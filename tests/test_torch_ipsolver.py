"""The PyTorch port's host interior-point solver (awebox_tpu_torch/opti/
ipsolver.py) and its homotopy loop against the JAX package's
(awebox_tpu/opti/ipsolver.py, opti/homotopy.py), on the CPU, in f64, on the
same numpy inputs:

- the six problems of tests/test_ipsolver.py through both solvers: the same
  status and iteration count, solutions within 1e-8;
- at the committed anchor's state (tests/artifacts/bench_anchor_nk4_d3.npz,
  the final cost weights, the relaxed final bounds): init_state,
  barrier_phi_theta and kkt_error, and the dense direction kkt_solve at
  mu = 1e-3 with delta_w = 0 and 1e-4;
- five iterations of the bench problem's 'initial' homotopy step: mu, alpha,
  err and the delta_w ladder's factorizations per iteration (callback);
- the block branch (linear_solver='block') for one iteration.

On the CPU the port's kernel wrappers run their plain versions
(torch.linalg's Cholesky and LU); the card's kernels are held to those in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_final_P, jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
STATE_KEYS = ('w', 's', 'y', 'lam', 'zl', 'zu')


# --- the problems of tests/test_ipsolver.py ----------------------------------

def problems(xp):
    """(name, f, eq, ineq, n, n_eq, n_ineq, options, solves) in the array
    module xp (jnp or torch); solves: [(w0, p, lbw, ubw)], solved in turn by
    one solver."""
    stack = jnp.stack if xp is jnp else torch.stack
    inf = np.inf
    none = lambda w, p: w[:0]
    Q, b, A, c = np.diag([1., 2., 3.]), np.ones(3), np.ones((1, 3)), np.ones(1)
    Qx, bx, Ax, cx = ((xp.asarray(a) if xp is jnp else torch.as_tensor(a)) for a in (Q, b, A, c))
    return [
        ('rosenbrock', lambda w, p: (1. - w[0]) ** 2 + 100. * (w[1] - w[0] ** 2) ** 2,
         none, none, 2, 0, 0, dict(tol=1e-10, max_iter=300),
         [(np.array([-1.2, 1.0]), None, np.array([-5., -5.]), np.array([5., 5.]))]),
        ('equality_qp', lambda w, p: 0.5 * w @ (Qx @ w) - bx @ w,
         lambda w, p: Ax @ w - cx, none, 3, 1, 0, dict(tol=1e-10, max_iter=100),
         [(np.zeros(3), None, -inf * np.ones(3), inf * np.ones(3))]),
        ('hs071', lambda w, p: w[0] * w[3] * (w[0] + w[1] + w[2]) + w[2],
         lambda w, p: stack([w @ w - 40.]),
         lambda w, p: stack([25. - w[0] * w[1] * w[2] * w[3]]), 4, 1, 1,
         dict(tol=1e-9, max_iter=300),
         [(np.array([1., 5., 5., 1.]), None, np.ones(4), 5. * np.ones(4))]),
        ('nonconvex', lambda w, p: -(w ** 2).sum(), none, none, 2, 0, 0,
         dict(tol=1e-8, max_iter=200),
         [(np.array([0.3, -0.2]), None, -np.ones(2), np.ones(2))]),
        ('parametric', lambda w, p: ((w - p) ** 2).sum(), lambda w, p: stack([w[0] + w[1] - 1.]),
         none, 2, 1, 0, dict(tol=1e-10, max_iter=50),
         [(np.zeros(2), np.array([0., 0.]), -inf * np.ones(2), inf * np.ones(2)),
          (np.zeros(2), np.array([3., 1.]), -inf * np.ones(2), inf * np.ones(2))]),
    ]


NAMES = [p[0] for p in problems(jnp)]


def both_solvers(name, options=None):
    from awebox_tpu.opti.ipsolver import InteriorPointSolver as SolverJ, IPOptions as OptJ
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver as SolverT, IPOptions as OptT
    pj = dict((p[0], p) for p in problems(jnp))[name]
    pt = dict((p[0], p) for p in problems(torch))[name]
    opts = options or pj[7]
    sj = SolverJ(*pj[1:4], n=pj[4], n_eq=pj[5], n_ineq=pj[6], options=OptJ(**opts))
    st = SolverT(*pt[1:4], n=pt[4], n_eq=pt[5], n_ineq=pt[6], options=OptT(**opts),
                 device='cpu')
    return sj, st, pj[8]


def same_result(rj, rt, tol=1e-8):
    assert (rt.status, rt.iterations, rt.success) == (rj.status, rj.iterations, rj.success)
    for k in STATE_KEYS:
        a, b = rt.__dict__[k].numpy(), np.asarray(rj.__dict__[k])
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() <= tol * max(1., np.abs(b).max()), k


@pytest.mark.parametrize('name', NAMES)
def test_standard_problems_match_the_reference(name):
    """Rosenbrock with bounds, the equality QP, HS071, the nonconvex problem
    that needs primal regularization, and the parametric re-solve (two p,
    one solver): the same status and iteration count as the JAX package's
    solver, every iterate entry (w, s, y, lam, zl, zu) within 1e-8 of max(1,
    max |.|)."""
    sj, st, solves = both_solvers(name)
    for w0, p, lbw, ubw in solves:
        same_result(sj.solve(w0, p, lbw=lbw, ubw=ubw), st.solve(w0, p, lbw=lbw, ubw=ubw))


def test_relaxed_barrier_and_warm_resolve_match_the_reference():
    """The hippo strategy's relaxed barrier (mu_target = 1e-2) and the warm
    re-solve with mu_target 0 from its state, as tests/test_ipsolver.py runs
    them: the same status and iterations in both packages, iterates within
    1e-8."""
    from awebox_tpu.opti.ipsolver import InteriorPointSolver as SolverJ, IPOptions as OptJ
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver as SolverT, IPOptions as OptT
    f = lambda w, p: (w[0] - 2.) ** 2
    lb, ub = np.array([0.]), np.array([1.])
    outs = []
    for Solver, Opt, kw in ((SolverJ, OptJ, {}), (SolverT, OptT, dict(device='cpu'))):
        none = lambda w, p: w[:0]
        s1 = Solver(f, none, none, n=1, n_eq=0, n_ineq=0,
                    options=Opt(tol=1e-6, mu_target=1e-2, max_iter=100), **kw)
        r1 = s1.solve(np.array([0.5]), None, lbw=lb, ubw=ub)
        s2 = Solver(f, none, none, n=1, n_eq=0, n_ineq=0, options=Opt(tol=1e-9, max_iter=100),
                    **kw)
        state = dict(w=r1.w, s=r1.s, y=r1.y, lam=r1.lam, zl=r1.zl, zu=r1.zu, mu=1e-2)
        outs.append((r1, s2.solve(r1.w, None, lbw=lb, ubw=ub, state=state)))
    (r1j, r2j), (r1t, r2t) = outs
    assert r1t.success and 0.9 < float(r1t.w[0]) < 1.0 - 1e-4
    same_result(r1j, r1t)
    same_result(r2j, r2t)


# --- the bench problem at the anchor -----------------------------------------

@pytest.fixture(scope='module')
def bench():
    """Both packages' dense solvers on the bench problem, the anchor's state,
    the final cost weights and the relaxed final bounds (split), numpy."""
    from awebox_tpu.opti.ipsolver import InteriorPointSolver as SolverJ
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver as SolverT
    oj, ot = jax_trial().ocp, torch_trial().ocp
    sj = SolverJ(oj.f_fn, oj.eq_fn, oj.ineq_fn, n=oj.vstruct.total, n_eq=oj.n_eq,
                 n_ineq=oj.n_ineq)
    st = SolverT(ot.f_fn, ot.eq_fn, ot.ineq_fn, n=ot.vstruct.total, n_eq=ot.n_eq,
                 n_ineq=ot.n_ineq, device='cpu')
    _, _, lbw, ubw, free = jax_sweep(1)
    return dict(sj=sj, st=st, P=jax_final_P(), a=anchor(), lbw=lbw, ubw=ubw, free=free)


def rel_gap(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)) if b.size else 0.


# at the anchor the constraint violation theta and the KKT error at mu = 0
# sit at roundoff (theta ~2e-12: a sum of 263 residuals of ~1e-14, each
# summed in another order by the two packages), where a relative gap means
# nothing: they are held to an absolute 1e-10
ROUNDOFF = 1e-10


def test_state_pieces_match_the_reference(bench):
    """init_state from the anchor's w (mu = 1e-3, the anchor's y and lam as
    warm duals), barrier_phi_theta and kkt_error at mu = 1e-3 and 0 at the
    anchor's state: within 1e-12 relative (theta and a KKT error at roundoff
    level within ROUNDOFF)."""
    sj, st, P, a = bench['sj'], bench['st'], bench['P'], bench['a']
    lbw, ubw, free = bench['lbw'], bench['ubw'], bench['free']
    ij = sj.init_state(a['w'], P, lbw, ubw, y0=a['y'], lam0=a['lam'], mu=1e-3)
    it = st.init_state(a['w'], P, lbw, ubw, y0=a['y'], lam0=a['lam'], mu=1e-3)
    for k in STATE_KEYS:
        assert rel_gap(it[k].numpy(), ij[k]) <= 1e-12, k
    assert it['mu'] == ij['mu']
    t = st._t
    sj_args = [jnp.asarray(a[k]) for k in STATE_KEYS]
    st_args = [t(a[k]) for k in STATE_KEYS]
    Pt = st._p(P)
    for mu in (1e-3, 0.):
        pj = sj._barrier_phi_theta(sj_args[0], sj_args[1], P, mu, jnp.asarray(lbw),
                                   jnp.asarray(ubw))
        pt = st._barrier_phi_theta(st_args[0], st_args[1], Pt, mu, t(lbw), t(ubw))
        assert rel_gap(float(pt[0]), float(pj[0])) <= 1e-12
        assert abs(float(pt[1]) - float(pj[1])) <= ROUNDOFF
        ej = sj._kkt_error(*sj_args, P, mu, jnp.asarray(lbw), jnp.asarray(ubw),
                           jnp.asarray(free))
        et = st._kkt_error(*st_args, Pt, mu, t(lbw), t(ubw), t(free))
        assert abs(float(et) - float(ej)) <= max(1e-12 * abs(float(ej)), ROUNDOFF)


# the direction at the anchor: [W, A^T; A, -D] has cond ~1e17 there (the
# active bounds' sigma against the 1e-7 regularization of D), so the two
# packages' LU solves of the same system differ by rounding amplified by
# it; each side's own residual is at working accuracy
TOL_DIRECTION = 1e-6


@pytest.mark.parametrize('delta_w', [0., 1e-4])
def test_kkt_solve_at_the_anchor_matches_the_reference(bench, delta_w):
    """The dense direction at the anchor (mu = 1e-3, delta_c = 1e-7, delta_ce
    0 as the ladder's first trial): the same inertia verdict ok; dw, dy,
    dlam, ds, dzl and dzu within TOL_DIRECTION of their max; the augmented
    system's residual max |K sol - rhs| <= 1e-10 relative to max |K| max
    |sol| + max |rhs|."""
    sj, st, P, a = bench['sj'], bench['st'], bench['P'], bench['a']
    lbw, ubw, free = bench['lbw'], bench['ubw'], bench['free']
    mu, dc = 1e-3, 1e-7
    dj = sj._derivs(jnp.asarray(a['w']), jnp.asarray(a['y']), jnp.asarray(a['lam']), P)
    t = st._t
    dt = st._derivs(t(a['w']), t(a['y']), t(a['lam']), st._p(P))
    sj_state = [jnp.asarray(a[k]) for k in STATE_KEYS]
    st_state = [t(a[k]) for k in STATE_KEYS]
    out_j = sj._kkt_solve(*dj[1:], *sj_state, jnp.asarray(lbw), jnp.asarray(ubw),
                          jnp.asarray(free), mu, delta_w, dc, 0.)
    out_t = st._kkt_solve(*dt[1:], *st_state, t(lbw), t(ubw), t(free), mu, delta_w, dc, 0.)
    assert bool(out_t[6]) == bool(out_j[6])
    for name, u, v in zip(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu'), out_t[:6], out_j[:6]):
        assert rel_gap(u.numpy(), v) <= TOL_DIRECTION, name
    # the augmented residual of the port's solution
    _, gradf, cE, cI, JE, JI, H = (x.numpy() for x in dt)
    w, s, y, lam, zl, zu = (a[k] for k in STATE_KEYS)
    dl, du = np.maximum(w - lbw, 1e-20), np.maximum(ubw - w, 1e-20)
    W = H + np.diag(zl / dl + zu / du) + delta_w * np.eye(len(w))
    W = W * np.outer(free, free) + np.diag(1. - free)
    A = np.concatenate([JE, JI]) * free[None, :]
    lam_s = np.maximum(lam, 1e-12)
    D = np.concatenate([np.zeros(len(y)), s / lam_s + dc])
    K = np.block([[W, A.T], [A, -np.diag(D)]])
    r1 = -(gradf + A.T @ np.concatenate([y, lam]) - mu / dl + mu / du) * free
    rhs = np.concatenate([r1, -np.concatenate([cE, cI + mu / lam_s])])
    sol = np.concatenate([out_t[0].numpy(), out_t[1].numpy(), out_t[2].numpy()])
    res = np.abs(K @ sol - rhs).max()
    assert res <= 1e-10 * (np.abs(K).max() * np.abs(sol).max() + np.abs(rhs).max())


# --- the homotopy's first step, and the block branch -------------------------

def initial_step(package, max_iter, linear_solver='auto'):
    """Trial.optimize of the bench problem up to the 'initial' step, capped at
    max_iter iterations, with the per-iteration callback on: (trial, its
    callback records)."""
    if package == 'jax':
        from awebox_tpu.api.trial import Trial
        from tests.test_torch_support import jax_bench_options as options_of
        kw = {}
    else:
        from awebox_tpu_torch.api.trial import Trial
        from awebox_tpu_torch.configs import bench_options as options_of
        kw = dict(device='cpu')
    o = options_of()
    o['solver.max_iter'] = max_iter
    o['solver.callback'] = True
    o['solver.linear_solver'] = linear_solver
    trial = Trial(o, f'{package}_initial').build()
    trial.optimize(final_homotopy_step='initial', verbose=False, **kw)
    return trial, trial.solution.stats['iterates']['initial_0']


def counted_initial_step(package, max_iter, n_k=4, kept=None, dof=3):
    """initial_step (at n_k; of the 6-DOF health configuration with dof=6)
    with the solver's kkt_solve wrapped by a counter; the callback closes
    each iteration's count. With ``kept`` (a dict), the first kkt_solve
    call's arguments and outputs land there."""
    from tests.test_torch_support import options_of
    if package == 'jax':
        from awebox_tpu.api.trial import Trial
        from awebox_tpu.opti.ipsolver import InteriorPointSolver, IPOptions
        kw, skw = {}, {}
    else:
        from awebox_tpu_torch.api.trial import Trial
        from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver, IPOptions
        kw, skw = dict(device='cpu'), dict(device='cpu')
    o = options_of(package, dof)(n_k)
    o['solver.max_iter'] = max_iter
    o['solver.callback'] = True
    trial = Trial(o, f'{package}_initial').build()
    ocp = trial.ocp
    solver = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=ocp.vstruct.total,
                                 n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, options=IPOptions(), **skw)
    calls, per_iter = [0], []
    inner = solver._kkt_solve

    def counting(*args):
        calls[0] += 1
        out = inner(*args)
        if kept is not None and not kept:
            kept['args'], kept['out'] = args, out
        return out
    solver._kkt_solve = counting
    inner_solve = solver.solve

    def solve(*args, callback=None, **kwargs):
        def cb(**info):
            per_iter.append(calls[0])
            calls[0] = 0
            callback(**info)
        return inner_solve(*args, callback=cb, **kwargs)
    solver.solve = solve
    trial._solver_cache['solver'] = solver
    trial.optimize(final_homotopy_step='initial', verbose=False, **kw)
    return trial, trial.solution.stats['iterates']['initial_0'], per_iter


def test_initial_step_iterations_match_the_reference():
    """Five iterations of the bench problem's cold 'initial' homotopy step in
    both packages: per iteration the same barrier level mu, the same number
    of delta_w ladder factorizations, and alpha, delta_w and the KKT error
    within 1e-9 relative; the same status; the iterates within 1e-9 of
    max(1, max |w|)."""
    tj, rec_j, ladder_j = counted_initial_step('jax', 5)
    tt, rec_t, ladder_t = counted_initial_step('torch', 5)
    assert len(rec_t) == len(rec_j) == 5
    assert ladder_t == ladder_j
    for rt, rj in zip(rec_t, rec_j):
        assert rt['it'] == rj['it'] and rt['mu'] == rj['mu']
        for k in ('alpha', 'delta_w', 'err', 'f'):
            assert abs(rt[k] - rj[k]) <= 1e-9 * max(abs(rj[k]), 1e-300), (rt['it'], k)
    assert tt.solution.step_results['initial_0']['status'] \
        == tj.solution.step_results['initial_0']['status']
    vj = np.asarray(tj.solution.V_opt)
    assert np.abs(tt.solution.V_opt - vj).max() <= 1e-9 * max(1., np.abs(vj).max())


def test_block_branch_one_iteration_matches_the_reference():
    """linear_solver='block' (ocp/blockkkt.py's factor, K8 and K9 on the
    card, their plain versions here) for one iteration of the cold 'initial'
    step in both packages: the same mu and status, alpha, delta_w and err
    within 1e-6 relative, and the iterate within 1e-6 of max(1, max |w|) (the
    block direction sums in another order than the JAX package's)."""
    tj, rec_j = initial_step('jax', 1, 'block')
    tt, rec_t = initial_step('torch', 1, 'block')
    assert tt._solver_cache['solver']._block is not None
    assert len(rec_t) == len(rec_j) == 1
    rt, rj = rec_t[0], rec_j[0]
    assert rt['mu'] == rj['mu']
    for k in ('alpha', 'delta_w', 'err'):
        assert abs(rt[k] - rj[k]) <= 1e-6 * max(abs(rj[k]), 1e-300), k
    assert tt.solution.step_results['initial_0']['status'] \
        == tj.solution.step_results['initial_0']['status']
    vj = np.asarray(tj.solution.V_opt)
    assert np.abs(tt.solution.V_opt - vj).max() <= 1e-6 * max(1., np.abs(vj).max())


def test_linear_solver_choice_is_the_reference_rule():
    """'auto' takes 'dense' for the bench problem (280 variables, below the
    block path's 1200), as the JAX package; 'block' and 'dense' are taken as
    given."""
    from awebox_tpu_torch.opti.homotopy import linear_solver_choice
    ocp = torch_trial().ocp
    assert linear_solver_choice(ocp) == 'dense'
    assert linear_solver_choice(ocp, 'block') == 'block'
    assert linear_solver_choice(ocp, 'dense') == 'dense'
