"""The PyTorch port's make_ip_step in every ported KKT mode and its
make_batched_solver (awebox_tpu_torch/parallel/batch.py) against the JAX
package's (awebox_tpu/parallel/batch.py), on the CPU, in f64, on the same
numpy inputs:

- the FakeOCP ladder test of tests/test_multichip.py on both packages with
  the defaults ('auto' resolves to 'dense' for a caller's derivs_fn), with
  and without inequality rows;
- the dense autodiff derivatives of an OCP without the structured layout;
- make_batched_solver's fixed loop, its tol-gated loop (latched lanes keep
  their bits), batch_p both ways, and its refusal of a mesh;
- ROADMAP A10b's gate: make_batched_solver(tol=1e-5, kkt='auglu', LU) from
  init_batched_state reaches the JAX solver's per-lane err.

The slow tier runs both default modes at B=2 to convergence. Three
lockstep iterations of the sweep through each mode are in
tests/test_torch_sweep_lockstep.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_final_P, jax_trial, lanes, torch_trial

torch.set_num_threads(1)
N_FAKE = 4


# --- the FakeOCP of tests/test_multichip.py ----------------------------------

def fake_ocp(n_ineq):
    return SimpleNamespace(vstruct=SimpleNamespace(total=N_FAKE), n_eq=1, n_ineq=n_ineq)


def fake_derivs_jax(n_ineq, convex=False):
    def derivs(w, y, lam, p):
        fval = jnp.sum(w ** 2)
        gradf = 2 * w
        cE = jnp.array([w[0] + w[1] - p['c']])
        cI = jnp.array([w[2] - 10.])[:n_ineq]
        JE = jnp.array([[1., 1., 0., 0.]])
        JI = jnp.array([[0., 0., 1., 0.]])[:n_ineq]
        # strongly indefinite Hessian with a NaN: the ladder must sanitize
        # and damp it rather than propagate NaNs
        H = -100. * jnp.eye(N_FAKE)
        H = 2. * jnp.eye(N_FAKE) if convex else H.at[0, 0].set(jnp.nan)
        return fval, gradf, cE, cI, JE, JI, H
    return derivs


def fake_derivs_torch(n_ineq, convex=False):
    """tests/test_multichip.py's derivatives in torch; with ``convex`` the
    objective's own Hessian 2 I, so that the iteration converges."""
    def derivs(w, y, lam, p):
        fval = (w ** 2).sum()
        gradf = 2 * w
        cE = (w[0] + w[1] - p['c'])[None]
        cI = (w[2] - 10.)[None][:n_ineq]
        JE = torch.tensor([[1., 1., 0., 0.]], dtype=w.dtype)
        JI = torch.tensor([[0., 0., 1., 0.]], dtype=w.dtype)[:n_ineq]
        if convex:
            return fval, gradf, cE, cI, JE, JI, 2. * torch.eye(N_FAKE, dtype=w.dtype)
        H = -100. * torch.eye(N_FAKE, dtype=w.dtype)
        H[0, 0] = torch.nan
        return fval, gradf, cE, cI, JE, JI, H
    return derivs


def fake_state(n_ineq, B=2):
    """Lane 0 is tests/test_multichip.py's start; the others move w."""
    w = np.ones((B, N_FAKE))
    w[1:] = np.array([0.5, -1., 2., 3.])
    return dict(w=w, s=np.ones((B, n_ineq)), y=np.zeros((B, 1)), lam=np.ones((B, n_ineq)),
                zl=np.zeros((B, N_FAKE)), zu=np.zeros((B, N_FAKE)), mu=np.full(B, 1e-1))


def fake_bounds():
    return np.full(N_FAKE, -np.inf), np.full(N_FAKE, np.inf), np.ones(N_FAKE)


def to_t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def gaps(out_t, out_j):
    """Each state entry's max gap over max(1, max |JAX's|)."""
    out = {}
    for k in out_j:
        a, b = out_t[k].numpy(), np.asarray(out_j[k])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        out[k] = float(np.abs(a - b).max() / max(1., np.abs(b).max())) if a.size else 0.
    return out


# the FakeOCP iterates agree to 1e-12 relative, but y: its step dnu =
# (A dw + r2) / D divides a sum that cancels to ~1e-5 of its terms by
# delta_ce = 1e-8, so an ulp of the terms moves y by ~1e-8 (measured 3e-12
# relative at |y| ~ 7e3 and 4e-12 at |y| ~ 1)
FAKE_TOL = dict(w=1e-12, s=1e-12, lam=1e-12, zl=1e-12, zu=1e-12, mu=1e-12, err=1e-12, y=1e-10)


@pytest.mark.parametrize('kkt, n_ineq', [('auto', 1), ('auto', 0), ('auglu', 0)])
def test_fake_ocp_ladder_matches_the_reference(kkt, n_ineq):
    """The FakeOCP step with the defaults (kkt='auto' -> 'dense', the caller's
    derivs_fn mapped over lanes), with and without the inequality row, and
    through 'auglu' without it (the plain Newton system and advance_state,
    not K1 and ip_step): three steps on both packages from the same state,
    with the NaN-sanitized indefinite Hessian that sends the ladder up;
    finite iterates that agree within FAKE_TOL."""
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t, resolve_kkt
    assert resolve_kkt(fake_ocp(n_ineq), 'auto', fake_derivs_torch(n_ineq)) == 'dense'
    step_j = jax.jit(jax.vmap(make_j(fake_ocp(n_ineq), derivs_fn=fake_derivs_jax(n_ineq),
                                     kkt=kkt),
                              in_axes=(0, None, None, None, None)))
    step_t = make_t(fake_ocp(n_ineq), derivs_fn=fake_derivs_torch(n_ineq), kkt=kkt)
    lbw, ubw, free = fake_bounds()
    state = fake_state(n_ineq)
    st_j = {k: jnp.asarray(v) for k, v in state.items()}
    st_t = to_t(state)
    p_t = {'c': torch.ones(2, dtype=torch.float64)}
    bt = [torch.as_tensor(a) for a in (lbw, ubw, free)]
    for _ in range(3):
        st_j = step_j(st_j, {'c': 1.}, jnp.asarray(lbw), jnp.asarray(ubw), jnp.asarray(free))
        st_t = step_t(st_t, p_t, *bt)
        assert set(st_t) == set(st_j)
        g = gaps(st_t, st_j)
        assert all(g[k] <= FAKE_TOL[k] for k in g), g


def test_caller_derivs_refused_by_vmap_raise_by_name():
    """A derivs_fn that torch.func.vmap cannot map raises naming derivs_fn."""
    from awebox_tpu_torch.parallel.batch import make_ip_step

    def derivs(w, y, lam, p):
        return (float(w[0]),) * 7    # a Python float of a batched tensor

    step = make_ip_step(fake_ocp(1), derivs_fn=derivs)
    lbw, ubw, free = (torch.as_tensor(a) for a in fake_bounds())
    with pytest.raises(RuntimeError, match='derivs_fn'):
        step(to_t(fake_state(1)), {'c': torch.ones(2, dtype=torch.float64)}, lbw, ubw, free)


def shim(ocp):
    """The OCP's NLP functions without its model: no structured layout."""
    return SimpleNamespace(vstruct=ocp.vstruct, n_eq=ocp.n_eq, n_ineq=ocp.n_ineq,
                           f_fn=ocp.f_fn, eq_fn=ocp.eq_fn, ineq_fn=ocp.ineq_fn)


def test_dense_autodiff_derivs_match_the_reference():
    """An OCP without a model gets the dense autodiff derivatives (value,
    gradient, constraints, Jacobians, the Lagrangian's Hessian) in both
    packages: at the n_k=2 bench configuration's initial guess, perturbed,
    with random duals, B=2, each output to 1e-10 relative."""
    from awebox_tpu.api.trial import Trial as TrialJ
    from awebox_tpu.opti.homotopy import build_p_fix as bpf_j
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t, p_from_numpy, resolve_kkt
    from tests.test_torch_support import jax_bench_options, to_numpy_tree
    ocp_j = TrialJ(jax_bench_options(n_k=2), 'shim').build().ocp
    ocp_t = torch_trial(2).ocp
    assert resolve_kkt(shim(ocp_t), 'auto') == 'dense'
    V0 = np.asarray(build_initial_guess(ocp_j))
    P = to_numpy_tree(bpf_j(ocp_j, build_reference(ocp_j, V0)))
    rng = np.random.default_rng(2)
    W = V0 + 1e-3 * rng.standard_normal((2, V0.size))
    Y = 0.1 * rng.standard_normal((2, ocp_j.n_eq))
    L = np.abs(rng.standard_normal((2, ocp_j.n_ineq)))
    derivs_j = jax.jit(jax.vmap(make_j(shim(ocp_j), split=True)[0],
                                in_axes=(0, 0, 0, None)))
    out_j = derivs_j(W, Y, L, P)
    derivs_t = make_t(shim(ocp_t), split=True)[0]
    out_t = derivs_t(*(torch.as_tensor(a) for a in (W, Y, L)),
                     p_from_numpy(lanes(P, 2), 'cpu'))
    for name, a, b in zip(('fval', 'gradf', 'cE', 'cI', 'JE', 'JI', 'H'), out_t, out_j):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        assert np.abs(a.numpy() - b).max() <= 1e-10 * max(1e-300, np.abs(b).max()), name


# --- make_batched_solver ------------------------------------------------------

def fake_solver(n_iter, tol=0., batch_p=True, n_ineq=1, convex=False):
    from awebox_tpu_torch.parallel.batch import make_batched_solver
    lbw, ubw, _ = fake_bounds()
    return make_batched_solver(fake_ocp(n_ineq), lbw, ubw, n_iter=n_iter, tol=tol,
                               batch_p=batch_p, derivs_fn=fake_derivs_torch(n_ineq, convex))


def test_batched_solver_fixed_loop():
    """tol = 0: n_iter steps of make_ip_step's fused step, bit for bit with
    stepping by hand, and to 1e-12 of the JAX package's scan; the state
    keeps no err where it had none."""
    from awebox_tpu.parallel.batch import make_batched_solver as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step
    state = fake_state(1, B=3)
    P = {'c': torch.tensor([1., 2., 0.5], dtype=torch.float64)}
    solve = fake_solver(3)
    out = solve(to_t(state), P)
    assert solve.n_iter == 3 and 'err' not in out
    step = make_ip_step(fake_ocp(1), derivs_fn=fake_derivs_torch(1))
    st = to_t(state)
    bounds = [torch.as_tensor(a) for a in fake_bounds()]
    for _ in range(3):
        st = step(st, P, *bounds)
    for k in st:
        assert torch.equal(out[k], st[k]), k
    lbw, ubw, _ = fake_bounds()
    solve_j = make_j(fake_ocp(1), lbw, ubw, n_iter=3, batch_p=True,
                     derivs_fn=fake_derivs_jax(1))
    out_j = solve_j({k: jnp.asarray(v) for k, v in state.items()}, {'c': jnp.asarray(P['c'])})
    g = gaps(out, out_j)
    assert set(out) == set(out_j) and all(g[k] <= FAKE_TOL[k] for k in g), g


def test_batched_solver_tol_loop_freezes_latched_lanes():
    """tol > 0: the loop runs until every lane's err is <= tol; a lane that
    latched keeps the state of the step that latched it, bit for bit, while
    the others go on (the JAX package's vmapped while_loop); the steps taken
    are counted; the outcome equals the JAX solver's to 1e-12 per lane."""
    from awebox_tpu.parallel.batch import make_batched_solver as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step
    state = fake_state(1, B=3)
    state['w'][2] = [0.2, 0.1, -3., 0.7]
    state['mu'] = np.array([1e-1, 1e-3, 1e-6])
    P = {'c': torch.tensor([1., 2., 0.5], dtype=torch.float64)}
    tol = 1e-6   # lane 0 latches at step 3, lanes 1 and 2 at step 4; lane 0's err
                 # would rise to 6e-5 at step 5 if it went on
    solve = fake_solver(60, tol=tol, convex=True)
    out = solve(to_t(state), P)
    # by hand: every lane steps every time; each lane's state is taken at
    # the first step whose err is <= tol
    step = make_ip_step(fake_ocp(1), derivs_fn=fake_derivs_torch(1, convex=True))
    bounds = [torch.as_tensor(a) for a in fake_bounds()]
    st = dict(to_t(state), err=torch.full((3,), torch.inf, dtype=torch.float64))
    latched_at, kept = {}, {}
    for it in range(1, 61):
        st = step(st, P, *bounds)
        for b in range(3):
            if b not in latched_at and float(st['err'][b]) <= tol:
                latched_at[b] = it
                kept[b] = {k: v[b].clone() for k, v in st.items()}
        if len(latched_at) == 3:
            break
    assert len(latched_at) == 3 and len(set(latched_at.values())) > 1, latched_at
    assert solve.n_iter == max(latched_at.values())
    for b in range(3):
        for k in kept[b]:
            assert torch.equal(out[k][b], kept[b][k]), (b, k)
    lbw, ubw, _ = fake_bounds()
    solve_j = make_j(fake_ocp(1), lbw, ubw, n_iter=60, batch_p=True, tol=tol,
                     derivs_fn=fake_derivs_jax(1, convex=True))
    out_j = solve_j({k: jnp.asarray(v) for k, v in state.items()}, {'c': jnp.asarray(P['c'])})
    g = gaps(out, out_j)
    assert set(out) == set(out_j) and all(g[k] <= FAKE_TOL[k] for k in g), g


def test_batched_solver_shares_p_without_batch_p():
    """batch_p=False: one P for every lane, the same bits as that P repeated
    on a lane axis with batch_p=True."""
    state = to_t(fake_state(1, B=3))
    shared = fake_solver(4, batch_p=False)(state, {'c': torch.tensor(2., dtype=torch.float64)})
    per_lane = fake_solver(4)(state, {'c': torch.full((3,), 2., dtype=torch.float64)})
    for k in shared:
        assert torch.equal(shared[k], per_lane[k]), k


def test_batched_solver_mesh_raises_by_name():
    """Lanes sharded over several devices (mesh=) are not ported."""
    from awebox_tpu_torch.parallel.batch import make_batched_solver
    lbw, ubw, _ = fake_bounds()
    with pytest.raises(NotImplementedError, match='mesh'):
        make_batched_solver(fake_ocp(1), lbw, ubw, mesh=object(),
                            derivs_fn=fake_derivs_torch(1))


# --- the wind sweep -------------------------------------------------------------

# A10b's gate on the bench sweep: from init_batched_state (y = 0, the slacks
# and bound duals at mu0 = 1e-2) neither package converges (the JAX package:
# err 7..500 through 150 steps with its f32 LU), and the f32 factors' gap
# grows each step: the errs agree to 2e-15, 2.6e-6, 6.6e-4, 2.3e-3 relative
# after steps 1-4 (measured), so the gate is the err after 2 steps; on the
# convex FakeOCP both converge
AUGLU_INIT_ERR = 1e-5


def test_batched_solver_auglu_from_init_batched_state():
    """ROADMAP A10b's gate: make_batched_solver(tol=1e-5, kkt='auglu',
    auglu_factor='lu') from init_batched_state reaches the JAX solver's
    per-lane err: on the bench configuration (two guesses at the anchor's w,
    the final P, mu0 = 1e-2) after 2 steps to AUGLU_INIT_ERR relative, and on
    the convex FakeOCP to convergence, err to 1e-10 relative in the same
    number of steps."""
    from awebox_tpu.parallel.batch import (init_batched_state as init_j,
                                           make_batched_solver as mbs_j)
    from awebox_tpu_torch.parallel.batch import (init_batched_state as init_t,
                                                 make_batched_solver as mbs_t, p_from_numpy)
    from awebox_tpu_torch.parallel.refine import sweep_bounds
    lbf, ubf = sweep_bounds(torch_trial())
    a = anchor()
    rng = np.random.default_rng(4)
    V = [a['w'], a['w'] * (1 + 1e-4 * rng.standard_normal(a['w'].shape))]
    P = jax_final_P()
    kw = dict(n_iter=2, tol=1e-5, kkt='auglu', auglu_factor='lu')
    st_j = init_j(jax_trial().ocp, [jnp.asarray(v) for v in V], P, lbf, ubf, with_err=True)
    err_j = np.asarray(mbs_j(jax_trial().ocp, lbf, ubf, **kw)(st_j, P)['err'])
    P_t = p_from_numpy(P, 'cpu')
    st_t = init_t(torch_trial().ocp, V, P_t, lbf, ubf, with_err=True, device='cpu')
    solve = mbs_t(torch_trial().ocp, lbf, ubf, **kw)
    err_t = solve(st_t, P_t)['err'].numpy()
    assert solve.n_iter == 2 and (err_j > 1e-5).all()
    assert np.abs(err_t / err_j - 1.).max() <= AUGLU_INIT_ERR, (err_t, err_j)
    # the convex FakeOCP, with its inequality as an NLP function
    fake_t, fake_j = fake_ocp(1), fake_ocp(1)
    fake_t.ineq_fn = lambda w, p: w[2:3] - 10.
    fake_j.ineq_fn = lambda w, p: w[2:3] - 10.
    lbw, ubw, _ = fake_bounds()
    V = [np.array([1., 1., 1., 1.]), np.array([0.5, -1., 2., 3.])]
    kw = dict(n_iter=60, tol=1e-8, batch_p=True, kkt='auglu', auglu_factor='lu')
    c = np.array([1., 2.])
    out_j = mbs_j(fake_j, lbw, ubw, derivs_fn=fake_derivs_jax(1, convex=True), **kw)(
        init_j(fake_j, V, {}, lbw, ubw, with_err=True), {'c': jnp.asarray(c)})
    solve = mbs_t(fake_t, lbw, ubw, derivs_fn=fake_derivs_torch(1, convex=True), **kw)
    out_t = solve(init_t(fake_t, V, {}, lbw, ubw, with_err=True, device='cpu'),
                  {'c': torch.as_tensor(c)})
    err_j, err_t = np.asarray(out_j['err']), out_t['err'].numpy()
    assert (err_t <= 1e-8).all() and (err_j <= 1e-8).all(), (err_t, err_j)
    assert np.abs(err_t - err_j).max() <= 1e-10 * np.abs(err_j).max() + 1e-20, (err_t, err_j)


# --- slow: to convergence ----------------------------------------------------------

def jax_converged(mode, cap):
    """The JAX package's make_batched_solver(n_iter=cap, batch_p=True,
    tol=1e-5) in ``mode`` on the B=2 sweep (u_ref 9.5, 10.5 m/s) from the
    anchor, f64: per lane average power [W] and period [s], numpy."""
    from awebox_tpu.parallel.batch import make_batched_solver as mbs_j
    from awebox_tpu_torch.parallel.refine import sweep_bounds
    from tests.test_torch_support import jax_sweep
    ocp_j = jax_trial().ocp
    state, P64 = jax_sweep(2)[:2]
    kw = dict(solve_dtype='float64') if mode == 'dense' else {}
    out = mbs_j(ocp_j, *sweep_bounds(torch_trial()), n_iter=cap, batch_p=True, tol=1e-5,
                kkt=mode, **kw)({k: jnp.asarray(v) for k, v in state.items()}, P64)
    T = jax.vmap(ocp_j.time_period_fn)(out['w'])
    return np.asarray(jax.vmap(ocp_j.e_final_si_fn)(out['w'], P64) / T), np.asarray(T)


@pytest.mark.slow
@pytest.mark.parametrize('mode', ['block', 'dense'])
def test_sweep_converges_in_both_modes(mode):
    """Both default modes run the B=2 sweep to convergence (err <= 1e-5, f64
    max |eq| <= 1e-4 in both lanes) through make_batched_solver, beside the
    JAX package's make_batched_solver in the same mode on the same inputs.
    The 9.5 m/s lane lands on the JAX package's optimum (power and period to
    1e-6). The 10.5 m/s lane: 'dense' latches where the JAX package latches,
    power to 1e-6 (measured 9.2e-7) and period to 2e-5 (measured 8.7e-6: the
    lane latches at err ~7e-6, where the period moves along a flat
    direction); 'block' latches at iteration 33 at the auglu optimum
    (11946.29 W) where the JAX package's lane, at err 1.09e-5, goes on to
    another optimum (12004.837 W at iteration 64): the two parted at the
    first iteration by the ~1% that the direction is determined to
    (tests/test_torch_blockkkt.py), so the lane is held to convergence only."""
    from awebox_tpu_torch.parallel.batch import make_batched_solver
    from awebox_tpu_torch.parallel.refine import (average_power, sweep_bounds,
                                                  wind_sweep_problem)
    cap = 200 if mode == 'block' else 100
    ref_p, ref_t = jax_converged(mode, cap)
    trial = torch_trial()
    ocp = trial.ocp
    state, P64, *_ = wind_sweep_problem(trial, anchor(), 2, device='cpu')
    kw = dict(solve_dtype=torch.float64, kkt='dense') if mode == 'dense' else {}
    solve = make_batched_solver(ocp, *sweep_bounds(trial), n_iter=cap, batch_p=True, tol=1e-5,
                                **kw)
    out = solve(state, P64)
    eq = torch.func.vmap(ocp.eq_fn)(out['w'], P64).abs().amax(dim=1).numpy()
    assert (out['err'].numpy() <= 1e-5).all() and (eq <= 1e-4).all(), (out['err'], eq)
    power = average_power(ocp, out['w'], P64).numpy()
    period = torch.func.vmap(ocp.time_period_fn)(out['w']).numpy()
    assert abs(power[0] / ref_p[0] - 1.) <= 1e-6 and abs(period[0] / ref_t[0] - 1.) <= 1e-6, \
        (power, period, ref_p, ref_t)
    if mode == 'dense':
        assert abs(power[1] / ref_p[1] - 1.) <= 1e-6 and abs(period[1] / ref_t[1] - 1.) <= 2e-5, \
            (power, period, ref_p, ref_t)
