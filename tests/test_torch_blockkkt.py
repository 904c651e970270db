"""The block-structured KKT factorization of the PyTorch port
(awebox_tpu_torch/ocp/blockkkt.py) against the JAX package's
(awebox_tpu/ocp/blockkkt.py), on the CPU, in f64, on the same numpy inputs:
the static maps, the per-node derivative blocks, the frame assembly and the
direction of kkt_solve, at the committed anchor (B=2 lanes of the bench
sweep) and there with the Hessian blocks shifted so that the Lanczos probe
sets delta; then the
port's own version of tests/test_blockkkt.py::_compare (block direction
against a dense condensed solve at the same delta).

The direction is determined only as well as its system allows: at the
anchor the condensed M has cond ~ 1.5e19 (active bounds put sigma at ~1e16,
the equality rows 1/delta_ce = 1e8), so the block solve and a dense LU solve
of the same M differ by ~9%, and two sweeps of augmented refinement leave
each package's direction within ~1% of the other's (measured below). The
tests hold what is determined tightly (maps, blocks, assembly, ok, delta,
err_d) and the direction by its augmented residual and a stated gap.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
B = 2
ARGS = ('w', 's', 'y', 'lam', 'zl', 'zu')


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_cache = {}


def kits():
    """(port derivs, kkt_solve, maps), (JAX derivs, kkt_solve, maps), built once."""
    if 'kits' not in _cache:
        from awebox_tpu.ocp.blockkkt import make_block_kkt as make_j
        from awebox_tpu_torch.ocp.blockkkt import make_block_kkt as make_t
        _cache['kits'] = make_t(torch_trial().ocp), make_j(jax_trial().ocp)
    return _cache['kits']


def sweep_state():
    """The bench sweep's B=2 lanes at the anchor (numpy)."""
    state, P64, lbw, ubw, free = jax_sweep(B)
    return {k: np.array(v) for k, v in state.items()}, P64, lbw, ubw, free


def jitted(name, make):
    """A jitted JAX function, compiled once for the file."""
    if name not in _cache:
        _cache[name] = make()
    return _cache[name]


def both_blocks(state, P64):
    (dt, _, _), (dj, _, _) = kits()
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    t = lambda k: torch.as_tensor(state[k])
    bt = dt(t('w'), t('y'), t('lam'), p_from_numpy(P64, 'cpu'))
    bj = jitted('derivs', lambda: jax.jit(jax.vmap(dj)))(state['w'], state['y'], state['lam'], P64)
    return bt, bj


def both_solves(state, P64, lbw, ubw, free, shift=0.):
    (_, kt, _), (_, kj, _) = kits()
    bt, bj = both_blocks(state, P64)
    if shift:
        bt, bj = shifted_blocks(bt, bj, shift)
    args_t = [torch.as_tensor(state[k]) for k in ARGS] + [torch.as_tensor(a) for a in
                                                           (lbw, ubw, free)]
    out_t = kt(bt, *args_t, torch.as_tensor(state['mu']), 1e-8, 1e-8, 1e-8)
    lb, ub, fr = (jnp.asarray(a) for a in (lbw, ubw, free))
    solve_j = jitted('kkt_solve', lambda: jax.jit(jax.vmap(
        lambda blk, w, s, y, lam, zl, zu, mu: kj(blk, w, s, y, lam, zl, zu, lb, ub, fr, mu,
                                                 1e-8, 1e-8, 1e-8))))
    out_j = solve_j(bj, *[state[k] for k in ARGS + ('mu',)])
    return out_t, out_j, bt


def augmented_residual(state, P64, lbw, ubw, free, dw, dy, dlam, delta):
    """max |W dw + A^T dnu - r1| / max|r1| and max |A dw - D dnu + r2| /
    max|r2| of a direction, per lane, from the dense structured derivatives
    (the JAX package's, f64) at the iterate."""
    from awebox_tpu.ocp.structured import make_structured_derivs
    ocp = jax_trial().ocp
    derivs = jitted('structured', lambda: jax.jit(jax.vmap(make_structured_derivs(ocp))))
    fval, gradf, cE, cI, JE, JI, H = (np.asarray(a) for a in derivs(
        state['w'], state['y'], state['lam'], P64))
    out = []
    for b in range(B):
        w, s, lam, mu = state['w'][b], state['s'][b], state['lam'][b], state['mu'][b]
        dl = np.maximum(w - lbw, 1e-20)
        du = np.maximum(ubw - w, 1e-20)
        sigma = np.clip(state['zl'][b] / dl + state['zu'][b] / du, 0., 1e16)
        W = (H[b] + np.diag(sigma)) * np.outer(free, free) + np.diag(1. - free) \
            + delta[b] * np.diag(free)
        A = np.concatenate([JE[b], JI[b]]) * free[None, :]
        lam_safe = np.maximum(lam, 1e-12)
        D = np.concatenate([1e-8 * np.ones(ocp.n_eq), s / lam_safe + 1e-8])
        r2 = np.concatenate([cE[b], cI[b] + mu / lam_safe])
        r1 = -(gradf[b] + A.T @ np.concatenate([state['y'][b], lam]) - mu / dl + mu / du) * free
        dnu = np.concatenate([dy[b], dlam[b]])
        out.append((np.abs(W @ dw[b] + A.T @ dnu - r1).max() / np.abs(r1).max(),
                    np.abs(A @ dw[b] - D * dnu + r2).max() / np.abs(r2).max()))
    return np.array(out)


def test_build_block_maps_equal_the_reference():
    """Every static map of the frame layout equals the JAX package's."""
    (_, _, mt), (_, _, mj) = kits()
    for k in ('n_k', 'd', 'nx', 'ni', 'nb', 'nloc', 'off_b', 'off_bn', 'off_i', 'off_g',
              'n_eq_m', 'n_sh', 'n_ineq_m', 'm_rows', 'n_extra', 'trash', 'n_eq', 'n_ineq', 'n'):
        assert getattr(mt, k) == getattr(mj, k), k
    for k in ('coll_cols', 'sh_cols', 'E_coll', 'E_sh', 'A_cont', 'A_extra', 'row_gid',
              'chain_V', 'intr_V', 'border_V', 'frame_V', 'own', 'glob_frame'):
        a, b = getattr(mt, k), np.asarray(getattr(mj, k))
        assert a.shape == b.shape and np.array_equal(a, b), k


# blocks: the same per-node AD in f64; measured 1.9e-12 relative on cE
# (residual values of order 1e-7 against entries of order 1e5), <= 5e-16 on
# the rest
BLOCK_TOL = 1e-10


def test_block_derivs_match_the_reference():
    """make_block_derivs at the anchor, B=2: every block to 1e-10 relative."""
    state, P64 = sweep_state()[:2]
    bt, bj = both_blocks(state, P64)
    assert set(bt) == set(bj)
    for k in bt:
        if bt[k] is None:
            assert bj[k] is None, k
            continue
        assert tuple(bt[k].shape) == np.asarray(bj[k]).shape, k
        assert rel(bt[k].numpy(), bj[k]) <= BLOCK_TOL, (k, rel(bt[k].numpy(), bj[k]))


# assembly: Frame, A, D_k, r2_k to 1e-13 relative (measured <= 4.2e-16);
# rhs_w = r1 - A^T (r2 / D) cancels terms of order |A|^2 / delta_ce: 1e-9
# (measured 3.1e-10)
ASSEMBLY_TOL = {'Frame': 1e-13, 'A': 1e-13, 'D_k': 1e-13, 'r2_k': 1e-13, 'r1': 1e-13,
                'rhs_w': 1e-9}


def test_assemble_matches_the_reference():
    """The frame matrices, constraint data and right-hand sides of
    maps.assemble equal the JAX package's within ASSEMBLY_TOL."""
    (_, _, mt), (_, _, mj) = kits()
    state, P64, lbw, ubw, free = sweep_state()
    bt, bj = both_blocks(state, P64)
    at = mt.assemble(bt, *[torch.as_tensor(state[k]) for k in ARGS],
                     *(torch.as_tensor(a) for a in (lbw, ubw, free)),
                     torch.as_tensor(state['mu']), 1e-8, 1e-8)
    lb, ub, fr = (jnp.asarray(a) for a in (lbw, ubw, free))
    aj = jax.jit(jax.vmap(lambda blk, w, s, y, lam, zl, zu, mu: mj.assemble(
        blk, w, s, y, lam, zl, zu, lb, ub, fr, mu, 1e-8, 1e-8)))(
        bj, *[state[k] for k in ARGS + ('mu',)])
    for k, tol in ASSEMBLY_TOL.items():
        assert rel(at[k].numpy(), aj[k]) <= tol, (k, rel(at[k].numpy(), aj[k]))


# kkt_solve: ok and delta_used equal (delta to 1e-10: the Lanczos probe's
# eigenvalue moves with the order of its sums), err_d to 1e-13, and the
# direction's gap from the JAX package's, each output over its max
# (DIRECTION_GAP). At the anchor, where cond(M) ~ 1.5e19, the gaps measured
# 0.9% (dw), 1.6% (dy, dlam), 0.16% (ds), 0.5% and 1.0% (dzl, dzu); there
# both directions must also satisfy the augmented equations within 10x of
# each other (measured 2.7e-7 and 2.1e-7 relative). With the Lanczos shift
# (delta ~ 5.7e9) the system is well conditioned: gaps up to 5.3e-11 (dw),
# held to the 1e-9 asked of the direction.
DIRECTION_GAP = {'anchor': 5e-2, 'lanczos': 1e-9}


def shifted_blocks(bt, bj, shift):
    """The blocks with every shooting node's Hessian block shifted by
    -shift I: M0 turns indefinite, and the Lanczos probe raises delta to
    ~1.5 |lambda_min| (not a value of the x100 ladder)."""
    eye = np.eye(bt['H_sh'].shape[-1])
    bt, bj = dict(bt), dict(bj)
    bt['H_sh'] = bt['H_sh'] - shift * torch.as_tensor(eye)
    bj['H_sh'] = bj['H_sh'] - shift * jnp.asarray(eye)
    return bt, bj


@pytest.mark.parametrize('where', ['anchor', 'lanczos'])
def test_kkt_solve_matches_the_reference(where):
    """kkt_solve at the anchor, and with the shooting Hessians shifted by
    -1e8 I, where the Lanczos probe finds M0 indefinite and sets delta:
    ok, delta_used, err_d, and the direction."""
    state, P64, lbw, ubw, free = sweep_state()
    shift = 1e8 if where == 'lanczos' else 0.
    out_t, out_j, _ = both_solves(state, P64, lbw, ubw, free, shift)
    np.testing.assert_array_equal(out_t[6].numpy(), np.asarray(out_j[6]))
    assert bool(out_t[6].all())
    dt_, dj_ = out_t[7]['delta_used'].numpy(), np.asarray(out_j[7]['delta_used'])
    assert rel(dt_, dj_) <= 1e-10, (dt_, dj_)
    if where == 'lanczos':
        assert (dt_ > 1e9).all(), dt_
    else:
        assert (dt_ == 1e-8).all(), dt_
    assert rel(out_t[7]['err_d'].numpy(), out_j[7]['err_d']) <= 1e-13
    for i, name in enumerate(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu')):
        gap = rel(out_t[i].numpy(), out_j[i])
        assert gap <= DIRECTION_GAP[where], (name, gap)
    if where == 'anchor':
        res_t = augmented_residual(state, P64, lbw, ubw, free,
                                   *(out_t[i].numpy() for i in range(3)), dt_)
        res_j = augmented_residual(state, P64, lbw, ubw, free,
                                   *(np.asarray(out_j[i]) for i in range(3)), dj_)
        assert (res_t <= 10 * np.maximum(res_j, 1e-12)).all(), (res_t, res_j)


def _state_and_args(trial):
    """A perturbed initial guess with random duals at mu = 0.1, as
    tests/test_blockkkt.py::_state_and_args, on the port (numpy)."""
    from awebox_tpu_torch.opti.homotopy import build_p_fix, define_schedule, set_initial_bounds
    from awebox_tpu_torch.opti.initialization import build_initial_guess, build_reference
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    ocp = trial.ocp
    V0 = build_initial_guess(ocp)
    P = build_p_fix(ocp, build_reference(ocp, V0))
    lb, ub = set_initial_bounds(ocp, trial.lb_nominal, trial.ub_nominal, V0,
                                define_schedule(ocp))
    lbw, ubw, free, center = InteriorPointSolver.split_pins(lb, ub)
    rng = np.random.default_rng(7)
    w = np.asarray(V0) + 1e-3 * rng.normal(size=V0.shape)
    w = np.where(free > 0.5, w, center)
    span = np.minimum(1e-2 * np.maximum(1., np.abs(w)), 0.5 * (ubw - lbw))
    w = np.clip(w, np.where(np.isfinite(lbw), lbw + span, -np.inf),
                np.where(np.isfinite(ubw), ubw - span, np.inf))
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    Pt = p_from_numpy(P, 'cpu')
    mu = 1e-1
    cI = ocp.ineq_fn(torch.as_tensor(w), Pt).numpy()
    s = np.maximum(-cI, 1e-2)
    lam = np.maximum(mu / s, 1e-8)
    y = 0.1 * rng.normal(size=ocp.n_eq)
    dl = np.maximum(w - lbw, 1e-8)
    du = np.maximum(ubw - w, 1e-8)
    zl = np.where(np.isfinite(lbw), mu / dl, 0.)
    zu = np.where(np.isfinite(ubw), mu / du, 0.)
    return dict(w=w, s=s, y=y, lam=lam, zl=zl, zu=zu, mu=mu, lbw=lbw, ubw=ubw, free=free, P=Pt)


def test_block_kkt_matches_dense():
    """The port's tests/test_blockkkt.py::_compare: kkt_solve's direction
    against a dense condensed solve (numpy, f64) of M = W + A^T D^-1 A
    assembled from the dense structured derivatives at the delta the ladder
    settled on, at a perturbed initial guess, in the reference's
    configuration (n_k=3, d=2, the bench
    options otherwise) and tolerances (atol 1e-5 of the max, rtol 1e-4)."""
    from awebox_tpu_torch.ocp.blockkkt import make_block_kkt
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    trial = Trial(bench_options(n_k=3, d=2), 'blockkkt').build()
    ocp = trial.ocp
    st = _state_and_args(trial)
    from awebox_tpu_torch.tree import tree_map
    lane = lambda a: torch.as_tensor(np.asarray(a))[None]
    P1 = tree_map(lambda t: t[None], st['P'])
    derivs_fn, kkt_solve, _ = make_block_kkt(ocp)
    blocks = derivs_fn(lane(st['w']), lane(st['y']), lane(st['lam']), P1)
    dw, dy, dlam, ds, dzl, dzu, ok, info = kkt_solve(
        blocks, *[lane(st[k]) for k in ARGS], *(torch.as_tensor(st[k]) for k in
                                                ('lbw', 'ubw', 'free')),
        torch.tensor([st['mu']], dtype=torch.float64), 1e-6, 1e-8, 1e-8)
    assert bool(ok.all())
    delta = float(info['delta_used'][0])
    vals, jac, hess = make_structured_derivs(ocp)
    W1, Y1, L1 = lane(st['w']), lane(st['y']), lane(st['lam'])
    fval, gradf, cE, cI = (t[0].numpy() for t in vals(W1, Y1, L1, P1))
    JE, JI = (t[0].numpy() for t in jac(W1, P1))
    H = hess(W1, Y1, L1, P1)[0].numpy()
    w, s, lam, y, mu = st['w'], st['s'], st['lam'], st['y'], st['mu']
    lbw, ubw, free = st['lbw'], st['ubw'], st['free']
    dl = np.maximum(w - lbw, 1e-20)
    du = np.maximum(ubw - w, 1e-20)
    sigma = np.clip(st['zl'] / dl + st['zu'] / du, 0., 1e16)
    W = (H + np.diag(sigma)) * np.outer(free, free) + np.diag(1. - free) + delta * np.diag(free)
    A = np.concatenate([JE, JI], axis=0) * free[None, :]
    lam_safe = np.maximum(lam, 1e-12)
    D = np.concatenate([1e-8 * np.ones(ocp.n_eq), s / lam_safe + 1e-8 * np.ones(ocp.n_ineq)])
    r2 = np.concatenate([cE, cI + mu / lam_safe])
    r1 = -(gradf + A.T @ np.concatenate([y, lam]) - mu / dl + mu / du) * free
    M = W + A.T @ (A / D[:, None])
    dw_ref = np.linalg.solve(M, r1 - A.T @ (r2 / D)) * free
    dnu = (A @ dw_ref + r2) / D
    for got, ref in ((dw, dw_ref), (dy, dnu[:ocp.n_eq]), (dlam, dnu[ocp.n_eq:])):
        scale = max(1., np.abs(ref).max())
        np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-5 * scale, rtol=1e-4)
