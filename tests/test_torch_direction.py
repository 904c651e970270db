"""The interior-point direction of the PyTorch port (parallel/batch.py and
parallel/kernels.py) against the JAX package's ``_auglu_solve`` (both
factors), ``direction`` and ``_advance_state``, in f64 on the CPU, where every kernel
wrapper runs its plain PyTorch version. The kernels themselves, which run
only on a CUDA card, are tested in test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_batch_auglu import aug_residual, make_system
from tests.test_torch_kernels import newton_inputs, step_solution
from tests.test_torch_support import jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
N_LADDER, LADDER = 7, 100.


def systems():
    """make_system saddle systems as lanes: indefinite (seeds 0, 3, 5),
    definite (seed 1), the singular leading block of
    test_auglu_ladder_recovers_singular_leading_block (seed 7), and a lane
    whose variable 2 appears nowhere (zero row and column of W0, zero column
    of A): K(delta) then pins it only through delta, |dw_2| = |r1_2| / delta
    exceeds dw_cap until the ladder has raised delta, so this lane fails
    its first attempts and is retried alone."""
    ds = [make_system(seed=s) for s in (0, 3, 5)] + [make_system(seed=1, indefinite=False)]
    d7 = make_system(seed=7)
    W0 = np.array(d7['W0'])
    W0[:5, :5] = 0.
    W0[:5, 5:] = 0.
    W0[5:, :5] = 0.
    d7['W0'] = jnp.asarray(W0)
    dz = make_system(seed=11)
    W0, A = np.array(dz['W0']), np.array(dz['A'])
    W0[2, :] = 0.
    W0[:, 2] = 0.
    A[:, 2] = 0.
    dz['W0'], dz['A'] = jnp.asarray(W0), jnp.asarray(A)
    return ds + [d7, dz]


def stacked(ds):
    return [torch.as_tensor(np.stack([np.asarray(d[k]) for d in ds]))
            for k in ('W0', 'A', 'D', 'r1', 'r2')]


# Agreement of (dw, dnu) with the JAX package, relative to max |dw| resp.
# max |dnu|. LU: both factor the same f32 matrix with LAPACK's partial-pivot
# LU and refine twice in f64, which brings either factorization to the f64
# solution of K(delta); what remains is f64 summation order (measured ~1e-15)
# and, should the two LAPACKs break a pivot tie differently, the
# (cond * eps_f32)^3 left after refinement. QR: the one guarded sweep leaves
# each side at (cond * eps_f32)^2 of its own factor, and the JAX package
# forms Q where the port applies LAPACK's reflectors (measured 4e-11 to
# 1.5e-7 on these systems).
TOL_SOLVE = {'lu': 1e-9, 'qr': 1e-5}


def auglu_solve_matches_jax(factor):
    """Same ok and the same (dw, dnu) as the JAX package, lane by lane, to
    TOL_SOLVE; with QR both sides also leave the augmented residual that
    tests/test_batch_auglu.py asks of the JAX package (2e-3 of the
    right-hand side's scale) on every lane that solved at delta_w, and the
    singular leading block is finite on both."""
    from awebox_tpu.parallel.batch import _auglu_solve as solve_j
    from awebox_tpu_torch.parallel.batch import _auglu_solve as solve_t
    ds = systems()
    n = ds[0]['n']
    W0, A, D, r1, r2 = stacked(ds)
    free = torch.ones(n, dtype=torch.float64)
    dw, dnu, ok = solve_t(W0, A, D, r1, r2, free, n, 1e-8, 1e-8, N_LADDER, LADDER,
                          factor=factor)
    assert dw.dtype == dnu.dtype == torch.float64 and ok.dtype == torch.bool
    jit_j = jax.jit(lambda W0, A, D, r1, r2, free: solve_j(
        W0, A, D, r1, r2, free, n, 1e-8, 1e-8, N_LADDER, LADDER, factor=factor)[:3])
    tol = TOL_SOLVE[factor]
    for i, d in enumerate(ds):
        dw_j, dnu_j, ok_j = (np.asarray(a) for a in jit_j(
            d['W0'], d['A'], d['D'], d['r1'], d['r2'], d['free']))
        assert bool(ok_j) == bool(ok[i]), i
        assert np.isfinite(dw[i].numpy()).all() and np.isfinite(dnu[i].numpy()).all(), i
        np.testing.assert_allclose(dw[i].numpy(), dw_j, rtol=0,
                                   atol=tol * np.abs(dw_j).max(), err_msg=str(i))
        np.testing.assert_allclose(dnu[i].numpy(), dnu_j, rtol=0,
                                   atol=tol * np.abs(dnu_j).max(), err_msg=str(i))
        if factor == 'qr' and i < 4:   # the lanes that solve at delta_w
            scale = max(np.abs(np.asarray(d['r1'])).max(), np.abs(np.asarray(d['r2'])).max())
            for sol in ((dw[i].numpy(), dnu[i].numpy()), (dw_j, dnu_j)):
                assert aug_residual(d, *sol) <= 2e-3 * scale, i
    # the ladder lane really went up the ladder: its dw_2 is r1_2 / delta at
    # the first delta (x100 steps from 1e-8) that brings |dw| under dw_cap
    r12 = float(r1[-1, 2])
    delta = 1e-8
    while abs(r12) / delta > 1e4:
        delta *= LADDER
    assert delta > 1e-8
    np.testing.assert_allclose(float(dw[-1, 2]), r12 / delta, rtol=1e-6)


def test_auglu_solve_matches_jax_lane_by_lane():
    """auglu_solve_matches_jax with the LU factor."""
    auglu_solve_matches_jax('lu')


def test_auglu_solve_qr_matches_jax_lane_by_lane():
    """auglu_solve_matches_jax with the QR factor."""
    auglu_solve_matches_jax('qr')


def ladder_retries_only_failing_lanes(factor):
    """A lane's result does not depend on which other lanes share its batch,
    and a lane that solves at the first attempt keeps that solution while
    another lane climbs the ladder."""
    from awebox_tpu_torch.parallel.batch import _auglu_solve
    ds = systems()
    n = ds[0]['n']
    free = torch.ones(n, dtype=torch.float64)
    args = (free, n, 1e-8, 1e-8, N_LADDER, LADDER)
    both = _auglu_solve(*stacked([ds[0], ds[-1]]), *args, factor=factor)
    alone = [_auglu_solve(*stacked([d]), *args, factor=factor) for d in (ds[0], ds[-1])]
    for lane in range(2):
        for k in range(2):
            np.testing.assert_allclose(both[k][lane].numpy(), alone[lane][k][0].numpy(),
                                       rtol=1e-12, atol=0)
        assert bool(both[2][lane]) and bool(alone[lane][2][0])


def test_ladder_retries_only_failing_lanes():
    """ladder_retries_only_failing_lanes with the LU factor."""
    ladder_retries_only_failing_lanes('lu')


def test_qr_ladder_retries_only_failing_lanes():
    """ladder_retries_only_failing_lanes with the QR factor."""
    ladder_retries_only_failing_lanes('qr')


def test_qr_ruiz_scale_plain_is_the_jax_formula():
    """K5's plain version against the JAX package's lines
    (awebox_tpu/parallel/batch.py:375-381) in jax.numpy f32 on the same
    K(delta_w) of the saddle systems: s and M to 1e-6 relative (the same f32
    operations in the same order; XLA's and PyTorch's sqrt and division may
    differ in the last bit, and three sweeps compound it), every row of |M|
    within [0.25, 4] of 1 at its maximum."""
    from awebox_tpu_torch.parallel import kernels
    W0, A, D, r1, r2 = stacked(systems())
    n = W0.shape[1]
    free = torch.ones(n, dtype=torch.float64)
    eq = kernels.equilibrate(W0, A, D, r1, r2, free, 1e-8)
    delta = torch.full((W0.shape[0],), 1e-8, dtype=torch.float64)
    K = kernels.kkt_assemble(eq['W32'], eq['A32'], eq['Dr32'], eq['free32'], delta)
    M, s = kernels.ruiz_scale(K)
    assert M.dtype == s.dtype == torch.float32
    for lane in range(K.shape[0]):
        Kj = jnp.asarray(K[lane].numpy())
        sj = jnp.ones(Kj.shape[0], jnp.float32)
        Mj = Kj
        for _ in range(3):
            rr = jnp.sqrt(jnp.clip(jnp.max(jnp.abs(Mj), axis=1), 1e-12, None))
            sj = sj / rr
            Mj = Kj * sj[:, None] * sj[None, :]
        assert Mj.dtype == jnp.float32
        np.testing.assert_allclose(s[lane].numpy(), np.asarray(sj), rtol=1e-6, atol=0)
        np.testing.assert_allclose(M[lane].numpy(), np.asarray(Mj), rtol=1e-6, atol=1e-30)
        row_max = np.abs(M[lane].numpy()).max(axis=1)
        assert (row_max >= 0.25).all() and (row_max <= 4.).all(), lane


def anchor_inputs():
    """(state, derivs, lbw, ubw, free) numpy: the first iteration of the
    wind sweep, two lanes at 9.5 and 10.5 m/s from the anchor. The derivatives are the port's, with J and H rounded to f32 as the
    production path hands them to the direction."""
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    state, P64, lbw, ubw, free = jax_sweep(2)
    vals_fn, jac_fn, hess_fn = make_structured_derivs(torch_trial().ocp)
    W, Y, L = (torch.as_tensor(state[k]) for k in ('w', 'y', 'lam'))
    Pt = p_from_numpy(P64, 'cpu')
    derivs = [v.numpy() for v in vals_fn(W, Y, L, Pt)] \
        + [j.to(torch.float32).numpy() for j in jac_fn(W, Pt)] \
        + [hess_fn(W, Y, L, Pt).to(torch.float32).numpy()]
    return state, derivs, lbw, ubw, free


# Agreement of the new iterates, relative to max |new - old| for w and to
# max |value| otherwise. At the anchor cond(Ks) ~ 1e9 and the two
# packages' LAPACKs factor the f32 matrix into slightly different factors,
# so after two f64 refinement sweeps the LU directions differ at ~1e-10 of
# |dw| (measured 2e-10 for w, 1e-11 for s and y). Multipliers amplify that
# gap: lam and zu by up to 1e2 (measured 1.5e-8, 3e-8), and the bound
# duals zl of the active bounds, whose w sits ~1e-8 from its relaxed bound,
# by zl/dl ~ 1e8 through dzl = mu/dl - zl - zl dw/dl (measured 7.5e-6).
# The QR direction has one guarded sweep, not two: each side stops at the
# accuracy of its own f32 factor after one refinement (the JAX package forms
# Q, the port applies LAPACK's reflectors), so the gaps are those of two
# inexact solves (measured 5.4e-4 of the step for w, 1.2e-5 for s, 3.5e-5 to
# 4.5e-5 for y, lam, zl and zu; the bounds leave 10x).
TOL_DIRECTION = {
    'lu': {'w': 1e-8, 's': 1e-9, 'y': 1e-9, 'lam': 1e-6, 'zu': 1e-6, 'zl': 1e-4},
    'qr': {'w': 5e-3, 's': 1e-4, 'y': 5e-4, 'lam': 5e-4, 'zu': 5e-4, 'zl': 5e-4},
}


def direction_at_the_anchor_matches_jax(factor):
    """One full direction (Newton system, the f32 factor with f64
    refinement, ladder, step) from identical inputs, lane by lane; mu and
    err to 1e-12, the other iterates to TOL_DIRECTION of their size (w: of
    the step)."""
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t
    state, derivs, lbw, ubw, free = anchor_inputs()
    _, dir_j = make_j(jax_trial().ocp, kkt='auglu', hessian='exact', split=True,
                      kappa_mu=0.4, auglu_factor=factor)
    out_j = jax.jit(jax.vmap(lambda st, dv: dir_j(st, dv, lbw, ubw, free)))(
        state, tuple(derivs))
    _, dir_t = make_t(torch_trial().ocp, kkt='auglu', split=True, kappa_mu=0.4,
                      auglu_factor=factor)
    as_t = lambda a: torch.as_tensor(a)
    out_t = dir_t({k: as_t(v) for k, v in state.items()}, tuple(as_t(d) for d in derivs),
                  as_t(lbw), as_t(ubw), as_t(free))
    assert set(out_t) == set(out_j)
    step = np.abs(np.asarray(out_j['w']) - state['w']).max(axis=1, keepdims=True)
    assert (step > 0).all()
    for k in out_j:
        a, b = np.asarray(out_j[k]), out_t[k].numpy()
        assert b.dtype == np.float64, k
        if k == 'w':
            scale = step
        elif a.ndim == 2:
            scale = np.abs(a).max(axis=1, keepdims=True)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0, err_msg=k)
            continue
        assert (np.abs(b - a) <= TOL_DIRECTION[factor][k] * scale).all(), \
            (k, (np.abs(b - a) / scale).max())


def test_direction_at_the_anchor_matches_jax():
    """direction_at_the_anchor_matches_jax with the LU factor."""
    direction_at_the_anchor_matches_jax('lu')


def test_qr_direction_at_the_anchor_matches_jax():
    """direction_at_the_anchor_matches_jax with the QR factor."""
    direction_at_the_anchor_matches_jax('qr')


def test_advance_state_matches_jax():
    """K4's plain version against _advance_state on random f64 states with
    active bounds (w within 1e-9 of a bound, pinned and infinite bounds),
    random directions, failed and successful lanes: 1e-14 relative (the same
    f64 operations in the same order)."""
    from awebox_tpu.parallel.batch import _advance_state
    from awebox_tpu_torch.parallel import kernels
    state0, _, lbw, ubw, free = jax_sweep(2)
    B, n = 4, lbw.shape[0]
    n_eq, n_ineq = state0['y'].shape[1], state0['s'].shape[1]
    rng = np.random.default_rng(17)
    w = np.stack([state0['w'][0]] * B) + 0.01 * rng.standard_normal((B, n))
    w = np.clip(w, np.where(np.isfinite(lbw), lbw, -np.inf),
                np.where(np.isfinite(ubw), ubw, np.inf))
    near = np.isfinite(lbw) & (rng.uniform(size=(B, n)) < 0.3)
    w = np.where(near, lbw + 1e-9, w)
    state = dict(w=w, s=np.abs(rng.standard_normal((B, n_ineq))) + 1e-6,
                 y=rng.standard_normal((B, n_eq)),
                 lam=np.abs(rng.standard_normal((B, n_ineq))) * 1e-2,
                 zl=np.abs(rng.standard_normal((B, n))),
                 zu=np.abs(rng.standard_normal((B, n))),
                 mu=np.array([1e-5, 1e-3, 1e-7, 1e-2]), err=np.full(B, np.inf))
    direction = (rng.standard_normal((B, n)), rng.standard_normal((B, n_eq)),
                 rng.standard_normal((B, n_ineq)) * 1e-2, rng.standard_normal((B, n_ineq)),
                 rng.standard_normal((B, n)), rng.standard_normal((B, n)))
    ok = np.array([True, False, True, True])
    err_d, err_k = np.abs(rng.standard_normal(B)), np.abs(rng.standard_normal(B))
    tau, kappa_mu, mu_min = 0.99, 0.4, 1e-8
    out_j = jax.jit(jax.vmap(lambda st, dr, o, ed, ek: _advance_state(
        st, dr, o, ed, lbw, ubw, n_ineq, tau, kappa_mu, mu_min, err_kkt=ek)))(
        state, direction, ok, err_d, err_k)
    as_t = torch.as_tensor
    before = dict(kernels.LAUNCHES)
    out_t = kernels.advance_state({k: as_t(v) for k, v in state.items()},
                                  tuple(as_t(d) for d in direction), as_t(ok),
                                  as_t(err_d), as_t(err_k), as_t(lbw), as_t(ubw),
                                  tau, kappa_mu, mu_min)
    assert kernels.LAUNCHES == before   # CPU tensors: the plain version ran
    assert set(out_t) == set(out_j)
    for k in out_j:
        a, b = np.asarray(out_j[k]), out_t[k].numpy()
        assert b.dtype == np.float64
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=0, err_msg=k)
    # the failed lane held its barrier, the others contracted it
    np.testing.assert_array_equal(out_t['mu'][1].numpy(), state['mu'][1])


def newton_case(case):
    """(state, derivs, lbw, ubw, free) as tensors: the anchor's first
    iteration (two lanes), or random inputs with non-finite J, H, gradf, cE
    and cI entries, pinned variables and infinite bounds."""
    if case == 'random':
        return newton_inputs()
    state, derivs, lbw, ubw, free = anchor_inputs()
    as_t = torch.as_tensor
    return ({k: as_t(v) for k, v in state.items()}, tuple(as_t(d) for d in derivs),
            as_t(lbw), as_t(ubw), as_t(free))


@pytest.mark.parametrize('case', ['anchor', 'random'])
def test_newton_kkt_plain_is_the_unfused_composition(case):
    """K1's plain version (what newton_kkt runs on CPU tensors) equals the
    unfused pieces bit for bit: newton_system, equilibrate, then
    kkt_assemble_scaled_plain at delta_w on every lane, gathered as the
    ladder's first attempt gathered them, and the f64 casts of W32 and A32
    that the refinement reads. Sanitizing leaves every output finite."""
    from awebox_tpu_torch.parallel import kernels
    state, derivs, lbw, ubw, free = newton_case(case)
    out = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
    f64 = torch.float64
    sys_ = kernels.newton_system(state, derivs, lbw, ubw, free, 1e-8)
    eq = kernels.equilibrate(sys_['W0'], sys_['A'], sys_['D'], sys_['r1'], sys_['r2'], free, 1e-8)
    idx = torch.arange(sys_['W0'].shape[0])
    delta = torch.full((len(idx),), 1e-8, dtype=f64)
    Ks, kd = kernels.kkt_assemble_scaled_plain(eq['W32'][idx], eq['A32'][idx], eq['Dr32'][idx],
                                               eq['free32'], delta)
    expect = dict(Ks=Ks, kd=kd, W64=eq['W32'].to(f64), A64=eq['A32'].to(f64), rn=eq['rn'],
                  D_reg=eq['D_reg'], Dr32=eq['Dr32'], r2_e=eq['r2_e'], b=eq['b'],
                  r1=sys_['r1'])
    assert set(out) == set(expect)
    for k, v in expect.items():
        assert torch.equal(out[k], v), k
        assert bool(torch.isfinite(out[k]).all()), k
    # the QR factor's system: the same pieces around the unscaled K(delta_w)
    out_u = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8, scaled=False)
    expect.pop('Ks'), expect.pop('kd')
    expect['K'] = kernels.kkt_assemble_plain(eq['W32'], eq['A32'], eq['Dr32'], eq['free32'], delta)
    assert set(out_u) == set(expect)
    for k, v in expect.items():
        assert torch.equal(out_u[k], v), k


@pytest.mark.parametrize('case', ['anchor', 'random'])
def test_ip_step_plain_is_the_unfused_step(case):
    """K4's plain version (what ip_step runs on CPU tensors) equals, bit for
    bit, the unfused lines: dw and dnu from the solution x, sanitized by ok
    and finiteness, ds, dzl, dzu, err_d and err_p from newton_system's
    sanitized values and dl, du, then advance_state. On the anchor x is the
    ladder's solution; the random case has a NaN entry and a failed lane,
    whose barrier is held."""
    from awebox_tpu_torch.parallel import batch, kernels
    state, derivs, lbw, ubw, free = newton_case(case)
    n, n_eq, n_ineq = free.shape[0], state['y'].shape[1], state['s'].shape[1]
    sys_k = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
    if case == 'anchor':
        x, ok = batch._ladder_solve(sys_k, free, n, 1e-8, N_LADDER, LADDER)
        assert bool(ok.all())
    else:
        x, ok = step_solution(*sys_k['b'].shape)
    ds = torch.empty(x.shape[0], n_ineq, dtype=torch.float64)
    args = (lbw, ubw, 0.99, 0.4, 1e-8)
    out = kernels.ip_step(x, ok, sys_k['rn'], sys_k['r1'], state, derivs, lbw, ubw, free,
                          *args[2:], ds_out=ds)
    sys_ = kernels.newton_system(state, derivs, lbw, ubw, free, 1e-8)
    s, zl, zu, m_ = state['s'], state['zl'], state['zu'], state['mu'][:, None]
    dw, dnu = x[:, :n] * free, sys_k['rn'] * x[:, n:]
    okc = ok[:, None]
    dw = torch.where(okc & torch.isfinite(dw), dw, 0.)
    dnu = torch.where(okc & torch.isfinite(dnu), dnu, 0.)
    dy, dlam = dnu[:, :n_eq].contiguous(), dnu[:, n_eq:].contiguous()
    ds_ref = -(sys_['cI'] + s) - (sys_['JI'].to(dw.dtype) @ dw[:, :, None])[:, :, 0]
    dzl = m_ / sys_['dl'] - zl - zl * dw / sys_['dl']
    dzu = m_ / sys_['du'] - zu + zu * dw / sys_['du']
    err_d = torch.abs(sys_['r1']).amax(dim=1)
    err_p = torch.maximum(torch.abs(sys_['cE']).amax(dim=1),
                          torch.abs(sys_['cI'] + s).amax(dim=1))
    ref = kernels.advance_state(state, (dw, dy, dlam, ds_ref, dzl, dzu), ok, err_d,
                                torch.maximum(err_d, err_p), *args)
    assert torch.equal(ds, ds_ref)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert torch.equal(out[k], v), k
        assert bool(torch.isfinite(v).all()), k
    if case == 'random':
        assert torch.equal(out['mu'][1], state['mu'][1])


def test_lu_plain_solves_like_jax_lu():
    """K2+K3's plain versions (torch.linalg) against
    jax.scipy.linalg.lu_factor/lu_solve on the same scaled f32 systems:
    both solutions leave a scaled residual at f32 level (the factors may
    differ by pivot ties; solutions are compared through residuals)."""
    from awebox_tpu_torch.parallel import kernels
    rng = np.random.default_rng(4)
    B, N = 3, 40
    Ks = rng.standard_normal((B, N, N)).astype(np.float32) + 5 * np.eye(N, dtype=np.float32)
    kd = rng.uniform(0.5, 2.0, (B, N)).astype(np.float32)
    v = rng.standard_normal((B, N)).astype(np.float32)
    lu, piv = kernels.lu_factor_batched(torch.as_tensor(Ks))
    assert piv.dtype == torch.int32 and int(piv.min()) >= 1
    x = kernels.lu_solve_batched(lu, piv, torch.as_tensor(kd), torch.as_tensor(v)).numpy()
    for b in range(B):
        lj = jax.scipy.linalg.lu_factor(jnp.asarray(Ks[b]))
        xj = np.asarray(kd[b] * jax.scipy.linalg.lu_solve(lj, kd[b] * v[b]))
        for sol in (x[b], xj):
            res = Ks[b].astype(np.float64) @ (sol / kd[b]) - kd[b] * v[b]
            assert np.abs(res).max() <= 1e-5 * np.abs(kd[b] * v[b]).max()
        np.testing.assert_allclose(x[b], xj, rtol=1e-4, atol=1e-5)
