"""The PyTorch port against the JAX package at n_k=8: the bench configuration
(Ampyx AP2, 3-DOF, power_cycle) on the finer grid of
tests/artifacts/bench_anchor_nk8_d3.npz, n=540 variables and m=515
constraints, so the augmented KKT matrix is 1055 x 1055, the size only the
blocked factor kernels take on the card. B=2 lanes at u_ref 9.5 and 10.5 m/s
from the anchor, both packages on the CPU, the LU factor (the JAX package's
CPU QR stalls near tol, tests/test_batched_refine.py:66-67).

Tolerances. The derivatives keep those of tests/test_torch_structured.py
(values 1e-12; gradient 1e-10 abs / 1e-8 rel; J 1e-9 abs / 1e-7 rel; H 1e-8
abs / 1e-6 rel). The direction and the iterations do not keep those of the
n_k=4 files, and the reason is the anchor: tests/test_torch_direction.py and
tests/test_torch_refine.py hold the LU direction to 1e-8 of the step, where
two f32 LU factors of one K(delta) with two f64 refinement sweeps agree to
~1e-10 of it. At this anchor they agree only to 2.7e-5 of the step (an f32
and an f64 LU factor, the port alone, measured on the CPU): two sweeps do not
converge the refinement here. The bounds below are set from that, and the
JAX package's and the port's LAPACKs sit inside them (measured values beside
each).

The anchor is not a starting point from which the batched refinement
converges, in either package: it is an older artifact (the host solver's
state at barrier 3.16e-5, KKT error 3.1e-4, where the n_k=4 anchor sits at
1e-9), and from it every lane's KKT error grows to O(1) within three
iterations, in the JAX package as in the port, with an f32 or an f64 factor.
test_sweep_stays_unconverged_in_both_packages (slow tier) runs both packages
to the 100-iteration cap and finds no lane latched in either.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
N_K, B = 8, 2
TOL, VERIFY_TOL = 1e-5, 1e-4


def inputs():
    """The sweep's first iterate: the anchor, lanes at 9.5 and 10.5 m/s."""
    state, P64, _, _, _ = jax_sweep(B, N_K)
    return state['w'], state['y'], state['lam'], P64


_JAX, _PORT = {}, {}


def jax_parts():
    """The JAX package's (vals, J, H) in f64, vmapped over lanes and jitted."""
    if not _JAX:
        from awebox_tpu.ocp.structured import make_structured_derivs
        vals_fn, jac_fn, hess_fn = make_structured_derivs(jax_trial(N_K).ocp, parts=True)
        w, y, lam, P = inputs()
        _JAX['vals'] = [np.asarray(v) for v in jax.jit(jax.vmap(vals_fn))(w, y, lam, P)]
        _JAX['J'] = [np.asarray(j) for j in jax.jit(jax.vmap(jac_fn))(w, P)]
        _JAX['H'] = np.asarray(jax.jit(jax.vmap(hess_fn))(w, y, lam, P))
    return _JAX


def port_parts():
    if not _PORT:
        from awebox_tpu_torch.ocp.structured import make_structured_derivs
        from awebox_tpu_torch.parallel.batch import p_from_numpy
        vals_fn, jac_fn, hess_fn = make_structured_derivs(torch_trial(N_K).ocp)
        w, y, lam, P = inputs()
        w, y, lam = (torch.as_tensor(a) for a in (w, y, lam))
        Pt = p_from_numpy(P, 'cpu')
        _PORT['vals'] = [v.numpy() for v in vals_fn(w, y, lam, Pt)]
        _PORT['J'] = [j.numpy() for j in jac_fn(w, Pt)]
        _PORT['H'] = hess_fn(w, y, lam, Pt).numpy()
    return _PORT


def test_problem_size():
    ocp = torch_trial(N_K).ocp
    assert (ocp.vstruct.total, ocp.n_eq + ocp.n_ineq) == (540, 515)
    assert anchor(N_K)['w'].shape == (540,)


def test_values_and_gradient_match():
    for name, a, b, atol, rtol in zip(('fval', 'gradf', 'cE', 'cI'), jax_parts()['vals'],
                                      port_parts()['vals'], (1e-12, 1e-10, 1e-12, 1e-12),
                                      (1e-12, 1e-8, 1e-12, 1e-12)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize('which', ['JE', 'JI'])
def test_constraint_jacobians_match(which):
    i = ('JE', 'JI').index(which)
    a, b = jax_parts()['J'][i], port_parts()['J'][i]
    assert a.shape == b.shape and a.shape[0] == B
    np.testing.assert_allclose(b, a, atol=1e-9, rtol=1e-7)


def test_lagrangian_hessian_matches():
    Hj, Ht = jax_parts()['H'], port_parts()['H']
    assert Ht.shape == Hj.shape == (B, 540, 540)
    np.testing.assert_allclose(Ht, Hj, atol=1e-8, rtol=1e-6)


def direction_inputs():
    """(state, derivs, lbw, ubw, free) numpy: the port's derivatives at the
    first iterate, J and H rounded to f32 as the direction takes them."""
    state, _, lbw, ubw, free = jax_sweep(B, N_K)
    pt = port_parts()
    derivs = pt['vals'] + [j.astype(np.float32) for j in pt['J']] + [pt['H'].astype(np.float32)]
    return state, derivs, lbw, ubw, free


# One LU direction from identical inputs: the new w to TOL_DIRECTION['w'] of
# the step, the other iterates to TOL_DIRECTION of their size (measured:
# w 2.1e-6, s 8.4e-7, y 1.4e-7, lam 1.4e-7, zu 7.4e-7, zl 1.1e-7), mu and err
# to 1e-12. The n_k=4 file's 1e-9..1e-4 rest on refinement that converges
# there; see the module docstring.
TOL_DIRECTION = {'w': 3e-5, 's': 1e-5, 'y': 1e-5, 'lam': 1e-5, 'zu': 1e-5, 'zl': 1e-5}


def test_direction_matches_jax():
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t
    state, derivs, lbw, ubw, free = direction_inputs()
    _, dir_j = make_j(jax_trial(N_K).ocp, kkt='auglu', hessian='exact', split=True,
                      kappa_mu=0.4, auglu_factor='lu')
    out_j = jax.jit(jax.vmap(lambda st, dv: dir_j(st, dv, lbw, ubw, free)))(state, tuple(derivs))
    _, dir_t = make_t(torch_trial(N_K).ocp, kkt='auglu', split=True, kappa_mu=0.4,
                      auglu_factor='lu')
    as_t = torch.as_tensor
    out_t = dir_t({k: as_t(v) for k, v in state.items()}, tuple(as_t(d) for d in derivs),
                  as_t(lbw), as_t(ubw), as_t(free))
    assert set(out_t) == set(out_j)
    step = np.abs(np.asarray(out_j['w']) - state['w']).max(axis=1, keepdims=True)
    assert (step > 0).all()
    gaps = {}
    for k in out_j:
        a, b = np.asarray(out_j[k]), out_t[k].numpy()
        if a.ndim == 1:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0, err_msg=k)
            continue
        scale = step if k == 'w' else np.abs(a).max(axis=1, keepdims=True)
        gaps[k] = float((np.abs(b - a) / scale).max())
    print('direction gaps (of the step for w, else of max |value|):', gaps)
    assert all(gaps[k] <= TOL_DIRECTION[k] for k in gaps), gaps


def jax_one_iter(eval_f32=False):
    """one_iter(state) of the JAX package on numpy inputs, the LU factor, J
    and H evaluated in f64 and rounded to f32 (what the port does) or, with
    eval_f32, in f32 (the production recipe of tests/test_batched_refine.py)."""
    from awebox_tpu.ocp.structured import make_structured_derivs
    from awebox_tpu.parallel.batch import make_ip_step
    ocp = jax_trial(N_K).ocp
    _, P64, lbw, ubw, free = jax_sweep(B, N_K)
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp, hessian='exact', parts=True)
    _, direction = make_ip_step(ocp, kkt='auglu', hessian='exact', split=True,
                                kappa_mu=0.4, auglu_factor='lu')
    vals_jit, jac_jit = jax.jit(jax.vmap(vals_fn)), jax.jit(jax.vmap(jac_fn))
    hess_jit = jax.jit(jax.vmap(hess_fn))
    dir_jit = jax.jit(jax.vmap(lambda st, dv: direction(st, dv, lbw, ubw, free)))
    P32 = jax.tree_util.tree_map(
        lambda x: x.astype(np.float32) if x.dtype == np.float64 else x, P64)

    def one_iter(st):
        if eval_f32:
            f32 = lambda k: st[k].astype(jnp.float32)
            with jax.enable_x64(False):
                JH = tuple(jac_jit(f32('w'), P32)) + (hess_jit(f32('w'), f32('y'), f32('lam'), P32),)
        else:
            JH = tuple(x.astype(jnp.float32) for x in tuple(jac_jit(st['w'], P64))
                       + (hess_jit(st['w'], st['y'], st['lam'], P64),))
        return dir_jit(st, tuple(vals_jit(st['w'], st['y'], st['lam'], P64)) + JH)
    return one_iter


def port_problem():
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    return wind_sweep_problem(torch_trial(N_K), anchor(N_K), B, device='cpu')


# Per iteration, the new w to LOCKSTEP_W of that iteration's step, err and
# mu to LOCKSTEP_SCALAR relative (measured: w 2.1e-6, 1.6e-4, 1.4e-3 of the
# step in the worse lane). The iterates leave the anchor's basin (see the
# module docstring), and the gap grows with each step as it does at n_k=4
# (1e-10, 3e-8, 1.4e-6 there).
LOCKSTEP_W = 1e-2
LOCKSTEP_SCALAR = 1e-4


def test_three_iterations_in_lockstep_with_jax():
    from awebox_tpu_torch.parallel.refine import make_refiner
    state_t, P64, lbw, ubw, free, _ = port_problem()
    one_t = make_refiner(torch_trial(N_K).ocp, lbw, ubw, free, kappa_mu=0.4, auglu_factor='lu')
    one_j = jax_one_iter()
    state_j = {k: jnp.asarray(v) for k, v in jax_sweep(B, N_K)[0].items()}
    for it in range(3):
        w_prev = np.asarray(state_j['w'])
        state_j = one_j(state_j)
        state_t = one_t(state_t, P64)
        wj, wt = np.asarray(state_j['w']), state_t['w'].numpy()
        step = np.abs(wj - w_prev).max(axis=1)
        gap = np.abs(wt - wj).max(axis=1)
        print(f'iteration {it}: w gap / step {gap / step}, err {np.asarray(state_j["err"])}')
        assert (gap <= LOCKSTEP_W * step).all(), (it, gap, step)
        for k in ('err', 'mu'):
            np.testing.assert_allclose(state_t[k].numpy(), np.asarray(state_j[k]),
                                       rtol=LOCKSTEP_SCALAR, err_msg=f'{k} {it}')


@pytest.mark.slow
def test_sweep_stays_unconverged_in_both_packages():
    """Both packages to the 100-iteration cap from the anchor, the LU
    factor, the JAX package with its production recipe (J and H evaluated in
    f32): no lane latches KKT error <= 1e-5 in either, and every iterate
    stays finite. Measured on the CPU: the JAX package's lanes end at max
    f64 |eq| 11.9 and 2.9, the port's at 41.3 and 45.1; the test takes ~8
    minutes."""
    from awebox_tpu_torch.parallel.refine import refine
    state, P64, lbw, ubw, free, _ = port_problem()
    res = refine(torch_trial(N_K).ocp, state, P64, lbw, ubw, free, tol=TOL,
                 verify_tol=VERIFY_TOL, max_iter=100, kappa_mu=0.4, auglu_factor='lu')
    assert res['n_iter'] == 100 and not bool(res['latched'].any())
    assert bool(torch.isfinite(res['state']['w']).all())
    one_j = jax_one_iter(eval_f32=True)
    st = {k: jnp.asarray(v) for k, v in jax_sweep(B, N_K)[0].items()}
    latched = np.zeros(B, dtype=bool)
    for _ in range(100):
        st = one_j(st)
        latched |= np.asarray(st['err']) <= TOL
    assert not latched.any() and np.isfinite(np.asarray(st['w'])).all()
