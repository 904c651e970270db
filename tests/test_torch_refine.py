"""The batched wind-sweep refinement of the PyTorch port
(parallel/refine.py) against the JAX package's production recipe
(tests/test_batched_refine.py, bench.py:384-395): B=2 lanes at u_ref 9.5 and
10.5 m/s continue from the committed anchor to their own optima.

The JAX side evaluates J and H in f32; the port evaluates them in f64 and
rounds to f32 (see awebox_tpu_torch/parallel/refine.py). Both then run the
f32-factored direction with f64 refinement on an f64 state.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
B = 2
TOL, VERIFY_TOL = 1e-5, 1e-4


def jax_refiner(eval_f32, factor='lu'):
    """one_iter(state) of the JAX package on numpy inputs, its direction
    through the ``factor`` factor. With eval_f32 it
    is the production recipe of tests/test_batched_refine.py (J and H
    evaluated in f32); without, J and H are evaluated in f64 and rounded to
    f32, which is what the port does."""
    from awebox_tpu.ocp.structured import make_structured_derivs
    from awebox_tpu.parallel.batch import make_ip_step
    ocp = jax_trial().ocp
    _, P64, lbw, ubw, free = jax_sweep(B)
    P32 = jax.tree_util.tree_map(
        lambda x: x.astype(np.float32) if x.dtype == np.float64 else x, P64)
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp, hessian='exact', parts=True)
    _, direction = make_ip_step(ocp, kkt='auglu', hessian='exact', split=True,
                                kappa_mu=0.4, auglu_factor=factor)
    jac_jit, hess_jit = jax.jit(jax.vmap(jac_fn)), jax.jit(jax.vmap(hess_fn))
    vals_jit = jax.jit(jax.vmap(vals_fn))
    dir_jit = jax.jit(jax.vmap(lambda st, dv: direction(st, dv, lbw, ubw, free)))

    def derivs_f32(st):
        f32 = lambda k: st[k].astype(jnp.float32)
        with jax.enable_x64(False):
            return tuple(jac_jit(f32('w'), P32)) + (hess_jit(f32('w'), f32('y'), f32('lam'), P32),)

    def derivs_f64_rounded(st):
        J = jac_jit(st['w'], P64)
        H = hess_jit(st['w'], st['y'], st['lam'], P64)
        return tuple(x.astype(jnp.float32) for x in tuple(J) + (H,))

    derivs = derivs_f32 if eval_f32 else derivs_f64_rounded

    def one_iter(st):
        dv = tuple(vals_jit(st['w'], st['y'], st['lam'], P64)) + derivs(st)
        return dir_jit(st, dv)
    return one_iter


def port_problem():
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    return wind_sweep_problem(torch_trial(), anchor(), B, device='cpu')


# Lockstep agreement per iteration: the new w to LOCKSTEP_W of that
# iteration's step, err and mu to LOCKSTEP_SCALAR relative. LU: the first
# directions agree to ~1e-10 of the step (test_torch_direction); each
# iteration at cond(Ks) ~ 1e9 amplifies the gap ~40x (measured 1e-10, 3e-8,
# 1.4e-6 of the step; err and mu within 3e-9 relative). QR: one guarded
# sweep leaves each package at the accuracy of its own f32 factor, so the
# first directions already differ by 5.4e-4 of the step (test_torch_direction)
# and the iterates move apart and together again with the steps' sizes
# (measured 5.4e-4, 3.7e-2, 2.8e-3 of the step; err within 7.1e-4 relative, mu
# equal).
LOCKSTEP_W = {'lu': 1e-5, 'qr': 0.3}
LOCKSTEP_SCALAR = {'lu': 1e-6, 'qr': 1e-2}


def lockstep_with_jax(factor):
    """Both packages iterate independently from the same state, each
    evaluating J and H in f64 and rounding them to f32, through the same
    factor. After each of 3 iterations the new w, the KKT errors and the
    barriers agree to LOCKSTEP_W / LOCKSTEP_SCALAR. The production recipe
    (J and H evaluated in f32) moves w by ~6e-3 in the first step alone, in
    the JAX package as in the port: test_converged_lanes_match_jax compares
    that recipe where it ends, at the optimum."""
    from awebox_tpu_torch.parallel.refine import make_refiner
    state_t, P64, lbw, ubw, free, _ = port_problem()
    one_t = make_refiner(torch_trial().ocp, lbw, ubw, free, kappa_mu=0.4, auglu_factor=factor)
    one_j = jax_refiner(eval_f32=False, factor=factor)
    state_j = {k: jnp.asarray(v) for k, v in jax_sweep(B)[0].items()}
    for it in range(3):
        w_prev = np.asarray(state_j['w'])
        state_j = one_j(state_j)
        state_t = one_t(state_t, P64)
        wj, wt = np.asarray(state_j['w']), state_t['w'].numpy()
        step = np.abs(wj - w_prev).max(axis=1)
        gap = np.abs(wt - wj).max(axis=1)
        assert (gap <= LOCKSTEP_W[factor] * step).all(), (it, gap, step)
        for k in ('err', 'mu'):
            np.testing.assert_allclose(state_t[k].numpy(), np.asarray(state_j[k]),
                                       rtol=LOCKSTEP_SCALAR[factor], err_msg=f'{k} {it}')


def test_three_iterations_in_lockstep_with_jax():
    """lockstep_with_jax with the LU factor."""
    lockstep_with_jax('lu')


def converges_both_lanes(factor):
    """The port alone, to convergence (the assertions of
    tests/test_batched_refine.py): both lanes latch KKT error <= 1e-5, the
    f64 dynamics residual of the final iterates is <= 1e-4, and the two
    wind lanes reach different optima. With LAPACK's QR on the CPU the port
    does not stall at the tolerance, as tests/test_batched_refine.py says
    of the JAX package's CPU QR, but its inexact directions (one guarded
    sweep) take 52 iterations where LU takes 22
    (tests/test_torch_refine_qr.py, slow tier); both end at the same
    average power to 1e-7 relative (10120.212 and 11947.573 W)."""
    from awebox_tpu_torch.parallel.refine import average_power, refine
    state, P64, lbw, ubw, free, _ = port_problem()
    res = refine(torch_trial().ocp, state, P64, lbw, ubw, free, tol=TOL,
                 verify_tol=VERIFY_TOL, max_iter=100, kappa_mu=0.4, auglu_factor=factor)
    assert bool(res['latched'].all()), (res['state']['err'], res['n_iter'])
    assert bool((res['eq_res'] <= VERIFY_TOL).all()), res['eq_res']
    assert bool(res['converged'].all())
    W = res['state']['w'].numpy()
    assert np.abs(W[0] - W[1]).max() > 1e-3
    for v in res['state'].values():
        assert v.dtype == torch.float64
    # more wind, more power
    power = average_power(torch_trial().ocp, res['state']['w'], P64).numpy()
    assert np.isfinite(power).all() and power[1] > power[0] > 0
    np.testing.assert_allclose(power, [10120.212, 11947.573], rtol=1e-6)


def test_port_converges_both_lanes():
    """converges_both_lanes with the LU factor."""
    converges_both_lanes('lu')


@pytest.mark.slow
def test_converged_lanes_match_jax():
    """Full convergence, the port against the JAX package's production
    recipe (J and H evaluated in f32). Both latch in the same number of
    iterations (22 measured) and reach the same average power to 1e-6
    relative (measured 3e-8). The final iterates agree to 1e-2 in scaled
    units (measured 5.9e-3): the optimum is flat along directions that move
    w by ~1e-3 and the power by ~1e-8, so where a latched lane stops along
    them depends on the f32 rounding of J and H; the JAX package's own two
    recipes (f32-evaluated vs f64-evaluated and rounded) end 5.5e-3 apart."""
    from awebox_tpu_torch.parallel.refine import average_power, refine
    state, P64, lbw, ubw, free, _ = port_problem()
    ocp_t, ocp_j = torch_trial().ocp, jax_trial().ocp
    res = refine(ocp_t, state, P64, lbw, ubw, free, tol=TOL,
                 verify_tol=VERIFY_TOL, max_iter=100, kappa_mu=0.4, auglu_factor='lu')
    one_j = jax_refiner(eval_f32=True)
    state_j = {k: jnp.asarray(v) for k, v in jax_sweep(B)[0].items()}
    latched = np.zeros(B, dtype=bool)
    for it in range(100):
        state_j = one_j(state_j)
        latched |= np.asarray(state_j['err']) <= TOL
        if latched.all():
            break
    assert latched.all() and bool(res['latched'].all())
    assert abs((it + 1) - res['n_iter']) <= 2, (it + 1, res['n_iter'])
    P_j = jax_sweep(B)[1]
    W_j = state_j['w']
    power_j = np.asarray(jax.vmap(ocp_j.e_final_si_fn)(W_j, P_j)
                         / jax.vmap(ocp_j.time_period_fn)(W_j))
    power_t = average_power(ocp_t, res['state']['w'], P64).numpy()
    np.testing.assert_allclose(power_t, power_j, rtol=1e-6)
    np.testing.assert_allclose(res['state']['w'].numpy(), np.asarray(W_j),
                               rtol=0, atol=1e-2)
