"""Three iterations of the B=2 wind sweep (u_ref 9.5, 10.5 m/s from the
committed anchor) through the PyTorch port's make_ip_step in the JAX
package's default modes, 'block' (what 'auto' picks for this configuration)
and 'dense' (f64), each step taken by both packages from the same iterate
(the JAX package's), on the CPU. The directions come from condensed systems
of cond ~ 1e19 at these iterates, so the tolerances are the measured gaps
with room, stated below; convergence and the optima are the slow test of
tests/test_torch_batched_solver.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)


def to_t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


_cache = {}


def jax_step(mode):
    """The JAX package's fused step of ``mode`` for the bench sweep, vmapped and
    jitted once."""
    if mode not in _cache:
        from awebox_tpu.parallel.batch import make_ip_step
        _, _, lbw, ubw, free = jax_sweep(2)
        kw = dict(solve_dtype='float64') if mode == 'dense' else {}
        step = make_ip_step(jax_trial().ocp, kkt=mode, **kw)
        lb, ub, fr = (jnp.asarray(a) for a in (lbw, ubw, free))
        _cache[mode] = jax.jit(jax.vmap(lambda st, p: step(st, p, lb, ub, fr)))
    return _cache[mode]


# Lockstep agreement per iteration: the new w's gap over that iteration's
# step (max |w_port - w_jax| / max |w_jax - w_before|), and err, mu to a
# relative gap. Measured (B=2): 'dense' w 2.7e-6, 1.8e-4, 1.3e-4 of the step,
# err and mu 2e-14; 'block' w 1.4e-2, 0.11, 1.1e-2 of the step (the block
# direction is determined to ~1%: tests/test_torch_blockkkt.py), err and mu
# 2e-14. err and mu depend on the incoming iterate alone. chip_smoke.py holds
# the first iteration on the card to the CPU's within LOCKSTEP_W.
LOCKSTEP_W = {'dense': 2e-3, 'block': 0.3}
LOCKSTEP_SCALAR = {'dense': 1e-10, 'block': 1e-10}


def lockstep(mode):
    from awebox_tpu_torch.parallel.batch import make_ip_step, p_from_numpy
    state, P64, lbw, ubw, free = jax_sweep(2)
    kw = dict(solve_dtype=torch.float64) if mode == 'dense' else {}
    step_t = make_ip_step(torch_trial().ocp, kkt=mode, **kw)
    bounds = [torch.as_tensor(a) for a in (lbw, ubw, free)]
    P_t = p_from_numpy(P64, 'cpu')
    st_j = {k: jnp.asarray(v) for k, v in state.items()}
    gaps = []
    for _ in range(3):
        prev = np.asarray(st_j['w'])
        new_j = jax_step(mode)(st_j, P64)
        # each package steps from the same (the JAX package's) iterate
        new_t = step_t(to_t({k: np.asarray(v) for k, v in st_j.items()}), P_t, *bounds)
        step = np.abs(np.asarray(new_j['w']) - prev).max()
        w_gap = np.abs(new_t['w'].numpy() - np.asarray(new_j['w'])).max() / step
        scal = max(float(np.abs(new_t[k].numpy() / np.asarray(new_j[k]) - 1.).max())
                   for k in ('err', 'mu'))
        gaps.append((w_gap, scal))
        st_j = new_j
    return gaps


@pytest.mark.parametrize('mode', ['block', 'dense'])
def test_sweep_lockstep_with_the_reference(mode):
    """Three iterations of the B=2 sweep through ``mode``, each from the JAX
    package's iterate, within LOCKSTEP_W / LOCKSTEP_SCALAR."""
    gaps = lockstep(mode)
    for w_gap, scal in gaps:
        assert w_gap <= LOCKSTEP_W[mode] and scal <= LOCKSTEP_SCALAR[mode], (w_gap, scal)
