"""Structured-derivative parity of the PyTorch port
(ocp/structured.py::make_local_kit, make_structured_derivs) against the JAX
package's ``make_structured_derivs(parts=True)``, batched over two lanes:
the anchor itself and a seeded perturbation of it.

Tolerances, in f64, mirror tests/test_structured.py (structured vs dense
autodiff in the JAX package): values 1e-12; gradient 1e-10 abs / 1e-8 rel;
J 1e-9 abs / 1e-7 rel; H 1e-8 abs / 1e-6 rel. The AD graphs of the two
frameworks (forward-over-reverse Hessians through the Euler-Lagrange
dynamics) sum third-order terms in different orders, and H reaches entries
of O(1e6) at the anchor.

The f32 gap (the port's f32 J/H, evaluated in f64 and rounded, against the
JAX package's J/H evaluated in f32) is printed and not gated.
"""
import numpy as np
import pytest
import torch

import jax

from tests.test_torch_support import jax_sweep, jax_trial, torch_trial

torch.set_num_threads(1)
B = 2


def inputs():
    """Lane 0: the anchor at 9.5 m/s; lane 1: the anchor perturbed by
    seeded 2% noise (w), with random multipliers, at 10.5 m/s."""
    state, P64, _, _, _ = jax_sweep(B)
    rng = np.random.default_rng(5)
    w, y, lam = state['w'].copy(), state['y'].copy(), state['lam'].copy()
    w[1] = w[1] * (1. + 0.02 * rng.standard_normal(w.shape[1]))
    y[1] = rng.standard_normal(y.shape[1])
    lam[1] = np.abs(rng.standard_normal(lam.shape[1])) + 0.1
    return w, y, lam, P64


_JAX = {}


def jax_parts(dtype):
    """The JAX package's (vals, J, H) on the inputs, vmapped over lanes and
    jitted, in f64 or (as bench.py runs them) in f32."""
    if dtype in _JAX:
        return _JAX[dtype]
    from awebox_tpu.ocp.structured import make_structured_derivs
    vals_fn, jac_fn, hess_fn = make_structured_derivs(jax_trial().ocp, parts=True)
    w, y, lam, P = inputs()
    if dtype == 'f64':
        vals = jax.jit(jax.vmap(vals_fn))(w, y, lam, P)
        J = jax.jit(jax.vmap(jac_fn))(w, P)
        H = jax.jit(jax.vmap(hess_fn))(w, y, lam, P)
    else:
        f32 = lambda x: np.asarray(x, np.float32) if np.asarray(x).dtype == np.float64 else x
        w, y, lam = f32(w), f32(y), f32(lam)
        P = jax.tree_util.tree_map(f32, P)
        with jax.enable_x64(False):
            J = jax.jit(jax.vmap(jac_fn))(w, P)
            H = jax.jit(jax.vmap(hess_fn))(w, y, lam, P)
        vals = None
    out = (None if vals is None else [np.asarray(v) for v in vals],
           [np.asarray(j) for j in J], np.asarray(H))
    _JAX[dtype] = out
    return out


_PORT = {}


def port_parts():
    if not _PORT:
        from awebox_tpu_torch.ocp.structured import make_structured_derivs
        from awebox_tpu_torch.parallel.batch import p_from_numpy
        vals_fn, jac_fn, hess_fn = make_structured_derivs(torch_trial().ocp)
        w, y, lam, P = inputs()
        w, y, lam = (torch.as_tensor(a) for a in (w, y, lam))
        Pt = p_from_numpy(P, 'cpu')
        _PORT['vals'] = [v.numpy() for v in vals_fn(w, y, lam, Pt)]
        _PORT['J'] = [j.numpy() for j in jac_fn(w, Pt)]
        _PORT['H'] = hess_fn(w, y, lam, Pt).numpy()
    return _PORT


def test_values_and_gradient_match():
    vj, _, _ = jax_parts('f64')
    vt = port_parts()['vals']
    for name, a, b, atol, rtol in zip(('fval', 'gradf', 'cE', 'cI'), vj, vt,
                                      (1e-12, 1e-10, 1e-12, 1e-12),
                                      (1e-12, 1e-8, 1e-12, 1e-12)):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize('which', ['JE', 'JI'])
def test_constraint_jacobians_match(which):
    _, Jj, _ = jax_parts('f64')
    i = ('JE', 'JI').index(which)
    a, b = Jj[i], port_parts()['J'][i]
    assert a.shape == b.shape and a.shape[0] == B
    np.testing.assert_allclose(b, a, atol=1e-9, rtol=1e-7)


def test_lagrangian_hessian_matches():
    _, _, Hj = jax_parts('f64')
    Ht = port_parts()['H']
    assert Ht.shape == Hj.shape == (B, 280, 280)
    np.testing.assert_allclose(Ht, Hj, atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(Ht, np.swapaxes(Ht, 1, 2), atol=1e-8, rtol=1e-6)


def test_f32_gap_to_jax_f32_is_reported():
    """Not a gate: how far the JAX package's f32-evaluated J/H lie from the
    port's f32 J/H (f64 evaluation, then rounded), relative to max |entry|."""
    _, Jj, Hj = jax_parts('f32')
    pt = port_parts()
    gaps = {}
    for name, a, b in (('JE', Jj[0], pt['J'][0]), ('JI', Jj[1], pt['J'][1]),
                       ('H', Hj, pt['H'])):
        b32 = b.astype(np.float32)
        assert np.isfinite(a).all() and np.isfinite(b32).all()
        gaps[name] = float(np.abs(a.astype(np.float64) - b32).max()
                           / np.abs(b32).max())
    print('f32 gap, JAX f32 vs port, relative to max |entry|:', gaps)
