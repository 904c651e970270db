"""Model parity of the PyTorch port (model/builder.py::make_model and the
physics below it) against the JAX package, in f64.

Tolerance: 1e-12, absolute and relative. Both packages evaluate the same
formulas in the same order; what differs is the summation order inside
dot products and reductions, worth a few ulp of the O(1..1e3) values.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import (anchor, jax_final_P, jax_trial,
                                      torch_trial)

torch.set_num_threads(1)
TOL = 1e-12
PHI_DIM = 7


def node_vectors(perturb):
    """Model-variable vectors at every shooting and collocation node of the
    anchor, optionally perturbed by seeded 5% noise so the residuals are
    far from zero."""
    ocp = jax_trial().ocp
    shooting, coll = ocp.assemble_nodes_fn(jnp.asarray(anchor()['w']))
    nodes = np.concatenate([np.asarray(shooting), np.asarray(coll)])
    if perturb:
        rng = np.random.default_rng(11)
        nodes = nodes * (1. + 0.05 * rng.standard_normal(nodes.shape))
    phi = np.asarray(ocp.vstruct.get_phi(anchor()['w']))
    return nodes, phi


def theta0_pair():
    from awebox_tpu_torch.tree import to_tensors
    th = jax_final_P()['theta0']
    return th, to_tensors(th, torch.float64, 'cpu')


def test_assembled_nodes_equal():
    w = anchor()['w']
    sj, cj = jax_trial().ocp.assemble_nodes_fn(jnp.asarray(w))
    st, ct = torch_trial().ocp.assemble_nodes_fn(torch.as_tensor(w))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=TOL, atol=TOL)


@pytest.mark.parametrize('perturb', [False, True], ids=['anchor', 'perturbed'])
@pytest.mark.parametrize('fn', ['eq_fn', 'ineq_fn', 'power_fn'])
def test_model_functions_match_at_every_node(fn, perturb):
    nodes, phi = node_vectors(perturb)
    th_j, th_t = theta0_pair()
    f_j = jax.jit(jax.vmap(getattr(jax_trial().model, fn), in_axes=(0, None, None)))
    f_t = torch.func.vmap(getattr(torch_trial().model, fn), in_dims=(0, None, None))
    a = np.asarray(f_j(jnp.asarray(nodes), jnp.asarray(phi), th_j))
    b = f_t(torch.as_tensor(nodes), torch.as_tensor(phi), th_t).numpy()
    assert a.shape == b.shape == (nodes.shape[0],) + a.shape[1:]
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_model_outputs_match():
    nodes, phi = node_vectors(True)
    th_j, th_t = theta0_pair()
    oj = jax.jit(jax_trial().model.outputs_fn)(jnp.asarray(nodes[5]), jnp.asarray(phi), th_j)
    ot = torch_trial().model.outputs_fn(torch.as_tensor(nodes[5]), torch.as_tensor(phi), th_t)
    flat_j = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(oj)}
    flat_t = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_leaves_with_path(
                  ot, is_leaf=lambda x: isinstance(x, torch.Tensor))}
    assert set(flat_j) == set(flat_t)
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def test_stability_derivatives_match():
    """6-DOF stability-derivative tables at random inputs (the 3-DOF slice
    does not call them; the port carries the module for 6-DOF)."""
    from awebox_tpu.model.aero import stability_derivatives as sd_j
    from awebox_tpu_torch.model.aero import stability_derivatives as sd_t
    from awebox_tpu_torch.tree import to_tensors
    model = jax_trial().model
    structure = model.cfg['stab_derivs_structure']
    th_j = jax_final_P()['theta0']
    th_t = to_tensors(th_j, torch.float64, 'cpu')
    rng = np.random.default_rng(3)
    for _ in range(6):
        alpha, beta = rng.uniform(-0.2, 0.2, 2)
        airspeed = rng.uniform(10, 40)
        omega, delta = rng.standard_normal(3), rng.standard_normal(3) * 0.1
        inputs = [np.asarray(x, dtype=np.float64)
                  for x in (alpha, beta, airspeed, omega, delta)]
        out_j = sd_j.evaluate(structure, *(jnp.asarray(x) for x in inputs),
                              th_j, 'control', 'control')
        out_t = sd_t.evaluate(structure, *(torch.as_tensor(x) for x in inputs),
                              th_t, 'control', 'control')
        for a, b in zip(out_j, out_t):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)


@pytest.mark.parametrize('wind_model', ['power', 'log_wind', 'uniform'])
@pytest.mark.parametrize('atmosphere', ['isa', 'uniform'])
def test_wind_and_atmosphere_profiles_match(wind_model, atmosphere):
    from awebox_tpu.model import atmosphere as atm_j, wind as wind_j
    from awebox_tpu_torch.model import atmosphere as atm_t, wind as wind_t
    from awebox_tpu_torch.tree import to_tensors
    th_j = jax_final_P()['theta0']
    th_t = to_tensors(th_j, torch.float64, 'cpu')
    zz = np.linspace(-5., 600., 37)
    pairs = [
        (wind_j.get_velocity(wind_model, th_j['wind'], jnp.asarray(zz)),
         wind_t.get_velocity(wind_model, th_t['wind'], torch.as_tensor(zz))),
        (atm_j.get_density(atmosphere, th_j['atmosphere'], jnp.asarray(zz)),
         atm_t.get_density(atmosphere, th_t['atmosphere'], torch.as_tensor(zz))),
        (atm_j.get_viscosity(atmosphere, th_j['atmosphere'], jnp.asarray(zz)),
         atm_t.get_viscosity(atmosphere, th_t['atmosphere'], torch.as_tensor(zz))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)
