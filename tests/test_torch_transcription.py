"""Transcription parity of the PyTorch port (ocp/transcription.py::build_ocp)
against the JAX package, in f64, on the bench configuration.

Tolerance: 1e-12, absolute and relative, for objective, equalities and
inequalities. Both packages evaluate the same per-node formulas; what
differs is the summation order inside dot products, worth a few ulp of the
O(1..1e3) values. The port's own dynamics residual at the committed anchor
must clear 1e-4, the load-and-verify rule of tests/conftest.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_final_P, jax_trial, torch_trial

torch.set_num_threads(1)
TOL = 1e-12


def points():
    """The anchor w and a seeded 2% perturbation of it (residuals far from
    zero, every inequality row live)."""
    w = anchor()['w']
    rng = np.random.default_rng(21)
    return {'anchor': w, 'perturbed': w * (1. + 0.02 * rng.standard_normal(w.shape))}


def P_pair():
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    P = jax_final_P()
    return P, p_from_numpy(P, 'cpu')


@pytest.mark.parametrize('where', ['anchor', 'perturbed'])
@pytest.mark.parametrize('fn', ['f_fn', 'eq_fn', 'ineq_fn'])
def test_nlp_functions_match(fn, where):
    w = points()[where]
    Pj, Pt = P_pair()
    a = np.asarray(jax.jit(getattr(jax_trial().ocp, fn))(jnp.asarray(w), Pj))
    b = getattr(torch_trial().ocp, fn)(torch.as_tensor(w), Pt).numpy()
    assert a.shape == b.shape
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


def test_cost_components_period_and_energy_match():
    w = points()['perturbed']
    Pj, Pt = P_pair()
    oj, ot = jax_trial().ocp, torch_trial().ocp
    cj = jax.jit(oj.cost_components_fn)(jnp.asarray(w), Pj)
    ct = ot.cost_components_fn(torch.as_tensor(w), Pt)
    # the port computes the components a power_cycle objective reads; the
    # landing and transition terms belong to trajectory types it refuses
    assert set(cj) - set(ct) == {'nominal_landing_cost', 'transition_cost'}
    assert set(ct) <= set(cj)
    for k in ct:
        np.testing.assert_allclose(float(ct[k]), float(cj[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    pairs = [(oj.time_period_fn(jnp.asarray(w)), ot.time_period_fn(torch.as_tensor(w))),
             (oj.tf_per_k_fn(jnp.asarray(w)), ot.tf_per_k_fn(torch.as_tensor(w))),
             (oj.e_final_si_fn(jnp.asarray(w), Pj),
              ot.e_final_si_fn(torch.as_tensor(w), Pt))]
    for a, b in pairs:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=TOL, atol=TOL)


def test_anchor_is_feasible_in_the_port():
    """The committed anchor passes the port's own f64 dynamics check, and
    its bounds hold it: the refinement starts from a solved state."""
    _, Pt = P_pair()
    tt = torch_trial()
    w = torch.as_tensor(anchor()['w'])
    eq = tt.ocp.eq_fn(w, Pt)
    assert eq.shape == (tt.ocp.n_eq,)
    assert float(eq.abs().max()) <= 1e-4
    assert float(tt.ocp.ineq_fn(w, Pt).max()) <= 1e-6


def test_node_vmaps_match_per_node_loops():
    """The port's vmapped node evaluations (transcription.py eq_fn) equal a
    Python loop over nodes of the model's eq_fn: vmap changes no value."""
    from awebox_tpu_torch.model.builder import take
    _, Pt = P_pair()
    ocp = torch_trial().ocp
    w = torch.as_tensor(points()['perturbed'])
    phi = ocp.vstruct.get_phi(w)
    shooting, coll = ocp.assemble_nodes_fn(w)
    eq = ocp.eq_fn(w, Pt)
    sl_c, sl_s = ocp.eq_slices['collocation'], ocp.eq_slices['shooting']
    loop_c = torch.cat([ocp.model.eq_fn(v, phi, Pt['theta0']) for v in coll])
    loop_s = torch.cat([take(ocp.model.eq_fn(v, phi, Pt['theta0']), ocp.keep_rows)
                        for v in shooting])
    np.testing.assert_allclose(eq[sl_c].numpy(), loop_c.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(eq[sl_s].numpy(), loop_s.numpy(), rtol=TOL, atol=TOL)
