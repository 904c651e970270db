"""The structured derivatives of the PyTorch port's 6-DOF kite
(ocp/structured.py: vals, J and H over the nodes, with the beta cost in each
collocation node's scalar) against the JAX package's
make_structured_derivs(parts=True), on the CPU in f64, at n_k=2, d=2 (the
size tests/test_blockkkt.py builds its 6-DOF case at), batched over two
lanes: the initial guess and a seeded perturbation of it, with random
multipliers and the final cost weights.

Tolerances as tests/test_torch_structured.py: values 1e-12; gradient 1e-10
abs / 1e-8 rel; J 1e-9 abs / 1e-7 rel; H 1e-8 abs / 1e-6 rel.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_support import jax_sixdof_options, lanes, to_numpy_tree

torch.set_num_threads(1)
B = 2


@functools.lru_cache(maxsize=None)
def small_pair():
    from awebox_tpu.api.trial import Trial as TJ
    from awebox_tpu_torch.api.trial import Trial as TT
    from awebox_tpu_torch.configs import flagship_options
    return (TJ(jax_sixdof_options(2, 2), 'sixdof_small').build(),
            TT(flagship_options(2, 2), 'sixdof_small').build())


@functools.lru_cache(maxsize=None)
def structured_inputs():
    """Lane 0: the initial guess; lane 1: it perturbed by seeded 2% noise;
    random multipliers; the final cost weights (the beta cost's 1e3 among
    them), numpy."""
    from awebox_tpu.opti import homotopy as hm
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    tj, _ = small_pair()
    ocp = tj.ocp
    V0 = np.asarray(build_initial_guess(ocp))
    P = hm.build_p_fix(ocp, build_reference(ocp, V0))
    P['cost'] = {k: np.asarray(v) for k, v in hm.final_cost_values(ocp).items()}
    P = to_numpy_tree(P)
    assert float(P['cost']['beta']) > 0.
    rng = np.random.default_rng(29)
    w = np.stack([V0, V0 * (1. + 0.02 * rng.standard_normal(V0.shape))])
    y = rng.standard_normal((B, ocp.n_eq))
    lam = np.abs(rng.standard_normal((B, ocp.n_ineq))) + 0.1
    return w, y, lam, lanes(P, B)


@functools.lru_cache(maxsize=None)
def structured_parts():
    """Both packages' (vals, JE, JI, H) on the inputs: the JAX package's
    make_structured_derivs(parts=True) vmapped over lanes and jitted, the
    port's make_structured_derivs."""
    from awebox_tpu.ocp.structured import make_structured_derivs as make_j
    from awebox_tpu_torch.ocp.structured import make_structured_derivs as make_t
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    tj, tt = small_pair()
    w, y, lam, P = structured_inputs()
    vj, jj, hj = make_j(tj.ocp, parts=True)
    out_j = ([np.asarray(v) for v in jax.jit(jax.vmap(vj))(w, y, lam, P)],
             [np.asarray(j) for j in jax.jit(jax.vmap(jj))(w, P)],
             np.asarray(jax.jit(jax.vmap(hj))(w, y, lam, P)))
    vt, jt, ht = make_t(tt.ocp)
    wt, yt, lt = (torch.as_tensor(a) for a in (w, y, lam))
    Pt = p_from_numpy(P, 'cpu')
    out_t = ([v.numpy() for v in vt(wt, yt, lt, Pt)], [j.numpy() for j in jt(wt, Pt)],
             ht(wt, yt, lt, Pt).numpy())
    return out_j, out_t


def test_structured_values_and_gradient_match():
    (vj, _, _), (vt, _, _) = structured_parts()
    for name, a, b, atol, rtol in zip(('fval', 'gradf', 'cE', 'cI'), vj, vt,
                                      (1e-12, 1e-10, 1e-12, 1e-12),
                                      (1e-12, 1e-8, 1e-12, 1e-12)):
        assert a.shape == b.shape and a.shape[0] == B, name
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize('which', ['JE', 'JI'])
def test_structured_constraint_jacobians_match(which):
    (_, jj, _), (_, jt, _) = structured_parts()
    i = ('JE', 'JI').index(which)
    assert jj[i].shape == jt[i].shape and jj[i].shape[0] == B
    np.testing.assert_allclose(jt[i], jj[i], atol=1e-9, rtol=1e-7)


def test_structured_lagrangian_hessian_matches():
    (_, _, hj), (_, _, ht) = structured_parts()
    n = small_pair()[1].ocp.vstruct.total
    assert ht.shape == hj.shape == (B, n, n)
    np.testing.assert_allclose(ht, hj, atol=1e-8, rtol=1e-6)
    np.testing.assert_allclose(ht, np.swapaxes(ht, 1, 2), atol=1e-8, rtol=1e-6)


def test_structured_objective_is_the_dense_one():
    """The port's structured gradient and Hessian of f alone (zero
    multipliers) are the dense autodiff derivatives of its f_fn, which
    holds the beta cost at every collocation node."""
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    from awebox_tpu_torch.tree import tree_map
    _, tt = small_pair()
    w, y, lam, P = structured_inputs()
    vals_fn, _, hess_fn = make_structured_derivs(tt.ocp)
    Pt = p_from_numpy(P, 'cpu')
    wt = torch.as_tensor(w)
    zy, zl = torch.zeros(y.shape, dtype=torch.float64), torch.zeros(lam.shape, dtype=torch.float64)
    _, gradf, _, _ = vals_fn(wt, zy, zl, Pt)
    H = hess_fn(wt, zy, zl, Pt)
    comp = tt.ocp.cost_components_fn(wt[1], tree_map(lambda x: x[1], Pt))
    assert float(comp['beta_cost']) > 0.
    for b_ in range(B):
        P1 = tree_map(lambda x: x[b_], Pt)
        g = torch.func.grad(tt.ocp.f_fn)(wt[b_], P1)
        h = torch.func.hessian(tt.ocp.f_fn)(wt[b_], P1)
        np.testing.assert_allclose(gradf[b_].numpy(), g.numpy(), atol=1e-10, rtol=1e-8)
        np.testing.assert_allclose(H[b_].numpy(), h.numpy(), atol=1e-8, rtol=1e-6)
