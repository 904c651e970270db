"""Bookkeeping parity of the PyTorch port: option trees, layouts, index
arrays, collocation coefficients, bounds, initial guess, P tree and the
final-step bounds must be IDENTICAL to the JAX package's on the bench
configuration (no tolerance: these are build-time numpy computations that
the port carries over unchanged)."""
import numpy as np
import pytest
import torch

from tests.test_torch_support import jax_trial, torch_trial, to_numpy_tree

torch.set_num_threads(1)


def assert_tree_equal(a, b, path='root'):
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        # key sets, not order: jax.tree_util rebuilds dicts with sorted keys
        assert sorted(a, key=str) == sorted(b, key=str), (path, list(a), list(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    elif isinstance(a, slice):
        assert a == b, path
    elif hasattr(a, 'parent_map'):   # each package's own Architecture class
        assert a.parent_map == b.parent_map, path
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def test_options_trees_equal():
    from awebox_tpu_torch.configs import bench_options
    from tests.test_torch_support import jax_bench_options
    assert_tree_equal(jax_bench_options().as_dict(), bench_options().as_dict())
    assert_tree_equal(jax_trial().options, torch_trial().options)


def test_model_layout_and_static_data_equal():
    mj, mt = jax_trial().model, torch_trial().model
    assert mj.layout.entries == mt.layout.entries
    assert mj.layout.slices == mt.layout.slices
    assert mj.layout.type_offsets == mt.layout.type_offsets
    assert mj.gc_names == mt.gc_names
    assert_tree_equal(mj.cfg, mt.cfg)
    assert_tree_equal(mj.scaling, mt.scaling)
    assert_tree_equal(mj.theta0_init, mt.theta0_init)
    assert_tree_equal(mj.variable_bounds_scaled, mt.variable_bounds_scaled)
    assert mj.eq_slices == mt.eq_slices
    assert mj.ineq_slices == mt.ineq_slices
    assert np.array_equal(mj.scale_full, mt.scale_full)


def test_ocp_layout_and_coefficients_equal():
    oj, ot = jax_trial().ocp, torch_trial().ocp
    vj, vt = oj.vstruct, ot.vstruct
    for attr in ('n_k', 'd', 'nx', 'nu', 'nxd', 'nz', 'theta_names',
                 'theta_dims', 'offsets', 'total', 'u_param', 'with_xi'):
        assert getattr(vj, attr) == getattr(vt, attr), attr
    for attr in ('tau_root', 'coeff_collocation', 'coeff_continuity',
                 'quad_weights'):
        assert np.array_equal(getattr(oj.coll, attr), getattr(ot.coll, attr)), attr
    assert oj.eq_slices == ot.eq_slices and oj.ineq_slices == ot.ineq_slices
    assert (oj.n_eq, oj.n_ineq) == (ot.n_eq, ot.n_ineq) == (247, 16)
    assert vt.total == 280
    # keep_rows: the JAX package selects them from a jacfwd at a seeded
    # test point, the port from torch.func.jacfwd at the same point
    assert np.array_equal(np.asarray(oj.keep_rows), ot.keep_rows)
    assert np.array_equal(np.asarray(oj.periodic_idx), ot.periodic_idx)
    assert np.array_equal(np.asarray(oj.cat_mask_matrix), ot.cat_mask_matrix)
    assert oj.normalization == ot.normalization
    assert np.array_equal(oj.phase_idx, ot.phase_idx)
    assert oj.switch_kdx == ot.switch_kdx


def test_nominal_bounds_equal():
    tj, tt = jax_trial(), torch_trial()
    assert np.array_equal(tj.lb_nominal, tt.lb_nominal)
    assert np.array_equal(tj.ub_nominal, tt.ub_nominal)


def test_structured_index_maps_equal():
    from awebox_tpu.ocp.structured import make_local_kit as kit_j
    from awebox_tpu_torch.ocp.structured import make_local_kit as kit_t
    kj, kt = kit_j(jax_trial().ocp), kit_t(torch_trial().ocp)
    for attr in ('coll_idx', 'sh_idx', 'theta_idx', 'phi_idx', 'c_rows',
                 'sel_rows', 'phase_ws', 'int_ws', 'sh_phase_ws', 'glob_idx',
                 'lin_rows', 'lin_cols', 'lin_vals', 'cat_mask', 'cont'):
        assert np.array_equal(np.asarray(getattr(kj, attr)),
                              np.asarray(getattr(kt, attr))), attr
    assert kj.ineq_lin == kt.ineq_lin
    for attr in ('n', 'n_k', 'd', 'n_eq_m', 'n_ineq_m', 'n_sh', 'tf_dim'):
        assert getattr(kj, attr) == getattr(kt, attr), attr


def test_initial_guess_P_and_final_bounds_equal():
    from awebox_tpu.opti import homotopy as hj
    from awebox_tpu.opti.initialization import (build_initial_guess as igj,
                                                build_reference as rfj)
    from awebox_tpu.opti.ipsolver import InteriorPointSolver as IPj
    from awebox_tpu_torch.opti import homotopy as ht
    from awebox_tpu_torch.opti.initialization import (build_initial_guess as igt,
                                                      build_reference as rft)
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver as IPt
    tj, tt = jax_trial(), torch_trial()
    V0j, V0t = igj(tj.ocp), igt(tt.ocp)
    assert np.array_equal(V0j, V0t)
    Pj = to_numpy_tree(hj.build_p_fix(tj.ocp, rfj(tj.ocp, V0j)))
    Pt = ht.build_p_fix(tt.ocp, rft(tt.ocp, V0t))
    assert_tree_equal(Pj, Pt)
    assert hj.final_cost_values(tj.ocp) == ht.final_cost_values(tt.ocp)
    assert_tree_equal(hj.define_schedule(tj.ocp), ht.define_schedule(tt.ocp))
    lbj, ubj = hj.final_bounds(tj.ocp, tj.lb_nominal, tj.ub_nominal, V0j)
    lbt, ubt = ht.final_bounds(tt.ocp, tt.lb_nominal, tt.ub_nominal, V0t)
    assert np.array_equal(lbj, lbt) and np.array_equal(ubj, ubt)
    for a, b in zip(IPj.split_pins(lbj, ubj), IPt.split_pins(lbt, ubt)):
        assert np.array_equal(a, b)


def test_wind_sweep_problem_matches_bench_setup():
    """The port's scenario set-up reproduces bench.py's (as mirrored on the
    JAX side by the support module): state, P tree and bounds."""
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    from tests.test_torch_support import anchor, jax_sweep
    state_j, P_j, lbw_j, ubw_j, free_j = jax_sweep(3)
    state, P, lbw, ubw, free, u_refs = wind_sweep_problem(torch_trial(), anchor(), 3,
                                                          device='cpu')
    assert_tree_equal(state_j, {k: v.numpy() for k, v in state.items()})
    assert_tree_equal(P_j, to_numpy_tree({k: v for k, v in P.items()}))
    for a, b in ((lbw_j, lbw), (ubw_j, ubw), (free_j, free)):
        assert np.array_equal(a, b.numpy())
    np.testing.assert_array_equal(u_refs, [9.5, 10.0, 10.5])


def test_wind_sweep_problem_defaults_to_the_card():
    """The entry point's lanes go to the card unless the caller asks for the
    CPU; without a card the default raises rather than returning CPU
    tensors."""
    import inspect
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    from tests.test_torch_support import anchor
    assert inspect.signature(wind_sweep_problem).parameters['device'].default == 'cuda'
    if torch.cuda.is_available():
        state = wind_sweep_problem(torch_trial(), anchor(), 2)[0]
        assert all(v.is_cuda for v in state.values())
    else:
        with pytest.raises(RuntimeError, match='no CUDA card'):
            wind_sweep_problem(torch_trial(), anchor(), 2)


@pytest.mark.parametrize('with_err', [False, True])
def test_init_batched_state_matches_jax(with_err):
    """init_batched_state on two initial guesses (the model's own and a
    seeded perturbation of it that leaves some bounds) against the JAX
    package's, under the nominal bounds and the final-step P: every entry to
    1e-12 (numpy on both sides but for the inequality values, whose
    evaluation order differs), f64, err = inf only when asked for."""
    from awebox_tpu.opti.initialization import build_initial_guess as igj
    from awebox_tpu.parallel.batch import init_batched_state as init_j
    from awebox_tpu_torch.parallel.batch import init_batched_state as init_t
    from tests.test_torch_support import jax_final_P
    tj, tt = jax_trial(), torch_trial()
    V0 = np.asarray(igj(tj.ocp))
    rng = np.random.default_rng(8)
    V_batch = [V0, V0 * (1. + 0.3 * rng.standard_normal(V0.shape)) + 0.1]
    P = jax_final_P()
    out_j = init_j(tj.ocp, V_batch, P, tj.lb_nominal, tj.ub_nominal, mu0=1e-2,
                   with_err=with_err)
    out_t = init_t(tt.ocp, V_batch, P, tt.lb_nominal, tt.ub_nominal, mu0=1e-2,
                   with_err=with_err, device='cpu')
    assert set(out_t) == set(out_j) and ('err' in out_t) == with_err
    for k in out_j:
        a, b = np.asarray(out_j[k]), out_t[k].numpy()
        assert b.dtype == np.float64 and a.shape == b.shape, k
        assert np.allclose(b, a, rtol=1e-12, atol=1e-12), (k, np.abs(b - a).max())
    assert out_t['w'].shape == (2, tt.ocp.vstruct.total) and out_t['mu'].shape == (2,)
    assert np.abs(out_t['w'][0].numpy() - out_t['w'][1].numpy()).max() > 1e-2


def test_init_batched_state_defaults_to_the_card():
    """Like wind_sweep_problem: the state goes to the card unless the caller
    asks for the CPU, and without a card the default raises."""
    import inspect
    from awebox_tpu_torch.parallel.batch import init_batched_state
    assert inspect.signature(init_batched_state).parameters['device'].default == 'cuda'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA card'):
            init_batched_state(torch_trial().ocp, [], {}, None, None)


@pytest.mark.parametrize('collocation', [(3, 'radau'), (4, 'legendre'), (2, 'radau')])
def test_collocation_coefficients_equal(collocation):
    from awebox_tpu.ocp.collocation import Collocation as Cj
    from awebox_tpu_torch.ocp.collocation import Collocation as Ct
    d, scheme = collocation
    cj, ct = Cj.build(d, scheme), Ct.build(d, scheme)
    for attr in ('tau_root', 'coeff_collocation', 'coeff_continuity', 'quad_weights'):
        assert np.array_equal(getattr(cj, attr), getattr(ct, attr)), attr
