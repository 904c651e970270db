"""The 6-DOF kite model of the PyTorch port against the JAX package's, on
the CPU in f64: the Ampyx AP2 with the JAX package's default kite (a DCM and
body rates as states, the stability-derivative aerodynamics, the beta cost).

- the frame conversions of model/aero/frames.py and skew on seeded random
  inputs (TOL_FRAMES);
- the DCM tangent of make_time_derivative, R skew(omega) in scaled units
  (TOL_TANGENT);
- the model's eq_fn, ineq_fn and outputs at every node of a seeded
  perturbation of the initial guess, for both surface_control values and
  both rotation-bound types (TOL, as tests/test_torch_model.py);
- the initial guess, the tracking reference and the bounds of the 6-DOF
  health configuration (n_k=4, d=3), bit for bit;
- the graft entry's f, eq and ineq (__graft_entry__.entry(): 6-DOF, n_k=6,
  d=3) against the port's at the same V0 and P (TOL);
- the refusals that stay, and K12's reach on the card at 6-DOF grids.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import jax_sixdof_options, to_numpy_tree

torch.set_num_threads(1)
# frames and skew: a few products and square roots of O(1) values
TOL_FRAMES = 1e-14
# the DCM tangent: one 3x3 product and two scalings of O(1) values
TOL_TANGENT = 1e-13
# model and NLP functions: the summation order inside dot products and
# reductions differs, worth a few ulp of the O(1..1e3) values
TOL = 1e-12


def rng_inputs(seed):
    """A random apparent velocity, a random proper rotation (columns of a
    QR factor), a random 3-vector and a random rate vector."""
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    dcm = q * np.sign(np.diag(r))
    if np.linalg.det(dcm) < 0:
        dcm[:, 2] = -dcm[:, 2]
    vec_u = rng.standard_normal(3) * 20.
    return vec_u, dcm, rng.standard_normal(3) * 100., rng.standard_normal(3)


FRAME_CALLS = {
    'smooth_norm': lambda F, u, R, v: F.smooth_norm(u),
    'smooth_normalize': lambda F, u, R, v: F.smooth_normalize(u),
    'smooth_normed_cross': lambda F, u, R, v: F.smooth_normed_cross(u, v),
    'get_wind_dcm': lambda F, u, R, v: F.get_wind_dcm(u, R),
    'from_body_to_earth': lambda F, u, R, v: F.from_body_to_earth(R, v),
    'from_earth_to_body': lambda F, u, R, v: F.from_earth_to_body(R, v),
    'from_body_to_control': lambda F, u, R, v: F.from_body_to_control(v),
    'from_control_to_body': lambda F, u, R, v: F.from_control_to_body(v),
    'from_control_to_earth': lambda F, u, R, v: F.from_control_to_earth(R, v),
    'from_earth_to_control': lambda F, u, R, v: F.from_earth_to_control(R, v),
    'from_wind_to_earth': lambda F, u, R, v: F.from_wind_to_earth(u, R, v),
    'from_earth_to_wind': lambda F, u, R, v: F.from_earth_to_wind(u, R, v),
}
for _name in ('earth', 'body', 'control', 'wind'):
    FRAME_CALLS[f'from_named_frame_to_earth[{_name}]'] = \
        (lambda n: lambda F, u, R, v: F.from_named_frame_to_earth(n, u, R, v))(_name)
    FRAME_CALLS[f'from_named_frame_to_body[{_name}]'] = \
        (lambda n: lambda F, u, R, v: F.from_named_frame_to_body(n, u, R, v))(_name)


@pytest.mark.parametrize('name', sorted(FRAME_CALLS))
def test_frames_match(name):
    from awebox_tpu.model.aero import frames as fj
    from awebox_tpu_torch.model.aero import frames as ft
    call = FRAME_CALLS[name]
    for seed in range(8):
        u, R, v, _ = rng_inputs(seed)
        a = np.asarray(call(fj, jnp.asarray(u), jnp.asarray(R), jnp.asarray(v)))
        b = call(ft, torch.as_tensor(u), torch.as_tensor(R), torch.as_tensor(v)).numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=TOL_FRAMES, atol=TOL_FRAMES, err_msg=name)


def test_skew_matches():
    """skew(w) in both packages, and skew(w) a = w x a."""
    from awebox_tpu.model import lagrangian as lj
    from awebox_tpu_torch.model import lagrangian as lt
    from awebox_tpu_torch.model.aero.frames import cross
    for seed in range(8):
        _, _, a, w = rng_inputs(seed)
        sj = np.asarray(lj.skew(jnp.asarray(w)))
        st = lt.skew(torch.as_tensor(w))
        np.testing.assert_allclose(st.numpy(), sj, rtol=TOL_FRAMES, atol=TOL_FRAMES)
        np.testing.assert_allclose((st @ torch.as_tensor(a)).numpy(),
                                   cross(torch.as_tensor(w), torch.as_tensor(a)).numpy(),
                                   rtol=TOL_FRAMES, atol=TOL_FRAMES * np.abs(a).max())


# --- the model ---------------------------------------------------------------

VARIANTS = [(sc, rt) for sc in (1, 0) for rt in ('yaw', 'roll_pitch')]


def variant_options(package, surface_control, rotation_type, n_k=4, d=3):
    if package == 'jax':
        o = jax_sixdof_options(n_k, d)
    else:
        from awebox_tpu_torch.configs import flagship_options
        o = flagship_options(n_k, d)
    o['user_options.system_model.surface_control'] = surface_control
    o['model.model_bounds.rotation.type'] = rotation_type
    return o


@functools.lru_cache(maxsize=None)
def models(surface_control, rotation_type):
    """Both packages' 6-DOF models of the health configuration with the
    given surface control and rotation bound (the JAX package's model
    alone: its OCP is not needed here), and the port's trial."""
    from awebox_tpu.arch import Architecture
    from awebox_tpu.model.builder import make_model
    from awebox_tpu_torch.api.trial import Trial
    oj = variant_options('jax', surface_control, rotation_type)
    arch = Architecture({1: 0})
    model_j = make_model(oj.build(arch), arch)
    trial_t = Trial(variant_options('torch', surface_control, rotation_type), 'sixdof').build()
    return model_j, trial_t


@functools.lru_cache(maxsize=None)
def node_inputs(surface_control, rotation_type):
    """Every shooting and collocation node of the initial guess (the port's;
    test_initial_guess_bounds_and_reference_match holds it to the JAX
    package's bit for bit) with seeded 5% noise, the homotopy parameters at
    one, and theta0."""
    from awebox_tpu_torch.opti.initialization import build_initial_guess
    _, trial_t = models(surface_control, rotation_type)
    ocp = trial_t.ocp
    V0 = torch.as_tensor(build_initial_guess(ocp))
    shooting, coll = ocp.assemble_nodes_fn(V0)
    nodes = np.concatenate([shooting.numpy(), coll.numpy()])
    rng = np.random.default_rng(17 + surface_control)
    nodes = nodes * (1. + 0.05 * rng.standard_normal(nodes.shape))
    phi = np.ones(7)
    return nodes, phi, to_numpy_tree(trial_t.model.theta0_init)


def flat_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}


@pytest.mark.parametrize('surface_control, rotation_type', VARIANTS)
@pytest.mark.parametrize('fn', ['eq_fn', 'ineq_fn', 'outputs_fn'])
def test_model_functions_match_at_every_node(fn, surface_control, rotation_type):
    from awebox_tpu_torch.tree import to_tensors
    model_j, trial_t = models(surface_control, rotation_type)
    nodes, phi, th = node_inputs(surface_control, rotation_type)
    th_t = to_tensors(th, torch.float64, 'cpu')
    f_j = jax.jit(jax.vmap(getattr(model_j, fn), in_axes=(0, None, None)))
    f_t = torch.func.vmap(getattr(trial_t.model, fn), in_dims=(0, None, None))
    a = flat_leaves(f_j(jnp.asarray(nodes), jnp.asarray(phi), th))
    b = flat_leaves(f_t(torch.as_tensor(nodes), torch.as_tensor(phi), th_t))
    assert set(a) == set(b)
    if fn == 'outputs_fn':
        assert any('orthonormality' in k for k in a) and any('P_moment' in k for k in a)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].shape[0] == nodes.shape[0], k
        assert np.isfinite(b[k]).all(), k
        np.testing.assert_allclose(b[k], a[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize('surface_control, rotation_type', VARIANTS)
def test_model_layout_matches(surface_control, rotation_type):
    """The 6-DOF rows (rotation_dynamics, ref_frame_dynamics and the
    rotation bound's rows) sit where the JAX package puts them."""
    model_j, trial_t = models(surface_control, rotation_type)
    mt = trial_t.model
    assert mt.eq_slices == model_j.eq_slices and mt.ineq_slices == model_j.ineq_slices
    assert 'rotation_dynamics1' in mt.eq_slices and 'ref_frame_dynamics1' in mt.eq_slices
    assert mt.ineq_slices['rotation_max10'].stop - mt.ineq_slices['rotation_max10'].start \
        == (2 if rotation_type == 'roll_pitch' else 1)


def test_dcm_tangent_matches():
    """make_time_derivative of the 6-DOF layout: the tangent itself (the
    derivative of the identity), where r moves with R skew(omega), and the
    derivative of a product of the DCM and rate states, at seeded points."""
    from awebox_tpu.model import lagrangian as lj
    from awebox_tpu_torch.model import lagrangian as lt
    model_j, trial_t = models(1, 'yaw')
    m = trial_t.model
    dj = lj.make_time_derivative(m.layout, m.scaling, m.arch, 6)
    dt = lt.make_time_derivative(m.layout, m.scaling, m.arch, 6)
    x0 = m.layout.type_offsets['x']
    r_sl = m.layout.slices['x']['r10']
    om_sl = m.layout.slices['x']['omega10']
    r_abs = slice(x0 + r_sl.start, x0 + r_sl.stop)
    om_abs = slice(x0 + om_sl.start, x0 + om_sl.stop)

    def prod_j(v):
        return v[r_abs].reshape(3, 3) @ v[om_abs] * v[x0:x0 + 3].sum()

    def prod_t(v):
        return v[r_abs].reshape(3, 3) @ v[om_abs] * v[x0:x0 + 3].sum()

    rng = np.random.default_rng(23)
    for _ in range(4):
        v = rng.standard_normal(m.layout.total_dim)
        tan_j = np.asarray(dj(lambda x: x)(jnp.asarray(v)))
        tan_t = dt(lambda x: x)(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(tan_t, tan_j, rtol=TOL_TANGENT, atol=TOL_TANGENT)
        R = v[r_abs].reshape(3, 3) * m.scaling['x'][r_sl].reshape(3, 3)
        w = v[om_abs] * m.scaling['x'][om_sl]
        W = np.array([[0., -w[2], w[1]], [w[2], 0., -w[0]], [-w[1], w[0], 0.]])
        np.testing.assert_allclose(tan_t[r_abs], (R @ W).reshape(9) / m.scaling['x'][r_sl],
                                   rtol=TOL_TANGENT, atol=TOL_TANGENT)
        np.testing.assert_allclose(dt(prod_t)(torch.as_tensor(v)).numpy(),
                                   np.asarray(dj(prod_j)(jnp.asarray(v))),
                                   rtol=TOL_TANGENT, atol=TOL_TANGENT)


# --- the NLP -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def nlp_pair():
    from awebox_tpu.api.trial import Trial as TJ
    from awebox_tpu_torch.api.trial import Trial as TT
    from awebox_tpu_torch.configs import flagship_options
    return (TJ(jax_sixdof_options(4, 3), 'sixdof').build(),
            TT(flagship_options(4, 3), 'sixdof').build())


@pytest.mark.parametrize('what', ['V0', 'V_ref', 'lb', 'ub'])
def test_initial_guess_bounds_and_reference_match(what):
    """The health configuration's (n_k=4, d=3: n=569) circular-path guess
    with its aero-validity-aligned DCM, the tracking reference and the
    bounds (6-DOF scaling, surface and rotation bounds), bit for bit."""
    from awebox_tpu.opti import initialization as ij
    from awebox_tpu_torch.opti import initialization as it
    tj, tt = nlp_pair()
    assert tt.ocp.vstruct.total == tj.ocp.vstruct.total == 569
    vals = {
        'V0': (ij.build_initial_guess(tj.ocp), it.build_initial_guess(tt.ocp)),
        'lb': (tj.lb_nominal, tt.lb_nominal),
        'ub': (tj.ub_nominal, tt.ub_nominal),
    }
    if what == 'V_ref':
        V0 = np.asarray(vals['V0'][0])
        vals['V_ref'] = (ij.build_reference(tj.ocp, V0), it.build_reference(tt.ocp, V0))
    a, b = (np.asarray(x) for x in vals[what])
    assert a.shape == b.shape == (569,)
    np.testing.assert_array_equal(b, a)


def test_auto_takes_the_dense_direction(monkeypatch):
    """'auto' sends every 6-DOF problem to the dense direction in both
    packages (awebox_tpu/opti/homotopy.py:351-360): the JAX package's
    solve_homotopy builds its solver with no block KKT for the health
    configuration, and the port's rule takes 'dense' there and at n_k=9
    (n=1239, past the 1200 variables from which a 3-DOF problem of the same
    kind, bench_options(n_k=20), takes 'block')."""
    from awebox_tpu.opti import homotopy as hj
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.opti.homotopy import linear_solver_choice
    built = {}

    class Stop(Exception):
        pass

    def solver_stub(*args, **kwargs):
        built['block_kkt'] = kwargs.get('block_kkt')
        raise Stop
    monkeypatch.setattr(hj, 'InteriorPointSolver', solver_stub)
    tj, tt = nlp_pair()
    V0 = np.asarray(build_initial_guess(tj.ocp))
    with pytest.raises(Stop):
        hj.solve_homotopy(tj.ocp, V0, build_reference(tj.ocp, V0), tj.lb_nominal,
                          tj.ub_nominal, verbose=False)
    assert built == {'block_kkt': None}
    assert linear_solver_choice(tt.ocp) == 'dense'
    ocp9 = _port_trial(9).ocp
    assert ocp9.vstruct.total == 1239 and linear_solver_choice(ocp9) == 'dense'
    assert linear_solver_choice(Trial(bench_options(n_k=20), 'b20').build().ocp) == 'block'


@functools.lru_cache(maxsize=None)
def _port_trial(n_k):
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import flagship_options
    return Trial(flagship_options(n_k, 3), f'sixdof_{n_k}').build()


@functools.lru_cache(maxsize=None)
def graft_entry():
    import __graft_entry__
    fn, (V0, P) = __graft_entry__.entry()
    return fn, np.array(V0), to_numpy_tree(P)


@pytest.mark.parametrize('which', ['f', 'eq', 'ineq'])
def test_graft_entry_matches(which):
    """__graft_entry__.entry(): the flagship 6-DOF problem at n_k=6, d=3
    (n=837, m=768 + 54): its f, eq and ineq at its V0 and P against the
    port's on flagship_options(6, 3), whose initial guess is the entry's V0
    bit for bit."""
    from awebox_tpu_torch.opti.initialization import build_initial_guess
    from awebox_tpu_torch.tree import to_tensors
    fn, V0, P = graft_entry()
    tt = _port_trial(6)
    assert tt.ocp.vstruct.total == V0.shape[0] == 837
    np.testing.assert_array_equal(build_initial_guess(tt.ocp), V0)
    i = ('f', 'eq', 'ineq').index(which)
    a = np.asarray(jax.jit(fn)(jnp.asarray(V0), P)[i])
    Pt = to_tensors(P, torch.float64, 'cpu')
    b = (tt.ocp.f_fn, tt.ocp.eq_fn, tt.ocp.ineq_fn)[i](torch.as_tensor(V0), Pt).numpy()
    assert a.shape == b.shape == ((), (768,), (54,))[i]
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)


# --- refusals and reach ------------------------------------------------------

@pytest.mark.parametrize('settings, what', [
    ({'user_options.induction_model': 'vortex'}, 'vortex'),
    ({'nlp.discretization': 'multiple_shooting'}, 'discretization'),
    ({'user_options.trajectory.type': 'nominal_landing'}, 'trajectory.type'),
    ({'user_options.system_model.architecture': {1: 0, 2: 1, 3: 1},
      'user_options.system_model.cross_tether': True}, 'cross tether'),
])
def test_refusals_that_stay_raise_at_six_dof(settings, what):
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import flagship_options
    options = flagship_options(4, 3)
    for k, v in settings.items():
        options[k] = v
    with pytest.raises(NotImplementedError, match=what):
        Trial(options, 'refused').build()


@pytest.mark.parametrize('n_k, reach', [(4, True), (9, True), (10, False)])
def test_k12_reach_at_six_dof(n_k, reach):
    """The dense direction's K at 6-DOF grids, d=3: N=1125 at n_k=4, 2460
    at n_k=9 (the last K12 takes on the card) and 2727 at n_k=10, which
    lu_factor_f64_geometry refuses by name, with no fallback."""
    from awebox_tpu_torch.parallel import kernels
    ocp = _port_trial(n_k).ocp
    N = ocp.vstruct.total + ocp.n_eq + ocp.n_ineq
    assert N == {4: 1125, 9: 2460, 10: 2727}[n_k]
    if reach:
        assert kernels.lu_factor_f64_geometry(N, 1).smem_bytes <= kernels.SMEM_PER_BLOCK
    else:
        with pytest.raises(ValueError, match='lu_factor_f64'):
            kernels.lu_factor_f64_geometry(N, 1)
