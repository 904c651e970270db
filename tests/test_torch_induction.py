"""The PyTorch port's induction and tether-drag modules against the JAX
package's, on the CPU in f64: the counterpart of tests/test_induction.py
for model/aero/{actuator, induction, geometry}.py and the Reynolds-number
drag coefficients of model/tether.py.

- the variable sets and the rows of each actuator variant (quasi-steady or
  unsteady, axisymmetric or asymmetric, the skew corrections, a comparison
  of two labels), and the model's eq_fn and outputs_fn at seeded nodes
  against the JAX package's (TOL; the JAX package's uaxi rows raise, and
  are held to its formula, jax_uaxi_rows);
- momentum theory: at a state whose thrust is 4 corr (1 - a) q A, the qaxi
  row vanishes in the port, and its residuals equal the JAX package's;
- the iota blend: iota = 1 pins ui to 0, iota = 0 to the actuator model's
  induced velocity, which points against the disk normal;
- actuator.collect_outputs through the model's outputs (a_qaxi0 and ui1,
  which the reference's qaxi test reads) against the JAX package's;
- the orbit-geometry centers (averaged, parent, frenet) of a layer;
- tether.drag_coefficient over Re from 1 to 1e7 for the constant, piecewise
  and polyfit models.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import to_numpy_tree

torch.set_num_threads(1)
# model functions: the summation order inside dot products and reductions
# differs, worth a few ulp of the O(1..1e3) values (as tests/test_torch_model.py)
TOL = 1e-12

# (steadyness, symmetry, further options) of the actuator variants
VARIANTS = {
    'qaxi': ('quasi-steady', 'axisymmetric', {}),
    'qasym': ('quasi-steady', 'asymmetric', {}),
    'uaxi': ('unsteady', 'axisymmetric', {}),
    'uasym': ('unsteady', 'asymmetric', {}),
    'qaxi_glauert_equal': ('quasi-steady', 'axisymmetric',
                           {'model.aero.actuator.actuator_skew': 'glauert',
                            'model.aero.actuator.wake_skew': 'equal'}),
    'qasym_coleman_xhat': ('quasi-steady', 'asymmetric',
                           {'model.aero.actuator.actuator_skew': 'coleman',
                            'model.aero.actuator.normal_vector_model': 'xhat'}),
    'qaxi_vs_uaxi': ('quasi-steady', 'axisymmetric',
                     {'model.aero.actuator.steadyness_comparison': ['u']}),
    'qaxi_frenet': ('quasi-steady', 'axisymmetric', {'model.aero.geometry.model': 'frenet'}),
}


def actuator_options(package, variant):
    """tests/test_induction.py::make_actuator_options in ``package``."""
    steadyness, symmetry, more = VARIANTS[variant]
    if package == 'jax':
        from tests.test_options import make_ampyx_options
        options = make_ampyx_options()
    else:
        from awebox_tpu_torch.configs import ampyx_options
        options = ampyx_options()
    options['user_options.system_model.kite_dof'] = 3
    options['user_options.induction_model'] = 'actuator'
    options['model.aero.actuator.steadyness'] = steadyness
    options['model.aero.actuator.symmetry'] = symmetry
    options['nlp.n_k'] = 4
    options['nlp.collocation.d'] = 3
    for k, v in more.items():
        options[k] = v
    return options


@functools.lru_cache(maxsize=None)
def models(variant):
    """Both packages' single-kite models of the variant: (JAX, port)."""
    from awebox_tpu.arch import Architecture as AJ
    from awebox_tpu.model.builder import make_model as make_j
    from awebox_tpu_torch.arch import Architecture as AT
    from awebox_tpu_torch.model.builder import make_model as make_t
    aj, at = AJ({1: 0}), AT({1: 0})
    return (make_j(actuator_options('jax', variant).build(aj), aj),
            make_t(actuator_options('torch', variant).build(at), at))


def consistent_state(m, a=0.2):
    """tests/test_induction.py's scaled state: the kite on a crosswind
    circle, a_qaxi0 = a and ui10 = (-0.5, 0, 0)."""
    v = np.zeros(m.layout.total_dim)

    def set_var(t, name, val):
        sl = m.layout.slices[t][name]
        off = m.layout.type_offsets[t]
        v[off + sl.start:off + sl.stop] = np.asarray(val) / m.scaling[t][sl]

    set_var('x', 'q10', [200., 0., 150.])
    set_var('x', 'dq10', [0., 30., 0.])
    set_var('x', 'coeff10', [1., 0.])
    set_var('x', 'l_t', 250.)
    set_var('z', 'lambda10', 1.)
    if m.layout.has('z', 'a_qaxi0'):
        set_var('z', 'a_qaxi0', a)
    set_var('z', 'ui10', [-0.5, 0., 0.])
    set_var('theta', 'diam_t', 0.005)
    set_var('theta', 't_f', 30.)
    return v


def seeded_nodes(m, variant, count=6):
    """The consistent state with seeded noise on every entry."""
    rng = np.random.default_rng(sum(map(ord, variant)))
    base = consistent_state(m)
    return base[None] + 0.1 * rng.standard_normal((count, base.shape[0]))


def flat_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))}


def port_si(mt, v):
    from awebox_tpu_torch.tree import to_tensors
    return mt.to_si(torch.as_tensor(v)), to_tensors(mt.theta0_init, torch.float64, 'cpu')


def port_refs(mt, theta0):
    return {'thrust_ref': 1.0, 'moment_ref': 1.0, 'a_ref': 0.33,
            'varrho_ref': mt.cfg['act_varrho_ref'],
            'b_ref': mt.cfg['geometry_static']['b_ref'],
            'u_ref': theta0['wind']['u_ref']}


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_variable_sets_and_rows_match(variant):
    """The port's layout and row slices are the JAX package's, with the
    induction factors of each label (lifted algebraic for q*, states with
    their derivatives for u*, and acos_/asin_ for the asymmetric ones) and
    one induction and actuator row block per kite and label."""
    mj, mt = models(variant)
    assert mt.layout.entries == mj.layout.entries
    assert mt.eq_slices == mj.eq_slices and mt.ineq_slices == mj.ineq_slices
    labels = mt.cfg['act_comparison_labels']
    assert labels == mj.cfg['act_comparison_labels']
    assert 'ui10' in mt.layout.names('z') and 'induction10' in mt.eq_slices
    for label in labels:
        holder = 'x' if label[0] == 'u' else 'z'
        names = ['a_' + label + '0'] + (['acos_' + label + '0', 'asin_' + label + '0']
                                        if 'asym' in label else [])
        for nm in names:
            assert nm in mt.layout.names(holder), nm
            if holder == 'x':
                assert 'd' + nm in mt.layout.names('xdot'), nm
        rows = mt.eq_slices['actuator_' + label + '0']
        assert rows.stop - rows.start == (3 if 'asym' in label else 1)


def jax_uaxi_rows(original):
    """The JAX package's residuals_for_layer with its uaxi rows computed:
    it stacks [a, acos, asin] before it branches on the label, and for
    'uaxi' acos and asin are None, so it raises; these are the rows of its
    'uaxi' branch, from its own support quantities."""
    from awebox_tpu.model.aero import actuator as aj

    def residuals_for_layer(cfg, si, theta0, arch, layer, label, f_earth, refs):
        if label != 'uaxi':
            return original(cfg, si, theta0, arch, layer, label, f_earth, refs)
        sup = aj.layer_support(cfg, si, theta0, arch, layer)
        a, _, _ = aj.get_a_vars(si, layer, label)
        thrust = 0.
        for k in sup['kites']:
            thrust = thrust + f_earth[k] @ sup['n_hat']
        corr = aj.corr_val(cfg, a, sup, aj.wake_angle_chi(cfg, a, sup))
        thrust_den = sup['qzero'] * sup['area']
        t_num = sup['b_ref'] * (sup['bar_varrho'] + 0.5)
        t_den = sup['u_mag']
        t_num_ref = refs['b_ref'] * (refs['varrho_ref'] + 0.5)
        da = si['xdot']['da_uaxi' + str(layer)][0]
        term_1 = aj.MM_DIAG[0] * da * t_num * thrust_den
        term_2 = 4. * corr * a * thrust_den * t_den
        term_3 = -thrust * t_den
        term_1_ref = aj.MM_DIAG[0] * refs['a_ref'] * t_num_ref * refs['thrust_ref']
        return jnp.atleast_1d((term_1 + term_2 + term_3) / term_1_ref)
    return residuals_for_layer


@pytest.mark.parametrize('variant', list(VARIANTS))
@pytest.mark.parametrize('fn', ['eq_fn', 'outputs_fn'])
def test_model_functions_match_at_seeded_nodes(variant, fn, monkeypatch):
    """eq_fn (every row, the iota blend at 0.5) and outputs_fn at seeded
    nodes. Where a uaxi label is built, the JAX package's eq_fn raises, and
    its rows are held to jax_uaxi_rows."""
    from awebox_tpu.model.aero import actuator as aj
    from awebox_tpu_torch.tree import to_tensors
    mj, mt = models(variant)
    nodes = seeded_nodes(mt, variant)
    th = to_numpy_tree(mt.theta0_init)
    phi = np.full(7, 0.5)
    if fn == 'eq_fn' and 'uaxi' in mt.cfg['act_comparison_labels']:
        with pytest.raises(ValueError, match='None'):
            mj.eq_fn(jnp.asarray(nodes[0]), jnp.asarray(phi), th)
        monkeypatch.setattr(aj, 'residuals_for_layer', jax_uaxi_rows(aj.residuals_for_layer))
    f_j = jax.jit(jax.vmap(getattr(mj, fn), in_axes=(0, None, None)))
    f_t = torch.func.vmap(getattr(mt, fn), in_dims=(0, None, None))
    a = flat_leaves(f_j(jnp.asarray(nodes), jnp.asarray(phi), th))
    b = flat_leaves(f_t(torch.as_tensor(nodes), torch.as_tensor(phi),
                        to_tensors(th, torch.float64, 'cpu')))
    assert set(a) == set(b)
    if fn == 'outputs_fn':
        assert any("['actuator']" in k for k in a)
    for k in a:
        assert a[k].shape == b[k].shape and np.isfinite(b[k]).all(), k
        np.testing.assert_allclose(b[k], a[k], rtol=TOL, atol=TOL, err_msg=k)


def test_momentum_theory_residual_consistency():
    """At a state where the thrust is exactly 4 corr (1 - a) q A (the
    'simple' correction corr = cos(gamma) - a, a root of the quadratic),
    the port's qaxi row is zero; its residual rows equal the JAX
    package's at that state."""
    from awebox_tpu.model.aero import actuator as act_j, kite_aero as ka_j
    from awebox_tpu_torch.model.aero import actuator, kite_aero
    mj, mt = models('qaxi')
    si, theta0 = port_si(mt, consistent_state(mt))
    sup = actuator.layer_support(mt.cfg, si, theta0, mt.arch, 0)
    f_earth, _, _ = kite_aero.forces_and_outputs(mt.cfg, si, theta0, mt.arch)
    thrust = float(f_earth[1] @ sup['n_hat'])
    qA = float(sup['qzero'] * sup['area'])
    cg = float(sup['cosgamma'])
    roots = np.roots([4. * qA, -4. * qA * (1. + cg), 4. * qA * cg - thrust])
    a_root = min(r.real for r in roots if abs(r.imag) < 1e-12 and r.real > -0.2)

    v2 = consistent_state(mt, a_root)
    si2, _ = port_si(mt, v2)
    resi = actuator.residuals_for_layer(mt.cfg, si2, theta0, mt.arch, 0, 'qaxi', f_earth,
                                        port_refs(mt, theta0))
    assert abs(float(resi[0])) < 1e-6

    th = to_numpy_tree(mj.theta0_init)
    si_j = mj.to_si(jnp.asarray(v2))
    f_j, _, _ = ka_j.forces_and_outputs(mj.cfg, si_j, th, mj.arch)
    refs_j = {'thrust_ref': 1.0, 'moment_ref': 1.0, 'a_ref': 0.33,
              'varrho_ref': mj.cfg['act_varrho_ref'],
              'b_ref': mj.cfg['geometry_static']['b_ref'], 'u_ref': th['wind']['u_ref']}
    res_j = act_j.residuals_for_layer(mj.cfg, si_j, th, mj.arch, 0, 'qaxi', f_j, refs_j)
    np.testing.assert_allclose(resi.numpy(), np.asarray(res_j), rtol=TOL, atol=TOL * qA)


def test_iota_blend():
    """iota = 1 pins ui to zero; iota = 0 pins ui to the actuator model's
    value, which points against the disk normal for a > 0."""
    from awebox_tpu_torch.model.aero import actuator, induction, kite_aero
    _, mt = models('qaxi')
    si, theta0 = port_si(mt, consistent_state(mt))
    f_earth, _, _ = kite_aero.forces_and_outputs(mt.cfg, si, theta0, mt.arch)
    refs = port_refs(mt, theta0)
    one = torch.tensor(1., dtype=torch.float64)
    ui = si['z']['ui10'].numpy()
    u_ref = float(theta0['wind']['u_ref'])
    res1 = induction.residuals(mt.cfg, si, theta0, mt.arch, one, f_earth, refs)
    np.testing.assert_allclose(res1[:3].numpy() * u_ref, ui, rtol=1e-10)
    res0 = induction.residuals(mt.cfg, si, theta0, mt.arch, 0. * one, f_earth, refs)
    ui_model = actuator.induced_velocity_at_kite(mt.cfg, si, theta0, mt.arch, 1, 'qaxi')
    np.testing.assert_allclose(res0[:3].numpy() * u_ref, ui - ui_model.numpy(), rtol=1e-8)
    sup = actuator.layer_support(mt.cfg, si, theta0, mt.arch, 0)
    assert float(ui_model @ sup['n_hat']) < 0.


def test_actuator_outputs_match():
    """outputs['actuator'] at the consistent state: a_qaxi0 and ui1 (what
    the reference's qaxi test reads) are the state's, and every entry equals
    the JAX package's."""
    from awebox_tpu_torch.tree import to_tensors
    mj, mt = models('qaxi')
    v = consistent_state(mt)
    th = to_numpy_tree(mt.theta0_init)
    phi = np.zeros(7)
    oj = mj.outputs_fn(jnp.asarray(v), jnp.asarray(phi), th)['actuator']
    ot = mt.outputs_fn(torch.as_tensor(v), torch.as_tensor(phi),
                       to_tensors(th, torch.float64, 'cpu'))['actuator']
    assert set(ot) == set(oj) >= {'a_qaxi0', 'ui1', 'ct0', 'area0', 'thrust0', 'gamma0'}
    assert float(ot['a_qaxi0']) == pytest.approx(0.2, rel=1e-14)
    np.testing.assert_allclose(ot['ui1'].numpy(), [-0.5, 0., 0.], rtol=1e-14)
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize('geometry', ['averaged', 'parent', 'frenet'])
def test_layer_centers_match(geometry):
    """center_and_velocity of each geometry model for the upper layer of
    the dual-kite tree (node 1, kites 2 and 3) at seeded states."""
    from awebox_tpu.model.aero import geometry as gj
    from awebox_tpu_torch.arch import Architecture
    from awebox_tpu_torch.model.aero import geometry as gt
    arch = Architecture({1: 0, 2: 1, 3: 1})
    rng = np.random.default_rng(41)
    for _ in range(4):
        si = {t: {f'{p}{arch.node_label(k)}': rng.standard_normal(3) * 50.
                  for k in (1, 2, 3) for p in (('q', 'dq') if t == 'x' else ('ddq',))}
              for t in ('x', 'xdot')}
        cj, dj = gj.center_and_velocity(geometry, jax.tree_util.tree_map(jnp.asarray, si),
                                        arch, 1)
        ct, dt = gt.center_and_velocity(
            geometry, {t: {k: torch.as_tensor(v) for k, v in d.items()} for t, d in si.items()},
            arch, 1)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=TOL, atol=TOL * 50.)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=TOL, atol=TOL * 50.)


@pytest.mark.parametrize('model', ['constant', 'piecewise', 'polyfit'])
def test_tether_drag_coefficient_matches(model):
    """cd(Re) for Re from 1 to 1e7 (2001 points, log-spaced, and the fits'
    breakpoints 10^2, 10^4, 10^4.3, 10^5.26, 10^5.74, 10^7) in both
    packages; the piecewise curve is the Stokes 100/Re below Re = 100 and 1
    on the laminar plateau."""
    from awebox_tpu.model import tether as tj
    from awebox_tpu_torch.model import tether as tt
    re = np.concatenate([np.logspace(0., 7., 2001),
                         10. ** np.array([2., 4., 4.3, 5.26, 5.74, 7.])])
    cfg = {'tether_cd_model': model, 'tether_reynolds_smoothing': 1e-4}
    theta0 = {'tether': {'cd': np.asarray(1.2)}}
    a = np.asarray(tj.drag_coefficient(cfg, theta0, jnp.asarray(re)))
    b = tt.drag_coefficient(cfg, {'tether': {'cd': torch.tensor(1.2, dtype=torch.float64)}},
                            torch.as_tensor(re))
    b = np.broadcast_to(np.asarray(b), re.shape) if model == 'constant' else b.numpy()
    np.testing.assert_allclose(b, np.broadcast_to(a, re.shape), rtol=TOL, atol=TOL)
    if model != 'constant':
        at = tt.drag_coefficient(cfg, None, torch.tensor([10., 1e3], dtype=torch.float64))
        np.testing.assert_allclose(at.numpy(), [10., 1.], rtol=1e-3)
