"""Shared set-up of the PyTorch-port parity tests, and tests of the port's
tree/state converters and of its refusals.

Both packages are built on the batched wind-sweep configuration (Ampyx AP2,
3-DOF, power_cycle, n_k=4, d=3) and fed identical numpy inputs: the committed
anchor state, or arrays drawn from a seeded numpy generator. The JAX side
runs as its own tests run it: CPU, x64, jitted.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ANCHOR = os.path.join(HERE, 'artifacts', 'bench_anchor_nk4_d3.npz')
STATE_KEYS = ('w', 's', 'y', 'lam', 'zl', 'zu')


def jax_bench_options(n_k=4):
    sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
    from make_bench_anchor import bench_options
    return bench_options(n_k=n_k)


def jax_sixdof_options(n_k=4, d=3):
    """The JAX package's single-kite 6-DOF health configuration at (n_k, d):
    tests/test_options.py::make_ampyx_options with kite_dof=6, the
    counterpart of awebox_tpu_torch.configs.flagship_options(n_k, d)."""
    from tests.test_options import make_ampyx_options
    options = make_ampyx_options()
    options['user_options.system_model.kite_dof'] = 6
    options['nlp.n_k'] = n_k
    options['nlp.collocation.d'] = d
    return options


def options_of(package, dof=3):
    """(n_k -> options) of the bench configuration (dof=3) or of the 6-DOF
    health configuration (dof=6) in ``package`` ('jax' or 'torch')."""
    if package == 'jax':
        return jax_bench_options if dof == 3 else jax_sixdof_options
    from awebox_tpu_torch.configs import bench_options, flagship_options
    return (lambda n_k=4: bench_options(n_k=n_k)) if dof == 3 \
        else (lambda n_k=4: flagship_options(n_k, 3))


@functools.lru_cache(maxsize=None)
def jax_trial(n_k=4):
    from awebox_tpu.api.trial import Trial
    return Trial(jax_bench_options(n_k), 'parity').build()


@functools.lru_cache(maxsize=None)
def torch_trial(n_k=4):
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    return Trial(bench_options(n_k=n_k), 'parity').build()


@functools.lru_cache(maxsize=None)
def anchor(n_k=4):
    """The committed solved state of the bench configuration at n_k (4: the
    main path's; 8: tests/artifacts/bench_anchor_nk8_d3.npz)."""
    path = os.path.join(HERE, 'artifacts', f'bench_anchor_nk{n_k}_d3.npz')
    return {k: np.asarray(v) for k, v in np.load(path).items()}


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@functools.lru_cache(maxsize=None)
def jax_final_P():
    """The JAX package's P at the anchor (final-step cost weights), numpy."""
    from awebox_tpu.opti import homotopy as hm
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    ocp = jax_trial().ocp
    P = hm.build_p_fix(ocp, build_reference(ocp, build_initial_guess(ocp)))
    P['cost'] = {k: np.asarray(v) for k, v in hm.final_cost_values(ocp).items()}
    return to_numpy_tree(P)


def lanes(tree, B):
    """Repeat every leaf of a numpy tree along a new leading lane axis."""
    return jax.tree_util.tree_map(lambda x: np.stack([np.asarray(x)] * B), tree)


@functools.lru_cache(maxsize=None)
def jax_sweep(B, n_k=4):
    """bench.py's scenario set-up on the JAX side: (state, P64, lbw, ubw,
    free), numpy. Mirrors awebox_tpu_torch.parallel.refine.wind_sweep_problem."""
    import copy
    from awebox_tpu.opti.homotopy import build_p_fix, final_bounds, final_cost_values
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    from awebox_tpu.opti.ipsolver import InteriorPointSolver
    trial = jax_trial(n_k)
    ocp = trial.ocp
    V0 = build_initial_guess(ocp)
    base_P = build_p_fix(ocp, build_reference(ocp, V0))
    lbf, ubf = final_bounds(ocp, trial.lb_nominal, trial.ub_nominal, np.asarray(V0))
    relax = 1e-8
    fin_l = np.isfinite(lbf) & (lbf != ubf)
    fin_u = np.isfinite(ubf) & (lbf != ubf)
    lbf = np.where(fin_l, lbf - relax * np.maximum(1., np.abs(lbf)), lbf)
    ubf = np.where(fin_u, ubf + relax * np.maximum(1., np.abs(ubf)), ubf)
    fc = final_cost_values(ocp)
    p_list = []
    for u in 10.0 * (1.0 + 0.05 * np.linspace(-1., 1., B)):
        th = copy.deepcopy(to_numpy_tree(base_P['theta0']))
        th['wind']['u_ref'] = np.asarray(float(u))
        p_list.append({'cost': {k: np.asarray(fc[k]) for k in fc},
                       'ref': np.asarray(base_P['ref']),
                       'weights': np.asarray(base_P['weights']), 'theta0': th})
    P64 = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *p_list)
    a = anchor(n_k)
    state = {k: np.stack([a[k]] * B) for k in STATE_KEYS}
    state['mu'] = np.full(B, 1e-5)
    state['err'] = np.full(B, np.inf)
    lbw, ubw, free, _ = InteriorPointSolver.split_pins(lbf, ubf)
    return state, P64, lbw, ubw, free


# --- tests of the converters and refusals ------------------------------------

def test_p_from_numpy_keeps_tree_and_dtype():
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    P = lanes(jax_final_P(), 2)
    for dtype in (torch.float64, torch.float32):
        Pt = p_from_numpy(P, 'cpu', dtype)
        flat_np = jax.tree_util.tree_leaves(P)
        flat_t = jax.tree_util.tree_leaves(
            Pt, is_leaf=lambda x: isinstance(x, torch.Tensor))
        assert len(flat_np) == len(flat_t)
        assert set(Pt) == set(P) and set(Pt['theta0']) == set(P['theta0'])
        for a, t in zip(flat_np, flat_t):
            assert t.dtype == dtype and t.shape == a.shape
            np.testing.assert_array_equal(t.numpy(), a.astype(t.numpy().dtype))


def test_state_from_numpy_is_f64():
    from awebox_tpu_torch.parallel.batch import state_from_numpy
    state = jax_sweep(2)[0]
    st = state_from_numpy(state, 'cpu')
    assert set(st) == set(state)
    for k, v in st.items():
        # the state stays f64: active bounds sit ~1e-8 from their relaxed
        # values, below f32 resolution
        assert v.dtype == torch.float64
        np.testing.assert_array_equal(v.numpy(), state[k])


@pytest.mark.parametrize('path, value, what', [
    ('user_options.induction_model', 'vortex', 'vortex'),
    ('user_options.trajectory.type', 'tracking', 'trajectory.type'),
    ('user_options.trajectory.type', 'nominal_landing', 'trajectory.type'),
    ('user_options.trajectory.type', 'transition', 'trajectory.type'),
    ('user_options.trajectory.type', 'launch', 'trajectory.type'),
    ('nlp.discretization', 'multiple_shooting', 'discretization'),
    (('user_options.system_model.architecture', 'user_options.system_model.cross_tether'),
     ({1: 0, 2: 1, 3: 1}, True), 'cross tether'),
])
def test_unported_options_raise(path, value, what):
    """What the port still refuses raises by name when the trial is built
    (a tuple of paths sets each to its value)."""
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import apply_overrides, bench_options
    settings = dict(zip(path, value)) if isinstance(path, tuple) else {path: value}
    options = apply_overrides(bench_options(), settings)
    with pytest.raises(NotImplementedError, match=what):
        Trial(options, 'refused').build()


def test_unported_solver_modes_raise():
    """What the port leaves out of make_ip_step raises by name: the
    stale-factor modes of auglu, the Gauss-Newton Hessian (both on the
    do-not-port list); an unknown factor is refused by ValueError; both
    factors build."""
    from awebox_tpu_torch.parallel.batch import make_ip_step
    ocp = torch_trial().ocp
    for kwargs, what in ((dict(kkt='auglu', auglu_mode='stale'), 'auglu_mode'),
                         (dict(kkt='auglu', auglu_mode='refresh'), 'auglu_mode'),
                         (dict(hessian='gauss_newton'), 'hessian')):
        with pytest.raises(NotImplementedError, match=what):
            make_ip_step(ocp, **kwargs)
    with pytest.raises(ValueError, match='auglu_factor'):
        make_ip_step(ocp, auglu_factor='cholesky', kkt='auglu', split=True)
    for factor in ('qr', 'lu'):
        assert len(make_ip_step(ocp, auglu_factor=factor, kkt='auglu', split=True)) == 2


@pytest.mark.parametrize('name', ['kkt', 'split', 'auglu_factor', 'auglu_mode', 'hessian',
                                  'delta_w', 'delta_c', 'tau', 'kappa_mu', 'mu_min',
                                  'n_ladder', 'ladder_factor', 'derivs_fn', 'solve_dtype'])
def test_make_ip_step_has_the_reference_defaults(name):
    """A caller who takes each package's defaults asks both for the same
    algorithm: every parameter the two make_ip_step share has one default."""
    import inspect
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t
    default = lambda fn: inspect.signature(fn).parameters[name].default
    assert default(make_t) == default(make_j)


@pytest.mark.parametrize('kwargs, fused', [
    ({}, True),                                   # 'auto' -> 'block'
    ({'split': True}, True),                      # 'block' is fused whatever split says
    ({'kkt': 'block', 'split': True}, True),
    ({'kkt': 'dense'}, True),
    ({'kkt': 'dense', 'split': True, 'solve_dtype': 'float64'}, False),
    ({'kkt': 'auglu'}, True),
])
def test_every_mode_builds(kwargs, fused):
    """Every KKT mode of the reference but the stale-factor ones builds on
    the bench configuration: the fused step step(state, p, lbw, ubw, free),
    or with split=True (derivs_fn, direction_fn); 'block' returns the fused
    step whatever split says, as the JAX package's make_ip_step does."""
    from awebox_tpu_torch.parallel.batch import make_ip_step
    out = make_ip_step(torch_trial().ocp, **kwargs)
    if fused:
        assert callable(out) and not isinstance(out, tuple)
    else:
        assert isinstance(out, tuple) and len(out) == 2 and all(map(callable, out))


def test_auto_resolves_as_in_the_reference(monkeypatch):
    """'auto' picks the JAX package's mode for the bench configuration:
    its make_ip_step, given the defaults, builds the block step."""
    from awebox_tpu.parallel import batch as batch_j
    from awebox_tpu_torch.parallel.batch import resolve_kkt
    monkeypatch.setattr(batch_j, '_make_block_ip_step', lambda *a, **k: 'block')
    assert batch_j.make_ip_step(jax_trial().ocp) == 'block'
    assert resolve_kkt(torch_trial().ocp, 'auto') == 'block'
    assert resolve_kkt(torch_trial().ocp, 'auglu') == 'auglu'


@pytest.mark.parametrize('with_model', [True, False])
def test_auto_resolves_dense_for_a_derivs_fn(monkeypatch, with_model):
    """With a caller's derivs_fn, or for an OCP without a model, 'auto' is
    'dense' in both packages (awebox_tpu/parallel/batch.py:94-96): the JAX
    package's make_ip_step then builds no block step."""
    from types import SimpleNamespace
    from awebox_tpu.parallel import batch as batch_j
    from awebox_tpu_torch.parallel.batch import resolve_kkt
    monkeypatch.setattr(batch_j, '_make_block_ip_step', lambda *a, **k: 'block')
    derivs = lambda w, y, lam, p: None
    if with_model:
        ocp_j, ocp_t = jax_trial().ocp, torch_trial().ocp
        assert batch_j.make_ip_step(ocp_j, derivs_fn=derivs) != 'block'
        assert resolve_kkt(ocp_t, 'auto', derivs) == 'dense'
        assert resolve_kkt(ocp_t, 'auto') == 'block'
    else:
        fake = SimpleNamespace(vstruct=SimpleNamespace(total=4), n_eq=1, n_ineq=1)
        assert batch_j.make_ip_step(fake, derivs_fn=derivs) != 'block'
        assert resolve_kkt(fake, 'auto') == resolve_kkt(fake, 'auto', derivs) == 'dense'


def test_package_imports_no_jax():
    """The port never imports jax or the JAX package."""
    pkg = os.path.join(ROOT, 'awebox_tpu_torch')
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(dirpath, name)) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(('import ', 'from ')):
                            assert 'jax' not in s and 'awebox_tpu.' not in s \
                                and s != 'import awebox_tpu', (name, s)
