"""Named problem configurations.

``bench_options`` is the batched wind-sweep configuration: the Ampyx AP2
single kite, 3-DOF, power_cycle, power-law wind at u_ref = 10 m/s and
z_ref = 100 m, simple phase fix, Radau collocation with n_k = 4, d = 3. It is
the configuration of ``benchmarks/make_bench_anchor.py`` and of the solved
primal-dual state ``tests/artifacts/bench_anchor_nk4_d3.npz``.

``flagship_options`` is the canonical trajectory of
``examples/ampyx_ap2_trajectory.py::make_options``: the Ampyx AP2 with the
package's default 6-DOF kite, one winding, lift mode, power-law wind with
exponent 0.15, zoh controls, n_k = 40, d = 4. Its n_k = 20, d = 3 grid is the
coarse stage of ``tests/artifacts/flagship_coarse_nk20_d3.pkl``, and its
n_k = 4, d = 3 grid the single-kite 6-DOF health configuration
(``tests/test_options.py::make_ampyx_options`` with kite_dof = 6).

``e2e_options(name)`` is one of the eight configurations of the reference's
end-to-end matrix (``tests/test_e2e_configs.py``) beyond the 6-DOF kite:
``ampyx_options`` (``tests/test_options.py::make_ampyx_options``) with the
overrides of ``E2E_OVERRIDES[name]``. Their solved states, from the JAX
package's cold solves on the CPU, are ``tests/artifacts/e2e_<name>.pkl``.
"""
from __future__ import annotations

from .options.kite_data import ampyx_ap2_settings
from .options.options import Options


def ampyx_options() -> Options:
    """The Ampyx AP2 base configuration (``tests/test_options.py::
    make_ampyx_options``): one kite, power_cycle, power-law wind (u_ref 10
    m/s at z_ref 100 m, exponent 0.15), zoh controls, simple phase fix, n_k =
    40; each named configuration below sets its own kite and grid."""
    options = Options()
    ampyx_ap2_settings.set_ampyx_ap2_settings(options)
    options['user_options.system_model.architecture'] = {1: 0}
    options['user_options.trajectory.type'] = 'power_cycle'
    options['user_options.wind.model'] = 'power'
    options['user_options.wind.u_ref'] = 10.
    options['params.wind.z_ref'] = 100.0
    options['params.wind.power_wind.exp_ref'] = 0.15
    options['nlp.n_k'] = 40
    options['nlp.collocation.u_param'] = 'zoh'
    options['user_options.trajectory.lift_mode.phase_fix'] = 'simple'
    return options


def apply_overrides(options, overrides):
    for key, value in overrides.items():
        options[key] = value
    return options


def bench_options(n_k: int = 4, d: int = 3) -> Options:
    return apply_overrides(ampyx_options(), {
        'user_options.system_model.kite_dof': 3, 'nlp.n_k': n_k, 'nlp.collocation.d': d})


def flagship_options(n_k: int = 40, d: int = 4, kite_dof: int = 6) -> Options:
    return apply_overrides(ampyx_options(), {
        'user_options.system_model.kite_dof': kite_dof,
        'user_options.trajectory.system_type': 'lift_mode',
        'user_options.trajectory.lift_mode.windings': 1,
        'nlp.n_k': n_k, 'nlp.collocation.d': d})


_DOF3_NK4 = {'user_options.system_model.kite_dof': 3, 'nlp.n_k': 4}

# name -> the options each test of tests/test_e2e_configs.py sets on top of
# ampyx_options(), in its order
E2E_OVERRIDES = {
    'dual_kite': {**_DOF3_NK4,
                  'user_options.system_model.architecture': {1: 0, 2: 1, 3: 1},
                  'nlp.collocation.d': 2},
    'drag_mode': {**_DOF3_NK4,
                  'user_options.trajectory.system_type': 'drag_mode',
                  'nlp.collocation.d': 2},
    'actuator_qaxi': {**_DOF3_NK4, 'user_options.induction_model': 'actuator',
                      'nlp.collocation.d': 3},
    'averaged_induction': {**_DOF3_NK4, 'user_options.induction_model': 'averaged',
                           'nlp.collocation.d': 3},
    'poly_controls': {**_DOF3_NK4, 'nlp.collocation.u_param': 'poly',
                      'nlp.collocation.d': 3},
    'single_homotopy': {**_DOF3_NK4, 'solver.homotopy_method.type': 'single',
                        'nlp.collocation.d': 3},
    'integral_outputs': {'user_options.system_model.kite_dof': 3,
                         'model.integral_outputs': True,
                         'nlp.n_k': 3, 'nlp.collocation.d': 2},
    'reynolds_cd': {**_DOF3_NK4, 'model.tether.cd_model': 'piecewise',
                    'nlp.collocation.d': 3},
}
E2E_NAMES = tuple(E2E_OVERRIDES)


def e2e_options(name: str) -> Options:
    """The end-to-end configuration ``name`` (one of ``E2E_NAMES``)."""
    return apply_overrides(ampyx_options(), E2E_OVERRIDES[name])
