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
"""
from __future__ import annotations

from .options.kite_data import ampyx_ap2_settings
from .options.options import Options


def bench_options(n_k: int = 4, d: int = 3) -> Options:
    options = Options()
    ampyx_ap2_settings.set_ampyx_ap2_settings(options)
    options['user_options.system_model.architecture'] = {1: 0}
    options['user_options.system_model.kite_dof'] = 3
    options['user_options.trajectory.type'] = 'power_cycle'
    options['user_options.wind.model'] = 'power'
    options['user_options.wind.u_ref'] = 10.
    options['params.wind.z_ref'] = 100.0
    options['user_options.trajectory.lift_mode.phase_fix'] = 'simple'
    options['nlp.n_k'] = n_k
    options['nlp.collocation.d'] = d
    return options


def flagship_options(n_k: int = 40, d: int = 4, kite_dof: int = 6) -> Options:
    options = Options()
    ampyx_ap2_settings.set_ampyx_ap2_settings(options)
    options['user_options.system_model.architecture'] = {1: 0}
    options['user_options.system_model.kite_dof'] = kite_dof
    options['user_options.trajectory.type'] = 'power_cycle'
    options['user_options.trajectory.system_type'] = 'lift_mode'
    options['user_options.trajectory.lift_mode.windings'] = 1
    options['params.wind.z_ref'] = 100.0
    options['params.wind.power_wind.exp_ref'] = 0.15
    options['user_options.wind.model'] = 'power'
    options['user_options.wind.u_ref'] = 10.
    options['nlp.n_k'] = n_k
    options['nlp.collocation.d'] = d
    options['nlp.collocation.u_param'] = 'zoh'
    options['user_options.trajectory.lift_mode.phase_fix'] = 'simple'
    return options

