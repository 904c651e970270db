"""Default options tree.

Reference-compatible option paths and default values, condensed from
awebox opts/default.py:33-575. Only options that are
meaningful to the TPU-native build are included; unknown paths raise,
which surfaces unsupported reference features loudly instead of silently.
"""
from __future__ import annotations

import numpy as np


def default_options_tree():
    inf = np.inf

    user_options = {
        'trajectory': {
            # power_cycle | tracking | mpc | transition | nominal_landing |
            # compromised_landing | launch (reference default.py:41 +
            # ocp/operation.py:52-118)
            'type': 'power_cycle',
            'system_type': 'lift_mode',       # lift_mode | drag_mode
            'lift_mode': {
                'windings': 3,
                'phase_fix': 'single_reelout',  # single_reelout | simple
                'max_l_t': None,
                'pumping_range': None,
            },
            'tracking': {'fix_tether_length': False},
            # xi-parameterized boundary trajectories: saved-trial filenames
            # or Trial objects (reference default.py:47-48)
            'transition': {'initial_trajectory': None,
                           'terminal_trajectory': None},
            'compromised_landing': {'emergency_scenario': ('broken_lift', 2),
                                    'xi_0_initial': 0.0},
            'fixed_params': {},
        },
        'system_model': {
            'kite_dof': 6,
            'surface_control': 1,
            'architecture': {1: 0, 2: 1, 3: 1},
            'cross_tether': False,
        },
        'wind': {
            'model': 'log_wind',       # log_wind | power | uniform | datafile
            'u_ref': 5.,
        },
        'induction_model': 'not_in_use',
        'kite_standard': None,
        'atmosphere': 'isa',
        'tether_drag_model': 'multi',         # split | multi | kite_only | not_in_use
    }

    params = {
        'atmosphere': {
            'g': 9.81, 'gamma': 1.4, 'r': 287.053,
            't_ref': 288.15, 'p_ref': 101325., 'rho_ref': 1.225,
            'gamma_air': 6.5e-3, 'mu_ref': 1.789e-5, 'c_sutherland': 120.,
        },
        'wind': {
            'z_ref': 10.,
            'log_wind': {'z0_air': 0.1},
            'power_wind': {'exp_ref': 0.15},
            'datafile': None,   # {'heights','u_x','u_y'} arrays for model='datafile'
        },
        'tether': {
            'kappa': 10., 'rho': 970., 'cd': 1., 'f_max': 5.,
            'max_stress': 3.6e9, 'stress_safety_factor': 1.5,
        },
        'model_bounds': {
            'tether_force_limits': np.array([1e0, 2e3]),
            'airspeed_limits': np.array([13., 32.]),
            'rot_angles': np.array([80., 80., 160.]) * np.pi / 180.,
            'acceleration': None,   # unused placeholder
        },
        'aero': {'turbine_efficiency': 0.75, 'moment_factor': 1.0},
        'kappa_r': 1.,  # Baumgarte constant for DCM dynamics
    }

    model = {
        'tether': {
            'control_var': 'dddl_t',     # ddl_t | dddl_t
            'aero_elements': 5,
            'cd_model': 'constant',      # constant | piecewise | polyfit
            'reynolds_smoothing': 1e-4,
            'attachment': 'com',
            'lift_tether_force': False,
        },
        'aero': {
            'lift_aero_force': False,
            'aero_coeff_ref_velocity': 'eff',
            'induction': {
                'comparison': [],          # extra models to co-build: 'act'
                'force_zero': False,
            },
            'geometry': {'model': 'averaged'},  # averaged | parent | frenet
            # vortex-wake options (reference opts/default.py:124-143)
            'vortex': {
                'representation': 'alg',
                'wake_nodes': 5,
                'far_wake_element_type': 'semi_infinite_filament',
                'core_to_chord_ratio': 0.05,
                'filament_strength_from_circulation': 'averaged',
                # cylinder far-wake smoothing (reference default.py:132-133)
                'epsilon_m': 1.e-8,
                'epsilon_r': 1.e-8,
                # 1: lift only the per-kite total induced velocity; 2: lift
                # the near-wake and far-wake contributions separately with
                # their own fixing rows (reference default.py:139 lifts
                # per-element; substructure granularity is the TPU-native
                # equivalent since elements are not NLP variables here)
                'degree_of_induced_velocity_lifting': 1,
            },
            # actuator-disk options (reference opts/default.py:108-123)
            'actuator': {
                'steadyness': 'quasi-steady',   # quasi-steady | unsteady
                'symmetry': 'axisymmetric',     # axisymmetric | asymmetric
                'steadyness_comparison': [],    # e.g. ['q', 'u']
                'symmetry_comparison': [],      # e.g. ['axi', 'asym']
                'a_ref': 0.33,
                'a_range': [0., 0.5],
                'a_fourier_range': [-0.01, 0.01],
                'actuator_skew': 'simple',      # not_in_use|glauert|coleman|simple
                'wake_skew': 'coleman',         # not_in_use|jimenez|coleman|equal
                'normal_vector_model': 'tether_parallel',  # tether_parallel|xhat
                'asym_radial_linearity': False,
                'support_only': False,
            },
            'three_dof': {
                'coeff_max': np.array([2., 80. * np.pi / 180.]),
                'coeff_min': np.array([0., -80. * np.pi / 180.]),
                'dcoeff_max': np.array([5., 80. * np.pi / 180.]),
                'dcoeff_min': np.array([-5., -80. * np.pi / 180.]),
            },
        },
        'system_bounds': {
            'theta': {
                'diam_t': [1.0e-4, 1.0e-1],
                'diam_s': [1.0e-4, 1.0e-1],
                't_f': [1e-3, 500.0],
                'a': [0., 0.5],   # averaged induction factor (momentum limit)
            },
            'x': {
                'l_t': [1.0e-2, 1.0e3],
                'dl_t': [-30.0, 30.0],
                'ddl_t': [-100.0, 100.0],
                'q': [np.array([-inf, -inf, 10.0]), np.array([inf, inf, inf])],
                'omega': [np.pi / 180. * np.array([-50.] * 3),
                          np.pi / 180. * np.array([50.] * 3)],
                'coeff': [np.array([0., -80. * np.pi / 180.]),
                          np.array([2., 80. * np.pi / 180.])],
            },
            'u': {
                'dddl_t': [-100.0, 100.0],
                'dcoeff': [np.array([-5., -80. * np.pi / 180.]),
                           np.array([5., 80. * np.pi / 180.])],
            },
            'z': {'lambda': [0., inf]},
        },
        'model_bounds': {
            'tether_stress': {'include': True, 'scaling': 1.},
            'tether_force': {'include': False},
            'airspeed': {'include': False},
            'aero_validity': {'include': True, 'scaling': 1.},
            'anticollision': {'include': True, 'safety_factor': 5.},
            'acceleration': {'include': True, 'acc_max': 12.},
            'rotation': {'include': True, 'type': 'yaw'},
        },
        'scaling': {
            'other': {
                'position_scaling_method': 'radius',
                'force_scaling_method': 'synthesized',
                'flight_radius_estimate': 'centripetal',
                'tension_estimate': 'average_force',
                'g': 9.81,
            },
        },
        'scaling_overwrite': {
            'lambda_tree': {'include': True},
            'lambda_factor': 1.,
            'energy_factor': 1.,
        },
        'integral_outputs': False,  # energy as state (reference 'constraints' path)
    }

    nlp = {
        'n_k': 40,
        'discretization': 'direct_collocation',  # or 'multiple_shooting'
        'collocation': {'d': 4, 'scheme': 'radau', 'u_param': 'zoh'},
        # multiple shooting: rk4root substeps per interval and Newton
        # corrections per RK stage (ocp/multiple_shooting.py)
        'ms_integrator_steps': 1,
        'ms_newton_iters': 1,
        'phase_fix_reelout': 0.7,
        'pumping_range': [None, None],
        'cost': {
            'P_max': False,
            'output_quadrature': False,
        },
    }

    solver = {
        'max_iter': 2000,
        # 'auto' picks the block-structured KKT factorization for large
        # horizons and the dense path for tiny ones / vortex; 'block'/'dense'
        # force one (the MA57-role choice, reference opts/default.py:322)
        'linear_solver': 'auto',
        'mu_target': 0.,
        'mu_init': 1.,
        'tol': 1e-8,
        'hippo_strategy': True,
        'mu_hippo': 1e-2,
        'tol_hippo': 1e-4,
        'max_iter_hippo': 2000,
        'homotopy_method': {'type': 'scheduled', 'advance_despite_max_iter': True},
        'homotopy_step': {'gamma': 0.1, 'psi': 1.0},
        'initialization': {
            # 'default': circular scenario (standard_scenario.py); 'modular':
            # primitive-scheduled s-curve guess (modular.py:45-1318 role)
            'type': 'default',
            'groundspeed': 20.,
            'cone_deg': 25.,
            'inclination_deg': 40.,
            'min_rel_radius': 2.,
            'kite_dcm': 'aero_validity',
            'psi0_rad': 0.,
            'l_t': 500.,
            'max_cone_angle_multi': 80.,
            'max_cone_angle_single': 35.,
            'clockwise_rotation_about_xhat': True,
            'init_clipping': True,
            'theta': {
                'l_i': 100., 'l_s': 50., 'l_c': 100.,
                'diam_t': 5e-3, 'diam_i': 4e-3, 'diam_s': 5e-3, 'diam_c': 5e-3,
                'a': 1. / 3.,   # averaged-induction factor guess (Betz point)
            },
        },
        'tracking': {'stagger_distance': 0.1},
        'cost_factor': {'power': 1e0},
        'weights': {
            'q': 1e-1, 'dq': 1e-1, 'ddq': 1e0,
            'l_t': 1e-3, 'dl_t': 1e-3, 'ddl_t': 2e4, 'dddl_t': 2e2,
            'l_s': 1e0, 'r': 1e1, 'omega': 1e-1, 'domega': 5e7,
            'lambda': 1., 'delta': 1e-4, 'ddelta': 1e2,
            'coeff': 1e-4, 'diam_s': 1e0, 'diam_t': 1e0,
        },
        # homotopy cost schedule: name -> list of values indexed by update count
        'cost': {
            'tracking':             [1e-1, 1e-3],
            'u_regularisation':     [1e-6],
            'xdot_regularisation':  [1e-8],
            'theta_regularisation': [1e0],
            'gamma':                [0., 1e2, 1e-3],
            'iota':                 [0., 1e2, 1e-3],
            'psi':                  [0., 1e2, 1e-3],
            'tau':                  [0., 1e3, 1e-3],
            'eta':                  [0., 1e3],
            'nu':                   [0., 1e3],
            'upsilon':              [0., 1e3],
            'fictitious':           [1e3, 1e3, 1e-3],
            'power':                [0.],   # [1] filled by derived options
            't_f':                  [0.],
            'beta':                 [1e3],
            # landing/transition ladders (reference default.py:430-457)
            'nominal_landing':      [0., 1e-2],
            'transition':           [0., 1e-1],
            'compromised_battery':  [0., 1e1, 0.],
        },
        'callback': False,       # per-iteration recording (tools/callback.py)
        'callback_step': 1,
        'health_check': {'when': 'never', 'raise_exception': False,
                         'thresh': {'reduced_hessian_eig': 1e-8,
                                    'condition_number': 1e9}},
    }

    mpc = {
        'N': 10, 'd': 4, 'scheme': 'radau', 'u_param': 'zoh',
        'cost_type': 'tracking', 'max_iter': 1000,
        'homotopy_warmstart': True, 'terminal_point_constr': False,
        'ref_interpolator': 'spline',
    }

    sim = {'number_of_finite_elements': 20,
           'integrator': 'collocation'}  # collocation | rk4root

    quality = {
        'when': 'final_success',
        'raise_exception': False,
        'test_param': {
            'c_max': 1e0, 'dc_max': 1e1, 'z_min': 0., 'r_max': 1e-2,
            'max_loyd_factor': 30, 'max_power_harvesting_factor': 100,
            'max_tension': 1e6, 'max_velocity': 100., 't_f_min': 5.,
            'power_balance_thresh': 1e0, 'max_control_interval': 10.,
            # max estimated far-wake truncation error |u_far|/u_ref
            # (reference default.py:565 + quality_funcs.py:283)
            'vortex_truncation_error_thresh': 1e-2,
        },
        'interpolation': {'n_points': 100},
    }

    visualization = {'cosmetics': {'interpolation': {'n_points': 100},
                                   'plot_coll': True}}

    # landing/transition formulation parameters (reference
    # default.py:258-262)
    formulation = {
        'nominal_landing': {
            'main_node_radius': 40.,
            'kite_node_radius': 80.,
            'position_weight': 0.,
            'velocity_weight': 10.,
        },
    }

    return {
        'user_options': user_options,
        'params': params,
        'model': model,
        'nlp': nlp,
        'solver': solver,
        'mpc': mpc,
        'sim': sim,
        'quality': quality,
        'visualization': visualization,
        'formulation': formulation,
    }
