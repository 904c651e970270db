"""Architecture-aware option processing and scaling heuristics.

The NLP scaling is load-bearing for homotopy convergence (reference SURVEY
Appendix B.1). This module reproduces the semantics of the reference's
derived-option computation and scaling estimators
(awebox opts/model_funcs.py:227-283, 993-1057, 1141-1473):

* flight radius, aero force, centripetal force, CL/CD, Loyd power,
  tension-per-length, total mass, energy, time-period estimates;
* per-variable scaling values (q, dq, l_t, dl_t, forces, lambda tree, energy);
* constraint-applicability switches (3-DOF vs 6-DOF, anticollision,
  stress-vs-force tether constraints);
* the power-cost update value used by the homotopy 'power' step.

Everything here is build-time numpy; the results feed static pytree shapes and
numeric parameter pytrees.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np


# --- small helpers --------------------------------------------------------

def wind_speed_at(model, u_ref, z_ref, z0_air, exp_ref, zz):
    """Wind speed profile (numeric); matches mdl/wind.py:184-209."""
    z_cropped = np.sqrt(zz ** 2 + 1.)  # smooth_abs with epsilon=1
    if model == 'log_wind':
        return u_ref * np.log10(z_cropped / z0_air) / np.log10(z_ref / z0_air)
    elif model == 'power':
        return u_ref * (z_cropped / z_ref) ** exp_ref
    elif model == 'uniform':
        return u_ref
    raise ValueError(f'unsupported wind model {model}')


def _get_u_at_altitude(options, zz):
    return wind_speed_at(
        options['user_options']['wind']['model'],
        options['user_options']['wind']['u_ref'],
        options['params']['wind']['z_ref'],
        options['params']['wind']['log_wind']['z0_air'],
        options['params']['wind']['power_wind']['exp_ref'],
        zz)


def _get_q_at_altitude(options, zz):
    u = _get_u_at_altitude(options, zz)
    return 0.5 * options['params']['atmosphere']['rho_ref'] * u ** 2


def _estimate_position_of_main_tether_end(options):
    incl = options['solver']['initialization']['inclination_deg'] * np.pi / 180.
    length = options['solver']['initialization']['l_t']
    return length * np.array([np.cos(incl), 0., np.sin(incl)])


def _estimate_altitude(options):
    return _estimate_position_of_main_tether_end(options)[2]


def get_geometry(options) -> Dict[str, Any]:
    kite_standard = options['user_options']['kite_standard']
    if kite_standard is None:
        raise ValueError('user_options.kite_standard must be set (a kite data dict)')
    return copy.deepcopy(kite_standard['geometry'])


def load_stability_derivatives(options):
    ks = options['user_options']['kite_standard']
    return copy.deepcopy(ks['stab_derivs']), copy.deepcopy(ks['aero_validity'])


def _estimate_CL_CD(options):
    """CL/CD at max valid alpha; mdl_funcs estimate_CL/estimate_CD."""
    aero_deriv, aero_validity = load_stability_derivatives(options)
    alpha = aero_validity['alpha_max_deg'] * np.pi / 180.
    cos, sin = np.cos(alpha), np.sin(alpha)

    kite_dof = options['user_options']['system_model']['kite_dof']
    if int(kite_dof) == 3:
        CL = options['model']['system_bounds']['x']['coeff'][1][0]
    elif 'CL' in aero_deriv:
        CL = aero_deriv['CL']['0'][0] + aero_deriv['CL']['alpha'][0] * alpha
    elif 'CZ' in aero_deriv:
        CX = aero_deriv['CX']['0'][0] + aero_deriv['CX']['alpha'][0] * alpha
        CZ = aero_deriv['CZ']['0'][0] + aero_deriv['CZ']['alpha'][0] * alpha
        CL = CX * sin - CZ * cos

    if 'CD' in aero_deriv:
        CD = aero_deriv['CD']['0'][0] + aero_deriv['CD']['alpha'][0] * alpha
    elif 'CZ' in aero_deriv:
        CX = aero_deriv['CX']['0'][0] + aero_deriv['CX']['alpha'][0] * alpha
        CZ = aero_deriv['CZ']['0'][0] + aero_deriv['CZ']['alpha'][0] * alpha
        CD = -CX * cos - CZ * sin
    return float(CL), float(CD)


def estimate_flight_radius(options, architecture):
    b_ref = get_geometry(options)['b_ref']
    anticollision_radius = b_ref * options['model']['model_bounds']['anticollision']['safety_factor']

    acc_max = options['model']['model_bounds']['acceleration']['acc_max']
    gravity = options['model']['scaling']['other']['g']
    groundspeed = options['solver']['initialization']['groundspeed']
    centripetal_radius = groundspeed ** 2. / (acc_max * gravity)

    cone_angle = options['solver']['initialization']['cone_deg'] * np.pi / 180.
    if architecture.number_of_kites == 1:
        length = options['solver']['initialization']['l_t']
    else:
        length = options['solver']['initialization']['theta']['l_s']
    cone_radius = float(length * np.sin(cone_angle))

    method = options['model']['scaling']['other']['flight_radius_estimate']
    if method == 'anticollision':
        return anticollision_radius
    if method == 'centripetal':
        return centripetal_radius
    if method == 'cone':
        return cone_radius
    if method == 'synthesized':
        vals = np.array([anticollision_radius, centripetal_radius, cone_radius])
        return float(np.exp(np.mean(np.log(vals))))
    raise ValueError(f'unknown flight radius method {method}')


def estimate_aero_force(options):
    geometry = get_geometry(options)
    CL, _ = _estimate_CL_CD(options)
    zz = _estimate_altitude(options)
    u_wind = _get_u_at_altitude(options, zz)
    groundspeed = options['solver']['initialization']['groundspeed']
    u_app = np.sqrt(u_wind ** 2 + groundspeed ** 2.)
    q_app = 0.5 * options['params']['atmosphere']['rho_ref'] * u_app ** 2
    return CL * q_app * geometry['s_ref']


def estimate_centripetal_force(options, architecture):
    geometry = get_geometry(options)
    groundspeed = options['solver']['initialization']['groundspeed']
    radius = estimate_flight_radius(options, architecture)
    return geometry['m_k'] * groundspeed ** 2. / radius


def estimate_power(options, architecture):
    zz = _estimate_altitude(options)
    uu = _get_u_at_altitude(options, zz)
    qq = _get_q_at_altitude(options, zz)
    power_density = uu * qq
    geometry = get_geometry(options)
    elevation = options['solver']['initialization']['inclination_deg'] * np.pi / 180.
    CL, CD = _estimate_CL_CD(options)

    eps = 1.e-6
    CR = CL * (1. + CD ** 2. / (CL ** 2 + eps ** 2.)) ** 0.5
    phf = 4. / 27. * CR * (CR / CD) ** 2. * np.cos(elevation) ** 3.
    p_loyd = power_density * geometry['s_ref'] * phf

    induction_efficiency = 1. if options['user_options']['induction_model'] == 'not_in_use' else 0.5
    kite_dof = int(options['user_options']['system_model']['kite_dof'])
    dof_efficiency = 1. if kite_dof == 3 else 0.5
    return architecture.number_of_kites * p_loyd * induction_efficiency * dof_efficiency


def estimate_reelout_speed(options):
    zz = _estimate_altitude(options)
    return _get_u_at_altitude(options, zz) / 3.


def estimate_total_mass(options, architecture):
    init_theta = options['solver']['initialization']['theta']
    rho_tether = options['params']['tether']['rho']
    mass = get_geometry(options)['m_k'] * architecture.number_of_kites
    area_t = np.pi * (init_theta['diam_t'] / 2.) ** 2.
    mass += area_t * options['solver']['initialization']['l_t'] * rho_tether
    if architecture.number_of_kites > 1:
        area_s = np.pi * (init_theta['diam_s'] / 2.) ** 2.
        mass += area_s * init_theta['l_s'] * rho_tether * architecture.number_of_kites
    n_intermediate = architecture.number_of_nodes - 1 - architecture.number_of_kites
    if n_intermediate > 0:
        area_i = np.pi * (init_theta['diam_i'] / 2.) ** 2.
        mass += area_i * init_theta['l_i'] * rho_tether * n_intermediate
    return mass


def estimate_main_tether_tension_per_unit_length(options, architecture):
    power = estimate_power(options, architecture)
    tension_via_power = power / estimate_reelout_speed(options)

    aero_force = estimate_aero_force(options)
    cone = options['solver']['initialization']['cone_deg'] * np.pi / 180.
    aero_sum = aero_force * np.cos(cone) * architecture.number_of_kites
    total_mass = estimate_total_mass(options, architecture)
    gravity = options['model']['scaling']['other']['g']
    incl = options['solver']['initialization']['inclination_deg'] * np.pi / 180.
    grav_sum = total_mass * gravity * np.sin(incl)
    tension_via_force_summation = abs(aero_sum - grav_sum)

    max_stress = options['params']['tether']['max_stress'] / options['params']['tether']['stress_safety_factor']
    diam_t = options['solver']['initialization']['theta']['diam_t']
    tension_via_max_stress = 0.5 * max_stress * np.pi * (diam_t / 2.) ** 2.

    limits = options['params']['model_bounds']['tether_force_limits']
    tension_via_average_force = (limits[0] + limits[1]) / 2.

    method = options['model']['scaling']['other']['tension_estimate']
    if method == 'power':
        tension = tension_via_power
    elif method == 'max_stress':
        tension = tension_via_max_stress
    elif method == 'average_force':
        tension = tension_via_average_force
    elif method == 'force_summation':
        tension = tension_via_force_summation
    elif method == 'synthesized':
        vals = np.array([tension_via_power, tension_via_max_stress,
                         tension_via_average_force, tension_via_force_summation])
        tension = float(np.exp(np.mean(np.log(np.maximum(vals, 1e-12)))))
    else:
        raise ValueError(f'unknown tension estimation method {method}')
    return tension / options['solver']['initialization']['l_t']


def estimate_time_period(options, architecture):
    fixed = options['user_options']['trajectory']['fixed_params']
    if 't_f' in fixed:
        return fixed['t_f']
    windings = options['user_options']['trajectory']['lift_mode']['windings']
    groundspeed = options['solver']['initialization']['groundspeed']
    radius = estimate_flight_radius(options, architecture)
    return float((2. * np.pi * windings * radius) / groundspeed)


def estimate_energy(options, architecture):
    return estimate_power(options, architecture) * estimate_time_period(options, architecture)


# --- main entry -----------------------------------------------------------

def build_processed_options(options: Dict[str, Any], architecture) -> Dict[str, Any]:
    options = copy.deepcopy(options)
    user_options = options['user_options']
    kite_dof = int(user_options['system_model']['kite_dof'])
    geometry = get_geometry(options)
    stab_derivs, aero_validity = load_stability_derivatives(options)

    # constraint applicability (model_funcs.py:327-386)
    if kite_dof == 3:
        options['model']['model_bounds']['rotation']['include'] = False
        options['model']['model_bounds']['aero_validity']['include'] = False
    if architecture.number_of_kites == 1:
        options['model']['model_bounds']['anticollision']['include'] = False

    # tether control variable plumbing (model_funcs.py:892-919)
    control_var = options['model']['tether']['control_var']
    ddl_t_bounds = options['model']['system_bounds']['x']['ddl_t']
    scaling: Dict[str, Dict[str, np.ndarray]] = {'x': {}, 'u': {}, 'z': {}, 'theta': {}}
    if control_var == 'ddl_t':
        options['model']['system_bounds']['u']['ddl_t'] = ddl_t_bounds
        scaling['u']['ddl_t'] = np.max(np.array(ddl_t_bounds)) / 2.
    elif control_var == 'dddl_t':
        scaling['x']['ddl_t'] = np.max(np.array(ddl_t_bounds)) / 2.
        dddl_t_bounds = options['model']['system_bounds']['u']['dddl_t']
        scaling['u']['dddl_t'] = np.max(np.array(dddl_t_bounds)) / 2.
    else:
        raise ValueError('invalid tether control variable')

    # tether constraint includes (model_funcs.py:860-887)
    includes = {'stress': [], 'force': []}
    stress_incl = options['model']['model_bounds']['tether_stress']['include']
    force_incl = options['model']['model_bounds']['tether_force']['include']
    if force_incl and stress_incl:
        includes['stress'] = [n for n in range(1, architecture.number_of_nodes)
                              if n not in architecture.kite_nodes]
        includes['force'] = list(architecture.kite_nodes)
    elif force_incl:
        includes['force'] = list(architecture.kite_nodes)
        includes['stress'] = [n for n in range(1, architecture.number_of_nodes)
                              if n not in architecture.kite_nodes]
    elif stress_incl:
        includes['stress'] = list(range(1, architecture.number_of_nodes))

    # basic scaling values (model_funcs.py:252-283)
    init = options['solver']['initialization']
    length_scaling = init['l_t']
    scaling['x']['l_t'] = np.array(length_scaling)
    scaling['theta']['l_t'] = np.array(length_scaling)

    flight_radius = estimate_flight_radius(options, architecture)
    method = options['model']['scaling']['other']['position_scaling_method']
    position = _estimate_position_of_main_tether_end(options)
    if method == 'radius':
        q_scaling = flight_radius * np.ones(3)
    elif method == 'altitude':
        q_scaling = position[2] * np.ones(3)
    elif method == 'b_ref':
        q_scaling = geometry['b_ref'] * np.ones(3)
    elif method == 'radius_and_tether':
        q_scaling = np.array([position[0], flight_radius, flight_radius])
    elif 'radius' in method and 'altitude' in method:
        q_scaling = np.array([position[0], flight_radius, position[2]])
    else:
        raise ValueError(f'unknown position scaling method {method}')
    scaling['x']['q'] = q_scaling

    u_altitude = _get_u_at_altitude(options, _estimate_altitude(options))
    groundspeed = init['groundspeed']
    for node in range(1, architecture.number_of_nodes):
        label = architecture.node_label(node)
        if node in architecture.kite_nodes:
            scaling['x']['dq' + label] = np.array(groundspeed)
        else:
            scaling['x']['dq' + label] = np.array(u_altitude)
    scaling['x']['dl_t'] = np.array(u_altitude / 3.)

    for param, val in init['theta'].items():
        scaling['theta'][param] = np.array(val)
    scaling['theta']['t_f'] = np.array(1.0)

    # kite-dof-dependent scaling (model_funcs.py:287-344)
    t_f_guess = estimate_time_period(options, architecture)
    windings = user_options['trajectory']['lift_mode']['windings']
    omega_guess = 2. * np.pi / (t_f_guess / float(windings))
    if kite_dof == 6:
        delta_max = np.asarray(geometry['delta_max'], dtype=float)
        ddelta_max = np.asarray(geometry['ddelta_max'], dtype=float)
        options['model']['system_bounds']['x']['delta'] = [-delta_max, delta_max]
        options['model']['system_bounds']['u']['ddelta'] = [-ddelta_max, ddelta_max]
        scaling['x']['delta'] = delta_max / 2.
        scaling['u']['ddelta'] = ddelta_max / 2.
        scaling['x']['omega'] = np.array(omega_guess)
        scaling['x']['r'] = np.ones(9)
    else:
        coeff_max = np.asarray(options['model']['system_bounds']['x']['coeff'][1], dtype=float)
        dcoeff_max = np.asarray(options['model']['system_bounds']['u']['dcoeff'][1], dtype=float)
        scaling['x']['coeff'] = coeff_max
        scaling['u']['dcoeff'] = dcoeff_max

    # force scaling (model_funcs.py:993-1057)
    b_ref = geometry['b_ref']
    q_altitude = _get_q_at_altitude(options, _estimate_altitude(options))
    centripetal_force = float(estimate_centripetal_force(options, architecture))
    gravity = options['model']['scaling']['other']['g']
    acc_max = options['model']['model_bounds']['acceleration']['acc_max']
    max_acceleration_force = float(geometry['m_k'] * acc_max * gravity)
    aero_force = float(estimate_aero_force(options))
    total_mass = estimate_total_mass(options, architecture)
    gravity_force = total_mass * gravity / float(architecture.number_of_kites)
    tension_per_length = estimate_main_tether_tension_per_unit_length(options, architecture)
    tension = tension_per_length * init['l_t']

    f_method = options['model']['scaling']['other']['force_scaling_method']
    estimates = {
        'max_acceleration': max_acceleration_force, 'tension': tension,
        'gravity': gravity_force, 'centripetal': centripetal_force, 'aero': aero_force,
    }
    if f_method == 'synthesized':
        vals = np.array(list(estimates.values()))
        f_scaling = float(np.exp(np.mean(np.log(np.maximum(vals, 1e-12)))))
    elif f_method in estimates:
        f_scaling = estimates[f_method]
    else:
        raise ValueError(f'unknown force scaling method {f_method}')

    moment_factor = b_ref / 2.
    scaling['u']['f_fict'] = np.array(f_scaling)
    scaling['u']['m_fict'] = np.array(f_scaling * moment_factor)
    scaling['z']['f_aero'] = np.array(f_scaling)
    scaling['z']['m_aero'] = np.array(f_scaling * moment_factor)

    CD_tether = options['params']['tether']['cd']
    diam_t = init['theta']['diam_t']
    scaling['z']['f_tether'] = np.array(
        0.5 * CD_tether * (0.25 * q_altitude) * diam_t * init['l_t'])

    # lambda / energy / power scaling (model_funcs.py:1069-1138)
    lam = estimate_main_tether_tension_per_unit_length(options, architecture)
    lambda_scaling = options['model']['scaling_overwrite']['lambda_factor'] * lam
    energy = estimate_energy(options, architecture)
    energy_scaling = options['model']['scaling_overwrite']['energy_factor'] * energy
    estimated_power = estimate_power(options, architecture)
    power_cost_factor = options['solver']['cost_factor']['power']
    power_cost_update = power_cost_factor * energy_scaling / estimated_power  # = pcf * T_est

    scaling['z']['lambda10'] = np.array(lambda_scaling)
    # lambda scaling tree for multi-node architectures
    if architecture.number_of_nodes > 2:
        l_s_scaling = init['theta']['l_s']
        l_t_scaling = init['l_t']
        l_i_scaling = init['theta']['l_i']
        tension_main = lambda_scaling * l_t_scaling
        lambda_s_scaling = tension_main / architecture.number_of_kites / l_s_scaling
        lambda_i_max = tension_main / l_i_scaling
        layers = architecture.layers
        layer_count = 1
        for node in range(2, architecture.number_of_nodes):
            label = 'lambda' + architecture.node_label(node)
            if node in architecture.kite_nodes:
                scaling['z'][label] = np.array(lambda_s_scaling)
            else:
                linear_factor = (layers - layer_count) / float(layers)
                scaling['z'][label] = np.array(linear_factor * lambda_i_max)
                layer_count += 1

    scaling['x']['e'] = np.array(energy_scaling)

    # fixed design parameters: pin theta bounds and override the initial guess,
    # but (matching the reference option-assembly order, funcs.py:51-54 vs
    # model_funcs.py:252-283) NOT the scaling values computed above.
    fixed_params = dict(user_options['trajectory'].get('fixed_params') or {})
    initialization_theta = dict(init['theta'])
    initialization_theta['l_t'] = init['l_t']
    for name, value in fixed_params.items():
        options['model']['system_bounds']['theta'][name] = [value, value]
        initialization_theta[name] = value

    # ---- induction model plumbing (model_funcs.py:520-805) ---------------
    induction_model = user_options['induction_model']
    act_labels = []
    act_primary = None
    if induction_model in ('actuator', 'vortex'):
        a_ref_ind = float(options['model']['aero']['actuator']['a_ref'])
        scaling['z']['ui'] = np.array(
            a_ref_ind * float(user_options['wind']['u_ref']))
        # degree-2 lifting: near/far wake contributions share ui's scale
        scaling['z']['uin'] = scaling['z']['ui']
        scaling['z']['uif'] = scaling['z']['ui']
    if (induction_model == 'vortex'
            and options['model']['aero']['vortex']['representation']
            == 'state'):
        # diff/state-representation wake variables (reference
        # diff_repr_dir/scaling.py:85-107): wake-node positions scale like
        # the kite position ('q10' position_scaling_method); ring strengths
        # like the lifting-line circulation estimate
        # Gamma ~ 0.5 CL u_app c_ref (alg_repr_dir/scaling.py:51-71)
        geometry = get_geometry(options)
        CL_est, _ = _estimate_CL_CD(options)
        u_wind = _get_u_at_altitude(options, _estimate_altitude(options))
        groundspeed = options['solver']['initialization']['groundspeed']
        u_app = np.sqrt(u_wind ** 2 + groundspeed ** 2)
        wg_scale = max(0.5 * abs(CL_est) * u_app * geometry['c_ref'], 1.0)
        wake_nodes = int(options['model']['aero']['vortex']['wake_nodes'])
        q_pos_scale = np.asarray(scaling['x']['q'], dtype=float)
        for kite in architecture.kite_nodes:
            label = architecture.node_label(kite)
            for r in range(wake_nodes):
                scaling['z'][f'wxm{label}_{r}'] = q_pos_scale
                scaling['z'][f'wxp{label}_{r}'] = q_pos_scale
                scaling['z'][f'wg{label}_{r}'] = np.array(wg_scale)
    if induction_model == 'actuator':
        act = options['model']['aero']['actuator']
        steady_map = {'quasi-steady': 'q', 'steady': 'q', 'unsteady': 'u'}
        sym_map = {'axisymmetric': 'axi', 'asymmetric': 'asym'}
        act_primary = steady_map[act['steadyness']] + sym_map[act['symmetry']]
        steadies = sorted(set([steady_map[act['steadyness']]]
                              + list(act['steadyness_comparison'])))
        syms = sorted(set([sym_map[act['symmetry']]]
                          + list(act['symmetry_comparison'])))
        act_labels = [s + y for s in steadies for y in syms]
        for lbl in act_labels:
            holder = 'x' if lbl[0] == 'u' else 'z'
            scaling[holder]['a_' + lbl] = np.array(1.0)
            options['model']['system_bounds'][holder]['a_' + lbl] = \
                list(act['a_range'])
            if 'asym' in lbl:
                for prefix in ('acos_', 'asin_'):
                    scaling[holder][prefix + lbl] = np.array(1.0)
                    options['model']['system_bounds'][holder][prefix + lbl] = \
                        list(act['a_fourier_range'])

    processed = {
        'geometry': geometry,
        'stab_derivs': stab_derivs,
        'aero_validity': aero_validity,
        'scaling': scaling,
        'tether_constraint_includes': includes,
        'fixed_params': fixed_params,
        'initialization_theta': initialization_theta,
        'power_cost_update': float(power_cost_update),
        'estimates': {
            'flight_radius': flight_radius,
            'aero_force': aero_force,
            'centripetal_force': centripetal_force,
            'power': estimated_power,
            'energy': energy_scaling,
            'tension_per_length': float(lam),
            'total_mass': float(total_mass),
            'time_period': float(t_f_guess),
            'u_altitude': float(u_altitude),
            'q_altitude': float(q_altitude),
            'omega_guess': float(omega_guess),
            'f_scaling': float(f_scaling),
            'CL_CD': _estimate_CL_CD(options),
        },
        'airspeed_ref': float(np.sqrt(groundspeed ** 2. + u_altitude ** 2.)),
        'anticollision_num_ref': float(groundspeed ** 2.),
        'induction_model': induction_model,
        'act_comparison_labels': act_labels,
        'act_primary_label': act_primary,
        'act_varrho_ref': float(flight_radius / geometry['b_ref']),
    }

    # homotopy power-cost update value (solver.cost.power[1])
    options['solver']['cost']['power'] = [0., float(power_cost_update)]

    options['processed'] = processed
    options['architecture'] = architecture
    return options
