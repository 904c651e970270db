"""Initial guess generation: uniform circular path per kite.

Counterpart of ``awebox_tpu/opti/initialization.py`` (numpy only).

Counterpart of awebox opti/initialization_dir/
{initialization, standard_scenario, tools}.py: precomputed circle parameters
(radius from cone angle, groundspeed clipped into the airspeed window,
winding period), kite positions/velocities on the circle, aero-validity-
aligned DCMs, static tether nodes, and polynomial-consistent xdot entries.
All build-time numpy; the result is a scaled flat V vector.
"""
from __future__ import annotations

import numpy as np

from ..options.derived import wind_speed_at


def _wind_velocity(options, zz):
    uu = wind_speed_at(
        options['user_options']['wind']['model'],
        options['user_options']['wind']['u_ref'],
        options['params']['wind']['z_ref'],
        options['params']['wind']['log_wind']['z0_air'],
        options['params']['wind']['power_wind']['exp_ref'], zz)
    return np.array([uu, 0., 0.])


def _normalize(v):
    return v / np.linalg.norm(v)


def precompute_path_parameters(options, arch):
    """standard_scenario.py:215-458."""
    init = options['solver']['initialization']
    pre = {}

    l_t = init['l_t']
    hypotenuse = l_t if arch.number_of_kites == 1 else init['theta']['l_s']
    pre['hypotenuse'] = hypotenuse
    cone_angle = init['cone_deg'] * np.pi / 180.
    radius = hypotenuse * np.sin(cone_angle)
    pre['radius'] = radius

    inclination = init['inclination_deg'] * np.pi / 180.
    ehat_tether = np.array([np.cos(inclination), 0., np.sin(inclination)])
    zz = l_t * ehat_tether[2]

    groundspeed = init['groundspeed']
    mb = options['model']['model_bounds']
    airspeed_include = mb['airspeed']['include']
    limits = options['params']['model_bounds']['airspeed_limits']

    def airspeed_at(psi, gs):
        # velocity on the circle at azimuth psi
        n_hat = ehat_tether
        if np.linalg.norm(n_hat - np.array([1., 0., 0.])) < 1e-4:
            y_rot = np.array([0., 1., 0.])
            z_rot = np.array([0., 0., 1.])
        else:
            y_rot = _normalize(np.cross(n_hat, np.array([1., 0., 0.])))
            z_rot = _normalize(np.cross(n_hat, y_rot))
        sign = 1. if init['clockwise_rotation_about_xhat'] else -1.
        outward = z_rot * np.cos(psi) - sign * y_rot * np.sin(psi)
        radial = sign * outward
        tangential = _normalize(np.cross(n_hat, radial))
        vel = gs * tangential
        u_app = vel - _wind_velocity(options, zz)
        return np.linalg.norm(u_app)

    if airspeed_include and init['init_clipping']:
        gs = groundspeed
        for _ in range(60):
            speeds = [airspeed_at(psi, gs)
                      for psi in [np.pi / 2., np.pi, 3 * np.pi / 2., 2 * np.pi]]
            if min(speeds) <= limits[0]:
                gs += 1.
            elif max(speeds) >= limits[1]:
                gs -= 1.
            else:
                break
        groundspeed = gs
    pre['groundspeed'] = groundspeed

    winding_period = 2. * np.pi * radius / groundspeed
    if mb['acceleration']['include'] and init['init_clipping']:
        acc_max = mb['acceleration']['acc_max'] * 9.81
        omega = 2. * np.pi / winding_period
        if groundspeed * omega > acc_max:
            winding_period = 2. * np.pi * groundspeed / acc_max
    pre['winding_period'] = winding_period

    windings = options['user_options']['trajectory']['lift_mode']['windings']
    pre['time_final'] = windings * winding_period
    pre['height'] = np.sqrt(max(hypotenuse ** 2 - radius ** 2, 0.))
    pre['angular_speed'] = groundspeed / radius
    pre['ehat_tether'] = ehat_tether
    pre['sign'] = 1. if init['clockwise_rotation_about_xhat'] else -1.
    return pre


def guess_values_at_time(t, options, arch, model, pre):
    """standard_scenario.py:72-149; returns SI name->value dict."""
    init = options['solver']['initialization']
    ret = {}
    l_t = init['l_t']
    ret['l_t'] = l_t
    ret['dl_t'] = 0.
    ret['e'] = 0.

    n_hat = pre['ehat_tether']
    sign = pre['sign']
    if np.linalg.norm(n_hat - np.array([1., 0., 0.])) < 1e-4:
        y_rot = np.array([0., 1., 0.])
        z_rot = np.array([0., 0., 1.])
    else:
        y_rot = _normalize(np.cross(n_hat, np.array([1., 0., 0.])))
        z_rot = _normalize(np.cross(n_hat, y_rot))

    level_siblings = arch.get_all_level_siblings()
    omega_norm = pre['angular_speed']

    for node in range(1, arch.number_of_nodes):
        label = arch.node_label(node)
        parent = arch.parent_map[node]
        parent_position = np.zeros(3) if parent == 0 \
            else np.asarray(ret['q' + arch.parent_label(node)])

        if node not in arch.kite_nodes:
            seg_length = init['theta']['l_i'] if node > 1 else l_t
            ret['q' + label] = parent_position + seg_length * n_hat
            ret['dq' + label] = np.zeros(3)
            ret['ddq' + label] = np.zeros(3)
        else:
            siblings = level_siblings[parent]
            idx = siblings.index(node)
            psi0 = init['psi0_rad'] + (idx / len(siblings)) * 2. * np.pi \
                if len(siblings) > 1 else init['psi0_rad']
            psi = np.mod(psi0 + omega_norm * t, 2. * np.pi)

            outward = z_rot * np.cos(psi) - sign * y_rot * np.sin(psi)
            radial = sign * outward
            tangential = _normalize(np.cross(n_hat, radial))

            position = parent_position + outward * pre['radius'] + n_hat * pre['height']
            velocity = pre['groundspeed'] * tangential
            acceleration = pre['groundspeed'] ** 2 / pre['radius'] * (-outward)
            ret['q' + label] = position
            ret['dq' + label] = velocity
            ret['ddq' + label] = acceleration

            kite_dof = int(options['user_options']['system_model']['kite_dof'])
            if kite_dof == 3:
                ret['coeff' + label] = np.array([1., 0.])
            else:
                # aero-validity-aligned DCM (initialization tools.py:228-297)
                q10 = ret['q10'] if 'q10' in ret else position
                normal = _normalize(np.asarray(q10))
                u_app = _wind_velocity(options, position[2]) - velocity
                ehat1 = _normalize(u_app)
                ehat2 = _normalize(np.cross(normal, ehat1))
                ehat3 = _normalize(np.cross(ehat1, ehat2))
                dcm = np.stack([ehat1, ehat2, ehat3], axis=1)
                omega_body = sign * omega_norm * np.array([0., 0., 1.])
                skew = np.array([[0, -omega_body[2], omega_body[1]],
                                 [omega_body[2], 0, -omega_body[0]],
                                 [-omega_body[1], omega_body[0], 0]])
                ret['r' + label] = dcm.reshape(9)          # row-major
                ret['omega' + label] = omega_body
                ret['dr' + label] = (dcm @ skew).reshape(9)
                ret['domega' + label] = np.zeros(3)
                ret['delta' + label] = np.zeros(3)
    return ret


def _fill_z_theta_phi(ocp, V, tf_guess):
    """Shared guess scaffolding: z defaults, theta from processed
    initialization values, phi = 1 (initialization.py:59-103)."""
    options = ocp.options
    model = ocp.model
    layout = model.layout
    vs = ocp.vstruct
    n_k, d = ocp.n_k, ocp.d

    # multipliers nonzero: z entries start at scaled 1 (initialization.py:59-69)
    z_init = np.ones(vs.nz)
    # induction guesses (initialization_dir/induction.py): ui starts at 0
    # (the iota step enters with the trivial residual pinned), induction
    # factors at a_ref
    a_ref = float(options['model']['aero']['actuator']['a_ref'])
    for name, dim in layout.entries['z']:
        sl = layout.slices['z'][name]
        if name.startswith('ui'):
            z_init[sl] = 0.
        elif name.startswith('a_'):
            z_init[sl] = a_ref / model.scaling['z'][sl]
        elif name.startswith(('acos_', 'asin_')):
            z_init[sl] = 0.
    if vs.u_param in ('zoh', 'ms'):
        for k in range(n_k):
            V[vs.z_slice(k)] = z_init
    if vs.u_param != 'ms':
        for k in range(n_k):
            for j in range(d):
                V[vs.coll_z_slice(k, j)] = z_init

    # theta
    init_theta = options['processed']['initialization_theta']
    for name in vs.theta_names:
        sl = vs.theta_slice(name)
        msl = layout.slices['theta'][name]
        scale = model.scaling['theta'][msl]
        if name == 't_f':
            V[sl] = tf_guess / scale[0]
        else:
            val = init_theta.get(name, 1.0)
            V[sl] = np.asarray(val) / scale

    # phi = 1
    V[vs.phi_slice] = 1.
    return V


def _make_pack_x(ocp):
    """SI name->value dict -> scaled x vector packer."""
    model = ocp.model
    layout = model.layout
    vs = ocp.vstruct
    scale_x = model.scaling['x']
    a_ref = float(ocp.options['model']['aero']['actuator']['a_ref'])

    def pack_x(ret):
        out = np.zeros(vs.nx)
        for name, dim in layout.entries['x']:
            if name in ret:
                sl = layout.slices['x'][name]
                out[sl] = np.reshape(np.asarray(ret[name], dtype=float), -1) / scale_x[sl]
            elif name.startswith('a_'):   # unsteady actuator states
                sl = layout.slices['x'][name]
                out[sl] = a_ref / scale_x[sl]
        return out
    return pack_x


def build_initial_guess(ocp) -> np.ndarray:
    """Scaled V_init (initialization.py:47-103): the circular-path guess.
    The modular initializer is not ported."""
    init_type = ocp.options['solver']['initialization'].get('type', 'default')
    if init_type == 'modular':
        raise NotImplementedError("solver.initialization.type='modular' is not ported")

    options = ocp.options
    model = ocp.model
    arch = model.arch
    layout = model.layout
    vs = ocp.vstruct
    n_k, d = ocp.n_k, ocp.d

    pre = precompute_path_parameters(options, arch)
    tf_guess = pre['time_final']

    V = np.zeros(vs.total)
    _fill_z_theta_phi(ocp, V, tf_guess)

    # time grids (per-phase uniform; 'simple' phase fix => uniform)
    tf_k = np.full(n_k, tf_guess)
    t_x = np.concatenate([[0.], np.cumsum(tf_k / n_k)])

    pack_x = _make_pack_x(ocp)

    for k in range(n_k + 1):
        ret = guess_values_at_time(t_x[k], options, arch, model, pre)
        V[vs.x_slice(k)] = pack_x(ret)
        if k < n_k and vs.u_param != 'ms':
            for j in range(d):
                t_coll = t_x[k] + ocp.coll.tau_root[1 + j] * tf_guess / n_k
                ret_c = guess_values_at_time(t_coll, options, arch, model, pre)
                V[vs.coll_x_slice(k, j)] = pack_x(ret_c)
                # coll z stays at scaled 1

    # xdot from the interpolating polynomial (initialization.py:240-246);
    # poly controls carry no shooting-node xdot block; multiple shooting has
    # no collocation points, so use a central finite difference of the guess
    if vs.u_param == 'zoh':
        C = ocp.coll.coeff_collocation
        h = 1. / n_k
        for k in range(n_k):
            X_stack = np.stack([V[vs.x_slice(k)]] +
                               [V[vs.coll_x_slice(k, j)] for j in range(d)])
            xdot0_scaled_x = (C[:, 0] @ X_stack) / (h * tf_guess)
            # convert x-scaled derivative to xdot scaling (identical vectors)
            V[vs.xdot_slice(k)] = xdot0_scaled_x
    elif vs.u_param == 'ms':
        eps = 1e-4 * pre['winding_period']
        for k in range(n_k):
            rp = pack_x(guess_values_at_time(t_x[k] + eps, options, arch,
                                             model, pre))
            rm = pack_x(guess_values_at_time(t_x[k] - eps, options, arch,
                                             model, pre))
            V[vs.xdot_slice(k)] = (rp - rm) / (2. * eps)

    return V


def build_reference(ocp, V_init: np.ndarray) -> np.ndarray:
    """Tracking reference = initial guess with node positions staggered
    outward (opti/reference.py:42-205)."""
    options = ocp.options
    model = ocp.model
    arch = model.arch
    layout = model.layout
    vs = ocp.vstruct
    stagger = options['solver']['tracking']['stagger_distance']

    V_ref = V_init.copy()
    q_scales = {}
    for node in range(1, arch.number_of_nodes):
        name = 'q' + arch.node_label(node)
        q_scales[node] = model.scaling['x'][layout.slices['x'][name]]

    def stagger_block(xvec_scaled, k_is_last=False):
        out = xvec_scaled.copy()
        positions = {}
        for node in range(1, arch.number_of_nodes):
            name = 'q' + arch.node_label(node)
            sl = layout.slices['x'][name]
            positions[node] = xvec_scaled[sl] * q_scales[node]
        for node in range(1, arch.number_of_nodes):
            name = 'q' + arch.node_label(node)
            sl = layout.slices['x'][name]
            parent = arch.parent_map[node]
            q_parent = np.zeros(3) if parent == 0 else positions[parent]
            ehat = _normalize(positions[node] - q_parent)
            factor = 0.5 if parent == 0 else 1.0
            out[sl] = out[sl] + stagger * factor * ehat / q_scales[node]
        return out

    for k in range(ocp.n_k):
        sl = vs.x_slice(k)
        V_ref[sl] = stagger_block(V_init[sl])
        if vs.u_param != 'ms':
            for j in range(ocp.d):
                slc = vs.coll_x_slice(k, j)
                V_ref[slc] = stagger_block(V_init[slc])

    return V_ref
