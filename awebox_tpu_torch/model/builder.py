"""Model factory: the implicit-DAE dynamics residual, path inequalities,
power and outputs for a given architecture and options, in PyTorch.

Counterpart of ``awebox_tpu/model/builder.py``. The result is a
:class:`Model` whose members are plain torch functions of a flat scaled
model-variables vector ``v`` (layout [x, xdot, u, z, theta]), the
homotopy-parameter vector ``phi`` and a parameter dict ``theta0`` of tensors;
they are written so that ``torch.func.vmap``/``jacfwd``/``hessian`` apply
(no in-place writes, no Python branches on tensor values).

Ported configurations: single- or multi-node lift or drag mode with 3-DOF or
6-DOF kites, no cross tethers, the actuator-disk and trajectory-averaged
induction models or none, energy as a state or as an integral output. The
vortex induction model and the measured ('datafile') wind raise
NotImplementedError naming the option.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..arch import Architecture
from . import lagrangian as lagr
from . import atmosphere, tether, wind
from .aero import frames, kite_aero
from .aero import induction as induction_mod
from .lagrangian import const
from .system import PHI_NAMES, generate_structure
from .vars import VarLayout, strip_node_identifier


@dataclass
class Model:
    layout: VarLayout
    gc_names: List[str]
    arch: Architecture
    cfg: dict                      # static configuration (no tensors)
    scaling: Dict[str, np.ndarray]  # per-type full scaling vectors
    theta0_init: dict              # numeric parameter tree (numpy leaves)
    eq_fn: Callable               # (v, phi, theta0) -> eq residual vector
    ineq_fn: Callable             # (v, phi, theta0) -> ineq residual vector (<= 0)
    outputs_fn: Callable          # (v, phi, theta0) -> nested outputs dict
    power_fn: Callable            # (v, phi, theta0) -> instantaneous SI power
    eq_slices: Dict[str, slice]
    ineq_slices: Dict[str, slice]
    variable_bounds_scaled: Dict[str, Tuple[np.ndarray, np.ndarray]]
    split: Callable = None
    to_si: Callable = None
    scale_full: np.ndarray = None
    avg_induction_fn: Callable = None  # (v, phi, theta0) -> (F_sum, WdA_sum)

    @property
    def n_eq(self):
        return sum(s.stop - s.start for s in self.eq_slices.values())

    @property
    def n_ineq(self):
        return sum(s.stop - s.start for s in self.ineq_slices.values())


def take(vec, idx):
    """vec[idx] for a static numpy index array: a slice when contiguous."""
    idx = np.asarray(idx)
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return vec[int(idx[0]):int(idx[0]) + idx.size]
    return vec[torch.as_tensor(idx, dtype=torch.long, device=vec.device)]


def check_ported(options):
    """Refuse configurations outside the port's scope, naming the option."""
    if options['processed']['induction_model'] == 'vortex':
        raise NotImplementedError("induction model 'vortex' is not ported")


def build_theta0(options) -> dict:
    """Numeric parameter pytree; the sweep axis of the framework."""
    params = options['params']
    proc = options['processed']
    geometry = proc['geometry']
    stab = proc['stab_derivs']

    stab_tables = {c: {i: np.asarray(v, dtype=float) for i, v in tab.items()}
                   for c, tab in stab.items() if c != 'frame'}

    theta0 = {
        'geometry': {
            'm_k': np.asarray(geometry['m_k'], dtype=float),
            'j': np.asarray(geometry['j'], dtype=float),
            'b_ref': np.asarray(geometry['b_ref'], dtype=float),
            'c_ref': np.asarray(geometry['c_ref'], dtype=float),
            's_ref': np.asarray(geometry['s_ref'], dtype=float),
        },
        'aero': {
            'stab_derivs': stab_tables,
            'moment_factor': np.asarray(params['aero']['moment_factor'], dtype=float),
            'turbine_efficiency': np.asarray(params['aero']['turbine_efficiency'], dtype=float),
        },
        'tether': {k: np.asarray(params['tether'][k], dtype=float)
                   for k in ('kappa', 'rho', 'cd', 'max_stress', 'stress_safety_factor')},
        'atmosphere': {k: np.asarray(v, dtype=float)
                       for k, v in params['atmosphere'].items()},
        'wind': {
            'u_ref': np.asarray(options['user_options']['wind']['u_ref'], dtype=float),
            'z_ref': np.asarray(params['wind']['z_ref'], dtype=float),
            'z0_air': np.asarray(params['wind']['log_wind']['z0_air'], dtype=float),
            'exp_ref': np.asarray(params['wind']['power_wind']['exp_ref'], dtype=float),
        },
        'model_bounds': {
            'tether_force_limits': np.asarray(params['model_bounds']['tether_force_limits'], dtype=float),
            'airspeed_limits': np.asarray(params['model_bounds']['airspeed_limits'], dtype=float),
            'rot_angles': np.asarray(params['model_bounds']['rot_angles'], dtype=float),
        },
        'kappa_r': np.asarray(params['kappa_r'], dtype=float),
    }

    if options['user_options']['wind']['model'] == 'datafile':
        raise NotImplementedError("wind model 'datafile' is not ported")
    return theta0


def _build_cfg(options, arch) -> dict:
    proc = options['processed']
    user = options['user_options']
    stab = proc['stab_derivs']
    stab_structure = {c: sorted(tab.keys()) for c, tab in stab.items() if c != 'frame'}

    # 3-DOF baseline drag coefficient: |C?0| with preference CX < CA < CD
    CD0 = 0.
    for label in ['CX', 'CA', 'CD']:
        if label in stab and '0' in stab[label]:
            CD0 = abs(stab[label]['0'][0])
    mb = options['model']['model_bounds']

    cfg = {
        'kite_dof': int(user['system_model']['kite_dof']),
        'surface_control': int(user['system_model']['surface_control']),
        'system_type': user['trajectory']['system_type'],
        'cross_tether': bool(user['system_model']['cross_tether']),
        'wind_model': user['wind']['model'],
        'atmosphere_model': user['atmosphere'],
        'tether_drag_model': user['tether_drag_model'],
        'tether_aero_elements': int(options['model']['tether']['aero_elements']),
        'tether_cd_model': options['model']['tether']['cd_model'],
        'tether_reynolds_smoothing': float(options['model']['tether']['reynolds_smoothing']),
        'force_frame': stab['frame']['force'],
        'moment_frame': stab['frame']['moment'],
        'stab_derivs_structure': stab_structure,
        'aero_validity': dict(proc['aero_validity']),
        'aero_validity_scaling': mb['aero_validity']['scaling'],
        'aero_validity_include': bool(mb['aero_validity']['include']),
        'airspeed_include': bool(mb['airspeed']['include']),
        'airspeed_ref': proc['airspeed_ref'],
        'anticollision_include': bool(mb['anticollision']['include']),
        'anticollision_safety_factor': mb['anticollision']['safety_factor'],
        'acceleration_include': bool(mb['acceleration']['include']),
        'acc_max': mb['acceleration']['acc_max'],
        'rotation_include': bool(mb['rotation']['include']),
        'rotation_type': mb['rotation']['type'],
        'tether_stress_tightness': mb['tether_stress']['scaling'],
        'tether_constraint_includes': proc['tether_constraint_includes'],
        'g_scaling': options['model']['scaling']['other']['g'],
        'CD0': CD0,
        'geometry_static': {'ar': proc['geometry']['ar'],
                            'b_ref': proc['geometry']['b_ref']},
    }

    # induction plumbing (induction_dir/induction.py; system.py:233-350)
    induction_model = proc['induction_model']
    act = options['model']['aero']['actuator']
    cfg['induction_model'] = induction_model
    cfg['induction_lifted'] = induction_model not in ('not_in_use', 'averaged')
    cfg['act_comparison_labels'] = list(proc['act_comparison_labels'])
    cfg['act_primary_label'] = proc['act_primary_label']
    cfg['act_varrho_ref'] = proc['act_varrho_ref']
    cfg['act_normal_vector_model'] = act['normal_vector_model']
    cfg['act_actuator_skew'] = act['actuator_skew']
    cfg['act_wake_skew'] = act['wake_skew']
    cfg['act_a_ref'] = float(act['a_ref'])
    cfg['act_asym_radial_linearity'] = bool(act['asym_radial_linearity'])
    cfg['act_force_zero'] = bool(options['model']['aero']['induction']['force_zero'])
    cfg['act_geometry_model'] = options['model']['aero']['geometry']['model']
    vor = options['model']['aero']['vortex']
    cfg['vortex_wake_nodes'] = int(vor['wake_nodes'])
    cfg['vortex_core_to_chord_ratio'] = float(vor['core_to_chord_ratio'])
    cfg['vortex_far_wake'] = vor['far_wake_element_type']
    cfg['vortex_strength_mode'] = vor['filament_strength_from_circulation']
    cfg['vortex_epsilon_m'] = float(vor['epsilon_m'])
    cfg['vortex_epsilon_r'] = float(vor['epsilon_r'])
    cfg['vortex_degree_lifting'] = int(vor['degree_of_induced_velocity_lifting'])
    cfg['vortex_representation'] = vor['representation']
    return cfg


def build_scaling_vectors(layout: VarLayout, scaling_by_name) -> Dict[str, np.ndarray]:
    """Expand the per-name scaling map into full per-type vectors; xdot
    inherits the scaling of its integral variable (dynamics.py:886-903)."""
    out = {}
    for t in ('x', 'u', 'z', 'theta'):
        out[t] = layout.expand_per_name(t, scaling_by_name.get(t, {}), fallback=1.0)
    # xdot: same layout as x
    out['xdot'] = out['x'].copy()
    return out


def _scaling_value(scaling_vec, layout, var_type, name):
    return scaling_vec[var_type][layout.slices[var_type][name]]


def build_variable_bounds(options, layout, scaling) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Scaled model-variable bounds (mdl/system.py:353-410)."""
    system_bounds = options['model']['system_bounds']
    bounds = {}
    for t in ('x', 'xdot', 'u', 'z', 'theta'):
        lb = np.full(layout.dims[t], -np.inf)
        ub = np.full(layout.dims[t], np.inf)
        sec = system_bounds.get(t, {})
        for name, dim in layout.entries[t]:
            stripped = strip_node_identifier(name)
            entry = None
            if name in sec:
                entry = sec[name]
            elif name in system_bounds.get('x', {}) and t != 'x':
                entry = system_bounds['x'][name]
            elif stripped in sec:
                entry = sec[stripped]
            if entry is not None:
                sl = layout.slices[t][name]
                lo = np.broadcast_to(np.reshape(np.asarray(entry[0], dtype=float), -1), (dim,))
                hi = np.broadcast_to(np.reshape(np.asarray(entry[1], dtype=float), -1), (dim,))
                scale = scaling[t][sl]
                lb[sl] = lo / scale
                ub[sl] = hi / scale
        bounds[t] = (lb, ub)
    return bounds


def make_model(options, arch: Architecture) -> Model:
    check_ported(options)
    layout, gc_names = generate_structure(options, arch)
    cfg = _build_cfg(options, arch)
    scaling = build_scaling_vectors(layout, options['processed']['scaling'])
    theta0_init = build_theta0(options)
    bounds = build_variable_bounds(options, layout, scaling)

    split, to_si, scale_full = lagr.make_splitters(layout, scaling)
    time_derivative = lagr.make_time_derivative(layout, scaling, arch, cfg['kite_dof'])

    n_nodes = arch.number_of_nodes
    kite_nodes = arch.kite_nodes
    kite_dof = cfg['kite_dof']
    lift_mode = cfg['system_type'] == 'lift_mode'
    integral_outputs = options['model']['integral_outputs']

    # --- index arrays for generalized coordinates -------------------------
    x_off = layout.type_offsets['x']
    gc_q_idx = np.concatenate([
        np.arange(layout.slices['x'][name].start, layout.slices['x'][name].stop) + x_off
        for name in gc_names])
    gc_dq_idx = np.concatenate([
        np.arange(layout.slices['x']['d' + name].start, layout.slices['x']['d' + name].stop) + x_off
        for name in gc_names])
    q_scale_gc = scale_full[gc_q_idx]
    dq_scale_gc = scale_full[gc_dq_idx]

    # --- static scaling bundles -------------------------------------------
    sc = options['processed']['scaling']

    def scaling_of(var_type, name, default=None):
        m = sc.get(var_type, {})
        if name in m:
            return np.asarray(m[name], dtype=float)
        stripped = strip_node_identifier(name)
        if stripped in m:
            return np.asarray(m[stripped], dtype=float)
        if default is not None:
            return np.asarray(default, dtype=float)
        return np.asarray(1.0)

    # per-segment scaling lengths/areas for row scalings
    seg_scaling = {}
    for node in range(1, n_nodes):
        main = arch.parent_map[node] == 0
        secondary = node in kite_nodes
        if main:
            s_len = scaling_of('x' if lift_mode else 'theta', 'l_t')
            s_diam = scaling_of('theta', 'diam_t')
        elif secondary:
            s_len = scaling_of('theta', 'l_s')
            s_diam = scaling_of('theta', 'diam_s')
        else:
            s_len = scaling_of('theta', 'l_i')
            s_diam = scaling_of('theta', 'diam_t')
        seg_scaling[node] = {
            'length': float(s_len),
            'area': float(np.pi * (s_diam / 2.) ** 2.),
        }
    q_scaling_mean = float(np.mean(scaling_of('x', 'q')))

    def node_mass_scaling(theta0, like):
        """Per-gc-row characteristic node mass."""
        rho = theta0['tether']['rho']
        m_k = theta0['geometry']['m_k']
        ones = torch.ones(3, dtype=like.dtype, device=like.device)
        rows = []
        for node in range(1, n_nodes):
            mass = seg_scaling[node]['area'] * rho * seg_scaling[node]['length'] / 2.
            for child in arch.children_map.get(node, []):
                mass = mass + seg_scaling[child]['area'] * rho * seg_scaling[child]['length'] / 2.
            if node in kite_nodes:
                mass = mass + m_k
            rows.append(mass * ones)
        return torch.cat(rows)

    holonomic_names = lagr.holonomic_names(cfg, arch)

    # --- equality-constraint slices ---------------------------------------
    eq_slices: Dict[str, slice] = {}
    cursor = 0

    def add_eq(name, dim):
        nonlocal cursor
        eq_slices[name] = slice(cursor, cursor + dim)
        cursor += dim

    add_eq('dynamics_translation', 3 * (n_nodes - 1))
    add_eq('dynamics_constraint', len(holonomic_names))
    if kite_dof == 6:
        for kite in kite_nodes:
            add_eq(f'rotation_dynamics{kite}', 3)
            add_eq(f'ref_frame_dynamics{kite}', 9)
    # trivial kinematics: an xdot variable whose own name is also an x or u
    # variable (e.g. xdot['dq10'] = x['dq10'])
    trivial_names = []
    for name in layout.names('xdot'):
        if layout.has('x', name):
            trivial_names.append((name, 'x'))
        elif layout.has('u', name):
            trivial_names.append((name, 'u'))
    for (name, t) in trivial_names:
        add_eq('trivial_' + name, layout.dim('xdot', name))
    # the actuator model's rows live in the per-node model (the averaged
    # model's one row integrates over the horizon, in the OCP)
    induction_in_model = cfg['induction_lifted'] \
        and cfg['induction_model'] == 'actuator'
    if induction_in_model:
        for name, dim in induction_mod.residual_names_and_dims(cfg, arch):
            add_eq(name, dim)
    if not integral_outputs:
        add_eq('integral_e', 1)

    # static references that normalize the actuator residual rows
    static_refs = {
        'thrust_ref': float(scaling_of('z', 'f_aero')),
        'moment_ref': float(scaling_of('z', 'm_aero',
                                       default=scaling_of('z', 'f_aero')
                                       * cfg['geometry_static']['b_ref'] / 2.)),
        'a_ref': cfg['act_a_ref'],
        'varrho_ref': cfg['act_varrho_ref'],
        'b_ref': cfg['geometry_static']['b_ref'],
    }

    def induction_scaling_refs(theta0):
        return dict(static_refs, u_ref=theta0['wind']['u_ref'])

    h_scaling_np = []
    for name in holonomic_names:
        node = int(name[1:-1]) if len(name) > 3 else int(name[1])
        h_scaling_np.append(seg_scaling[node]['length'] * q_scaling_mean)
    h_scaling_np = np.array(h_scaling_np)
    trivial_scales = {
        name: np.sqrt(_scaling_value(scaling, layout, t, name)
                      * _scaling_value(scaling, layout, 'xdot', name))
        for (name, t) in trivial_names}
    e_scale = float(scaling_of('x', 'e'))
    m_scale = float(scaling_of('z', 'm_aero'))
    gamma_i = PHI_NAMES.index('gamma')
    iota_i = PHI_NAMES.index('iota')

    def generator_force(si, theta0, kite):
        """Drag mode: the on-board turbine's force kappa |u| u and the
        apparent velocity u at ``kite``."""
        vec_u = kite_aero.get_u_eff_earth(cfg, si, theta0, arch, kite)
        airspeed = torch.sqrt(vec_u @ vec_u + 1e-16)
        kappa = si['x']['kappa' + arch.node_label(kite)][0]
        return kappa * airspeed * vec_u, vec_u

    # --- power ------------------------------------------------------------
    def power_fn(v, phi, theta0):
        si = to_si(v)
        if not lift_mode:
            total = 0.
            for kite in kite_nodes:
                f_gen, vec_u = generator_force(si, theta0, kite)
                total = total + theta0['aero']['turbine_efficiency'] * (vec_u @ f_gen)
            return total
        return si['z']['lambda10'][0] * si['x']['l_t'][0] * si['x']['dl_t'][0]

    def g_stack_fn(theta0):
        def g_stack(vv):
            g = lagr.tether_length_constraints(cfg, to_si(vv), theta0, arch)
            return torch.stack([g[name] for name in holonomic_names])
        return g_stack

    # --- equality residual -------------------------------------------------
    def eq_fn(v, phi, theta0):
        si = to_si(v)
        parts = split(v)
        gamma = phi[gamma_i]

        # Lagrangian as a function of v (closing over theta0)
        def lagrangian_scalar(vv):
            sii = to_si(vv)
            ek = sum(lagr.node_kinetic_energies(cfg, sii, theta0, arch).values())
            ep = sum(lagr.node_potential_energies(cfg, sii, theta0, arch).values())
            wh = lagr.work_holonomic(cfg, sii, theta0, arch)
            return ek - ep - wh

        grad_L = torch.func.grad(lagrangian_scalar)

        def dlagr_dqdot(vv):
            return take(grad_L(vv), gc_dq_idx)

        dlagr_dqdot_dt = time_derivative(dlagr_dqdot)(v)
        lhs_translation = dlagr_dqdot_dt / const(dq_scale_gc, v) \
            - take(grad_L(v), gc_q_idx) / const(q_scale_gc, v)

        # generalized forces
        drag = tether.tether_drag_forces(cfg, si, theta0, arch)
        f_kite, m_kite, _ = kite_aero.forces_and_outputs(cfg, si, theta0, arch)
        rhs_rows = []
        for node in range(1, n_nodes):
            label = arch.node_label(node)
            f = drag['f' + label]
            if node in kite_nodes:
                f = f + gamma * si['u']['f_fict' + label] + f_kite[node]
                if not lift_mode:
                    f = f + generator_force(si, theta0, node)[0]
            rhs_rows.append(f)
        rhs_translation = torch.cat(rhs_rows)

        # open-system momentum correction (lift mode): reeled-out tether
        # mass enters node 1
        if lift_mode:
            def seg1_mass(vv):
                sii = to_si(vv)
                return tether.segment_properties(cfg, sii, theta0, arch, 1)['seg_mass']
            mass_flow = time_derivative(seg1_mass)(v)
            rhs_translation = rhs_translation + torch.cat([
                mass_flow * si['x']['dq10'],
                torch.zeros(rhs_translation.shape[0] - 3, dtype=v.dtype, device=v.device)])

        force_scaling = node_mass_scaling(theta0, v) * cfg['g_scaling'] * 10.
        res_translation = (lhs_translation - rhs_translation) / force_scaling

        # holonomic constraints with Baumgarte stabilization
        g_stack = g_stack_fn(theta0)
        gdot_fn = time_derivative(g_stack)
        gddot = time_derivative(gdot_fn)(v)
        gdot = gdot_fn(v)
        g = g_stack(v)
        kappa_b = theta0['tether']['kappa']
        lhs_holonomic = gddot + 2. * kappa_b * gdot + kappa_b ** 2. * g
        res_holonomic = lhs_holonomic / (kappa_b ** 2. * const(h_scaling_np, v))

        res = [res_translation, res_holonomic]

        # rotational dynamics and DCM evolution of 6-DOF kites
        if kite_dof == 6:
            J = theta0['geometry']['j']
            kappa_r = theta0['kappa_r']
            eye = torch.eye(3, dtype=v.dtype, device=v.device)
            for kite in kite_nodes:
                label = arch.node_label(kite)
                moment = gamma * si['u']['m_fict' + label] + m_kite[kite]
                omega = si['x']['omega' + label]
                domega = si['xdot']['domega' + label]
                res.append((moment - (J @ domega + frames.cross(omega, J @ omega)))
                           / m_scale)
                R = si['x']['r' + label].reshape(3, 3)
                dR = si['xdot']['dr' + label].reshape(3, 3)
                ortho = kappa_r / 2. * (eye - R.T @ R)
                res.append((dR - R @ (ortho + lagr.skew(omega))).reshape(9))

        # trivial kinematics xdot_name = var
        for (name, t) in trivial_names:
            res.append((si['xdot'][name] - si[t][name])
                       / const(trivial_scales[name], v))

        # induction equalities with the iota blend
        if induction_in_model:
            res.append(induction_mod.residuals(
                cfg, si, theta0, arch, phi[iota_i], f_kite,
                induction_scaling_refs(theta0)))

        # energy quadrature as dynamics
        if not integral_outputs:
            de_scaled = parts['xdot'][layout.slices['xdot']['de']]
            res.append(de_scaled - power_fn(v, phi, theta0) / e_scale)

        return torch.cat([torch.atleast_1d(r) for r in res])

    # --- inequality residuals (<= 0) ---------------------------------------
    ineq_slices: Dict[str, slice] = {}
    icursor = 0

    def add_ineq(name, dim):
        nonlocal icursor
        ineq_slices[name] = slice(icursor, icursor + dim)
        icursor += dim

    includes = cfg['tether_constraint_includes']
    for node in range(1, n_nodes):
        label = arch.node_label(node)
        if node in includes['stress']:
            add_ineq('tether_stress' + label, 1)
        elif node in includes['force']:
            add_ineq('tether_force_max' + label, 1)
            add_ineq('tether_force_min' + label, 1)
    if cfg['airspeed_include']:
        for kite in kite_nodes:
            label = arch.node_label(kite)
            add_ineq('airspeed_max' + label, 1)
            add_ineq('airspeed_min' + label, 1)
    if cfg['aero_validity_include']:
        for kite in kite_nodes:
            for nm in ('alpha_ub', 'alpha_lb', 'beta_ub', 'beta_lb'):
                add_ineq(nm + str(kite), 1)
    anticollision_pairs = []
    if cfg['anticollision_include']:
        import itertools
        for pair in itertools.combinations(kite_nodes, 2):
            anticollision_pairs.append(pair)
            add_ineq(f'anticollision{pair[0]}{pair[1]}', 1)
    if cfg['acceleration_include']:
        for node in range(1, n_nodes):
            add_ineq('acceleration' + arch.node_label(node), 1)
    rotation_type = cfg['rotation_type'] \
        if cfg['rotation_include'] and kite_dof == 6 else None
    for kite in kite_nodes:
        if rotation_type == 'roll_pitch':
            add_ineq('rotation_max' + arch.node_label(kite), 2)
            add_ineq('rotation_min' + arch.node_label(kite), 2)
        elif rotation_type == 'yaw':
            add_ineq('rotation_max' + arch.node_label(kite), 1)
    yaw_scales = {kite: float(scaling_of('x', 'l_t')) if kite == 1
                  else float(scaling_of('theta', 'l_s')) for kite in kite_nodes}

    def tension_and_stress(si, theta0, node):
        label = arch.node_label(node)
        props = tether.segment_properties(cfg, si, theta0, arch, node)
        tension = si['z']['lambda' + label][0] * props['seg_length']
        return tension, props

    def ineq_fn(v, phi, theta0):
        si = to_si(v)
        res = []
        tightness = float(cfg['tether_stress_tightness'])
        for node in range(1, n_nodes):
            label = arch.node_label(node)
            in_stress = node in includes['stress']
            in_force = node in includes['force']
            if not (in_stress or in_force):
                continue
            tension, props = tension_and_stress(si, theta0, node)
            if in_stress:
                max_stress = theta0['tether']['max_stress'] / theta0['tether']['stress_safety_factor']
                char = abs(float(scaling_of('z', 'lambda' + label))
                           * seg_scaling[node]['length'])
                res.append((tension - props['cross_section_area'] * max_stress) / char * tightness)
            else:
                limits = theta0['model_bounds']['tether_force_limits']
                f_scale = float(scaling_of('z', 'lambda' + label)) * seg_scaling[node]['length']
                res.append((tension - limits[1]) / f_scale)
                res.append((limits[0] - tension) / f_scale)

        if cfg['airspeed_include'] or cfg['aero_validity_include']:
            _, _, aero_outputs = kite_aero.forces_and_outputs(cfg, si, theta0, arch)
        if cfg['airspeed_include']:
            limits = theta0['model_bounds']['airspeed_limits']
            airspeed_scaling = theta0['wind']['u_ref']
            for kite in kite_nodes:
                airspeed = aero_outputs['aerodynamics']['airspeed' + str(kite)]
                res.append((airspeed - limits[1]) / airspeed_scaling)
                res.append((limits[0] - airspeed) / airspeed_scaling)
        if cfg['aero_validity_include']:
            for kite in kite_nodes:
                for nm in ('alpha_ub', 'alpha_lb', 'beta_ub', 'beta_lb'):
                    res.append(aero_outputs['aero_validity'][nm + str(kite)])
        if cfg['anticollision_include']:
            dist_min = cfg['anticollision_safety_factor'] * theta0['geometry']['b_ref']
            for (a, b) in anticollision_pairs:
                dist = si['x']['q' + arch.node_label(a)] - si['x']['q' + arch.node_label(b)]
                res.append(1. - (dist @ dist) / dist_min ** 2)
        if cfg['acceleration_include']:
            acc_max = cfg['acc_max'] * cfg['g_scaling']
            for node in range(1, n_nodes):
                acc = si['xdot']['ddq' + arch.node_label(node)]
                res.append((acc @ acc) / acc_max ** 2. - 1.)
        if rotation_type is not None:
            rot_angles = theta0['model_bounds']['rot_angles']
            for kite in kite_nodes:
                label = arch.node_label(kite)
                q_hat = si['x']['q' + label]
                if arch.parent_map[kite] != 0:
                    q_hat = q_hat - si['x']['q' + arch.parent_label(kite)]
                R = si['x']['r' + label].reshape(3, 3)
                if rotation_type == 'roll_pitch':
                    roll_t = (q_hat @ R[:, 1]) / (q_hat @ R[:, 2])
                    pitch_s = (q_hat @ R[:, 0]) / torch.sqrt(q_hat @ q_hat + 1e-16)
                    angles = torch.stack([roll_t, pitch_s])
                    max_angles = torch.stack([torch.tan(rot_angles[0]),
                                              torch.sin(rot_angles[1])])
                    res.append(angles - max_angles)
                    res.append(-max_angles - angles)
                else:
                    norm_q = torch.sqrt(q_hat @ q_hat + 1e-16)
                    yaw_expr = (q_hat @ R[:, 2]) - torch.cos(rot_angles[2]) * norm_q
                    res.append(-yaw_expr / yaw_scales[kite])
        if not res:
            return v[:0]
        return torch.cat([torch.atleast_1d(r) for r in res])

    # --- outputs -----------------------------------------------------------
    def outputs_fn(v, phi, theta0):
        si = to_si(v)
        outputs = {}
        _, _, aero_outputs = kite_aero.forces_and_outputs(cfg, si, theta0, arch)
        outputs.update(aero_outputs)

        current_power = power_fn(v, phi, theta0)
        outputs['performance'] = {'p_current': current_power}
        perf = outputs['performance']
        q10 = si['x']['q10']
        elevation = torch.atan2(q10[2], torch.sqrt(q10[0] ** 2 + q10[1] ** 2 + 1e-16))
        perf['elevation'] = elevation
        s_ref = theta0['geometry']['s_ref']
        p_loyd_total = 0.
        available_at_kites = 0.
        cos_el3 = torch.cos(elevation) ** 3.
        for kite in kite_nodes:
            label = arch.node_label(kite)
            CL = aero_outputs['aerodynamics']['CL' + str(kite)]
            CD = aero_outputs['aerodynamics']['CD' + str(kite)]
            z_kite = si['x']['q' + label][2]
            rho = atmosphere.get_density(cfg['atmosphere_model'],
                                         theta0['atmosphere'], z_kite)
            windspeed = wind.get_speed(cfg['wind_model'], theta0['wind'], z_kite)
            power_density = 0.5 * rho * windspeed ** 3.
            eps = 1.e-6
            CR = CL * (1. + CD ** 2. / (CL ** 2. + eps ** 2.)) ** 0.5
            phf_loyd = 4. / 27. * CR * (CR / (CD + 1e-12)) ** 2. * cos_el3
            p_loyd = power_density * s_ref * phf_loyd
            perf['p_loyd' + str(kite)] = p_loyd
            perf['phf_loyd' + str(kite)] = phf_loyd
            p_loyd_total = p_loyd_total + p_loyd
            available_at_kites = available_at_kites + power_density * s_ref
        perf['p_loyd_total'] = p_loyd_total
        rho_hub = atmosphere.get_density(cfg['atmosphere_model'],
                                         theta0['atmosphere'], q10[2])
        u_hub = wind.get_speed(cfg['wind_model'], theta0['wind'], q10[2])
        hub_avail = 0.5 * rho_hub * u_hub ** 3. * s_ref * len(kite_nodes)
        perf['phf'] = current_power / torch.clamp(available_at_kites, min=1e-12)
        perf['phf_hubheight'] = current_power / torch.clamp(hub_avail, min=1e-12)
        perf['loyd_factor'] = current_power / torch.sqrt(p_loyd_total ** 2. + 1e-8)

        if cfg['induction_lifted']:
            f_earth, _, _ = kite_aero.forces_and_outputs(cfg, si, theta0, arch)
            outputs['actuator'] = induction_mod.collect_outputs(
                cfg, si, theta0, arch, f_earth)

        # invariants
        g_stack = g_stack_fn(theta0)
        gdot_fn = time_derivative(g_stack)
        g = g_stack(v)
        gdot = gdot_fn(v)
        gddot = time_derivative(gdot_fn)(v)
        outputs['invariants'] = {}
        for i, name in enumerate(holonomic_names):
            outputs['invariants'][name] = g[i]
            outputs['invariants']['d' + name] = gdot[i]
            outputs['invariants']['dd' + name] = gddot[i]
        if kite_dof == 6:
            eye = torch.eye(3, dtype=v.dtype, device=v.device)
            for kite in kite_nodes:
                label = arch.node_label(kite)
                R = si['x']['r' + label].reshape(3, 3)
                outputs['invariants']['orthonormality' + label] = \
                    (R.T @ R - eye).reshape(9)

        # local performance: tether forces/stresses
        outputs['local_performance'] = {}
        for node in range(1, n_nodes):
            label = arch.node_label(node)
            tension, props = tension_and_stress(si, theta0, node)
            outputs['local_performance']['tether_force' + label] = tension
            outputs['local_performance']['tether_stress' + label] = \
                tension / props['cross_section_area']

        # power balance
        pb = outputs.setdefault('power_balance', {})
        drag = tether.tether_drag_forces(cfg, si, theta0, arch)
        for node in range(1, n_nodes):
            label = arch.node_label(node)
            q_n = si['x']['q' + label]
            q_rel = q_n if arch.parent_map[node] == 0 \
                else q_n - si['x']['q' + arch.parent_label(node)]
            dq_n = si['x']['dq' + label]
            tension, _ = tension_and_stress(si, theta0, node)
            direction = q_rel / torch.sqrt(q_rel @ q_rel + 1e-16)
            pb['P_tether' + str(node)] = -(tension * direction) @ dq_n
            pb['P_tetherdrag' + str(node)] = drag['f' + label] @ dq_n

        def e_kin_total(vv):
            sii = to_si(vv)
            return sum(lagr.node_kinetic_energies(cfg, sii, theta0, arch).values())

        def e_pot_total(vv):
            sii = to_si(vv)
            return sum(lagr.node_potential_energies(cfg, sii, theta0, arch).values())

        pb['P_kinetic'] = -time_derivative(e_kin_total)(v)
        pb['P_potential'] = -time_derivative(e_pot_total)(v)
        return outputs

    def avg_induction_integrands(v, phi, theta0):
        """Integrands of the trajectory-averaged induction model: summed kite
        tether forces and WdA = sum_kites 0.5 b_ref |dq| rho(z) u_inf(z)^2."""
        si = to_si(v)
        b_ref = theta0['geometry']['b_ref']
        F_sum = 0.
        WdA = 0.
        for kite in kite_nodes:
            label = arch.node_label(kite)
            tension, _ = tension_and_stress(si, theta0, kite)
            F_sum = F_sum + tension
            q = si['x']['q' + label]
            dq = si['x']['dq' + label]
            rho = atmosphere.get_density(cfg['atmosphere_model'],
                                         theta0['atmosphere'], q[2])
            u_inf = wind.get_speed(cfg['wind_model'], theta0['wind'], q[2])
            WdA = WdA + 0.5 * b_ref * torch.sqrt(dq @ dq + 1e-16) * rho * u_inf ** 2
        return F_sum, WdA

    return Model(
        layout=layout, gc_names=gc_names, arch=arch, cfg=cfg, scaling=scaling,
        theta0_init=theta0_init, eq_fn=eq_fn, ineq_fn=ineq_fn,
        outputs_fn=outputs_fn, power_fn=power_fn,
        eq_slices=eq_slices, ineq_slices=ineq_slices,
        variable_bounds_scaled=bounds,
        split=split, to_si=to_si, scale_full=scale_full,
        avg_induction_fn=avg_induction_integrands)
