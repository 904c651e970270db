"""System variable-set declaration per architecture and options.

Reproduces the variable bookkeeping of awebox mdl/system.py:
42-230 as a static :class:`VarLayout`: tether nodes carry (q, dq, lambda),
kite nodes additionally carry 3-DOF (coeff, dcoeff) or 6-DOF (omega, r,
delta/ddelta, m_fict) variables, plus global tether states (l_t, dl_t,
[ddl_t]), energy state e, and design parameters theta.
"""
from __future__ import annotations

from typing import List, Tuple

from .vars import VarLayout


def generate_structure(options, architecture) -> Tuple[VarLayout, List[str]]:
    """Returns (layout, gc_names) where gc_names are the generalized
    coordinates (position states) entering the Lagrangian."""
    user_options = options['user_options']
    kite_dof = int(user_options['system_model']['kite_dof'])
    surface_control = int(user_options['system_model']['surface_control'])
    tether_control_var = options['model']['tether']['control_var']
    system_type = user_options['trajectory']['system_type']
    lift_aero_force = options['model']['aero']['lift_aero_force']
    lift_tether_force = options['model']['tether']['lift_tether_force']

    kite_nodes = architecture.kite_nodes
    x: List[Tuple[str, int]] = []
    u: List[Tuple[str, int]] = []
    z: List[Tuple[str, int]] = []
    theta: List[Tuple[str, int]] = []
    gc: List[str] = []

    for node in range(1, architecture.number_of_nodes):
        label = architecture.node_label(node)
        x += [('q' + label, 3), ('dq' + label, 3)]
        gc += ['q' + label]
        z += [('lambda' + label, 1)]
        if node in kite_nodes:
            u += [('f_fict' + label, 3)]
            if kite_dof == 3:
                x += [('coeff' + label, 2)]
                u += [('dcoeff' + label, 2)]
            elif kite_dof == 6:
                x += [('omega' + label, 3), ('r' + label, 9)]
                u += [('m_fict' + label, 3)]
                if surface_control == 0:
                    u += [('delta' + label, 3)]
                else:
                    x += [('delta' + label, 3)]
                    u += [('ddelta' + label, 3)]
            else:
                raise ValueError(f'kite dof option {kite_dof} not supported')
            if system_type == 'drag_mode':
                x += [('kappa' + label, 1)]
                u += [('dkappa' + label, 1)]

    # cross-tether multipliers
    if user_options['system_model']['cross_tether'] and len(kite_nodes) > 1:
        for l in architecture.layer_nodes:
            kite_children = architecture.kites_map[l]
            n_tethers = 1 if len(kite_children) == 2 else len(kite_children)
            for k in range(n_tethers):
                pair = f'{kite_children[k]}{kite_children[(k + 1) % len(kite_children)]}'
                z += [('lambda' + pair, 1)]

    # global tether states/controls
    if system_type == 'lift_mode':
        x += [('l_t', 1), ('dl_t', 1)]
        if tether_control_var == 'ddl_t':
            u += [('ddl_t', 1)]
        elif tether_control_var == 'dddl_t':
            x += [('ddl_t', 1)]
            u += [('dddl_t', 1)]
        else:
            raise ValueError('invalid tether control variable chosen')

    # energy as state (the reference's integral_outputs=False path)
    if not options['model']['integral_outputs']:
        x += [('e', 1)]

    # lifted aerodynamics variables
    if lift_tether_force:
        for node in range(1, architecture.number_of_nodes):
            z += [('f_tether' + architecture.node_label(node), 3)]
    if lift_aero_force:
        for kite in kite_nodes:
            label = architecture.node_label(kite)
            z += [('f_aero' + label, 3)]
            if kite_dof == 6:
                z += [('m_aero' + label, 3)]

    # lifted induction variables (system.py:233-350). TPU-native design lifts
    # only the genuinely implicit unknowns: per-kite induced velocity ui and
    # the actuator induction factors (algebraic for quasi-steady, dynamic
    # Pitt-Peters states for unsteady); the ~21 per-layer support variables
    # of the reference are closed-form here (aero/actuator.py).
    induction_model = user_options['induction_model']
    if induction_model not in ('not_in_use', 'averaged'):
        vortex_lift_deg = int(options['model']['aero']['vortex']
                              ['degree_of_induced_velocity_lifting'])
        for kite in kite_nodes:
            z += [('ui' + architecture.node_label(kite), 3)]
            if induction_model == 'vortex' and vortex_lift_deg >= 2:
                # degree-2 lifting: near- and far-wake induced velocities
                # carried as separate algebraic unknowns with their own
                # fixing rows (reference opts/default.py:139; substructure
                # granularity replaces per-element lifting — elements are
                # gathers here, not variables)
                label = architecture.node_label(kite)
                z += [('uin' + label, 3), ('uif' + label, 3)]
        if (induction_model == 'vortex'
                and options['model']['aero']['vortex']['representation']
                == 'state'):
            # diff/state representation (reference diff_repr_dir/
            # structure.py:1-281): wake-node positions and ring strengths
            # become lifted algebraic unknowns at every time node, pinned by
            # OCP fixing rows to their convected values (wake.py state
            # branch). The alg default keeps them closed-form gathers.
            wake_nodes = int(options['model']['aero']['vortex']['wake_nodes'])
            for kite in kite_nodes:
                label = architecture.node_label(kite)
                for r in range(wake_nodes):
                    z += [(f'wxm{label}_{r}', 3), (f'wxp{label}_{r}', 3),
                          (f'wg{label}_{r}', 1)]
        for layer in architecture.layer_nodes:
            for lbl in options['processed']['act_comparison_labels']:
                target = x if lbl[0] == 'u' else z
                target += [('a_' + lbl + str(layer), 1)]
                if 'asym' in lbl:
                    target += [('acos_' + lbl + str(layer), 1),
                               ('asin_' + lbl + str(layer), 1)]

    # design parameters theta (system.py:195-221)
    theta += [('diam_t', 1)]
    if induction_model == 'averaged':
        # trajectory-averaged induction factor, enforced by an OCP-level
        # integral constraint (induction_dir/averaged.py:39-58 +
        # ocp/constraints.py:108-124)
        theta += [('a', 1)]
    if system_type == 'drag_mode':
        theta += [('l_t', 1)]
    if (architecture.number_of_nodes - architecture.number_of_kites) > 1:
        theta += [('l_s', 1), ('diam_s', 1)]
    if len(architecture.layer_nodes) > 1:
        theta += [('l_i', 1), ('diam_i', 1)]
    if user_options['system_model']['cross_tether'] and len(kite_nodes) > 1:
        for l in architecture.layer_nodes:
            theta += [(f'l_c{l}', 1), (f'diam_c{l}', 1)]
    theta += [('t_f', 1)]

    xdot = [('d' + name, dim) for (name, dim) in x]

    layout = VarLayout({'x': x, 'xdot': xdot, 'u': u, 'z': z, 'theta': theta})
    return layout, gc


PHI_NAMES = ('gamma', 'tau', 'iota', 'psi', 'eta', 'nu', 'upsilon')
