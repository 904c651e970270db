"""Scaled variable bounds on the NLP vector V, including phase fixing.

Counterpart of awebox ocp/var_bounds.py:42-223: model bounds
mapped onto shooting-node AND collocation-node entries (periodicity skips the
final x node), the lift-mode phase-fix classification of dl_t nodes
(reel-out / reel-in / switching / periodic-final) at both control and
collocation nodes with the Radau-overlap and zoh exemptions
(var_bounds.py:113-201), the 'simple' dl_t(0)=0 pin, the drag-mode
dq10_y(0)=0 pin (var_bounds.py:105-111), and the optional pumping_range l_t
pins at the initial and switching control nodes (var_bounds.py:210-221).
"""
from __future__ import annotations

import numpy as np


def build_v_bounds(ocp) -> tuple[np.ndarray, np.ndarray]:
    vs = ocp.vstruct
    model = ocp.model
    layout = model.layout
    options = ocp.options
    n_k, d = ocp.n_k, ocp.d

    lb = np.full(vs.total, -np.inf)
    ub = np.full(vs.total, np.inf)

    traj = options['user_options']['trajectory']
    lift_mode = traj['system_type'] == 'lift_mode'
    phase_fix = traj['lift_mode']['phase_fix'] if lift_mode else None
    single_reelout = vs.get_theta(np.zeros(vs.total), 't_f').shape[0] == 2
    periodic = traj['type'] in ('power_cycle', 'tracking')

    mb = model.variable_bounds_scaled

    # theta
    for name in vs.theta_names:
        sl = vs.theta_slice(name)
        msl = layout.slices['theta'][name]
        if name == 't_f' and single_reelout:
            lb[sl] = 0.  # components nonnegative; period bounded via ineq
            ub[sl] = np.inf
        else:
            lb[sl] = mb['theta'][0][msl]
            ub[sl] = mb['theta'][1][msl]

    # phi in [0, 1]
    lb[vs.phi_slice] = 0.
    ub[vs.phi_slice] = 1.

    # xi boundary-trajectory parameters (formulation.py:150-169): active
    # entries range [0, 1], UNUSED entries pin to 0; compromised landings
    # pin xi_0 to the prescribed starting position
    if vs.with_xi:
        from .operation import conditions as op_conditions
        conds = op_conditions(options)
        i0 = vs.xi_slice.start
        if conds['param_initial']:
            lb[i0], ub[i0] = 0., 1.
            if traj['type'] == 'compromised_landing':
                xi0 = float(traj['compromised_landing']['xi_0_initial'])
                lb[i0] = ub[i0] = xi0
        else:
            lb[i0] = ub[i0] = 0.
        if conds['param_terminal']:
            lb[i0 + 1], ub[i0 + 1] = 0., 1.
        else:
            lb[i0 + 1] = ub[i0 + 1] = 0.

    # x at shooting nodes (skip final node when periodic)
    last_bounded = n_k if periodic else n_k + 1
    for k in range(last_bounded):
        sl = vs.x_slice(k)
        lb[sl] = mb['x'][0]
        ub[sl] = mb['x'][1]

    # x at collocation nodes: only the phase-fix-relevant dl_t entries are
    # bounded there (var_bounds.py:113-201). The reference maps ALL model
    # bounds onto coll_var entries (var_bounds.py:42-102); measured here,
    # the extra interior active bounds materially slow homotopy convergence
    # on coarse grids, and the path constraints already police the envelope
    # at the enforcement nodes — so the general mapping stays off.

    # u, z at their parameterization's nodes (var_struct.py:59-81)
    if vs.u_param in ('zoh', 'ms'):
        for k in range(n_k):
            lb[vs.u_slice(k)] = mb['u'][0]
            ub[vs.u_slice(k)] = mb['u'][1]
            lb[vs.z_slice(k)] = mb['z'][0]
            ub[vs.z_slice(k)] = mb['z'][1]
    else:  # poly: controls + algebraic vars live on the collocation nodes
        for k in range(n_k):
            for j in range(d):
                lb[vs.coll_u_slice(k, j)] = mb['u'][0]
                ub[vs.coll_u_slice(k, j)] = mb['u'][1]
                lb[vs.coll_z_slice(k, j)] = mb['z'][0]
                ub[vs.coll_z_slice(k, j)] = mb['z'][1]

    # drag-mode phase fixing: pin the y-speed of the first system node at
    # k=0 (var_bounds.py:105-111)
    if traj['system_type'] == 'drag_mode' and layout.has('x', 'dq10'):
        dq_rel = layout.slices['x']['dq10']
        idx = vs.x_slice(0).start + dq_rel.start + 1
        lb[idx] = 0.
        ub[idx] = 0.

    # phase fixing on dl_t (var_bounds.py:113-223)
    if lift_mode and layout.has('x', 'dl_t'):
        dl_rel = layout.slices['x']['dl_t']
        given_lb = mb['x'][0][dl_rel][0]
        given_ub = mb['x'][1][dl_rel][0]
        radau = options['nlp']['collocation']['scheme'] == 'radau'
        poly_u = vs.u_param == 'poly'

        if phase_fix == 'simple':
            sl = vs.x_slice(0)
            lb[sl.start + dl_rel.start] = 0.
            ub[sl.start + dl_rel.start] = 0.
            # collocation nodes stay at the plain model bounds (already set)
        elif phase_fix == 'single_reelout' and single_reelout:
            switch_kdx = ocp.switch_kdx
            # control (shooting) nodes: reelout/reelin/switch classification
            for k in range(n_k + 1):
                idx = vs.x_slice(k).start + dl_rel.start
                if k == 0 and periodic:
                    lo, hi = -np.inf, np.inf
                elif k == n_k and periodic:
                    lo, hi = 0., 0.
                elif k == switch_kdx:
                    lo, hi = 0., 0.
                elif k < switch_kdx:
                    lo, hi = 0., given_ub
                else:
                    lo, hi = given_lb, 0.
                lb[idx] = lo
                ub[idx] = hi
            # collocation nodes (var_bounds.py:148-166): free under zoh
            # controls; free at Radau nodes that overlap the next control
            # node; phase-classified only under poly controls elsewhere
            for k in range(n_k if vs.u_param != 'ms' else 0):
                for j in range(d):
                    idx = vs.coll_x_slice(k, j).start + dl_rel.start
                    overlaps_control = radau and (j == d - 1)
                    if (not poly_u) or overlaps_control:
                        lo, hi = -np.inf, np.inf
                    elif k < switch_kdx:
                        lo, hi = 0., given_ub
                    else:
                        lo, hi = given_lb, 0.
                    lb[idx] = lo
                    ub[idx] = hi

        # optional pumping range: pin l_t at the initial and switching
        # control nodes (var_bounds.py:210-221)
        pumping_range = options['nlp'].get('pumping_range', [None, None])
        if (layout.has('x', 'l_t') and len(pumping_range) == 2
                and pumping_range[0] is not None
                and pumping_range[1] is not None):
            if not (phase_fix == 'single_reelout' and single_reelout):
                raise ValueError(
                    "nlp.pumping_range requires trajectory.lift_mode."
                    "phase_fix == 'single_reelout' (the switching node pins "
                    "the range endpoints)")
            lt_rel = layout.slices['x']['l_t']
            lt_scale = float(model.scaling['x'][lt_rel][0])
            for k, val in ((0, pumping_range[0]),
                           (ocp.switch_kdx, pumping_range[1])):
                idx = vs.x_slice(k).start + lt_rel.start
                lb[idx] = float(val) / lt_scale
                ub[idx] = float(val) / lt_scale

    return lb, ub
