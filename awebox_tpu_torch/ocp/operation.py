"""Trajectory-type boundary conditions.

Counterpart of the part of ``awebox_tpu/ocp/operation.py`` that periodic
problems need: which boundary-condition families attach to the OCP. The
xi-parameterized boundary trajectories of transitions and landings are not
ported.
"""
from __future__ import annotations


def conditions(options) -> dict:
    """Which boundary-condition families apply."""
    traj_type = options['user_options']['trajectory']['type']
    return {
        'periodic': traj_type in ('power_cycle', 'tracking'),
        'param_initial': traj_type in ('transition', 'nominal_landing',
                                       'compromised_landing'),
        'param_terminal': traj_type in ('transition', 'launch'),
        'initial': traj_type in ('launch', 'mpc'),
        'terminal_inequalities': traj_type in ('nominal_landing',
                                               'compromised_landing'),
    }
