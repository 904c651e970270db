"""Declarative homotopy schedule and its solve loop.

Counterpart of ``awebox_tpu/opti/homotopy.py``: the schedule is pure data,
an ordered list of steps, each with cost-weight updates (indexed into the
per-name update ladders of solver.cost) and bound updates (pin/release
homotopy parameters, fictitious controls, phase-fix bounds), with its replay
to the bounds and cost weights in effect at the 'final' step, and the
numeric NLP parameter tree P (numpy leaves; ``parallel.batch.p_from_numpy``
turns it into tensors). ``solve_homotopy`` walks the schedule: one
interior-point solver (``opti/ipsolver.py``) serves every step, only P and
the bounds change, and iterates warm-start from the previous step (the hippo
strategy: relaxed mu_target on intermediate steps).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..model.system import PHI_NAMES
from ..utils.logging import awelogger
from .ipsolver import InteriorPointSolver, IPOptions

COST_NAMES = ['tracking', 'u_regularisation', 'xdot_regularisation',
              'theta_regularisation', 'fictitious', 'power', 't_f', 'beta',
              'nominal_landing', 'transition', 'compromised_battery'] \
    + list(PHI_NAMES)


def initial_cost_values(options) -> Dict[str, float]:
    table = options['solver']['cost']
    return {name: float(table.get(name, [0.])[0]) for name in COST_NAMES}


def define_schedule(ocp):
    """Returns the homotopy schedule for the problem at hand
    (scheduling.py:53-159)."""
    options = ocp.options
    traj_type = options['user_options']['trajectory']['type']
    induction = options['user_options']['induction_model']
    make_induction_step = induction not in ('not_in_use', 'averaged')

    steps = ['initial', 'fictitious']
    if make_induction_step:
        steps.append('induction')
    if traj_type == 'power_cycle':
        steps.append('power')
    elif traj_type in ('nominal_landing', 'compromised_landing'):
        # landing branch of scheduling.py:89-97
        steps.append('nominal_landing')
        if traj_type == 'compromised_landing':
            steps.append('compromised_landing')
    elif traj_type == 'transition':
        steps.append('transition')
    steps.append('final')

    model = ocp.model
    fict_names = [n for n in model.layout.names('u') if 'fict' in n]
    tether_control = options['model']['tether']['control_var']

    costs_to_update = {
        'initial': {0: list(COST_NAMES)},
        'fictitious': {0: ['gamma', 'fictitious'], 1: ['gamma']},
        'induction': {0: ['iota'], 1: ['iota']},
        'power': {0: ['power', 'psi', 'fictitious'], 1: ['tracking', 'psi']},
        'nominal_landing': {0: ['nominal_landing', 'eta'], 1: []},
        'transition': {0: ['transition', 'upsilon'], 1: []},
        'compromised_landing': {0: ['compromised_battery', 'nu'], 1: []},
        'final': {0: []},
    }
    bounds_to_update = {
        'initial': {0: [('release_theta', None), ('release_control', tether_control)]},
        'fictitious': {0: [('phi_lb_zero', 'gamma')],
                       1: [('phi_ub_zero', 'gamma'),
                           ('release_fict', fict_names)]},
        'induction': {0: [('phi_lb_zero', 'iota')], 1: [('phi_ub_zero', 'iota')]},
        'power': {0: [('phi_lb_zero', 'psi')] +
                     ([('restore_phase_fix', None)] if ocp.switch_kdx < ocp.n_k else []),
                  1: [('phi_ub_zero', 'psi')]},
        # scheduling.py:207-232: release the tether control + theta, then
        # walk eta/upsilon/nu down
        'nominal_landing': {0: [('release_control', tether_control),
                                ('release_theta', None),
                                ('phi_lb_zero', 'eta')],
                            1: [('phi_ub_zero', 'eta')]},
        'transition': {0: [('release_control', tether_control),
                           ('release_theta', None),
                           ('phi_lb_zero', 'upsilon')],
                       1: [('phi_ub_zero', 'upsilon')]},
        'compromised_landing': {0: [('phi_lb_zero', 'nu')],
                                1: [('phi_ub_zero', 'nu')]},
        'final': {0: []},
    }
    labels = {
        'initial': {0: 'Initial solution...'},
        'fictitious': {0: 'Minimize fictitious forces...',
                       1: 'Eliminate fictitious forces...'},
        'induction': {0: 'Introduce induction constraints...',
                      1: 'Enforce induction constraints...'},
        'power': {0: 'Switch to power problem...', 1: 'Maximize average power...'},
        'nominal_landing': {0: 'Introduce landing objective...',
                            1: 'Enforce landing objective...'},
        'transition': {0: 'Introduce transition objective...',
                       1: 'Enforce transition objective...'},
        'compromised_landing': {0: 'Introduce emergency scenario...',
                                1: 'Enforce emergency scenario...'},
        'final': {0: 'Final solution.'},
    }
    used_phis = {'gamma', 'psi'} | ({'iota'} if make_induction_step else set())
    if traj_type != 'power_cycle':
        # the tracking blend multiplies upsilon*nu*eta*psi: every factor not
        # actively walked by the schedule must stay PINNED AT 1 (not zeroed
        # as 'unused'), so all three join used_phis for these types
        used_phis |= {'eta', 'nu', 'upsilon'}
    schedule = {'steps': steps, 'costs_to_update': costs_to_update,
                'bounds_to_update': bounds_to_update, 'labels': labels,
                'used_phis': used_phis}

    # 'single' compressed method: all intermediate steps fold into one
    # 'middle' step with merged cost/bound updates (scheduling.py:37-51 +
    # compress_homotopy_schedule, scheduling.py:522-540)
    if options['solver']['homotopy_method']['type'] == 'single':
        middle = [s for s in steps if s not in ('initial', 'final')]
        merged_costs = {0: [], 1: []}
        merged_bounds = {0: [], 1: []}
        for s in middle:
            for counter in (0, 1):
                merged_costs[counter] += costs_to_update[s].get(counter, [])
                merged_bounds[counter] += bounds_to_update[s].get(counter, [])
        schedule['steps'] = ['initial', 'middle', 'final']
        schedule['costs_to_update']['middle'] = merged_costs
        schedule['bounds_to_update']['middle'] = merged_bounds
        schedule['labels']['middle'] = {0: 'Compressed homotopy (relax)...',
                                        1: 'Compressed homotopy (enforce)...'}
    return schedule


def build_p_fix(ocp, V_ref: np.ndarray) -> dict:
    """Numeric NLP parameters: cost weights, reference, per-variable
    regularization weights, model parameters (preparation.py:83-147)."""
    options = ocp.options
    model = ocp.model
    layout = model.layout

    weight_table = options['solver']['weights']
    weights = np.ones(layout.total_dim)
    from ..model.vars import strip_node_identifier
    for t in ('x', 'xdot', 'u', 'z', 'theta'):
        off = layout.type_offsets[t]
        for name, dim in layout.entries[t]:
            lookup = strip_node_identifier(name)
            if lookup.startswith('w') and t in ('x', 'z'):
                lookup = 'vortex'
            val = weight_table.get(lookup, 1.0)
            sl = layout.slices[t][name]
            weights[off + sl.start:off + sl.stop] = val

    cost = initial_cost_values(options)
    return {
        'cost': {k: np.asarray(float(v)) for k, v in cost.items()},
        'ref': np.asarray(V_ref),
        'weights': np.asarray(weights),
        'theta0': model.theta0_init,
    }


def _u_entry_slices(ocp, rel):
    """V-slices of one control entry across all nodes where controls live
    (shooting nodes under zoh, collocation nodes under poly)."""
    vs = ocp.vstruct
    if vs.u_param in ('zoh', 'ms'):
        for k in range(ocp.n_k):
            s = vs.u_slice(k)
            yield slice(s.start + rel.start, s.start + rel.stop)
    else:
        for k in range(ocp.n_k):
            for j in range(ocp.d):
                s = vs.coll_u_slice(k, j)
                yield slice(s.start + rel.start, s.start + rel.stop)


def set_initial_bounds(ocp, lb, ub, V_init, schedule):
    """Pre-homotopy bound pinning (preparation.py:150-230)."""
    vs = ocp.vstruct
    layout = ocp.model.layout
    lb = lb.copy()
    ub = ub.copy()

    # pin all phi to 1; zero the unused ones
    phi_sl = vs.phi_slice
    lb[phi_sl] = 1.
    ub[phi_sl] = 1.
    for i, name in enumerate(PHI_NAMES):
        if name not in schedule['used_phis']:
            lb[phi_sl.start + i] = 0.
            ub[phi_sl.start + i] = 0.

    # pin theta to initial values (released again at the 'initial' step)
    for name in vs.theta_names:
        sl = vs.theta_slice(name)
        lb[sl] = V_init[sl]
        ub[sl] = V_init[sl]

    # free fictitious controls
    for name in layout.names('u'):
        if 'fict' in name:
            rel = layout.slices['u'][name]
            for s in _u_entry_slices(ocp, rel):
                lb[s] = -np.inf
                ub[s] = np.inf

    # phase fix: free dl_t and l_t until the power step
    if ocp.switch_kdx < ocp.n_k:
        for base in ('dl_t', 'l_t'):
            rel = layout.slices['x'][base]
            for k in range(ocp.n_k + 1):
                s = vs.x_slice(k)
                lb[s.start + rel.start] = -np.inf
                ub[s.start + rel.start] = np.inf
    return lb, ub


def apply_bound_update(ocp, lb, ub, lb_nominal, ub_nominal, update):
    """One bound update action; nominal = the full NLP bounds from
    ocp/bounds.py (the 'final' values in scheduling.py:326-398)."""
    vs = ocp.vstruct
    layout = ocp.model.layout
    kind, arg = update
    phi_sl = vs.phi_slice

    if kind == 'phi_lb_zero':
        lb[phi_sl.start + PHI_NAMES.index(arg)] = 0.
    elif kind == 'phi_ub_zero':
        ub[phi_sl.start + PHI_NAMES.index(arg)] = 0.
    elif kind == 'release_theta':
        for name in vs.theta_names:
            sl = vs.theta_slice(name)
            lb[sl] = lb_nominal[sl]
            ub[sl] = ub_nominal[sl]
    elif kind == 'release_control':
        name = arg
        if layout.has('u', name):
            rel = layout.slices['u'][name]
            for s in _u_entry_slices(ocp, rel):
                lb[s] = lb_nominal[s]
                ub[s] = ub_nominal[s]
    elif kind == 'release_fict':
        for name in arg:
            rel = layout.slices['u'][name]
            for s in _u_entry_slices(ocp, rel):
                lb[s] = lb_nominal[s]
                ub[s] = ub_nominal[s]
    elif kind == 'restore_phase_fix':
        for base in ('dl_t', 'l_t'):
            rel = layout.slices['x'][base]
            for k in range(ocp.n_k + 1):
                s = vs.x_slice(k)
                i = s.start + rel.start
                lb[i] = lb_nominal[i]
                ub[i] = ub_nominal[i]
    else:
        raise ValueError(f'unknown bound update {kind}')
    return lb, ub


def final_bounds(ocp, lb_nominal, ub_nominal, V_init, schedule=None):
    """The bound vectors in effect at the 'final' homotopy step: replay every
    bound update of the schedule without solving (used to continue/refine a
    solved problem, e.g. the batched sweep path)."""
    if schedule is None:
        schedule = define_schedule(ocp)
    lb, ub = set_initial_bounds(ocp, lb_nominal, ub_nominal, V_init, schedule)
    for step_name in schedule['steps']:
        for counter in sorted(schedule['bounds_to_update'][step_name]):
            for update in schedule['bounds_to_update'][step_name][counter]:
                lb, ub = apply_bound_update(ocp, lb, ub, lb_nominal,
                                            ub_nominal, update)
    return lb, ub


def final_cost_values(ocp, schedule=None):
    """Cost weights in effect at the 'final' step (same replay idea)."""
    options = ocp.options
    if schedule is None:
        schedule = define_schedule(ocp)
    cost_table = options['solver']['cost']
    counter_state = {name: -1 for name in COST_NAMES}
    for step_name in schedule['steps']:
        for counter in sorted(schedule['costs_to_update'][step_name]):
            for cost_name in schedule['costs_to_update'][step_name][counter]:
                counter_state[cost_name] += 1
    out = {}
    for name in COST_NAMES:
        ladder = cost_table.get(name, [0.])
        idx = min(max(counter_state[name], 0), len(ladder) - 1)
        out[name] = float(ladder[idx])
    return out


@dataclass
class HomotopySolution:
    V_opt: np.ndarray
    P: dict
    stats: dict
    success: bool
    step_results: dict
    final_state: dict = None


def linear_solver_choice(ocp, choice='auto') -> str:
    """The KKT path of the host solver, as the JAX package chooses it
    (homotopy.py:334-365): 'auto' takes 'block' for a 3-DOF problem of at
    least 1200 variables without horizon-coupling rows, else 'dense'; an
    explicit 'block' on a problem with such rows raises."""
    induction = ocp.model.cfg.get('induction_model')
    # vortex couples intervals through the wake history; 'averaged' adds one
    # dense integral row over the whole horizon: both break the
    # block-tridiagonal structure
    dense_only = induction in ('vortex', 'averaged') \
        or ocp.options['model']['integral_outputs'] \
        or ocp.vstruct.u_param in ('poly', 'ms') \
        or getattr(ocp.vstruct, 'with_xi', False) \
        or ocp.options['user_options']['trajectory']['type'] == 'mpc'
    if choice == 'auto':
        # the block path's chol-only inertia test is proven on the 3-DOF
        # families; auto prefers it only there, and only where it pays
        block_ok = (ocp.vstruct.total >= 1200
                    and ocp.model.cfg.get('kite_dof', 3) == 3)
        choice = 'dense' if (dense_only or not block_ok) else 'block'
    if dense_only and choice == 'block':
        raise ValueError(f"linear_solver='block' is incompatible with "
                         f"induction_model='{induction}' (constraints couple "
                         "intervals); use 'dense'")
    return choice


def solve_homotopy(ocp, V_init, V_ref, lb_nominal, ub_nominal,
                   final_homotopy_step='final', solver_cache=None,
                   verbose=True, skip_through=None, device=None) -> HomotopySolution:
    """Walk the homotopy schedule (homotopy.py:312-474) on ``device`` (the
    card unless the caller passes 'cpu').

    skip_through = name of the last homotopy step the warmstart source
    already completed: the schedule's cost/bound updates up to and including
    that step are applied but not solved, and solving resumes at the next
    step. If the source completed the whole schedule, the final step is
    re-solved once as a refinement."""
    sol_opts = ocp.options['solver']
    schedule = define_schedule(ocp)
    P = build_p_fix(ocp, V_ref)
    cost_table = sol_opts['cost']

    lb, ub = set_initial_bounds(ocp, lb_nominal, ub_nominal, V_init, schedule)
    choice = linear_solver_choice(ocp, sol_opts.get('linear_solver', 'auto'))

    if solver_cache is not None and 'solver' in solver_cache:
        solver = solver_cache['solver']
    else:
        block_kkt = None
        if choice == 'block':
            from ..ocp.blockkkt import make_block_kkt
            bd, bs, _maps = make_block_kkt(ocp)
            block_kkt = (bd, bs)
        solver = InteriorPointSolver(
            ocp.f_fn, ocp.eq_fn, ocp.ineq_fn,
            n=ocp.vstruct.total, n_eq=ocp.n_eq, n_ineq=ocp.n_ineq,
            options=IPOptions(), block_kkt=block_kkt, device=device)
        if solver_cache is not None:
            solver_cache['solver'] = solver

    hippo = sol_opts['hippo_strategy']
    mu_hippo = sol_opts['mu_hippo']
    tol_hippo = sol_opts['tol_hippo']
    tol_final = sol_opts['tol']
    mu_target_final = sol_opts['mu_target']

    cost_update_counter = {name: -1 for name in COST_NAMES}
    w = np.asarray(V_init)
    state = None
    stats = {'iterations': {}, 't_wall': {}}
    step_results = {}
    success = True

    # per-iteration recording (option solver.callback); iterates land in
    # stats['iterates'][step_key]
    record_iterates = bool(sol_opts.get('callback', False))
    callback_step = int(sol_opts.get('callback_step', 1))
    if record_iterates:
        stats['iterates'] = {}

    steps = schedule['steps']
    if final_homotopy_step in steps:
        steps = steps[:steps.index(final_homotopy_step) + 1]
    solve_from = 0
    if skip_through in steps:
        solve_from = steps.index(skip_through) + 1
        if solve_from >= len(steps):
            solve_from = len(steps) - 1   # fully solved source: refine final

    for si, step_name in enumerate(steps):
        if not success:
            break
        n_counters = len(schedule['bounds_to_update'][step_name])
        for counter in range(max(n_counters, 1)):
            # cost updates
            for cost_name in schedule['costs_to_update'][step_name].get(counter, []):
                cost_update_counter[cost_name] += 1
                ladder = cost_table.get(cost_name, [0.])
                idx = min(cost_update_counter[cost_name], len(ladder) - 1)
                P['cost'][cost_name] = np.asarray(float(ladder[idx]))
            # bound updates
            for update in schedule['bounds_to_update'][step_name].get(counter, []):
                lb, ub = apply_bound_update(ocp, lb, ub, lb_nominal, ub_nominal, update)
            if si < solve_from:
                # completed by the warmstart source: updates applied, no solve
                continue

            if step_name == 'initial' or not hippo:
                mu_init = sol_opts['mu_init']
                mu_target = mu_hippo if hippo else mu_target_final
                tol = tol_hippo if hippo else tol_final
            elif step_name == 'final':
                mu_init, mu_target, tol = mu_hippo, mu_target_final, tol_final
            else:
                mu_init, mu_target, tol = mu_hippo, mu_hippo, tol_hippo

            if verbose:
                awelogger.info(f"[homotopy] {schedule['labels'][step_name].get(counter, step_name)}")
            t0 = time.time()
            if state is not None:
                # warm start: keep duals, refresh slacks/barrier state
                ws = solver.init_state(w, P, lb, ub, y0=state['y'],
                                       lam0=state['lam'], mu=mu_init)
            else:
                ws = solver.init_state(w, P, lb, ub, mu=mu_init)
            key = f'{step_name}_{counter}'
            cb = None
            if record_iterates:
                recs = stats['iterates'].setdefault(key, [])

                def cb(w=None, recs=recs, **info):  # drop the full iterate, keep scalars
                    recs.append(info)
            res = solver.solve(w, P, lb, ub, state=ws, tol=tol,
                               mu_target=mu_target,
                               max_iter=sol_opts['max_iter'],
                               verbose=verbose,
                               callback=cb, callback_step=callback_step)
            elapsed = time.time() - t0
            stats['iterations'][key] = res.iterations
            stats['t_wall'][key] = elapsed
            step_results[key] = {'status': res.status, 'kkt_error': res.kkt_error,
                                 'iterations': res.iterations}
            if verbose:
                awelogger.info(f'[homotopy]   {res.status} in {res.iterations} iters '
                               f'({elapsed:.1f}s), kkt={res.kkt_error:.2e}')

            advance_anyway = sol_opts['homotopy_method']['advance_despite_max_iter']
            if not res.success and not (res.status == 'max_iter' and advance_anyway):
                success = False
            w = res.w.cpu().numpy()
            state = {k: getattr(res, k).cpu().numpy() for k in ('w', 's', 'y', 'lam', 'zl', 'zu')}
            state['mu'] = res.mu

    return HomotopySolution(V_opt=w, P=P, stats=stats, success=success,
                            step_results=step_results, final_state=state)
