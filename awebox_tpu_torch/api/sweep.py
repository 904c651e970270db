"""Sweep: parametric studies over trials.

Counterpart of ``awebox_tpu/api/sweep.py``. Two execution paths:

* ``run``: serial, each parametric point re-optimized by ``Trial.optimize``
  from the previous solution (warm-start chaining);
* ``run_batched``: one batched interior-point solve
  (``parallel/batch.py::make_batched_solver`` with ``batch_p=True``) refines
  every parametric case from a solved anchor at once, each case with its own
  theta0 (wind, aero, tether parameters).

Both run on the card unless the caller passes ``device='cpu'``.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List

import numpy as np
import torch

from ..tree import tree_map
from .trial import Trial


class Sweep:
    def __init__(self, options_seed, param_options: List[Dict], name='sweep'):
        """param_options: list of dotted-path override dicts, one per case,
        e.g. [{'user_options.wind.u_ref': 5.}, {...: 6.}, ...]."""
        self.base_seed = options_seed
        self.param_options = param_options
        self.name = name
        self.sweep_dict: Dict = {}
        self.plot_dict: Dict = {}

    def run(self, final_homotopy_step='final', verbose=False, warmstart_chain=True,
            device=None):
        """Serial sweep with warm-start chaining."""
        previous_V = None
        for idx, overrides in enumerate(self.param_options):
            seed = copy.deepcopy(self.base_seed)
            if hasattr(seed, 'as_dict'):
                trial = Trial(copy.deepcopy(seed), f'{self.name}_{idx}')
                for key, val in overrides.items():
                    trial.options_raw[key] = val
            else:
                seed = dict(seed)
                seed.update(overrides)
                trial = Trial(seed, f'{self.name}_{idx}')
            trial.build()
            t0 = time.time()
            trial.optimize(final_homotopy_step=final_homotopy_step,
                           verbose=verbose,
                           warmstart=previous_V if warmstart_chain else None,
                           device=device)
            label = '_'.join(str(v) for v in overrides.values())
            self.sweep_dict[label] = {
                'success': trial.solve_succeeded,
                'global_outputs': trial.global_outputs(),
                'theta_opt': trial.theta_opt(),
                'wall_time': time.time() - t0,
                'iterations': trial.solution.stats['iterations'],
            }
            self.plot_dict[label] = trial.interpolate() if trial.solve_succeeded else None
            if trial.solve_succeeded and warmstart_chain:
                previous_V = np.asarray(trial.solution.V_opt)
        return self

    # ------------------------------------------------------------------
    def batched_problem(self, anchor_trial, device=None):
        """What run_batched solves from the solved ``anchor_trial``: (lbf, ubf)
        the final-step bounds relaxed as the host solver left them (numpy,
        before split_pins), P_batch the per-case parameter tree (the final
        cost weights, the anchor's reference and weights, each case's theta0
        overrides; numpy leaves with a case axis) and state, every case at
        the anchor's converged primal-dual state with mu = 1e-5 and err =
        inf, f64 tensors on ``device`` (the card for None)."""
        from ..opti import homotopy as homotopy_mod
        from ..opti.ipsolver import solver_device
        from ..parallel import batch as batch_mod

        dev = solver_device(device, 'Sweep.run_batched')
        ocp = anchor_trial.ocp
        # final-step bounds and cost weights (replayed, not re-solved)
        lbf, ubf = homotopy_mod.final_bounds(
            ocp, anchor_trial.lb_nominal, anchor_trial.ub_nominal,
            np.asarray(anchor_trial.V_init))
        # the anchor solution sits ON the host solver's (relaxed) bounds;
        # refine under the same relaxation or the barrier terms blow up at
        # the active set (ipsolver.solve applies the identical recipe)
        relax = 1e-8
        fin_l = np.isfinite(lbf) & (lbf != ubf)
        fin_u = np.isfinite(ubf) & (lbf != ubf)
        lbf = np.where(fin_l, lbf - relax * np.maximum(1., np.abs(lbf)), lbf)
        ubf = np.where(fin_u, ubf + relax * np.maximum(1., np.abs(ubf)), ubf)
        base_P = anchor_trial.solution.P
        final_costs = homotopy_mod.final_cost_values(ocp)

        # per-scenario P: overrides mapped onto theta0 leaves
        p_list = []
        for overrides in self.param_options:
            p_list.append({
                'cost': {k: np.asarray(final_costs[k]) for k in final_costs},
                'ref': base_P['ref'],
                'weights': base_P['weights'],
                'theta0': _override_theta0(base_P['theta0'], overrides),
            })
        P_batch = tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *p_list)

        # every scenario starts from the anchor's converged state
        st = anchor_trial.solution.final_state
        n_cases = len(self.param_options)
        state = {k: np.stack([np.asarray(st[k])] * n_cases)
                 for k in ('w', 's', 'y', 'lam', 'zl', 'zu')}
        state['mu'] = np.full((n_cases,), 1e-5)
        state['err'] = np.full((n_cases,), np.inf)
        return lbf, ubf, P_batch, batch_mod.state_from_numpy(state, dev)

    def run_batched(self, anchor_trial=None, n_iter: int = 200, mesh=None,
                    verbose=False, tol: float = 1e-7, device=None):
        """Batched sweep: one batched interior-point solve refines every
        parametric case simultaneously.

        The anchor is a single fully homotopy-solved trial on the base
        options (solved here on ``device`` if not given); each scenario then
        continues from the anchor's converged state with its own theta0
        (e.g. per-scenario wind u_ref), final-step bounds and final cost
        weights. Only dotted paths that map onto theta0 leaves can be swept
        this way (wind/atmosphere/aero parameters); structural overrides need
        the serial path. Each case iterates until its KKT error clears tol
        (n_iter is only the cap). ``mesh`` (cases sharded over several
        devices) is not ported. The batched state lands in
        ``self.batched_state`` and the loop's iterations in ``self.n_iter``."""
        from ..parallel import batch as batch_mod

        if mesh is not None:
            raise NotImplementedError('Sweep.run_batched: mesh= (cases sharded over several '
                                      'devices) is not ported')
        if anchor_trial is None:
            anchor_trial = Trial(copy.deepcopy(self.base_seed),
                                 f'{self.name}_anchor').build()
            anchor_trial.optimize(verbose=verbose, device=device)
        if not anchor_trial.solve_succeeded:
            raise RuntimeError('anchor trial failed; cannot batch-continue')
        self.anchor_trial = anchor_trial
        ocp = anchor_trial.ocp
        lbf, ubf, P_np, state = self.batched_problem(anchor_trial, device)
        P_batch = batch_mod.p_from_numpy(P_np, state['w'].device)

        solver = batch_mod.make_batched_solver(
            ocp, lbf, ubf, n_iter=n_iter, mesh=mesh, batch_p=True, tol=tol)
        out = solver(state, P_batch)
        self.batched_state = out
        self.n_iter = solver.n_iter
        W = out['w']

        # per-scenario outputs + convergence check against the final-step KKT
        T = torch.func.vmap(ocp.time_period_fn)(W).cpu().numpy()
        e_end = torch.func.vmap(ocp.e_final_si_fn)(W, P_batch).cpu().numpy()
        eq_res = torch.abs(torch.func.vmap(ocp.eq_fn)(W, P_batch)).amax(dim=1).cpu().numpy()
        finite = torch.isfinite(W).all(dim=1).cpu().numpy()
        W = W.cpu().numpy()
        for idx, overrides in enumerate(self.param_options):
            label = '_'.join(str(v) for v in overrides.values())
            self.sweep_dict[label] = {
                'success': bool(finite[idx] and eq_res[idx] < 1e-4),
                'global_outputs': {'time_period': float(T[idx]),
                                   'e_final_joules': float(e_end[idx]),
                                   'avg_power_watts': float(e_end[idx] / T[idx])},
                'eq_residual': float(eq_res[idx]),
                'V_opt': W[idx],
            }
        return self

    # ------------------------------------------------------------------
    def plot_comparison(self, save_prefix=None):
        raise NotImplementedError('Sweep.plot_comparison is not ported (the visualization '
                                  'modules are not)')

    def power_curve(self):
        """(labels, avg_power_watts) across the sweep."""
        labels = list(self.sweep_dict.keys())
        powers = [self.sweep_dict[l]['global_outputs']['avg_power_watts']
                  for l in labels]
        return labels, powers


def _override_theta0(theta0, overrides):
    """Map dotted option overrides onto theta0 leaves (the batchable subset:
    user_options.wind.u_ref and params.* paths that exist in theta0)."""
    out = copy.deepcopy(tree_map(np.asarray, theta0))
    for key, val in overrides.items():
        parts = key.split('.')
        if key == 'user_options.wind.u_ref':
            out['wind']['u_ref'] = np.asarray(float(val))
            continue
        if parts[0] == 'params' and len(parts) >= 3:
            node = out
            ok = True
            for p in parts[1:-1]:
                if p in node:
                    node = node[p]
                else:
                    ok = False
                    break
            if ok and parts[-1] in node:
                node[parts[-1]] = np.asarray(float(val))
                continue
        raise ValueError(
            f'override {key!r} does not map onto a theta0 leaf; '
            'use the serial Sweep.run path for structural options')
    return out
