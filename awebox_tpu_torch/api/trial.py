"""Trial: one OCP from options to optimized solution.

Counterpart of ``awebox_tpu/api/trial.py``: build chains architecture ->
processed options -> model -> transcription -> bounds; ``optimize`` runs the
homotopy (``opti/homotopy.py::solve_homotopy``) on the card unless the caller
passes ``device='cpu'``; post-processing exposes the global performance
numbers (average power, time period), the optimized design parameters, the
interpolated SI solution and its CSV export. The KKT health check, plotting
and the quality checks are not ported and raise by name.
"""
from __future__ import annotations

import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..arch import Architecture
from ..model.builder import make_model
from ..ocp.bounds import build_v_bounds
from ..ocp.transcription import build_ocp
from ..opti import homotopy as homotopy_mod
from ..opti.initialization import build_initial_guess, build_reference
from ..opti.ipsolver import solver_device
from ..options.options import Options
from ..tree import to_tensors
from ..utils.logging import awelogger

STATE_KEYS = ('w', 's', 'y', 'lam', 'zl', 'zu')
NOT_PORTED = ('is not ported (ROADMAP item 17, opti/diagnostics.py, and the '
              'visualization and quality modules)')


class Trial:
    def __init__(self, options_seed, name: str = 'trial'):
        if isinstance(options_seed, Options):
            self.options_raw = options_seed
        elif isinstance(options_seed, dict):
            self.options_raw = Options(options_seed)
        else:
            raise TypeError('options seed must be an Options or a dict')
        self.name = name
        self.timings: Dict[str, float] = {}
        self.solution: Optional[homotopy_mod.HomotopySolution] = None
        self._solver_cache: dict = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _peak_rss_mb():
        """Peak resident set size [MB] of this process."""
        try:
            import resource
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.
        except Exception:
            return float('nan')

    def build(self):
        t0 = time.time()
        arch_seed = self.options_raw['user_options.system_model.architecture']
        self.arch = Architecture(dict(arch_seed))
        self.options = self.options_raw.build(self.arch)
        self.timings['build_options'] = time.time() - t0
        t1 = time.time()
        self.model = make_model(self.options, self.arch)
        self.timings['build_model'] = time.time() - t1
        t1 = time.time()
        self.ocp = build_ocp(self.model, self.options)
        self.lb_nominal, self.ub_nominal = build_v_bounds(self.ocp)
        self.timings['build_nlp'] = time.time() - t1
        self.timings['build'] = time.time() - t0
        self.timings['peak_rss_mb'] = self._peak_rss_mb()
        return self

    # ------------------------------------------------------------------
    def optimize(self, final_homotopy_step: str = 'final', verbose: bool = True,
                 warmstart=None, warmstart_schedule: str = 'auto', device=None):
        """Solve the homotopy on ``device``: the card for None (raises without
        one), or the CPU for ``device='cpu'``.

        warmstart: a solved Trial, a V vector, or the path of a saved
        payload (a pickle with 'remap', the solution_payload of the source,
        and 'final_homotopy_step'), remapped onto this trial's grid.
        warmstart_schedule: 'resume' starts the homotopy after the step the
        warmstart source recorded as completed (a fully solved source gets
        one final refinement solve); 'full' re-walks the whole schedule with
        V_ref re-aimed at the warm point; 'auto' resumes for saved-payload
        warmstarts that recorded their final step and re-walks for
        everything else."""
        hc_when = self.options['solver']['health_check']['when']
        if hc_when != 'never':
            raise NotImplementedError(
                f"solver.health_check.when={hc_when!r}: the KKT health check {NOT_PORTED}")
        dev = solver_device(device, 'Trial.optimize')
        t0 = time.time()
        V_init = build_initial_guess(self.ocp)
        V_ref = build_reference(self.ocp, V_init)
        self.V_init = V_init
        self.V_ref = V_ref
        skip_through = None
        if warmstart is not None:
            from . import warmstart as ws
            if isinstance(warmstart, str):
                # a saved solution file, its stored grid remapped onto this
                # trial's (n_k, d) discretization
                with open(warmstart, 'rb') as fh:
                    payload = pickle.load(fh)
                V_init = ws.remap_to_v(payload['remap'], self.ocp)
                if warmstart_schedule in ('auto', 'resume'):
                    skip_through = payload.get('final_homotopy_step')
            elif isinstance(warmstart, Trial):
                V_init = ws.remap_to_v(ws.solution_payload(warmstart), self.ocp)
                if warmstart_schedule == 'resume':
                    skip_through = getattr(warmstart, '_final_homotopy_step', None)
            else:
                V_init = np.asarray(warmstart)
            # the tracking reference follows the warmstart: early homotopy
            # steps then pull toward the warm solution, not back to the cold
            # circular guess
            V_ref = build_reference(self.ocp, V_init)
            self.V_init = V_init
            self.V_ref = V_ref
        self._final_homotopy_step = final_homotopy_step
        cached = self._solver_cache.get('solver')
        if cached is not None and cached.device != dev:
            self._solver_cache.clear()
        self.solution = homotopy_mod.solve_homotopy(
            self.ocp, V_init, V_ref, self.lb_nominal, self.ub_nominal,
            final_homotopy_step=final_homotopy_step,
            solver_cache=self._solver_cache, verbose=verbose,
            skip_through=skip_through, device=dev)
        self.timings['optimize'] = time.time() - t0
        self.timings['peak_rss_mb'] = self._peak_rss_mb()
        return self

    def health_check(self, **kwargs):
        raise NotImplementedError(f'Trial.health_check {NOT_PORTED}')

    # ------------------------------------------------------------------
    @property
    def solve_succeeded(self) -> bool:
        return self.solution is not None and self.solution.success

    def _V_P(self):
        """The solution's V and P as f64 tensors on the CPU."""
        V = torch.as_tensor(np.asarray(self.solution.V_opt, dtype=float))
        return V, to_tensors(self.solution.P, torch.float64, 'cpu')

    def global_outputs(self) -> Dict[str, float]:
        """time period, final energy, average power (the energy from the e
        state or, under model.integral_outputs, from the collocation
        quadrature of the power)."""
        V, P = self._V_P()
        T = float(self.ocp.time_period_fn(V))
        e_end = float(self.ocp.e_final_si_fn(V, P))
        return {'time_period': T,
                'e_final_joules': e_end,
                'avg_power_watts': e_end / T}

    def theta_opt(self) -> Dict[str, np.ndarray]:
        return self.theta_of(self.solution.V_opt)

    def theta_of(self, V) -> Dict[str, np.ndarray]:
        """The SI design parameters held in a V of this trial's OCP."""
        V = np.asarray(V)
        vs = self.ocp.vstruct
        layout = self.model.layout
        out = {}
        for name in vs.theta_names:
            scale = self.model.scaling['theta'][layout.slices['theta'][name]]
            val = np.asarray(V[vs.theta_slice(name)])
            if name == 't_f' and val.shape[0] == 2:
                out[name] = val * scale[0]
            else:
                out[name] = val * scale
        return out

    def solution_table(self) -> str:
        """Post-solve summary table: headline performance, optimized design
        parameters, per-step iterations/wall time, and the cost-component
        breakdown."""
        go = self.global_outputs()
        lines = [f'===== solution: {self.name} =====',
                 f'  average power      {go["avg_power_watts"] / 1e3:10.3f} kW',
                 f'  time period        {go["time_period"]:10.2f} s',
                 f'  final energy       {go["e_final_joules"] / 1e3:10.2f} kJ']
        for name, val in self.theta_opt().items():
            flat = np.ravel(val)
            txt = ', '.join(f'{v:.4g}' for v in flat)
            lines.append(f'  theta {name:12s} [{txt}]')
        stats = self.solution.stats
        iters = stats.get('iterations', {})
        walls = stats.get('t_wall', {})
        lines.append(f'  homotopy           {sum(iters.values())} iterations, '
                     f'{sum(walls.values()):.1f} s wall')
        for key in iters:
            lines.append(f'    {key:22s} {iters[key]:5d} it '
                         f'{walls.get(key, float("nan")):8.1f} s')
        if self.ocp.cost_components_fn is not None:
            comp = self.ocp.cost_components_fn(*self._V_P())
            lines.append('  cost components:')
            for name in sorted(comp):
                val = float(comp[name])
                if abs(val) > 1e-12 and not name.endswith('problem_cost'):
                    lines.append(f'    {name:28s} {val: .4e}')
        if 'peak_rss_mb' in self.timings:
            lines.append(f'  peak RSS           {self.timings["peak_rss_mb"]:.0f} MB')
        return '\n'.join(lines)

    def print_solution_table(self):
        awelogger.info(self.solution_table())

    def x_traj_si(self, name: str) -> np.ndarray:
        """(n_k+1, dim) SI trajectory of state `name` at shooting nodes."""
        V = np.asarray(self.solution.V_opt)
        vs = self.ocp.vstruct
        sl = self.model.layout.slices['x'][name]
        scale = self.model.scaling['x'][sl]
        return np.asarray(vs.get_x_all(V)[:, sl]) * scale

    # ------------------------------------------------------------------
    def interpolate(self, n_points: int = 100):
        from . import postprocessing
        return postprocessing.interpolate_solution(self, n_points)

    def write_to_csv(self, filename, n_points: int = 100):
        from . import postprocessing
        return postprocessing.write_csv(self, filename, n_points)

    def plot(self, *args, **kwargs):
        raise NotImplementedError(f'Trial.plot {NOT_PORTED}')

    def check_quality(self, *args, **kwargs):
        raise NotImplementedError(f'Trial.check_quality {NOT_PORTED}')


def _install(trial, V_opt, V_init, final_state, eq_tol, **record) -> bool:
    """Install V_opt as the built ``trial``'s final-step solution once its
    f64 dynamics residual under this trial's OCP and the final cost weights
    is within ``eq_tol``; ``record`` fills the solution's other fields."""
    ocp = trial.ocp
    if V_opt.shape[0] != ocp.vstruct.total:
        return False
    V_ref = build_reference(ocp, V_init)
    P = homotopy_mod.build_p_fix(ocp, V_ref)
    # a final-homotopy-step optimum: evaluate it under the final cost
    # weights, as the solver left it
    P['cost'] = {k: np.asarray(v) for k, v in homotopy_mod.final_cost_values(ocp).items()}
    eq = ocp.eq_fn(torch.as_tensor(V_opt), to_tensors(P, torch.float64, 'cpu'))
    eq = float(torch.abs(eq).max())
    if not np.isfinite(eq) or eq > eq_tol:
        return False
    trial.V_init = V_init
    trial.V_ref = V_ref
    trial._final_homotopy_step = 'final'
    trial.solution = homotopy_mod.HomotopySolution(V_opt=V_opt, P=P, final_state=final_state,
                                                   **record)
    return True


def install_anchor(trial, path, eq_tol: float = 1e-4) -> bool:
    """Install a solved primal-dual state saved as an npz (w, s, y, lam, zl,
    zu, V_init, kkt_error; tests/artifacts/bench_anchor_*.npz) as the built
    ``trial``'s final-step solution, as if ``optimize`` had left it. The
    state is accepted only if its f64 dynamics residual under this trial's
    OCP and the final cost weights is within ``eq_tol``; returns whether it
    was installed."""
    anchor = np.load(path)
    return _install(
        trial, np.asarray(anchor['w']), np.asarray(anchor['V_init']),
        {k: np.asarray(anchor[k]) for k in STATE_KEYS}, eq_tol,
        stats={'iterations': {}, 't_wall': {}}, success=True,
        step_results={'final_0': {'iterations': 0, 'kkt_error': float(anchor['kkt_error']),
                                  'loaded_from_artifact': True}})


def install_solution(trial, payload, eq_tol: float = 1e-4) -> bool:
    """Install a solution saved by the JAX package's ``Trial.save`` (a dict
    of numpy arrays, floats and dicts, or the path of its pickle, as
    tests/artifacts/flagship_coarse_nk20_d3.pkl) as the built ``trial``'s
    final-step solution: V_opt, V_init, the primal-dual state ('duals') and
    the solve's stats. The payload's theta_opt must be the design
    parameters of its V_opt under this trial's scaling, and the state is
    accepted only if its f64 dynamics residual under this trial's OCP and
    the final cost weights is within ``eq_tol``; returns whether it was
    installed."""
    if isinstance(payload, str):
        with open(payload, 'rb') as fh:
            payload = pickle.load(fh)
    V_opt = np.asarray(payload['V_opt'], dtype=float)
    if V_opt.shape[0] != trial.ocp.vstruct.total:
        return False
    theta = trial.theta_of(V_opt)
    if set(payload['theta_opt']) != set(theta) or not all(
            np.allclose(theta[k], np.asarray(v, dtype=float), rtol=1e-12, atol=0.)
            for k, v in payload['theta_opt'].items()):
        return False
    duals, stats = payload['duals'], payload['stats']
    return _install(trial, V_opt, np.asarray(payload['V_init'], dtype=float),
                    {k: np.asarray(duals[k]) for k in STATE_KEYS} if duals else None,
                    eq_tol, stats=stats, success=bool(payload['success']),
                    step_results={'final_0': {'iterations': stats['iterations'].get('final_0', 0),
                                              'loaded_from_artifact': True}})
