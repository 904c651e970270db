"""Both packages' Trial.optimize on the CPU in f64: the cold homotopy solve of
the bench configuration (Ampyx AP2 3-DOF, n_k=4, d=3), and both packages'
Sweep.run_batched from the committed anchor. Not a test: a script that
prints what chip_smoke.py and PERF.md quote.

    python -m tests.trial_cold_cpu cold PACKAGE [--nk N] [--final STEP] [--max-iter M]
        # per homotopy step: status, iterations, wall seconds, KKT error;
        # average power and period (PACKAGE: jax or torch; at N = 4, the
        # default, against the anchor's; --nk N solves bench_options(n_k=N)
        # instead; --final STEP stops the homotopy after that step, as
        # Trial.optimize's final_homotopy_step; --max-iter M caps every step
        # at M iterations, solver.max_iter)
    python -m tests.trial_cold_cpu sweep PACKAGE TOL [EPS SEED]
        # Sweep.run_batched over u_ref 9.5 and 10.5 m/s from the anchor
        # (n_iter=200, tol=TOL): per case success, average power, period,
        # max |eq|; with EPS, the anchor's primal w is first multiplied by
        # 1 + EPS z, z standard normal from SEED (a perturbation at rounding
        # level shows whether the case's optimum is decided by rounding)

Run from the repository root with JAX_PLATFORMS=cpu.
"""
import sys
import time

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU, x64)

from tests.test_torch_support import anchor, jax_bench_options
from tests.test_torch_trial import installed


def cold(package, n_k=4, final=None, max_iter=None):
    if package == 'jax':
        from awebox_tpu.api.trial import Trial
        options = jax_bench_options(n_k)
        kw = {}
    else:
        from awebox_tpu_torch.api.trial import Trial
        from awebox_tpu_torch.configs import bench_options
        options = bench_options(n_k=n_k)
        kw = dict(device='cpu')
    if max_iter:
        options['solver.max_iter'] = max_iter
    trial = Trial(options, f'cold_{package}').build()
    if final:
        kw['final_homotopy_step'] = final
    t0 = time.time()
    trial.optimize(verbose=False, **kw)
    seconds = time.time() - t0
    st = trial.solution.stats
    for key, res in trial.solution.step_results.items():
        print(f'{package} {key}: {res["status"]}, {st["iterations"][key]} iterations, '
              f'{st["t_wall"][key]:.1f} s, kkt {res["kkt_error"]:.3e}')
    go = trial.global_outputs()
    line = (f'{package} cold solve at n_k={n_k}: success {trial.solve_succeeded}, {seconds:.1f} s, '
            f'{sum(st["iterations"].values())} iterations; power {go["avg_power_watts"]!r} W')
    if n_k == 4:
        a = anchor()
        line += f' ({go["avg_power_watts"] / float(a["avg_power_watts"]) - 1.:.2e} from the anchor)'
    line += f', period {go["time_period"]!r} s'
    if n_k == 4:
        line += f' ({go["time_period"] / float(a["time_period"]) - 1.:.2e})'
    print(line)


def perturbed(trial, eps, seed):
    """``trial`` with its final state's w multiplied by 1 + eps z."""
    st = dict(trial.solution.final_state)
    w = np.asarray(st['w'], dtype=np.float64)
    st['w'] = w * (1. + eps * np.random.default_rng(seed).standard_normal(w.shape))
    trial.solution.final_state = st
    return trial


def sweep(package, tol, eps=0., seed=0):
    cases = [{'user_options.wind.u_ref': 9.5}, {'user_options.wind.u_ref': 10.5}]
    anchor_trial = perturbed(installed(package), eps, seed) if eps else installed(package)
    t0 = time.time()
    if package == 'jax':
        from awebox_tpu.api.sweep import Sweep
        sw = Sweep(jax_bench_options(), cases).run_batched(
            anchor_trial=anchor_trial, n_iter=200, tol=tol)
    else:
        from awebox_tpu_torch.api.sweep import Sweep
        from awebox_tpu_torch.configs import bench_options
        sw = Sweep(bench_options(), cases).run_batched(
            anchor_trial=anchor_trial, n_iter=200, tol=tol, device='cpu')
    print(f'{package} run_batched tol={tol}'
          + (f' from w (1 + {eps} z), seed {seed}' if eps else '')
          + f': {time.time() - t0:.1f} s'
          + (f', {sw.n_iter} iterations' if package == 'torch' else ''))
    for label, rec in sw.sweep_dict.items():
        go = rec['global_outputs']
        print(f'{package} u_ref {label}: success {rec["success"]}, power '
              f'{go["avg_power_watts"]!r} W, period {go["time_period"]!r} s, max |eq| '
              f'{rec["eq_residual"]:.2e}')


if __name__ == '__main__':
    torch.set_num_threads(1)
    if sys.argv[1] == 'cold':
        opts = dict(zip(sys.argv[3::2], sys.argv[4::2]))
        cold(sys.argv[2], int(opts.get('--nk', 4)), opts.get('--final'),
             int(opts.get('--max-iter', 0)))
    else:
        sweep(sys.argv[2], float(sys.argv[3]),
              *([float(sys.argv[4]), int(sys.argv[5])] if len(sys.argv) > 5 else []))
