"""Both packages' Trial.optimize on the CPU in f64: the cold homotopy solve of
the bench configuration (Ampyx AP2 3-DOF, n_k=4, d=3) or of the 6-DOF
flagship configuration, and both packages' Sweep.run_batched from the
committed anchor. Not a test: a script that
prints what chip_smoke.py and PERF.md quote.

    python -m tests.trial_cold_cpu cold PACKAGE [--nk N] [--dof 6] [--final STEP] [--max-iter M]
        # per homotopy step: status, iterations, wall seconds, KKT error;
        # average power and period (PACKAGE: jax or torch; at N = 4, the
        # default, against the anchor's; --nk N solves bench_options(n_k=N)
        # instead; --final STEP stops the homotopy after that step, as
        # Trial.optimize's final_homotopy_step; --max-iter M caps every step
        # at M iterations, solver.max_iter; --dof 6 solves the 6-DOF
        # flagship configuration at n_k=N, d=3 instead, the single-kite
        # 6-DOF health configuration at N = 4: tests/test_options.py::
        # make_ampyx_options with kite_dof=6 for the JAX package,
        # configs.flagship_options(N, 3) for the port)
    python -m tests.trial_cold_cpu e2e PACKAGE NAME [--save PATH] [--max-iter M]
        # the cold solve of the end-to-end configuration NAME
        # (awebox_tpu_torch.configs.E2E_NAMES; tests/test_e2e_configs.py):
        # per homotopy step as above, average power and period; --save PATH
        # writes the JAX package's solved trial with its Trial.save and each
        # step's status (the payloads tests/artifacts/e2e_<NAME>.pkl)
    python -m tests.trial_cold_cpu trace PACKAGE NAME PATH [--threads T]
        # the cold solve of NAME as e2e does, with every iterate w of every
        # homotopy step (and alpha, delta_w, mu, the KKT error, f) and each
        # step's P pickled to PATH; --threads T runs the port's CPU
        # operations on T threads (default 1; the JAX package's thread count
        # is the process's CPU affinity, e.g. under taskset)
    python -m tests.trial_cold_cpu part NAME PATH_A PATH_B [STEP]
        # where two traces part: per step, the iterations of each and the
        # first iteration whose iterates differ by more than 1e-9 relative
        # (and the gap at 1, 10, 100, the five before it and the last shared
        # iterations); then at
        # PATH_A's iterate there in STEP (default final_0) both packages'
        # dense derivatives (the solvers' own _derivs: f, grad f, c_E, c_I,
        # J_E, J_I and the Lagrangian's Hessian at numpy-seeded multipliers)
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

from tests.test_torch_support import anchor, jax_bench_options, options_of, to_numpy_tree
from tests.test_torch_trial import installed


def cold(package, n_k=4, final=None, max_iter=None, dof=3):
    if package == 'jax':
        from awebox_tpu.api.trial import Trial
        kw = {}
    else:
        from awebox_tpu_torch.api.trial import Trial
        kw = dict(device='cpu')
    options = options_of(package, dof)(n_k)
    if max_iter:
        options['solver.max_iter'] = max_iter
    t0 = time.time()
    trial = Trial(options, f'cold_{package}').build()
    print(f'{package} built {dof}-DOF n_k={n_k}: n={trial.ocp.vstruct.total}, '
          f'm={trial.ocp.n_eq} + {trial.ocp.n_ineq}, {time.time() - t0:.1f} s', flush=True)
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
    line = (f'{package} cold solve ({dof}-DOF) at n_k={n_k}: success {trial.solve_succeeded}, {seconds:.1f} s, '
            f'{sum(st["iterations"].values())} iterations; power {go["avg_power_watts"]!r} W')
    if n_k == 4 and dof == 3:
        a = anchor()
        line += f' ({go["avg_power_watts"] / float(a["avg_power_watts"]) - 1.:.2e} from the anchor)'
    line += f', period {go["time_period"]!r} s'
    if n_k == 4 and dof == 3:
        line += f' ({go["time_period"] / float(a["time_period"]) - 1.:.2e})'
    print(line)


def e2e_options_of(package, name):
    """The end-to-end configuration ``name`` in ``package``: the port's
    configs.e2e_options, or for the JAX package tests/test_options.py::
    make_ampyx_options with the same overrides."""
    from awebox_tpu_torch import configs
    if package == 'torch':
        return configs.e2e_options(name)
    from tests.test_options import make_ampyx_options
    return configs.apply_overrides(make_ampyx_options(), configs.E2E_OVERRIDES[name])


def e2e(package, name, save=None, max_iter=None):
    if package == 'jax':
        from awebox_tpu.api.trial import Trial
        kw = {}
    else:
        from awebox_tpu_torch.api.trial import Trial
        kw = dict(device='cpu')
    options = e2e_options_of(package, name)
    if max_iter:
        options['solver.max_iter'] = max_iter
    t0 = time.time()
    trial = Trial(options, f'e2e_{name}').build()
    print(f'{package} built {name}: n={trial.ocp.vstruct.total}, '
          f'm={trial.ocp.n_eq} + {trial.ocp.n_ineq}, {time.time() - t0:.1f} s', flush=True)
    t0 = time.time()
    trial.optimize(verbose=False, **kw)
    seconds = time.time() - t0
    st = trial.solution.stats
    for key, res in trial.solution.step_results.items():
        print(f'{package} {name} {key}: {res["status"]}, {st["iterations"][key]} iterations, '
              f'{st["t_wall"][key]:.1f} s, kkt {res["kkt_error"]:.3e}')
    go = trial.global_outputs()
    print(f'{package} {name} cold solve: success {trial.solve_succeeded}, {seconds:.1f} s, '
          f'{sum(st["iterations"].values())} iterations; power {go["avg_power_watts"]!r} W, '
          f'period {go["time_period"]!r} s', flush=True)
    if save:
        add_step_statuses(trial.save(save), {k: res['status']
                                             for k, res in trial.solution.step_results.items()})
        print(f'saved {save}')
    return trial


def solver_class(package):
    if package == 'jax':
        from awebox_tpu.opti.ipsolver import InteriorPointSolver
    else:
        from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    return InteriorPointSolver


def trace(package, name, path):
    """e2e's cold solve with every solve call's iterates and P recorded."""
    import pickle
    cls = solver_class(package)
    plain_solve, calls = cls.solve, []

    def solve(self, w0, p, lbw, ubw, callback=None, **kw):
        rec = dict(P=to_numpy_tree(p), iterates=[])

        def cb(**info):
            rec['iterates'].append(info)
            if callback is not None:
                callback(**info)
        calls.append(rec)
        kw['callback_step'] = 1
        return plain_solve(self, w0, p, lbw, ubw, callback=cb, **kw)
    cls.solve = solve
    try:
        trial = e2e(package, name)
    finally:
        cls.solve = plain_solve
    keys = list(trial.solution.stats['iterations'])
    assert len(keys) == len(calls), (keys, len(calls))
    with open(path, 'wb') as fh:
        pickle.dump({k: c for k, c in zip(keys, calls)}, fh)
    print(f'saved {path}')


def part(name, path_a, path_b, step='final_0'):
    """Where the traces path_a and path_b part, and both packages' dense
    derivatives at path_a's iterate there in ``step``."""
    import pickle
    import jax.numpy as jnp
    from awebox_tpu_torch.tree import to_tensors
    from tests.e2e_parity import trials
    with open(path_a, 'rb') as fh:
        ta = pickle.load(fh)
    with open(path_b, 'rb') as fh:
        tb = pickle.load(fh)
    at = None
    for key in ta:
        ia, ib = ta[key]['iterates'], tb[key]['iterates']
        gaps = [float(np.abs(a['w'] - b['w']).max() / max(1., np.abs(a['w']).max()))
                for a, b in zip(ia, ib)]
        first = next((k for k, g in enumerate(gaps) if g > 1e-9), None)
        shown = sorted({k for k in (0, 9, 99, len(gaps) - 1) if 0 <= k < len(gaps)}
                       | (set(range(max(first - 5, 0), first + 1)) if first is not None else set()))
        line = (f'{key}: {len(ia)} and {len(ib)} iterations; first iterate more than 1e-9 '
                f'apart: {"none" if first is None else first + 1}; gaps '
                + ', '.join(f'{k + 1}: {gaps[k]:.1e}' for k in shown))
        if first is not None:
            a, b = ia[first], ib[first]
            line += (f'; there alpha {a["alpha"]:.6e} / {b["alpha"]:.6e}, delta_w '
                     f'{a["delta_w"]:.1e} / {b["delta_w"]:.1e}, mu {a["mu"]:.3e} / {b["mu"]:.3e}')
        print(line, flush=True)
        if key == step:
            at = first if first is not None else len(ia) - 1
    w = ta[step]['iterates'][at]['w']
    P = ta[step]['P']
    tj, tt = trials(name)
    ocp = tj.ocp
    rng = np.random.default_rng(0)
    y = rng.standard_normal(ocp.n_eq)
    lam = np.abs(rng.standard_normal(ocp.n_ineq))
    n = ocp.vstruct.total
    sj = solver_class('jax')(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=n, n_eq=ocp.n_eq,
                             n_ineq=ocp.n_ineq)
    st = solver_class('torch')(tt.ocp.f_fn, tt.ocp.eq_fn, tt.ocp.ineq_fn, n=n,
                               n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, device='cpu')
    dj = [np.asarray(x) for x in sj._derivs(jnp.asarray(w), jnp.asarray(y), jnp.asarray(lam),
                                            P)]
    dt = [x.numpy() for x in st._derivs(*(torch.as_tensor(v) for v in (w, y, lam)),
                                         to_tensors(P, torch.float64, 'cpu'))]
    def gap(a, b):
        """max |a - b| / max |a|, and max |a - b| / |a| over the entries of
        |a| above 1e-9 max |a|"""
        scale = max(np.abs(a).max(), 1e-300)
        big = np.abs(a) > 1e-9 * scale
        return (float(np.abs(a - b).max() / scale),
                float((np.abs(a - b)[big] / np.abs(a)[big]).max()) if big.any() else 0.)
    gaps = {k: gap(a, b) for k, a, b in zip(('f', 'grad f', 'c_E', 'c_I', 'J_E', 'J_I', 'H'),
                                             dj, dt)}
    print(f'{step} iterate {at + 1} of {path_a}: the port\'s dense derivatives against the '
          f'JAX package\'s, max |diff| / max |.| and entrywise relative: '
          + ', '.join(f'{k} {v[0]:.2e} / {v[1]:.2e}' for k, v in gaps.items()), flush=True)


def add_step_statuses(path, statuses):
    """Adds each homotopy step's status to a payload saved by Trial.save,
    under 'step_statuses' (Trial.save keeps the iterations, not these)."""
    import pickle
    with open(path, 'rb') as fh:
        payload = pickle.load(fh)
    payload['step_statuses'] = dict(statuses)
    with open(path, 'wb') as fh:
        pickle.dump(payload, fh)


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
             int(opts.get('--max-iter', 0)), int(opts.get('--dof', 3)))
    elif sys.argv[1] == 'trace':
        opts = dict(zip(sys.argv[5::2], sys.argv[6::2]))
        torch.set_num_threads(int(opts.get('--threads', 1)))
        trace(sys.argv[2], sys.argv[3], sys.argv[4])
    elif sys.argv[1] == 'part':
        part(*sys.argv[2:])
    elif sys.argv[1] == 'e2e':
        opts = dict(zip(sys.argv[4::2], sys.argv[5::2]))
        e2e(sys.argv[2], sys.argv[3], opts.get('--save'), int(opts.get('--max-iter', 0)))
    else:
        sweep(sys.argv[2], float(sys.argv[3]),
              *([float(sys.argv[4]), int(sys.argv[5])] if len(sys.argv) > 5 else []))
