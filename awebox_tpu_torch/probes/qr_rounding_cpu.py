#!/usr/bin/env python3
"""How the QR recipe's iteration count hangs on the rounding of its f32
solve, on the CPU (no card needed, no device number comes out of it): the
B=2 wind sweep (u_ref 9.5 and 10.5 m/s from
tests/artifacts/bench_anchor_nk4_d3.npz) is iterated to convergence with
auglu_factor='qr' once per variant, the factor and solve being
  lapack      torch.geqrf and ormqr + solve_triangular in f32 (the plain
              versions, what the CPU tests run),
  mirror      the CPU mirrors of the CUDA kernels' algorithms in f32
              (cluster_qr_mirror, panel_qr_solve_mirror of
              tests/test_torch_kernels.py: the kernels' panels, block
              reflectors and order, without their fused multiply-adds),
  mirror-t64  the same with each panel's G = V^T V and larft's recurrence
              for T in f64, T rounded to f32,
  mirror-g64  G in f64 (rounded to f32), the recurrence in f32,
  mirror-r64  G in f32, the recurrence in f64,
  f64         LAPACK in f64: an exact solve of the f32 system, for which
              the guarded refinement sweep has nothing left to do.

    python3 awebox_tpu_torch/probes/qr_rounding_cpu.py [variant ..] [--errors]

Prints one JSON line per variant (all six by default, about two minutes
each): iterations until both lanes latched, the final KKT errors, the
seconds taken. With --errors, the first variant's loop also keeps every
system it factors (the Ruiz-scaled K and the right-hand side of its first
solve), and each variant then solves all of them: one JSON line per variant
with the median and geometric mean, over the systems, of the relative error
of x against an f64 solve before and after one f64 residual sweep (about a
minute a variant more). Equal errors with unequal iteration counts say that
the count follows the rounding, not the factor's accuracy.
"""
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
from awebox_tpu_torch.api.trial import Trial  # noqa: E402
from awebox_tpu_torch.configs import bench_options  # noqa: E402
from awebox_tpu_torch.parallel import kernels  # noqa: E402
from awebox_tpu_torch.parallel.refine import refine, wind_sweep_problem  # noqa: E402


def main():
    torch.set_num_threads(2)
    spec = importlib.util.spec_from_file_location(
        'test_torch_kernels', os.path.join(ROOT, 'tests', 'test_torch_kernels.py'))
    ktests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ktests)

    def mirror_factor(M):
        out = [ktests.cluster_qr_mirror(lane.clone()) for lane in M]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    panel_t32 = ktests.panel_t

    def panel_t_in(g_dtype, r_dtype):
        """panel_t with G formed in g_dtype and the recurrence in r_dtype."""
        def panel_t(V, tau):
            G = (V.to(g_dtype).T @ V.to(g_dtype)).to(r_dtype)
            T = torch.zeros(V.shape[1], V.shape[1], dtype=r_dtype)
            for k in range(V.shape[1]):
                T[k, k] = tau[k]
                T[:k, k] = -tau[k].to(r_dtype) * (T[:k, :k] @ G[:k, k])
            return T.float()
        return panel_t

    def mirror_solve(qr, tau, v):
        return torch.stack([ktests.panel_qr_solve_mirror(*lane) for lane in zip(qr, tau, v)])

    def f64_solve(qr, tau, v):
        y = torch.ormqr(qr, tau, v.double()[:, :, None], left=True, transpose=True)
        return torch.linalg.solve_triangular(torch.triu(qr), y, upper=True)[:, :, 0].float()

    variants = {'lapack': (kernels.qr_factor_batched_plain, kernels.qr_solve_batched_plain),
                'mirror': (mirror_factor, mirror_solve),
                'mirror-t64': (mirror_factor, mirror_solve),
                'mirror-g64': (mirror_factor, mirror_solve),
                'mirror-r64': (mirror_factor, mirror_solve),
                'f64': (lambda M: torch.geqrf(M.double()), f64_solve)}
    f32, f64 = torch.float32, torch.float64
    panel_ts = {'mirror-t64': panel_t_in(f64, f64), 'mirror-g64': panel_t_in(f64, f32),
                'mirror-r64': panel_t_in(f32, f64)}
    errors = '--errors' in sys.argv[1:]
    names = [a for a in sys.argv[1:] if a != '--errors'] or list(variants)
    systems = []
    trial = Trial(bench_options(), 'qr_rounding').build()
    anchor = dict(np.load(os.path.join(ROOT, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64, lbw, ubw, free, _ = wind_sweep_problem(trial, anchor, 2, device='cpu')
    for i, name in enumerate(names):
        factor, solve = variants[name]
        ktests.panel_t = panel_ts.get(name, panel_t32)
        if errors and i == 0:
            factor, solve = recording(factor, solve, systems)
        # on CPU tensors the wrappers call their plain versions by these names
        kernels.qr_factor_batched_plain, kernels.qr_solve_batched_plain = factor, solve
        t0 = time.time()
        res = refine(trial.ocp, state, P64, lbw, ubw, free, max_iter=100, kappa_mu=0.4,
                     auglu_factor='qr')
        print(json.dumps({'solve': name, 'iterations': res['n_iter'],
                          'latched': res['latched'].tolist(),
                          'err': res['state']['err'].tolist(),
                          'seconds': time.time() - t0}), flush=True)
    for name in names if errors else ():
        factor, solve = variants[name]
        ktests.panel_t = panel_ts.get(name, panel_t32)
        print(json.dumps(dict(solve=name, systems=len(systems),
                              **solve_errors(factor, solve, systems))), flush=True)
    return 0


def recording(factor, solve, systems):
    """factor and solve that keep each factored M beside the right-hand side
    of the first solve on its factor (the recipe's solve before its sweep)."""
    last = {}

    def factor_kept(M):
        last['M'] = M.clone()
        return factor(M)

    def solve_kept(qr, tau, v):
        if 'M' in last:
            systems.extend(zip(last.pop('M'), v.clone()))
        return solve(qr, tau, v)
    return factor_kept, solve_kept


def solve_errors(factor, solve, systems):
    """Median and geometric mean over the systems of |x - x*| / |x*| (x* the
    f64 solve) for x0 = the f32 solve and x1 = x0 + the solve of the f64
    residual, scaled to max 1."""
    e0, e1 = [], []
    for M, v in systems:
        qr, tau = factor(M[None].clone())
        x_ref = torch.linalg.solve(M.double(), v.double())
        x0 = solve(qr, tau, v[None])[0].double()
        r = v.double() - M.double() @ x0
        rmax = r.abs().max()
        x1 = x0 + rmax * solve(qr, tau, (r / rmax).float()[None])[0].double()
        e0.append(float((x0 - x_ref).norm() / x_ref.norm()))
        e1.append(float((x1 - x_ref).norm() / x_ref.norm()))
    e0, e1 = torch.tensor(e0, dtype=torch.float64), torch.tensor(e1, dtype=torch.float64)
    return {'x0_median': float(e0.median()), 'x0_geomean': float(e0.log().mean().exp()),
            'x1_median': float(e1.median()), 'x1_geomean': float(e1.log().mean().exp())}


if __name__ == '__main__':
    sys.exit(main())
