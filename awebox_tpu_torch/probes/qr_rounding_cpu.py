#!/usr/bin/env python3
"""How the QR recipe's iteration count hangs on the rounding of its f32
solve, on the CPU (no card needed, no device number comes out of it): the
B=2 wind sweep (u_ref 9.5 and 10.5 m/s from
tests/artifacts/bench_anchor_nk4_d3.npz) is iterated to convergence with
auglu_factor='qr' three times, the factor and solve being
  lapack   torch.geqrf and ormqr + solve_triangular in f32 (the plain
           versions, what the CPU tests run),
  mirror   the CPU mirrors of the CUDA kernels' algorithms in f32
           (cluster_qr_mirror, panel_qr_solve_mirror of
           tests/test_torch_kernels.py: unblocked Householder reflectors in
           the kernels' order, without their fused multiply-adds),
  f64      LAPACK in f64: an exact solve of the f32 system, for which the
           guarded refinement sweep has nothing left to do.

    python3 awebox_tpu_torch/probes/qr_rounding_cpu.py

Prints one JSON line per variant: iterations until both lanes latched, the
final KKT errors and the seconds taken (about five minutes in all).
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

    def mirror_solve(qr, tau, v):
        return torch.stack([ktests.panel_qr_solve_mirror(*lane) for lane in zip(qr, tau, v)])

    def f64_solve(qr, tau, v):
        y = torch.ormqr(qr, tau, v.double()[:, :, None], left=True, transpose=True)
        return torch.linalg.solve_triangular(torch.triu(qr), y, upper=True)[:, :, 0].float()

    variants = {'lapack': (kernels.qr_factor_batched_plain, kernels.qr_solve_batched_plain),
                'mirror': (mirror_factor, mirror_solve),
                'f64': (lambda M: torch.geqrf(M.double()), f64_solve)}
    trial = Trial(bench_options(), 'qr_rounding').build()
    anchor = dict(np.load(os.path.join(ROOT, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64, lbw, ubw, free, _ = wind_sweep_problem(trial, anchor, 2, device='cpu')
    for name, (factor, solve) in variants.items():
        # on CPU tensors the wrappers call their plain versions by these names
        kernels.qr_factor_batched_plain, kernels.qr_solve_batched_plain = factor, solve
        t0 = time.time()
        res = refine(trial.ocp, state, P64, lbw, ubw, free, max_iter=100, kappa_mu=0.4,
                     auglu_factor='qr')
        print(json.dumps({'solve': name, 'iterations': res['n_iter'],
                          'latched': res['latched'].tolist(),
                          'err': res['state']['err'].tolist(),
                          'seconds': time.time() - t0}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
