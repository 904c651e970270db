#!/usr/bin/env python3
"""Counts the aten operations that one direction call dispatches on the
card, and times the call, for the port in the tree at --root (default: this
checkout), at the slice's shape: the bench configuration, B=16 lanes from
tests/artifacts/bench_anchor_nk4_d3.npz, the derivatives at the anchor.

Two trees are compared in one call on one card, e.g. a parent commit
unpacked (``git archive``) into a directory that .gitignore lists, in turns:

    python3 awebox_tpu_torch/probes/direction_ops.py --root _archive/parent
    python3 awebox_tpu_torch/probes/direction_ops.py

Prints one JSON line: the tree, the card, the number of aten operations of
one direction call (a TorchDispatchMode counter, after a warm-up call) and
the call's time in ms (host clock around the call and a device
synchronize, median of --runs). With --profile, a second line gives the
device time per call of each kernel the call launches (torch.profiler over
--runs calls), largest first, and their sum. Needs a CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

HERE = os.path.dirname(os.path.abspath(__file__))


class OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count_and_time(call, runs):
    """The aten operations one call() dispatches (after a warm-up call) and
    the times of ``runs`` more calls in ms, each on the host clock around the
    call and a device synchronize. chip_smoke.py reads the direction's
    numbers through this function too."""
    call()
    torch.cuda.synchronize()
    with OpCount() as count:
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return count.n, times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument('--lanes', type=int, default=16)
    ap.add_argument('--runs', type=int, default=25)
    ap.add_argument('--profile', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('direction_ops: no CUDA device', file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.parallel.batch import make_ip_step
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    torch.backends.cuda.matmul.allow_tf32 = False

    f32 = torch.float32
    trial = Trial(bench_options(), 'direction_ops').build()
    ocp = trial.ocp
    anchor = dict(np.load(os.path.join(root, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64, lbw, ubw, free, _ = wind_sweep_problem(trial, anchor, args.lanes, device='cuda')
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp)
    w, y, lam = state['w'], state['y'], state['lam']
    dv = tuple(vals_fn(w, y, lam, P64)) + tuple(J.to(f32) for J in jac_fn(w, P64)) \
        + (hess_fn(w, y, lam, P64).to(f32),)
    _, direction = make_ip_step(ocp, kappa_mu=0.4)
    call = lambda: direction(state, dv, lbw, ubw, free)
    n_ops, times = count_and_time(call, args.runs)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({'root': os.path.relpath(root, os.getcwd()), 'card': smi, 'lanes': args.lanes,
                      'ops': n_ops, 'direction_ms': statistics.median(times),
                      'direction_ms_min': min(times)}), flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.runs):
                call()
            torch.cuda.synchronize()
        per_call = {}
        for ev in prof.key_averages():
            us = ev.self_device_time_total
            if us > 0:
                per_call[ev.key[:60]] = us / args.runs
        kern = dict(sorted(per_call.items(), key=lambda kv: -kv[1]))
        print(json.dumps({'device_us_per_call': kern,
                          'device_us_sum': sum(kern.values())}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
