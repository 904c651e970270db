#!/usr/bin/env python3
"""The convergence tail of the two factors of the direction on one wide
wind sweep: the bench configuration, --lanes lanes (default 128) with u_ref
spread +-5% around 10 m/s, from tests/artifacts/bench_anchor_nk4_d3.npz,
each factor ('lu', then 'qr') iterated to convergence or to the --max-iter
cap (default 100) in one call on one card.

    python3 awebox_tpu_torch/probes/factor_tail.py

Prints one JSON line per factor: converged and latched lanes, iterations,
the u_ref, KKT error and barrier of every lane that did not converge, ms
per iteration with the direction piece's share, delta-ladder retries and
the average powers' range; then one line with the card and the largest
relative gap of the per-lane average powers between the factors over the
lanes that converged with both. Needs a CUDA card.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--lanes', type=int, default=128)
    ap.add_argument('--max-iter', type=int, default=100)
    ap.add_argument('--spread', type=float, default=0.05)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('factor_tail: no CUDA device', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.parallel import kernels
    from awebox_tpu_torch.parallel.refine import average_power, refine, wind_sweep_problem
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels.library()   # built before anything is timed
    trial = Trial(bench_options(), 'factor_tail').build()
    ocp = trial.ocp
    anchor = dict(np.load(os.path.join(root, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64, lbw, ubw, free, u_refs = wind_sweep_problem(trial, anchor, args.lanes,
                                                            spread=args.spread, device='cuda')
    powers = {}
    for factor in ('lu', 'qr'):
        kernels.reset_launch_counts()
        res = refine(ocp, state, P64, lbw, ubw, free, tol=1e-5, verify_tol=1e-4,
                     max_iter=args.max_iter, kappa_mu=0.4, time_pieces=True,
                     auglu_factor=factor)
        it = res['n_iter']
        conv = res['converged'].cpu().numpy()
        latched = res['latched'].cpu().numpy()
        err, mu = res['state']['err'].cpu().numpy(), res['state']['mu'].cpu().numpy()
        p = average_power(ocp, res['state']['w'], P64).cpu().numpy()
        powers[factor] = np.where(conv, p, np.nan)
        retries = kernels.LAUNCHES['kkt_assemble' if factor == 'qr' else 'kkt_assemble_scaled']
        print(json.dumps({
            'factor': factor, 'lanes': args.lanes, 'converged': int(conv.sum()),
            'latched': int(latched.sum()), 'iterations': it,
            'unconverged': [dict(lane=int(i), u_ref=float(u_refs[i]), err=float(err[i]),
                                 mu=float(mu[i]), latched=bool(latched[i]))
                            for i in np.where(~conv)[0]],
            'ms_per_iter': 1e3 * res['seconds'] / it,
            'direction_ms_per_iter': 1e3 * res['times']['direction'] / it,
            'ladder_retries': retries, 'solves_per_s': float(conv.sum() / res['seconds']),
            'max_eq_res': float(res['eq_res'].max()),
            'p_avg_kw': [float(np.nanmin(p) / 1e3), float(np.nanmax(p) / 1e3)]}), flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    both = np.isfinite(powers['lu']) & np.isfinite(powers['qr'])
    gap = float(np.abs(powers['qr'][both] / powers['lu'][both] - 1.).max()) if both.any() else None
    print(json.dumps({'card': smi, 'lanes_converged_with_both': int(both.sum()),
                      'max_relative_power_gap': gap}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
