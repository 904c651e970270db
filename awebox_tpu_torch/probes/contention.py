"""Whether host-bound processes slow each other on one card: the batched
dense derivative pass of the bench configuration (B=16 lanes from the n_k=4
anchor, make_ip_step(kkt='dense', split=True)'s derivatives, host-dispatch
bound) timed in 1, 2 and 3 processes started at once, each on one CPU thread.
chip_smoke.py runs its cold solves of Trial.optimize in a second process
beside its batched slices on this measurement.

    python3 awebox_tpu_torch/probes/contention.py

prints the card's name, power limit and compute mode, then for each number of
processes the median seconds of a derivative pass (of 6, after a warm-up) in
each process and the wall time.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, HERE)


def derivative_passes(n):
    """Seconds of each of n derivative passes on the card."""
    import numpy as np
    import torch
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.parallel import batch
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    torch.set_num_threads(1)
    trial = Trial(bench_options(), 'contention').build()
    anchor = dict(np.load(os.path.join(HERE, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64 = wind_sweep_problem(trial, anchor, 16, device=torch.device('cuda'))[:2]
    derivs, _ = batch.make_ip_step(trial.ocp, kkt='dense', split=True, solve_dtype=torch.float64)
    derivs(state['w'], state['y'], state['lam'], P64)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        derivs(state['w'], state['y'], state['lam'], P64)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def main():
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,compute_mode',
                          '--format=csv,noheader'], capture_output=True, text=True).stdout.strip())
    for k in (1, 2, 3):
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--passes', '6'],
                                  stdout=subprocess.PIPE, text=True) for _ in range(k)]
        outs = [json.loads(p.communicate()[0].strip().splitlines()[-1]) for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f'a process failed: {[p.returncode for p in procs]}')
        print(f'{k} process(es) at once: median s a derivative pass, each: '
              f'{[sorted(o)[len(o) // 2] for o in outs]}; wall {time.time() - t0:.1f} s',
              flush=True)


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--passes':
        print(json.dumps(derivative_passes(int(sys.argv[2]))), flush=True)
    else:
        main()
