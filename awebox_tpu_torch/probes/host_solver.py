#!/usr/bin/env python3
"""Times one iteration's pieces of the host solver behind Trial.optimize
(``opti/ipsolver.py``) at the bench configuration, and optionally a cold
solve of it.

At the committed anchor's state (tests/artifacts/bench_anchor_nk4_d3.npz,
mu = 1e-3, the final cost weights) on --device (default the card), each
piece on the host clock around the call and a device synchronize, median of
--runs: the dense derivatives as the solver builds them (reverse mode:
jacrev for the Jacobians, jacrev(jacrev) for the Hessian) and by forward
mode as the JAX package takes them (grad, jacfwd, hessian) with the largest
difference of the two, the residual pieces of the KKT error (kkt_parts, on
the dense derivatives as the solve loop passes them), one dense direction
(kkt_solve: K10's inertia test, K12, K13 twice) and one evaluation of the
barrier objective, each with its count of aten operations. With --solve, a cold Trial.optimize of the
bench configuration on the same device, printing each homotopy step's
iterations and seconds, and the power and period against the anchor's.
Prints one JSON line at the end.

    python3 awebox_tpu_torch/probes/host_solver.py [--solve] [--device cpu]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
ANCHOR = os.path.join(ROOT, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')


def timed(call, dev, runs):
    """(the last result, median ms) of ``runs`` calls after a warm-up."""
    out = call()
    times = []
    for _ in range(runs):
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        if dev.type == 'cuda':
            torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, sorted(times)[len(times) // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--solve', action='store_true')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.opti.homotopy import build_p_fix, final_cost_values
    from awebox_tpu_torch.opti.initialization import build_reference
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver, IPOptions
    from awebox_tpu_torch.parallel import kernels
    from awebox_tpu_torch.probes.direction_ops import OpCount

    dev = torch.device(args.device)
    trial = Trial(bench_options(), 'host_solver').build()
    ocp = trial.ocp
    anchor = dict(np.load(ANCHOR))
    P = build_p_fix(ocp, build_reference(ocp, anchor['V_init']))
    P['cost'] = {k: np.asarray(v) for k, v in final_cost_values(ocp).items()}
    solver = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=ocp.vstruct.total,
                                 n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, options=IPOptions(),
                                 device=dev)
    lbw, ubw, free, _ = InteriorPointSolver.split_pins(trial.lb_nominal, trial.ub_nominal)
    t = solver._t
    lbw, ubw, free = t(lbw), t(ubw), t(free)
    Pd = solver._p(P)
    st = {k: t(anchor[k]) for k in ('w', 's', 'y', 'lam', 'zl', 'zu')}
    w, s, y, lam, zl, zu = (st[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu'))
    mu = 1e-3
    f, eq, ineq = ocp.f_fn, ocp.eq_fn, ocp.ineq_fn

    def lagrangian(w_, y_, lam_, p_):
        return f(w_, p_) + y_ @ eq(w_, p_) + lam_ @ ineq(w_, p_)

    def derivs_fwd():
        return (f(w, Pd), grad(f)(w, Pd), eq(w, Pd), ineq(w, Pd), jacfwd(eq)(w, Pd),
                jacfwd(ineq)(w, Pd), hessian(lagrangian)(w, y, lam, Pd))

    pieces, ops = {}, {}

    def piece(name, call):
        out, pieces[name] = timed(call, dev, args.runs)
        with OpCount() as count:
            call()
        ops[name] = count.n
        return out

    d_rev = piece('derivs (jacrev, jacrev(jacrev); the solver\'s)',
                  lambda: solver._derivs(w, y, lam, Pd))
    d_fwd = piece('derivs (jacfwd, hessian)', derivs_fwd)
    gaps = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))
            for a, b in zip(d_rev[4:], d_fwd[4:])]
    fval, gradf, cE, cI, JE, JI, H = d_rev
    piece('kkt_parts', lambda: solver._kkt_parts(w, s, y, lam, zl, zu, Pd, lbw, ubw, free,
                                                 (gradf, cE, cI, JE, JI)))
    kernels.reset_launch_counts()
    piece('kkt_solve', lambda: solver._kkt_solve(gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu,
                                                 lbw, ubw, free, mu, 0.0, 1e-7, 0.0))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    piece('barrier_phi_theta', lambda: solver._barrier_phi_theta(w, s, Pd, mu, lbw, ubw))
    for name, ms in pieces.items():
        print(f'[host_solver] {name}: {ms:.1f} ms, {ops[name]} aten ops', flush=True)
    print(f'[host_solver] reverse against forward mode: JE, JI, H gaps {gaps} (relative to '
          f'max |.|); kkt_solve launches over {args.runs + 2} calls: {launches}', flush=True)
    out = dict(device=str(dev), pieces_ms=pieces, aten_ops=ops, reverse_gaps=gaps,
               launches=launches)
    if dev.type == 'cuda':
        out['card'] = torch.cuda.get_device_name(0)

    if args.solve:
        cold = Trial(bench_options(), 'host_solver_cold').build()
        t0 = time.time()
        cold.optimize(verbose=False, device=dev)
        seconds = time.time() - t0
        go = cold.global_outputs()
        st_ = cold.solution.stats
        for key in st_['iterations']:
            print(f'[host_solver] {key}: {st_["iterations"][key]} iterations, '
                  f'{st_["t_wall"][key]:.1f} s', flush=True)
        rel_p = go['avg_power_watts'] / float(anchor['avg_power_watts']) - 1.
        rel_t = go['time_period'] / float(anchor['time_period']) - 1.
        print(f'[host_solver] cold solve: {cold.solve_succeeded}, {seconds:.1f} s, '
              f'{sum(st_["iterations"].values())} iterations; power {go["avg_power_watts"]:.6f} W '
              f'({rel_p:.2e} relative to the anchor), period {go["time_period"]:.6f} s '
              f'({rel_t:.2e})', flush=True)
        out['solve'] = dict(success=cold.solve_succeeded, seconds=seconds,
                            iterations=st_['iterations'], t_wall=st_['t_wall'],
                            rel_power=rel_p, rel_period=rel_t)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
