#!/usr/bin/env python3
"""Times one iteration's pieces of the host solver behind Trial.optimize
(``opti/ipsolver.py``) at the bench configuration (or, with --config sixdof,
at the 6-DOF flagship configuration, ``configs.flagship_options(N, 3)``:
at N = 4 the single-kite 6-DOF health configuration, n = 569 variables, an
augmented K of 1125), and optionally a cold solve of it.

The bench configuration at n_k=4 (the default) is timed at the committed
anchor's state (tests/artifacts/bench_anchor_nk4_d3.npz, mu = 1e-3, the
final cost weights); with --nk N at another grid (no anchor there), and the
6-DOF configuration at every grid, at the cold solve's first iterate, the
arguments of the first kkt_solve of the 'initial' homotopy step
(bench_options(n_k=N): at N = 10, n = 670 variables, an augmented K of
1311). On --device (default the card), each
piece on the host clock around the call and a device synchronize, median of
--runs: the dense derivatives as the solver builds them (reverse mode:
jacrev for the Jacobians, jacrev(jacrev) for the Hessian) and by forward
mode as the JAX package takes them (grad, jacfwd, hessian) with the largest
difference of the two, the residual pieces of the KKT error (kkt_parts, on
the dense derivatives as the solve loop passes them), one dense direction
(kkt_solve: K10's inertia test, K12, K13 twice) and one evaluation of the
barrier objective, each with its count of aten operations. With --solve, a
cold Trial.optimize of the configuration at n_k=N on the same device, uncut,
printing each homotopy step's status, iterations, seconds and KKT error, and
the power and period (against the anchor's for the bench configuration at
N = 4); --solve-only runs the
cold solve alone, --final STEP stops it after that homotopy step (at n_k=14,
the first grid past the previous K12's reach, the final step runs to its
2000-iteration cap in the JAX package), --max-iter M caps every step at M
iterations (solver.max_iter, 2000 by default). Prints one JSON line at the
end.

    python3 awebox_tpu_torch/probes/host_solver.py [--config bench|sixdof] [--nk N]
        [--solve | --solve-only] [--final STEP] [--max-iter M] [--device cpu]
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
    ap.add_argument('--solve-only', action='store_true')
    ap.add_argument('--final', help="the last homotopy step of the cold solve (default: all)")
    ap.add_argument('--max-iter', type=int, help='solver.max_iter (default: 2000)')
    ap.add_argument('--nk', type=int, default=4)
    ap.add_argument('--config', choices=('bench', 'sixdof'), default='bench')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options, flagship_options
    options_of = {'bench': lambda n_k: bench_options(n_k=n_k),
                  'sixdof': lambda n_k: flagship_options(n_k, 3)}[args.config]
    at_anchor = args.config == 'bench' and args.nk == 4
    if args.solve_only:
        dev = torch.device(args.device)
        out = dict(device=str(dev), n_k=args.nk, config=args.config,
                   solve=cold_solve(Trial, options_of, args.nk, dev, args.final,
                                    args.max_iter, at_anchor))
        if dev.type == 'cuda':
            out['card'] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
        return
    from awebox_tpu_torch.opti.homotopy import build_p_fix, final_cost_values
    from awebox_tpu_torch.opti.initialization import build_reference
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver, IPOptions
    from awebox_tpu_torch.parallel import kernels
    from awebox_tpu_torch.probes.direction_ops import OpCount

    dev = torch.device(args.device)
    anchor = dict(np.load(ANCHOR))
    options = options_of(args.nk)
    if not at_anchor:
        options['solver.max_iter'] = 1
    trial = Trial(options, 'host_solver').build()
    ocp = trial.ocp
    solver = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=ocp.vstruct.total,
                                 n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, options=IPOptions(),
                                 device=dev)
    t = solver._t
    kkt_args = None
    if at_anchor:
        P = build_p_fix(ocp, build_reference(ocp, anchor['V_init']))
        P['cost'] = {k: np.asarray(v) for k, v in final_cost_values(ocp).items()}
        lbw, ubw, free, _ = InteriorPointSolver.split_pins(trial.lb_nominal, trial.ub_nominal)
        lbw, ubw, free = t(lbw), t(ubw), t(free)
        st = {k: t(anchor[k]) for k in ('w', 's', 'y', 'lam', 'zl', 'zu')}
        w, s, y, lam, zl, zu = (st[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu'))
        mu = 1e-3
    else:
        # the cold solve's first iterate: its first kkt_solve's arguments
        kept, inner_kkt, inner_solve = {}, solver._kkt_solve, solver.solve

        def kkt_kept(*a):
            kept.setdefault('args', a)
            return inner_kkt(*a)

        def solve_kept(w0, p, *a, **kw):
            kept.setdefault('P', p)
            return inner_solve(w0, p, *a, **kw)
        solver._kkt_solve, solver.solve = kkt_kept, solve_kept
        trial._solver_cache['solver'] = solver
        trial.optimize(final_homotopy_step='initial', verbose=False, device=dev)
        solver._kkt_solve, solver.solve = inner_kkt, inner_solve
        kkt_args = kept['args']
        w, s, y, lam, zl, zu = kkt_args[6:12]
        lbw, ubw, free = kkt_args[12:15]
        mu, P = float(kkt_args[15]), kept['P']
    Pd = solver._p(P)
    where = 'the anchor' if at_anchor else "the cold solve's first iterate"
    print(f'[host_solver] {args.config} n_k={args.nk}: n={ocp.vstruct.total}, m={ocp.n_eq + ocp.n_ineq}, '
          f'at {where}, mu {mu:g}', flush=True)
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
    kkt_args = kkt_args or (gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu, lbw, ubw, free, mu,
                            0.0, 1e-7, 0.0)
    piece('kkt_solve', lambda: solver._kkt_solve(*kkt_args))
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    piece('barrier_phi_theta', lambda: solver._barrier_phi_theta(w, s, Pd, mu, lbw, ubw))
    for name, ms in pieces.items():
        print(f'[host_solver] {name}: {ms:.1f} ms, {ops[name]} aten ops', flush=True)
    print(f'[host_solver] reverse against forward mode: JE, JI, H gaps {gaps} (relative to '
          f'max |.|); kkt_solve launches over {args.runs + 2} calls: {launches}', flush=True)
    out = dict(device=str(dev), n_k=args.nk, config=args.config, pieces_ms=pieces, aten_ops=ops, reverse_gaps=gaps,
               launches=launches)
    if dev.type == 'cuda':
        out['card'] = torch.cuda.get_device_name(0)

    if args.solve:
        out['solve'] = cold_solve(Trial, options_of, args.nk, dev, args.final, args.max_iter,
                                  at_anchor)
    print(json.dumps(out), flush=True)


def cold_solve(Trial, options_of, n_k, dev, final=None, max_iter=None, at_anchor=False):
    """Trial(options_of(n_k)).build().optimize() on dev, uncut (through the
    homotopy step ``final`` if given, each step capped at ``max_iter``
    iterations if given): each homotopy step's line and the solve's, against
    the anchor's power and period ``at_anchor``; returns its record."""
    options = options_of(n_k)
    if max_iter:
        options['solver.max_iter'] = max_iter
    cold = Trial(options, 'host_solver_cold').build()
    t0 = time.time()
    cold.optimize(verbose=False, device=dev,
                  **({'final_homotopy_step': final} if final else {}))
    seconds = time.time() - t0
    go = cold.global_outputs()
    st_ = cold.solution.stats
    steps = {}
    for key in st_['iterations']:
        res = cold.solution.step_results[key]
        steps[key] = dict(status=res['status'], iterations=st_['iterations'][key],
                          seconds=st_['t_wall'][key], kkt_error=res['kkt_error'])
        print(f'[host_solver] {key}: {res["status"]}, {st_["iterations"][key]} iterations, '
              f'{st_["t_wall"][key]:.1f} s, '
              f'{1e3 * st_["t_wall"][key] / max(st_["iterations"][key], 1):.0f} ms/iter, '
              f'KKT error {res["kkt_error"]:.3e}', flush=True)
    rec = dict(success=cold.solve_succeeded, seconds=seconds, steps=steps,
               power=go['avg_power_watts'], period=go['time_period'])
    line = (f'[host_solver] cold solve at n_k={n_k}: {cold.solve_succeeded}, {seconds:.1f} s, '
            f'{sum(st_["iterations"].values())} iterations; power {go["avg_power_watts"]!r} W, '
            f'period {go["time_period"]!r} s')
    if at_anchor:
        anchor = dict(np.load(ANCHOR))
        rec['rel_power'] = go['avg_power_watts'] / float(anchor['avg_power_watts']) - 1.
        rec['rel_period'] = go['time_period'] / float(anchor['time_period']) - 1.
        line += f' ({rec["rel_power"]:.2e}, {rec["rel_period"]:.2e} relative to the anchor)'
    print(line, flush=True)
    return rec


if __name__ == '__main__':
    main()
