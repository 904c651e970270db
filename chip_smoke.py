#!/usr/bin/env python3
"""Smoke test of awebox_tpu_torch on one CUDA card.

Drives the port's main path, the batched wind-sweep refinement of the
Ampyx AP2 3-DOF power cycle (n_k=4, d=3: n=280 variables, m=263
constraints, a 543x543 augmented KKT system per lane), through its public
entry points, and checks the hand-written CUDA kernels on the way:

  1. device   the card (nvidia-smi name and power limit), torch/CUDA
              versions; TF32 off for matmul and cuDNN
  2. build    compile awebox_tpu_torch/csrc/auglu.cu with nvcc (sm_90a)
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, on anchor-derived and random systems, with the
              times of both (median of 25 runs, CUDA events)
  4. slice    Trial(bench_options()).build(), 16 lanes with u_ref in
              9.5..10.5 m/s from tests/artifacts/bench_anchor_nk4_d3.npz,
              iterated to convergence (at most 100 iterations); every lane
              must latch KKT error <= 1e-5 and pass the f64 dynamics
              residual check <= 1e-4
  5. path     every kernel launched during the slice run; state on the card

Any failure raises and exits non-zero. Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero before printing a
result. Run from the repository root:

    python3 chip_smoke.py
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(HERE, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')
B = 16
N_TIMED = 25


def phase(name, msg):
    print(f'[{name}] {msg}', flush=True)


def require(ok, what):
    """Fail the run (not an assert: the checks must hold under python -O)."""
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {what}')


def cuda_median_ms(fn, setup=None, n=N_TIMED):
    """Median device time of fn() in ms over n runs, each bracketed by CUDA
    events after an untimed warm-up; setup() runs untimed before each."""
    import torch
    if setup is not None:
        setup()
    fn()
    times = []
    for _ in range(n):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def random_systems(rng, n, m, lanes):
    """Saddle systems shaped like the test suite's make_system (symmetric
    indefinite W0 with a barrier-like diagonal spread, rows of A spread over
    four decades, D of 1e-8 equality rows and small inequality rows), at
    the main path's n and m."""
    import numpy as np
    W0, A, D, r1, r2 = [], [], [], [], []
    for _ in range(lanes):
        Wh = rng.standard_normal((n, n))
        W = (Wh + Wh.T) / 2 + np.diag(10.0 ** rng.uniform(-2, 5, n))
        W0.append(W)
        A.append(rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-2, 2, (m, 1)))
        D.append(np.concatenate([1e-8 * np.ones(m - 16),
                                 np.abs(rng.standard_normal(16)) * 1e-3]))
        r1.append(rng.standard_normal(n))
        r2.append(rng.standard_normal(m))
    return [np.stack(x) for x in (W0, A, D, r1, r2)]


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.parallel import batch, kernels
    from awebox_tpu_torch.parallel.refine import (average_power, make_refiner,
                                                  refine, wind_sweep_problem)
    from awebox_tpu_torch.ocp.structured import make_structured_derivs

    dev = torch.device('cuda')
    f32, f64 = torch.float32, torch.float64
    # the CPU reference computations run single-threaded: batched LAPACK LU
    # under several OpenMP threads has been seen to stall in containers
    torch.set_num_threads(1)

    # --- 1. device --------------------------------------------------------
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase('device', f'{torch.cuda.get_device_name(0)}; torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}; allow_tf32 matmul='
          f'{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}')

    # --- 2. build ---------------------------------------------------------
    t0 = time.time()
    lib_path = kernels.build_library(verbose=True)
    kernels.library()
    phase('build', f'{os.path.relpath(lib_path, HERE)} in {time.time() - t0:.1f} s')

    # --- 3. kernels vs plain at the main path's shapes --------------------
    trial = Trial(bench_options(), 'chip_smoke').build()
    ocp = trial.ocp
    n, m = ocp.vstruct.total, ocp.n_eq + ocp.n_ineq
    anchor = dict(np.load(ANCHOR))
    state, P64, lbw, ubw, free, u_refs = wind_sweep_problem(trial, anchor, B, device=dev)
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp)
    w, y, lam = state['w'], state['y'], state['lam']
    dv = tuple(vals_fn(w, y, lam, P64)) + tuple(J.to(f32) for J in jac_fn(w, P64)) \
        + (hess_fn(w, y, lam, P64).to(f32),)
    sys_ = batch.newton_system(state, dv, lbw, ubw, free)
    eq_a = batch.equilibrate(sys_['W0'], sys_['A'], sys_['D'], sys_['r1'],
                             sys_['r2'], free, 1e-8)
    delta = torch.full((B,), 1e-8, dtype=f64, device=dev)
    report = {}

    # K1: anchor-derived K(delta); the kernel rounds exactly as the plain
    # version (same f32 operations, no contraction), so the bound is 2 ulp
    args1 = (eq_a['W32'], eq_a['A32'], eq_a['Dr32'], eq_a['free32'], delta)
    Ks_k, kd_k = kernels.kkt_assemble_scaled(*args1)
    Ks_p, kd_p = kernels.kkt_assemble_scaled_plain(*args1)
    torch.cuda.synchronize()
    err1 = max(float((Ks_k - Ks_p).abs().max()), float((kd_k - kd_p).abs().max()))
    ulp = torch.finfo(f32).eps
    ok1 = bool(((Ks_k - Ks_p).abs() <= 2 * ulp * Ks_p.abs()).all()) \
        and bool(((kd_k - kd_p).abs() <= 2 * ulp * kd_p.abs()).all())
    require(ok1, f'K1 disagrees with its plain version: max abs {err1:.3e}')
    report['kkt_assemble_scaled'] = dict(
        max_abs_err=err1,
        ms=cuda_median_ms(lambda: kernels.kkt_assemble_scaled(*args1)),
        plain_ms=cuda_median_ms(lambda: kernels.kkt_assemble_scaled_plain(*args1)))
    phase('kernels', f'K1 kkt_assemble_scaled: max abs diff {err1:.3e} (bound 2 ulp '
          f'relative), {report["kkt_assemble_scaled"]["ms"]:.3f} ms vs plain '
          f'{report["kkt_assemble_scaled"]["plain_ms"]:.3f} ms')

    # K2+K3: factor and solve the anchor-derived Ks. LU ties may pick other
    # rows than cuSOLVER, so the factors are compared through P L U, which
    # must reproduce Ks as closely as cuSOLVER's does (within 10x of its
    # max deviation: f32 backward error of pivoted LU times the growth
    # factor), and solutions through their scaled residuals
    # ||Ks z - c|| / ||c|| (c = kd b), within 10x of each other. K3 alone is
    # held to the plain solve on cuSOLVER's factor: 1e-3 of max |x|, the
    # f32 forward error of triangular solves at cond(Ks) ~ 1e9 after the
    # Jacobi scaling.
    c = eq_a['b'].to(f32).contiguous()
    lu_k, piv_k = kernels.lu_factor_batched(Ks_p.clone())
    lu_p, piv_p = kernels.lu_factor_batched_plain(Ks_p)
    lu_p, piv_p = lu_p.contiguous(), piv_p.contiguous()   # cuSOLVER's is column-major
    x_k = kernels.lu_solve_batched(lu_k, piv_k, kd_p, c)
    x_p = kernels.lu_solve_batched_plain(lu_p, piv_p, kd_p, c)
    x_kp = kernels.lu_solve_batched(lu_p, piv_p, kd_p, c)
    torch.cuda.synchronize()

    def plu(lu, piv):
        P, L, U = torch.lu_unpack(lu, piv)
        return P @ L @ U
    dev_k = float((plu(lu_k, piv_k) - Ks_p).abs().max())
    dev_p = float((plu(lu_p, piv_p) - Ks_p).abs().max())
    require(dev_k <= 10 * max(dev_p, 1e-6), f'K2: |P L U - Ks| {dev_k:.3e} vs plain {dev_p:.3e}')

    def scaled_res(x):
        z = (x / kd_p).to(f64)
        cc = (kd_p * c).to(f64)
        r = (Ks_p.to(f64) @ z[:, :, None])[:, :, 0] - cc
        return (r.abs().amax(dim=1) / cc.abs().amax(dim=1)).cpu().numpy()
    res_k, res_p = scaled_res(x_k), scaled_res(x_p)
    require(np.isfinite(res_k).all() and np.isfinite(res_p).all(), 'K2+K3: non-finite residual')
    require((res_k <= 10 * np.maximum(res_p, 1e-7)).all(), f'K2+K3 residuals {res_k} vs plain {res_p}')
    err3 = float((x_kp - x_p).abs().max())
    require(err3 <= 1e-3 * float(x_p.abs().max()), f'K3: max |x - x_plain| {err3:.3e}')
    Ks_work = torch.empty_like(Ks_p)
    report['lu_factor_batched'] = dict(
        max_abs_err=float((plu(lu_k, piv_k) - plu(lu_p, piv_p)).abs().max()),
        ms=cuda_median_ms(lambda: kernels.lu_factor_batched(Ks_work),
                          setup=lambda: Ks_work.copy_(Ks_p)),
        plain_ms=cuda_median_ms(lambda: kernels.lu_factor_batched_plain(Ks_p)))
    report['lu_solve_batched'] = dict(
        max_abs_err=err3,
        ms=cuda_median_ms(lambda: kernels.lu_solve_batched(lu_p, piv_p, kd_p, c)),
        plain_ms=cuda_median_ms(lambda: kernels.lu_solve_batched_plain(lu_p, piv_p, kd_p, c)))
    phase('kernels', f'K2 lu_factor_batched: max |P L U - Ks| kernel {dev_k:.3e} vs '
          f'plain {dev_p:.3e} (max |Ks| {float(Ks_p.abs().max()):.3e}); '
          f'{report["lu_factor_batched"]["ms"]:.3f} ms vs plain '
          f'{report["lu_factor_batched"]["plain_ms"]:.3f} ms')
    phase('kernels', f'K3 lu_solve_batched: max |x - x_plain| {err3:.3e} (max |x| '
          f'{float(x_p.abs().max()):.3e}); K2+K3 scaled residual max {res_k.max():.3e} '
          f'vs plain {res_p.max():.3e}; {report["lu_solve_batched"]["ms"]:.3f} ms vs '
          f'plain {report["lu_solve_batched"]["plain_ms"]:.3f} ms')

    # the whole direction solve (K1-K3 + refinement + ladder) on the card
    # against the plain path on the CPU, on make_system-style random saddle
    # systems at n, m. In lane 0 variable 0 appears nowhere (zero row and
    # column of W0, zero column of A), so K(delta) pins it only through
    # delta: |dw_0| = |r1_0| / delta exceeds dw_cap until the ladder has
    # raised delta, and lane 0 is retried alone on the card. ok must agree
    # lane by lane, and the card's augmented residual (relative to the
    # right-hand side) must be within 10x of the CPU's: both are set by the
    # f32 factor's accuracy on these ill-conditioned random systems
    rng = np.random.default_rng(0)
    W0r, Ar, Dr, r1r, r2r = random_systems(rng, n, m, B)
    W0r[0, 0, :] = 0.
    W0r[0, :, 0] = 0.
    Ar[0, :, 0] = 0.
    freer = np.ones(n)
    host = [torch.as_tensor(a, dtype=f64) for a in (W0r, Ar, Dr, r1r, r2r, freer)]
    card = [t.to(dev) for t in host]
    factors_before = kernels.LAUNCHES['lu_factor_batched']
    out_c = batch._auglu_solve(*card[:5], card[5], n, 1e-8, 1e-8, 7, 100.)
    retries = kernels.LAUNCHES['lu_factor_batched'] - factors_before - 1
    out_h = batch._auglu_solve(*host[:5], host[5], n, 1e-8, 1e-8, 7, 100.)
    ok_c, ok_h = out_c[2].cpu().numpy(), out_h[2].numpy()
    require((ok_c == ok_h).all(), f'direction ok: card {ok_c}, cpu {ok_h}')
    require(retries >= 1, 'the ladder did not run')
    dw0_c, dw0_h = float(out_c[0][0, 0]), float(out_h[0][0, 0])
    require(abs(dw0_c - dw0_h) <= 1e-6 * abs(dw0_h), f'ladder lane dw_0: card {dw0_c}, cpu {dw0_h}')

    def aug_res(W0, A, D, r1, r2, dw, dnu):
        rn = 1.0 / np.clip(np.abs(A).max(axis=2), 1e-10, 1e10)
        A_e = A * rn[:, :, None]
        dnu_e = dnu / rn
        r_w = r1 - (np.einsum('bij,bj->bi', W0 + 1e-8 * np.eye(n), dw)
                    + np.einsum('bji,bj->bi', A_e, dnu_e))
        r_nu = -(r2 * rn) - (np.einsum('bij,bj->bi', A_e, dw) - (D * rn * rn + 1e-8) * dnu_e)
        scale = np.maximum(np.abs(r1).max(axis=1), np.abs(r2).max(axis=1))
        return np.maximum(np.abs(r_w).max(axis=1), np.abs(r_nu).max(axis=1)) / scale
    ar_c = aug_res(W0r, Ar, Dr, r1r, r2r, out_c[0].cpu().numpy(), out_c[1].cpu().numpy())
    ar_h = aug_res(W0r, Ar, Dr, r1r, r2r, out_h[0].numpy(), out_h[1].numpy())
    require(bool(torch.isfinite(out_c[0]).all() and torch.isfinite(out_h[0]).all()),
            'direction: non-finite dw')
    regular = ok_c.copy()
    regular[0] = False   # lane 0 solved a laddered K(delta)
    require((ar_c[regular] <= 10 * np.maximum(ar_h[regular], 1e-9)).all(),
            f'direction residuals: card {ar_c}, cpu {ar_h}')
    phase('kernels', f'direction solve, random systems: ok {int(ok_c.sum())}/{B} on both; '
          f'augmented residual card max {ar_c[regular].max():.3e}, cpu max '
          f'{ar_h[regular].max():.3e}; ladder lane: {retries} retries on the card, '
          f'dw_0 card {dw0_c:.6e}, cpu {dw0_h:.6e}')

    # K4: random f64 states with active bounds; same f64 operations in the
    # same order, so the bound is 1e-14 relative
    g = torch.Generator(device='cpu').manual_seed(1)
    ni, ne = ocp.n_ineq, ocp.n_eq
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=f64).to(dev)
    st = {k: state[k].clone() for k in ('w', 's', 'y', 'lam', 'zl', 'zu', 'mu')}
    st['w'] = torch.where(torch.isfinite(lbw) & (rnd(B, n) > 1.), lbw + 1e-9, st['w'])
    st['mu'] = torch.full((B,), 1e-5, dtype=f64, device=dev)
    direction4 = (rnd(B, n), rnd(B, ne), rnd(B, ni) * 1e-3, rnd(B, ni), rnd(B, n), rnd(B, n))
    ok4 = rnd(B) > -1.
    err_d4, err_k4 = rnd(B).abs(), rnd(B).abs()
    args4 = (st, direction4, ok4, err_d4, err_k4, lbw, ubw, 0.99, 0.4, 1e-8)
    o_k = kernels.advance_state(*args4)
    o_p = kernels.advance_state_plain(*args4)
    torch.cuda.synchronize()
    err4, rel4 = 0., 0.
    for k in o_p:
        d = (o_k[k] - o_p[k]).abs()
        err4 = max(err4, float(d.max()))
        rel4 = max(rel4, float((d / o_p[k].abs().clamp(min=1e-300)).max()))
    require(rel4 <= 1e-14, f'K4 relative error {rel4:.3e}')
    report['advance_state'] = dict(
        max_abs_err=err4,
        ms=cuda_median_ms(lambda: kernels.advance_state(*args4)),
        plain_ms=cuda_median_ms(lambda: kernels.advance_state_plain(*args4)))
    phase('kernels', f'K4 advance_state: max rel diff {rel4:.3e} (bound 1e-14), '
          f'{report["advance_state"]["ms"]:.3f} ms vs plain '
          f'{report["advance_state"]["plain_ms"]:.3f} ms')

    # one iteration from the anchor on the card against the plain path on
    # the CPU, 2 lanes: the iterates agree to 1e-6 of the step (the f32
    # factors differ by pivot ties and rounding; two f64 refinement sweeps
    # bring both directions to the same f64 solution within that)
    state_h, P64_h, lbw_h, ubw_h, free_h, _ = wind_sweep_problem(trial, anchor, 2)
    sel = torch.tensor([0, B - 1], device=dev)
    it_c = make_refiner(ocp, lbw, ubw, free)(_take_lanes(state, sel),
                                             _take_lanes(P64, sel))
    it_h = make_refiner(ocp, lbw_h, ubw_h, free_h)(state_h, P64_h)
    step = float((it_h['w'] - state_h['w']).abs().max())
    dw_gap = float((it_c['w'].cpu() - it_h['w']).abs().max())
    require(dw_gap <= 1e-6 * step, f'one iteration: |w diff| {dw_gap:.3e}, step {step:.3e}')
    phase('kernels', f'one iteration card vs cpu plain: max |w diff| {dw_gap:.3e} '
          f'(step {step:.3e})')

    # --- 4. the slice -----------------------------------------------------
    kernels.reset_launch_counts()
    res = refine(ocp, state, P64, lbw, ubw, free, tol=1e-5, verify_tol=1e-4,
                 max_iter=100, kappa_mu=0.4, time_pieces=True)
    launches = dict(kernels.LAUNCHES)
    it = res['n_iter']
    conv = res['converged'].cpu().numpy()
    latched = res['latched'].cpu().numpy()
    eq_max = float(res['eq_res'].max())
    powers = average_power(ocp, res['state']['w'], P64).cpu().numpy()
    pieces = {k: 1e3 * v / it for k, v in res['times'].items()}
    phase('slice', f'B={B} lanes, u_ref {u_refs[0]:.2f}..{u_refs[-1]:.2f} m/s: '
          f'{it} iterations, {1e3 * res["seconds"] / it:.1f} ms/iter '
          f'(vals {pieces["vals"]:.1f}, jac {pieces["jac"]:.1f}, '
          f'hess {pieces["hess"]:.1f}, direction {pieces["direction"]:.1f} ms), '
          f'latched {int(latched.sum())}/{B}, converged {int(conv.sum())}/{B}, '
          f'max f64 eq {eq_max:.2e}, P_avg {powers.min() / 1e3:.2f}..'
          f'{powers.max() / 1e3:.2f} kW, {conv.sum() / res["seconds"]:.3f} solves/s')
    require(conv.all(), f'unconverged lanes: {np.where(~conv)[0]}')
    require(np.isfinite(powers).all(), f'non-finite average power {powers}')

    # --- 5. path check ----------------------------------------------------
    require(all(v > 0 for v in launches.values()), f'a kernel did not run in the slice: {launches}')
    require(all(v.is_cuda for v in res['state'].values()), 'the state left the card')
    phase('path', f'kernel launches in the slice run: {launches}')

    sources = {'kkt_assemble_scaled': 'awebox_tpu/parallel/batch.py:409',
               'lu_factor_batched': 'awebox_tpu/parallel/batch.py:414',
               'lu_solve_batched': 'awebox_tpu/parallel/batch.py:416',
               'advance_state': 'awebox_tpu/parallel/batch.py:449'}
    print(json.dumps({'kernels': [
        dict(name=k, route='cuda', source='awebox_tpu_torch/csrc/auglu.cu',
             replaces=sources[k], launches=launches[k], **report[k])
        for k in sources]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def _take_lanes(tree, sel):
    if isinstance(tree, dict):
        return {k: _take_lanes(v, sel) for k, v in tree.items()}
    return tree[sel]


if __name__ == '__main__':
    sys.exit(main())
