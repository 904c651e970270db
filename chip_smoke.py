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
              times of both (median of 25 runs, CUDA events): K1 newton_kkt
              (the Newton system and K(delta_w)) bit for bit and K4 ip_step
              (the direction from the solution and the step) at its stated
              tolerances, each at B = 1, 16 and 128 and on random systems
              with non-finite J/H entries, pinned variables and infinite
              bounds; the retry assembly bit for bit; the LU factor K2 in
              both variants, each where lu_factor_geometry takes it: the
              cluster kernel at N=543, B = 1, 16 and 128, the unblocked one
              at N=1055 B=2; the LU solve K3 on each of those shapes, on K2's
              factor and on cuSOLVER's; every kernel and the library calls
              (cuSOLVER's getrf, torch.linalg.lu_solve) are also timed queued
              behind a device sleep, which hides the host's dispatch, beside
              an empty kernel's time (the launch floor); each kernel's bound
              (bytes over HBM rate or operations over the CUDA cores' peak)
              is computed from its shapes; the aten operations and the time
              of one direction call
  4. slice    Trial(bench_options()).build(), 16 lanes with u_ref in
              9.5..10.5 m/s from tests/artifacts/bench_anchor_nk4_d3.npz,
              iterated to convergence (at most 100 iterations); every lane
              must latch KKT error <= 1e-5 and pass the f64 dynamics
              residual check <= 1e-4
  5. path     every kernel of the path launched during the slice run: K1
              and K4 once per iteration, the retry assembly once per ladder
              retry, every factor through the cluster variant, three solves
              per factor; no plain piece of the Newton system or of the step
              called; state on the card

Any failure raises and exits non-zero. Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero before printing a
result. Run from the repository root:

    python3 chip_smoke.py
"""
import importlib.util
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


def cuda_median_ms(fn, setup=None, n=N_TIMED, queued=False):
    """Median device time of fn() in ms over n runs, each bracketed by CUDA
    events after an untimed warm-up; setup() runs untimed before each. With
    queued, the events and fn's launches are enqueued behind a ~0.1 s
    device sleep, so the time is the card's alone even where fn's host side
    (dispatch, a library's per-matrix calls) is slower than its device work."""
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
        if queued:
            torch.cuda._sleep(200_000_000)
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
    from awebox_tpu_torch.probes.direction_ops import count_and_time

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
    N = n + m
    anchor = dict(np.load(ANCHOR))
    state, P64, lbw, ubw, free, u_refs = wind_sweep_problem(trial, anchor, B, device=dev)
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp)
    w, y, lam = state['w'], state['y'], state['lam']
    dv = tuple(vals_fn(w, y, lam, P64)) + tuple(J.to(f32) for J in jac_fn(w, P64)) \
        + (hess_fn(w, y, lam, P64).to(f32),)
    delta = torch.full((B,), 1e-8, dtype=f64, device=dev)
    report = {}

    def bound(nbytes, ops=0, peak=67e12):
        """The least time the card could take for the work, in ms, and what
        sets it: the larger of the bytes over HBM3's 3.35 TB/s and the
        operations over their peak (H100 SXM data sheet, at 700 W): f32 on
        the CUDA cores 67 TFLOP/s, f64 34 TFLOP/s."""
        t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / peak * 1e3
        return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    # the launch floor: an empty kernel, as called and queued
    floor = dict(ms=cuda_median_ms(kernels.launch_floor),
                 queued_ms=cuda_median_ms(kernels.launch_floor, queued=True))
    phase('kernels', f'launch floor (empty kernel): {floor["ms"]:.4f} ms, queued '
          f'{floor["queued_ms"]:.4f} ms')

    def lanes(tree, Bk):
        """The B anchor lanes repeated (or cut) to Bk lanes."""
        if isinstance(tree, dict):
            return {k: lanes(v, Bk) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(lanes(v, Bk) for v in tree)
        rep = (Bk + B - 1) // B
        return tree.repeat(rep, *([1] * (tree.dim() - 1)))[:Bk].contiguous()

    # K1 newton_kkt: the Newton system, its equilibration and K(delta_w),
    # bit for bit against the plain composition (the same operations in the
    # same order; r1 through the same cuBLAS product), on the anchor's
    # systems at B = 1, 16 and 128 and on random systems with non-finite
    # J/H entries, pinned variables and infinite bounds
    def hold_k1(tag, args):
        before = kernels.LAUNCHES['newton_kkt']
        out = kernels.newton_kkt(*args, 1e-8, 1e-8)
        ref = kernels.newton_kkt_plain(*args, 1e-8, 1e-8)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['newton_kkt'] == before + 1, f'K1 {tag}: no launch')
        differ = [k for k in ref if not torch.equal(out[k], ref[k])]
        require(not differ, f'K1 {tag}: {differ} differ from the plain composition')
        k1 = lambda: kernels.newton_kkt(*args, 1e-8, 1e-8)
        state_, dv_ = args[0], args[1]
        ins = [dv_[k] for k in range(1, 7)] + [state_[k] for k in ('w', 's', 'y', 'lam', 'zl',
                                                                    'zu', 'mu')] + list(args[2:])
        # bound_ms counts the outputs as this design writes them, W0 and A'
        # as f64 images for the refinement's f64 products; bound_f32_images_ms
        # counts those two at the 4 bytes of the f32 values they hold
        b_, by_ = bound(nbytes(*ins, *out.values()))
        b32, _ = bound(nbytes(*ins, *out.values()) - 4 * (out['W64'].numel() + out['A64'].numel()))
        rec = dict(max_abs_err=0.0, ms=cuda_median_ms(k1), queued_ms=cuda_median_ms(k1, queued=True),
                   plain_ms=cuda_median_ms(lambda: kernels.newton_kkt_plain(*args, 1e-8, 1e-8)),
                   bound_ms=b_, bound_by=by_, bound_f32_images_ms=b32, library_ms=None,
                   launch_floor_ms=floor['ms'], launch_floor_queued_ms=floor['queued_ms'])
        phase('kernels', f'K1 newton_kkt {tag}: {len(ref)} outputs bit for bit; {rec["ms"]:.4f} ms, '
              f'queued {rec["queued_ms"]:.4f} ms, vs plain {rec["plain_ms"]:.3f} ms; bound '
              f'{b_:.4f} ms ({by_}; W0 and A\' in f32: {b32:.4f} ms)')
        return out, ref, rec

    # the input generators and the tolerances of K4 are the kernel tests' own
    # (loaded by path: an installed package may own the name 'tests')
    spec = importlib.util.spec_from_file_location(
        'test_torch_kernels', os.path.join(HERE, 'tests', 'test_torch_kernels.py'))
    ktests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ktests)
    newton_inputs, step_gaps, step_solution, step_within_tolerance = (
        ktests.newton_inputs, ktests.step_gaps, ktests.step_solution, ktests.step_within_tolerance)
    k1_at, k1_out = {}, {}
    for Bk in (1, B, 8 * B):
        args = (lanes(state, Bk), lanes(dv, Bk), lbw, ubw, free)
        k1_out[Bk], ref_a, k1_at[f'B={Bk}'] = hold_k1(f'anchor B={Bk}', args)
        if Bk == B:
            ref16 = ref_a
    rand_args = newton_inputs(B=B, n=n, n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, seed=3, device=dev)
    _, rand_ref, k1_at['random B=16'] = hold_k1('random B=16', rand_args)
    report['newton_kkt'] = dict(k1_at[f'B={B}'], at=k1_at)

    # the retry assembly: K(delta) of the lanes a ladder retry takes, from
    # the f32 W0 and A'; bit for bit, at three deltas
    f32w = lambda t: t.to(f32).contiguous()
    args1 = (f32w(ref16['W64']), f32w(ref16['A64']), ref16['Dr32'],
             free.to(f32).contiguous(), 10.0 ** torch.linspace(-8, 0, B, dtype=f64, device=dev))
    Ks_k, kd_k = kernels.kkt_assemble_scaled(*args1)
    Ks_r, kd_r = kernels.kkt_assemble_scaled_plain(*args1)
    torch.cuda.synchronize()
    require(torch.equal(Ks_k, Ks_r) and torch.equal(kd_k, kd_r),
            'the retry assembly disagrees with its plain version')
    k1r = lambda: kernels.kkt_assemble_scaled(*args1)
    b1, by1 = bound(nbytes(*args1, Ks_k, kd_k))
    report['kkt_assemble_scaled'] = r1 = dict(
        max_abs_err=0.0, ms=cuda_median_ms(k1r), queued_ms=cuda_median_ms(k1r, queued=True),
        plain_ms=cuda_median_ms(lambda: kernels.kkt_assemble_scaled_plain(*args1)),
        bound_ms=b1, bound_by=by1, library_ms=None)
    phase('kernels', f'retry assembly kkt_assemble_scaled: bit for bit at delta 1e-8..1, '
          f'{r1["ms"]:.4f} ms, queued {r1["queued_ms"]:.4f} ms, vs plain '
          f'{r1["plain_ms"]:.3f} ms; bound {b1:.4f} ms ({by1})')
    Ks_p, kd_p = ref16['Ks'], ref16['kd']

    # K2+K3: factor and solve the anchor-derived Ks. LU ties may pick other
    # rows than cuSOLVER, so the factors are compared through P L U, which
    # must reproduce Ks as closely as cuSOLVER's does (within 10x of its
    # max deviation: f32 backward error of pivoted LU times the growth
    # factor), and solutions through their scaled residuals
    # ||Ks z - c|| / ||c|| (c = kd b), within 10x of each other. K3 is held
    # on each factor, K2's and cuSOLVER's, to the plain solve on the same
    # factor: 1e-3 of max |x|, the f32 forward error of triangular solves at
    # cond(Ks) ~ 1e9 after the Jacobi scaling.
    # K2 has two variants, chosen by N (kernels.lu_factor_geometry): the
    # cluster kernel at the slice's N, held at B = 1, 16 and 128 (the B=16
    # systems repeated), and the unblocked kernel, held on a random saddle
    # system of the n_k=8 size N=1055 at B=2, which only it takes.
    # cuSOLVER's time as called moves between runs with the host's load
    # (at N >= 512 PyTorch calls its getrf once per lane), so the factors
    # and the solves are timed queued too.
    c = ref16['b'].to(f32).contiguous()
    geom = kernels.lu_factor_geometry(N)
    require(geom.variant == 'cluster', f'N={N} does not take the cluster variant: {geom}')
    max_clusters = kernels.lu_cluster_max_active(geom)
    phase('kernels', f'K2 geometry at N={N}: {geom}; {max_clusters} clusters run at once; '
          f'K3 geometry: {kernels.lu_solve_geometry(N)}')

    def plu(lu, piv):
        P, L, U = torch.lu_unpack(lu, piv)
        return P @ L @ U

    def scaled_res(Ks, kd, c, x):
        z = (x / kd).to(f64)
        cc = (kd * c).to(f64)
        r = (Ks.to(f64) @ z[:, :, None])[:, :, 0] - cc
        return (r.abs().amax(dim=1) / cc.abs().amax(dim=1)).cpu().numpy()

    def hold_k3(tag, lu, piv, kd, c):
        """K3 on one factor against the plain solve on the same factor;
        returns K3's x and its max deviation."""
        before = kernels.LAUNCHES['lu_solve_batched']
        x_k = kernels.lu_solve_batched(lu, piv, kd, c)
        x_p = kernels.lu_solve_batched_plain(lu, piv, kd, c)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['lu_solve_batched'] == before + 1, f'K3 {tag}: no launch')
        err = float((x_k - x_p).abs().max())
        require(err <= 1e-3 * float(x_p.abs().max()),
                f'K3 {tag}: max |x - x_plain| {err:.3e}, max |x| {float(x_p.abs().max()):.3e}')
        return x_k, err

    def hold_k2(tag, Ks, kd, c, variant):
        """Factor Ks with the kernel, which must take ``variant``, and with
        cuSOLVER, hold K3 on both factors, apply the gates above, and time
        both factors and both solves. Returns K2's and K3's records."""
        B_, N_ = Ks.shape[0], Ks.shape[1]
        before = kernels.LAUNCHES[f'lu_factor_{variant}']
        lu_k, piv_k = kernels.lu_factor_batched(Ks.clone())
        require(kernels.LAUNCHES[f'lu_factor_{variant}'] == before + 1,
                f'K2 {tag}: the {variant} variant did not run')
        lu_raw, piv_raw = kernels.lu_factor_batched_plain(Ks)   # cuSOLVER's is column-major
        lu_p, piv_p = lu_raw.contiguous(), piv_raw.contiguous()
        x_k, err_k = hold_k3(f'{tag} on the {variant} factor', lu_k, piv_k, kd, c)
        x_kp, err_p = hold_k3(f'{tag} on cuSOLVER\'s factor', lu_p, piv_p, kd, c)
        x_p = kernels.lu_solve_batched_plain(lu_p, piv_p, kd, c)
        torch.cuda.synchronize()
        dev_k = float((plu(lu_k, piv_k) - Ks).abs().max())
        dev_p = float((plu(lu_p, piv_p) - Ks).abs().max())
        require(dev_k <= 10 * max(dev_p, 1e-6),
                f'K2 {variant} {tag}: |P L U - Ks| {dev_k:.3e} vs plain {dev_p:.3e}')
        res_k, res_p = scaled_res(Ks, kd, c, x_k), scaled_res(Ks, kd, c, x_p)
        res_kp = scaled_res(Ks, kd, c, x_kp)
        require(np.isfinite(res_k).all() and np.isfinite(res_p).all() and np.isfinite(res_kp).all(),
                f'K2+K3 {variant} {tag}: non-finite residual')
        require((res_k <= 10 * np.maximum(res_p, 1e-7)).all(),
                f'K2+K3 {variant} {tag}: residuals {res_k} vs plain {res_p}')
        require((res_kp <= 10 * np.maximum(res_p, 1e-7)).all(),
                f'K3 on cuSOLVER\'s factor {tag}: residuals {res_kp} vs plain {res_p}')
        work = torch.empty_like(Ks)
        factor = lambda: kernels.lu_factor_batched(work)
        refill = lambda: work.copy_(Ks)
        plain = lambda: kernels.lu_factor_batched_plain(Ks)   # one library call, lu_factor_ex
        k2_bound, k2_by = bound(8 * B_ * N_ * N_ + 4 * B_ * N_, 2 / 3 * B_ * N_ ** 3)
        k2 = dict(max_abs_err=float((plu(lu_k, piv_k) - plu(lu_p, piv_p)).abs().max()),
                  ms=cuda_median_ms(factor, setup=refill),
                  plain_ms=cuda_median_ms(plain),
                  queued_ms=cuda_median_ms(factor, setup=refill, queued=True),
                  plain_queued_ms=cuda_median_ms(plain, queued=True),
                  bound_ms=k2_bound, bound_by=k2_by)
        k2['library_ms'], k2['library_queued_ms'] = k2['plain_ms'], k2['plain_queued_ms']
        # K3 and the library timed on cuSOLVER's factor, each in its own layout
        rhs = (kd * c)[:, :, None]
        solve = lambda: kernels.lu_solve_batched(lu_p, piv_p, kd, c)
        library = lambda: torch.linalg.lu_solve(lu_raw, piv_raw, rhs)
        k3_bound, k3_by = bound(4 * B_ * N_ * N_ + 16 * B_ * N_, 2 * B_ * N_ * N_)
        k3 = dict(max_abs_err=max(err_k, err_p),
                  ms=cuda_median_ms(solve), queued_ms=cuda_median_ms(solve, queued=True),
                  plain_ms=cuda_median_ms(lambda: kernels.lu_solve_batched_plain(lu_p, piv_p, kd, c)),
                  library_ms=cuda_median_ms(library),
                  library_queued_ms=cuda_median_ms(library, queued=True),
                  bound_ms=k3_bound, bound_by=k3_by)
        phase('kernels', f'K2 {variant} {tag}: max |P L U - Ks| kernel {dev_k:.3e} vs plain '
              f'{dev_p:.3e} (max |Ks| {float(Ks.abs().max()):.3e}); K2+K3 scaled residual '
              f'max {res_k.max():.3e} vs plain {res_p.max():.3e}; {k2["ms"]:.3f} ms vs '
              f'plain {k2["plain_ms"]:.3f} ms; queued {k2["queued_ms"]:.3f} ms vs '
              f'plain {k2["plain_queued_ms"]:.3f} ms; bound {k2_bound:.4f} ms ({k2_by})')
        phase('kernels', f'K3 {tag}: max |x - x_plain| on the {variant} factor {err_k:.3e}, '
              f'on cuSOLVER\'s {err_p:.3e} (max |x| {float(x_p.abs().max()):.3e}), residual on '
              f'cuSOLVER\'s factor max {res_kp.max():.3e}; {k3["ms"]:.4f} ms, queued '
              f'{k3["queued_ms"]:.4f} ms; plain {k3["plain_ms"]:.3f} ms; torch.linalg.lu_solve '
              f'{k3["library_ms"]:.3f} ms, queued {k3["library_queued_ms"]:.3f} ms; bound '
              f'{k3_bound:.4f} ms ({k3_by})')
        return k2, k3

    cluster_at, solve_at = {}, {}
    for Bk in (1, B, 8 * B):
        rep = (Bk + B - 1) // B
        args2 = [t.repeat(rep, *([1] * (t.dim() - 1)))[:Bk].contiguous() for t in (Ks_p, kd_p, c)]
        cluster_at[f'B={Bk}'], solve_at[f'N={N} B={Bk}'] = hold_k2(f'N={N} B={Bk}', *args2,
                                                                     'cluster')
    rng = np.random.default_rng(1)
    n8, m8 = 540, 515
    sys8 = [torch.as_tensor(a, dtype=f64, device=dev) for a in random_systems(rng, n8, m8, 2)]
    eq8 = kernels.equilibrate(*sys8, torch.ones(n8, dtype=f64, device=dev), 1e-8)
    Ks8, kd8 = kernels.kkt_assemble_scaled(eq8['W32'], eq8['A32'], eq8['Dr32'], eq8['free32'],
                                           torch.full((2,), 1e-8, dtype=f64, device=dev))
    require(kernels.lu_factor_geometry(n8 + m8).variant == 'unblocked',
            'N=1055 does not take the unblocked variant')
    k2_8, solve_at[f'N={n8 + m8} B=2'] = hold_k2(
        f'N={n8 + m8} B=2', Ks8, kd8, eq8['b'].to(f32).contiguous(), 'unblocked')
    report['lu_factor_unblocked'] = dict(k2_8, N=n8 + m8, B=2)
    report['lu_factor_cluster'] = dict(cluster_at[f'B={B}'], at=cluster_at,
                                       max_active_clusters=max_clusters)
    report['lu_solve_batched'] = dict(solve_at[f'N={N} B={B}'], at=solve_at)

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

    # K4 ip_step: the direction from the solution and the step, against its
    # plain version at tests/test_torch_kernels.py's TOL_STEP / TOL_DS (JI dw
    # sums in another order): on the anchor's solutions at B = 1, 16 and 128
    # and on random solutions (a NaN entry, a failed lane) of the random
    # systems above
    def hold_k4(tag, x, ok, sys_, args):
        n_ineq = args[0]['s'].shape[1]
        ds_k, ds_p = (torch.empty(x.shape[0], n_ineq, dtype=f64, device=dev) for _ in range(2))
        step = (x, ok, sys_['rn'], sys_['r1']) + tuple(args) + (0.99, 0.4, 1e-8)
        before = kernels.LAUNCHES['ip_step']
        o_k = kernels.ip_step(*step, ds_out=ds_k)
        o_p = kernels.ip_step_plain(*step, ds_out=ds_p)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['ip_step'] == before + 1, f'K4 {tag}: no launch')
        gaps = step_gaps(o_k, o_p, args[0], ds_k, ds_p, x, ok, args[1], args[4])
        require(step_within_tolerance(gaps), f'K4 {tag}: gaps over tolerance {gaps}')
        # past the gate, a NaN difference is one of entries NaN on both sides
        err = max(float((o_k[k] - o_p[k]).abs().nan_to_num().max()) for k in o_p)
        k4 = lambda: kernels.ip_step(*step)
        st, dv_ = args[0], args[1]
        ins = [x, ok, sys_['rn'], sys_['r1'], dv_[2], dv_[3], dv_[5]] + list(st.values()) \
            + list(args[2:])
        b_, by_ = bound(nbytes(*ins, *o_k.values()), 2 * x.shape[0] * n_ineq * free.numel(), 34e12)
        rec = dict(max_abs_err=err, ms=cuda_median_ms(k4), queued_ms=cuda_median_ms(k4, queued=True),
                   plain_ms=cuda_median_ms(lambda: kernels.ip_step_plain(*step)),
                   bound_ms=b_, bound_by=by_, library_ms=None, gaps=gaps,
                   launch_floor_ms=floor['ms'], launch_floor_queued_ms=floor['queued_ms'])
        phase('kernels', f'K4 ip_step {tag}: gaps over tolerance max {max(gaps.values()):.3f} '
              f'(ds {gaps["ds"]:.3f}), max abs diff {err:.3e}; {rec["ms"]:.4f} ms, queued '
              f'{rec["queued_ms"]:.4f} ms, vs plain {rec["plain_ms"]:.3f} ms; bound {b_:.5f} ms '
              f'({by_}); launch floor queued {floor["queued_ms"]:.4f} ms')
        return rec

    k4_at = {}
    for Bk in (1, B, 8 * B):
        sys_k = k1_out[Bk]
        st_k = {k: lanes(state, Bk)[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu', 'mu')}
        x_k, ok_k = batch._ladder_solve(sys_k, free, n, 1e-8, 7, 100.)
        k4_at[f'B={Bk}'] = hold_k4(f'anchor B={Bk}', x_k, ok_k, sys_k,
                                   (st_k, lanes(dv, Bk), lbw, ubw, free))
    x_r, ok_r = step_solution(B, N, device=dev)
    k4_at['random B=16'] = hold_k4('random B=16', x_r, ok_r, rand_ref, rand_args)
    report['ip_step'] = dict(k4_at[f'B={B}'], at=k4_at)

    # aten operations one direction call dispatches on the card, and its time
    _, direction = batch.make_ip_step(ocp, kappa_mu=0.4)
    n_ops, dir_ms = count_and_time(lambda: direction(state, dv, lbw, ubw, free), N_TIMED)
    dir_ms = sorted(dir_ms)[N_TIMED // 2]
    phase('kernels', f'one direction call at B={B}: {n_ops} aten ops dispatched, '
          f'{dir_ms:.3f} ms (host clock, synchronized, median of {N_TIMED})')

    # one iteration from the anchor on the card against the plain path on
    # the CPU, 2 lanes: the iterates agree to 1e-6 of the step (the f32
    # factors differ by pivot ties and rounding; two f64 refinement sweeps
    # bring both directions to the same f64 solution within that)
    state_h, P64_h, lbw_h, ubw_h, free_h, _ = wind_sweep_problem(trial, anchor, 2,
                                                                 device='cpu')
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
    # the plain pieces of the Newton system and of the step are counted
    # while the slice runs: on the card none may run
    plain_calls = {k: 0 for k in ('newton_system', 'equilibrate', 'kkt_assemble_scaled_plain',
                                  'newton_kkt_plain', 'advance_state', 'ip_step_plain')}
    saved = {k: getattr(kernels, k) for k in plain_calls}

    def counted(name):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return saved[name](*args, **kwargs)
        return call
    for k in plain_calls:
        setattr(kernels, k, counted(k))
    kernels.reset_launch_counts()
    try:
        res = refine(ocp, state, P64, lbw, ubw, free, tol=1e-5, verify_tol=1e-4,
                     max_iter=100, kappa_mu=0.4, time_pieces=True)
    finally:
        for k, fn in saved.items():
            setattr(kernels, k, fn)
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
    # at N=543 every factor takes the cluster variant; the unblocked one
    # serves lanes no cluster holds and is held above at N=1055. The retry
    # assembly runs once per delta-ladder retry, a factor beyond the one per
    # iteration: the slice may need none; it is held above, and on the card
    # in the direction solve's ladder lane
    on_path = [k for k in launches if k not in ('lu_factor_unblocked', 'kkt_assemble_scaled')]
    require(all(launches[k] > 0 for k in on_path), f'a kernel did not run in the slice: {launches}')
    require(launches['newton_kkt'] == it and launches['ip_step'] == it,
            f'K1 and K4 did not run once per iteration ({it}): {launches}')
    require(launches['kkt_assemble_scaled'] == launches['lu_factor_batched'] - it,
            f'the retry assembly did not run once per retry: {launches}')
    require(not any(plain_calls.values()), f'plain pieces ran in the slice: {plain_calls}')
    require(launches['lu_factor_cluster'] == launches['lu_factor_batched'],
            f'a factor of the slice did not take the cluster variant: {launches}')
    # every attempt solves once and refines twice on its factor
    require(launches['lu_solve_batched'] == 3 * launches['lu_factor_batched'],
            f'the slice did not solve three times per factor: {launches}')
    require(all(v.is_cuda for v in res['state'].values()), 'the state left the card')
    phase('path', f'kernel launches in the slice run: {launches}; plain pieces called: '
          f'{plain_calls}')

    sources = {'newton_kkt': 'awebox_tpu/parallel/batch.py:154',
               'kkt_assemble_scaled': 'awebox_tpu/parallel/batch.py:409',
               'lu_factor_cluster': 'awebox_tpu/parallel/batch.py:414',
               'lu_factor_unblocked': 'awebox_tpu/parallel/batch.py:414',
               'lu_solve_batched': 'awebox_tpu/parallel/batch.py:416',
               'ip_step': 'awebox_tpu/parallel/batch.py:189'}
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
