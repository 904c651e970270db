#!/usr/bin/env python3
"""Smoke test of awebox_tpu_torch on one CUDA card.

Drives the port's main path, the batched wind-sweep refinement of the
Ampyx AP2 3-DOF power cycle (n_k=4, d=3: n=280 variables, m=263
constraints, a 543x543 augmented KKT system per lane), the same sweep on
the n_k=8 grid (n=540, m=515, 1055x1055), and the cold homotopy solve of
the configuration through Trial.optimize (at n_k=4, and capped at n_k=18:
n=1190, m=1145, 2335x2335), of the 6-DOF kite (n_k=4, capped: n=569,
m=556, 1125x1125) and of the eight further configurations of the
reference's end-to-end matrix (capped: n = 166 .. 516, K of 317 .. 1017),
through its public entry points, and checks the hand-written CUDA kernels
on the way:

  1. device   the card (nvidia-smi name and power limit), torch/CUDA
              versions; TF32 off for matmul and cuDNN
  2. build    compile awebox_tpu_torch/csrc/auglu.cu with nvcc (sm_90a)
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shapes, on anchor-derived and random systems, with the
              times of both (median of N_TIMED = 7 runs, CUDA events): K1 newton_kkt
              (the Newton system and K(delta_w), Jacobi-scaled for the LU
              factor and unscaled for the QR factor) bit for bit and K4 ip_step
              (the direction from the solution and the step) at its stated
              tolerances, each at B = 1, 16 and 128 and on random systems
              with non-finite J/H entries, pinned variables and infinite
              bounds; the retry assemblies bit for bit at N=543 and
              N=1055 (B=16); the LU factor K2 in
              both variants, each where lu_factor_geometry takes it: the
              cluster kernel at N=543, B = 1, 16 and 128, the blocked one
              at N=1055, B = 2 and 16, with a singular and a NaN lane; the
              LU solve K3 on each of those shapes, on K2's factor and on
              cuSOLVER's; the QR path's kernels: K5 ruiz_scale bit for bit
              in its one launch (a cluster per lane; its mode and cluster
              size printed) at N=543, B = 1, 16 and 128 (a NaN row and an
              inf entry included) and N=1055, B = 2 and 16, K6
              qr_factor_batched in both variants (the cluster kernel at
              N=543, B = 1, 16 and 128, the blocked one at N=1055, B = 2 and
              16, with a singular and a NaN lane) by |diag R| and by the
              solve, K7 qr_solve_batched on K6's factor and on cuSOLVER's
              geqrf factor by its residual and by the guarded refinement
              sweep's result; every kernel and the library calls (cuSOLVER's
              getrf and geqrf, torch.linalg.lu_solve, torch.ormqr with
              solve_triangular) are also timed queued
              behind a device sleep, which hides the host's dispatch, beside
              an empty kernel's time (the launch floor); each kernel's bound
              (bytes over HBM rate or operations over the card's peak)
              is computed from its shapes; the aten operations and the time
              of one direction call with each factor; the block and condensed
              KKT modes' kernels: K8 block_factor and K9 block_solve on the
              anchor's frames at B = 1, 2, 16 and 128 (and the n_k=8 anchor's at
              B=16, in phase 7), K10 chol_factor_batched in its cluster
              variant (its geometry and the clusters that run at once
              printed) and K11 chol_solve_batched on the anchor's condensed
              M (n=280, B = 1, 2 and 16; n=540, B=16 in phase 7) and K10's
              stream variant (a cluster of 16 a lane, the lane in the L2)
              with K11 on random SPD matrices at n=700 (B = 4, 2 and 1) and
              n = 555, 670, 876 and 1190 (B=1; the n_k=18 path's own M,
              n=1190, in phase 9), each with an indefinite and a NaN lane
              where B > 2,
              and K4's advance_state bit for bit; K12 lu_factor_f64 and K13
              lu_solve_f64, the host solver's f64 LU, on its augmented K at
              the anchor (N=543, B = 1 and 16) and on random saddle systems
              (N=37, B=4; N = 1055, 1311, 1823 and 2335, B=1; the n_k=18
              path's own K, N=2335, in phase 9), with a singular and a NaN
              lane; each beside its bound, its
              plain version and a library yardstick
  4. slice    Trial(bench_options()).build(), 16 lanes with u_ref in
              9.5..10.5 m/s from tests/artifacts/bench_anchor_nk4_d3.npz,
              with the QR factor, the port's default ([slice-qr]), to
              convergence (at most 100 iterations: every lane must latch
              KKT error <= 1e-5 and pass the f64 dynamics residual check <=
              1e-4), and with the LU factor ([slice]) for a fixed LU_ITERS
              iterations (cut for [slice-trial]'s time; the two runs'
              powers are printed, not gated)
  5. path     after each slice run, every kernel of its path launched in
              it: K1 and K4 once per iteration, the retry assembly once per
              ladder retry, every factor through the variant of its N; LU:
              three solves per factor and no QR kernel; QR: one K5 and one
              K6 per attempt, two K7 solves per factor and no LU kernel; no
              plain version of any kernel called; state on the card; the
              lanes of each K5 call
  6. solver   the reference's own batched API: make_batched_solver with its
              defaults (kkt='auto', which is 'block' here; [slice-block],
              driven through Sweep.run_batched from the anchor installed as
              a solved Trial where Sweep.batched_problem gives the same
              start, bounds and P, [slice-sweep]) and with kkt='dense' in
              f64 ([slice-dense], cut to DENSE_ITERS iterations) on the same
              16 lanes, each after its first iteration is held against the
              plain path on the CPU; [slice-block]'s every lane must reach
              err <= 1e-5 with f64 max |eq| <= 1e-4 and the 9.5 m/s lane the
              JAX package's power and period to 1e-6; every lane's power and
              period printed; then its
              [path]: K8 (K10, every launch in its cluster variant) once per
              ladder attempt, K9 (K11) three times and K4's advance_state
              once per iteration, no other kernel and no plain version
  7. n_k=8    the same sweep from tests/artifacts/bench_anchor_nk8_d3.npz
              ([slice-nk8] with LU, [slice-nk8-qr] with QR, each followed by
              its [path]), every factor through the blocked variants: the
              first LU iteration against the plain path on the CPU, then
              NK8_ITERS iterations (from this anchor the refinement does not
              converge, in the JAX package as in the port; see main)
  8. trial    Trial(bench_options()).build().optimize() on the card
              ([slice-trial]): the cold homotopy through the host solver,
              its dense direction through K10, K12 and K13; solve_succeeded,
              the anchor's average power and period to 1e-6, the final KKT
              error within its tol, each step's iterations beside the JAX
              package's, the first direction held to the CPU's plain path,
              then its [path]
  9. n_k=18   Trial(bench_options(n_k=18)).build().optimize() on the card
              ([slice-trial-nk18], n=1190, N=2335, 'auto' still 'dense'),
              each homotopy step capped at NK18_ITERS iterations (the
              homotopy advances despite the cap): every direction through
              K10's stream variant, K12 and K13 twice and no other kernel or
              plain version, the first direction held to the CPU's plain
              path; then K10 on the first M of the path that it factors and
              K12/K13 on that direction's K in [kernels] rows
 10. 6-DOF    Trial(flagship_options(4, 3)).build().optimize() on the card
              ([slice-trial-6dof]: the JAX package's default 6-DOF kite,
              n=569, N=1125), each homotopy step capped at SIXDOF_ITERS
              iterations: every step runs, every direction through K10's
              stream variant, K12 in half panels and K13 twice and no other
              kernel or plain version, the first direction held to the
              CPU's plain path; then K10 and K12/K13 on the path's own M and
              K in [kernels] rows
 11. configs  Trial(e2e_options(name)).build().optimize() on the card for
              each configuration of the reference's end-to-end matrix
              beyond the 6-DOF kite (configs.E2E_NAMES: the dual kites, drag
              mode, the actuator-disk and averaged induction models, the
              polynomial controls, the 'single' homotopy, the integral
              outputs, the Reynolds-dependent tether drag;
              [slice-trial-configs]), each homotopy step capped at
              CONFIG_ITERS iterations: the JAX package's steps
              (JAX_CONFIG_ITERS), every direction through K10's cluster
              variant, K12 and K13 twice and no other kernel or plain
              version, the first direction held to the CPU's plain path;
              then K10 on the dual kite's M and K12/K13 on its K and on the
              actuator model's K in [kernels] rows

Phases 8-11 run in a second process (``chip_smoke.py --trials PATH``,
trial_worker), started before phase 4 and joined before phase 7: both it and
phases 4-6 are host-bound, so they share the card without slowing each other,
and the [kernels] rows of phases 9-11 are timed after the join, with the card
to this process alone. The worker's lines are printed when it is joined; it
is stopped if this process fails or ends first.

Any failure raises and exits non-zero. Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero before printing a
result. Run from the repository root:

    python3 chip_smoke.py
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(HERE, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')
ANCHOR8 = os.path.join(HERE, 'tests', 'artifacts', 'bench_anchor_nk8_d3.npz')
B = 16
# timed runs a median is taken over (25 before [slice-trial] came, 11 before
# [slice-trial-nk10]). A queued run waits behind a ~0.1 s device sleep, so
# each queued median costs ~0.8 s whatever it times, and the queued medians
# set most of the [kernels] phase's length; the script has to fit 1200 s on
# a slow host (1230.6 s with 25 in one run on an H100 at 700 W; 1045 s with
# 11 and [slice-trial-nk10] in another, host-bound phases ~25% slower than
# the same tree's 859 s)
N_TIMED = 7
# The time the script's limit leaves for [slice-trial] is given back from
# earlier paths, in this order: the n_k=8 slices (12 -> NK8_ITERS
# iterations; they gate no convergence), the LU slice (to convergence, 22
# iterations -> LU_ITERS; its convergence stays gated on the CPU in
# tests/test_torch_refine.py) and the condensed solver's slice (to
# convergence, 34 iterations -> DENSE_ITERS). [slice-trial-configs] takes no
# depth from them: the cold solves of Trial.optimize ([slice-trial] ..
# [slice-trial-configs]) run in a second process (trial_worker) beside the
# batched slices ([slice] .. [slice-dense]); both are host-bound, and a
# derivative pass takes the same time with one, two or three such processes
# on the card (awebox_tpu_torch/probes/contention.py; PERF.md section 4)
NK8_ITERS = 3     # iterations of each n_k=8 slice (its lanes do not converge; see main)
# iterations a homotopy step of [slice-trial-nk18] (solver.max_iter; the
# homotopy advances despite it), set from its ms/iter so that the script
# keeps within 1100 s
NK18_ITERS = 3
# iterations a homotopy step of [slice-trial-6dof] (solver.max_iter), set
# from its ms/iter (~2.5 s) so that the script keeps within 1100 s; the uncut
# 6-DOF solve takes the JAX package 4089 iterations (JAX_SIXDOF_ITERS), ~4.7 h
# on the card, and the solve capped at 150 a step, which ends where the uncut
# one does, runs in `probes/host_solver.py --config sixdof --solve-only
# --max-iter 150`
SIXDOF_ITERS = 3
# iterations a homotopy step of each configuration of [slice-trial-configs]
# (solver.max_iter), set so that the trial worker ends before the batched
# slices do; the uncut solves (JAX_CONFIG_ITERS) run in
# `probes/host_solver.py --config NAME --solve-only`
CONFIG_ITERS = 1
LU_ITERS = 6
DENSE_ITERS = 8
# The JAX package's converged B=2 sweep (u_ref 9.5, 10.5 m/s) through
# make_batched_solver(batch_p=True, tol=1e-5) on the CPU in f64: average
# power [W] and period [s] in each mode, as `python -m tests.sweep_modes_cpu
# converge MODE CAP` prints them (the slow test of
# tests/test_torch_batched_solver.py runs the same), and the 10.5 m/s lane's
# power through the auglu direction (tests/test_torch_refine.py)
JAX_CONVERGED = {
    'block': ((10120.21197851301, 12004.83706630143), (38.568498529831544, 42.55828460882993)),
    'dense': ((10120.211978365909, 11946.823207327776), (38.56849852572657, 43.96690580295076)),
    'auglu_10.5': 11947.573}
# K9's forward gap max |x_k - x_p| / max |x_p| to its plain version on the
# same factor of the anchor's frames: the CPU mirror of K9's order reads up to
# 2.9e-6 there (cond of the reduced system ~ 1e19); a solve returning zeros,
# or one that drops a term of a sum, reads ~1
TOL_K9_FWD = 1e-4
# the first iteration's gap card - CPU over the step: the CPU lockstep test's
# tolerance (tests/test_torch_sweep_lockstep.py::LOCKSTEP_W)
FIRST_ITER = {'block': 0.3, 'dense': 2e-3}
# The JAX package's cold homotopy of the bench configuration on the CPU, its
# iterations a step (`python -m tests.trial_cold_cpu cold jax`)
JAX_TRIAL_ITERS = {'initial_0': 23, 'fictitious_0': 5, 'fictitious_1': 2, 'power_0': 30,
                   'power_1': 1, 'final_0': 47}
# The JAX package's cold homotopy of the 6-DOF health configuration (the
# same problem as flagship_options(4, 3)) on the CPU, uncut, its iterations a
# step (`python -m tests.trial_cold_cpu cold jax --dof 6`: its first two steps
# run to the 2000-iteration cap)
JAX_SIXDOF_ITERS = {'initial_0': 2000, 'fictitious_0': 2000, 'fictitious_1': 57,
                    'power_0': 18, 'power_1': 1, 'final_0': 13}
# The JAX package's cold homotopy of each configuration of the end-to-end
# matrix on the CPU, its iterations a step: uncut (`python -m
# tests.trial_cold_cpu e2e jax NAME`) where no step runs to the
# 2000-iteration cap, else capped at 150 a step (`--max-iter 150`), as the
# payloads tests/artifacts/e2e_NAME.pkl hold them. Uncut, the integral
# outputs' last three steps run to the cap (461/4/1/2000/2000/2000), the
# actuator model's first and third too and its second fails, ending the
# homotopy there (2000/1269/2000, regularization_failed); the dual kite's
# capped solve stops at the cap in every step (PERF.md section 6)
JAX_CONFIG_ITERS = {
    'dual_kite': {'initial_0': 150, 'fictitious_0': 150, 'fictitious_1': 150, 'power_0': 150,
                  'power_1': 150, 'final_0': 150},
    'drag_mode': {'initial_0': 20, 'fictitious_0': 4, 'fictitious_1': 1, 'power_0': 34,
                  'power_1': 1, 'final_0': 10},
    'actuator_qaxi': {'initial_0': 150, 'fictitious_0': 150, 'fictitious_1': 150,
                      'induction_0': 150, 'induction_1': 150, 'power_0': 150, 'power_1': 150,
                      'final_0': 150},
    'averaged_induction': {'initial_0': 23, 'fictitious_0': 9, 'fictitious_1': 14,
                           'power_0': 54, 'power_1': 4, 'final_0': 14},
    'poly_controls': {'initial_0': 65, 'fictitious_0': 4, 'fictitious_1': 1, 'power_0': 20,
                      'power_1': 1, 'final_0': 82},
    'single_homotopy': {'initial_0': 23, 'middle_0': 35, 'middle_1': 1, 'final_0': 47},
    'integral_outputs': {'initial_0': 150, 'fictitious_0': 56, 'fictitious_1': 1, 'power_0': 150,
                         'power_1': 150, 'final_0': 150},
    'reynolds_cd': {'initial_0': 23, 'fictitious_0': 5, 'fictitious_1': 2, 'power_0': 36,
                    'power_1': 1, 'final_0': 156},
}
# the first kkt_solve of [slice-trial] on the card against the CPU's plain
# path (LAPACK getrf/getrs and potrf there, K12, K13 and K10 here) at the same
# state and derivatives, over each part's max: K's condition number there is
# ~1e9, so two f64 LU orders may part by up to cond x eps ~1e-7 of the
# solution; a wrong factor or solve parts by O(1)
TOL_FIRST_KKT = 1e-8


# the clock of every line's (+N s): the trial worker takes main's
T_START = float(os.environ.get('CHIP_SMOKE_T0', time.time()))
# the plain versions a run of the solvers may reach, each counted while one
# runs: on the card none may run
SOLVER_PLAIN = ('block_factor_plain', 'block_solve_plain', 'chol_factor_batched_plain',
                'chol_solve_batched_plain', 'advance_state_plain', 'newton_kkt_plain',
                'ip_step_plain', 'lu_factor_batched_plain', 'lu_solve_batched_plain',
                'ruiz_scale_plain', 'qr_factor_batched_plain', 'qr_solve_batched_plain')
# the seconds after the script's start by which the trial worker must have
# ended (its work takes ~500 s on an H100 80GB HBM3 at 700 W)
WORKER_DEADLINE = 1100.
# (process, log, folder) of the trial worker, stopped at exit if it still runs
WORKERS = []


def phase(name, msg):
    """One line of the run's record, with the seconds since the script began."""
    print(f'[{name}] {msg} (+{time.time() - T_START:.0f} s)', flush=True)


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

    t_start = time.time()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from awebox_tpu_torch.api.sweep import Sweep
    from awebox_tpu_torch.api.trial import Trial, install_anchor
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.opti.homotopy import build_p_fix, final_cost_values
    from awebox_tpu_torch.opti.initialization import build_reference
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    from awebox_tpu_torch.parallel import batch, kernels
    from awebox_tpu_torch.parallel.refine import (average_power, make_refiner, refine,
                                                  sweep_bounds, wind_sweep_problem)
    from awebox_tpu_torch.tree import tree_map
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.probes.direction_ops import count_and_time
    from awebox_tpu_torch.probes.yardstick import (block_factor_bound, block_factor_gaps,
                                                   block_factor_library, block_solve_bound,
                                                   block_solve_library, bound, chol_factor_bound,
                                                   chol_solve_bound, lu_factor_f64_bound,
                                                   lu_solve_f64_bound)

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
    def hold_k1(tag, args, scaled=True):
        before = kernels.LAUNCHES['newton_kkt']
        out = kernels.newton_kkt(*args, 1e-8, 1e-8, scaled)
        ref = kernels.newton_kkt_plain(*args, 1e-8, 1e-8, scaled)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['newton_kkt'] == before + 1, f'K1 {tag}: no launch')
        require(set(out) == set(ref) and ('K' in out) != scaled, f'K1 {tag}: outputs {set(out)}')
        differ = [k for k in ref if not torch.equal(out[k], ref[k])]
        require(not differ, f'K1 {tag}: {differ} differ from the plain composition')
        k1 = lambda: kernels.newton_kkt(*args, 1e-8, 1e-8, scaled)
        state_, dv_ = args[0], args[1]
        ins = [dv_[k] for k in range(1, 7)] + [state_[k] for k in ('w', 's', 'y', 'lam', 'zl',
                                                                    'zu', 'mu')] + list(args[2:])
        # bound_ms counts the outputs as this design writes them, W0 and A'
        # as f64 images for the refinement's f64 products; bound_f32_images_ms
        # counts those two at the 4 bytes of the f32 values they hold
        b_, by_ = bound(nbytes(*ins, *out.values()))
        b32, _ = bound(nbytes(*ins, *out.values()) - 4 * (out['W64'].numel() + out['A64'].numel()))
        rec = dict(max_abs_err=0.0, ms=cuda_median_ms(k1), queued_ms=cuda_median_ms(k1, queued=True),
                   plain_ms=cuda_median_ms(
                       lambda: kernels.newton_kkt_plain(*args, 1e-8, 1e-8, scaled)),
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
    # ... and with scaled=False, the unscaled K(delta_w) that the QR factor
    # equilibrates: the same kernels given no kd (no kd written, the tiles
    # scaled by 1), bit for bit too
    k1_at, k1_out, k1u_out = {}, {}, {}
    for Bk in (1, B, 8 * B):
        args = (lanes(state, Bk), lanes(dv, Bk), lbw, ubw, free)
        k1_out[Bk], ref_a, k1_at[f'B={Bk}'] = hold_k1(f'anchor B={Bk}', args)
        k1u_out[Bk], _, k1_at[f'unscaled B={Bk}'] = hold_k1(f'unscaled, anchor B={Bk}', args,
                                                             scaled=False)
        if Bk == B:
            ref16 = ref_a
    rand_args = newton_inputs(B=B, n=n, n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, seed=3, device=dev)
    _, rand_ref, k1_at['random B=16'] = hold_k1('random B=16', rand_args)
    _, _, k1_at['unscaled random B=16'] = hold_k1('unscaled, random B=16', rand_args,
                                                  scaled=False)
    report['newton_kkt'] = dict(k1_at[f'B={B}'], at=k1_at)

    # the retry assemblies: K(delta) of the lanes a ladder retry takes, from
    # the f32 W0 and A', Jacobi-scaled (LU) and unscaled (QR); bit for bit,
    # here at three deltas, at N=1055 below
    def hold_assembly(name, tag, args):
        fn, plain = getattr(kernels, name), getattr(kernels, name + '_plain')
        out_k, out_p = fn(*args), plain(*args)
        torch.cuda.synchronize()
        out_k, out_p = (o if isinstance(o, tuple) else (o,) for o in (out_k, out_p))
        require(all(torch.equal(a, b_) for a, b_ in zip(out_k, out_p)),
                f'{name} {tag}: disagrees with its plain version')
        b_, by_ = bound(nbytes(*args, *out_k))
        rec = dict(max_abs_err=0.0, ms=cuda_median_ms(lambda: fn(*args)),
                   queued_ms=cuda_median_ms(lambda: fn(*args), queued=True),
                   plain_ms=cuda_median_ms(lambda: plain(*args)), bound_ms=b_, bound_by=by_,
                   library_ms=None)
        phase('kernels', f'retry assembly {name} {tag}: bit for bit, {rec["ms"]:.4f} ms, queued '
              f'{rec["queued_ms"]:.4f} ms, vs plain {rec["plain_ms"]:.3f} ms; bound {b_:.4f} ms '
              f'({by_})')
        return rec

    f32w = lambda t: t.to(f32).contiguous()
    args1 = (f32w(ref16['W64']), f32w(ref16['A64']), ref16['Dr32'],
             free.to(f32).contiguous(), 10.0 ** torch.linspace(-8, 0, B, dtype=f64, device=dev))
    assembly_at = {name: {f'N={N} B={B}': hold_assembly(name, f'N={N} B={B}, delta 1e-8..1', args1)}
                   for name in ('kkt_assemble_scaled', 'kkt_assemble')}
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
    # systems repeated), and the blocked kernel, held below on random saddle
    # systems of the n_k=8 size N=1055, which only it takes.
    # cuSOLVER's time as called moves between runs with the host's load
    # (at N >= 512 PyTorch calls its getrf once per lane), so the factors
    # and the solves are timed queued too.
    c = ref16['b'].to(f32).contiguous()
    geom = kernels.lu_factor_geometry(N)
    require(geom.variant == 'cluster', f'N={N} does not take the cluster variant: {geom}')
    max_clusters = kernels.cluster_max_active('lu_factor_cluster', geom)
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
    # K2's blocked variant takes the lanes no cluster holds: held on random
    # saddle systems of the n_k=8 size N=1055 (n=540, m=515) at B = 2 and 16
    # (the first two lanes are those of earlier runs), then on a singular
    # lane (a zero column) and a NaN lane, whose solves must be non-finite
    # while every other lane keeps the bits of the clean run
    rng = np.random.default_rng(1)
    n8, m8 = 540, 515
    N8 = n8 + m8
    sys8 = [torch.as_tensor(a, dtype=f64, device=dev) for a in random_systems(rng, n8, m8, B)]
    eq8 = kernels.equilibrate(*sys8, torch.ones(n8, dtype=f64, device=dev), 1e-8)
    pieces8 = (eq8['W32'], eq8['A32'], eq8['Dr32'], eq8['free32'],
               torch.full((B,), 1e-8, dtype=f64, device=dev))
    Ks8, kd8 = kernels.kkt_assemble_scaled(*pieces8)
    c8 = eq8['b'].to(f32).contiguous()
    geom8 = kernels.lu_factor_geometry(N8)
    require(geom8.variant == 'blocked', f'N={N8} does not take the blocked variant: {geom8}')
    phase('kernels', f'K2 geometry at N={N8}: {geom8}')
    blocked_at = {}
    for Bk in (2, B):
        blocked_at[f'B={Bk}'], solve_at[f'N={N8} B={Bk}'] = hold_k2(
            f'N={N8} B={Bk}', Ks8[:Bk].contiguous(), kd8[:Bk].contiguous(), c8[:Bk].contiguous(),
            'blocked')
    x_clean = kernels.lu_solve_batched(*kernels.lu_factor_batched(Ks8.clone()), kd8, c8)
    Ks_bad = Ks8.clone()
    Ks_bad[2, :, 100] = 0.
    Ks_bad[5, :, 700] = float('nan')
    x_bad = kernels.lu_solve_batched(*kernels.lu_factor_batched(Ks_bad.clone()), kd8, c8)
    lu_bp, piv_bp, _ = torch.linalg.lu_factor_ex(Ks_bad)
    x_bad_p = kernels.lu_solve_batched_plain(lu_bp, piv_bp, kd8, c8)
    torch.cuda.synchronize()
    others = [b_ for b_ in range(B) if b_ not in (2, 5)]
    require(not any(bool(torch.isfinite(x[b_]).all()) for x in (x_bad, x_bad_p) for b_ in (2, 5)),
            'K2 blocked: a singular or NaN lane gave a finite solution')
    require(torch.equal(x_bad[others], x_clean[others]),
            'K2 blocked: a singular or NaN lane changed another lane')
    phase('kernels', f'K2 blocked + K3, N={N8} B={B}, a singular lane and a NaN lane: non-finite '
          f'x on both, as with getrf; the {len(others)} other lanes keep their bits')
    report['lu_factor_blocked'] = dict(blocked_at[f'B={B}'], at=blocked_at, N=N8)
    report['lu_factor_cluster'] = dict(cluster_at[f'B={B}'], at=cluster_at,
                                       max_active_clusters=max_clusters)
    report['lu_solve_batched'] = dict(solve_at[f'N={N} B={B}'], at=solve_at)

    # K5 ruiz_scale: three Ruiz sweeps and M = s K s, bit for bit against
    # its plain version (a maximum, a square root and a division a row, two
    # products an entry, each rounded as PyTorch rounds them), on the anchor's
    # K(delta_w) at B = 1, 16 and 128 and with a NaN row and an inf entry
    same_bits = ktests.same_bits   # equal entry for entry, NaN with NaN

    def hold_k5(tag, K):
        before = kernels.LAUNCHES['ruiz_scale']
        M, s_ = kernels.ruiz_scale(K)
        M_p, s_p = kernels.ruiz_scale_plain(K)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['ruiz_scale'] == before + 1, f'K5 {tag}: no launch')
        require(same_bits(M, M_p) and same_bits(s_, s_p), f'K5 {tag}: differs from its plain version')
        k5 = lambda: kernels.ruiz_scale(K)
        b_, by_ = bound(nbytes(K, M, s_), 8 * K.numel())
        geom = kernels.ruiz_geometry(K.shape[1])
        clusters = kernels.ruiz_clusters(K.shape[0], K.shape[1], geom)
        rec = dict(max_abs_err=0.0, ms=cuda_median_ms(k5), queued_ms=cuda_median_ms(k5, queued=True),
                   plain_ms=cuda_median_ms(lambda: kernels.ruiz_scale_plain(K)),
                   bound_ms=b_, bound_by=by_, library_ms=None, geometry=geom._asdict(),
                   clusters=clusters,
                   clusters_at_once=kernels.ruiz_cluster_max_active(K.shape[1], geom))
        phase('kernels', f'K5 ruiz_scale {tag}: M and s bit for bit; {rec["ms"]:.4f} ms, queued '
              f'{rec["queued_ms"]:.4f} ms, vs plain {rec["plain_ms"]:.3f} ms; bound {b_:.4f} ms '
              f'({by_}); {geom.mode}, C={geom.C}, {geom.resident_rows} rows a CTA in shared '
              f'memory and {geom.register_rows} in registers of {geom.rows}, {clusters} clusters '
              f'launched ({rec["clusters_at_once"]} run at once); max |M| '
              f'{float(M.nan_to_num().abs().max()):.3f}')
        return M, s_, rec

    k5_at, ruiz_out = {}, {}
    for Bk in (1, B, 8 * B):
        M_k, s_k, k5_at[f'B={Bk}'] = hold_k5(f'anchor B={Bk}', k1u_out[Bk]['K'])
        ruiz_out[Bk] = (M_k, s_k)
    K_bad = k1u_out[B]['K'].clone()
    K_bad[3, 5, :] = float('nan')
    K_bad[7, 2, 9] = float('inf')
    _, s_bad, k5_at['non-finite B=16'] = hold_k5('NaN row and inf entry B=16', K_bad)
    require(bool(torch.isnan(s_bad[3]).any()) and bool(torch.isfinite(s_bad[[0, 1, 2]]).all()),
            'K5: the NaN row did not reach its lane\'s s, or reached another lane')

    # K6 + K7: Householder QR and the solve R^-1 Q^T c of the Ruiz-scaled
    # anchor systems M, c = s b. A QR factor is unique only up to the signs of
    # R's rows and to rounding, so K6 is held by |diag R| (1e-3 of its
    # maximum against cuSOLVER's geqrf: the f32 backward error N eps |M| ~
    # 3e-5, which the conditioning of M's leading blocks amplifies in R;
    # 1.1e-4 was measured at the anchor, cond(M) ~ 1e9) and by the solve. K7 is held on the same factor, K6's and cuSOLVER's,
    # against its plain version (ormqr + solve_triangular): the direct f32
    # solve reaches only ~1e-5 of scaled residual at cond(M) ~ 1e9, so the
    # gates are the residual max |c - M64 z| / max |c| within 10x of the
    # plain version's (and of the library's on its own factor), then the
    # direction's guarded refinement sweep through each solve: its residual
    # within 10x and its z within 1e-2 of max |z| (one sweep leaves each
    # solve at its own (cond eps)^2; the JAX package's and LAPACK's QR differ
    # by 5e-4 of the step at the anchor on the CPU). The cluster variant is
    # held at N=543, B = 1, 16, 128, the blocked one below on random saddle
    # systems of the n_k=8 size N=1055, which only it takes (at the n_k=8
    # anchor itself even LAPACK's f32 and f64 geqrf differ by 2.8e-3 in
    # |diag R|).
    def qr_res(M64, c64, z):
        r = c64 - (M64 @ z.to(f64)[:, :, None])[:, :, 0]
        return r.abs().amax(dim=1) / c64.abs().amax(dim=1)

    def guarded(M64, c64, solve):
        """The direction's solve with one guarded sweep (batch.py:348-358)
        through solve(v32) -> f32: the direct residual, z and its residual."""
        z = solve(c64.to(f32).contiguous()).to(f64)
        res = c64 - (M64 @ z[:, :, None])[:, :, 0]
        best = res.abs().amax(dim=1)
        z1 = z + solve(res.to(f32).contiguous()).to(f64)
        b1 = (c64 - (M64 @ z1[:, :, None])[:, :, 0]).abs().amax(dim=1)
        z = torch.where((b1 < best)[:, None], z1, z)
        scale = c64.abs().amax(dim=1)
        return best / scale, z, torch.minimum(best, b1) / scale

    def hold_qr(tag, M, c64, variant, n_timed=N_TIMED):
        B_, N_ = M.shape[0], M.shape[1]
        before = dict(kernels.LAUNCHES)
        qr_k, tau_k = kernels.qr_factor_batched(M)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES[f'qr_factor_{variant}'] == before[f'qr_factor_{variant}'] + 1,
                f'K6 {tag}: the {variant} variant did not run')
        raw = kernels.qr_factor_batched_plain(M)            # cuSOLVER's geqrf, column-major
        qr_p, tau_p = (t.contiguous() for t in raw)
        dk = torch.diagonal(qr_k, dim1=1, dim2=2).abs()
        dp = torch.diagonal(qr_p, dim1=1, dim2=2).abs()
        diag_err = float((dk - dp).abs().max())
        require(diag_err <= 1e-3 * float(dp.max()),
                f'K6 {variant} {tag}: |diag R| off by {diag_err:.3e} of {float(dp.max()):.3e}')
        M64 = M.to(f64)
        lib0, z_lib, lib1 = guarded(M64, c64, lambda v: kernels.qr_solve_batched_plain(qr_p, tau_p, v))
        worst = dict(direct=0., swept=0., z=0.)
        solves_before = kernels.LAUNCHES['qr_solve_batched']
        for fac, (f_, t_) in (('K6', (qr_k, tau_k)), ('geqrf', (qr_p, tau_p))):
            k0, z_k, k1_ = guarded(M64, c64, lambda v: kernels.qr_solve_batched(f_, t_, v))
            p0, z_p, p1_ = guarded(M64, c64, lambda v: kernels.qr_solve_batched_plain(f_, t_, v))
            torch.cuda.synchronize()
            for what, a, ref in (('direct', k0, p0), ('direct vs library', k0, lib0),
                                 ('swept', k1_, p1_), ('swept vs library', k1_, lib1)):
                require(bool(torch.isfinite(a).all())
                        and bool((a <= 10 * torch.clamp(ref, min=1e-9)).all()),
                        f'K7 on {fac}\'s factor {tag}: {what} residual {a.tolist()} vs {ref.tolist()}')
            zgap = float(((z_k - z_p).abs().amax(dim=1) / z_p.abs().amax(dim=1)).max())
            require(zgap <= 1e-2, f'K7 on {fac}\'s factor {tag}: swept z off by {zgap:.3e} of max |z|')
            worst = dict(direct=max(worst['direct'], float(k0.max())),
                         swept=max(worst['swept'], float(k1_.max())), z=max(worst['z'], zgap))
        require(kernels.LAUNCHES['qr_solve_batched'] == solves_before + 4, f'K7 {tag}: launches')
        c32 = c64.to(f32).contiguous()
        factor = lambda: kernels.qr_factor_batched(M)
        plain = lambda: kernels.qr_factor_batched_plain(M)       # one library call, geqrf
        k6_bound, k6_by = bound(8 * B_ * N_ * N_ + 4 * B_ * N_, 4 / 3 * B_ * N_ ** 3)
        k6 = dict(max_abs_err=diag_err, ms=cuda_median_ms(factor, n=n_timed),
                  plain_ms=cuda_median_ms(plain, n=n_timed),
                  queued_ms=cuda_median_ms(factor, n=n_timed, queued=True),
                  plain_queued_ms=cuda_median_ms(plain, n=n_timed, queued=True),
                  bound_ms=k6_bound, bound_by=k6_by, timed_runs=n_timed)
        k6['library_ms'], k6['library_queued_ms'] = k6['plain_ms'], k6['plain_queued_ms']
        # K7 and the library's two calls timed on cuSOLVER's factor, each in its own layout
        solve = lambda: kernels.qr_solve_batched(qr_p, tau_p, c32)
        rhs = c32[:, :, None]
        library = lambda: torch.linalg.solve_triangular(
            raw[0], torch.ormqr(raw[0], raw[1], rhs, left=True, transpose=True), upper=True)
        k7_bound, k7_by = bound(4 * B_ * N_ * N_ + 12 * B_ * N_, 3 * B_ * N_ * N_)
        k7 = dict(max_abs_err=worst['z'] * float(z_lib.abs().max()),
                  ms=cuda_median_ms(solve), queued_ms=cuda_median_ms(solve, queued=True),
                  plain_ms=cuda_median_ms(lambda: kernels.qr_solve_batched_plain(qr_p, tau_p, c32)),
                  library_ms=cuda_median_ms(library),
                  library_queued_ms=cuda_median_ms(library, queued=True),
                  bound_ms=k7_bound, bound_by=k7_by, swept_z_gap=worst['z'],
                  direct_residual=worst['direct'], swept_residual=worst['swept'],
                  geometry=kernels.qr_solve_geometry(N_)._asdict())
        phase('kernels', f'K6 {variant} {tag}: max ||diag R| - |diag R_geqrf|| {diag_err:.3e} (max '
              f'{float(dp.max()):.3e}); {k6["ms"]:.3f} ms vs geqrf {k6["plain_ms"]:.3f} ms; queued '
              f'{k6["queued_ms"]:.3f} ms vs geqrf {k6["plain_queued_ms"]:.3f} ms; bound '
              f'{k6_bound:.4f} ms ({k6_by})')
        phase('kernels', f'K7 {tag}: direct residual max {worst["direct"]:.3e} (library '
              f'{float(lib0.max()):.3e}), after the guarded sweep {worst["swept"]:.3e} (library '
              f'{float(lib1.max()):.3e}), swept z within {worst["z"]:.3e} of max |z| of the plain '
              f'solve; {k7["ms"]:.4f} ms, queued {k7["queued_ms"]:.4f} ms; plain '
              f'{k7["plain_ms"]:.3f} ms; ormqr + solve_triangular {k7["library_ms"]:.3f} ms, queued '
              f'{k7["library_queued_ms"]:.3f} ms; bound {k7_bound:.4f} ms ({k7_by})')
        return k6, k7, qr_k, tau_k

    qgeom = kernels.qr_factor_geometry(N)
    require(qgeom.variant == 'cluster', f'N={N} does not take the QR cluster variant: {qgeom}')
    at_once = {C: kernels.cluster_max_active('qr_factor_cluster', kernels.qr_cluster_layout(N, C))
               for C in (7, 8)}
    phase('kernels', f'K6 geometry at N={N}: {qgeom}; clusters that run at once: '
          f'{at_once[7]} of 7 CTAs, {at_once[8]} of 8; C={qgeom.C} taken; K7 geometry: '
          f'{kernels.qr_solve_geometry(N)}')
    k6_at, k7_at = {}, {}
    for Bk in (1, B, 8 * B):
        M_k, s_k = ruiz_out[Bk]
        c64 = k1u_out[Bk]['b'] * s_k.to(f64)
        k6_at[f'B={Bk}'], k7_at[f'N={N} B={Bk}'], qr16, tau16 = hold_qr(
            f'N={N} B={Bk}', M_k, c64, 'cluster')
        if Bk == B:
            x_clean = kernels.qr_solve_batched(qr16, tau16, c64.to(f32).contiguous())
            M16, c16 = M_k, c64.to(f32).contiguous()
    # a singular lane (a zero column: tau = 0 and a zero on R's diagonal) and
    # a lane with a NaN column give a non-finite solution, as with the
    # library, and every other lane keeps the bits of the clean run
    M_bad = M16.clone()
    M_bad[2, :, 100] = 0.
    M_bad[5, :, 200] = float('nan')
    x_bad = kernels.qr_solve_batched(*kernels.qr_factor_batched(M_bad), c16)
    x_bad_p = kernels.qr_solve_batched_plain(*kernels.qr_factor_batched_plain(M_bad), c16)
    torch.cuda.synchronize()
    others = [b_ for b_ in range(B) if b_ not in (2, 5)]
    require(not bool(torch.isfinite(x_bad[2]).all()) and not bool(torch.isfinite(x_bad[5]).all())
            and not bool(torch.isfinite(x_bad_p[2]).all())
            and not bool(torch.isfinite(x_bad_p[5]).all()),
            'K6+K7: a singular or NaN lane gave a finite solution')
    require(torch.equal(x_bad[others], x_clean[others]),
            'K6+K7: a singular or NaN lane changed another lane')
    phase('kernels', 'K6+K7 singular lane and NaN lane: non-finite x on both, as with geqrf; '
          'the 14 other lanes keep their bits')
    # K6's blocked variant on the Ruiz-scaled random systems of N=1055 at
    # B = 2 and 16, then a singular and a NaN lane
    qgeom8 = kernels.qr_factor_geometry(N8)
    require(qgeom8.variant == 'blocked', f'N={N8} does not take the blocked QR variant: {qgeom8}')
    K8 = kernels.kkt_assemble(*pieces8)
    for Bk in (2, B):
        M8, s8, k5_at[f'N={N8} B={Bk}'] = hold_k5(f'N={N8} B={Bk}', K8[:Bk].contiguous())
    report['ruiz_scale'] = dict(k5_at[f'B={B}'], at=k5_at)
    for name in assembly_at:
        assembly_at[name][f'N={N8} B={B}'] = hold_assembly(name, f'N={N8} B={B}', pieces8)
        report[name] = dict(assembly_at[name][f'N={N} B={B}'], at=assembly_at[name])
    c64_8 = eq8['b'] * s8.to(f64)
    k6b_at = {}
    for Bk in (2, B):
        k6b_at[f'B={Bk}'], k7_at[f'N={N8} B={Bk}'], qr8, tau8 = hold_qr(
            f'N={N8} B={Bk}', M8[:Bk].contiguous(), c64_8[:Bk].contiguous(), 'blocked')
    c8q = c64_8.to(f32).contiguous()
    x_clean = kernels.qr_solve_batched(qr8, tau8, c8q)
    M_bad = M8.clone()
    M_bad[2, :, 100] = 0.
    M_bad[5, :, 700] = float('nan')
    x_bad = kernels.qr_solve_batched(*kernels.qr_factor_batched(M_bad), c8q)
    x_bad_p = kernels.qr_solve_batched_plain(*kernels.qr_factor_batched_plain(M_bad), c8q)
    torch.cuda.synchronize()
    require(not any(bool(torch.isfinite(x[b_]).all()) for x in (x_bad, x_bad_p) for b_ in (2, 5)),
            'K6 blocked + K7: a singular or NaN lane gave a finite solution')
    require(torch.equal(x_bad[others], x_clean[others]),
            'K6 blocked + K7: a singular or NaN lane changed another lane')
    phase('kernels', f'K6 blocked + K7, N={N8} B={B}, a singular lane and a NaN lane: non-finite '
          f'x on both, as with geqrf; the {len(others)} other lanes keep their bits')
    report['qr_factor_blocked'] = dict(k6b_at[f'B={B}'], at=k6b_at, N=N8)
    report['qr_factor_cluster'] = dict(k6_at[f'B={B}'], at=k6_at)
    report['qr_solve_batched'] = dict(k7_at[f'N={N} B={B}'], at=k7_at)

    # the whole direction solve (the kernels + refinement + ladder) on the
    # card against the plain path on the CPU, with each factor, on
    # make_system-style random saddle systems at n, m. In lane 0 variable 0
    # appears nowhere (zero row and column of W0, zero column of A), so
    # K(delta) pins it only through delta: |dw_0| = |r1_0| / delta exceeds
    # dw_cap until the ladder has raised delta, and lane 0 is retried alone
    # on the card. ok must agree lane by lane, and the card's augmented
    # residual (relative to the right-hand side) must be within 10x of the
    # CPU's: both are set by the f32 factor's accuracy on these
    # ill-conditioned random systems
    rng = np.random.default_rng(0)
    W0r, Ar, Dr, r1r, r2r = random_systems(rng, n, m, B)
    W0r[0, 0, :] = 0.
    W0r[0, :, 0] = 0.
    Ar[0, :, 0] = 0.
    freer = np.ones(n)
    host = [torch.as_tensor(a, dtype=f64) for a in (W0r, Ar, Dr, r1r, r2r, freer)]
    card = [t.to(dev) for t in host]

    def aug_res(W0, A, D, r1, r2, dw, dnu):
        rn = 1.0 / np.clip(np.abs(A).max(axis=2), 1e-10, 1e10)
        A_e = A * rn[:, :, None]
        dnu_e = dnu / rn
        r_w = r1 - (np.einsum('bij,bj->bi', W0 + 1e-8 * np.eye(n), dw)
                    + np.einsum('bji,bj->bi', A_e, dnu_e))
        r_nu = -(r2 * rn) - (np.einsum('bij,bj->bi', A_e, dw) - (D * rn * rn + 1e-8) * dnu_e)
        scale = np.maximum(np.abs(r1).max(axis=1), np.abs(r2).max(axis=1))
        return np.maximum(np.abs(r_w).max(axis=1), np.abs(r_nu).max(axis=1)) / scale

    for fac in ('lu', 'qr'):
        before = dict(kernels.LAUNCHES)
        out_c = batch._auglu_solve(*card[:5], card[5], n, 1e-8, 1e-8, 7, 100., factor=fac)
        run = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
        retries = run[f'{fac}_factor_batched'] - 1
        out_h = batch._auglu_solve(*host[:5], host[5], n, 1e-8, 1e-8, 7, 100., factor=fac)
        ok_c, ok_h = out_c[2].cpu().numpy(), out_h[2].numpy()
        require((ok_c == ok_h).all(), f'{fac} direction ok: card {ok_c}, cpu {ok_h}')
        require(retries >= 1, f'the {fac} ladder did not run')
        if fac == 'qr':   # a retry re-runs the assembly, K5, K6 and K7 on its lanes alone
            require(run['kkt_assemble'] == run['ruiz_scale'] == retries + 1
                    and run['qr_solve_batched'] == 2 * (retries + 1)
                    and run['lu_factor_batched'] == run['lu_solve_batched'] == 0,
                    f'qr direction launches: {run}')
        dw0_c, dw0_h = float(out_c[0][0, 0]), float(out_h[0][0, 0])
        require(abs(dw0_c - dw0_h) <= 1e-6 * abs(dw0_h),
                f'{fac} ladder lane dw_0: card {dw0_c}, cpu {dw0_h}')
        ar_c = aug_res(W0r, Ar, Dr, r1r, r2r, out_c[0].cpu().numpy(), out_c[1].cpu().numpy())
        ar_h = aug_res(W0r, Ar, Dr, r1r, r2r, out_h[0].numpy(), out_h[1].numpy())
        require(bool(torch.isfinite(out_c[0]).all() and torch.isfinite(out_h[0]).all()),
                f'{fac} direction: non-finite dw')
        regular = ok_c.copy()
        regular[0] = False   # lane 0 solved a laddered K(delta)
        require((ar_c[regular] <= 10 * np.maximum(ar_h[regular], 1e-9)).all(),
                f'{fac} direction residuals: card {ar_c}, cpu {ar_h}')
        phase('kernels', f'{fac} direction solve, random systems: ok {int(ok_c.sum())}/{B} on '
              f'both; augmented residual card max {ar_c[regular].max():.3e}, cpu max '
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
        b_, by_ = bound(nbytes(*ins, *o_k.values()), 2 * x.shape[0] * n_ineq * args[4].numel())
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

    # --- K8-K11 and K4's advance_state: the block and condensed KKT modes --
    # K8 block_factor and K9 block_solve on the frames of the anchor's block
    # systems (ocp/blockkkt.py's assembly of the same 16 lanes, damped by
    # delta_w), K10/K11 on the anchor's condensed M = W0 + delta_w diag(free)
    # + A_s^T A_s. Each against its plain version on the same inputs, with an
    # indefinite lane and a NaN lane that must fail alone (ok False, NaN
    # solution) while every other lane keeps the bits of a clean run. The
    # direct solves of these systems are ill-conditioned (cond(M) ~ 1e19 at
    # the anchor: the block solve and a dense LU solve of the same M differ
    # by ~9%), so solutions are gated by their residual |M x - b| / |b|,
    # within 10x of the plain version's, and the factors by what they
    # reproduce: Li and Xc within 1e-10 of their max (the interiors are well
    # conditioned; the CPU mirror of K8's schedule agrees to 4e-13),
    # R = L_R L_R^T within 1e-10 of its max (the mirror: 3e-15), and
    # L L^T - M of K10 within 10x of the plain factor's.
    from awebox_tpu_torch.ocp.blockkkt import make_block_kkt

    def block_inputs(ocp_, state_, P_, lbw_, ubw_, free_):
        """The block path's frames (damped by delta_w), right-hand sides and
        maps on the card, and its condensed M and right-hand side."""
        derivs_b, kkt_b, maps_ = make_block_kkt(ocp_)
        blocks = derivs_b(state_['w'], state_['y'], state_['lam'], P_)
        asm = maps_.assemble(blocks, *[state_[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu')],
                             lbw_, ubw_, free_, state_['mu'], 1e-8, 1e-8)
        fV = torch.as_tensor(maps_.frame_V.astype(np.int64), device=dev)
        own_free = (torch.as_tensor(maps_.own, device=dev) * free_[fV]).contiguous()
        index_maps = tuple(torch.as_tensor(getattr(maps_, k).astype(np.int64), device=dev)
                           for k in ('chain_V', 'intr_V', 'border_V'))
        return maps_, asm, own_free, index_maps, fV, blocks, kkt_b

    def frames_to_M(Frame, fV, delta, free_):
        """The condensed M that the frames make up (each frame's entries
        summed into the n variables) and its damping delta diag(free)."""
        B_, n_ = Frame.shape[0], free_.shape[0]
        M = torch.zeros(B_, n_, n_, dtype=f64, device=dev)
        for k in range(Frame.shape[1]):
            M[:, fV[k][:, None], fV[k][None, :]] += Frame[:, k]
        return M + delta[:, None, None] * torch.diag(free_)

    def rel_res(M, x, b):
        return ((M @ x[..., None])[..., 0] - b).abs().amax(dim=1) / b.abs().amax(dim=1)

    def spoil(T, idx_neg, idx_nan):
        """A copy of T with lane 1 made indefinite and lane 2 given a NaN (where B > 2)."""
        T = T.clone()
        if T.shape[0] > 2:
            T[(1,) + idx_neg] = -1e6
            T[(2,) + idx_nan] = float('nan')
        return T

    def ladder_delta(ok_at):
        """The least delta_w 100^k (k <= 7, the ladder's values) at which
        ok_at(delta) holds for every lane: the damping the path's ladder
        factors these systems with."""
        for k in range(8):
            if ok_at(1e-8 * 100. ** k):
                return 1e-8 * 100. ** k
        raise RuntimeError('chip_smoke: no damping of the ladder factors these systems')

    def hold_block(tag, Frame, own_free, index_maps, rhs, fV, free_, lay):
        Frame, rhs = Frame.contiguous(), rhs.contiguous()
        B_ = Frame.shape[0]
        d0 = ladder_delta(lambda d: bool(kernels.block_factor_plain(
            Frame, torch.full((B_,), d, dtype=f64, device=dev), own_free, lay)[3].all()))
        delta = torch.full((B_,), d0, dtype=f64, device=dev)
        tag = f'{tag} delta {d0:.0e}'
        oi = 2 * lay.nx
        Fb = spoil(Frame, (lay.n_k - 1, oi + 3, oi + 3), (0, oi + 1, oi + 1))
        before = dict(kernels.LAUNCHES)
        fac_k = kernels.block_factor(Fb, delta, own_free, lay)
        x_k = kernels.block_solve(*fac_k[:3], rhs, index_maps, lay)
        fac_p = kernels.block_factor_plain(Fb, delta, own_free, lay)
        x_p = kernels.block_solve_plain(*fac_p[:3], rhs, index_maps, lay)
        fac_c = kernels.block_factor(Frame, delta, own_free, lay)
        x_c = kernels.block_solve(*fac_c[:3], rhs, index_maps, lay)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['block_factor'] == before['block_factor'] + 2
                and kernels.LAUNCHES['block_solve'] == before['block_solve'] + 2,
                f'K8/K9 {tag}: launches')
        bad = [b_ for b_ in (1, 2) if B_ > 2]
        good = [b_ for b_ in range(B_) if b_ not in bad]
        require(torch.equal(fac_k[3], fac_p[3]) and not bool(fac_k[3][bad].any())
                and bool(fac_k[3][good].all()), f'K8 {tag}: ok {fac_k[3].tolist()} vs '
                f'plain {fac_p[3].tolist()}')
        gaps = block_factor_gaps(fac_k, fac_p, good)
        require(max(gaps) <= 1e-10, f'K8 {tag}: Li, Xc, R gaps {gaps}')
        # K9 against its plain version on the same (kernel's) factor of the
        # clean frames: the forward gap max |x_k - x_p| / max |x_p| per lane
        fwd = (x_c - kernels.block_solve_plain(*fac_c[:3], rhs, index_maps, lay)).abs().amax(dim=1) \
            / kernels.block_solve_plain(*fac_c[:3], rhs, index_maps, lay).abs().amax(dim=1)
        require(bool(fac_c[3].all()) and bool((fwd <= TOL_K9_FWD).all()),
                f'K9 {tag}: forward gaps to the plain solve {fwd.tolist()}')
        # the residuals on M of the frames, for information only: the reduced
        # system is too ill-conditioned for them to tell a right solve
        M = frames_to_M(Frame[good], fV, delta[good], free_)
        res_k, res_p = rel_res(M, x_k[good], rhs[good]), rel_res(M, x_p[good], rhs[good])
        require(bool(torch.isnan(fac_k[2][bad]).all()) and bool(torch.isnan(x_k[bad]).all()),
                f'K8/K9 {tag}: a failed lane is not NaN')
        require(all(torch.equal(t[good], tc[good]) for t, tc in zip(fac_k[:3] + (x_k,),
                                                                     fac_c[:3] + (x_c,))),
                f'K8/K9 {tag}: a failed lane changed another lane')
        # the library composition: cholesky, solve_triangular, a product per
        # frame and cholesky of R (K8); four triangular solves and two
        # products (K9), on the clean lanes' factor
        Li, Xc, LR = fac_c[:3]
        lib8 = block_factor_library(Frame, delta, own_free, lay, LR)
        lib9 = block_solve_library(Li, Xc, LR, rhs, lay, index_maps[1])
        b8 = block_factor_bound(lay, B_)
        b9 = block_solve_bound(lay, B_)
        k8 = lambda: kernels.block_factor(Frame, delta, own_free, lay)
        k9 = lambda: kernels.block_solve(Li, Xc, LR, rhs, index_maps, lay)
        recs = []
        for fn, plain, lib, (b_, by_), err in (
                (k8, lambda: kernels.block_factor_plain(Frame, delta, own_free, lay), lib8, b8,
                 max(gaps)),
                (k9, lambda: kernels.block_solve_plain(Li, Xc, LR, rhs, index_maps, lay), lib9, b9,
                 float(fwd.max()))):
            recs.append(dict(max_abs_err=err, ms=cuda_median_ms(fn),
                             queued_ms=cuda_median_ms(fn, queued=True),
                             plain_ms=cuda_median_ms(plain), library_ms=cuda_median_ms(lib),
                             library_queued_ms=cuda_median_ms(lib, queued=True),
                             bound_ms=b_, bound_by=by_, delta=d0))
        geom = kernels.block_factor_geometry(lay)
        phase('kernels', f'K8 block_factor {tag}: {B_} clusters of {lay.n_k} CTAs, '
              f'{geom.smem_bytes} B of shared memory a CTA, leading dimensions {geom.ld_frame} / '
              f'{geom.ld_r} / {geom.ld_s} (frame / R / S), panels of {kernels.BLOCK_WIDTH}')
        g9 = kernels.block_solve_geometry(lay)
        a9 = kernels.cluster_max_active('block_solve', g9)
        phase('kernels', f'K9 block_solve {tag}: clusters of {g9.C} CTAs, {g9.smem_bytes} B of '
              f'shared memory a rank ({g9.li_tiles} + {g9.r_tiles} tiles of Li / L_R, Xc at '
              f'leading dimension {g9.ld_x}); {a9} clusters at once: {-(-B_ // a9)} wave(s)')
        phase('kernels', f'K8 block_factor {tag}: ok {int(fac_k[3].sum())}/{B_} as plain '
              f'(indefinite and NaN lanes fail alone), Li/Xc/R gaps {gaps[0]:.2e}/{gaps[1]:.2e}/'
              f'{gaps[2]:.2e}; {recs[0]["ms"]:.4f} ms, queued {recs[0]["queued_ms"]:.4f} ms, plain '
              f'{recs[0]["plain_ms"]:.3f} ms, library {recs[0]["library_ms"]:.3f} ms (queued '
              f'{recs[0]["library_queued_ms"]:.3f}); bound {b8[0]:.5f} ms ({b8[1]})')
        phase('kernels', f'K9 block_solve {tag}: forward gap to plain {float(fwd.max()):.2e} '
              f'(tolerance {TOL_K9_FWD:.0e}; zeros read 1), residual on M max '
              f'{float(res_k.max()):.2e} vs plain {float(res_p.max()):.2e}; {recs[1]["ms"]:.4f} ms, queued {recs[1]["queued_ms"]:.4f} '
              f'ms, plain {recs[1]["plain_ms"]:.3f} ms, library {recs[1]["library_ms"]:.3f} ms '
              f'(queued {recs[1]["library_queued_ms"]:.3f}); bound {b9[0]:.5f} ms ({b9[1]})')
        return recs

    def condensed(state_, P_, lbw_, ubw_, free_, ocp_):
        """The condensed M and right-hand side of the dense path at the anchor
        (f64 derivatives, as make_batched_solver's), M damped by the least
        delta of the ladder at which every lane factors."""
        vf, jf, hf = make_structured_derivs(ocp_)
        w_, y_, l_ = state_['w'], state_['y'], state_['lam']
        dv_ = tuple(vf(w_, y_, l_, P_)) + tuple(jf(w_, P_)) + (hf(w_, y_, l_, P_),)
        sys_ = kernels.newton_system(state_, dv_, lbw_, ubw_, free_)
        As = sys_['A'] / torch.sqrt(sys_['D'])[:, :, None]
        AtA = As.transpose(1, 2) @ As
        M_of = lambda d: (sys_['W0'] + d * torch.diag(free_) + AtA).contiguous()
        d0 = ladder_delta(lambda d: bool(kernels.chol_factor_batched_plain(M_of(d))[1].all()))
        rhs_ = sys_['r1'] - (sys_['A'].transpose(1, 2) @ (sys_['r2'] / sys_['D'])[..., None])[..., 0]
        return M_of(d0), rhs_.contiguous(), d0

    def hold_chol(tag, M, b, variant):
        """K10 (in the variant chol_factor_geometry gives, which must be
        ``variant``) and K11 on M and b against their plain versions."""
        M, b = M.contiguous(), b.contiguous()
        B_, n_ = M.shape[0], M.shape[1]
        geom = kernels.chol_factor_geometry(n_)
        require(geom.variant == variant, f'K10 {tag}: the {geom.variant} variant, not {variant}')
        Mb = spoil(M, (n_ // 2, n_ // 2), (n_ - 1, 3))
        before = dict(kernels.LAUNCHES)
        L_k, ok_k = kernels.chol_factor_batched(Mb)
        x_k = kernels.chol_solve_batched(L_k, b)
        L_p, ok_p = kernels.chol_factor_batched_plain(Mb)
        x_p = kernels.chol_solve_batched_plain(L_p, b)
        L_c, ok_c = kernels.chol_factor_batched(M)
        x_c = kernels.chol_solve_batched(L_c, b)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['chol_factor_batched'] == before['chol_factor_batched'] + 2
                and kernels.LAUNCHES[f'chol_factor_{variant}']
                == before[f'chol_factor_{variant}'] + 2
                and kernels.LAUNCHES['chol_solve_batched'] == before['chol_solve_batched'] + 2,
                f'K10/K11 {tag}: launches')
        bad = [b_ for b_ in (1, 2) if B_ > 2]
        good = [b_ for b_ in range(B_) if b_ not in bad]
        require(torch.equal(ok_k, ok_p) and bool(ok_k[good].all()) and not bool(ok_k[bad].any()),
                f'K10 {tag}: ok {ok_k.tolist()} vs plain {ok_p.tolist()}')
        rec_k = (L_k[good] @ L_k[good].transpose(1, 2) - M[good]).abs().amax(dim=(1, 2))
        rec_p = (L_p[good] @ L_p[good].transpose(1, 2) - M[good]).abs().amax(dim=(1, 2))
        scale = M[good].abs().amax(dim=(1, 2))
        require(bool((rec_k <= 10 * torch.clamp(rec_p, min=1e-15 * scale)).all()),
                f'K10 {tag}: |L L^T - M| {rec_k.tolist()} vs plain {rec_p.tolist()}')
        res_k, res_p = rel_res(M[good], x_k[good], b[good]), rel_res(M[good], x_p[good], b[good])
        require(bool((res_k <= 10 * torch.clamp(res_p, min=1e-12)).all()),
                f'K11 {tag}: residuals {res_k.tolist()} vs plain {res_p.tolist()}')
        require(bool(torch.isnan(L_k[bad]).all()) and bool(torch.isnan(x_k[bad]).all()),
                f'K10/K11 {tag}: a failed lane is not NaN')
        require(torch.equal(L_k[good], L_c[good]) and torch.equal(x_k[good], x_c[good]),
                f'K10/K11 {tag}: a failed lane changed another lane')
        k10 = lambda: kernels.chol_factor_batched(M)
        k11 = lambda: kernels.chol_solve_batched(L_c, b)
        lib10 = lambda: torch.linalg.cholesky_ex(M)
        b_col = b[..., None].contiguous()
        lib11 = lambda: torch.cholesky_solve(b_col, L_c)
        b10 = chol_factor_bound(n_, B_)
        b11 = chol_solve_bound(n_, B_)
        recs = []
        for fn, plain, lib, (b_, by_), err in (
                (k10, lambda: kernels.chol_factor_batched_plain(M), lib10, b10,
                 float((rec_k / scale).max())),
                (k11, lambda: kernels.chol_solve_batched_plain(L_c, b), lib11, b11,
                 float(res_k.max()))):
            recs.append(dict(max_abs_err=err, ms=cuda_median_ms(fn),
                             queued_ms=cuda_median_ms(fn, queued=True),
                             plain_ms=cuda_median_ms(plain), library_ms=cuda_median_ms(lib),
                             library_queued_ms=cuda_median_ms(lib, queued=True),
                             bound_ms=b_, bound_by=by_))
        active = kernels.cluster_max_active(f'chol_factor_{geom.variant}', geom)
        in_l2 = '' if variant == 'cluster' else (
            '; panels in the L2 a rank: ' + ','.join(str(sum(o is None for o in offs))
                                                     for offs in geom.offsets))
        phase('kernels', f'K10 chol_factor_{variant} {tag}: clusters of C={geom.C} CTAs, panels of '
              f'{geom.nb} at leading dimension {geom.ld}, {geom.smem_bytes} B of shared memory a '
              f'rank{in_l2}; {active} clusters at once: {-(-B_ // active)} wave(s) at B={B_}, '
              f'{-(-B // active)} at B={B}, {-(-8 * B // active)} at B={8 * B}')
        phase('kernels', f'K10 chol_factor_{variant} {tag}: ok {int(ok_k.sum())}/{B_} as plain, '
              f'max |L L^T - M| {float(rec_k.max()):.2e} vs plain {float(rec_p.max()):.2e} (max |M| '
              f'{float(scale.max()):.2e}); {recs[0]["ms"]:.4f} ms, queued {recs[0]["queued_ms"]:.4f} '
              f'ms, plain {recs[0]["plain_ms"]:.3f} ms, torch.linalg.cholesky_ex '
              f'{recs[0]["library_ms"]:.3f} ms (queued {recs[0]["library_queued_ms"]:.3f}); bound '
              f'{b10[0]:.5f} ms ({b10[1]})')
        phase('kernels', f'K11 chol_solve_batched {tag}: a CTA a lane, {kernels.CHOL_SOLVE_SLOTS} '
              f'tile slots of ring and the vectors, {kernels.chol_solve_geometry(n_)} B of shared '
              f'memory, {-(-n_ // kernels.SUBST_NB)} tile steps each way')
        phase('kernels', f'K11 chol_solve_batched {tag}: residual max {float(res_k.max()):.2e} vs '
              f'plain {float(res_p.max()):.2e}; {recs[1]["ms"]:.4f} ms, queued '
              f'{recs[1]["queued_ms"]:.4f} ms, plain {recs[1]["plain_ms"]:.3f} ms, '
              f'torch.cholesky_solve {recs[1]["library_ms"]:.3f} ms (queued '
              f'{recs[1]["library_queued_ms"]:.3f}); bound {b11[0]:.5f} ms ({b11[1]})')
        return recs

    block_at, bsolve_at, chol_at, csolve_at = {}, {}, {}, {}
    maps4, asm4, own4, imaps4, fV4, blocks4, kkt_solve4 = block_inputs(ocp, state, P64, lbw, ubw,
                                                                     free)
    lay4 = maps4.layout
    for Bk in (1, 2, B, 8 * B):   # B=2: the size of a delta-ladder retry
        block_at[f'n_k=4 B={Bk}'], bsolve_at[f'n_k=4 B={Bk}'] = hold_block(
            f'n_k=4 B={Bk}', lanes(asm4['Frame'], Bk), own4, imaps4, lanes(asm4['rhs_w'], Bk),
            fV4, free, lay4)
    M4, rhs4, d4 = condensed(state, P64, lbw, ubw, free, ocp)
    for Bk in (1, 2, B):   # B = 1, 2: a delta-ladder retry's size
        chol_at[f'n={n} B={Bk}'], csolve_at[f'n={n} B={Bk}'] = hold_chol(
            f'n={n} B={Bk} delta {d4:.0e}', M4[:Bk], rhs4[:Bk], 'cluster')
    # the stream variant, for lanes no cluster holds, on random SPD matrices
    # (cond ~ 1e3): n = 700 at B = 4 with an indefinite and a NaN lane and at
    # B = 2 and 1, n = 555 (the first it takes), 670 (n_k=10's), 876 and 1190
    # (n_k=18's, the largest 'auto' sends to the dense direction) at B = 1
    stream_at, ssolve_at = {}, {}
    for n_s, Bs in ((700, 4), (555, 1), (670, 1), (876, 1), (1190, 1)):
        rng_s = np.random.default_rng(n_s)
        G_s = rng_s.standard_normal((Bs, n_s, n_s))
        M_s = torch.as_tensor(G_s @ G_s.transpose(0, 2, 1) / n_s + np.eye(n_s), device=dev)
        b_s = torch.as_tensor(rng_s.standard_normal((Bs, n_s)), device=dev)
        for Bk in ((4, 2, 1) if Bs == 4 else (1,)):
            stream_at[f'n={n_s} B={Bk}'], ssolve_at[f'n={n_s} B={Bk}'] = hold_chol(
                f'n={n_s} B={Bk} random SPD', M_s[:Bk], b_s[:Bk], 'stream')
    # K4's advance_state bit for bit on the block direction at the anchor
    direction4 = kkt_solve4(blocks4, *[state[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu')],
                            lbw, ubw, free, state['mu'], 1e-8, 1e-8, 1e-8)
    adv_args = (state, tuple(t.contiguous() for t in direction4[:6]), direction4[6],
                direction4[7]['err_d'], direction4[7]['err_d'], lbw, ubw, 0.99, 0.8, 1e-8)
    before = kernels.LAUNCHES['advance_state']
    adv_k, adv_p = kernels.advance_state(*adv_args), kernels.advance_state_plain(*adv_args)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES['advance_state'] == before + 1
            and all(same_bits(adv_k[k], adv_p[k]) for k in adv_p),
            'K4 advance_state differs from its plain version')
    adv_fn = lambda: kernels.advance_state(*adv_args)
    adv_in = [state[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu', 'mu')] + list(adv_args[1]) \
        + [adv_args[2], adv_args[3], adv_args[4], lbw, ubw]
    b_adv = bound(nbytes(*adv_in, *adv_k.values()))
    report['advance_state'] = dict(
        max_abs_err=0.0, ms=cuda_median_ms(adv_fn), queued_ms=cuda_median_ms(adv_fn, queued=True),
        plain_ms=cuda_median_ms(lambda: kernels.advance_state_plain(*adv_args)),
        bound_ms=b_adv[0], bound_by=b_adv[1], library_ms=None)
    phase('kernels', f'K4 advance_state anchor B={B}: bit for bit; '
          f'{report["advance_state"]["ms"]:.4f} ms, queued '
          f'{report["advance_state"]["queued_ms"]:.4f} ms, vs plain '
          f'{report["advance_state"]["plain_ms"]:.3f} ms; bound {b_adv[0]:.5f} ms ({b_adv[1]})')

    # K12 lu_factor_f64 and K13 lu_solve_f64, the host solver's dense
    # direction (opti/ipsolver.py kkt_solve, behind Trial.optimize), against
    # their plain versions (torch.linalg.lu_factor_ex and lu_solve in f64,
    # cuSOLVER on the card, which are also the library calls): on the
    # augmented K of the bench problem at the anchor (N=543: mu = 1e-3,
    # delta_c = 1e-7, delta_w 0 on lane 0 and 1e-8 .. 1e-1 on the others) at
    # B = 1 and 16, on random saddle systems at N=37 (B=4) and N=1055 (B=1),
    # with a singular lane (a zero column) and a NaN lane at N=37 and N=543
    # B=16. Gates, entry by entry or row by row so that K's large -D entries
    # at the anchor do not hide its O(1) rows: the factor's backward error
    # max |P L U - K| / (P |L| |U|) and the solve's row-wise backward error
    # max_i |K x - b|_i / (max_j |K_ij| max |x| + |b_i|) each within 10x the
    # plain version's (at least one f64 epsilon); the two solutions' gap
    # max |x - x_plain| / max |x_plain| within what their residuals allow,
    # 2 max |K^-1| (|r| + |r_plain|) / max |x_plain| (x - x_plain = K^-1
    # (r - r_plain); |K^-1| from torch.linalg.inv, the 2 for its rounding
    # and the residuals'; the (|K| |x| + |b|) scaling is no gate here: a
    # row whose exact x_i and b_i are 0 divides its residual by one of the
    # rounding's own size, O(1) for any solver);
    # the pivots equal but where a tie decides them (the first differing
    # pivot's |U_kk| equal in both to 1e-12), a failed lane's x not finite
    # and the other lanes' bits as without it, K unchanged, one launch each
    host = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=n, n_eq=ocp.n_eq,
                               n_ineq=ocp.n_ineq, device=dev)
    P_anchor = build_p_fix(ocp, build_reference(ocp, anchor['V_init']))
    P_anchor['cost'] = {k: np.asarray(v) for k, v in final_cost_values(ocp).items()}
    P_anchor = host._p(P_anchor)
    st1 = [state[k][0] for k in ('w', 's', 'y', 'lam', 'zl', 'zu')]
    d_anchor = host._derivs(st1[0], st1[2], st1[3], P_anchor)
    K_lanes = torch.stack([
        host._augmented(*d_anchor[1:], *st1, lbw, ubw, free, 1e-3, float(dw_), 1e-7, 0.)['K']
        for dw_ in [0.] + list(np.geomspace(1e-8, 1e-1, B - 1))]).contiguous()
    rhs_anchor = host._augmented(*d_anchor[1:], *st1, lbw, ubw, free, 1e-3, 0., 1e-7, 0.)['rhs']
    rhs_lanes = rhs_anchor.expand(B, -1).contiguous()

    def hold_lu64(tag, K, b, bad=()):
        """K12 and K13 on (K, b) against their plain versions, with the
        gates above; returns their records."""
        B_, N_ = K.shape[0], K.shape[1]
        good = [i for i in range(B_) if i not in bad]
        K0 = K.clone()
        before = dict(kernels.LAUNCHES)
        lu_p, piv_p = kernels.lu_factor_f64_plain(K)
        lu_p, piv_p = lu_p.contiguous(), piv_p.contiguous()   # cuSOLVER's is column-major
        lu_k, piv_k = kernels.lu_factor_f64(K)
        x_k = kernels.lu_solve_f64(lu_k, piv_k, b)
        x_p = kernels.lu_solve_f64_plain(lu_p, piv_p, b)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES['lu_factor_f64'] == before['lu_factor_f64'] + 1
                and kernels.LAUNCHES['lu_solve_f64'] == before['lu_solve_f64'] + 1,
                f'K12/K13 {tag}: launches')
        require(torch.equal(K.view(torch.int64), K0.view(torch.int64)), f'K12 {tag}: K changed')
        Kg, bg = K[good], b[good]
        eps = torch.finfo(torch.float64).eps

        def ratio(e, d):
            return torch.where(d > 0, e / d, e)

        def fac(lu, piv):
            P_, L_, U_ = torch.lu_unpack(lu[good], piv[good])
            return ratio((P_ @ L_ @ U_ - Kg).abs(),
                         P_ @ (L_.abs() @ U_.abs())).amax(dim=(1, 2))

        def resid(x):
            return ((Kg @ x[good][..., None])[..., 0] - bg).abs()

        row_max = Kg.abs().amax(dim=2)

        def res(x):
            return ratio(resid(x), row_max * x[good].abs().amax(dim=1, keepdim=True)
                         + bg.abs()).amax(dim=1)
        fac_k, fac_p = fac(lu_k, piv_k), fac(lu_p, piv_p)
        res_k, res_p = res(x_k), res(x_p)
        require(bool((fac_k <= 10 * torch.clamp(fac_p, min=eps)).all()),
                f'K12 {tag}: max |P L U - K| / (P |L| |U|) {fac_k.tolist()} vs plain '
                f'{fac_p.tolist()}')
        require(bool((res_k <= 10 * torch.clamp(res_p, min=eps)).all()),
                f'K13 {tag}: backward errors {res_k.tolist()} vs plain {res_p.tolist()}')
        xp_max = x_p[good].abs().amax(dim=1)
        gap_limit = 2 * (torch.linalg.inv(Kg).abs() @ (resid(x_k) + resid(x_p))[..., None]
                         )[..., 0].amax(dim=1) / xp_max
        gaps = (x_k[good] - x_p[good]).abs().amax(dim=1) / xp_max
        require(bool((gaps <= gap_limit).all()),
                f'K13 {tag}: max |x - x_plain| / max |x_plain| {gaps.tolist()} beyond what '
                f'the residuals allow, {gap_limit.tolist()}')
        ties = 0
        for i in good:
            diff_at = torch.nonzero(piv_k[i] != piv_p[i]).flatten()
            if diff_at.numel():
                k0 = int(diff_at[0])
                uk, up = abs(float(lu_k[i, k0, k0])), abs(float(lu_p[i, k0, k0]))
                require(abs(uk - up) <= 1e-12 * max(uk, up),
                        f'K12 {tag}: lane {i} pivots differ at {k0} without a tie')
                ties += 1
        for i in bad:
            require(not bool(torch.isfinite(x_k[i]).all()) and not bool(torch.isfinite(x_p[i]).all()),
                    f'K12/K13 {tag}: the failed lane {i} gave a finite solution')
        if bad:
            lu_c, piv_c = kernels.lu_factor_f64(K[good].contiguous())
            x_c = kernels.lu_solve_f64(lu_c, piv_c, b[good].contiguous())
            require(torch.equal(x_c.view(torch.int64), x_k[good].view(torch.int64)),
                    f'K12/K13 {tag}: a failed lane changed another lane')
        x_gap = float(gaps.max())
        factor = lambda: kernels.lu_factor_f64(K)
        plain_f = lambda: kernels.lu_factor_f64_plain(K)
        solve = lambda: kernels.lu_solve_f64(lu_k, piv_k, b)
        b_col = b[..., None].contiguous()
        plain_s = lambda: torch.linalg.lu_solve(lu_p, piv_p, b_col)
        b12 = lu_factor_f64_bound(N_, B_)
        b13 = lu_solve_f64_bound(N_, B_)
        g12 = kernels.lu_factor_f64_geometry(N_, B_)
        a12 = kernels.cluster_max_active('lu_factor_f64', g12)
        k12 = dict(max_abs_err=float(fac_k.max()), ms=cuda_median_ms(factor),
                   queued_ms=cuda_median_ms(factor, queued=True),
                   plain_ms=cuda_median_ms(plain_f), bound_ms=b12[0], bound_by=b12[1],
                   pivot_ties=ties, C=g12.C)
        k12['library_ms'] = k12['plain_ms']
        k12['library_queued_ms'] = cuda_median_ms(plain_f, queued=True)
        k13 = dict(max_abs_err=x_gap, gap_limit=float(gap_limit.min()),
                   backward_error=float(res_k.max()), ms=cuda_median_ms(solve),
                   queued_ms=cuda_median_ms(solve, queued=True), plain_ms=cuda_median_ms(plain_s),
                   bound_ms=b13[0], bound_by=b13[1])
        k13['library_ms'] = k13['plain_ms']
        k13['library_queued_ms'] = cuda_median_ms(plain_s, queued=True)
        phase('kernels', f'K12 lu_factor_f64 {tag}: clusters of C={g12.C} CTAs (panel p to rank '
              f'p % C), {g12.smem_bytes} B of shared memory a rank; {a12} clusters at once: '
              f'{-(-B_ // a12)} wave(s)')
        phase('kernels', f'K12 lu_factor_f64 {tag}: max |P L U - K| / (P |L| |U|) '
              f'{float(fac_k.max()):.2e} vs '
              f'plain {float(fac_p.max()):.2e}; pivots as plain on {len(good) - ties}/{len(good)} '
              f'lanes{f", the others parting at a tie" if ties else ""}{"; failed lanes " + str(list(bad)) + " not finite, the others unchanged" if bad else ""}; '
              f'{k12["ms"]:.3f} ms, queued {k12["queued_ms"]:.3f} ms; torch.linalg.lu_factor_ex '
              f'{k12["library_ms"]:.3f} ms, queued {k12["library_queued_ms"]:.3f} ms; bound '
              f'{b12[0]:.5f} ms ({b12[1]})')
        g13 = kernels.lu_solve_f64_geometry(N_, B_)
        a13 = kernels.cluster_max_active('lu_solve_f64', g13)
        phase('kernels', f'K13 lu_solve_f64 {tag}: clusters of C={g13.C} CTAs (row tile i to rank '
              f'i % C), {g13.smem_bytes} B of shared memory a rank; {a13} clusters at once: '
              f'{-(-B_ // a13)} wave(s)')
        phase('kernels', f'K13 lu_solve_f64 {tag}: row-wise backward error max |K x - b|_i / '
              f'(max |K_i.| max |x| + |b_i|) {float(res_k.max()):.2e} vs plain '
              f'{float(res_p.max()):.2e}; max |x - x_plain| / max |x_plain| '
              f'{[float(f"{g:.3e}") for g in gaps.tolist()]} within '
              f'{[float(f"{g:.3e}") for g in gap_limit.tolist()]}; '
              f'{k13["ms"]:.4f} ms, queued {k13["queued_ms"]:.4f} ms; torch.linalg.lu_solve '
              f'{k13["library_ms"]:.3f} ms, queued {k13["library_queued_ms"]:.3f} ms; bound '
              f'{b13[0]:.5f} ms ({b13[1]})')
        return k12, k13

    lu64_at, solve64_at = {}, {}
    K37, b37 = (torch.as_tensor(a, device=dev) for a in ktests.host_kkt_matrices(37, 4, seed=37))
    K37[1, :, 5] = 0.
    K37[2, 4, 7] = float('nan')
    lu64_at['N=37 B=4'], solve64_at['N=37 B=4'] = hold_lu64('N=37 B=4 random', K37, b37, (1, 2))
    for Bk in (1, B):
        lu64_at[f'N={N} B={Bk}'], solve64_at[f'N={N} B={Bk}'] = hold_lu64(
            f'N={N} B={Bk} anchor', K_lanes[:Bk].contiguous(), rhs_lanes[:Bk].contiguous())
    K_bad = K_lanes.clone()
    K_bad[1, :, 100] = 0.
    K_bad[2, 300, 7] = float('nan')
    hold_lu64(f'N={N} B={B} anchor, a singular and a NaN lane', K_bad, rhs_lanes, (1, 2))
    K1055, b1055 = (torch.as_tensor(a, device=dev)
                    for a in ktests.host_kkt_matrices(N8, 1, seed=N8, n=540))
    lu64_at[f'N={N8} B=1'], solve64_at[f'N={N8} B=1'] = hold_lu64(f'N={N8} B=1 random', K1055,
                                                                  b1055)
    # n_k=10's N (1311), and n_k=14's and n_k=18's (1823, the first the
    # previous K12 refused, and 2335, the largest the dense direction takes):
    # random saddle systems with their n
    for N_r, n_r in ((1311, 670), (1823, 930), (2335, 1190)):
        K_r, b_r = (torch.as_tensor(a, device=dev)
                    for a in ktests.host_kkt_matrices(N_r, 1, seed=N_r, n=n_r))
        lu64_at[f'N={N_r} B=1'], solve64_at[f'N={N_r} B=1'] = hold_lu64(
            f'N={N_r} B=1 random', K_r, b_r)
    report['lu_factor_f64'] = dict(lu64_at[f'N={N} B=1'], at=lu64_at)
    report['lu_solve_f64'] = dict(solve64_at[f'N={N} B=1'], at=solve64_at)   # phase 9 adds rows

    # aten operations one direction call dispatches on the card, and its
    # time, with each factor
    for fac in ('lu', 'qr'):
        _, direction = batch.make_ip_step(ocp, kkt='auglu', split=True, kappa_mu=0.4,
                                          auglu_factor=fac)
        n_ops, dir_ms = count_and_time(lambda: direction(state, dv, lbw, ubw, free), N_TIMED)
        phase('kernels', f'one {fac} direction call at B={B}: {n_ops} aten ops dispatched, '
              f'{sorted(dir_ms)[N_TIMED // 2]:.3f} ms (host clock, synchronized, median of '
              f'{N_TIMED})')

    # one iteration from the anchor on the card against the plain path on
    # the CPU, 2 lanes. LU: the iterates agree to 1e-6 of the step (the f32
    # factors differ by pivot ties and rounding; two f64 refinement sweeps
    # bring both directions to the same f64 solution within that). QR: one
    # guarded sweep leaves each side at the accuracy of its own f32 solve,
    # 1e-2 of the step (on the CPU the JAX package's and LAPACK's QR
    # directions differ by 5e-4 of it)
    state_h, P64_h, lbw_h, ubw_h, free_h, _ = wind_sweep_problem(trial, anchor, 2,
                                                                 device='cpu')
    sel = torch.tensor([0, B - 1], device=dev)
    for fac, tol in (('lu', 1e-6), ('qr', 1e-2)):
        it_c = make_refiner(ocp, lbw, ubw, free, auglu_factor=fac)(
            _take_lanes(state, sel), _take_lanes(P64, sel))
        it_h = make_refiner(ocp, lbw_h, ubw_h, free_h, auglu_factor=fac)(state_h, P64_h)
        step = float((it_h['w'] - state_h['w']).abs().max())
        dw_gap = float((it_c['w'].cpu() - it_h['w']).abs().max())
        require(dw_gap <= tol * step,
                f'one {fac} iteration: |w diff| {dw_gap:.3e}, step {step:.3e}')
        phase('kernels', f'one {fac} iteration card vs cpu plain: max |w diff| {dw_gap:.3e} '
              f'(step {step:.3e})')

    # the cold solves of Trial.optimize, [slice-trial] .. [slice-trial-configs],
    # run in a second process (trial_worker) beside the batched slices here,
    # from now until the n_k=8 slices, whose [kernels] rows time kernels with
    # the card to main alone; its lines are printed when it is joined
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_')
    worker_out = os.path.join(work_dir, 'trials.pt')
    worker_log = os.path.join(work_dir, 'trials.log')
    with open(worker_log, 'w') as log:
        worker = subprocess.Popen([sys.executable, os.path.abspath(__file__), '--trials',
                                   worker_out], stdout=log, stderr=subprocess.STDOUT,
                                  env=dict(os.environ, CHIP_SMOKE_T0=repr(T_START)))
    WORKERS.append((worker, worker_log, work_dir))
    phase('slice-trial', f'the cold solves of Trial.optimize started in a second process '
          f'(pid {worker.pid}), beside [slice] .. [slice-dense]')

    # --- 4. the slices and 5. their paths ---------------------------------
    # the plain version of every kernel is counted while a slice runs: on
    # the card none may run
    plain_names = ('newton_system', 'equilibrate', 'kkt_assemble_plain',
                   'kkt_assemble_scaled_plain', 'newton_kkt_plain', 'lu_factor_batched_plain',
                   'lu_solve_batched_plain', 'ruiz_scale_plain', 'qr_factor_batched_plain',
                   'qr_solve_batched_plain', 'advance_state_plain', 'ip_step_plain',
                   'block_factor_plain', 'block_solve_plain', 'chol_factor_batched_plain',
                   'chol_solve_batched_plain')

    def run_slice(tag, fac, cell, variant, max_iter=100, converge=True, cut=''):
        """The cell ``cell`` (ocp, state, P64, lbw, ubw, free, u_refs) with
        the ``fac`` factor, every factor through its ``variant``: the launch
        counts set to 0 just before, read just after. With ``converge`` every
        lane must converge within max_iter; ``cut`` names a cut of its depth
        on its phase line. Returns the run's launches,
        iterations and per-lane average powers."""
        ocp_, state_, P64_, lbw_, ubw_, free_, u_refs_ = cell
        plain_calls = {k: 0 for k in plain_names}
        saved = {k: getattr(kernels, k) for k in plain_calls}

        def counted(name):
            def call(*args, **kwargs):
                plain_calls[name] += 1
                return saved[name](*args, **kwargs)
            return call
        for k in plain_calls:
            setattr(kernels, k, counted(k))
        k5_lanes, ruiz = [], kernels.ruiz_scale

        def ruiz_recorded(K):   # the lanes of each K5 call (the wrapper counts its launch)
            k5_lanes.append(K.shape[0])
            return ruiz(K)
        kernels.ruiz_scale = ruiz_recorded
        kernels.reset_launch_counts()
        try:
            res = refine(ocp_, state_, P64_, lbw_, ubw_, free_, tol=1e-5, verify_tol=1e-4,
                         max_iter=max_iter, kappa_mu=0.4, time_pieces=True, auglu_factor=fac)
        finally:
            for k, fn in saved.items():
                setattr(kernels, k, fn)
            kernels.ruiz_scale = ruiz
        launches = dict(kernels.LAUNCHES)
        it = res['n_iter']
        conv = res['converged'].cpu().numpy()
        latched = res['latched'].cpu().numpy()
        eq_res = res['eq_res'].cpu().numpy()
        err = res['state']['err'].cpu().numpy()
        powers = average_power(ocp_, res['state']['w'], P64_).cpu().numpy()
        pieces = {k: 1e3 * v / it for k, v in res['times'].items()}
        phase(tag, f'auglu_factor={fac!r}, n={ocp_.vstruct.total}, m={ocp_.n_eq + ocp_.n_ineq}, '
              f'B={B} lanes, u_ref {u_refs_[0]:.2f}..{u_refs_[-1]:.2f} m/s: {it} iterations, '
              f'{1e3 * res["seconds"] / it:.1f} ms/iter (vals {pieces["vals"]:.1f}, jac '
              f'{pieces["jac"]:.1f}, hess {pieces["hess"]:.1f}, direction '
              f'{pieces["direction"]:.1f} ms), latched {int(latched.sum())}/{B}, converged '
              f'{int(conv.sum())}/{B}, KKT error {err.min():.2e}..{err.max():.2e}, max f64 eq '
              f'{eq_res.max():.2e}, P_avg {powers.min() / 1e3:.2f}..{powers.max() / 1e3:.2f} kW, '
              f'{conv.sum() / res["seconds"]:.3f} solves/s{"; " + cut if cut else ""}')
        if converge:
            require(conv.all(), f'{fac}: unconverged lanes: {np.where(~conv)[0]}')
            require(np.isfinite(powers).all(), f'{fac}: non-finite average power {powers}')
        require(all(bool(torch.isfinite(v).all()) for v in res['state'].values()),
                f'{tag}: non-finite iterates')

        # the path: K1 and K4 once per iteration; a factor per iteration and
        # one more per delta-ladder retry, each retry behind one launch of its
        # factor's retry assembly (the slice may need none: the retry
        # assemblies are held above, and on the card in the direction solves'
        # ladder lane); every factor through ``variant`` (cluster at N=543,
        # blocked at N=1055), none through the other
        other = {'cluster': 'blocked', 'blocked': 'cluster'}[variant]
        lu_names = ('kkt_assemble_scaled', 'lu_factor_batched', 'lu_factor_cluster',
                    'lu_factor_blocked', 'lu_solve_batched')
        qr_names = ('kkt_assemble', 'ruiz_scale', 'qr_factor_batched', 'qr_factor_cluster',
                    'qr_factor_blocked', 'qr_solve_batched')
        require(launches['newton_kkt'] == it and launches['ip_step'] == it,
                f'{fac}: K1 and K4 did not run once per iteration ({it}): {launches}')
        if fac == 'lu':
            retries = launches['kkt_assemble_scaled']
            require(launches['lu_factor_batched'] == it + retries
                    and launches[f'lu_factor_{variant}'] == launches['lu_factor_batched']
                    and launches[f'lu_factor_{other}'] == 0,
                    f'lu: not one {variant} factor per iteration and retry: {launches}')
            # every attempt solves once and refines twice on its factor
            require(launches['lu_solve_batched'] == 3 * launches['lu_factor_batched'],
                    f'lu: the slice did not solve three times per factor: {launches}')
            require(not any(launches[k] for k in qr_names), f'lu: a QR kernel ran: {launches}')
        else:
            retries = launches['kkt_assemble']
            require(launches['ruiz_scale'] == launches['qr_factor_batched'] == it + retries
                    and launches[f'qr_factor_{variant}'] == launches['qr_factor_batched']
                    and launches[f'qr_factor_{other}'] == 0,
                    f'qr: not one K5 and one {variant} K6 per iteration and retry: {launches}')
            # every attempt solves once and once more in its guarded sweep
            require(launches['qr_solve_batched'] == 2 * launches['qr_factor_batched'],
                    f'qr: the slice did not solve twice per factor: {launches}')
            require(not any(launches[k] for k in lu_names), f'qr: an LU kernel ran: {launches}')
        require(not any(plain_calls.values()), f'{fac}: plain versions ran: {plain_calls}')
        require(all(v.is_cuda for v in res['state'].values()), f'{fac}: the state left the card')
        k5_hist = {b_: k5_lanes.count(b_) for b_ in sorted(set(k5_lanes))}
        if fac == 'qr':
            k5_lanes_at[tag] = k5_hist
        phase('path', f'{tag}: kernel launches in the slice run: {launches}; {retries} ladder '
              f'retries; every factor through the {variant} variant; plain versions called: '
              f'{sum(plain_calls.values())}; K5 calls by lanes: {k5_hist}')
        return launches, it, powers

    k5_lanes_at = report['ruiz_scale']['lanes_per_call'] = {}
    cell4 = (ocp, state, P64, lbw, ubw, free, u_refs)
    launches_lu, it_lu, powers_lu = run_slice(
        'slice', 'lu', cell4, 'cluster', LU_ITERS, converge=False,
        cut=f'CUT: a fixed {LU_ITERS} iterations (22 to convergence before the cut), for the time '
            f'of [slice-trial]; convergence of this path is gated on the CPU')
    launches_qr, it_qr, powers_qr = run_slice('slice-qr', 'qr', cell4, 'cluster')
    power_gap = float(np.abs(powers_qr / powers_lu - 1.).max())
    phase('slice-qr', f'per-lane average power, QR converged against LU after its {it_lu} '
          f'iterations (cut from convergence at 22 to LU_ITERS={LU_ITERS} for [slice-trial]\'s '
          f'time; not gated): max relative gap {power_gap:.3e} '
          f'({it_qr} against {it_lu} iterations)')

    # --- 6. the reference's batched solver: [slice-block], [slice-dense] --
    # make_batched_solver with the JAX package's defaults (kkt='auto', which
    # is 'block' for this configuration; kappa_mu 0.8) and with kkt='dense'
    # in f64 as bench.py runs BENCH_KKT=dense, on the same 16 lanes from the
    # make_batched_solver's own bounds (the relaxed final bounds, before
    # split_pins). Gates: every lane reaches err <= 1e-5 with f64 max |eq|
    # <= 1e-4, the 9.5 m/s lane at the JAX package's power and period
    # (CPU, f64, JAX_CONVERGED) to 1e-6
    # relative, and the first iteration on the card within the CPU lockstep
    # test's tolerance of the plain path on the CPU (FIRST_ITER, the gap in
    # w over the step's size: the directions come from systems of
    # cond(M) ~ 1e19, and the port's and the JAX package's first block
    # directions already differ by ~1% of the step on the CPU). The 10.5 m/s
    # lane is printed beside both JAX optima; which one it reaches is
    # recorded, not gated (on the CPU the port's block path latches at the
    # auglu optimum where the JAX package's goes on to another).
    lbf, ubf = sweep_bounds(trial)
    state_h16 = {k: v.cpu() for k, v in state.items()}
    P_h16 = tree_map(lambda t: t.cpu(), P64)

    def run_solver(tag, kkt, mode, kw, n_iter, converge=True, cut='', sweep=None):
        """make_batched_solver with ``kkt`` ('auto': the default, not passed),
        resolving to ``mode``: the first iteration against the CPU, then the
        run, its gates (with ``converge``) and its path. With ``sweep`` the
        run is sweep.run_batched(anchor_trial=anchor_trial), the reference's
        Sweep API over the same solver; ``cut`` names a cut of its depth."""
        pick = {} if kkt == 'auto' else dict(kkt=kkt)
        step_c = batch.make_ip_step(ocp, **pick, **kw)
        t0 = time.time()
        it_c = step_c(state, P64, lbw, ubw, free)
        torch.cuda.synchronize()
        t_card = time.time() - t0
        t0 = time.time()
        it_h = step_c(state_h16, P_h16, lbw.cpu(), ubw.cpu(), free.cpu())
        t_cpu = time.time() - t0
        step_size = (it_h['w'] - state_h16['w']).abs().amax(dim=1)
        gap = ((it_c['w'].cpu() - it_h['w']).abs().amax(dim=1) / step_size)
        require(float(gap.max()) <= FIRST_ITER[mode], f'{tag}: the first iteration on the card is '
                f'{gap.tolist()} of the step from the CPU\'s (tolerance {FIRST_ITER[mode]})')
        phase(tag, f'first iteration card vs cpu plain, 16 lanes: max |w diff| / step '
              f'{float(gap.max()):.3e} (tolerance {FIRST_ITER[mode]}); {t_card:.1f} s on the card '
              f'(first call), {t_cpu:.1f} s on the CPU')
        if sweep is None:
            solve = batch.make_batched_solver(ocp, lbf, ubf, n_iter=n_iter, batch_p=True,
                                              tol=1e-5, **pick, **kw)
        plain_calls = {k: 0 for k in SOLVER_PLAIN}
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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if sweep is None:
                out = solve(state, P64)
            else:
                sweep.run_batched(anchor_trial=anchor_trial, n_iter=n_iter, tol=1e-5, device=dev)
                out = sweep.batched_state
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(kernels, k, fn)
        launches = dict(kernels.LAUNCHES)
        it = solve.n_iter if sweep is None else sweep.n_iter
        err = out['err'].cpu().numpy()
        eq = torch.abs(torch.func.vmap(ocp.eq_fn)(out['w'], P64)).amax(dim=1).cpu().numpy()
        powers = average_power(ocp, out['w'], P64).cpu().numpy()
        periods = torch.func.vmap(ocp.time_period_fn)(out['w']).cpu().numpy()
        conv = (err <= 1e-5) & (eq <= 1e-4)
        api = 'Sweep.run_batched over ' if sweep is not None else ''
        phase(tag, f'{api}make_batched_solver(kkt={kkt!r} -> {mode!r}'
              f'{", solve_dtype=float64" if kw else ""}), '
              f'B={B}, u_ref {u_refs[0]:.2f}..{u_refs[-1]:.2f} m/s: {it} iterations (the '
              f'loop\'s own count; cap {n_iter}), {1e3 * seconds / it:.1f} ms/iter, converged '
              f'{int(conv.sum())}/{B}, err {err.min():.2e}..{err.max():.2e}, max f64 eq '
              f'{eq.max():.2e}, {conv.sum() / seconds:.3f} solves/s{"; " + cut if cut else ""}')
        for b_ in range(B):
            phase(tag, f'lane {b_:2d} u_ref {u_refs[b_]:.4f} m/s: P_avg {powers[b_]:.6f} W, T '
                  f'{periods[b_]:.6f} s, err {err[b_]:.2e}, max eq {eq[b_]:.2e}')
        ref_p, ref_t = JAX_CONVERGED[mode]
        phase(tag, f'lane u_ref {u_refs[-1]:.2f}: {powers[-1]:.6f} W / {periods[-1]:.6f} s; the JAX '
              f'package (CPU) reaches {ref_p[1]:.6f} W / {ref_t[1]:.6f} s in this mode, '
              f'{JAX_CONVERGED["auglu_10.5"]:.3f} W with auglu')
        dp = abs(powers[0] / ref_p[0] - 1.)
        dt_ = abs(periods[0] / ref_t[0] - 1.)
        if converge:
            require(conv.all(), f'{tag}: unconverged lanes {np.where(~conv)[0]} (err {err}, '
                    f'eq {eq})')
            require(dp <= 1e-6 and dt_ <= 1e-6, f'{tag}: the 9.5 m/s lane at {powers[0]} W / '
                    f'{periods[0]} s, the JAX package at {ref_p[0]} / {ref_t[0]}')
        phase(tag, f'lane u_ref {u_refs[0]:.2f}: power and period within {dp:.2e} and {dt_:.2e} of '
              f'the JAX package\'s{"" if converge else " (not gated: the run is cut)"}')
        if sweep is not None:
            cases = sweep.sweep_dict.values()
            phase('slice-sweep', f'Sweep.run_batched: {sum(c["success"] for c in cases)}/{B} cases '
                  f'succeed by its own test (finite, max |eq| < 1e-4); power '
                  f'{min(c["global_outputs"]["avg_power_watts"] for c in cases) / 1e3:.3f}..'
                  f'{max(c["global_outputs"]["avg_power_watts"] for c in cases) / 1e3:.3f} kW')
            require(all(c['success'] for c in cases), f'{tag}: a Sweep case failed its own test')
        # the path
        if mode == 'block':
            fac, sol = 'block_factor', 'block_solve'
        else:
            fac, sol = 'chol_factor_batched', 'chol_solve_batched'
        retries = launches[fac] - it
        require(retries >= 0 and launches[sol] == 3 * it and launches['advance_state'] == it,
                f'{tag}: not one {fac} per ladder attempt, three {sol} and one advance_state per '
                f'iteration ({it}): {launches}')
        variants = ()
        if mode == 'dense':   # every K10 launch takes the cluster variant at n = 280
            variants = ('chol_factor_cluster',)
            require(launches['chol_factor_cluster'] == launches[fac]
                    and launches['chol_factor_stream'] == 0,
                    f'{tag}: K10 launches not all in the cluster variant: {launches}')
        others = [k for k in launches
                  if k not in (fac, sol, 'advance_state') + variants and launches[k]]
        require(not others, f'{tag}: other kernels ran: {others}')
        require(not any(plain_calls.values()), f'{tag}: plain versions ran: {plain_calls}')
        require(all(v.is_cuda for v in out.values()), f'{tag}: the state left the card')
        phase('path', f'{tag}: kernel launches in the run: '
              f'{ {k: v for k, v in launches.items() if v} }; {fac} {launches[fac]} = {it} '
              f'iterations + {retries} ladder retries{", all in the cluster variant" if variants else ""}, '
              f'{sol} 3 per iteration, advance_state 1 per '
              f'iteration; plain versions called: {sum(plain_calls.values())}; state on the card')
        return launches, it, seconds

    # one iteration's pieces, host clock around each, device synchronized
    def pieces_ms(kkt, kw):
        if kkt == 'block':
            derivs_b, kkt_b, _ = make_block_kkt(ocp)
            fns = [('derivs', lambda: derivs_b(state['w'], state['y'], state['lam'], P64))]
            fns.append(('direction', lambda blk: kkt_b(
                blk, *[state[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu')], lbw, ubw, free,
                state['mu'], 1e-8, 1e-8, 1e-8)))
        else:
            derivs_d, direction_d = batch.make_ip_step(ocp, kkt=kkt, split=True, **kw)
            fns = [('derivs', lambda: derivs_d(state['w'], state['y'], state['lam'], P64)),
                   ('direction', lambda dv_: direction_d(state, dv_, lbw, ubw, free))]
        times = {}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mid = fns[0][1]()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fns[1][1](mid)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            times.setdefault('derivs', []).append(1e3 * (t1 - t0))
            times.setdefault('direction', []).append(1e3 * (t2 - t1))
        return {k: sorted(v)[1] for k, v in times.items()}

    # [slice-sweep]: the same 16 lanes through the reference's Sweep API, from
    # the anchor installed as a solved trial: where Sweep.batched_problem
    # gives [slice-block]'s start, bounds and P bit for bit, [slice-block]
    # runs through Sweep.run_batched with its gates as they are; else
    # [slice-block] runs as before and run_batched three iterations as a
    # path check
    anchor_trial = Trial(bench_options(), 'chip_smoke_anchor').build()
    require(install_anchor(anchor_trial, ANCHOR), 'the anchor does not install as a solution')
    sweep = Sweep(bench_options(), [{'user_options.wind.u_ref': float(u)} for u in u_refs],
                  'chip_smoke')
    lbf_s, ubf_s, P_s, state_s = sweep.batched_problem(anchor_trial, dev)
    P_s = batch.p_from_numpy(P_s, dev)
    diff = [name for name, same in (
        ('lower bounds', np.array_equal(lbf_s, lbf)), ('upper bounds', np.array_equal(ubf_s, ubf)),
        ('P', same_tree(P_s, P64)),
        ('start', all(torch.equal(state_s[k], state[k]) for k in state)))
        if not same]
    phase('slice-sweep', f'Sweep.batched_problem against [slice-block]\'s set-up: '
          f'{"the same start, bounds and P bit for bit: [slice-block] runs through Sweep.run_batched" if not diff else "differs in " + ", ".join(diff)}')

    solver_runs = {}
    for tag, kkt, kw, cap, conv_, cut_ in (
            ('slice-block', 'auto', {}, 200, True, ''),
            ('slice-dense', 'dense', dict(solve_dtype=torch.float64), DENSE_ITERS, False,
             f'CUT: at most {DENSE_ITERS} iterations (34 to convergence before the cut), for the '
             f'time of [slice-trial]; convergence of this path is gated on the CPU')):
        mode = batch.resolve_kkt(ocp, kkt)
        require(mode == ('block' if kkt == 'auto' else kkt), f'{tag}: kkt resolves to {mode}')
        pc = pieces_ms(mode, kw)
        phase(tag, f'one iteration\'s pieces at B={B}, median of 3 (host clock, synchronized): '
              f'derivatives {pc["derivs"]:.1f} ms, direction {pc["direction"]:.1f} ms')
        solver_runs[mode] = run_solver(tag, kkt, mode, kw, cap, conv_, cut_,
                                       sweep if mode == 'block' and not diff else None)
    if diff:
        sweep.run_batched(anchor_trial=anchor_trial, n_iter=3, tol=1e-5, device=dev)
        require(sweep.n_iter == 3 and all(bool(torch.isfinite(v).all())
                                          for v in sweep.batched_state.values()),
                'slice-sweep: three iterations of Sweep.run_batched')
        phase('slice-sweep', 'Sweep.run_batched, 3 iterations as a path check: finite iterates')
    launches_block, launches_dense = solver_runs['block'][0], solver_runs['dense'][0]

    # the trial worker's end: its lines, then its gates' verdict
    try:
        worker_rc = worker.wait(timeout=max(60., WORKER_DEADLINE - (time.time() - T_START)))
    except subprocess.TimeoutExpired:
        worker_rc = None
    with open(worker_log) as log:
        sys.stdout.write(log.read())
    sys.stdout.flush()
    require(worker_rc == 0 and os.path.exists(worker_out),
            f'the trial worker ([slice-trial] .. [slice-trial-configs]) failed: exit code '
            f'{worker_rc}' + (' (still running past its deadline)' if worker_rc is None else ''))

    # --- 7. the n_k=8 slices ----------------------------------------------
    # bench_options(n_k=8) from tests/artifacts/bench_anchor_nk8_d3.npz:
    # n=540, m=515, N=1055, which only the blocked factors take. The anchor
    # is no start from which the batched refinement converges, in the JAX
    # package (CPU, LU: no lane of 9.5..10.5 m/s, nor the anchor's own 10 m/s,
    # latches within 100 iterations; tests/test_torch_nk8.py) as in the port,
    # so these slices run NK8_ITERS iterations and gate what the reference
    # fixes: the first LU iteration on the card against the plain path on the
    # CPU (2 lanes; 1e-3 of the step: at this anchor an f32 and an f64 LU
    # factor give directions 2.7e-5 of the step apart on the CPU), finite
    # iterates, and the path. The QR recipe's first iterate depends on the
    # rounding of its one guarded sweep here (LAPACK's f32 and f64 QR give
    # iterates 13 steps apart on the CPU), so its gap is printed, not gated.
    trial8 = Trial(bench_options(n_k=8), 'chip_smoke_nk8').build()
    ocp8 = trial8.ocp
    anchor8 = dict(np.load(ANCHOR8))
    cell8 = (ocp8,) + wind_sweep_problem(trial8, anchor8, B, device=dev)
    require(ocp8.vstruct.total + ocp8.n_eq + ocp8.n_ineq == N8, 'n_k=8 is not N=1055')
    # K1 and K4 within their compiled limits (n=540 <= NEWTON_ROW_MAX, n and
    # m <= STEP_ITEMS) on the n_k=8 anchor's systems: K1 bit for bit in both
    # modes, K4 at its stated tolerances on the LU direction's solution
    state8, P64_8, lbw8, ubw8, free8 = cell8[1:6]
    w8, y8, lam8 = state8['w'], state8['y'], state8['lam']
    vals8, jac8, hess8 = make_structured_derivs(ocp8)
    dv8 = tuple(vals8(w8, y8, lam8, P64_8)) + tuple(J.to(f32) for J in jac8(w8, P64_8)) \
        + (hess8(w8, y8, lam8, P64_8).to(f32),)
    args8 = (state8, dv8, lbw8, ubw8, free8)
    sys8_k, _, k1_at[f'n_k=8 B={B}'] = hold_k1(f'n_k=8 anchor B={B}', args8)
    _, _, k1_at[f'unscaled n_k=8 B={B}'] = hold_k1(f'unscaled, n_k=8 anchor B={B}', args8,
                                                    scaled=False)
    x8, ok8 = batch._ladder_solve(sys8_k, free8, ocp8.vstruct.total, 1e-8, 7, 100.)
    k4_at[f'n_k=8 B={B}'] = hold_k4(f'n_k=8 anchor B={B}', x8, ok8, sys8_k,
                                   ({k: state8[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu',
                                                            'mu')},) + args8[1:])
    # K8/K9 on the n_k=8 anchor's frames (n_k=8: a 108 x 108 reduced system)
    # and K10/K11 on its condensed M (n=540), B=16
    maps8, asm8, own8, imaps8, fV8, _, _ = block_inputs(ocp8, state8, P64_8, lbw8, ubw8, free8)
    block_at[f'n_k=8 B={B}'], bsolve_at[f'n_k=8 B={B}'] = hold_block(
        f'n_k=8 B={B}', asm8['Frame'], own8, imaps8, asm8['rhs_w'], fV8, free8, maps8.layout)
    M8c, rhs8c, d8 = condensed(state8, P64_8, lbw8, ubw8, free8, ocp8)
    n8c = M8c.shape[1]
    chol_at[f'n={n8c} B={B}'], csolve_at[f'n={n8c} B={B}'] = hold_chol(
        f'n={n8c} B={B} delta {d8:.0e}', M8c, rhs8c, 'cluster')
    report['block_factor'] = dict(block_at[f'n_k=4 B={B}'], at=block_at)
    report['block_solve'] = dict(bsolve_at[f'n_k=4 B={B}'], at=bsolve_at)
    report['chol_factor_cluster'] = dict(chol_at[f'n={n} B={B}'], at=chol_at)
    report['chol_solve_batched'] = dict(csolve_at[f'n={n} B={B}'], at=csolve_at)
    cell8_h = wind_sweep_problem(trial8, anchor8, 2, device='cpu')
    for fac in ('lu', 'qr'):
        it_c = make_refiner(ocp8, *cell8[3:6], auglu_factor=fac)(
            _take_lanes(cell8[1], sel), _take_lanes(cell8[2], sel))
        it_h = make_refiner(ocp8, *cell8_h[2:5], auglu_factor=fac)(cell8_h[0], cell8_h[1])
        step = float((it_h['w'] - cell8_h[0]['w']).abs().max())
        dw_gap = float((it_c['w'].cpu() - it_h['w']).abs().max())
        require(bool(torch.isfinite(it_c['w']).all()), f'n_k=8: one {fac} iteration: non-finite w')
        if fac == 'lu':
            require(dw_gap <= 1e-3 * step,
                    f'n_k=8: one lu iteration: |w diff| {dw_gap:.3e}, step {step:.3e}')
        phase('slice-nk8', f'one {fac} iteration at n_k=8 card vs cpu plain: max |w diff| '
              f'{dw_gap:.3e} (step {step:.3e}{"; not gated" if fac == "qr" else ""})')
    cut8 = f'CUT: {NK8_ITERS} iterations (12 before), for the time of [slice-trial]'
    launches_lu8, _, powers_lu8 = run_slice('slice-nk8', 'lu', cell8, 'blocked', NK8_ITERS,
                                            converge=False, cut=cut8)
    launches_qr8, _, powers_qr8 = run_slice('slice-nk8-qr', 'qr', cell8, 'blocked', NK8_ITERS,
                                            converge=False, cut=cut8)
    phase('slice-nk8-qr', f'per-lane average power after {NK8_ITERS} iterations, QR against LU: '
          f'max relative gap {float(np.abs(powers_qr8 / powers_lu8 - 1.).max()):.3e} (the '
          f'lanes have not converged: not gated)')

    # --- 8.-11. the cold solves' [kernels] rows --------------------------
    # K10 and K12/K13 on the M and K of the trial worker's paths, timed here
    # with the card to main alone: [slice-trial-nk18]'s and
    # [slice-trial-6dof]'s (K10's stream variant), the dual kite's (K10's
    # cluster variant, K12/K13) and the actuator model's K
    res = torch.load(worker_out)
    launches_trial, launches_nk18 = res['launches_trial'], res['launches_nk18']
    launches_6dof, launches_configs = res['launches_6dof'], res['launches_configs']
    M18, K18_, rhs18 = (t.to(dev) for t in res['systems']['nk18'])
    n18, N18 = M18.shape[1], K18_.shape[1]
    b18 = torch.as_tensor(np.random.default_rng(n18).standard_normal((1, n18)), device=dev)
    stream_at[f'n={n18} B=1 path'], ssolve_at[f'n={n18} B=1 path'] = hold_chol(
        f'n={n18} B=1 the path\'s M', M18, b18, 'stream')
    lu64_at[f'N={N18} B=1 path'], solve64_at[f'N={N18} B=1 path'] = hold_lu64(
        f'N={N18} B=1 the path\'s K', K18_, rhs18)
    M6, K6_, rhs6 = (t.to(dev) for t in res['systems']['6dof'])
    n6, N6 = M6.shape[1], K6_.shape[1]
    b6 = torch.as_tensor(np.random.default_rng(n6).standard_normal((1, n6)), device=dev)
    stream_at[f'n={n6} B=1 path 6-DOF'], ssolve_at[f'n={n6} B=1 path 6-DOF'] = hold_chol(
        f'n={n6} B=1 the 6-DOF path\'s M', M6, b6, 'stream')
    lu64_at[f'N={N6} B=1 path 6-DOF'], solve64_at[f'N={N6} B=1 path 6-DOF'] = hold_lu64(
        f'N={N6} B=1 the 6-DOF path\'s K', K6_, rhs6)
    for name, what in (('dual_kite', 'the dual kite\'s'), ('actuator_qaxi', 'the actuator model\'s')):
        M_c, K_c, rhs_c = (t.to(dev) for t in res['systems'][name])
        n_c, N_c = M_c.shape[1], K_c.shape[1]
        if name == 'dual_kite':
            b_c = torch.as_tensor(np.random.default_rng(n_c).standard_normal((1, n_c)), device=dev)
            chol_at[f'n={n_c} B=1 path {name}'], csolve_at[f'n={n_c} B=1 path {name}'] = \
                hold_chol(f'n={n_c} B=1 {what} M', M_c, b_c, 'cluster')
        lu64_at[f'N={N_c} B=1 path {name}'], solve64_at[f'N={N_c} B=1 path {name}'] = hold_lu64(
            f'N={N_c} B=1 {what} K', K_c, rhs_c)
    report['chol_factor_stream'] = dict(stream_at[f'n={n18} B=1 path'], at=stream_at)

    # each kernel's launches are those of the slice whose path holds it: the
    # QR slice, the port's default path, for its own kernels and for K1 and
    # K4, which both paths share; the LU slice for the LU kernels; the n_k=8
    # slices for the blocked variants; [slice-trial-nk18] for K10's stream
    # variant
    sources = {'newton_kkt': 'awebox_tpu/parallel/batch.py:154',
               'kkt_assemble_scaled': 'awebox_tpu/parallel/batch.py:409',
               'lu_factor_cluster': 'awebox_tpu/parallel/batch.py:414',
               'lu_factor_blocked': 'awebox_tpu/parallel/batch.py:414',
               'lu_solve_batched': 'awebox_tpu/parallel/batch.py:416',
               'ip_step': 'awebox_tpu/parallel/batch.py:189',
               'kkt_assemble': 'awebox_tpu/parallel/batch.py:333',
               'ruiz_scale': 'awebox_tpu/parallel/batch.py:375',
               'qr_factor_cluster': 'awebox_tpu/parallel/batch.py:382',
               'qr_factor_blocked': 'awebox_tpu/parallel/batch.py:382',
               'qr_solve_batched': 'awebox_tpu/parallel/batch.py:344',
               'advance_state': 'awebox_tpu/parallel/batch.py:449',
               'chol_factor_cluster': 'awebox_tpu/parallel/batch.py:215',
               'chol_factor_stream': 'awebox_tpu/opti/ipsolver.py:183',
               'chol_solve_batched': 'awebox_tpu/parallel/batch.py:234',
               'block_factor': 'awebox_tpu/ocp/blockkkt.py:539',
               'block_solve': 'awebox_tpu/ocp/blockkkt.py:646',
               'lu_factor_f64': 'awebox_tpu/opti/ipsolver.py:194',
               'lu_solve_f64': 'awebox_tpu/opti/ipsolver.py:195'}
    own = {'kkt_assemble_scaled': launches_lu, 'lu_factor_cluster': launches_lu,
           'lu_solve_batched': launches_lu, 'lu_factor_blocked': launches_lu8,
           'qr_factor_blocked': launches_qr8, 'advance_state': launches_block,
           'block_factor': launches_block, 'block_solve': launches_block,
           'chol_factor_cluster': launches_dense, 'chol_factor_stream': launches_nk18,
           'chol_solve_batched': launches_dense, 'lu_factor_f64': launches_trial,
           'lu_solve_f64': launches_trial}
    phase('done', f'chip_smoke.py ran {time.time() - t_start:.1f} s')
    print(json.dumps({'kernels': [
        dict(name=k, route='cuda', source='awebox_tpu_torch/csrc/auglu.cu',
             replaces=sources[k], launches=own.get(k, launches_qr)[k],
             launches_lu_slice=launches_lu[k], launches_qr_slice=launches_qr[k],
             launches_nk8_lu_slice=launches_lu8[k], launches_nk8_qr_slice=launches_qr8[k],
             launches_block_slice=launches_block[k], launches_dense_slice=launches_dense[k],
             launches_trial_slice=launches_trial[k], launches_trial_nk18_slice=launches_nk18[k],
             launches_trial_6dof_slice=launches_6dof[k],
             launches_trial_configs_slice=launches_configs.get(k, 0),
             **report[k])
        for k in sources]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


def trial_worker(out_path):
    """[slice-trial] .. [slice-trial-configs], the cold solves of
    Trial.optimize on the card, in a process of their own: main starts it
    beside its batched slices (both are host-bound) and joins it before the
    n_k=8 slices. Its gates raise; each run's kernel launches, and the M, K
    and rhs of the directions that main's [kernels] rows hold, are saved to
    ``out_path``."""
    import ctypes

    import numpy as np
    import torch

    # PR_SET_PDEATHSIG: the worker ends with the process that started it
    ctypes.CDLL(None).prctl(1, signal.SIGTERM)
    sys.path.insert(0, HERE)
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import E2E_NAMES, bench_options, e2e_options, flagship_options
    from awebox_tpu_torch.opti.homotopy import linear_solver_choice
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    from awebox_tpu_torch.parallel import kernels

    dev = torch.device('cuda')
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.library()
    anchor = dict(np.load(ANCHOR))
    systems = {}

    def path_system(run):
        """The M, K and rhs of a run's first direction whose inertia test
        passed, on the CPU."""
        sys_ = run['solver']._augmented(*run['first']['args_ok'])
        return tuple(sys_[k][None].contiguous().cpu() for k in ('M', 'K', 'rhs'))

    # --- 8. the host solver behind Trial.optimize: [slice-trial] ----------
    # Trial(bench_options()).build().optimize() on the card: the cold
    # homotopy of the bench configuration at its published size, through
    # the reference's own linear-solver choice ('auto' is 'dense' here: 280
    # variables), so every direction is kkt_solve's: K10's inertia test (its
    # cluster variant), K12 and K13 twice. The solver is the one
    # solve_homotopy builds, made here so that its first kkt_solve call can
    # be kept and held, after the run, to the plain path on the CPU at the
    # same state (TOL_FIRST_KKT). Gates: solve_succeeded; the average power
    # and period within 1e-6 relative of the anchor's; the final step's KKT
    # error within its tol; K10, K12 and K13 launched, once, once and twice a
    # direction, and no other kernel; no plain version called. Each step's
    # iterations are printed beside the JAX package's (JAX_TRIAL_ITERS).
    def cold_trial(tag, options, jax_iters=JAX_TRIAL_ITERS, jax_what='at n_k=4', who=''):
        """Trial(options).build().optimize() on the card, with the first
        kkt_solve's arguments and outputs kept (and the arguments of the
        first whose inertia test passed), every plain version counted and
        the launches of the run; the steps' lines printed, each after
        ``who``."""
        cold = Trial(options, f'chip_smoke_{tag}').build()
        require(linear_solver_choice(cold.ocp) == 'dense', f'{tag}: auto is not dense')
        solver = InteriorPointSolver(cold.ocp.f_fn, cold.ocp.eq_fn, cold.ocp.ineq_fn,
                                     n=cold.ocp.vstruct.total, n_eq=cold.ocp.n_eq,
                                     n_ineq=cold.ocp.n_ineq, device=dev)
        kkt_inner, first = solver._kkt_solve, {}

        def kkt_kept(*args):
            out = kkt_inner(*args)
            if not first:
                first['args'] = [a.clone() if torch.is_tensor(a) else a for a in args]
                first['out'] = [o.clone() for o in out[:7]]
            if 'args_ok' not in first and bool(out[6]):   # the first M K10 factors
                first['args_ok'] = [a.clone() if torch.is_tensor(a) else a for a in args]
            return out
        solver._kkt_solve = kkt_kept
        cold._solver_cache['solver'] = solver
        plain = {k: 0 for k in SOLVER_PLAIN + ('lu_factor_f64_plain', 'lu_solve_f64_plain')}
        saved = {k: getattr(kernels, k) for k in plain}

        def counted_plain(name):
            def call(*args, **kwargs):
                plain[name] += 1
                return saved[name](*args, **kwargs)
            return call
        for k in plain:
            setattr(kernels, k, counted_plain(k))
        kernels.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            cold.optimize(verbose=False)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            for k, fn in saved.items():
                setattr(kernels, k, fn)
        launches = dict(kernels.LAUNCHES)
        stats = cold.solution.stats
        for key in stats['iterations']:
            res_ = cold.solution.step_results[key]
            phase(tag, f'{who}{key}: {res_["status"]}, {stats["iterations"][key]} iterations '
                  f'(the JAX package {jax_what}: {jax_iters.get(key)}), '
                  f'{stats["t_wall"][key]:.1f} s, '
                  f'{1e3 * stats["t_wall"][key] / max(stats["iterations"][key], 1):.0f} ms/iter, '
                  f'KKT error {res_["kkt_error"]:.2e}')
        return dict(cold=cold, solver=solver, first=first, kkt_inner=kkt_inner,
                    launches=launches, plain=plain, seconds=seconds, stats=stats)

    def hold_path(tag, run, variant, who=''):
        """A cold run's [path]: K10 (in ``variant``), K12 and two K13 a
        direction, no other kernel and no plain version; and its first
        kkt_solve on the CPU's plain path at the same state, within
        TOL_FIRST_KKT. ``who`` names the run in the lines and errors."""
        launches, first, solver = run['launches'], run['first'], run['solver']
        phase_tag, tag = tag, f'{tag}: {who.strip()}' if who else tag
        n_dir = launches['lu_factor_f64']
        kernels_of = ('lu_factor_f64', 'lu_solve_f64', 'chol_factor_batched',
                      f'chol_factor_{variant}')
        require(n_dir > 0 and launches['lu_solve_f64'] == 2 * n_dir
                and launches['chol_factor_batched'] == n_dir
                and launches[f'chol_factor_{variant}'] == n_dir,
                f'{tag}: not K10 ({variant}), K12 and two K13 a direction: {launches}')
        others = [k for k, v in launches.items() if v and k not in kernels_of]
        require(not others, f'{tag}: other kernels ran: {others}')
        require(not any(run['plain'].values()), f'{tag}: plain versions ran: {run["plain"]}')
        cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in first['args']]
        out_h = run['kkt_inner'](*cpu_args)
        gaps = {name: float((u.cpu() - v).abs().max() / max(float(v.abs().max()), 1e-300))
                for name, u, v in zip(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu'),
                                      first['out'][:6], out_h[:6])}
        require(bool(first['out'][6]) == bool(out_h[6]), f'{tag}: the first inertia test differs')
        require(max(gaps.values()) <= TOL_FIRST_KKT,
                f'{tag}: the first kkt_solve differs from the CPU\'s: {gaps}')
        cond = float(torch.linalg.cond(solver._augmented(*cpu_args)['K']))
        phase(phase_tag, f'{who}the first kkt_solve on the card against the plain path on the '
              f'CPU at the same state (cond(K) {cond:.2e}): inertia ok {bool(out_h[6])} in both; max gaps '
              f'over max |.|: ' + ', '.join(f'{k} {v:.2e}' for k, v in gaps.items())
              + f' (tolerance {TOL_FIRST_KKT})')
        phase('path', f'{tag}: kernel launches in the solve: '
              f'{ {k: v for k, v in launches.items() if v} }; {n_dir} directions, each K10 '
              f'({variant} variant), K12 and two K13; plain versions called: 0; '
              f'{len(run["stats"]["iterations"])} homotopy steps')

    trial_run = cold_trial('slice-trial', bench_options())
    cold, stats, trial_s = trial_run['cold'], trial_run['stats'], trial_run['seconds']
    launches_trial = trial_run['launches']
    n_it = sum(stats['iterations'].values())
    go = cold.global_outputs()
    dp = abs(go['avg_power_watts'] / float(anchor['avg_power_watts']) - 1.)
    dt_ = abs(go['time_period'] / float(anchor['time_period']) - 1.)
    tol_final = cold.options['solver']['tol']
    kkt_final = cold.solution.step_results['final_0']['kkt_error']
    phase('slice-trial', f'Trial(bench_options()).build().optimize() on the card: '
          f'solve_succeeded {cold.solve_succeeded}, {n_it} iterations (the JAX package: '
          f'{sum(JAX_TRIAL_ITERS.values())}) in {trial_s:.1f} s, {1e3 * trial_s / n_it:.0f} '
          f'ms/iter; power {go["avg_power_watts"]:.6f} W ({dp:.2e} from the anchor\'s '
          f'{float(anchor["avg_power_watts"]):.6f}), period {go["time_period"]:.6f} s ({dt_:.2e} '
          f'from {float(anchor["time_period"]):.6f}); final KKT error {kkt_final:.2e} (tol '
          f'{tol_final:g})')
    require(cold.solve_succeeded, 'slice-trial: the solve did not succeed')
    require(dp <= 1e-6 and dt_ <= 1e-6, f'slice-trial: power {go["avg_power_watts"]} W, period '
            f'{go["time_period"]} s, the anchor\'s {float(anchor["avg_power_watts"])} / '
            f'{float(anchor["time_period"])}')
    require(kkt_final <= tol_final, f'slice-trial: final KKT error {kkt_final} > {tol_final}')
    require(stats['iterations'] == JAX_TRIAL_ITERS,
            f'slice-trial: iterations a step {stats["iterations"]}, the JAX package '
            f'{JAX_TRIAL_ITERS}')
    hold_path('slice-trial', trial_run, 'cluster')

    # --- 9. Trial.optimize at n_k=18: [slice-trial-nk18] ------------------
    # The same entry point on bench_options(n_k=18): n=1190 variables,
    # m=1145 constraints, N=2335, the largest grid on which 'auto' still
    # takes the dense direction (below 1200 variables), whose inertia test is
    # K10's stream variant and whose factor K12 factors in half panels. Each
    # homotopy step is capped at NK18_ITERS iterations (solver.max_iter; the
    # homotopy advances despite the cap), so every step of the entry point
    # runs. Gates: the [path] of hold_path (K10 stream, K12, two K13 a
    # direction, nothing else; the first direction against the CPU's plain
    # path). Then K10 on the first M of the path that it factors (the first
    # iterate's fails the inertia test: the delta_w ladder follows) and
    # K12/K13 on that direction's K, as main's [kernels] rows.
    o18 = bench_options(n_k=18)
    o18['solver.max_iter'] = NK18_ITERS
    nk18_run = cold_trial('slice-trial-nk18', o18)
    stats18, launches_nk18 = nk18_run['stats'], nk18_run['launches']
    n_it18 = sum(stats18['iterations'].values())
    ocp18 = nk18_run['cold'].ocp
    phase('slice-trial-nk18', f'Trial(bench_options(n_k=18)).build().optimize() on the card, '
          f'n={ocp18.vstruct.total}, m={ocp18.n_eq + ocp18.n_ineq} (CUT: solver.max_iter = '
          f'{NK18_ITERS} a step): {len(stats18["iterations"])} homotopy steps, {n_it18} '
          f'iterations in {nk18_run["seconds"]:.1f} s, '
          f'{1e3 * nk18_run["seconds"] / max(n_it18, 1):.0f} ms/iter, '
          f'{launches_nk18["lu_factor_f64"]} directions; not gated on convergence')
    require(len(stats18['iterations']) == len(JAX_TRIAL_ITERS)
            and all(0 < v <= NK18_ITERS for v in stats18['iterations'].values()),
            f'slice-trial-nk18: steps and iterations {stats18["iterations"]}')
    hold_path('slice-trial-nk18', nk18_run, 'stream')
    require('args_ok' in nk18_run['first'], 'slice-trial-nk18: no inertia test passed')
    systems['nk18'] = path_system(nk18_run)

    # --- 10. the 6-DOF kite through Trial.optimize: [slice-trial-6dof] ----
    # flagship_options(n_k=4, d=3), the single-kite 6-DOF health
    # configuration (the JAX package's default kite: DCM and body rates as
    # states, the stability-derivative aerodynamics, the beta cost): n=569,
    # m=556, N=1125. 'auto' takes the dense direction, whose inertia test
    # runs K10's stream variant (n=569, past the cluster variant's 554) and
    # whose K12 factors in half panels (past 1024 rows). Each homotopy step is
    # capped at SIXDOF_ITERS iterations, so every step runs (the uncut solve
    # takes 4089 iterations; see SIXDOF_ITERS). Gates: six steps, the [path]
    # of hold_path, the first direction against the CPU's; then
    # K10 on the first M of the path that it factors and K12/K13 on that
    # direction's K as main's [kernels] rows.
    o6 = flagship_options(4, 3)
    o6['solver.max_iter'] = SIXDOF_ITERS
    six_run = cold_trial('slice-trial-6dof', o6, JAX_SIXDOF_ITERS, '6-DOF uncut')
    stats6, launches_6dof = six_run['stats'], six_run['launches']
    n_it6 = sum(stats6['iterations'].values())
    ocp6 = six_run['cold'].ocp
    phase('slice-trial-6dof', f'Trial(flagship_options(4, 3)).build().optimize() on the card, '
          f'6-DOF, n={ocp6.vstruct.total}, m={ocp6.n_eq + ocp6.n_ineq} (CUT: solver.max_iter = '
          f'{SIXDOF_ITERS} a step, for the script\'s time): {len(stats6["iterations"])} homotopy '
          f'steps, {n_it6} iterations in {six_run["seconds"]:.1f} s, '
          f'{1e3 * six_run["seconds"] / max(n_it6, 1):.0f} ms/iter, '
          f'{launches_6dof["lu_factor_f64"]} directions; not gated on convergence')
    require(list(stats6['iterations']) == list(JAX_SIXDOF_ITERS)
            and all(0 < v <= SIXDOF_ITERS for v in stats6['iterations'].values()),
            f'slice-trial-6dof: steps and iterations {stats6["iterations"]}')
    hold_path('slice-trial-6dof', six_run, 'stream')
    require('args_ok' in six_run['first'], 'slice-trial-6dof: no inertia test passed')
    systems['6dof'] = path_system(six_run)

    # --- 11. the reference's end-to-end matrix: [slice-trial-configs] -----
    # Trial(e2e_options(name)).build().optimize() on the card for the eight
    # configurations of tests/test_e2e_configs.py beyond the 6-DOF kite:
    # n = 166 .. 516 variables, K of 317 .. 1017, so 'auto' takes the dense
    # direction (and three of them are dense-only), whose inertia test runs
    # K10's cluster variant (n <= 554) and whose factor K12 takes K in full
    # panels (N <= 1024). Each homotopy step is capped at CONFIG_ITERS
    # iterations (CUT: the uncut solves, JAX_CONFIG_ITERS, run in
    # probes/host_solver.py --config NAME --solve-only), so every step runs.
    # Gates, each configuration: the JAX package's steps, each run to at
    # most the cap; the [path] of hold_path (K10 cluster, K12 and two K13 a
    # direction, nothing else; the first direction against the CPU's plain
    # path). Then K10 on the dual kite's first M that it factors, and K12/K13
    # on the K of that direction and of the actuator model's, as main's
    # [kernels] rows.
    launches_configs = {}
    for name in E2E_NAMES:
        oc = e2e_options(name)
        oc['solver.max_iter'] = CONFIG_ITERS
        run = cold_trial('slice-trial-configs', oc, JAX_CONFIG_ITERS[name], 'uncut or at 150',
                         who=f'{name} ')
        stats_c, ocp_c = run['stats'], run['cold'].ocp
        n_c = ocp_c.vstruct.total
        n_itc = sum(stats_c['iterations'].values())
        phase('slice-trial-configs', f'{name}: Trial(e2e_options({name!r})).build().optimize() '
              f'on the card, n={n_c}, m={ocp_c.n_eq} + {ocp_c.n_ineq}, N='
              f'{n_c + ocp_c.n_eq + ocp_c.n_ineq} (CUT: solver.max_iter = {CONFIG_ITERS} a step): '
              f'{len(stats_c["iterations"])} homotopy steps, {n_itc} iterations in '
              f'{run["seconds"]:.1f} s, {1e3 * run["seconds"] / max(n_itc, 1):.0f} ms/iter, '
              f'{run["launches"]["lu_factor_f64"]} directions; not gated on convergence')
        require(list(stats_c['iterations']) == list(JAX_CONFIG_ITERS[name])
                and all(0 < v <= CONFIG_ITERS for v in stats_c['iterations'].values()),
                f'slice-trial-configs: {name}: steps and iterations {stats_c["iterations"]}, the '
                f'JAX package\'s steps {list(JAX_CONFIG_ITERS[name])}')
        hold_path('slice-trial-configs', run, 'cluster', who=f'{name} ')
        require('args_ok' in run['first'], f'slice-trial-configs: {name}: no inertia test passed')
        for k, v in run['launches'].items():
            launches_configs[k] = launches_configs.get(k, 0) + v
        if name in ('dual_kite', 'actuator_qaxi'):
            systems[name] = path_system(run)
    phase('slice-trial-configs', f'{len(E2E_NAMES)} configurations through Trial.optimize on the '
          f'card; kernel launches over them: { {k: v for k, v in launches_configs.items() if v} }')
    torch.save(dict(launches_trial=launches_trial, launches_nk18=launches_nk18,
                    launches_6dof=launches_6dof, launches_configs=launches_configs,
                    systems=systems), out_path)
    return 0


def stop_workers():
    """Stops every process main started that is still running (with the end
    of its output on stderr) and removes its folder."""
    import shutil
    for proc, log_path, work_dir in WORKERS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            with open(log_path) as log:
                tail = log.readlines()[-40:]
            print(f'chip_smoke: stopped the trial worker (pid {proc.pid}); the end of its '
                  f'output:\n' + ''.join(tail), file=sys.stderr)
        shutil.rmtree(work_dir, ignore_errors=True)


def same_tree(a, b):
    """Two trees of tensors with the same keys and equal leaves."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(same_tree(a[k], b[k]) for k in a)
    return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)


def _take_lanes(tree, sel):
    if isinstance(tree, dict):
        return {k: _take_lanes(v, sel) for k, v in tree.items()}
    return tree[sel]


if __name__ == '__main__':
    if len(sys.argv) == 3 and sys.argv[1] == '--trials':
        sys.exit(trial_worker(sys.argv[2]))
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        sys.exit(main())
    finally:
        stop_workers()
