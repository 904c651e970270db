#!/usr/bin/env python3
"""Where K9 (block_solve_kernel) and K11 (chol_solve_kernel) of
awebox_tpu_torch/csrc/auglu.cu spend their time on the card, and how they and
K13 (lu_solve_f64_kernel) compare with a parent tree's kernels and with
PyTorch's calls for the same functions.

K9 on the factor (kernels.block_factor) of random SPD frames in the n_k=4
and n_k=8 layouts of the bench configuration (nx=11, ni=54, nb=20, nloc=96)
at n_k=4 B = 1, 2, 16, 128 and n_k=8 B=16; K11 on the Cholesky factor of
random SPD M = G G^T / n + I at n = 280 B = 1, 2, 16, 128 and n = 540 B=16,
f64 (a delta-ladder retry solves 1 to a few lanes); K13 on cuSOLVER's LU
factor of random saddle matrices shaped like the host solver's augmented K
at N = 543 (n_k=4) B = 1 and 16, 1055 (n_k=8), 1311 (n_k=10) and 2335
(n_k=18) B = 1: its cluster (C, shared memory a rank, the clusters the card
runs at once), max |x - x_plain| / max |x_plain|, whether x is the parent's
bits, and queued medians of this tree's and the parent's in turns beside
torch.linalg.lu_solve and the bound. At each shape of K9 and K11:

- the layout (K9: the cluster, its shared memory a rank, the clusters the
  card runs at once and the waves; K11: its shared memory);
- max |x - x_plain| over max |x_plain| (and to the parent's kernel with
  --parent);
- queued CUDA-event medians (behind a device sleep) of this tree's kernel,
  of the parent's in turns (parent, this, this, parent), of the library
  composition (K9: four solve_triangular and two products,
  probes/yardstick.py's block_solve_library, as chip_smoke.py times it;
  K11: torch.cholesky_solve) and the bound (yardstick.py);
- phase cuts from clock64 stamps of a copy of the source built with
  KS_STAMPS defined: thread 0 of every CTA, which runs warp 0's chain, adds
  the cycles of each piece up (copy-in with the gathers and the
  reciprocals; its waits for its ring's tiles; the chains (K9: the
  interiors'); the step barriers, where warp 0 waits for warps 1 .. 7's
  off-diagonal sums; K9's reduced chains and their barriers (rank 0), its
  coupling products and exchanges, its cluster waits; the scatter), in
  microseconds at the clock the stamps measured (clock64 over
  %globaltimer), the median over lanes (K9: rank 0, and the other ranks'
  cluster waits), and the chain's cycles a column: an L2 round trip takes
  several hundred, so a chain that waited on global memory would show it; lane 0 of
  warp 1 likewise (its ring waits, its off-diagonal sums, its ring issues,
  its barrier waits);
- at K9 n_k=4 B=16 and K11 n=280 B=16, cuts of the chain's column step
  (without the fold into the next tile, without the reciprocal's multiply,
  without the shuffle; wrong results) and the cycles a column each leaves.

With --parent, the kernels module of the tree at that path is loaded under
its own name (a parent commit unpacked with ``git archive`` into a
directory that .gitignore lists):

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/solve_chains.py --parent _archive/parent

Prints the card, ptxas's registers and spills of K9 and K11, then lines per
shape. Exits non-zero if this tree's kernel differs from the plain version
by more than 1e-10 of max |x| (K13: 1e-8, on K's condition number). Needs a CUDA card and nvcc; about three
minutes.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import threading

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
from awebox_tpu_torch.parallel import kernels  # noqa: E402
from awebox_tpu_torch.probes.block_phases import frames, start_build, variant_source  # noqa: E402
from awebox_tpu_torch.probes.chol_phases import spd  # noqa: E402
from awebox_tpu_torch.probes.qr_phases import load_parent, queued_ms  # noqa: E402
from awebox_tpu_torch.probes.yardstick import (block_solve_bound, block_solve_library,  # noqa: E402
                                               chol_solve_bound, lu_solve_f64_bound)

K9_SHAPES = ((4, 1), (4, 2), (4, 16), (4, 128), (8, 16))
K11_SHAPES = ((280, 1), (280, 2), (280, 16), (280, 128), (540, 16))
K13_SHAPES = ((543, 1), (543, 16), (1055, 1), (1311, 1), (2335, 1))
STAMP_CTAS = 1024
PHASES = ('copy-in', 'ring waits', 'chains', 'step barriers', 'reduced chains',
          'reduced step barriers', 'coupling products', 'cluster waits', 'scatter',
          'off-diagonal sums', 'ring issues')
NPH = len(PHASES)
TOL = 1e-10

# lane 0 of warps 0 and 1 (threads 0 and 32) each add the cycles since their
# last stamp to a phase's count
STAMP_PRELUDE = r'''
#define KS_STAMPS
__device__ long long ks_stamps[STAMP_CTAS][2][NPH + 2];
__shared__ long long ks_acc[2][NPH];
__shared__ long long ks_last[2];
__shared__ long long ks_g0;
#define KS_STAMP_BEGIN() do { if (threadIdx.x == 0) { \
  for (int i_ = 0; i_ < NPH; ++i_) ks_acc[0][i_] = ks_acc[1][i_] = 0; \
  ks_last[0] = ks_last[1] = clock64(); long long g_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); ks_g0 = g_; } } while (0)
#define KS_STAMP(i) do { if ((threadIdx.x & ~32u) == 0) { const int w_ = threadIdx.x >> 5; \
  const long long c_ = clock64(); ks_acc[w_][i] += c_ - ks_last[w_]; ks_last[w_] = c_; } } while (0)
#define KS_STAMP_END() do { if ((threadIdx.x & ~32u) == 0 && blockIdx.x < STAMP_CTAS) { \
  const int w_ = threadIdx.x >> 5; long long g1_, sum_ = 0; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1_)); \
  for (int i_ = 0; i_ < NPH; ++i_) { ks_stamps[blockIdx.x][w_][i_] = ks_acc[w_][i_]; \
    sum_ += ks_acc[w_][i_]; } \
  ks_stamps[blockIdx.x][w_][NPH] = sum_; ks_stamps[blockIdx.x][w_][NPH + 1] = g1_ - ks_g0; } } \
  while (0)
'''.replace('STAMP_CTAS', str(STAMP_CTAS)).replace('NPH', str(NPH))
STAMP_READER = r'''
extern "C" int ks_stamps_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, ks_stamps, (size_t)bytes);
}
'''
ANCHOR = 'constexpr int KS_NB = 32;'
FWD_COL = ('    if (wl == j) b *= r;\n    const double xj = __shfl_sync(FULL_MASK, b, j);\n'
           '    if (wl > j) b = fma(-d, xj, b);\n    an = fma(-e, xj, an);\n')
BWD_COL = ('          if (wl == j) b *= r;\n          const double xj = __shfl_sync(FULL_MASK, b, j);\n'
           '          if (wl < j) b = fma(-D[j * KS_LDT], xj, b);\n'
           '          if (fold) an = fma(-E[j * KS_LDT], xj, an);\n')
# cuts of the chain's column step (wrong results; the cycles a column they
# save say what each piece costs on the chain), each on the stamped source
CUTS = {
    'without the fold': [(FWD_COL, FWD_COL.replace('    an = fma(-e, xj, an);\n', '')),
                         (BWD_COL, BWD_COL.replace('          if (fold) an = fma(-E[j * KS_LDT], '
                                                   'xj, an);\n', ''))],
    'without the reciprocal': [(FWD_COL, FWD_COL.replace('    if (wl == j) b *= r;\n', '')),
                               (BWD_COL, BWD_COL.replace('          if (wl == j) b *= r;\n', ''))],
    'without the shuffle': [(FWD_COL, FWD_COL.replace('__shfl_sync(FULL_MASK, b, j)', 'b')),
                            (BWD_COL, BWD_COL.replace('__shfl_sync(FULL_MASK, b, j)', 'b'))],
}
CUT_SHAPES = {'K9': (4, 16), 'K11': (280, 16)}


def bind(lib):
    for name in ('block_solve', 'block_solve_occupancy', 'chol_solve_batched'):
        getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def finish(name, so, proc):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f'{name}: nvcc failed\n{log}')
    return bind(ctypes.CDLL(so)), log


def ptxas(log):
    out, keep = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = next((k for k in ('block_solve_kernel', 'chol_solve_kernel') if k in line), None)
        elif keep and re.search(r'registers|stack frame', line):
            out.append(f'{keep}: ' + line.replace('ptxas info    :', '').strip())
    return out


def index_maps(lay, rng):
    """A random partition of the n variables into the chain, interior and
    border blocks, as int64 tensors on the card."""
    n = lay.n_k * (lay.nx + lay.ni) + lay.nb
    p = torch.as_tensor(rng.permutation(n), device='cuda')
    nc, nii = lay.n_k * lay.nx, lay.n_k * lay.ni
    return (p[:nc].reshape(lay.n_k, lay.nx), p[nc:nc + nii].reshape(lay.n_k, lay.ni),
            p[nc + nii:])


def k9_caller(lib, fac, rhs, maps, lay, x):
    g = kernels.block_solve_geometry(lay)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    B, n = rhs.shape

    def call():
        err = lib.block_solve(*(ptr(t) for t in fac), ptr(rhs), *(ptr(t) for t in maps), ptr(x),
                              B, lay.n_k, lay.nx, lay.ni, lay.nb, n, g.ld_x, g.smem_bytes, stream)
        if err:
            raise RuntimeError(f'block_solve: CUDA error {err}')
    return call


def k11_caller(lib, L, b, x, smem=None):
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    B, n = b.shape
    smem = smem or kernels.chol_solve_geometry(n)

    def call():
        err = lib.chol_solve_batched(ptr(L), ptr(b), ptr(x), B, n, smem, stream)
        if err:
            raise RuntimeError(f'chol_solve_batched: CUDA error {err}')
    return call


def stamps(lib, call, C, B):
    """(lanes, C, 2, NPH + 2) cycles of each phase of warps 0 and 1, their
    sums and the nanoseconds, from the last of five calls; and the clock in
    GHz."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    buf = np.zeros((STAMP_CTAS, 2, NPH + 2), dtype=np.int64)
    err = lib.ks_stamps_read(buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if err:
        raise RuntimeError(f'ks_stamps_read: CUDA error {err}')
    lanes = min(B, STAMP_CTAS // C)
    st = buf[:lanes * C].reshape(lanes, C, 2, NPH + 2).astype(np.float64)
    ghz = float(np.median(st[:, 0, 0, NPH] / np.maximum(st[:, 0, 0, NPH + 1], 1)))
    return st, ghz


def phase_line(tag, st, ghz, columns, stamped_ms):
    """Rank 0's phases for warp 0 (the chain's) and warp 1 (median over
    lanes, us), the other ranks' cluster waits, and each chain's cycles a
    column."""
    us = lambda cyc: float(np.median(cyc)) / ghz / 1e3
    line = f'{tag} phases (rank 0, median over lanes, us at {ghz:.3f} GHz)'
    for w in range(2):
        parts = [us(st[:, 0, w, i]) for i in range(NPH)]
        line += (f'; warp {w}: ' + ', '.join(f'{p} {t:.2f}' for p, t in zip(PHASES, parts) if t > 0)
                 + f', total {us(st[:, 0, w, NPH]):.2f}')
    if st.shape[1] > 1:
        line += f'; other ranks\' cluster waits {us(st[:, 1:, 0, 7].mean(axis=1)):.2f}'
    for name, phase, cols in columns:
        line += f'; {name} {float(np.median(st[:, 0, 0, phase])) / cols:.1f} cycles a column'
    return line + f'; stamped kernel {stamped_ms:.4f} ms'


def turns(tag, name, this, before):
    if before is None:
        print(f'{tag} {name} this tree: {queued_ms(this):.4f} ms', flush=True)
        return
    times = [queued_ms(call) for call in (before, this, this, before)]
    print(f'{tag} {name} parent, this tree, this tree, parent: '
          + ' / '.join(f'{t:.4f}' for t in times) + ' ms', flush=True)


def gap(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def saddle(N, B, rng):
    """(B, N, N) saddle matrices [[W, A^T], [A, -D]] shaped like the host
    solver's augmented K (n = 280 N / 543 primal rows, D of 1e-8 and small
    entries) and right-hand sides, on the card."""
    n = N * 280 // 543
    m = N - n
    K = np.zeros((B, N, N))
    for lane in range(B):
        Wh = rng.standard_normal((n, n))
        W = (Wh + Wh.T) / 2 + np.diag(10.0 ** rng.uniform(-2, 4, n))
        A = rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-1, 1, (m, 1))
        D = np.concatenate([1e-8 * np.ones(m - m // 16), np.abs(rng.standard_normal(m // 16))])
        K[lane] = np.block([[W, A.T], [A, -np.diag(D)]])
    return (torch.as_tensor(K, device='cuda'),
            torch.as_tensor(rng.standard_normal((B, N)), device='cuda'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('solve_chains: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    stamps_edit = [(ANCHOR, STAMP_PRELUDE + ANCHOR)]
    builds = {'whole': start_build('solve_whole', variant_source([])),
              'stamps': start_build('solve_stamps', variant_source(stamps_edit) + STAMP_READER)}
    for name, edits in CUTS.items():
        builds[name] = start_build('solve_' + re.sub(r'\W', '_', name),
                                   variant_source(stamps_edit + edits) + STAMP_READER)
    parent = load_parent(args.parent) if args.parent else None
    threads = [threading.Thread(target=m.library) for m in (kernels, parent) if m is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name, (so, proc) in builds.items():
        libs[name], log = finish(name, so, proc)
        if name == 'whole':
            for line in ptxas(log):
                print(f'ptxas {line}', flush=True)
    for name in ['stamps', *CUTS]:
        libs[name].ks_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name].ks_stamps_read.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    failed = []
    for n_k, B in K9_SHAPES:
        lay, F, delta, own = frames(n_k, B, rng)
        fac = tuple(t.contiguous() for t in kernels.block_factor(F, delta, own, lay)[:3])
        maps = index_maps(lay, rng)
        n = lay.n_k * (lay.nx + lay.ni) + lay.nb
        rhs = torch.as_tensor(rng.standard_normal((B, n)), device='cuda')
        tag = f'K9 n_k={n_k} B={B:3d}'
        g = kernels.block_solve_geometry(lay)
        active = kernels.cluster_max_active('block_solve', g)
        x = kernels.block_solve(*fac, rhs, maps, lay)
        xp = kernels.block_solve_plain(*fac, rhs, maps, lay)
        torch.cuda.synchronize()
        line = (f'{tag} {g}: {active} clusters at once, {-(-B // active)} wave(s); x gap to '
                f'plain {gap(x, xp):.2e}')
        failed += [] if gap(x, xp) <= TOL else [tag]
        before = None
        if parent is not None:
            play = parent.BlockLayout(*lay)
            before = lambda: parent.block_solve(*fac, rhs, maps, play)
            x_o = before()
            torch.cuda.synchronize()
            line += f'; to the parent {gap(x, x_o):.2e}'
        print(line, flush=True)
        turns(tag, 'K9', lambda: kernels.block_solve(*fac, rhs, maps, lay), before)
        lib_ms = queued_ms(block_solve_library(*fac, rhs, lay, maps[1]))
        b_ms, b_by = block_solve_bound(lay, B)
        print(f'{tag} library composition {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})',
              flush=True)
        out = torch.empty_like(rhs)
        stamped = k9_caller(libs['stamps'], fac, rhs, maps, lay, out)
        st, ghz = stamps(libs['stamps'], stamped, n_k, B)
        print(phase_line(tag, st, ghz, (('interior chain', 2, 2 * lay.ni),
                                        ('reduced chain', 4, 2 * lay.nr)),
                         queued_ms(stamped)), flush=True)
        if (n_k, B) == CUT_SHAPES['K9']:
            for name in CUTS:
                cut = k9_caller(libs[name], fac, rhs, maps, lay, out)
                st, _ = stamps(libs[name], cut, n_k, B)
                print(f'{tag} cut {name}: {queued_ms(cut):.4f} ms, interior chain '
                      f'{float(np.median(st[:, 0, 0, 2])) / (2 * lay.ni):.1f} / reduced chain '
                      f'{float(np.median(st[:, 0, 0, 4])) / (2 * lay.nr):.1f} cycles a column',
                      flush=True)
    for n, B in K11_SHAPES:
        L = torch.linalg.cholesky(spd(n, B, rng)).contiguous()
        b = torch.as_tensor(rng.standard_normal((B, n)), device='cuda')
        tag = f'K11 n={n} B={B:3d}'
        x = kernels.chol_solve_batched(L, b)
        xp = kernels.chol_solve_batched_plain(L, b)
        torch.cuda.synchronize()
        line = (f'{tag}: {kernels.chol_solve_geometry(n)} B of shared memory, '
                f'{-(-n // kernels.SUBST_NB)} tile steps each way; x gap to plain {gap(x, xp):.2e}')
        failed += [] if gap(x, xp) <= TOL else [tag]
        before = None
        if parent is not None:
            before = lambda: parent.chol_solve_batched(L, b)
            x_o = before()
            torch.cuda.synchronize()
            line += f'; to the parent {gap(x, x_o):.2e}'
        print(line, flush=True)
        turns(tag, 'K11', lambda: kernels.chol_solve_batched(L, b), before)
        b_col = b[..., None].contiguous()
        lib_ms = queued_ms(lambda: torch.cholesky_solve(b_col, L))
        b_ms, b_by = chol_solve_bound(n, B)
        print(f'{tag} torch.cholesky_solve {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})',
              flush=True)
        out = torch.empty_like(b)
        stamped = k11_caller(libs['stamps'], L, b, out)
        st, ghz = stamps(libs['stamps'], stamped, 1, B)
        print(phase_line(tag, st, ghz, (('chain', 2, 2 * n),), queued_ms(stamped)), flush=True)
        if (n, B) == CUT_SHAPES['K11']:
            for name in CUTS:
                cut = k11_caller(libs[name], L, b, out)
                st, _ = stamps(libs[name], cut, 1, B)
                print(f'{tag} cut {name}: {queued_ms(cut):.4f} ms, chain '
                      f'{float(np.median(st[:, 0, 0, 2])) / (2 * n):.1f} cycles a column', flush=True)
    for N, B in K13_SHAPES:
        K, b = saddle(N, B, rng)
        lu, piv = (t.contiguous() for t in torch.linalg.lu_factor(K))
        tag = f'K13 N={N} B={B:3d}'
        g = kernels.lu_solve_f64_geometry(N, B)
        active = kernels.cluster_max_active('lu_solve_f64', g)
        x = kernels.lu_solve_f64(lu, piv, b)
        xp = kernels.lu_solve_f64_plain(lu, piv, b)
        torch.cuda.synchronize()
        line = (f'{tag}: clusters of C={g.C}, {g.smem_bytes} B of shared memory a rank, {active} '
                f'clusters at once, {-(-B // active)} wave(s); x gap to plain {gap(x, xp):.2e}')
        failed += [] if gap(x, xp) <= 1e-8 else [tag]
        before = None
        if parent is not None:
            before = lambda: parent.lu_solve_f64(lu, piv, b)
            x_o = before()
            torch.cuda.synchronize()
            line += (f'; the parent\'s bits: {torch.equal(x.view(torch.int64), x_o.view(torch.int64))}'
                     f' (gap {gap(x, x_o):.2e})')
        print(line, flush=True)
        turns(tag, 'K13', lambda: kernels.lu_solve_f64(lu, piv, b), before)
        b_col = b[..., None].contiguous()
        lib_ms = queued_ms(lambda: torch.linalg.lu_solve(lu, piv, b_col))
        b_ms, b_by = lu_solve_f64_bound(N, B)
        print(f'{tag} torch.linalg.lu_solve {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})',
              flush=True)
    if parent is not None:
        print(f'parent launches: K9 {parent.LAUNCHES["block_solve"]}, '
              f'K11 {parent.LAUNCHES["chol_solve_batched"]}, '
              f'K13 {parent.LAUNCHES["lu_solve_f64"]}', flush=True)
    if failed:
        print(f'solve_chains: differs from the plain version at {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
