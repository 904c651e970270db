#!/usr/bin/env python3
"""Where K10 (awebox_tpu_torch/csrc/auglu.cu: chol_factor_cluster_kernel and
chol_factor_stream_kernel) spends its time on the card, and how it compares
with a parent tree's kernel and with torch.linalg.cholesky_ex.

Random SPD matrices M = G G^T / n + I (cond ~ 1e3), f64, at the condensed
system's sizes: n = 280 (n_k=4) at B = 1, 2, 16, 128 and n = 540 (n_k=8) at
B = 1, 16 through the cluster variant (a delta-ladder retry factors 1 to a
few lanes), and through the stream variant n = 555, 670 (the inertia test of
Trial.optimize at n_k=10), 876 and 1190 (n_k=18) at B = 1 and n = 700 at B
= 1, 2 and 4. At each shape:

- the variant and layout kernels.chol_factor_geometry gives, the clusters
  of it that the card runs at once and the waves B lanes take;
- max |L - L_plain| over max |L_plain| (and to the parent's kernel with
  --parent);
- queued CUDA-event medians (behind a device sleep) of this tree's kernel, of
  the parent's in turns (parent, this, this, parent) where the parent takes
  the shape (its one-CTA global variant stops at n = 876), of cholesky_ex
  and the bound (probes/yardstick.py, as chip_smoke.py reports them);
- with --parent, at n = 700 B = 2 and 4, phase cuts of the parent's one-CTA
  global variant from clock64 stamps of thread 0 (copy of M into L, the
  panels' loads into shared memory, their column chains, their stores, the
  trailing updates in global memory, the final scan for finite values) in
  microseconds, the median over lanes: what held it back;
- for the cluster variant, phase cuts from clock64 stamps of a copy of the
  source compiled beside it: thread 0 of every CTA adds the cycles of each
  piece up (copy-in, warp 0's chains with the stores of their rows, the
  rest of the row sweeps below them (the block's wait at the panel's end),
  cluster barrier waits, the fetches of panels through the L2, the
  look-ahead's copy of the handed-off rows with its update, the other
  trailing updates, the zeros above the panels with the flag exchange,
  warp 0's waits for the handoff),
  reported in microseconds at the clock the stamps measured (clock64 over
  %globaltimer), averaged over the ranks and the median over lanes; and
  cuts without the trailing updates, the L2 fetches, the row sweeps and the
  stores of the swept rows (wrong results; a cut's time says what the piece
  costs on the chain);
- at n = 280, the cluster layouts of 3, 4, 8 and 16 CTAs a lane
  (kernels.chol_cluster_layout) timed side by side: the design step behind
  the geometry's choice of the fewest CTAs that hold the lane.

Each insertion names the source text it follows or replaces and fails loudly
when the kernel has changed under it. With --parent, the kernels module of
the tree at that path is loaded under its own name (a parent commit unpacked
with ``git archive`` into a directory that .gitignore lists):

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/chol_phases.py --parent _archive/parent

Prints the card, ptxas's registers and spills of K10's kernels, then lines
per shape. Exits non-zero if this tree's kernel differs from the plain
version by more than 1e-12 of max |L| or fails a lane. Needs a CUDA card and
nvcc; about three minutes.
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
from awebox_tpu_torch.probes.block_phases import finish_build, start_build, variant_source  # noqa: E402
from awebox_tpu_torch.probes.qr_phases import load_parent, queued_ms  # noqa: E402
from awebox_tpu_torch.probes.yardstick import chol_factor_bound  # noqa: E402

SHAPES = ((280, 1), (280, 2), (280, 16), (280, 128), (540, 1), (540, 16), (555, 1), (670, 1),
          (700, 1), (700, 2), (700, 4), (876, 1), (1190, 1))
LAYOUT_SIZES = (3, 4, 8, 16)   # cluster sizes timed side by side at n = 280
STAMP_CTAS = 2048
PHASES = ('copy-in', 'chains', 'row sweeps', 'cluster waits', 'L2 fetches',
          'look-ahead copy and update', 'other updates', 'zeros and flags', 'handoff waits')
NPH = len(PHASES)

# thread 0 of each CTA adds the cycles since its last stamp to a phase's
# count (in shared memory, so that the device functions stamp too)
STAMP_PRELUDE = r'''
__device__ long long k10c_stamps[STAMP_CTAS][NPH + 2];
__shared__ long long k10c_acc[NPH];
__shared__ long long k10c_last;
#define K10C_T(i) do { if (threadIdx.x == 0) { const long long c_ = clock64(); \
  k10c_acc[i] += c_ - k10c_last; k10c_last = c_; } } while (0)
'''.replace('STAMP_CTAS', str(STAMP_CTAS)).replace('NPH', str(NPH))
STAMP_READER = r'''
extern "C" int k10c_stamps_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, k10c_stamps, (size_t)bytes);
}
'''
STAMP_END = r'''
  K10C_T(7);
  if (threadIdx.x == 0 && blockIdx.x < STAMP_CTAS) {
    long long g1_, sum_ = 0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1_));
    for (int i_ = 0; i_ < NPH; ++i_) {
      k10c_stamps[blockIdx.x][i_] = k10c_acc[i_];
      sum_ += k10c_acc[i_];
    }
    k10c_stamps[blockIdx.x][NPH] = sum_;
    k10c_stamps[blockIdx.x][NPH + 1] = g1_ - k10c_g0;
  }
}
'''.replace('STAMP_CTAS', str(STAMP_CTAS)).replace('NPH', str(NPH))
# (text in csrc/auglu.cu, what replaces it); every text must occur once
STAMPS = [
    ('constexpr int K10C_NB = 16;\n', STAMP_PRELUDE + 'constexpr int K10C_NB = 16;\n'),
    ('  double* Lw = L + (size_t)lane * n * n;\n\n  // 1. the lower triangle',
     '  double* Lw = L + (size_t)lane * n * n;\n  long long k10c_g0;\n'
     '  if (tid == 0) {\n'
     '    for (int i_ = 0; i_ < %d; ++i_) k10c_acc[i_] = 0;\n'
     '    k10c_last = clock64();\n'
     '    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(k10c_g0));\n'
     '  }\n\n  // 1. the lower triangle' % NPH),
    ('  cluster.sync();                       // every rank\'s handoff barrier is ready\n',
     '  cluster.sync();                       // every rank\'s handoff barrier is ready\n'
     '  K10C_T(0);\n'),
    ('      k10c_hbar_wait(hbar, parity);\n', '      k10c_hbar_wait(hbar, parity);\n      K10C_T(8);\n'),
    ('      k10c_tile_pair(T, recv, ld, ld, h, q0, w, q0, 2, 3, b, g, tg);\n      __syncwarp();\n    }\n',
     '      k10c_tile_pair(T, recv, ld, ld, h, q0, w, q0, 2, 3, b, g, tg);\n      __syncwarp();\n    }\n'
     '    K10C_T(5);\n'),
    ('    fail = __any_sync(FULL_MASK, wl < w && (!(dg > 0.0) || !isfinite(dg)));\n'
     "    if (hsrc != nullptr) k6_cluster_wait();   // panel k's phase\n",
     '    fail = __any_sync(FULL_MASK, wl < w && (!(dg > 0.0) || !isfinite(dg)));\n    K10C_T(1);\n'
     "    if (hsrc != nullptr) k6_cluster_wait();   // panel k's phase\n    K10C_T(3);\n"),
    ('  return __syncthreads_or(fail) != 0;\n}\n',
     '  const bool f_ = __syncthreads_or(fail) != 0;\n  K10C_T(2);\n  return f_;\n}\n'),
    ('      k6_cluster_wait();                // panel k is published\n',
     '      k6_cluster_wait();                // panel k is published\n      K10C_T(3);\n'),
    ('        k10c_fetch(recv, Lw, ld, n, k * K10C_NB, (rank + t0 * C) * K10C_NB, n, (k + 1) * K10C_NB,\n'
     '                   tid, K10C_THREADS);\n        __syncthreads();\n',
     '        k10c_fetch(recv, Lw, ld, n, k * K10C_NB, (rank + t0 * C) * K10C_NB, n, (k + 1) * K10C_NB,\n'
     '                   tid, K10C_THREADS);\n        __syncthreads();\n        K10C_T(4);\n'),
    ('    __syncthreads();                    // recv is free for the next panel\n',
     '    __syncthreads();                    // recv is free for the next panel\n'
     '    K10C_T(6);\n'),
    ('  if (rank == 0 && tid == 0) ok[lane] = any ? 0 : 1;\n}\n',
     '  if (rank == 0 && tid == 0) ok[lane] = any ? 0 : 1;\n' + STAMP_END),
]
# cuts: each removes one piece (wrong results; its time says what the piece costs)
CUTS = {
    'without the other trailing updates': [
        ('  const int g = wl >> 2, tg = wl & 3, h = n - q0, nt = (h + 7) >> 3;\n',
         '  return;\n  const int g = wl >> 2, tg = wl & 3, h = n - q0, nt = (h + 7) >> 3;\n')],
    'without the L2 fetches of other ranks': [
        ('      if (t0 < n_local) {               // uniform over the block\n',
         '      if (false) {\n')],
    'without the row sweeps': [
        ('    double a[K10C_NB], c[K10C_NB];\n',
         '    double a[K10C_NB], c[K10C_NB];\n    if (n > 0) {\n'
         '      for (int id_ = 1; id_ <= 8; ++id_) k10c_bar_sync(id_, K10C_THREADS);\n'
         '      if (next >= 0 && warp == 1) k10c_bar_sync(10, 64);\n'
         '      return __syncthreads_or(false) != 0;\n    }\n')],
    'without the stores of swept rows': [
        ('    if (i0 < h) bad |= k10c_put_row(Lp + (size_t)i0 * n, a, K10C_NB, i0, pairs);\n'
         '    if (i1 < h) bad |= k10c_put_row(Lp + (size_t)i1 * n, c, K10C_NB, i1, pairs);\n',
         '    if (n < 0 && i0 < h) bad |= k10c_put_row(Lp + (size_t)i0 * n, a, K10C_NB, i0, pairs);\n'
         '    if (n < 0 && i1 < h) bad |= k10c_put_row(Lp + (size_t)i1 * n, c, K10C_NB, i1, pairs);\n')],
}


# the edits above apply to the cluster variant's part of the source alone
CLUSTER_SCOPE = ('// K10, cluster variant', '// K10, stream variant')


def cluster_source(edits):
    """The source with the edits made in the cluster variant's part (each text
    must occur once there)."""
    src = variant_source([])
    a, b = (src.index(m) for m in CLUSTER_SCOPE)
    part = src[a:b]
    for old, new in edits:
        if part.count(old) != 1:
            raise RuntimeError(f'the text {old!r} does not occur once in K10\'s cluster variant')
        part = part.replace(old, new)
    return src[:a] + part + src[b:]


# The parent's one-CTA global variant (its chol_factor_kernel), stamped:
# thread 0 adds the cycles of each piece up; the pieces follow its block
# barriers, so thread 0's clock is the block's
PARENT_PHASES = ('copy of M into L', 'panel loads', 'column chains', 'panel stores',
                 'trailing updates', 'finite scan')
NPP = len(PARENT_PHASES)
PARENT_STAMPS = [
    ('__global__ void __launch_bounds__(K10_THREADS, 1)\nchol_factor_kernel(',
     '__device__ long long k10g_stamps[%d][%d];\n'
     '#define K10G_T(i) do { if (tid == 0) { const long long c_ = clock64(); '
     'acc_[i] += c_ - last_; last_ = c_; } } while (0)\n'
     '__global__ void __launch_bounds__(K10_THREADS, 1)\nchol_factor_kernel(' % (STAMP_CTAS, NPP + 2)),
    ('  double* Lw = L + (size_t)lane * n * n;\n  for (int t = tid; t < n * n; t += K10_THREADS) {',
     '  double* Lw = L + (size_t)lane * n * n;\n'
     '  long long acc_[%d] = {0}, last_ = clock64(), g0_ = 0;\n'
     '  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g0_));\n'
     '  for (int t = tid; t < n * n; t += K10_THREADS) {' % NPP),
    ('  __syncthreads();\n  bool failed = false;\n',
     '  __syncthreads();\n  bool failed = false;\n  K10G_T(0);\n'),
    ('      P[r * K10_LD + cc] = cc < w ? Lw[(size_t)(j0 + r) * n + j0 + cc] : 0.0;\n    }\n'
     '    __syncthreads();\n',
     '      P[r * K10_LD + cc] = cc < w ? Lw[(size_t)(j0 + r) * n + j0 + cc] : 0.0;\n    }\n'
     '    __syncthreads();\n    K10G_T(1);\n'),
    ('    if (failed) break;\n    for (int t = tid; t < rows * w; t += K10_THREADS) {',
     '    K10G_T(2);\n    if (failed) break;\n    for (int t = tid; t < rows * w; t += K10_THREADS) {'),
    ('      if (r >= cc) Lw[(size_t)(j0 + r) * n + j0 + cc] = P[r * K10_LD + cc];\n    }\n',
     '      if (r >= cc) Lw[(size_t)(j0 + r) * n + j0 + cc] = P[r * K10_LD + cc];\n    }\n'
     '    K10G_T(3);\n'),
    ('      *e = *e - acc;\n    }\n    __syncthreads();\n',
     '      *e = *e - acc;\n    }\n    __syncthreads();\n    K10G_T(4);\n'),
    ('bad |= !isfinite(Lw[t]);\n  }\n  failed = __syncthreads_or(failed || bad) != 0;\n',
     'bad |= !isfinite(Lw[t]);\n  }\n  failed = __syncthreads_or(failed || bad) != 0;\n'
     '  K10G_T(5);\n'
     '  if (tid == 0 && blockIdx.x < %d) {\n'
     '    long long g1_, sum_ = 0;\n'
     '    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g1_));\n'
     '    for (int i_ = 0; i_ < %d; ++i_) { k10g_stamps[blockIdx.x][i_] = acc_[i_]; sum_ += acc_[i_]; }\n'
     '    k10g_stamps[blockIdx.x][%d] = sum_;\n'
     '    k10g_stamps[blockIdx.x][%d] = g1_ - g0_;\n'
     '  }\n' % (STAMP_CTAS, NPP, NPP, NPP + 1)),
]
PARENT_READER = r'''
extern "C" int k10g_stamps_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, k10g_stamps, (size_t)bytes);
}
'''


def parent_stamped(root):
    """The parent tree's source with its global variant stamped."""
    with open(os.path.join(root, 'awebox_tpu_torch', 'csrc', 'auglu.cu')) as fh:
        src = fh.read()
    for old, new in PARENT_STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f'the text {old!r} does not occur once in the parent\'s source')
        src = src.replace(old, new)
    return src + PARENT_READER


def parent_phases(lib, M):
    """Microseconds of each piece of the parent's global variant on M (thread
    0 of each lane's CTA, median over lanes) and in all, at the clock the
    stamps measured, from the last of five calls."""
    B, n = M.shape[0], M.shape[1]
    L, ok = torch.empty_like(M), torch.empty(B, dtype=torch.bool, device='cuda')
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for _ in range(5):
        err = lib.chol_factor_global(ptr(M), ptr(L), ptr(ok), B, n, stream)
        if err:
            raise RuntimeError(f'chol_factor_global (parent, stamped): CUDA error {err}')
    torch.cuda.synchronize()
    buf = np.zeros((STAMP_CTAS, NPP + 2), dtype=np.int64)
    err = lib.k10g_stamps_read(buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if err:
        raise RuntimeError(f'k10g_stamps_read: CUDA error {err}')
    st = buf[:B].astype(np.float64)
    ghz = float(np.median(st[:, NPP] / np.maximum(st[:, NPP + 1], 1)))
    return ghz, [float(np.median(st[:, i])) / ghz / 1e3 for i in range(NPP)], \
        float(np.median(st[:, NPP])) / ghz / 1e3


def takes(mod, n):
    """Whether the kernels module mod has a K10 variant for n."""
    try:
        mod.chol_factor_geometry(n)
    except ValueError:
        return False
    return True


def bind(lib):
    for name in ('chol_factor_cluster', 'chol_factor_cluster_occupancy'):
        getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def chol_ptxas(log):
    out, keep = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = next((k for k in ('chol_factor_cluster_kernel', 'chol_factor_stream_kernel')
                         if k in line), None)
        elif keep and re.search(r'registers|stack frame', line):
            out.append(f'{keep}: ' + line.replace('ptxas info    :', '').strip())
    return out


def spd(n, B, rng):
    G = rng.standard_normal((B, n, n))
    return torch.as_tensor(G @ G.transpose(0, 2, 1) / n + np.eye(n), device='cuda')


def caller(lib, M, geom, out):
    """One launch of lib's cluster kernel on M with layout geom into out = (L, ok)."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    B, n = M.shape[0], M.shape[1]

    def call():
        err = lib.chol_factor_cluster(ptr(M), ptr(out[0]), ptr(out[1]), B, n, geom.C, geom.ld,
                                      geom.recv_off, geom.smem_bytes, stream)
        if err:
            raise RuntimeError(f'chol_factor_cluster: CUDA error {err}')
    return call


def max_active(lib, geom):
    count = ctypes.c_int(0)
    err = lib.chol_factor_cluster_occupancy(geom.C, geom.smem_bytes, ctypes.byref(count))
    if err:
        raise RuntimeError(f'chol_factor_cluster_occupancy: CUDA error {err}')
    return count.value


def phase_cut(lib, call, C, B):
    """Microseconds of each piece (mean over a lane's ranks, median over
    lanes) and of the whole kernel (rank 0), from the stamps of the last of
    five calls."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    buf = np.zeros((STAMP_CTAS, NPH + 2), dtype=np.int64)
    err = lib.k10c_stamps_read(buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if err:
        raise RuntimeError(f'k10c_stamps_read: CUDA error {err}')
    lanes = min(B, STAMP_CTAS // C)
    st = buf[:lanes * C].reshape(lanes, C, NPH + 2).astype(np.float64)
    ghz = float(np.median(st[:, 0, NPH] / np.maximum(st[:, 0, NPH + 1], 1)))
    parts = [float(np.median(st[:, :, i].mean(axis=1))) / ghz / 1e3 for i in range(NPH)]
    return ghz, parts, float(np.median(st[:, 0, NPH])) / ghz / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chol_phases: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    builds = {'whole': start_build('chol_whole', variant_source([])),
              'stamps': start_build('chol_stamps', cluster_source(STAMPS) + STAMP_READER)}
    for name, edits in CUTS.items():
        builds[name] = start_build('chol_' + re.sub(r'\W', '_', name), cluster_source(edits))
    if args.parent and 'chol_factor_kernel(' in open(
            os.path.join(args.parent, 'awebox_tpu_torch', 'csrc', 'auglu.cu')).read():
        builds['parent stamps'] = start_build('chol_parent_stamps', parent_stamped(args.parent))
    parent = load_parent(args.parent) if args.parent else None
    threads = [threading.Thread(target=m.library) for m in (kernels, parent) if m is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name, (so, proc) in builds.items():
        libs[name], log = finish_build(name, so, proc)
        if name == 'parent stamps':
            lib = libs[name]
            lib.chol_factor_global.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
                + [ctypes.c_void_p]
            lib.chol_factor_global.restype = ctypes.c_int
            lib.k10g_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.k10g_stamps_read.restype = ctypes.c_int
            continue
        bind(libs[name])
        if name == 'whole':
            for line in chol_ptxas(log):
                print(f'ptxas {line}', flush=True)
    libs['stamps'].k10c_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    libs['stamps'].k10c_stamps_read.restype = ctypes.c_int
    rng = np.random.default_rng(0)
    failed = []
    for n, B in SHAPES:
        geom = kernels.chol_factor_geometry(n)
        tag = f'n={n} B={B:3d}'
        M = spd(n, B, rng)
        L, ok = kernels.chol_factor_batched(M)
        Lp, okp = kernels.chol_factor_batched_plain(M)
        torch.cuda.synchronize()
        gap = float((L - Lp).abs().max() / Lp.abs().max())
        good = bool(ok.all()) and bool(okp.all()) and gap <= 1e-12
        failed += [] if good else [tag]
        line = (f'{tag} {geom.variant} C={geom.C} nb={geom.nb} ld={geom.ld} smem '
                f'{geom.smem_bytes} B: L gap to plain {gap:.2e}, ok {int(ok.sum())}/{B}')
        mc = kernels.cluster_max_active(f'chol_factor_{geom.variant}', geom)
        line += f'; {mc} clusters at once, {-(-B // mc)} wave(s)'
        if geom.variant == 'stream':
            line += ('; panels in L a rank ' + ','.join(str(sum(o is None for o in offs))
                                                         for offs in geom.offsets))
        in_parent = parent is not None and takes(parent, n)
        if in_parent:
            L_o, _ = parent.chol_factor_batched(M)
            torch.cuda.synchronize()
            line += f'; to the parent {float((L - L_o).abs().max() / L_o.abs().max()):.2e}'
        print(line, flush=True)
        this = lambda: kernels.chol_factor_batched(M)
        if in_parent and n == 700 and B > 1 and 'parent stamps' in libs:
            ghz, parts, total = parent_phases(libs['parent stamps'], M)
            print(f'{tag} parent global variant phases (thread 0, median over lanes, us at '
                  f'{ghz:.3f} GHz): ' + ', '.join(f'{p} {t:.1f}' for p, t in
                                                  zip(PARENT_PHASES, parts))
                  + f'; total {total:.1f}', flush=True)
        if in_parent:
            before = lambda: parent.chol_factor_batched(M)
            times = [queued_ms(call) for call in (before, this, this, before)]
            print(f'{tag} K10 parent, this tree, this tree, parent: '
                  + ' / '.join(f'{t:.4f}' for t in times) + ' ms', flush=True)
        else:
            print(f'{tag} K10 this tree: {queued_ms(this):.4f} ms', flush=True)
        lib_ms = queued_ms(lambda: torch.linalg.cholesky_ex(M))
        b_ms, b_by = chol_factor_bound(n, B)
        print(f'{tag} torch.linalg.cholesky_ex {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})',
              flush=True)
        if geom.variant != 'cluster':
            continue
        out = (torch.empty_like(M), torch.empty(B, dtype=torch.bool, device='cuda'))
        stamped = caller(libs['stamps'], M, geom, out)
        ghz, parts, total = phase_cut(libs['stamps'], stamped, geom.C, B)
        P = -(-n // geom.nb)
        print(f'{tag} phases (mean over ranks, median over lanes, us at {ghz:.3f} GHz): '
              + ', '.join(f'{p} {t:.2f}' for p, t in zip(PHASES, parts))
              + f'; total {total:.2f} ({total / P:.2f} a panel of {P}); stamped kernel '
              f'{queued_ms(stamped):.4f} ms', flush=True)
        for name in CUTS:
            print(f'{tag} cut {name} {queued_ms(caller(libs[name], M, geom, out)):.4f} ms',
                  flush=True)
        if n == 280 and B in (1, 16, 128):
            cells = []
            for C in LAYOUT_SIZES:
                g = kernels.chol_cluster_layout(n, C)
                if g is None:
                    cells.append(f'C={C} does not fit')
                    continue
                call = caller(libs['whole'], M, g, out)
                call()
                torch.cuda.synchronize()
                same = bool(out[1].all()) and float((out[0] - Lp).abs().max()) <= 1e-12 * float(
                    Lp.abs().max())
                cells.append(f'C={C} ({g.smem_bytes} B, {max_active(libs["whole"], g)} at once'
                             f'{"" if same else ", WRONG"}) {queued_ms(call):.4f}')
            print(f'{tag} layouts: ' + '; '.join(cells) + ' ms', flush=True)
    if parent is not None:
        print(f'parent launches: {parent.LAUNCHES["chol_factor_batched"]}', flush=True)
    if failed:
        print(f'chol_phases: differs from the plain version at {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
