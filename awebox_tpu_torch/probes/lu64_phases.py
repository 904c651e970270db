#!/usr/bin/env python3
"""Where K12 (lu_factor_f64_kernel of awebox_tpu_torch/csrc/auglu.cu) spends
its time on the card, and how it compares with a parent tree's K12 and with
torch.linalg.lu_factor_ex.

Random saddle matrices shaped like the host solver's augmented K
(tests/test_torch_kernels.py's host_kkt_matrices with the n of each grid),
f64, at N = 543 (n_k=4) B = 1 and 16, 1055 (n_k=8), 1311 (n_k=10), 1823
(n_k=14) and 2335 (n_k=18) B = 1. At each shape:

- the cluster kernels.lu_factor_f64_geometry gives (C, shared memory a
  rank) and the clusters of it the card runs at once;
- K12's backward error max |P L U - K| / (P |L| |U|) beside the plain
  version's, and whether the pivots are the plain version's;
- queued CUDA-event medians of 15 (behind a device sleep) of this tree's
  kernel, of the parent's in turns (parent, this, this, parent) where the
  parent takes the shape (its blocked K12 stopped at N = 1807), of
  lu_factor_ex and the bound (probes/yardstick.py, as chip_smoke.py reports
  them);
- at N = 543, 1311 and 2335 (B = 1), phase cuts from clock64 stamps of a
  copy of the source built with K12_STAMPS defined: thread 0 of every CTA
  adds the cycles of each piece up (the copy-in; the handoff waits at the
  cluster barrier; the look-ahead's interchanges and U12 of the next panel,
  and its update by MMAs; a panel's loads and stores with a half panel's
  steps; the passes' interchanges and U12; their L2 chunk fetches of L21;
  their trailing MMA updates; the last interchanges with the copy-out; and
  a chain's column in four: its warps' argmax and row publication before
  the barrier, the barrier's wait, the slots' reduction with the
  reciprocal, the row updates), in microseconds at the clock the stamps
  measured (clock64 over %globaltimer), for rank 0 and the mean and the
  largest over the ranks, beside the whole call's; and the cycles a column
  of the chain's pieces (all ranks' over N);
- with --rings, at N = 543, 1311 and 2335 (B = 1), copies of the source
  built with other depths of the warps' rings of tile pairs (K12_RING,
  K12_RING_AHEAD: 1 and 1, 4 and 2, beside the source's) timed in turns
  with it (this, 4, 1, 1, 4, this), each with the shared memory its depths
  need, and whether they give the same bits.

With --parent, the kernels module of the tree at that path is loaded under
its own name (a parent commit unpacked with ``git archive`` into a directory
that .gitignore lists):

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/lu64_phases.py --parent _archive/parent [--rings]

Prints the card, ptxas's registers and spills of K12, then lines per shape.
Exits non-zero if this tree's backward error exceeds 10x the plain
version's (at least one epsilon). Needs a CUDA card and nvcc; about four
minutes (three builds run side by side).
"""
import argparse
import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import threading

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
from awebox_tpu_torch.parallel import kernels  # noqa: E402
from awebox_tpu_torch.probes.qr_phases import load_parent, queued_ms  # noqa: E402
from awebox_tpu_torch.probes.yardstick import lu_factor_f64_bound  # noqa: E402

SHAPES = ((543, 1), (543, 16), (1055, 1), (1311, 1), (1823, 1), (2335, 1))
N_PRIMAL = {543: 280, 1055: 540, 1311: 670, 1823: 930, 2335: 1190}
STAMPED = (543, 1311, 2335)
STAMP_CTAS = 256
PHASES = ('copy-in', 'handoff waits', 'look-ahead swaps and U12', 'look-ahead update',
          'panel loads, stores, halves', 'swaps and U12', 'L21 chunk fetches',
          'trailing updates', 'last swaps and copy-out', 'chain: before the barrier',
          'chain: barrier waits', 'chain: slots and reciprocal', 'chain: row updates')
NPH = len(PHASES)

# thread 0 of every CTA adds the cycles since its last stamp to a phase's count
STAMP_PRELUDE = r'''
#define K12_STAMPS
__device__ long long k12_stamps[STAMP_CTAS][NPH + 2];
__shared__ long long k12_acc[NPH];
__shared__ long long k12_last;
__shared__ long long k12_g0;
#define K12_STAMP_BEGIN() do { if (threadIdx.x == 0) { \
  for (int i_ = 0; i_ < NPH; ++i_) k12_acc[i_] = 0; \
  k12_last = clock64(); long long g_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); k12_g0 = g_; } } while (0)
#define K12_STAMP(i) do { if (threadIdx.x == 0) { \
  const long long c_ = clock64(); k12_acc[i] += c_ - k12_last; k12_last = c_; } } while (0)
#define K12_STAMP_END() do { if (threadIdx.x == 0 && blockIdx.x < STAMP_CTAS) { \
  long long g1_, sum_ = 0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1_)); \
  for (int i_ = 0; i_ < NPH; ++i_) { k12_stamps[blockIdx.x][i_] = k12_acc[i_]; sum_ += k12_acc[i_]; } \
  k12_stamps[blockIdx.x][NPH] = sum_; k12_stamps[blockIdx.x][NPH + 1] = g1_ - k12_g0; } } \
  while (0)
'''.replace('STAMP_CTAS', str(STAMP_CTAS)).replace('NPH', str(NPH))
STAMP_READER = r'''
extern "C" int k12_stamps_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, k12_stamps, (size_t)bytes);
}
'''
ANCHOR = 'constexpr int K12_NB = 16;\n'


def host_kkt_matrices():
    path = os.path.join(ROOT, 'tests', 'test_torch_kernels.py')
    spec = importlib.util.spec_from_file_location('k12_ktests', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.host_kkt_matrices


def stamped_build():
    """The source with the stamps compiled in, built by nvcc in the
    background; returns (library path, process)."""
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    if src.count(ANCHOR) != 1:
        raise RuntimeError(f'{ANCHOR!r} does not occur once in {kernels.SOURCE}')
    src = src.replace(ANCHOR, STAMP_PRELUDE + ANCHOR) + STAMP_READER
    out = os.path.join(kernels.BUILD_ROOT, 'probe_lu64')
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, 'auglu.cu'), os.path.join(out, 'libauglu.so')
    with open(cu, 'w') as fh:
        fh.write(src)
    return so, subprocess.Popen(
        [kernels._nvcc()] + kernels.NVCC_FLAGS + ['-Xptxas', '-v', '-o', so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


RING_VARIANTS = ((4, 2), (1, 1))   # (K12_RING, K12_RING_AHEAD) beside the source's


def ring_build(ring, ahead):
    """The source with other ring depths, built by nvcc in the background;
    returns (library path, process)."""
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    for name, value in (('K12_RING', ring), ('K12_RING_AHEAD', ahead)):
        old = re.search(rf'constexpr int {name} = \d+;', src).group(0)
        src = src.replace(old, f'constexpr int {name} = {value};', 1)
    out = os.path.join(kernels.BUILD_ROOT, f'probe_lu64_ring{ring}{ahead}')
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, 'auglu.cu'), os.path.join(out, 'libauglu.so')
    with open(cu, 'w') as fh:
        fh.write(src)
    return so, subprocess.Popen([kernels._nvcc()] + kernels.NVCC_FLAGS + ['-o', so, cu],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ring_call(lib, K, ring, ahead):
    """K12 from a ring variant's library at the geometry's C, with the
    shared memory its depths need; returns a call giving (lu, piv)."""
    B, N, _ = K.shape
    C = kernels.lu_factor_f64_geometry(N, B).C
    lu, piv = torch.empty_like(K), torch.empty(B, N, dtype=torch.int32, device=K.device)
    work = torch.empty(B, -(-N // 16), N, 16, dtype=torch.float64, device=K.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def call():
        err = lib.lu_factor_f64(ptr(K), ptr(lu), ptr(piv), ptr(work), B, N, C,
                                kernels.lu_factor_f64_smem(N, ring, ahead),
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f'lu_factor_f64 (rings {ring}, {ahead}): CUDA error {err}')
        return lu, piv
    return call


def k12_ptxas(log):
    out, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = 'lu_factor_f64_kernel' in line
        elif keep and re.search(r'registers|stack frame', line):
            out.append(line.replace('ptxas info    :', '').strip())
    return out


def backward_error(K, lu, piv):
    """Per lane max |P L U - K| / (P |L| |U|) (an entry whose denominator is
    0 counts its error alone), as chip_smoke.py gates K12."""
    P_, L_, U_ = torch.lu_unpack(lu, piv)
    e, d = (P_ @ L_ @ U_ - K).abs(), P_ @ (L_.abs() @ U_.abs())
    return torch.where(d > 0, e / d, e).amax(dim=(1, 2))


def stamped_call(lib, K):
    """K12 from the stamped library (the geometry's launch); returns the
    factor and the pivots."""
    B, N, _ = K.shape
    g = kernels.lu_factor_f64_geometry(N, B)
    lu, piv = torch.empty_like(K), torch.empty(B, N, dtype=torch.int32, device=K.device)
    work = torch.empty(B, -(-N // 16), N, 16, dtype=torch.float64, device=K.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.lu_factor_f64(ptr(K), ptr(lu), ptr(piv), ptr(work), B, N, g.C, g.smem_bytes,
                            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f'lu_factor_f64 (stamped): CUDA error {err}')
    return lu, piv


def phase_cut(lib, K):
    """Microseconds of each phase for rank 0 and the mean and the largest
    over the ranks of lane 0, from the stamps of the last of five calls, at
    the clock they measured; and the whole call's."""
    for _ in range(5):
        stamped_call(lib, K)
    torch.cuda.synchronize()
    C = kernels.lu_factor_f64_geometry(K.shape[1], K.shape[0]).C
    buf = np.zeros((STAMP_CTAS, NPH + 2), dtype=np.int64)
    err = lib.k12_stamps_read(buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if err:
        raise RuntimeError(f'k12_stamps_read: CUDA error {err}')
    st = buf[:C]
    ghz = float(np.median(st[:, NPH] / np.maximum(st[:, NPH + 1], 1)))
    us = st[:, :NPH] / ghz / 1e3
    return ghz, us[0], us.mean(axis=0), us.max(axis=0), float(st[:, NPH + 1].max()) / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', help='root of a parent tree (git archive) to time in turns')
    ap.add_argument('--rings', action='store_true', help='time other ring depths in turns')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('lu64_phases.py needs a CUDA card', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(f'card: {smi}', flush=True)
    so, proc = stamped_build()
    rings = {depths: ring_build(*depths) for depths in RING_VARIANTS} if args.rings else {}
    parent = load_parent(args.parent) if args.parent else None
    builds = [threading.Thread(target=kernels.library)]
    if parent is not None:
        builds.append(threading.Thread(target=parent.library))
    for t in builds:
        t.start()
    log = proc.communicate()[0]
    for t in builds:
        t.join()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed (stamped K12)\n{log}')
    print('ptxas, K12: ' + '; '.join(k12_ptxas(log)), flush=True)
    slib = ctypes.CDLL(so)
    slib.lu_factor_f64.argtypes = kernels.SIGNATURES['lu_factor_f64']
    slib.lu_factor_f64.restype = ctypes.c_int
    slib.k12_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    slib.k12_stamps_read.restype = ctypes.c_int
    ring_libs = {}
    for depths, (rso, rproc) in rings.items():
        rlog = rproc.communicate()[0]
        if rproc.returncode != 0:
            raise RuntimeError(f'nvcc failed (rings {depths})\n{rlog}')
        ring_libs[depths] = ctypes.CDLL(rso)
        ring_libs[depths].lu_factor_f64.argtypes = kernels.SIGNATURES['lu_factor_f64']
        ring_libs[depths].lu_factor_f64.restype = ctypes.c_int
    make = host_kkt_matrices()
    eps = torch.finfo(torch.float64).eps
    failed = []
    for N, B in SHAPES:
        K_np, _ = make(N, B, seed=N + B, n=N_PRIMAL[N])
        K = torch.as_tensor(K_np, device='cuda')
        g = kernels.lu_factor_f64_geometry(N, B)
        act = kernels.cluster_max_active('lu_factor_f64', g)
        lu, piv = kernels.lu_factor_f64(K)
        lu_p, piv_p = kernels.lu_factor_f64_plain(K)
        fac, fac_p = backward_error(K, lu, piv), backward_error(K, lu_p, piv_p)
        ok = bool((fac <= 10 * torch.clamp(fac_p, min=eps)).all())
        if not ok:
            failed.append((N, B))
        this = lambda: kernels.lu_factor_f64(K)
        lib_ms = queued_ms(lambda: kernels.lu_factor_f64_plain(K))
        bound = lu_factor_f64_bound(N, B)
        takes_parent = parent is not None and N <= 1807
        if takes_parent:
            old = lambda: parent.lu_factor_f64(K)
            t = [queued_ms(old), queued_ms(this), queued_ms(this), queued_ms(old)]
            turns = (f'parent {t[0]:.4f} / {t[3]:.4f}, this {t[1]:.4f} / {t[2]:.4f} ms '
                     f'(means {(t[0] + t[3]) / 2:.4f} -> {(t[1] + t[2]) / 2:.4f})')
        else:
            t = [queued_ms(this)]
            turns = f'this {t[0]:.4f} ms' + (' (the parent raises)' if parent is not None else '')
        print(f'N={N} B={B}: C={g.C}, {g.smem_bytes} B a rank, {act} clusters at once; backward '
              f'error {float(fac.max()):.2e} vs plain {float(fac_p.max()):.2e}, pivots as plain '
              f'{bool(torch.equal(piv, piv_p))}; queued {turns}; lu_factor_ex {lib_ms:.4f} ms; '
              f'bound {bound[0]:.5f} ms ({bound[1]})', flush=True)
        if B == 1 and N in STAMPED:
            ghz, r0, mean, most, whole = phase_cut(slib, K)
            print(f'  phases at {ghz:.3f} GHz, whole call {whole:.1f} us; us rank 0 / mean / '
                  f'largest over the {g.C} ranks:', flush=True)
            for i, name in enumerate(PHASES):
                print(f'    {name:26s} {r0[i]:9.1f} {mean[i]:9.1f} {most[i]:9.1f}', flush=True)
            chain = [mean[i] * g.C * ghz * 1e3 / N for i in (4, 9, 10, 11, 12)]
            print(f'  cycles a column (all ranks\' over N): panel loads, stores and halves '
                  f'{chain[0]:.0f}; the chain {sum(chain[1:]):.0f} (before the barrier '
                  f'{chain[1]:.0f}, barrier waits {chain[2]:.0f}, slots and reciprocal '
                  f'{chain[3]:.0f}, row updates {chain[4]:.0f})', flush=True)
    for N in (STAMPED if ring_libs else ()):
        K = torch.as_tensor(make(N, 1, seed=N + 1, n=N_PRIMAL[N])[0], device='cuda')
        lu0, _ = kernels.lu_factor_f64(K)
        this = lambda: kernels.lu_factor_f64(K)
        calls = {d: ring_call(lib, K, *d) for d, lib in ring_libs.items()}
        same = {d: bool(torch.equal(c()[0].view(torch.int64), lu0.view(torch.int64)))
                for d, c in calls.items()}
        (d4, c4), (d1, c1) = sorted(calls.items(), reverse=True)
        t = [queued_ms(this), queued_ms(c4), queued_ms(c1), queued_ms(c1), queued_ms(c4),
             queued_ms(this)]
        print(f'rings at N={N} B=1, queued, in turns: this ({kernels.LU64_RING}, '
              f'{kernels.LU64_RING_AHEAD}) {t[0]:.4f} / {t[5]:.4f}, {d4} {t[1]:.4f} / {t[4]:.4f}, '
              f'{d1} {t[2]:.4f} / {t[3]:.4f} ms; the same bits {same}', flush=True)
    if failed:
        print(f'K12 beyond 10x the plain backward error at {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
