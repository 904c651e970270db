#!/usr/bin/env python3
"""Where K8 (awebox_tpu_torch/csrc/auglu.cu: block_factor_kernel) spends its
time on the card, and how it compares with a parent tree's kernel and with
the library composition of the same function.

Random SPD frames in the n_k=4 and n_k=8 layouts of the bench configuration
(nx=11, ni=54, nb=20, nloc=96), f64, at n_k=4 B = 1, 2, 4, 16, 128 and n_k=8
B = 1, 16 (a delta-ladder retry factors 1 to a few lanes). At each shape:

- max |.| gaps of Li, Xc and R = L_R L_R^T to block_factor_plain (and to the
  parent's kernel with --parent), each over the plain version's max;
- queued CUDA-event medians (behind a device sleep) of this tree's kernel, of
  the parent's in turns (parent, this, this, parent), of the library
  composition and the bound (both from probes/yardstick.py, as chip_smoke.py
  reports them);
- phase cuts from clock64 stamps of a copy of the source compiled beside it
  (thread 0 of every CTA stamps each phase: copy-in, interior panels, the Li,
  Xc and S stores, the first cluster barrier, the ranks' gather of R with the
  second, R's factor, L_R's store), as medians over the lanes in
  microseconds at the clock the stamps measured (clock64 over %globaltimer
  of rank 0), and each panel's steps (strip; panel with the rest of the
  update) in cycles for lane 0's rank 0; and cuts without the trailing
  updates, without the Li and Xc stores, and without the L_R store (wrong
  results; a cut's time says what the piece costs).

Each insertion names the source text it follows or replaces and fails loudly
when the kernel has changed under it. With --parent, the kernels module of
the tree at that path is loaded under its own name (a parent commit unpacked
with ``git archive`` into a directory that .gitignore lists):

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/block_phases.py --parent _archive/parent

Prints the card, ptxas's registers and spills of K8, then lines per shape.
Exits non-zero if this tree's kernel differs from the plain version by more
than chip_smoke.py's 1e-10 or fails a lane. Needs a CUDA card and nvcc;
about two minutes.
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
from awebox_tpu_torch.probes.qr_phases import load_parent, queued_ms  # noqa: E402
from awebox_tpu_torch.probes.yardstick import (block_factor_bound, block_factor_gaps,  # noqa: E402
                                               block_factor_library)

SHAPES = ((4, 1), (4, 2), (4, 4), (4, 16), (4, 128), (8, 1), (8, 16))
STAMP_CTAS = 1024
PHASES = ('copy-in', 'interior panels', 'Li, Xc, S stores', 'cluster barrier',
          'gather R (DSMEM) and barrier', 'R factor', 'L_R store')

STAMP_PRELUDE = r'''
__device__ long long kb8_ticks[%d][48];
__shared__ int kb8_tick_n;
#define KB8_TICK() do { if (threadIdx.x == 0 && blockIdx.x < %d && kb8_tick_n < 48) \
  kb8_ticks[blockIdx.x][kb8_tick_n++] = clock64(); } while (0)
__device__ long long kb8_stamps[%d][8][2];
#define KB8_STAMP(i) do { if (threadIdx.x == 0 && blockIdx.x < %d) { long long g_; \
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(g_)); \
  kb8_stamps[blockIdx.x][i][0] = clock64(); kb8_stamps[blockIdx.x][i][1] = g_; } } while (0)
''' % ((STAMP_CTAS,) * 4)
STAMP_READER = r'''
extern "C" int kb8_stamps_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, kb8_stamps, (size_t)bytes);
}
extern "C" int kb8_ticks_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, kb8_ticks, (size_t)bytes);
}
'''
# (text in csrc/auglu.cu, what replaces it); every text must occur once
STAMPS = [
    ('constexpr int KB8_THREADS = 256;\n', STAMP_PRELUDE + 'constexpr int KB8_THREADS = 256;\n'),
    ('  // 1. frame k in, permuted',
     '  KB8_STAMP(0);\n  if (threadIdx.x == 0) kb8_tick_n = 0;\n  // 1. frame k in, permuted'),
    # kb8_factor's ticks: entry, the first panel, then each strip and each panel with the
    # rest of the update (or the last update), each after its barrier
    ('  if (warp < 2 && kb8_panel(A, ld, n, 0, min(KB8_W, npiv), slot, warp, wl) && wl == 0) *flag = 1;\n'
     '  __syncthreads();\n',
     '  KB8_TICK();\n'
     '  if (warp < 2 && kb8_panel(A, ld, n, 0, min(KB8_W, npiv), slot, warp, wl) && wl == 0) *flag = 1;\n'
     '  __syncthreads();\n  KB8_TICK();\n'),
    ('      kb8_update(A, ld, n, p0, w, q0, q0, q0 + wn, true, 0, warp, wl);\n      __syncthreads();\n',
     '      kb8_update(A, ld, n, p0, w, q0, q0, q0 + wn, true, 0, warp, wl);\n      __syncthreads();\n'
     '      KB8_TICK();\n'),
    ('      __syncthreads();\n      if (*flag) return true;\n    } else {\n',
     '      __syncthreads();\n      KB8_TICK();\n      if (*flag) return true;\n    } else {\n'),
    ('      kb8_update(A, ld, n, p0, w, q0, q0, n, false, 0, warp, wl);\n      __syncthreads();\n',
     '      kb8_update(A, ld, n, p0, w, q0, q0, n, false, 0, warp, wl);\n      __syncthreads();\n'
     '      KB8_TICK();\n'),
    ("  // 2. the interior's ni pivots\n", "  KB8_STAMP(1);\n  // 2. the interior's ni pivots\n"),
    ('  // 3. Li, Xc (coupling order', '  KB8_STAMP(2);\n  // 3. Li, Xc (coupling order'),
    ("  cluster.sync();   // every rank's S and flag are published; rank 0's frame is spent\n",
     "  KB8_STAMP(3);\n  cluster.sync();   // every rank's S and flag are published; rank 0's "
     "frame is spent\n  KB8_STAMP(4);\n"),
    ("  cluster.sync();   // R is whole in rank 0, and no rank reads another's S any more\n",
     "  cluster.sync();   // R is whole in rank 0, and no rank reads another's S any more\n"
     "  KB8_STAMP(5);\n"),
    ('  double* LR = L_R + (size_t)lane * nr * nr;\n',
     '  KB8_STAMP(6);\n  double* LR = L_R + (size_t)lane * nr * nr;\n'),
    ('LR[t] = __longlong_as_double(0x7ff8000000000000ll);\n  }\n  if (tid == 0) ok[lane] = failed ? 0 : 1;\n',
     'LR[t] = __longlong_as_double(0x7ff8000000000000ll);\n  }\n  if (tid == 0) ok[lane] = failed ? 0 : 1;\n'
     '  KB8_STAMP(7);\n'),
]
# cuts: each removes one piece (wrong results; its time says what the piece costs)
CUTS = {
    'without the trailing updates': [
        ('  const int nt = (n - o + 7) >> 3, step = KB8_WARPS - w0;\n',
         '  return;\n  const int nt = (n - o + 7) >> 3, step = KB8_WARPS - w0;\n')],
    'without the Li and Xc stores': [
        ('  bool bad = kb8_store_lower(Li + ((size_t)lane * n_k + k) * ni * ni, F, ldf, ni, warp, wl);\n',
         '  bool bad = false;\n'),
        ('    for (int a = wl; a < c; a += 32) Xk[(size_t)i * c + a] = F[(size_t)(ni + a) * ldf + i];\n',
         '')],
    'without the L_R store': [
        ('  bad = !failed && kb8_store_lower(LR, F, ldr, nr, warp, wl);\n', '  bad = false;\n')],
}


def variant_source(edits):
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f'the text {old!r} does not occur once in {kernels.SOURCE}')
        src = src.replace(old, new)
    return src


def start_build(name, src):
    out = os.path.join(kernels.BUILD_ROOT, 'probe_block', name)
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, 'auglu.cu'), os.path.join(out, 'libauglu.so')
    with open(cu, 'w') as fh:
        fh.write(src)
    return so, subprocess.Popen(
        [kernels._nvcc()] + kernels.NVCC_FLAGS + ['-Xptxas', '-v', '-o', so, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(name, so, proc):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f'{name}: nvcc failed\n{log}')
    lib = ctypes.CDLL(so)
    lib.block_factor.argtypes = kernels.SIGNATURES['block_factor']
    lib.block_factor.restype = ctypes.c_int
    return lib, log


def k8_ptxas(log):
    out, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = 'block_factor_kernel' in line
        elif keep and re.search(r'registers|stack frame', line):
            out.append(line.replace('ptxas info    :', '').strip())
    return out


def frames(n_k, B, rng):
    """SPD frames laid out as ocp/blockkkt.py's (frame 0's x_0 slot empty),
    the damping and the ownership mask, on the card."""
    lay = kernels.BlockLayout(n_k, 11, 54, 20, 96)
    nx, nloc = lay.nx, lay.nloc
    G = rng.standard_normal((B, n_k, nloc, nloc)) * 10.0 ** rng.uniform(-1, 1, (B, n_k, nloc, 1))
    F = G @ G.transpose(0, 1, 3, 2) / nloc + np.eye(nloc) * 0.1
    F[:, 0, :nx, :] = 0.
    F[:, 0, :, :nx] = 0.
    own = np.ones((n_k, nloc))
    own[0, :nx] = 0.
    own[:-1, nx:2 * nx] = 0.
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device='cuda')
    return lay, t(F), t(np.full(B, 1e-8)), t(own)


def caller(lib, F, delta, own, lay, out):
    geom = kernels.block_factor_geometry(lay)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    B = F.shape[0]

    def call():
        err = lib.block_factor(ptr(F), ptr(delta), ptr(own), *(ptr(t) for t in out), B,
                               lay.n_k, lay.nx, lay.ni, lay.nb, geom.ld_frame, geom.ld_r,
                               geom.ld_s, geom.smem_bytes, stream)
        if err:
            raise RuntimeError(f'block_factor: CUDA error {err}')
    return call


def phase_cut(lib, call, n_k, B):
    """Median (over lanes) microseconds of each phase of rank 0, and of the
    other ranks' gather and second cluster barrier, from the stamps of the
    last of five calls."""
    for _ in range(5):   # the stamps of the last, warm call
        call()
    torch.cuda.synchronize()
    n = min(B * n_k, STAMP_CTAS)
    buf = np.zeros((STAMP_CTAS, 8, 2), dtype=np.int64)
    err = lib.kb8_stamps_read(buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
    if err:
        raise RuntimeError(f'kb8_stamps_read: CUDA error {err}')
    st = buf[:n].reshape(-1, n_k, 8, 2)
    r0 = st[:, 0]
    clk = r0[:, 7, 0] - r0[:, 0, 0]
    ns = r0[:, 7, 1] - r0[:, 0, 1]
    ghz = float(np.median(clk / np.maximum(ns, 1)))
    us = lambda cyc: float(np.median(cyc)) / ghz / 1e3
    parts = [us(r0[:, i + 1, 0] - r0[:, i, 0]) for i in range(7)]
    others = us(st[:, 1:, 5, 0] - st[:, 1:, 4, 0]) if n_k > 1 else 0.0
    ticks = np.zeros((STAMP_CTAS, 48), dtype=np.int64)
    err = lib.kb8_ticks_read(ticks.ctypes.data_as(ctypes.c_void_p), ticks.nbytes)
    if err:
        raise RuntimeError(f'kb8_ticks_read: CUDA error {err}')
    return ghz, parts, us(clk), others, ticks[0]


def panel_ticks(t, n):
    """kb8_factor's steps from one CTA's ticks (cycles): the first panel,
    then (strip, panel and rest) pairs and the last update, of a call over
    n pivots; returns (steps, the ticks that follow)."""
    panels = -(-n // kernels.BLOCK_WIDTH)
    count = 2 + 2 * (panels - 1) + 1
    d = np.diff(t[:count]).tolist()
    return d, t[count:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('block_phases: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    builds = {'whole': start_build('whole', variant_source([])),
              'stamps': start_build('stamps', variant_source(STAMPS) + STAMP_READER)}
    for name, edits in CUTS.items():
        builds[name] = start_build(re.sub(r'\W', '_', name), variant_source(edits))
    parent = load_parent(args.parent) if args.parent else None
    threads = [threading.Thread(target=m.library) for m in (kernels, parent) if m is not None]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name, (so, proc) in builds.items():
        libs[name], log = finish_build(name, so, proc)
        if name == 'whole':
            for line in k8_ptxas(log):
                print(f'ptxas block_factor_kernel: {line}', flush=True)
    for entry in ('kb8_stamps_read', 'kb8_ticks_read'):
        getattr(libs['stamps'], entry).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(libs['stamps'], entry).restype = ctypes.c_int
    rng = np.random.default_rng(0)
    failed = []
    for n_k, B in SHAPES:
        lay, F, delta, own = frames(n_k, B, rng)
        geom = kernels.block_factor_geometry(lay)
        tag = f'n_k={n_k} B={B:3d}'
        fac = kernels.block_factor(F, delta, own, lay)
        ref = kernels.block_factor_plain(F, delta, own, lay)
        torch.cuda.synchronize()
        g_plain = block_factor_gaps(fac, ref)
        ok = bool(fac[3].all()) and bool(ref[3].all()) and max(g_plain) <= 1e-10
        failed += [] if ok else [tag]
        line = (f'{tag} {geom}: Li/Xc/R gaps to plain '
                + '/'.join(f'{g:.2e}' for g in g_plain) + f', ok {int(fac[3].sum())}/{B}')
        if parent is not None:
            fac_o = parent.block_factor(F, delta, own, parent.BlockLayout(*lay))
            torch.cuda.synchronize()
            line += ('; to the parent ' + '/'.join(f'{g:.2e}' for g in block_factor_gaps(fac, fac_o)))
        print(line, flush=True)
        this = lambda: kernels.block_factor(F, delta, own, lay)
        if parent is not None:
            before = lambda: parent.block_factor(F, delta, own, parent.BlockLayout(*lay))
            times = [queued_ms(call) for call in (before, this, this, before)]
            print(f'{tag} K8 parent, this tree, this tree, parent: '
                  + ' / '.join(f'{t:.4f}' for t in times) + ' ms', flush=True)
        else:
            print(f'{tag} K8 this tree: {queued_ms(this):.4f} ms', flush=True)
        lib_ms = queued_ms(block_factor_library(F, delta, own, lay, fac[2]))
        b_ms, b_by = block_factor_bound(lay, B)
        print(f'{tag} library composition {lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by})',
              flush=True)
        out = tuple(torch.empty_like(t) for t in fac[:3]) + (torch.empty_like(fac[3]),)
        stamped = caller(libs['stamps'], F, delta, own, lay, out)
        ghz, parts, total, others, ticks = phase_cut(libs['stamps'], stamped, n_k, B)
        frame_steps, rest = panel_ticks(ticks, lay.ni)
        r_steps, _ = panel_ticks(rest, lay.nr)
        print(f'{tag} rank 0 of lane 0, cycles: interior: first panel {frame_steps[0]}, '
              f'(strip, panel + rest) {list(zip(frame_steps[1:-1:2], frame_steps[2:-1:2]))}, '
              f'last update {frame_steps[-1]}; R: first panel {r_steps[0]}, (strip, panel + '
              f'rest) {list(zip(r_steps[1:-1:2], r_steps[2:-1:2]))}, last update {r_steps[-1]}',
              flush=True)
        print(f'{tag} phases (rank 0, median over lanes, us at {ghz:.3f} GHz): '
              + ', '.join(f'{p} {t:.2f}' for p, t in zip(PHASES, parts))
              + f'; total {total:.2f}; the other ranks\' gather and barrier {others:.2f}; '
              f'stamped kernel {queued_ms(stamped):.4f} ms', flush=True)
        for name in CUTS:
            cut = caller(libs[name], F, delta, own, lay, out)
            print(f'{tag} cut {name} {queued_ms(cut):.4f} ms', flush=True)
    if parent is not None:
        print(f'parent launches: {parent.LAUNCHES["block_factor"]}', flush=True)
    if failed:
        print(f'block_phases: differs from the plain version at {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
