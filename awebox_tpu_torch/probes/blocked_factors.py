#!/usr/bin/env python3
"""Times the blocked variants of K2 and K6 (awebox_tpu_torch/csrc/auglu.cu:
lu_factor_blocked, qr_factor_blocked) on the card at the n_k=8 size N=1055,
beside phase-cut copies of them, cuSOLVER's getrf and geqrf and, with
--parent, the one-block variants they replaced, from the tree at --parent
(a parent commit unpacked with ``git archive`` into a directory that
.gitignore lists), in the same call:

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/blocked_factors.py --parent _archive/parent

A cut removes launches from the C entry points; its results are wrong and
its time says what the rest costs: 'panels only' keeps the panel factors
alone, 'no update' drops the trailing update (LU keeps its interchanges and
U12, QR its W = V^T A22 pass), 'panel load and store' keeps only the panel
kernels' copies in and out of shared memory. Each cut names the source text
it replaces and fails loudly when the kernel has changed under it. All
times are queued behind a device sleep (CUDA events, median of --runs; the
one-block variants and the library calls take 5 runs). Prints the card,
then one line per shape and variant. Needs a CUDA card and nvcc.
"""
import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
from awebox_tpu_torch.parallel import kernels  # noqa: E402

LU_SWAP = ('    if (N > w) lu_swap_kernel<<<', '    if (N < 0) lu_swap_kernel<<<')
LU_UPDATE = ('      lu_update_kernel<<<dim3(tiles, B), KB_UTHREADS, 0, st>>>(a, N, k0);', '')
LU_COLUMNS = ('  for (int k = 0; k < w; ++k) {\n    __syncthreads();                          '
              '// the slots of column k are in',
              '  for (int k = 0; k < 0; ++k) {\n    __syncthreads();')
QR_W = ('      qr_w_kernel<<<dim3((nt + KB_NB - 1) / KB_NB, B), KB_UTHREADS, 0, st>>>'
        '(a, (float*)Ww, N, k0);', '')
QR_UPDATE = ('      qr_update_kernel<<<dim3(tiles, B), KB_UTHREADS, 0, st>>>(a, (const float*)Tw,',
             '      if (N < 0) qr_update_kernel<<<dim3(tiles, B), KB_UTHREADS, 0, st>>>'
             '(a, (const float*)Tw,')
QR_COLUMNS = ('  for (int k = 0; k < w; ++k) {\n    if (warp == k) {',
              '  for (int k = 0; k < 0; ++k) {\n    if (warp == k) {')
QR_GT = ('  if (warp < w) {\n    float g[KB_NB];', '  if (warp < 0) {\n    float g[KB_NB];')
# variant -> [(text in csrc/auglu.cu, replacement)]; every text must occur once
CUTS = {
    'LU: no update': [LU_UPDATE],
    'LU: panels only': [LU_UPDATE, LU_SWAP],
    'LU: panel load and store': [LU_UPDATE, LU_SWAP, LU_COLUMNS],
    'QR: no update': [QR_UPDATE],
    'QR: panels only': [QR_UPDATE, QR_W],
    'QR: panels without G and T': [QR_UPDATE, QR_W, QR_GT],
    'QR: panel load and store': [QR_UPDATE, QR_W, QR_GT, QR_COLUMNS],
}


def build_cuts():
    """Writes and compiles every cut at once; returns {variant: library}."""
    with open(kernels.SOURCE) as fh:
        source = fh.read()
    procs = {}
    for name, cuts in CUTS.items():
        src = source
        for old, new in cuts:
            if src.count(old) != 1:
                raise RuntimeError(f'{name}: the cut {old!r} does not occur once in '
                                   f'{kernels.SOURCE}')
            src = src.replace(old, new)
        out = os.path.join(kernels.BUILD_ROOT, 'probe_blocked',
                           ''.join(c if c.isalnum() else '_' for c in name))
        os.makedirs(out, exist_ok=True)
        cu, so = os.path.join(out, 'auglu.cu'), os.path.join(out, 'libauglu.so')
        with open(cu, 'w') as fh:
            fh.write(src)
        procs[name] = (so, subprocess.Popen([kernels._nvcc()] + kernels.NVCC_FLAGS + ['-o', so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{log}')
        lib = ctypes.CDLL(so)
        for entry in ('lu_factor_blocked', 'qr_factor_blocked'):
            getattr(lib, entry).argtypes = kernels.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def load_parent(root):
    """The kernels module of the tree at root, under a name of its own."""
    path = os.path.join(os.path.abspath(root), 'awebox_tpu_torch', 'parallel', 'kernels.py')
    spec = importlib.util.spec_from_file_location('parent_kernels', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def queued_ms(call, n, setup=None):
    if setup is not None:
        setup()
    call()
    times = []
    for _ in range(n):
        if setup is not None:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    ap.add_argument('--runs', type=int, default=15)
    ap.add_argument('--N', type=int, default=1055)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('blocked_factors: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.library()
    libs = build_cuts()
    parent = load_parent(args.parent) if args.parent else None
    if parent is not None:
        parent.library()
    N = args.N
    lg, qg = kernels.lu_factor_geometry(N), kernels.qr_factor_geometry(N)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    g = torch.Generator(device='cpu').manual_seed(0)
    row = lambda B, name, ms: print(f'N={N:5d} B={B:4d} {name:34s} {ms:9.3f} ms', flush=True)
    for B in (2, 16):
        A = torch.randn(B, N, N, generator=g).cuda()
        work = torch.empty_like(A)
        refill = lambda: work.copy_(A)
        piv = torch.empty(B, N, dtype=torch.int32, device='cuda')
        qr, tau = torch.empty_like(A), torch.empty(B, N, device='cuda')
        Tw = torch.empty(B, 32, 32, device='cuda')
        Ww = torch.empty(B, 32, N, device='cuda')
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def lu_call(lib):
            def call():
                err = lib.lu_factor_blocked(ptr(work), ptr(piv), B, N, lg.ld, lg.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'lu_factor_blocked: CUDA error {err}')
            return call

        def qr_call(lib):
            def call():
                err = lib.qr_factor_blocked(ptr(A), ptr(qr), ptr(tau), ptr(Tw), ptr(Ww), B, N,
                                            qg.ld, qg.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'qr_factor_blocked: CUDA error {err}')
            return call
        row(B, 'LU: blocked (whole)', queued_ms(lu_call(kernels.library()), args.runs, refill))
        for name, lib in libs.items():
            if name.startswith('LU'):
                row(B, name, queued_ms(lu_call(lib), args.runs, refill))
        row(B, 'LU: cuSOLVER getrf', queued_ms(lambda: torch.linalg.lu_factor_ex(A), 5))
        if parent is not None:
            row(B, 'LU: parent one-block variant',
                queued_ms(lambda: parent.lu_factor_batched(work), 5, refill))
        row(B, 'QR: blocked (whole)', queued_ms(qr_call(kernels.library()), args.runs))
        for name, lib in libs.items():
            if name.startswith('QR'):
                row(B, name, queued_ms(qr_call(lib), args.runs))
        row(B, 'QR: cuSOLVER geqrf', queued_ms(lambda: torch.geqrf(A), 5))
        if parent is not None:
            row(B, 'QR: parent one-block variant',
                queued_ms(lambda: parent.qr_factor_batched(A), 5))
    if parent is not None:
        print(f'parent launches: {parent.LAUNCHES}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
