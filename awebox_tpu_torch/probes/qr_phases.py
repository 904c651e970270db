#!/usr/bin/env python3
"""Where K6 and K7 (awebox_tpu_torch/csrc/auglu.cu: qr_factor_cluster_kernel,
qr_solve_kernel) spend their time on the card: phase-cut copies of the source
are compiled side by side (one nvcc each, all at once) and timed queued
behind a device sleep on Gaussian lanes at N=543, B = 1 and 16. A cut removes
one phase; its results are wrong, its time says what the phase costs. Each
cut names the source text it replaces and fails loudly when the kernel has
changed under it.

    python3 awebox_tpu_torch/probes/qr_phases.py

Prints the card, then one line per shape and variant. Needs a CUDA card and
nvcc; takes about a minute.
"""
import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
from awebox_tpu_torch.parallel import kernels  # noqa: E402

# variant -> [(text in csrc/auglu.cu, replacement)]; every text must occur once
CUTS = {
    'whole': [],
    'K6: no trailing update': [
        ('  for (int k = 0; k < w; ++k) k6_apply<NC, T0>(a, V + (size_t)k * ld, tl[k], p0 + k, N, wl);',
         '')],
    'K6: no panel factor': [('    if (rank == owner) qr_panel<T0>(', '    if (N < 0) qr_panel<T0>(')],
    'K6: no panel copy': [
        ('        for (int q = (p0 >> 2) + wl; q < (Nr >> 2); q += 32) d4[q] = s4[q];', '')],
    'K6: load, barriers and store only': [
        ('  for (int k = 0; k < w; ++k) k6_apply<NC, T0>(a, V + (size_t)k * ld, tl[k], p0 + k, N, wl);',
         ''),
        ('    if (rank == owner) qr_panel<T0>(', '    if (N < 0) qr_panel<T0>('),
        ('        for (int q = (p0 >> 2) + wl; q < (Nr >> 2); q += 32) d4[q] = s4[q];', '')],
    'K6: panel without the reflector\'s norm': [
        ('      const float beta = larfg(alpha, warp_sum(x2[0] + x2[1]), tau, scale);',
         '      const float beta = larfg(alpha, x2[0] + x2[1], tau, scale);')],
    'K7: no Gram matrix': [
        ('        g[4 * q] = fmaf(va, ua.x, g[4 * q]);', ''),
        ('        g[4 * q + 1] = fmaf(va, ua.y, g[4 * q + 1]);', ''),
        ('        g[4 * q + 2] = fmaf(va, ua.z, g[4 * q + 2]);', ''),
        ('        g[4 * q + 3] = fmaf(va, ua.w, g[4 * q + 3]);', '')],
    'K7: no forward substitution': [
        ('        if (wl > j) wc = fmaf(-g[j], tj, wc);', '')],
    'K7: reflectors only': [
        ('  if (warp == 0) k7_diag(d, a, N, T - 1, wl);\n  for (int t = T - 1; t >= 0; --t) {',
         '  if (warp == 0) k7_diag(d, a, N, T - 1, wl);\n  for (int t = T - 1; t >= T; --t) {')],
    'K7: back substitution only': [
        ('  for (int p = 0; p < T; ++p) {\n    const int p0 = p * K7_NB, col = p0 + wl;',
         '  for (int p = 0; p < 0; ++p) {\n    const int p0 = p * K7_NB, col = p0 + wl;')],
}
SHAPES = [(543, 1), (543, 16)]


def build_all():
    """Writes and compiles every variant at once; returns {variant: library}."""
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
        out = os.path.join(kernels.BUILD_ROOT, 'probe_qr',
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
        for entry in ('qr_factor_cluster', 'qr_solve_batched'):
            getattr(lib, entry).argtypes = kernels.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def queued_ms(call, n=15):
    call()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def main():
    if not torch.cuda.is_available():
        print('qr_phases: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_all()
    g = torch.Generator(device='cpu').manual_seed(0)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for N, B in SHAPES:
        M = torch.randn(B, N, N, generator=g).cuda()
        v = torch.randn(B, N, generator=g).cuda()
        qr, tau = kernels.qr_factor_batched(M)
        out, tau_o, x = torch.empty_like(M), torch.empty_like(tau), torch.empty_like(v)
        fg, sg = kernels.qr_factor_geometry(N), kernels.qr_solve_geometry(N)
        kernels.qr_cluster_max_active(fg)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, lib in libs.items():
            def factor():
                err = lib.qr_factor_cluster(ptr(M), ptr(out), ptr(tau_o), B, N, fg.C,
                                            fg.cols_per_cta, fg.ld, fg.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')

            def solve():
                err = lib.qr_solve_batched(ptr(qr), ptr(tau), ptr(v), ptr(x), B, N, sg.warps,
                                           sg.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            call, what = (solve, 'K7') if name.startswith('K7') else (factor, 'K6')
            if name == 'whole':
                print(f'N={N:5d} B={B:4d} {"K7: whole":40s} {queued_ms(solve):.4f} ms', flush=True)
                name = 'K6: whole'
            print(f'N={N:5d} B={B:4d} {name:40s} {queued_ms(call):.4f} ms', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
