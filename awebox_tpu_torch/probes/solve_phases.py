#!/usr/bin/env python3
"""Where the LU solve kernel (K3, ``lu_solve_kernel`` in csrc/auglu.cu)
spends its time: builds copies of the kernel source with one phase cut out
(their results are wrong; they are timed only) and times each, queued behind
a device sleep, on one random factor per shape. Needs a CUDA card and nvcc.

    python3 awebox_tpu_torch/probes/solve_phases.py [--out FILE]

Prints one line per variant and shape and, with --out, writes them as JSON.
"""
import argparse
import ctypes
import json
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
    'no factor loads': [('  const int rows = min(K3_NB, N - ti * K3_NB);\n  const int cols',
                         '  return;\n  const int rows = min(K3_NB, N - ti * K3_NB);\n  const int cols')],
    'no pivots': [('  for (int c = warp; c < T; c += K3_WARPS) {',
                   '  for (int c = warp; c < 0; c += K3_WARPS) {'),
                  ('  if (warp == 0) {\n    for (int c = 0; c < T; ++c) {',
                   '  if (false) {\n    for (int c = 0; c < T; ++c) {')],
    'no diagonal solve': [('      if (fwd) {                      // unit lower',
                           '      if (N > 0) {} else if (fwd) {   // unit lower')],
    'no reciprocal': [('if (wl == k) yj *= rinv;', '')],
    'warp 0 alone': [('    } else if (warp + 1 < n) {', '    } else if (N < 0) {')],
    'no step barrier': [('    __syncthreads();                  // the tile\'s values are out',
                         '    __syncwarp();  //')],
    'no look-ahead update': [
        ('        for (int k = 0; k < K3_NB; ++k) {\n'
         '          acc[k & 3] = fmaf(-M[k], __shfl_sync(K3_FULL, yj, k), acc[k & 3]);\n'
         '        }', '')],
    'no other updates': [
        ('        for (int k = 0; k < K3_NB; ++k) acc[k & 3] = fmaf(-M[k], yt[k], acc[k & 3]);',
         '')],
    'no tile waits': [('asm volatile("cp.async.wait_group %0;\\n" ::"n"(SW - 1) : "memory");', ''),
                      ('asm volatile("cp.async.wait_group %0;\\n" ::"n"(SW - 2) : "memory");', '')],
}
SHAPES = [(128, 1), (543, 1), (543, 16), (543, 128), (1055, 2)]


def build_all():
    """Writes and compiles every variant at once (one nvcc each); returns
    {variant: the bound lu_solve_batched entry point}."""
    with open(kernels.SOURCE) as fh:
        source = fh.read()
    procs = {}
    for name, cuts in CUTS.items():
        src = source
        for old, new in cuts:
            if src.count(old) != 1:
                raise RuntimeError(f'{name}: the cut {old!r} does not occur once in {kernels.SOURCE}')
            src = src.replace(old, new)
        out = os.path.join(kernels.BUILD_ROOT, 'probe', name.replace(' ', '_'))
        os.makedirs(out, exist_ok=True)
        cu, so = os.path.join(out, 'auglu.cu'), os.path.join(out, 'libauglu.so')
        with open(cu, 'w') as fh:
            fh.write(src)
        procs[name] = (so, subprocess.Popen([kernels._nvcc()] + kernels.NVCC_FLAGS + ['-o', so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{log}')
        fn = ctypes.CDLL(so).lu_solve_batched
        fn.argtypes = kernels.SIGNATURES['lu_solve_batched']
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def queued_ms(call, n=25):
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
    ap = argparse.ArgumentParser()
    ap.add_argument('--out')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('solve_phases: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    fns = build_all()
    g = torch.Generator(device='cpu').manual_seed(0)
    rows = []
    for N, B in SHAPES:
        A = torch.randn(B, N, N, generator=g).cuda()
        lu, piv = torch.linalg.lu_factor(A)
        lu, piv = lu.contiguous(), piv.contiguous()
        kd = torch.rand(B, N, generator=g).cuda() + 0.5
        v = torch.randn(B, N, generator=g).cuda()
        x = torch.empty_like(v)
        geom = kernels.lu_solve_geometry(N)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (lu, piv, kd, v, x)]
        for name, fn in fns.items():
            def call():
                err = fn(*ptrs, B, N, geom.sw, geom.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            ms = queued_ms(call)
            rows.append(dict(variant=name, N=N, B=B, queued_ms=ms))
            print(f'N={N:5d} B={B:4d} {name:22s} {ms:.4f} ms', flush=True)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(dict(device=smi, rows=rows), fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
