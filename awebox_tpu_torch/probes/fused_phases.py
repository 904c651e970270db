#!/usr/bin/env python3
"""Where K1 (newton_kkt: newton_rows_kernel, the cuBLAS product,
kkt_tiles_kernel) and K4 (ip_step_kernel) of csrc/auglu.cu spend their time:
builds copies of the kernel source with one phase cut out (their results
are wrong; they are timed only), then runs newton_kkt and ip_step through
each copy on the slice's systems (the bench configuration, B lanes from
tests/artifacts/bench_anchor_nk4_d3.npz) and reads each kernel's device time
per call from torch.profiler. Needs a CUDA card and nvcc.

    python3 awebox_tpu_torch/probes/fused_phases.py [--lanes 16] [--out FILE]

Prints one line per variant and, with --out, writes them as JSON.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
from awebox_tpu_torch.parallel import kernels  # noqa: E402


def section(src, start, end):
    """The text of csrc/auglu.cu from the line that holds ``start`` up to the
    one that holds ``end``: a cut edits only its kernel."""
    i = src.index(start)
    return i, src.index(end, i)


def edit(start, end, *pairs, regex=None):
    """A cut: replaces each (old, new) once (each old must occur once in the
    kernel between ``start`` and ``end``), or the regex (pattern, repl)."""
    def apply(src):
        i, j = section(src, start, end)
        body = src[i:j]
        for old, new in pairs:
            if body.count(old) != 1:
                raise RuntimeError(f'the cut {old!r} does not occur once')
            body = body.replace(old, new)
        if regex is not None:
            body, k = re.subn(regex[0], regex[1], body)
            if not k:
                raise RuntimeError(f'the cut {regex[0]!r} matches nothing')
        return src[:i] + body + src[j:]
    return apply


K4 = ('__global__ void __launch_bounds__(K4_THREADS)\nip_step_kernel', '// K5 ruiz_scale')
ROWS = ('newton_rows_kernel(NewtonPtrs p', '// Where phase 2 takes its entries')
TILES = ('kkt_tiles_kernel(Src src', '// K2 semantics')
# a result that keeps the cut kernel's remaining work alive
KEEP = 'if (ra == -7.0 && rz == -7.0 && err_d == -7.0) p.err_o[lane] = err_p;\n'
CUTS = {
    'whole': [],
    'K4: f64 divisions as products': [edit(*K4, regex=(r'\bdiv_rn\(', '__dmul_rn('))],
    'K4: ratios without division': [edit(
        'ftb_ratio(double val', '__global__',
        ('div_rn(__dmul_rn(-tau, val), dval)', '__dmul_rn(__dmul_rn(-tau, val), dval)'))],
    'K4: no JI dw': [edit(*K4, ('      acc = fma((double)fin32(J[j]), dw, acc);', ''))],
    'K4: vectors only': [edit(*K4, ('  // ds = -(cI + s) - JI dw, a warp per inequality row',
                                    '  ' + KEEP + '  return;\n  // ds'))],
    'K4: no updates': [edit(*K4, ('  const double alpha = nmin(ra, 1.0), alpha_z = nmin(rz, 1.0);',
                                  '  const double alpha = nmin(ra, 1.0), alpha_z = nmin(rz, 1.0);\n'
                                  '  if (alpha == -7.0 && alpha_z == -7.0) p.err_o[lane] = err_p;\n'
                                  '  return;'))],
    'K4: empty': [edit(*K4, ('  const double mu = p.mu[lane];', '  return;\n  const double mu = p.mu[lane];'))],
    'K1 rows: no stores of the row': [edit(*ROWS, ('        p.Araw[orow + j] = a;\n'
                                                    '        p.A64[orow + j] = (double)__fmul_rn('
                                                    '__double2float_rn(a), rn32);',
                                                    '        if (rn32 == -7.0f) p.A64[orow + j] = a;'))],
    'K1 tiles: 4 blocks per SM': [edit('constexpr int K1_MIN_BLOCKS', '\n',
                                 ('K1_MIN_BLOCKS = 8;', 'K1_MIN_BLOCKS = 4;'))],
    'K1 tiles: no blocks-per-SM bound': [edit('constexpr int K1_MIN_BLOCKS', '\n',
                                      ('K1_MIN_BLOCKS = 8;', 'K1_MIN_BLOCKS = 1;'))],
    'K1 tiles: 64 rows a tile': [edit('constexpr int K1_TROWS_TILE', '\n',
                                      ('K1_TROWS_TILE = 32;', 'K1_TROWS_TILE = 64;'))],
    'K1 tiles: 64 rows a tile, 4 blocks per SM': [
        edit('constexpr int K1_TROWS_TILE', '\n', ('K1_TROWS_TILE = 32;', 'K1_TROWS_TILE = 64;')),
        edit('constexpr int K1_MIN_BLOCKS', '\n', ('K1_MIN_BLOCKS = 8;', 'K1_MIN_BLOCKS = 4;'))],
    'K1 rows: empty': [edit(*ROWS, ('  const double mu = p.mu[lane];', '  return;\n  const double mu = p.mu[lane];'))],
    'K1 tiles: no Ks store': [edit(*TILES, ('      Kl[(size_t)i * N + j] = __fmul_rn(__fmul_rn(k[t], kdr[r]), kdj);',
                                            '      if (k[t] == -7.0f) Kl[(size_t)i * N + j] = kdr[r] * kdj;'))],
    'K1 tiles: no W64 store': [edit(*TILES, ('      if (i < n && j < n) src.w_out(lane, i, j, w[t]);',
                                             '      if (i < n && j < n && w[t] == -7.0f) src.w_out(lane, i, j, w[t]);'))],
    'K1 tiles: no A\'^T tile': [edit(*TILES, ('  if (i0 < n && j0 + K1_TILE > n) {', '  if (false) {'))],
    'K1 tiles: W0 entries not loaded': [edit(
        'struct FusedTiles {', '// ... or from the f32 W0',
        ('    if (i == j) return p.diag32[(size_t)lane * n + i];\n    const float h',
         '    return 1.0f;\n    const float h'))],
    'K1 tiles: A\' entries not loaded': [edit(
        'struct FusedTiles {', '// ... or from the f32 W0',
        ('    return a_prime(p, lane, r, c, n, n_eq, n_ineq);', '    return 1.0f;'))],
    'K1 tiles: stores only': [edit(
        'struct FusedTiles {', '// ... or from the f32 W0',
        ('    if (i == j) return p.diag32[(size_t)lane * n + i];\n    const float h',
         '    return 1.0f;\n    const float h'),
        ('    return a_prime(p, lane, r, c, n, n_eq, n_ineq);', '    return 1.0f;'),
        ('    return p.kd ? p.kd[(size_t)lane * (n + n_eq + n_ineq) + i] : 1.0f;',
         '    return 1.0f;'))],
    'K1 tiles: empty': [edit(*TILES, ('  const int N = n + m, TC = (N + K1_TILE - 1) / K1_TILE;',
                                      '  return;\n  const int N = n + m, TC = (N + K1_TILE - 1) / K1_TILE;'))],
}
NAMES = {'newton_rows_kernel': 'K1 rows', 'kkt_tiles_kernel<(anonymous namespace)::FusedTiles>': 'K1 tiles',
         'gemv': 'K1 product A^T nu', 'ip_step_kernel': 'K4'}


def build_all():
    """Writes and compiles every variant at once (one nvcc each); returns
    {variant: the loaded library, its entry points bound}."""
    with open(kernels.SOURCE) as fh:
        source = fh.read()
    procs = {}
    for name, cuts in CUTS.items():
        src = source
        for cut in cuts:
            src = cut(src)
        out = os.path.join(kernels.BUILD_ROOT, 'probe_fused', re.sub(r'\W+', '_', name))
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
        for entry, argtypes in kernels.SIGNATURES.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(call, runs):
    """Device time per call of each kernel call() launches, in us."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for key, label in NAMES.items():
            if key in ev.key and ev.self_device_time_total > 0:
                out[label] = out.get(label, 0.) + ev.self_device_time_total / runs
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--lanes', type=int, default=16)
    ap.add_argument('--runs', type=int, default=50)
    ap.add_argument('--out')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('fused_phases: no CUDA device', file=sys.stderr)
        return 2
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.parallel import batch
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_all()
    trial = Trial(bench_options(), 'fused_phases').build()
    anchor = dict(np.load(os.path.join(ROOT, 'tests', 'artifacts', 'bench_anchor_nk4_d3.npz')))
    state, P64, lbw, ubw, free, _ = wind_sweep_problem(trial, anchor, args.lanes, device='cuda')
    vals_fn, jac_fn, hess_fn = make_structured_derivs(trial.ocp)
    w, y, lam = state['w'], state['y'], state['lam']
    dv = tuple(vals_fn(w, y, lam, P64)) + tuple(J.float() for J in jac_fn(w, P64)) \
        + (hess_fn(w, y, lam, P64).float(),)
    sys_ = kernels.newton_kkt(state, dv, lbw, ubw, free, 1e-8, 1e-8)
    x, ok = batch._ladder_solve(sys_, free, free.numel(), 1e-8, 7, 100.)
    k1 = lambda: kernels.newton_kkt(state, dv, lbw, ubw, free, 1e-8, 1e-8)
    k4 = lambda: kernels.ip_step(x, ok, sys_['rn'], sys_['r1'], state, dv, lbw, ubw, free,
                                 0.99, 0.4, 1e-8)
    rows = []
    for name, lib in libs.items():
        kernels._lib = lib
        us = device_us(lambda: (k1(), k4()), args.runs)
        rows.append(dict(variant=name, device_us=us))
        print(f'{name:34s} ' + '  '.join(f'{k} {v:7.2f}' for k, v in sorted(us.items())) + ' us',
              flush=True)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(dict(device=smi, lanes=args.lanes, rows=rows), fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
