#!/usr/bin/env python3
"""Where K6's cluster variant and K7 (awebox_tpu_torch/csrc/auglu.cu:
qr_factor_cluster_kernel, qr_solve_kernel) spend their time on the card:
phase-cut copies of the source are compiled side by side (one nvcc each, all
at once) and timed queued behind a device sleep on Gaussian lanes: K6 at
N=543, B = 1, 16 and 128; K7 there and at N=1055, B = 2 and 16, also at
each (warps, tiles a staging slot) it is compiled for that fits N. A cut removes one
phase; its results are wrong, its time says what the phase costs. Each cut
names the source text it replaces and fails loudly when the kernel has
changed under it. --kernel k6 or k7 builds and times one of the two. With
--parent, the same kernels of the tree at --parent (a parent commit
unpacked with ``git archive`` into a directory that .gitignore lists) are
timed in the same call, in turns with this tree's (parent, this, this,
parent), and K7 prints max |x - x_parent| on the same factor and right-hand
side:

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/qr_phases.py --parent _archive/parent

Prints the card, the registers of the kernels (nvcc -Xptxas -v), the
clusters of K6's geometry that run at once for each cluster size that fits
N=543, whether this tree's factor holds geqrf's |diag R| and solve residual,
then one line per shape and variant. Needs a CUDA card and nvcc; takes
about three minutes (--kernel k7: about two).
"""
import argparse
import ctypes
import importlib.util
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
from awebox_tpu_torch.parallel import kernels  # noqa: E402

K6_W_PASS = [
    ('        x[4 * c] = fmaf(v.x, a[t], x[4 * c]);', ''),
    ('        x[4 * c + 1] = fmaf(v.y, a[t], x[4 * c + 1]);', ''),
    ('        x[4 * c + 2] = fmaf(v.z, a[t], x[4 * c + 2]);', ''),
    ('        x[4 * c + 3] = fmaf(v.w, a[t], x[4 * c + 3]);', '')]
K6_UPDATE = [
    ('        a[t] = fmaf(-x[4 * c], v.x, a[t]);', ''),
    ('        a[t] = fmaf(-x[4 * c + 1], v.y, a[t]);', ''),
    ('        a[t] = fmaf(-x[4 * c + 2], v.z, a[t]);', ''),
    ('        a[t] = fmaf(-x[4 * c + 3], v.w, a[t]);', '')]
# variant -> [(text in csrc/auglu.cu, replacement)]; every text must occur once
CUTS = {
    'whole': [],
    'K6: no panel factor': [
        ('  for (int k = 0; k < w; ++k) {\n    const int gk = g0 + k;\n    if (warp == k) {',
         '  for (int k = 0; k < 0; ++k) {\n    const int gk = g0 + k;\n    if (warp == k) {')],
    'K6: no G and T': [
        ('  if (warp < w) {\n    const int gk = g0 + warp;\n    float g[K6_NB];',
         '  if (w < 0) {\n    const int gk = g0 + warp;\n    float g[K6_NB];'),
        ('  if (warp == 0 && wl < K6_NB) {        // lane i: row i of T',
         '  if (w < 0) {        // lane i: row i of T')],
    'K6: no W pass': K6_W_PASS,
    'K6: no update': K6_UPDATE,
    'K6: no panel copy': [
        ('          d4[k6_vs_chunk(r, c)] = make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], '
         'v[4 * c + 3]);', '')],
    # the owner of panel p + 1 updates all its trailing columns, then factors
    'K6: look-ahead off': [
        ('      k6_factor<T0>(L.As + (size_t)c0 * ld, ld, p0, p0 + K6_NB, w1, N, L.Vs, L.Tl, L.Tp, '
         'L.tl);\n      done = K6_NB;',
         '      k6_update<T0>(L.As + (size_t)c0 * ld, ld, ntc, L.Vs, L.Tl, p0, N);\n'
         '      __syncthreads();\n'
         '      k6_factor<T0>(L.As + (size_t)c0 * ld, ld, p0 + K6_NB, p0 + K6_NB, w1, N, nullptr, '
         'nullptr, L.Tp, L.tl);\n      done = ntc;')],
    'K7: no Gram matrix': [
        ('              g[4 * q] = fmaf(va, u.x, g[4 * q]);', ''),
        ('              g[4 * q + 1] = fmaf(va, u.y, g[4 * q + 1]);', ''),
        ('              g[4 * q + 2] = fmaf(va, u.z, g[4 * q + 2]);', ''),
        ('              g[4 * q + 3] = fmaf(va, u.w, g[4 * q + 3]);', '')],
    # Q^T's y -= V t left out
    'K7: no y update': [
        ('      y[p0 + warp + WARPS * i] -= k7_dot32(sV + (size_t)i * K7_LDV, t_s);', '')],
    # Q^T's copies only zero-fill the slots: no read of the factor there
    'K7: no staging loads': [
        ('          cp_async16_zfill(slot + dst[q], g0 + src[q], (in[q] & need_q) == need_q);',
         '          cp_async16_zfill(slot + dst[q], g0 + src[q], false);')],
    # no copy issued in Q^T at all (the groups are still committed)
    'K7: no copies': [
        ('          cp_async16_zfill(slot + dst[q], g0 + src[q], (in[q] & need_q) == need_q);', '')],
    'K7: no slot waits': [
        ('  __device__ __forceinline__ const float* take() {\n'
         '    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");',
         '  __device__ __forceinline__ const float* take() {')],
    # Q^T's rows read from the slots but not stored realigned into sV
    'K7: no realign': [
        ('          for (int j = 0; j < RPW; ++j) sw[(h * RPW + j) * K7_LDV + wl] = vr[h][j];', '')],
    'K7: no forward substitution': [
        ('        if (wl > j) wc = fmaf(-g[j], tj, wc);', '')],
    # no R x = y: its rings are not started either
    'K7: reflectors only': [
        ('  back.start(T, wl);\n  for (int t = T - 1; t >= 0; --t) {',
         '  for (int t = T - 1; t >= T; --t) {')],
    'K7: back substitution only': [
        ('  for (int p = 0; p < T; ++p) {\n    const int p0 = p * K7_NB, col = p0 + wl;',
         '  for (int p = 0; p < 0; ++p) {\n    const int p0 = p * K7_NB, col = p0 + wl;')],
    # R x = y's rings copy nothing (its tiles are whatever the slots hold)
    'K7: no back copies': [
        ('      k3_load(slot, blocks, a, N, i, c);', '')],
    'K7: no back waits': [
        ('    asm volatile("cp.async.wait_group %0;\\n" ::"n"(K7_BACK_SLOTS - 1) : "memory");', '')],
    # the diagonal tile applied without its 32-step shuffle chain
    'K7: no diagonal chain': [
        ('      for (int k = K7_NB - 1; k >= 0; --k) {\n        if (wl == k) yj *= dinv;',
         '      for (int k = K7_NB - 1; k >= K7_NB; --k) {\n        if (wl == k) yj *= dinv;')],
    # warps 1.. apply no column tile
    'K7: no back update': [
        ('        y[i * K7_NB + wl] -= k7_dot32_any(k3_row(slot, a, N, i, t + 1, wl), y + r0 + K7_NB);',
         '')],
}
N_PROBE = 543
BATCHES = (1, 16, 128)
K7_SHAPES = ((543, 1), (543, 16), (543, 128), (1055, 2), (1055, 16))


def build_all(kernel):
    """Writes and compiles every variant of the kernels asked for ('k6',
    'k7' or 'both') at once; returns ({variant: library}, ptxas's lines for
    the kernel each variant cuts: K7's or K6's)."""
    with open(kernels.SOURCE) as fh:
        source = fh.read()
    procs = {}
    for name, cuts in CUTS.items():
        if name != 'whole' and kernel != 'both' and not name.startswith(kernel.upper()):
            continue
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
        procs[name] = (so, subprocess.Popen(
            [kernels._nvcc()] + kernels.NVCC_FLAGS + ['-Xptxas', '-v', '-o', so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, []
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'{name}: nvcc failed\n{log}')
        for k7 in ((False, True) if name == 'whole' else (name.startswith('K7'),)):
            if kernel == 'both' or k7 == (kernel == 'k7'):
                ptxas += [f'{name}: {line}' for line in k6_k7_ptxas(log, k7)]
        lib = ctypes.CDLL(so)
        for entry in ('qr_factor_cluster', 'qr_factor_cluster_occupancy', 'qr_solve_batched'):
            getattr(lib, entry).argtypes = kernels.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def k6_k7_ptxas(log, k7):
    """ptxas's register, stack and spill lines of each instance of
    qr_solve_kernel (k7) or of qr_factor_cluster_kernel, each after its
    mangled name."""
    out, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = ('qr_solve_kernel' if k7 else 'qr_factor_cluster_kernel') in line
            if keep:
                out.append(line.split("'")[1] if "'" in line else line)
        elif keep and re.search(r'registers|stack frame', line):
            out.append(line.replace('ptxas info    :', '').strip())
    return out


def load_parent(root):
    """The kernels module of the tree at root, under a name of its own."""
    path = os.path.join(os.path.abspath(root), 'awebox_tpu_torch', 'parallel', 'kernels.py')
    spec = importlib.util.spec_from_file_location('parent_kernels', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def residual(M, v, x):
    """max over lanes of |M x - v| / |v| (inf norms), in f64."""
    r = (M.double() @ x.double()[:, :, None])[:, :, 0] - v.double()
    return float((r.abs().amax(dim=1) / v.double().abs().amax(dim=1)).max())


def hold(M, v):
    """This tree's cluster factor against geqrf: max ||diag R| - |diag R_geqrf||
    over max |diag R_geqrf|, and the K7 solve's residual over the library's."""
    qr, tau = kernels.qr_factor_batched(M)
    qr_p, tau_p = (t.contiguous() for t in kernels.qr_factor_batched_plain(M))
    dk = torch.diagonal(qr, dim1=1, dim2=2).abs()
    dp = torch.diagonal(qr_p, dim1=1, dim2=2).abs()
    x = kernels.qr_solve_batched(qr, tau, v)
    x_lib = kernels.qr_solve_batched_plain(qr_p, tau_p, v)
    return (float((dk - dp).abs().max()) / float(dp.max()), residual(M, v, x),
            residual(M, v, x_lib), bool(torch.isfinite(qr).all()))


def row(N, B, name, ms):
    print(f'N={N:5d} B={B:4d} {name:40s} {ms:.4f} ms', flush=True)


def k6_rows(libs, parent, g):
    """K6's cluster factor at N_PROBE: occupancy, the geqrf check, and its
    cuts (and the parent's factor in turns) at each of BATCHES."""
    N = N_PROBE
    fg = kernels.qr_factor_geometry(N)
    for C in range(2, kernels.LU_CLUSTER_MAX + 1):
        geom = kernels.qr_cluster_layout(N, C)
        if geom is None:
            continue
        count = ctypes.c_int(0)
        err = libs['whole'].qr_factor_cluster_occupancy(C, geom.smem_bytes, ctypes.byref(count))
        print(f'N={N} C={C}: {geom.cols_per_cta} columns and {geom.smem_bytes} B a CTA; '
              f'{count.value} clusters run at once (error {err})', flush=True)
    print(f'N={N}: the geometry takes C={fg.C}: {fg}', flush=True)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for B in BATCHES:
        M = torch.randn(B, N, N, generator=g).cuda()
        v = torch.randn(B, N, generator=g).cuda()
        diag, res, res_lib, finite = hold(M, v)
        print(f'N={N:5d} B={B:4d} K6 cluster vs geqrf: |diag R| off by {diag:.3e} of its max, '
              f'solve residual {res:.3e} (library {res_lib:.3e}), finite {finite}', flush=True)
        out, tau_o = torch.empty_like(M), torch.empty(B, N, device=M.device)
        kernels.cluster_max_active('qr_factor_cluster', fg)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if parent is not None:
            this = lambda: kernels.qr_factor_batched(M)
            before = lambda: parent.qr_factor_batched(M)
            for name, call in (('K6: parent', before), ('K6: this tree', this),
                               ('K6: this tree', this), ('K6: parent', before)):
                row(N, B, name, queued_ms(call))
        for name, lib in libs.items():
            if name.startswith('K7'):
                continue

            def factor():
                err = lib.qr_factor_cluster(ptr(M), ptr(out), ptr(tau_o), B, N, fg.C,
                                            fg.cols_per_cta, fg.ld, fg.smem_bytes, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            row(N, B, 'K6: whole' if name == 'whole' else name, queued_ms(factor))


def k7_rows(libs, parent, g):
    """K7 at each of K7_SHAPES on this tree's factor of Gaussian lanes: its
    residual beside the library's; with a parent, max |x - x_parent| and the
    two kernels in turns; then every compiled layout that fits N and the
    cuts, each on the geometry's layout."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for N, B in K7_SHAPES:
        sg = kernels.qr_solve_geometry(N)
        M = torch.randn(B, N, N, generator=g).cuda()
        v = torch.randn(B, N, generator=g).cuda()
        qr, tau = kernels.qr_factor_batched(M)
        x = kernels.qr_solve_batched(qr, tau, v)
        qr_p, tau_p = (t.contiguous() for t in kernels.qr_factor_batched_plain(M))
        x_lib = kernels.qr_solve_batched_plain(qr_p, tau_p, v)
        line = (f'N={N:5d} B={B:4d} K7 {sg}: residual {residual(M, v, x):.3e} (library '
                f'{residual(M, v, x_lib):.3e}), finite {bool(torch.isfinite(x).all())}')
        if parent is not None:
            x_parent = parent.qr_solve_batched(qr, tau, v)
            line += (f'; max |x - x_parent| {float((x - x_parent).abs().max()):.3e}, parent '
                     f'{parent.qr_solve_geometry(N)}')
        print(line, flush=True)
        if parent is not None:
            this = lambda: kernels.qr_solve_batched(qr, tau, v)
            before = lambda: parent.qr_solve_batched(qr, tau, v)
            for name, call in (('K7: parent', before), ('K7: this tree', this),
                               ('K7: this tree', this), ('K7: parent', before)):
                row(N, B, name, queued_ms(call))
        out = torch.empty_like(v)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def solve(lib, layout, name):
            smem = kernels.qr_solve_smem(N, *layout)

            def call():
                err = lib.qr_solve_batched(ptr(qr), ptr(tau), ptr(v), ptr(out), B, N, *layout,
                                           smem, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            return call
        for layout in kernels.QR_SOLVE_LAYOUTS:
            smem = kernels.qr_solve_smem(N, *layout)
            if smem + kernels.QR_SOLVE_STATIC_SMEM > kernels.SMEM_PER_BLOCK:
                continue
            ms = queued_ms(solve(libs['whole'], layout, 'layout'))
            same = torch.equal(out, x) if layout[0] == sg.warps else None
            row(N, B, 'K7: {} warps, {} tiles a slot'.format(*layout)
                + ('' if same is None else f' (x {"equal" if same else "DIFFERS"})'), ms)
        for name, lib in libs.items():
            if name.startswith('K7'):
                row(N, B, name, queued_ms(solve(lib, (sg.warps, sg.group), name)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    ap.add_argument('--kernel', choices=('k6', 'k7', 'both'), default='both')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('qr_phases: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, ptxas = build_all(args.kernel)
    for line in ptxas:
        print(f'ptxas: {line}', flush=True)
    parent = load_parent(args.parent) if args.parent else None
    if parent is not None:
        parent.library()
    g = torch.Generator(device='cpu').manual_seed(0)
    if args.kernel in ('k6', 'both'):
        k6_rows(libs, parent, g)
    if args.kernel in ('k7', 'both'):
        k7_rows(libs, parent, g)
    if parent is not None:
        print(f'parent launches: {parent.LAUNCHES}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
