#!/usr/bin/env python3
"""Where K5 (awebox_tpu_torch/csrc/auglu.cu: ruiz_cluster_kernel) spends its
time on the card, and how it compares with a parent tree's kernel.

Phase-cut copies of the source are compiled side by side (one nvcc each, all
at once) and timed queued behind a device sleep, at N=543, B = 1, 16 and 128
and N=1055, B = 2 and 16, on Gaussian lanes with rows over six decades. A cut
removes one phase; its results are wrong, its time says what the phase costs.
Each cut names the source text it replaces and fails loudly when the kernel
has changed under it. At each shape the probe also runs other layouts than
kernels.ruiz_geometry's (cluster sizes, rows held in shared memory, clusters
in flight), each held bit for bit against ruiz_scale_plain, with the
clusters of that layout that the card runs at once. With --parent, the
kernel of the tree at --parent (a parent commit unpacked with ``git archive``
into a directory that .gitignore lists) is timed in the same call, in turns
with this tree's (parent, this, this, parent), and max |M - M_parent| and
max |s - s_parent| are printed; then both at N=1055 for every B from 1 to 16
(the n_k=8 sweep's delta-ladder retries call K5 on 1-10 lanes):

    mkdir -p _archive/parent
    git archive <parent> awebox_tpu_torch tests/artifacts | tar -x -C _archive/parent
    python3 awebox_tpu_torch/probes/ruiz_phases.py --parent _archive/parent

Prints the card, ptxas's registers and spills of each kernel instance, then
one line per shape, layout or cut. Exits non-zero if any layout of this tree
differs from the plain version. Needs a CUDA card and nvcc; about two and a
half minutes.
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
from awebox_tpu_torch.parallel import kernels  # noqa: E402
from awebox_tpu_torch.probes.qr_phases import load_parent, queued_ms  # noqa: E402

# variant -> [(text in csrc/auglu.cu, replacement)]; every text must occur once
CUTS = {
    'whole': [],
    # the rows copied in and M written with whatever s holds
    'K5: load and write only': [
        ('    for (int sweep = 0; sweep < K5_SWEEPS; ++sweep, par ^= 1) {',
         '    for (int sweep = 0; sweep < 0; ++sweep, par ^= 1) {')],
    'K5: one sweep': [
        ('    for (int sweep = 0; sweep < K5_SWEEPS; ++sweep, par ^= 1) {',
         '    for (int sweep = 0; sweep < 1; ++sweep, par ^= 1) {')],
    # no cluster barrier and no gather after a sweep: a CTA reads its own s
    'K5: no exchange': [
        ('      k5_exchange(cluster, s_all, own, N, R);', '      __syncthreads();')],
    # the mbarrier completes without a copy: the resident rows are whatever
    # shared memory holds
    'K5: no copy': [
        ('      k5_bulk_load(rows, Kr - shift, 16u * (unsigned)((shift + cnt + 3) >> 2), &k5_mbar);',
         '      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(k5_saddr(&k5_mbar)) '
         ': "memory");')],
    # M is not stored (nor computed)
    'K5: no M write': [
        ('    k5_write<U>(res_rows, Mr, 0, nres, r0, s_all, N, warp, wl);', ''),
        ('    if (nreg > 0) k5_reg_write(kreg, nreg, rreg, r0, s_all, Mr, N, wl);', ''),
        ('    k5_write<U>(Kr, Mr, rend, nrows, r0, s_all, N, warp, wl);', '')],
    # no lane: the launch, the mbarrier's set-up and the last cluster barrier
    'K5: launch only': [
        ('  for (int lane = (int)blockIdx.x / C; lane < B; lane += clusters) {',
         '  for (int lane = (int)blockIdx.x / C; lane < 0; lane += clusters) {')],
}
SHAPES = ((543, 1), (543, 16), (543, 128), (1055, 2), (1055, 16))
# other layouts: (name, C, shared-memory cap a CTA, cap on the clusters in flight or None)
SLOTS = kernels.SMEM_PER_BLOCK
LAYOUTS = {
    543: (('C=8, 1 CTA an SM', 8, SLOTS, None),
          ('C=12', 12, SLOTS, None),
          ('C=16, the first 17 rows resident', 16, kernels.ruiz_smem(543, 34, 17) + kernels.RUIZ_STATIC_SMEM, None),
          ('C=16, no row resident', 16, kernels.ruiz_smem(543, 34, 0) + kernels.RUIZ_STATIC_SMEM, None),
          ('C=16, 8 clusters in flight', 16, SLOTS, 8)),
    1055: (('C=8', 8, SLOTS, None),
           ('C=16, 2 CTAs an SM', 16, SLOTS // 2 - 1024, None),
           ('C=16, 3 CTAs an SM', 16, SLOTS // 3 - 1024, None),
           ('C=16, no row resident', 16, kernels.ruiz_smem(1055, 66, 0) + kernels.RUIZ_STATIC_SMEM, None),
           ('C=16, no row resident, 64 clusters', 16, kernels.ruiz_smem(1055, 66, 0) + kernels.RUIZ_STATIC_SMEM, 64)),
}


def build_all():
    """Writes and compiles every variant at once; returns ({variant:
    library}, ptxas's lines for ruiz_cluster_kernel)."""
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
        out = os.path.join(kernels.BUILD_ROOT, 'probe_ruiz',
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
        if name == 'whole':
            ptxas += [f'{name}: {line}' for line in k5_ptxas(log)]
        lib = ctypes.CDLL(so)
        for entry in ('ruiz_scale', 'ruiz_cluster_occupancy'):
            getattr(lib, entry).argtypes = kernels.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def k5_ptxas(log):
    """ptxas's register, stack and spill lines of each instance of
    ruiz_cluster_kernel, each after its mangled name."""
    out, keep = [], False
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            keep = 'ruiz_cluster_kernel' in line
            if keep:
                out.append(line.split("'")[1] if "'" in line else line)
        elif keep and re.search(r'registers|stack frame', line):
            out.append(line.replace('ptxas info    :', '').strip())
    return out


def lanes(B, N, g):
    """Gaussian lanes with rows over six decades, f32 on the card."""
    K = torch.randn(B, N, N, generator=g) * 10.0 ** (6 * torch.rand(B, N, 1, generator=g) - 3)
    return K.cuda()


def same_bits(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def occupancy(lib, N, geom):
    count = ctypes.c_int(0)
    err = lib.ruiz_cluster_occupancy(N, geom.rows, geom.resident_rows, geom.C, geom.smem_bytes,
                                     ctypes.byref(count))
    if err:
        raise RuntimeError(f'ruiz_cluster_occupancy: CUDA error {err}')
    return count.value


def caller(lib, K, M, s, geom, clusters, name):
    B, N = K.shape[0], K.shape[1]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call():
        err = lib.ruiz_scale(ptr(K), ptr(M), ptr(s), B, N, geom.C, geom.rows, geom.resident_rows,
                             clusters, geom.smem_bytes, stream)
        if err:
            raise RuntimeError(f'{name}: CUDA error {err}')
    return call


def row(N, B, name, ms, extra=''):
    print(f'N={N:5d} B={B:4d} {name:48s} {ms:.4f} ms{extra}', flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--parent', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('ruiz_phases: no CUDA device', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, ptxas = build_all()
    for line in ptxas:
        print(f'ptxas {line}', flush=True)
    kernels.library()
    parent = load_parent(args.parent) if args.parent else None
    if parent is not None:
        parent.library()
    g = torch.Generator(device='cpu').manual_seed(0)
    failed = []
    for N, B in SHAPES:
        K = lanes(B, N, g)
        geom = kernels.ruiz_geometry(N)
        M_p, s_p = kernels.ruiz_scale_plain(K)
        M, s = kernels.ruiz_scale(K)
        torch.cuda.synchronize()
        ok = same_bits(M, M_p) and same_bits(s, s_p)
        failed += [] if ok else [(N, B, 'geometry')]
        line = (f'N={N:5d} B={B:4d} K5 {geom}: {kernels.ruiz_clusters(B, N, geom)} clusters '
                f'launched, {occupancy(libs["whole"], N, geom)} run at once; bit for bit with '
                f'the plain version: {ok}')
        if parent is not None:
            M_o, s_o = parent.ruiz_scale(K)
            torch.cuda.synchronize()
            line += (f'; max |M - M_parent| {float((M - M_o).abs().nan_to_num().max()):.3e}, '
                     f'max |s - s_parent| {float((s - s_o).abs().nan_to_num().max()):.3e}')
        print(line, flush=True)
        bound = (2 * K.numel() + B * N) * 4 / 3.35e12 * 1e3
        this = lambda: kernels.ruiz_scale(K)
        if parent is not None:
            before = lambda: parent.ruiz_scale(K)
            for name, call in (('K5: parent', before), ('K5: this tree', this),
                               ('K5: this tree', this), ('K5: parent', before)):
                row(N, B, name, queued_ms(call))
        else:
            row(N, B, 'K5: this tree', queued_ms(this))
        row(N, B, 'bound (K and M once, s; 3.35 TB/s)', bound)
        out_M, out_s = torch.empty_like(K), torch.empty_like(s)
        for name, C, cap, cap_clusters in LAYOUTS[N]:
            lay = kernels.ruiz_layout(N, C, cap)
            at_once = occupancy(libs['whole'], N, lay)
            clusters = min(B, at_once, lay.lanes_in_flight or B, cap_clusters or B)
            call = caller(libs['whole'], K, out_M, out_s, lay, clusters, name)
            call()
            torch.cuda.synchronize()
            ok = same_bits(out_M, M_p) and same_bits(out_s, s_p)
            failed += [] if ok else [(N, B, name)]
            row(N, B, f'K5 layout {name}', queued_ms(call),
                f'  ({lay.mode}, C={lay.C}, {lay.resident_rows}/{lay.rows} rows in shared memory, '
                f'{lay.register_rows} in registers, '
                f'{lay.smem_bytes} B; {clusters} clusters launched, {at_once} run at once; '
                f'bit for bit {ok})')
        launched = kernels.ruiz_clusters(B, N, geom)
        for name, lib in libs.items():
            if name != 'whole':
                row(N, B, name, queued_ms(caller(lib, K, out_M, out_s, geom, launched, name)))
    if parent is not None:
        for B in range(1, 17):
            K = lanes(B, 1055, g)
            M, s = kernels.ruiz_scale(K)
            M_o, s_o = parent.ruiz_scale(K)
            torch.cuda.synchronize()
            same = same_bits(M, M_o) and same_bits(s, s_o)
            failed += [] if same else [(1055, B, 'parent')]
            before, this = (lambda: parent.ruiz_scale(K)), (lambda: kernels.ruiz_scale(K))
            times = [queued_ms(call) for call in (before, this, this, before)]
            print(f'N= 1055 B={B:4d} K5 parent, this tree, this tree, parent: '
                  + ' / '.join(f'{t:.4f}' for t in times) + f' ms; M and s equal the '
                  f'parent\'s: {same}', flush=True)
        print(f'parent launches: {parent.LAUNCHES}', flush=True)
    if failed:
        print(f'ruiz_phases: differs from the plain version at {failed}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
