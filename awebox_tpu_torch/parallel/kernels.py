"""Wrappers of the hand-written CUDA kernels of the interior-point direction
(``awebox_tpu_torch/csrc/auglu.cu``), each beside its plain PyTorch version.

=====================  ===========================================  ==========
wrapper                replaces (awebox_tpu/parallel/batch.py)       dtype
=====================  ===========================================  ==========
kkt_assemble_scaled    K(delta) assembly + Jacobi scale, :333-336,   f32
                       :409-413
lu_factor_batched      jax.scipy.linalg.lu_factor, :414              f32
                       (cluster or unblocked variant, by N)
lu_solve_batched       ksolve = kd * lu_solve(kd * v), :416-418      f32
advance_state          _advance_state, :449-512                      f64
=====================  ===========================================  ==========

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel, and raises on anything the kernel does not
take; it never falls back. ``LAUNCHES`` counts kernel launches per wrapper.

The kernels live in one ``.cu`` file with a plain C interface, compiled with
``nvcc`` for ``sm_90a`` into ``awebox_tpu_torch/_build/<source hash>/`` at
first use and loaded with ``ctypes``; nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import torch

# lu_factor_batched counts every factor; lu_factor_cluster and
# lu_factor_unblocked say which of K2's two variants ran
LAUNCHES = {'kkt_assemble_scaled': 0, 'lu_factor_batched': 0,
            'lu_factor_cluster': 0, 'lu_factor_unblocked': 0,
            'lu_solve_batched': 0, 'advance_state': 0}

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, 'csrc', 'auglu.cu')
BUILD_ROOT = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# argument types of the C entry points of csrc/auglu.cu, in order; every
# entry point returns a CUDA error code as an int
SIGNATURES = {
    'kkt_assemble_scaled': [_P] * 7 + [_I] * 3 + [_P],
    'lu_factor_cluster_occupancy': [_I, _I, _P],
    'lu_factor_cluster': [_P, _P] + [_I] * 6 + [_P],
    'lu_factor_unblocked': [_P, _P, _I, _I, _P],
    'lu_solve_batched': [_P] * 5 + [_I] * 4 + [_P],
    'advance_state': [_P] * 26 + [_I] * 4 + [_D] * 3 + [_P],
}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to build '
                       'awebox_tpu_torch/csrc/auglu.cu')


def build_library(verbose: bool = False) -> str:
    """Compile the kernels if this source has not been built yet; returns
    the path of the shared library."""
    with open(SOURCE, 'rb') as fh:
        src = fh.read()
    key = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, key)
    lib_path = os.path.join(out_dir, 'libauglu.so')
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = lib_path + f'.{os.getpid()}.tmp'
        cmd = [_nvcc()] + NVCC_FLAGS + (['-Xptxas', '-v'] if verbose else []) \
            + ['-o', tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}\n{proc.stderr}')
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    return lib_path


def library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name, err):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with error {err}')


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(name, *tensors_and_dtypes):
    dev = None
    for t, dt in tensors_and_dtypes:
        if not t.is_cuda:
            raise ValueError(f'{name}: mixed CPU and CUDA tensors')
        if t.dtype != dt:
            raise TypeError(f'{name}: expected {dt}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f'{name}: tensors on different devices')


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# --- K1 ----------------------------------------------------------------------

def kkt_assemble_scaled_plain(W32, A32, Dr32, free32, delta):
    """Ks = kd K(delta) kd and kd, with
    K(delta) = [[W32 + delta diag(free), A32^T], [A32, -diag(Dr32)]] and
    kd = clip(1/sqrt(clip(|diag K|, 1e-8)), 0, 1e4) (|.| on the W block;
    the Dr block enters as is), all in f32 (batch.py:333-336, 409-413)."""
    B, n, _ = W32.shape
    d32 = delta.to(torch.float32)
    Wd = W32 + d32[:, None, None] * torch.diag_embed(free32.expand(B, n))
    K = torch.cat([torch.cat([Wd, A32.transpose(1, 2)], dim=2),
                   torch.cat([A32, -torch.diag_embed(Dr32)], dim=2)], dim=1)
    kdiag = torch.cat([torch.abs(torch.diagonal(Wd, dim1=1, dim2=2)), Dr32], dim=1)
    kd = torch.clamp(1.0 / torch.sqrt(torch.clamp(kdiag, min=1e-8)), 0., 1e4)
    return K * kd[:, :, None] * kd[:, None, :], kd


def kkt_assemble_scaled(W32, A32, Dr32, free32, delta):
    """(B,n,n), (B,m,n), (B,m) f32, (n,) f32, (B,) f64 -> Ks (B,N,N), kd (B,N)."""
    if not W32.is_cuda:
        return kkt_assemble_scaled_plain(W32, A32, Dr32, free32, delta)
    name = 'kkt_assemble_scaled'
    f32 = torch.float32
    _require(name, (W32, f32), (A32, f32), (Dr32, f32), (free32, f32),
             (delta, torch.float64))
    B, n, _ = W32.shape
    m = A32.shape[1]
    N = n + m
    if A32.shape != (B, m, n) or Dr32.shape != (B, m) or free32.shape != (n,) \
            or delta.shape != (B,):
        raise ValueError(f'{name}: inconsistent shapes')
    Ks = torch.empty(B, N, N, dtype=f32, device=W32.device)
    kd = torch.empty(B, N, dtype=f32, device=W32.device)
    _check(name, library().kkt_assemble_scaled(
        _ptr(W32), _ptr(A32), _ptr(Dr32), _ptr(free32), _ptr(delta),
        _ptr(Ks), _ptr(kd), B, n, m, _stream()))
    LAUNCHES[name] += 1
    return Ks, kd


# --- K2 ----------------------------------------------------------------------

def lu_factor_batched_plain(Ks):
    """Partial-pivot LU (LAPACK getrf semantics, 1-based int32 pivots); a
    singular factor is returned, not raised, so inf/NaN reach the solve."""
    lu, piv, _ = torch.linalg.lu_factor_ex(Ks)
    return lu, piv


LU_CLUSTER_MAX = 8          # CTAs per cluster (the portable limit, K2C_MAX_CLUSTER)
LU_NB = 16                  # panel width, compiled into the cluster kernel (K2C_NB)
SMEM_PER_BLOCK = 232_448    # shared memory one H100 block may use, bytes
LU_STATIC_SMEM = 1_024      # room for the kernel's static shared arrays (384 B)


class LUGeometry(NamedTuple):
    """How K2 lays one lane out: ``variant`` 'cluster' runs a cluster of
    ``C`` CTAs, each holding ``cols_per_cta`` whole columns (panels of
    ``nb`` dealt block-cyclically, leading dimension ``ld``) in
    ``smem_bytes`` of dynamic shared memory; 'unblocked' runs one block on
    the matrix in global memory (the other fields then describe that).
    This is the one place that computes the layout: the cluster kernel
    takes C, cols_per_cta, ld and smem_bytes as they are."""
    variant: str
    C: int
    nb: int
    cols_per_cta: int
    ld: int
    smem_bytes: int


def lu_factor_geometry(N: int) -> LUGeometry:
    """K2's variant and layout for N x N lanes: the cluster variant when a
    lane fits the shared memory of LU_CLUSTER_MAX CTAs, else unblocked."""
    panels = -(-N // LU_NB)
    C = min(LU_CLUSTER_MAX, panels)
    cols = -(-panels // C) * LU_NB
    ld = -(-N // 4) * 4           # float4 rows; not a multiple of the 32
    if ld % 32 == 0:              # banks, so a row across columns spreads
        ld += 4
    # f32: the CTA's columns, the current L panel and the CTA's U12 block
    smem = 4 * (cols * ld + LU_NB * ld + LU_NB * cols)
    if smem + LU_STATIC_SMEM > SMEM_PER_BLOCK:
        return LUGeometry('unblocked', 1, 1, N, N, 0)
    return LUGeometry('cluster', C, LU_NB, cols, ld, smem)


_max_clusters = {}


def lu_cluster_max_active(geom: LUGeometry) -> int:
    """Clusters of this geometry the card runs at once (asked once per
    geometry); raises if it cannot run one."""
    key = (geom.C, geom.smem_bytes)
    if key not in _max_clusters:
        count = ctypes.c_int(0)
        _check('lu_factor_cluster_occupancy', library().lu_factor_cluster_occupancy(
            geom.C, geom.smem_bytes, ctypes.byref(count)))
        if count.value < 1:
            raise RuntimeError(f'lu_factor_cluster: a cluster of {geom.C} CTAs with '
                               f'{geom.smem_bytes} B of shared memory each cannot be scheduled')
        _max_clusters[key] = count.value
    return _max_clusters[key]


def lu_factor_batched(Ks):
    """(B,N,N) f32 -> (lu, piv (B,N) int32). On CUDA the factorization
    overwrites Ks in place and returns it as lu; the variant is
    lu_factor_geometry(N)'s."""
    if not Ks.is_cuda:
        return lu_factor_batched_plain(Ks)
    name = 'lu_factor_batched'
    _require(name, (Ks, torch.float32))
    B, N, N2 = Ks.shape
    if N != N2:
        raise ValueError(f'{name}: square matrices expected')
    geom = lu_factor_geometry(N)
    piv = torch.empty(B, N, dtype=torch.int32, device=Ks.device)
    if geom.variant == 'cluster':
        lu_cluster_max_active(geom)
        _check(name, library().lu_factor_cluster(
            _ptr(Ks), _ptr(piv), B, N, geom.C, geom.cols_per_cta, geom.ld,
            geom.smem_bytes, _stream()))
    else:
        _check(name, library().lu_factor_unblocked(_ptr(Ks), _ptr(piv), B, N, _stream()))
    LAUNCHES[name] += 1
    LAUNCHES[f'lu_factor_{geom.variant}'] += 1
    return Ks, piv


# --- K3 ----------------------------------------------------------------------

def lu_solve_batched_plain(lu, piv, kd, v):
    """kd * lu_solve(lu, piv, kd * v), all f32 (batch.py:416-418)."""
    return kd * torch.linalg.lu_solve(lu, piv, (kd * v)[:, :, None])[:, :, 0]


SOLVE_NB = 32               # tile width, compiled into the solve kernel (K3_NB)
SOLVE_WARPS = 8             # warps per lane (K3_WARPS)
SOLVE_TILE = 1168           # f32 per ring slot: a 32-row tile in 16-byte blocks (K3_TILE)
SOLVE_RING = (5, 2)         # ring slots per warp the kernel is compiled for, deepest first


class SolveGeometry(NamedTuple):
    """How K3 lays one lane out in shared memory: each of the ``SOLVE_WARPS``
    warps streams its tiles through a ring of ``sw`` slots of ``SOLVE_TILE``
    f32, beside the lane's right-hand side and its pivot bookkeeping (four
    words per padded row); ``smem_bytes`` in all."""
    sw: int
    smem_bytes: int


def lu_solve_geometry(N: int) -> SolveGeometry:
    """K3's ring depth for N x N lanes: the deepest ring that fits one
    block's shared memory beside the N-long vectors."""
    rows = -(-N // SOLVE_NB) * SOLVE_NB
    for sw in SOLVE_RING:
        smem = 4 * SOLVE_WARPS * sw * SOLVE_TILE + 16 * rows
        if smem + LU_STATIC_SMEM <= SMEM_PER_BLOCK:
            return SolveGeometry(sw, smem)
    raise ValueError(f'lu_solve_batched: N={N} leaves no room for the tile ring')


def lu_solve_batched(lu, piv, kd, v):
    """(B,N,N) f32, (B,N) int32, (B,N) f32, (B,N) f32 -> (B,N) f32."""
    if not lu.is_cuda:
        return lu_solve_batched_plain(lu, piv, kd, v)
    name = 'lu_solve_batched'
    f32 = torch.float32
    _require(name, (lu, f32), (piv, torch.int32), (kd, f32), (v, f32))
    B, N, _ = lu.shape
    if piv.shape != (B, N) or kd.shape != (B, N) or v.shape != (B, N):
        raise ValueError(f'{name}: inconsistent shapes')
    geom = lu_solve_geometry(N)
    x = torch.empty(B, N, dtype=f32, device=lu.device)
    _check(name, library().lu_solve_batched(
        _ptr(lu), _ptr(piv), _ptr(kd), _ptr(v), _ptr(x), B, N, geom.sw,
        geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return x


# --- K4 ----------------------------------------------------------------------

STATE_KEYS = ('w', 's', 'y', 'lam', 'zl', 'zu')


def advance_state_plain(state, direction, ok, err_d, err_kkt, lbw, ubw,
                        tau, kappa_mu, mu_min):
    """Fraction-to-boundary step + dual safeguards + adaptive mu, batched
    over lanes (batch.py:449-512); ``err`` of the result is ``err_kkt``."""
    w, s, y, lam = state['w'], state['s'], state['y'], state['lam']
    zl, zu, mu = state['zl'], state['zu'], state['mu']
    dw, dy, dlam, ds, dzl, dzu = direction
    lam_safe = torch.clamp(lam, min=1e-12)
    dl = torch.clamp(w - lbw, min=1e-20)
    du = torch.clamp(ubw - w, min=1e-20)

    def ftb(val, dval):
        neg = dval < 0
        ratios = torch.where(neg, -tau * val / torch.where(neg, dval, -1.),
                             torch.inf)
        one = torch.ones_like(ratios[:, :1])
        return torch.clamp(torch.cat([one, ratios], dim=1).amin(dim=1), max=1.0)

    alpha = torch.minimum(ftb(dl, dw), ftb(du, -dw))
    alpha = torch.minimum(alpha, ftb(s, ds))
    alpha_z = torch.minimum(ftb(torch.clamp(zl, min=1e-300), dzl),
                            ftb(torch.clamp(zu, min=1e-300), dzu))
    alpha_z = torch.minimum(alpha_z, ftb(lam_safe, dlam))
    a, az = alpha[:, None], alpha_z[:, None]

    w = w + a * dw
    y = torch.clamp(y + a * dy, -1e10, 1e10)
    lam = torch.clamp(lam + az * dlam, 1e-16, 1e10)
    s = torch.clamp(s + a * ds, min=1e-16)
    fin_l, fin_u = torch.isfinite(lbw), torch.isfinite(ubw)
    zl = torch.where(fin_l, zl + az * dzl, 0.)
    zu = torch.where(fin_u, zu + az * dzu, 0.)
    # IPOPT's kappa_sigma corridor keeps bound duals consistent with the
    # barrier, preventing z blow-ups from poisoning sigma next iteration
    dl = torch.clamp(w - lbw, min=1e-20)
    du = torch.clamp(ubw - w, min=1e-20)
    kappa_sigma = 1e10
    m = mu[:, None]
    zl = torch.minimum(torch.maximum(zl, m / (kappa_sigma * dl)), kappa_sigma * m / dl)
    zu = torch.minimum(torch.maximum(zu, m / (kappa_sigma * du)), kappa_sigma * m / du)
    zl = torch.where(fin_l, zl, 0.)
    zu = torch.where(fin_u, zu, 0.)

    mu_new = torch.clamp(torch.minimum(kappa_mu * mu, 0.1 * err_d), min=mu_min)
    mu_new = torch.where(ok, mu_new, mu)
    return dict(w=w, s=s, y=y, lam=lam, zl=zl, zu=zu, mu=mu_new, err=err_kkt)


def advance_state(state, direction, ok, err_d, err_kkt, lbw, ubw,
                  tau, kappa_mu, mu_min):
    """state: dict of (B, .) f64 tensors (w, s, y, lam, zl, zu) and mu (B,);
    direction: (dw, dy, dlam, ds, dzl, dzu); ok (B,) bool; err_d, err_kkt
    (B,) f64; lbw, ubw (n,) f64. Returns the new state dict (with err)."""
    if not state['w'].is_cuda:
        return advance_state_plain(state, direction, ok, err_d, err_kkt,
                                   lbw, ubw, tau, kappa_mu, mu_min)
    name = 'advance_state'
    f64 = torch.float64
    ins = [state[k] for k in STATE_KEYS] + [state['mu']] + list(direction)
    _require(name, *[(t, f64) for t in ins + [err_d, err_kkt, lbw, ubw]],
             (ok, torch.bool))
    B, n = state['w'].shape
    n_eq = state['y'].shape[1]
    n_ineq = state['s'].shape[1]
    if n_ineq == 0:
        raise ValueError(f'{name}: problems without inequalities are not supported')
    like = [state[k] for k in ('w', 'y', 'lam', 's', 'zl', 'zu')]
    if state['lam'].shape != (B, n_ineq) or any(
            t.shape != (B, k) for t, k in ((state['zl'], n), (state['zu'], n))) \
            or any(d.shape != s.shape for d, s in zip(direction, like)) \
            or any(t.shape != (B,) for t in (state['mu'], ok, err_d, err_kkt)) \
            or lbw.shape != (n,) or ubw.shape != (n,):
        raise ValueError(f'{name}: inconsistent shapes')
    out = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    out['mu'] = torch.empty_like(state['mu'])
    out['err'] = torch.empty_like(err_kkt)
    outs = [out[k] for k in STATE_KEYS] + [out['mu'], out['err']]
    _check(name, library().advance_state(
        *[_ptr(t) for t in ins], _ptr(ok), _ptr(err_d), _ptr(err_kkt),
        _ptr(lbw), _ptr(ubw), *[_ptr(t) for t in outs],
        B, n, n_eq, n_ineq, float(tau), float(kappa_mu), float(mu_min),
        _stream()))
    LAUNCHES[name] += 1
    return out
