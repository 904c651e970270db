"""Wrappers of the hand-written CUDA kernels of the interior-point direction
(``awebox_tpu_torch/csrc/auglu.cu``), each beside its plain PyTorch version.

=====================  ===========================================  ==========
wrapper                replaces (awebox_tpu/parallel/batch.py)       dtype
=====================  ===========================================  ==========
newton_kkt             the Newton system, row equilibration and      f64 -> f32
                       K(delta_w) + Jacobi scale, :154-180,
                       :320-336, :409-413
kkt_assemble_scaled    K(delta) + Jacobi scale of the lanes a        f32
                       ladder retry assembles, :409-413
lu_factor_batched      jax.scipy.linalg.lu_factor, :414              f32
                       (cluster or blocked variant, by N)
lu_solve_batched       ksolve = kd * lu_solve(kd * v), :416-418      f32
ip_step                the direction from the solution and           f64
                       _advance_state, :189-198, :449-512
kkt_assemble           the unscaled K(delta) of the QR factor,       f32
                       :333-336 (newton_kkt with scaled=False
                       builds it with the Newton system)
ruiz_scale             three Ruiz sweeps M = s K s, :375-381         f32
                       (one launch, a thread-block cluster a lane)
qr_factor_batched      jnp.linalg.qr, :382, as packed Householder    f32
                       reflectors (cluster or blocked variant, by N)
qr_solve_batched       msolve = R^-1 Q^T v, :344-346                 f32
advance_state          _advance_state, :449-512, from a direction    f64
                       (the step half of ip_step's kernel)
chol_factor_batched    jnp.linalg.cholesky of the condensed M,       f64
                       :215-231 (cluster or stream variant, by n)
chol_solve_batched     msolve = two solve_triangular, :234-236       f64
block_factor           the two-level factor of ocp/blockkkt.py,      f64
                       :539-588 (interior Cholesky, coupling solve,
                       Schur sums, Cholesky of the reduced system;
                       a thread-block cluster a lane)
block_solve            block_solve of ocp/blockkkt.py, :646-679      f64
                       (a thread-block cluster a lane)
=====================  ===========================================  ==========

and those of the host solver's dense direction (``opti/ipsolver.py``
kkt_solve, behind ``Trial.optimize``; ``chol_factor_batched`` is its
inertia test at B = 1):

=====================  ===========================================  ==========
wrapper                replaces (awebox_tpu/opti/ipsolver.py)       dtype
=====================  ===========================================  ==========
lu_factor_f64          jax.scipy.linalg.lu_factor of the augmented  f64
                       KKT matrix, :194 (a thread-block cluster a
                       lane)
lu_solve_f64           jax.scipy.linalg.lu_solve, :195, :197         f64
                       (a thread-block cluster a lane)
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
import itertools
import os
import shutil
import subprocess
import threading
from typing import NamedTuple, Optional

import torch

# newton_kkt counts its kernel pair once; lu_factor_batched counts every
# factor, lu_factor_cluster and lu_factor_blocked say which of K2's two
# variants ran (a blocked factor's launches a panel are counted once);
# likewise qr_factor_batched with qr_factor_cluster and qr_factor_blocked,
# and chol_factor_batched with chol_factor_cluster and chol_factor_stream
LAUNCHES = {'newton_kkt': 0, 'kkt_assemble_scaled': 0, 'lu_factor_batched': 0,
            'lu_factor_cluster': 0, 'lu_factor_blocked': 0,
            'lu_solve_batched': 0, 'ip_step': 0,
            'kkt_assemble': 0, 'ruiz_scale': 0, 'qr_factor_batched': 0,
            'qr_factor_cluster': 0, 'qr_factor_blocked': 0, 'qr_solve_batched': 0,
            'advance_state': 0, 'chol_factor_batched': 0, 'chol_factor_cluster': 0,
            'chol_factor_stream': 0, 'chol_solve_batched': 0,
            'block_factor': 0, 'block_solve': 0, 'lu_factor_f64': 0, 'lu_solve_f64': 0}

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
    'newton_rows': [_P] + [_I] * 4 + [_D] * 2 + [_P],
    'newton_tiles': [_P] + [_I] * 4 + [_D] + [_P],
    'kkt_assemble_scaled': [_P] * 7 + [_I] * 3 + [_P],
    'lu_factor_cluster_occupancy': [_I, _I, _P],
    'lu_factor_cluster': [_P, _P] + [_I] * 6 + [_P],
    'lu_factor_blocked': [_P, _P] + [_I] * 4 + [_P],
    'lu_solve_batched': [_P] * 5 + [_I] * 4 + [_P],
    'ip_step': [_P] + [_I] * 4 + [_D] * 3 + [_P],
    'ruiz_cluster_occupancy': [_I] * 5 + [_P],
    'ruiz_scale': [_P] * 3 + [_I] * 7 + [_P],
    'qr_factor_cluster_occupancy': [_I, _I, _P],
    'qr_factor_cluster': [_P] * 3 + [_I] * 6 + [_P],
    'qr_factor_blocked': [_P] * 5 + [_I] * 4 + [_P],
    'qr_solve_batched': [_P] * 4 + [_I] * 5 + [_P],
    'advance_state': [_P] + [_I] * 4 + [_D] * 3 + [_P],
    'chol_factor_cluster_occupancy': [_I, _I, _P],
    'chol_factor_cluster': [_P] * 3 + [_I] * 6 + [_P],
    'chol_factor_stream_occupancy': [_I, _I, _P],
    'chol_factor_stream': [_P] * 3 + [_I] * 6 + [_P],
    'chol_solve_batched': [_P] * 3 + [_I] * 3 + [_P],
    'block_factor': [_P] * 7 + [_I] * 9 + [_P],
    'block_solve_occupancy': [_I, _I, _P],
    'block_solve': [_P] * 8 + [_I] * 8 + [_P],
    'lu_factor_f64_occupancy': [_I, _I, _P],
    'lu_factor_f64': [_P] * 4 + [_I] * 4 + [_P],
    'lu_solve_f64_occupancy': [_I, _I, _P],
    'lu_solve_f64': [_P] * 4 + [_I] * 4 + [_P],
    'noop': [_I, _P],
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

def fin(x):
    """Non-finite entries to 0: derivatives of an iterate that escaped the
    model's domain must not poison the linear algebra (the ladder then
    produces a heavily damped, near-gradient step)."""
    return torch.where(torch.isfinite(x), x, 0.)


def newton_system(state, derivs_out, lbw, ubw, free, delta_c=1e-8):
    """The barrier-Newton system of one iteration (batch.py:146-180): the
    sanitized derivatives, W0 = H + diag(sigma) masked by free, A = [JE; JI]
    masked by free, the dual regularization D and the right-hand sides
    r1, r2. Everything f64 except JE/JI/H as given."""
    w, s, y, lam = state['w'], state['s'], state['y'], state['lam']
    zl, zu, mu = state['zl'], state['zu'], state['mu']
    f64 = w.dtype
    m_ = mu[:, None]

    fval, gradf, cE, cI, JE, JI, H = derivs_out
    gradf, cE, cI = fin(gradf), fin(cE), fin(cI)
    JE, JI, H = fin(JE), fin(JI), fin(H)

    dl = torch.clamp(w - lbw, min=1e-20)
    du = torch.clamp(ubw - w, min=1e-20)
    sigma = torch.clamp(zl / dl + zu / du, 0., 1e16)
    W0 = H.to(f64) + torch.diag_embed(sigma)
    W0 = W0 * (free[:, None] * free[None, :]) + torch.diag(1. - free)

    A = torch.cat([JE, JI], dim=1).to(f64) * free[None, :]
    lam_safe = torch.clamp(lam, min=1e-12)
    D = torch.cat([torch.full_like(y, delta_c), s / lam_safe + delta_c], dim=1)
    r2 = torch.cat([cE, cI + m_ / lam_safe], dim=1)
    nu = torch.cat([y, lam], dim=1)
    r1 = -(gradf + (A.transpose(1, 2) @ nu[:, :, None])[:, :, 0]
           - m_ / dl + m_ / du) * free
    return dict(W0=W0, A=A, D=D, r1=r1, r2=r2, cE=cE, cI=cI, JI=JI,
                dl=dl, du=du)


def equilibrate(W0, A, D, r1, r2, free, delta_ce):
    """Row equilibration A' = R A and the f32 pieces of K(delta)
    (batch.py:314-331): returns rn, W32, A32, Dr32, free32 and the f64
    right-hand side b and regularized D."""
    fdt, rdt = torch.float32, W0.dtype
    # all O(n^2) assembly stays f32; f64 appears only in O(n) vectors and in
    # the refinement residual, computed from f64 casts of the f32 matrices
    # (their f32-rounded values ARE the system being solved)
    rn32 = torch.clamp(1.0 / torch.clamp(torch.abs(A).amax(dim=2), 1e-10, 1e10),
                       0., 1e6).to(fdt)
    rn = rn32.to(rdt)
    r2_e = r2 * rn
    D_reg = D * rn * rn + delta_ce
    return dict(rn=rn, W32=W0.to(fdt).contiguous(),
                A32=(A.to(fdt) * rn32[:, :, None]).contiguous(),
                Dr32=D_reg.to(fdt).contiguous(), free32=free.to(fdt).contiguous(),
                D_reg=D_reg, r2_e=r2_e, b=torch.cat([r1, -r2_e], dim=1))


def kkt_assemble_plain(W32, A32, Dr32, free32, delta):
    """K(delta) = [[W32 + delta diag(free), A32^T], [A32, -diag(Dr32)]] in f32
    (batch.py:333-336), delta a (B,) tensor: the matrix the QR factor
    equilibrates and factors, and the one the LU factor Jacobi-scales."""
    B, n, _ = W32.shape
    d32 = delta.to(torch.float32)
    Wd = W32 + d32[:, None, None] * torch.diag_embed(free32.expand(B, n))
    return torch.cat([torch.cat([Wd, A32.transpose(1, 2)], dim=2),
                      torch.cat([A32, -torch.diag_embed(Dr32)], dim=2)], dim=1)


def kkt_assemble_scaled_plain(W32, A32, Dr32, free32, delta):
    """Ks = kd K(delta) kd and kd, with K(delta) of kkt_assemble_plain and
    kd = clip(1/sqrt(clip(|diag K|, 1e-8)), 0, 1e4) (|.| on the W block;
    the Dr block enters as is), all in f32 (batch.py:333-336, 409-413)."""
    n = W32.shape[1]
    K = kkt_assemble_plain(W32, A32, Dr32, free32, delta)
    kdiag = torch.cat([torch.abs(torch.diagonal(K, dim1=1, dim2=2)[:, :n]), Dr32], dim=1)
    kd = torch.clamp(1.0 / torch.sqrt(torch.clamp(kdiag, min=1e-8)), 0., 1e4)
    return K * kd[:, :, None] * kd[:, None, :], kd


def newton_kkt_plain(state, derivs_out, lbw, ubw, free, delta_w, delta_c, scaled=True):
    """newton_system, equilibrate and K(delta_w) of every lane: the system
    the first attempt of the direction solves. With ``scaled`` (the LU
    factor) K(delta_w) comes Jacobi-scaled as Ks with kd, from
    kkt_assemble_scaled_plain; without (the QR factor) as K, from
    kkt_assemble_plain. Returns Ks, kd or K (f32), the f64 images W64, A64
    of the f32 W0 and A' (the refinement's matrices), rn, D_reg, r2_e, b, r1
    (f64) and Dr32 (f32)."""
    rdt = state['w'].dtype
    sys_ = newton_system(state, derivs_out, lbw, ubw, free, delta_c)
    eq = equilibrate(sys_['W0'], sys_['A'], sys_['D'], sys_['r1'], sys_['r2'], free, delta_c)
    delta = torch.full((sys_['W0'].shape[0],), delta_w, dtype=rdt, device=free.device)
    pieces = (eq['W32'], eq['A32'], eq['Dr32'], eq['free32'], delta)
    if scaled:
        Ks, kd = kkt_assemble_scaled_plain(*pieces)
        mats = dict(Ks=Ks, kd=kd)
    else:
        mats = dict(K=kkt_assemble_plain(*pieces))
    return dict(mats, W64=eq['W32'].to(rdt), A64=eq['A32'].to(rdt), rn=eq['rn'],
                D_reg=eq['D_reg'], Dr32=eq['Dr32'], r2_e=eq['r2_e'], b=eq['b'], r1=sys_['r1'])


# the pointers newton_rows and newton_tiles take, in the order of
# csrc/auglu.cu's struct NewtonPtrs: inputs, outputs, scratch
NEWTON_FIELDS = ('JE', 'JI', 'H', 'gradf', 'cE', 'cI', 'w', 's', 'y', 'lam', 'zl', 'zu', 'mu',
                 'lbw', 'ubw', 'free',
                 'Ks', 'kd', 'W64', 'A64', 'rn', 'D_reg', 'Dr32', 'r2_e', 'b', 'r1',
                 'Araw', 'nu', 'diag32', 'rn32', 'Atnu')
NEWTON_OUTPUTS = NEWTON_FIELDS[16:26]
NEWTON_ROW_MAX = 768   # n the row phase holds in registers (32 * K1_ROW_REGS)


def _pointers(tensors, fields):
    return (ctypes.c_void_p * len(fields))(
        *[None if tensors.get(k) is None else tensors[k].data_ptr() for k in fields])


def newton_kkt(state, derivs_out, lbw, ubw, free, delta_w, delta_c, scaled=True):
    """The Newton system and K(delta_w) of every lane in one kernel pair
    (newton_rows, then A^T nu, then newton_tiles); equal to newton_kkt_plain
    bit for bit. state: the f64 (B, .) iterates and mu; derivs_out: (fval,
    gradf, cE, cI f64, JE, JI, H f32); lbw, ubw, free (n,) f64. Returns
    newton_kkt_plain's dict: with ``scaled`` Ks and kd, without it K alone
    (the kernels get a null kd: none is written, and the tiles are scaled
    by 1)."""
    if not state['w'].is_cuda:
        return newton_kkt_plain(state, derivs_out, lbw, ubw, free, delta_w, delta_c, scaled)
    name = 'newton_kkt'
    f32, f64 = torch.float32, torch.float64
    _, gradf, cE, cI, JE, JI, H = derivs_out
    t = dict(JE=JE, JI=JI, H=H, gradf=gradf, cE=cE, cI=cI, lbw=lbw, ubw=ubw, free=free,
             **{k: state[k] for k in ('w', 's', 'y', 'lam', 'zl', 'zu', 'mu')})
    _require(name, *[(t[k], f32 if k in ('JE', 'JI', 'H') else f64) for k in NEWTON_FIELDS[:16]])
    B, n = state['w'].shape
    n_eq, n_ineq = state['y'].shape[1], state['s'].shape[1]
    m, N = n_eq + n_ineq, n + n_eq + n_ineq
    shapes = dict(JE=(B, n_eq, n), JI=(B, n_ineq, n), H=(B, n, n), gradf=(B, n), cE=(B, n_eq),
                  cI=(B, n_ineq), w=(B, n), s=(B, n_ineq), y=(B, n_eq), lam=(B, n_ineq),
                  zl=(B, n), zu=(B, n), mu=(B,), lbw=(n,), ubw=(n,), free=(n,))
    if any(tuple(t[k].shape) != v for k, v in shapes.items()) or not (n_eq and n_ineq) \
            or n > NEWTON_ROW_MAX:
        raise ValueError(f'{name}: inconsistent shapes (or no equality or inequality rows, '
                         f'or n > {NEWTON_ROW_MAX})')
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=H.device)
    t.update(Ks=new((B, N, N), f32), kd=new((B, N), f32) if scaled else None,
             W64=new((B, n, n), f64),
             A64=new((B, m, n), f64), rn=new((B, m), f64), D_reg=new((B, m), f64),
             Dr32=new((B, m), f32), r2_e=new((B, m), f64), b=new((B, N), f64),
             r1=new((B, n), f64), Araw=new((B, m, n), f64), nu=new((B, m), f64),
             diag32=new((B, n), f32), rn32=new((B, m), f32))
    lib, stream = library(), _stream()
    _check(name, lib.newton_rows(_pointers(t, NEWTON_FIELDS), B, n, n_eq, n_ineq,
                                 float(delta_w), float(delta_c), stream))
    # A^T nu as newton_system forms it: the same product on the same f64 A
    t['Atnu'] = (t['Araw'].transpose(1, 2) @ t['nu'][:, :, None])[:, :, 0]
    _check(name, lib.newton_tiles(_pointers(t, NEWTON_FIELDS), B, n, n_eq, n_ineq,
                                  float(delta_w), stream))
    LAUNCHES[name] += 1
    out = {k: t[k] for k in NEWTON_OUTPUTS}
    if not scaled:
        out['K'] = out.pop('Ks')
        del out['kd']
    return out


def _assemble(name, W32, A32, Dr32, free32, delta, scaled):
    """The tile kernel on the f32 W0 and A' of the lanes given: Ks and kd,
    or the unscaled K and None."""
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
    kd = torch.empty(B, N, dtype=f32, device=W32.device) if scaled else None
    _check(name, library().kkt_assemble_scaled(
        _ptr(W32), _ptr(A32), _ptr(Dr32), _ptr(free32), _ptr(delta),
        _ptr(Ks), None if kd is None else _ptr(kd), B, n, m, _stream()))
    LAUNCHES[name] += 1
    return Ks, kd


def kkt_assemble_scaled(W32, A32, Dr32, free32, delta):
    """(B,n,n), (B,m,n), (B,m) f32, (n,) f32, (B,) f64 -> Ks (B,N,N), kd (B,N):
    the delta ladder's retry assembly of the LU factor, newton_kkt's tile
    kernel on the f32 W0 and A' of the retried lanes."""
    if not W32.is_cuda:
        return kkt_assemble_scaled_plain(W32, A32, Dr32, free32, delta)
    return _assemble('kkt_assemble_scaled', W32, A32, Dr32, free32, delta, True)


def kkt_assemble(W32, A32, Dr32, free32, delta):
    """Same arguments -> K (B,N,N), the unscaled K(delta): the QR factor's
    retry assembly, the same tile kernel writing no kd and scaling by none."""
    if not W32.is_cuda:
        return kkt_assemble_plain(W32, A32, Dr32, free32, delta)
    return _assemble('kkt_assemble', W32, A32, Dr32, free32, delta, False)[0]


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
BLOCKED_NB = 32             # panel width of both blocked variants (KB_NB)
QR_PANEL_STATIC_SMEM = 9_216   # room for qr_panel_kernel's static arrays (8576 B)


def blocked_lds(N: int) -> int:
    """The blocked panel kernels' leading dimension in shared memory: odd and
    >= N, so the 32 columns of one row fall in 32 banks."""
    return N | 1


class LUGeometry(NamedTuple):
    """How K2 lays one lane out: ``variant`` 'cluster' runs a cluster of
    ``C`` CTAs, each holding ``cols_per_cta`` whole columns (panels of
    ``nb`` dealt block-cyclically, leading dimension ``ld``) in
    ``smem_bytes`` of dynamic shared memory; 'blocked' keeps the lane in
    global memory and factors it in panels of ``nb`` columns, one CTA a lane
    holding a panel's rows (leading dimension ``ld``) in ``smem_bytes``
    (C = 1, cols_per_cta = nb). This is the one place that computes the
    layout: the kernels take it as it is."""
    variant: str
    C: int
    nb: int
    cols_per_cta: int
    ld: int
    smem_bytes: int


def lu_factor_geometry(N: int) -> LUGeometry:
    """K2's variant and layout for N x N lanes: the cluster variant when a
    lane fits the shared memory of LU_CLUSTER_MAX CTAs, else the blocked one
    while a panel's N rows fit one block's; beyond that it raises."""
    panels = -(-N // LU_NB)
    C = min(LU_CLUSTER_MAX, panels)
    cols = -(-panels // C) * LU_NB
    ld = -(-N // 4) * 4           # float4 rows; not a multiple of the 32
    if ld % 32 == 0:              # banks, so a row across columns spreads
        ld += 4
    # f32: the CTA's columns, the current L panel and the CTA's U12 block
    smem = 4 * (cols * ld + LU_NB * ld + LU_NB * cols)
    if smem + LU_STATIC_SMEM <= SMEM_PER_BLOCK:
        return LUGeometry('cluster', C, LU_NB, cols, ld, smem)
    lds = blocked_lds(N)
    smem = 4 * BLOCKED_NB * lds
    if smem + LU_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'lu_factor_batched: N={N} fits no variant of K2 (the blocked '
                         f'panel of {BLOCKED_NB} columns needs {smem} B of shared memory)')
    return LUGeometry('blocked', 1, BLOCKED_NB, BLOCKED_NB, lds, smem)


_max_clusters = {}


def cluster_max_active(name: str, geom) -> int:
    """Clusters of ``geom.C`` CTAs with ``geom.smem_bytes`` of shared memory
    each that the card runs at once, as ``{name}_occupancy`` of the library
    gives it (asked once per kernel and geometry); raises if it cannot run
    one."""
    key = (name, geom.C, geom.smem_bytes)
    if key not in _max_clusters:
        count = ctypes.c_int(0)
        _check(f'{name}_occupancy', getattr(library(), f'{name}_occupancy')(
            geom.C, geom.smem_bytes, ctypes.byref(count)))
        if count.value < 1:
            raise RuntimeError(f'{name}: a cluster of {geom.C} CTAs with '
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
        cluster_max_active('lu_factor_cluster', geom)
        _check(name, library().lu_factor_cluster(
            _ptr(Ks), _ptr(piv), B, N, geom.C, geom.cols_per_cta, geom.ld,
            geom.smem_bytes, _stream()))
    else:
        _check(name, library().lu_factor_blocked(_ptr(Ks), _ptr(piv), B, N, geom.ld,
                                                 geom.smem_bytes, _stream()))
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
    over lanes (batch.py:449-512); ``err`` of the result is ``err_kkt``.
    Without inequality rows (s, ds, lam, dlam of width 0) the s and lam
    ratios drop out, as in the JAX package."""
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
        one = ratios.new_ones(ratios.shape[0], 1)
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


def ip_step_plain(x, ok, rn, r1, state, derivs_out, lbw, ubw, free, tau, kappa_mu,
                  mu_min, ds_out=None):
    """The direction from the solution x = [dw'; dnu'] of the scaled system
    (batch.py:189-198: dw = x_w free, dnu = rn x_nu, zeroed on failed lanes
    and non-finite entries; ds, dzl, dzu; err_d = max |r1|, err_p) and the
    step advance_state takes with it. With ``ds_out``, ds is copied there."""
    n = free.shape[0]
    n_eq = state['y'].shape[1]
    s, zl, zu, mu = state['s'], state['zl'], state['zu'], state['mu']
    m_ = mu[:, None]
    _, _, cE, cI, _, JI, _ = derivs_out
    cE, cI, JI = fin(cE), fin(cI), fin(JI)
    dl = torch.clamp(state['w'] - lbw, min=1e-20)
    du = torch.clamp(ubw - state['w'], min=1e-20)
    dw = x[:, :n] * free
    dnu = rn * x[:, n:]
    okc = ok[:, None]
    dw = torch.where(okc & torch.isfinite(dw), dw, 0.)
    dnu = torch.where(okc & torch.isfinite(dnu), dnu, 0.)
    dy, dlam = dnu[:, :n_eq].contiguous(), dnu[:, n_eq:].contiguous()
    ds = -(cI + s) - (JI.to(dw.dtype) @ dw[:, :, None])[:, :, 0]
    dzl = m_ / dl - zl - zl * dw / dl
    dzu = m_ / du - zu + zu * dw / du
    err_d = torch.abs(r1).amax(dim=1)
    err_p = torch.maximum(torch.abs(cE).amax(dim=1),
                          torch.abs(cI + s).amax(dim=1))
    if ds_out is not None:
        ds_out.copy_(ds)
    return advance_state_plain(state, (dw, dy, dlam, ds, dzl, dzu), ok, err_d,
                               torch.maximum(err_d, err_p), lbw, ubw, tau, kappa_mu, mu_min)


# the pointers ip_step takes, in the order of csrc/auglu.cu's struct StepPtrs
STEP_FIELDS = ('x', 'ok', 'rn', 'r1', 'cE', 'cI', 'JI', 'w', 's', 'y', 'lam', 'zl', 'zu', 'mu',
               'lbw', 'ubw', 'free',
               'w_o', 's_o', 'y_o', 'lam_o', 'zl_o', 'zu_o', 'mu_o', 'err_o', 'ds_o')
STEP_ITEMS = 1024   # n and m the kernel takes at most (K4_ITEMS * K4_THREADS)


def ip_step(x, ok, rn, r1, state, derivs_out, lbw, ubw, free, tau, kappa_mu, mu_min,
            ds_out=None):
    """x (B, N) f64, ok (B,) bool, rn (B, m) and r1 (B, n) f64 (newton_kkt's),
    state: the f64 iterates and mu; derivs_out as newton_kkt takes it (cE, cI
    and JI are read); lbw, ubw, free (n,) f64. Returns the new state dict
    (with err), as ip_step_plain. ds_out: an optional (B, n_ineq) f64 tensor
    that receives ds, for the checks: ds is the one quantity the kernel sums
    in another order than the plain version (JI dw), and it reaches the
    state only through alpha's min and s's clamp, so its 1e-13 tolerance
    can be held only on ds itself."""
    if not x.is_cuda:
        return ip_step_plain(x, ok, rn, r1, state, derivs_out, lbw, ubw, free, tau,
                             kappa_mu, mu_min, ds_out)
    name = 'ip_step'
    f64 = torch.float64
    _, _, cE, cI, _, JI, _ = derivs_out
    t = dict(x=x, ok=ok, rn=rn, r1=r1, cE=cE, cI=cI, JI=JI, lbw=lbw, ubw=ubw, free=free,
             **{k: state[k] for k in STATE_KEYS + ('mu',)})
    if ds_out is not None:
        t['ds_o'] = ds_out
    _require(name, *[(v, torch.bool if k == 'ok' else torch.float32 if k == 'JI' else f64)
                     for k, v in t.items()])
    B, n = state['w'].shape
    n_eq, n_ineq = state['y'].shape[1], state['s'].shape[1]
    m = n_eq + n_ineq
    shapes = dict(x=(B, n + m), ok=(B,), rn=(B, m), r1=(B, n), cE=(B, n_eq), cI=(B, n_ineq),
                  JI=(B, n_ineq, n), w=(B, n), s=(B, n_ineq), y=(B, n_eq), lam=(B, n_ineq),
                  zl=(B, n), zu=(B, n), mu=(B,), lbw=(n,), ubw=(n,), free=(n,),
                  ds_o=(B, n_ineq))
    if any(tuple(v.shape) != shapes[k] for k, v in t.items()) or not (n_eq and n_ineq) \
            or n > STEP_ITEMS or m > STEP_ITEMS:
        raise ValueError(f'{name}: inconsistent shapes (or sizes the kernel does not take)')
    out = {k: torch.empty_like(state[k]) for k in STATE_KEYS + ('mu',)}
    out['err'] = torch.empty_like(state['mu'])
    t.update({f'{k}_o': v for k, v in out.items()})
    _check(name, library().ip_step(_pointers(t, STEP_FIELDS), B, n, n_eq, n_ineq, float(tau),
                                   float(kappa_mu), float(mu_min), _stream()))
    LAUNCHES[name] += 1
    return out


# the pointers advance_state takes, in the order of csrc/auglu.cu's struct
# AdvancePtrs: the direction and the lane scalars, the state, the bounds,
# then the new state
ADVANCE_FIELDS = ('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu', 'ok', 'err_d', 'err_kkt',
                  'w', 's', 'y', 'lam', 'zl', 'zu', 'mu', 'lbw', 'ubw',
                  'w_o', 's_o', 'y_o', 'lam_o', 'zl_o', 'zu_o', 'mu_o', 'err_o')


def advance_state(state, direction, ok, err_d, err_kkt, lbw, ubw, tau, kappa_mu, mu_min):
    """The step of a given direction (dw, dy, dlam, ds, dzl, dzu), each (B, .)
    f64, with ok (B,) bool and err_d, err_kkt (B,) f64: the new state dict
    (with err = err_kkt), equal to advance_state_plain bit for bit (the same
    f64 operations in the same order; minima are exact). On the card one
    launch of K4's step half, a CTA per lane; the block and the condensed
    directions step through it. Takes lanes without equality or inequality
    rows."""
    if not state['w'].is_cuda:
        return advance_state_plain(state, direction, ok, err_d, err_kkt, lbw, ubw, tau,
                                   kappa_mu, mu_min)
    name = 'advance_state'
    f64 = torch.float64
    t = dict(zip(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu'), direction), ok=ok, err_d=err_d,
             err_kkt=err_kkt, lbw=lbw, ubw=ubw, **{k: state[k] for k in STATE_KEYS + ('mu',)})
    _require(name, *[(v, torch.bool if k == 'ok' else f64) for k, v in t.items()])
    B, n = state['w'].shape
    n_eq, n_ineq = state['y'].shape[1], state['s'].shape[1]
    shapes = dict(dw=(B, n), dy=(B, n_eq), dlam=(B, n_ineq), ds=(B, n_ineq), dzl=(B, n),
                  dzu=(B, n), ok=(B,), err_d=(B,), err_kkt=(B,), w=(B, n), s=(B, n_ineq),
                  y=(B, n_eq), lam=(B, n_ineq), zl=(B, n), zu=(B, n), mu=(B,), lbw=(n,),
                  ubw=(n,))
    if any(tuple(v.shape) != shapes[k] for k, v in t.items()):
        raise ValueError(f'{name}: inconsistent shapes')
    out = {k: torch.empty_like(state[k]) for k in STATE_KEYS + ('mu',)}
    out['err'] = torch.empty_like(state['mu'])
    t.update({f'{k}_o': v for k, v in out.items()})
    _check(name, library().advance_state(_pointers(t, ADVANCE_FIELDS), B, n, n_eq, n_ineq,
                                         float(tau), float(kappa_mu), float(mu_min), _stream()))
    LAUNCHES[name] += 1
    return out


# --- K5 ----------------------------------------------------------------------

RUIZ_SWEEPS = 3             # as batch.py:377 (K5_SWEEPS)


def ruiz_scale_plain(K):
    """Three Ruiz sweeps from s = 1 (batch.py:375-381): rr = sqrt(clip(max_j
    |M_ij|, 1e-12)), s <- s / rr, M <- K s_i s_j, all f32, the maximum over
    each row. Returns (M (B,N,N), s (B,N)). A NaN in a row passes through
    the clip into that row's s, as in the JAX package."""
    s = torch.ones(K.shape[:2], dtype=K.dtype, device=K.device)
    M = K
    for _ in range(RUIZ_SWEEPS):
        rr = torch.sqrt(torch.clamp(M.abs().amax(dim=2), min=1e-12))
        s = s / rr
        M = K * s[:, :, None] * s[:, None, :]
    return M, s


RUIZ_WARPS = 12             # warps a CTA, a warp per row (K5_THREADS / 32)
RUIZ_CLUSTER_MAX = 16       # CTAs a lane (K5_MAX_CLUSTER, a non-portable cluster size)
RUIZ_L2_BYTES = 40 << 20    # streamed rows the clusters in flight may keep in the 50 MB L2
RUIZ_STATIC_SMEM = 16       # room for the kernel's static shared memory (its mbarrier, 8 B)
RUIZ_REG_ROWS = 2           # rows a warp may hold in registers (K5_REG_ROWS) ...
RUIZ_REG_COLS = 33          # ... of N <= 32 RUIZ_REG_COLS columns (K5_REG_COLS)


class RuizGeometry(NamedTuple):
    """How K5 lays one lane out: a cluster of ``C`` CTAs, each owning
    ``rows`` contiguous rows (the last CTA what is left); the first
    ``resident_rows`` are copied into ``smem_bytes`` of dynamic shared
    memory beside the lane's s, the next ``register_rows`` (for N <= 1056)
    are held in registers. 'resident' holds every row on chip; 'streamed'
    re-reads the others from global memory each sweep, with at most
    ``lanes_in_flight`` clusters at once so that those rows stay in the L2
    (0: no cap)."""
    mode: str
    C: int
    rows: int
    resident_rows: int
    register_rows: int
    smem_bytes: int
    lanes_in_flight: int


def ruiz_smem(N: int, rows: int, resident: int) -> int:
    """K5's dynamic shared memory (k5_smem in csrc/auglu.cu): the lane's s,
    the CTA's s in two buffers, the resident rows and the 16-byte blocks
    that cover them."""
    pad4 = lambda x: -(-x // 4) * 4
    return 4 * (pad4(N) + 2 * pad4(rows) + resident * N + 8)


def ruiz_layout(N: int, C: int, smem_cap: int = SMEM_PER_BLOCK) -> RuizGeometry:
    """K5's layout for N x N lanes on clusters of up to C CTAs (fewer where
    ceil(N / rows) is fewer), holding as many of a CTA's rows as smem_cap
    bytes of shared memory take and, where that is not all of them and
    N <= 32 RUIZ_REG_COLS (the kernel's k5_registers), up to RUIZ_REG_ROWS
    more a warp in registers; raises where not even the lane's s fits."""
    rows = -(-N // C)
    C = -(-N // rows)
    fixed = ruiz_smem(N, rows, 0)
    room = smem_cap - RUIZ_STATIC_SMEM
    if fixed > room:
        raise ValueError(f'ruiz_scale: N={N} fits no layout of K5 (the lane\'s s alone needs '
                         f'{fixed} B of shared memory, more than {room})')
    resident = min(rows, (room - fixed) // (4 * N))
    registers = 0
    if resident < rows and N <= 32 * RUIZ_REG_COLS:
        registers = min(rows - resident, RUIZ_WARPS * RUIZ_REG_ROWS)
    on_chip = resident + registers
    smem = ruiz_smem(N, rows, resident)
    if on_chip == rows:
        return RuizGeometry('resident', C, rows, resident, registers, smem, 0)
    streamed = 4 * N * (N - sum(min(on_chip, N - q * rows) for q in range(C)))
    return RuizGeometry('streamed', C, rows, resident, registers, smem,
                        max(1, RUIZ_L2_BYTES // streamed))


def ruiz_geometry(N: int) -> RuizGeometry:
    """K5's layout for N x N lanes: clusters of RUIZ_CLUSTER_MAX CTAs (fewer
    where the lane has fewer than RUIZ_WARPS rows a CTA); at the slice's
    N=543 every row in shared memory (34 rows, 76 KB a CTA: three CTAs an
    SM), at N=1055 53 of 66 rows there and 13 in registers."""
    return ruiz_layout(N, min(RUIZ_CLUSTER_MAX, -(-N // RUIZ_WARPS)))


def ruiz_cluster_max_active(N: int, geom: RuizGeometry) -> int:
    """Clusters of this geometry the card runs at once (asked once per
    geometry); raises if it cannot run one."""
    key = ('ruiz', geom.register_rows > 0, geom.C, geom.smem_bytes)
    if key not in _max_clusters:
        count = ctypes.c_int(0)
        _check('ruiz_cluster_occupancy', library().ruiz_cluster_occupancy(
            N, geom.rows, geom.resident_rows, geom.C, geom.smem_bytes, ctypes.byref(count)))
        if count.value < 1:
            raise RuntimeError(f'ruiz_scale: a cluster of {geom.C} CTAs with '
                               f'{geom.smem_bytes} B of shared memory each cannot be scheduled')
        _max_clusters[key] = count.value
    return _max_clusters[key]


def ruiz_clusters(B: int, N: int, geom: RuizGeometry) -> int:
    """The clusters one call launches: one a lane, at most as many as run at
    once and, in streamed mode, as the L2 cap allows."""
    return min(B, ruiz_cluster_max_active(N, geom), geom.lanes_in_flight or B)


def ruiz_scale(K):
    """(B,N,N) f32 -> (M (B,N,N), s (B,N)) f32, equal to ruiz_scale_plain bit
    for bit (a maximum, one square root and one division a row, two
    products an entry, each rounded as PyTorch rounds them), in one launch
    laid out by ruiz_geometry(N)."""
    if not K.is_cuda:
        return ruiz_scale_plain(K)
    name = 'ruiz_scale'
    _require(name, (K, torch.float32))
    B, N, N2 = K.shape
    if N != N2:
        raise ValueError(f'{name}: square matrices expected')
    geom = ruiz_geometry(N)
    M = torch.empty_like(K)
    s = torch.empty(B, N, dtype=torch.float32, device=K.device)
    _check(name, library().ruiz_scale(
        _ptr(K), _ptr(M), _ptr(s), B, N, geom.C, geom.rows, geom.resident_rows,
        ruiz_clusters(B, N, geom), geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return M, s


# --- K6 ----------------------------------------------------------------------

def qr_factor_batched_plain(M):
    """Householder QR in LAPACK's geqrf layout: R on and above the diagonal,
    the reflectors v_k (unit leading entry implied) below it, and tau (B,N);
    H_k = I - tau_k v_k v_k^T, Q = H_0 H_1 .. H_{N-1}."""
    return torch.geqrf(M)


QR_NB = 16                  # panel width of the cluster kernel (K6_NB): a warp per column
QR_ROW_MAX = 640            # rows a warp holds in registers (32 * K6_ROWS)
QR_CLUSTER_STATIC_SMEM = 2_560   # room for the cluster kernel's static arrays (2048 B)


class QRGeometry(NamedTuple):
    """How K6 lays one lane out, as LUGeometry: 'cluster' runs a cluster of
    ``C`` CTAs, each holding ``cols_per_cta`` whole columns (panels of ``nb``
    dealt block-cyclically, leading dimension ``ld``) and a copy of the
    current panel's reflectors in ``smem_bytes`` of dynamic shared memory;
    'blocked' is K2's blocked layout (the lane in global memory, a panel's
    rows in shared memory)."""
    variant: str
    C: int
    nb: int
    cols_per_cta: int
    ld: int
    smem_bytes: int


def qr_cluster_layout(N: int, C: int) -> Optional[QRGeometry]:
    """K6's cluster layout for N x N lanes on clusters of C CTAs (fewer where
    the lane has fewer panels), or None where a warp's registers do not hold
    a column or a CTA's columns, the panel copy and the static arrays do not
    fit one block's shared memory."""
    if N > QR_ROW_MAX:
        return None
    panels = -(-N // QR_NB)
    C = min(C, panels)
    cols = -(-panels // C) * QR_NB
    ld = -(-N // 4) * 4           # float4 rows of the panel copy
    # f32: the CTA's columns and the current panel's reflectors
    smem = 4 * (cols * ld + QR_NB * ld)
    if smem + QR_CLUSTER_STATIC_SMEM > SMEM_PER_BLOCK:
        return None
    return QRGeometry('cluster', C, QR_NB, cols, ld, smem)


def qr_factor_geometry(N: int) -> QRGeometry:
    """K6's variant and layout for N x N lanes: the cluster variant on
    LU_CLUSTER_MAX CTAs where the lane fits them (at N=543 a cluster of 7
    needs the same shared memory a CTA, and the H100 runs 15 clusters at
    once of either size: PERF.md), else the blocked one while a panel's N
    rows fit one block's shared memory; beyond that it raises."""
    geom = qr_cluster_layout(N, LU_CLUSTER_MAX)
    if geom is not None:
        return geom
    lds = blocked_lds(N)
    smem = 4 * BLOCKED_NB * lds
    if smem + QR_PANEL_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'qr_factor_batched: N={N} fits no variant of K6 (the blocked '
                         f'panel of {BLOCKED_NB} columns needs {smem} B of shared memory)')
    return QRGeometry('blocked', 1, BLOCKED_NB, BLOCKED_NB, lds, smem)


def qr_factor_batched(M):
    """(B,N,N) f32 -> (qr (B,N,N), tau (B,N)) f32 in geqrf's layout; M is
    kept (the refinement's residual reads it). The variant is
    qr_factor_geometry(N)'s. Signs follow LAPACK's larfg (beta = -sign(alpha)
    |x|), but a factor is unique only up to rounding: compare |diag R| and
    solutions, not entries."""
    if not M.is_cuda:
        return qr_factor_batched_plain(M)
    name = 'qr_factor_batched'
    _require(name, (M, torch.float32))
    B, N, N2 = M.shape
    if N != N2:
        raise ValueError(f'{name}: square matrices expected')
    geom = qr_factor_geometry(N)
    qr = torch.empty_like(M)
    tau = torch.empty(B, N, dtype=torch.float32, device=M.device)
    if geom.variant == 'cluster':
        cluster_max_active('qr_factor_cluster', geom)
        _check(name, library().qr_factor_cluster(
            _ptr(M), _ptr(qr), _ptr(tau), B, N, geom.C, geom.cols_per_cta, geom.ld,
            geom.smem_bytes, _stream()))
    else:
        # scratch: each panel's T factor and V^T A22
        T = torch.empty(B, BLOCKED_NB, BLOCKED_NB, dtype=torch.float32, device=M.device)
        W = torch.empty(B, BLOCKED_NB, N, dtype=torch.float32, device=M.device)
        _check(name, library().qr_factor_blocked(_ptr(M), _ptr(qr), _ptr(tau), _ptr(T), _ptr(W),
                                                 B, N, geom.ld, geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    LAUNCHES[f'qr_factor_{geom.variant}'] += 1
    return qr, tau


# --- K7 ----------------------------------------------------------------------

def qr_solve_batched_plain(qr, tau, v):
    """R^-1 (Q^T v) from a geqrf factor, all f32 (batch.py:344-346): the
    reflectors applied by ormqr, then the triangular solve with R."""
    y = torch.ormqr(qr, tau, v[:, :, None], left=True, transpose=True)
    return torch.linalg.solve_triangular(torch.triu(qr), y, upper=True)[:, :, 0]


QR_SOLVE_NB = 32            # reflectors per panel and tile width of the solve (K7_NB): a warp
QR_SOLVE_LDV = 36           # f32 per staged row of a panel or tile (K7_LDV)
QR_SOLVE_SROW = 36          # f32 per row of a staging slot: 9 aligned 16-byte blocks (K7_SROW)
# (warps per lane, tiles of a warp's staging slot) the kernel is compiled
# for, in the order of preference: the slice's N=543 takes the first, the
# n_k=8 sweep's N=1055 the second, the largest lanes the last; the warps fix
# the order of the sums, and so x's bits
QR_SOLVE_LAYOUTS = ((16, 8), (8, 4), (8, 1))
QR_SOLVE_STATIC_SMEM = 5_120   # room for the kernel's static arrays (4480 B)


class QRSolveGeometry(NamedTuple):
    """How K7 lays one lane out: ``tiles`` panels of ``QR_SOLVE_NB``
    reflectors, then as many tile steps of the back substitution, by
    ``warps`` warps. In Q^T v each warp streams its rows of the factor
    through a slot of ``group`` tiles; ``smem_bytes`` of dynamic shared
    memory hold the right-hand side padded to whole tiles and R's
    diagonal, then every warp's partial Gram matrix and partial V^T y, a
    staged row of ``QR_SOLVE_LDV`` f32 for each entry of the right-hand
    side and the slots (``group`` tiles of 32 rows of ``QR_SOLVE_SROW``
    f32); in R x = y the same room holds every warp's ring of
    ``QR_SOLVE_BACK_SLOTS`` whole tiles."""
    tiles: int
    warps: int
    group: int
    smem_bytes: int


QR_SOLVE_BACK_SLOTS = 2     # whole tiles (SOLVE_TILE f32, K3's layout) a warp's ring holds
                            # in R x = y (K7_BACK_SLOTS)


def qr_solve_smem(N: int, warps: int, group: int) -> int:
    """Dynamic shared memory of K7 at N (k7_smem in csrc/auglu.cu)."""
    rows = -(-N // QR_SOLVE_NB) * QR_SOLVE_NB
    qt = (warps * QR_SOLVE_NB * (QR_SOLVE_LDV + 1) + rows * QR_SOLVE_LDV
          + group * QR_SOLVE_NB * QR_SOLVE_SROW)
    return 4 * (2 * rows + max(qt, warps * QR_SOLVE_BACK_SLOTS * SOLVE_TILE))


def qr_solve_geometry(N: int) -> QRSolveGeometry:
    """K7's layout for N x N lanes: the first of ``QR_SOLVE_LAYOUTS`` that
    fits one block's shared memory."""
    for layout in QR_SOLVE_LAYOUTS:
        smem = qr_solve_smem(N, *layout)
        if smem + QR_SOLVE_STATIC_SMEM <= SMEM_PER_BLOCK:
            return QRSolveGeometry(-(-N // QR_SOLVE_NB), *layout, smem)
    raise ValueError(f'qr_solve_batched: N={N} leaves no room for the staged rows')


def qr_solve_batched(qr, tau, v):
    """(B,N,N) f32 in geqrf's layout, (B,N) f32, (B,N) f32 -> (B,N) f32."""
    if not qr.is_cuda:
        return qr_solve_batched_plain(qr, tau, v)
    name = 'qr_solve_batched'
    f32 = torch.float32
    _require(name, (qr, f32), (tau, f32), (v, f32))
    B, N, _ = qr.shape
    if tau.shape != (B, N) or v.shape != (B, N):
        raise ValueError(f'{name}: inconsistent shapes')
    geom = qr_solve_geometry(N)
    x = torch.empty(B, N, dtype=f32, device=qr.device)
    _check(name, library().qr_solve_batched(_ptr(qr), _ptr(tau), _ptr(v), _ptr(x), B, N,
                                            geom.warps, geom.group, geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return x


# --- K8, K9: the block-structured factor and solve (ocp/blockkkt.py) ----------

class BlockLayout(NamedTuple):
    """The frame layout of ocp/blockkkt.py: n_k intervals, each frame
    [x_k (nx) | x_{k+1} (nx) | interior (ni) | border (nb)] of nloc
    variables; the coupling [x_k | x_{k+1} | border] has c = 2 nx + nb, the
    reduced system over [x_1 .. x_{n_k} | border] nr = n_k nx + nb."""
    n_k: int
    nx: int
    ni: int
    nb: int
    nloc: int

    @property
    def c(self):
        return 2 * self.nx + self.nb

    @property
    def nr(self):
        return self.n_k * self.nx + self.nb


def _cholesky_or_nan(M):
    """Lower Cholesky factor as jnp.linalg.cholesky gives it: NaN wherever
    LAPACK's potrf fails (a pivot <= 0 or NaN)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def block_factor_plain(Frame, delta, own_free, lay: BlockLayout):
    """The two-level factor of ocp/blockkkt.py (awebox_tpu/ocp/blockkkt.py:539-588)
    of the frames Frame (B, n_k, nloc, nloc) damped by delta (B,) on the
    diagonal entries own_free (n_k, nloc): Li (B, n_k, ni, ni), the interior
    Cholesky factors; Xc = Li^-1 [M_ib | M_ibn | M_ig] (B, n_k, ni, c); L_R
    (B, nr, nr), the Cholesky factor of the reduced system R, whose blocks
    are the sums of the frames' Schur complements S = M_cc - Xc^T Xc; and
    ok (B,), that Li and L_R are finite. A failed factor is NaN, as
    jnp.linalg.cholesky's; on a lane that fails, L_R is NaN throughout."""
    B = Frame.shape[0]
    n_k, nx, ni, nb = lay.n_k, lay.nx, lay.ni, lay.nb
    c2, oi, og = 2 * nx, 2 * nx, 2 * nx + ni
    Fr = Frame.clone()
    Fr.diagonal(dim1=-2, dim2=-1).add_(delta[:, None, None] * own_free)
    Mii = Fr[:, :, oi:og, oi:og]
    Mi = Fr[:, :, oi:og]
    Mic = torch.cat([Mi[..., :c2], Mi[..., og:]], dim=-1)
    Fcr = torch.cat([Fr[:, :, :c2], Fr[:, :, og:]], dim=2)
    Fcc = torch.cat([Fcr[..., :c2], Fcr[..., og:]], dim=-1)
    Li = _cholesky_or_nan(Mii)
    Xc = torch.linalg.solve_triangular(Li, Mic, upper=False)
    S = Fcc - Xc.transpose(-1, -2) @ Xc
    bb, bnbn, bbn = S[..., :nx, :nx], S[..., nx:c2, nx:c2], S[..., :nx, nx:c2]
    bg, bng = S[..., :nx, c2:], S[..., nx:c2, c2:]
    gg = S[..., c2:, c2:].sum(dim=1)
    # the reduced bordered chain over [x_1 .. x_{n_k} | border]: T_diag[j]
    # couples x_{j+1} with itself, T_off[j] x_{j+1} with x_{j+2}
    T_diag = bnbn + torch.cat([bb[:, 1:], torch.zeros_like(bb[:, :1])], dim=1)
    Fb = bng + torch.cat([bg[:, 1:], torch.zeros_like(bg[:, :1])], dim=1)
    Rc = Frame.new_zeros(B, n_k, nx, n_k, nx)
    ks = torch.arange(n_k)
    Rc[:, ks, :, ks, :] = T_diag.transpose(0, 1)
    if n_k > 1:
        Rc[:, ks[:-1], :, ks[1:], :] = bbn[:, 1:].transpose(0, 1)
        Rc[:, ks[1:], :, ks[:-1], :] = bbn[:, 1:].transpose(-1, -2).transpose(0, 1)
    Rc = Rc.reshape(B, n_k * nx, n_k * nx)
    Fb_r = Fb.reshape(B, n_k * nx, nb)
    R = torch.cat([torch.cat([Rc, Fb_r], dim=2),
                   torch.cat([Fb_r.transpose(1, 2), gg], dim=2)], dim=1)
    L_R = _cholesky_or_nan(R)
    ok = torch.isfinite(Li).flatten(1).all(dim=1) & torch.isfinite(L_R).flatten(1).all(dim=1)
    L_R = torch.where(ok[:, None, None], L_R, torch.nan)
    return Li, Xc, L_R, ok


BLOCK_WIDTH = 8             # panel width of K8 (KB8_W): the MMA's two k = 4 steps
BLOCK_ROW_MAX = 160         # rows of a frame or of R a panel holds in registers (32 KB8_CHUNKS)
BLOCK_CLUSTER_MAX = 16      # frames a lane, a CTA each (KB8_MAX_CLUSTER; non-portable past 8)
BLOCK_STATIC_SMEM = 1_024   # room for K8's static shared arrays (688 B)


class BlockGeometry(NamedTuple):
    """How K8 lays one lane out: a thread-block cluster of n_k CTAs, rank k
    holding frame k (nloc rows at leading dimension ``ld_frame``) and then
    its Schur complement S (c rows at ``ld_s``); after a cluster barrier the
    ranks gather R (nr rows at ``ld_r``) into the space rank 0's frame used.
    ``smem_bytes`` of dynamic shared memory a rank (a launch gives every
    rank the same); panels of BLOCK_WIDTH columns."""
    ld_frame: int
    ld_r: int
    ld_s: int
    smem_bytes: int


def block_ld(n: int) -> int:
    """The least leading dimension >= n that is 4 mod 8 doubles: the 8 rows
    of 4 columns of an MMA fragment then fall on distinct banks."""
    return n + (4 - n) % 8


def block_factor_geometry(lay: BlockLayout) -> BlockGeometry:
    """K8's layout of a lane: a cluster of n_k CTAs, each with the larger of a
    frame and R plus S in shared memory (n_k = 4: 91.6 KB and n_k = 8: 108.1
    KB, two CTAs an SM; n_k = 10: 152.2 KB); raises by name where a frame or
    R has more rows than a panel holds in registers, or more frames than a
    cluster has CTAs, or does not fit one block's shared memory (n_k >= 13
    at nx = 11)."""
    nloc, nr, c = lay.nloc, lay.nr, lay.c
    if lay.n_k > BLOCK_CLUSTER_MAX or max(nloc, nr) > BLOCK_ROW_MAX:
        raise ValueError(f'block_factor: {lay.n_k} frames of {nloc} and a reduced system of '
                         f'{nr} exceed K8 (at most {BLOCK_CLUSTER_MAX} frames, '
                         f'{BLOCK_ROW_MAX} rows)')
    ldf, ldr, lds = block_ld(nloc), block_ld(nr), block_ld(c)
    smem = 8 * (max(nloc * ldf, nr * ldr) + c * lds)
    if smem + BLOCK_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'block_factor: a frame of {nloc}, a reduced system of {nr} and a '
                         f'Schur complement of {c} need {smem} B of shared memory, more than '
                         f'one block has')
    return BlockGeometry(ldf, ldr, lds, smem)


def block_factor(Frame, delta, own_free, lay: BlockLayout):
    """(B, n_k, nloc, nloc) f64, (B,) f64, (n_k, nloc) f64 -> (Li, Xc, L_R,
    ok) as block_factor_plain; on a lane that fails (a pivot <= 0 or
    non-finite, or a non-finite entry of Li or L_R) ok is False and L_R is
    NaN, Li and Xc unspecified. On the card one launch, a thread-block
    cluster per lane laid out by block_factor_geometry: each CTA factors a
    frame's interior, the Schur complements are gathered into R in rank 0
    through distributed shared memory, and rank 0 factors it; raises where
    that layout does not fit."""
    if not Frame.is_cuda:
        return block_factor_plain(Frame, delta, own_free, lay)
    name = 'block_factor'
    f64 = torch.float64
    _require(name, (Frame, f64), (delta, f64), (own_free, f64))
    B = Frame.shape[0]
    n_k, nx, ni, nb, nloc = lay
    if Frame.shape != (B, n_k, nloc, nloc) or delta.shape != (B,) \
            or own_free.shape != (n_k, nloc) or nloc != 2 * nx + ni + nb:
        raise ValueError(f'{name}: inconsistent shapes')
    geom = block_factor_geometry(lay)
    new = lambda *shape: torch.empty(shape, dtype=f64, device=Frame.device)
    Li, Xc, L_R = new(B, n_k, ni, ni), new(B, n_k, ni, lay.c), new(B, lay.nr, lay.nr)
    ok = torch.empty(B, dtype=torch.bool, device=Frame.device)
    _check(name, library().block_factor(_ptr(Frame), _ptr(delta), _ptr(own_free), _ptr(Li),
                                        _ptr(Xc), _ptr(L_R), _ptr(ok), B, n_k, nx, ni, nb,
                                        geom.ld_frame, geom.ld_r, geom.ld_s, geom.smem_bytes,
                                        _stream()))
    LAUNCHES[name] += 1
    return Li, Xc, L_R, ok


def block_solve_plain(Li, Xc, L_R, rhs, index_maps, lay: BlockLayout):
    """M^-1 rhs through block_factor's factor (awebox_tpu/ocp/blockkkt.py:646-679),
    rhs (B, n): the interior forward solves, the chain and border updates,
    the reduced solve, the interior back substitution. index_maps =
    (chain_V (n_k, nx), intr_V (n_k, ni), border_V (nb,)), the variables of
    each block, a partition of the n."""
    chain_V, intr_V, border_V = index_maps
    B, n = rhs.shape
    n_k, nx = lay.n_k, lay.nx
    c2 = 2 * nx
    st = torch.linalg.solve_triangular
    r_chain, r_intr, r_bord = rhs[:, chain_V], rhs[:, intr_V], rhs[:, border_V]
    t = st(Li, r_intr[..., None], upper=False)[..., 0]
    Xb, Xbn, Xg = Xc[..., :nx], Xc[..., nx:c2], Xc[..., c2:]
    tT = t[..., None, :]
    upd, upd_b = (tT @ Xbn)[..., 0, :], (tT @ Xb)[..., 0, :]
    r_chain = r_chain - upd - torch.cat([upd_b[:, 1:], torch.zeros_like(upd_b[:, :1])], dim=1)
    r_bord = r_bord - (tT @ Xg)[..., 0, :].sum(dim=1)
    rhs_red = torch.cat([r_chain.reshape(B, -1), r_bord], dim=1)
    u = st(L_R, rhs_red[..., None], upper=False)
    xr = st(L_R.transpose(-1, -2), u, upper=True)[..., 0]
    x_chain, x_g = xr[:, :n_k * nx].reshape(B, n_k, nx), xr[:, n_k * nx:]
    xb_full = torch.cat([x_g[:, None, :nx], x_chain[:, :-1]], dim=1)
    rhs_i = t - (Xb @ xb_full[..., None])[..., 0] - (Xbn @ x_chain[..., None])[..., 0] \
        - (Xg @ x_g[:, None, :, None])[..., 0]
    x_intr = st(Li.transpose(-1, -2), rhs_i[..., None], upper=True)[..., 0]
    out = rhs.new_zeros(B, n)
    out[:, chain_V.reshape(-1)] = x_chain.reshape(B, -1)
    out[:, intr_V.reshape(-1)] = x_intr.reshape(B, -1)
    out[:, border_V] = x_g
    return out


SUBST_NB = 32               # tile width of K9's and K11's substitutions (KS_NB)
SUBST_LD = 34               # doubles a staged tile row (KS_LDT): 16-byte rows
SUBST_TILE_BYTES = 8 * SUBST_NB * SUBST_LD
SUBST_STATIC_SMEM = 1_024   # room for static shared arrays (none; a probe's stamps)


class BlockSolveGeometry(NamedTuple):
    """How K9 lays one lane out: a thread-block cluster of ``C`` = n_k CTAs,
    rank k holding frame k's ``li_tiles`` lower tiles of Li and its Xc (ni
    rows at the odd leading dimension ``ld_x``), rank 0 also the
    ``r_tiles`` lower tiles of L_R, then the vectors (the interior and the
    reduced system, each with the reciprocals of its factor's diagonal, and
    the frames' coupling products), in ``smem_bytes`` of dynamic shared
    memory a rank (a launch gives every rank the same). A tile is 32 rows of
    SUBST_LD doubles. This is the one place that computes the layout:
    the kernel takes it as it is."""
    C: int
    ld_x: int
    li_tiles: int
    r_tiles: int
    smem_bytes: int


def block_solve_geometry(lay: BlockLayout) -> BlockSolveGeometry:
    """K9's layout of a lane (n_k = 4: 74,192 B a rank; n_k = 8: 137,488 B;
    n_k = 12: 182,864 B); raises by name where there are more frames than a
    cluster has CTAs or rank 0's factors do not fit one block's shared
    memory (n_k >= 13 at nx = 11, as block_factor_geometry)."""
    n_k, nx, ni, nb, nloc = lay
    c, nr = lay.c, lay.nr
    ti, tr = -(-ni // SUBST_NB), -(-nr // SUBST_NB)
    li_tiles, r_tiles = ti * (ti + 1) // 2, tr * (tr + 1) // 2
    ld_x = c | 1
    doubles = ((li_tiles + r_tiles) * SUBST_NB * SUBST_LD + (ni * ld_x + 1) // 2 * 2
               + 2 * SUBST_NB * (ti + tr) + n_k * c)
    smem = 8 * doubles
    if n_k > BLOCK_CLUSTER_MAX or smem + SUBST_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'block_solve: {n_k} frames (interior {ni}) and a reduced system of '
                         f'{nr} need a cluster of {n_k} CTAs with {smem} B of shared memory each '
                         f'(at most {BLOCK_CLUSTER_MAX} CTAs, {SMEM_PER_BLOCK} B)')
    return BlockSolveGeometry(n_k, ld_x, li_tiles, r_tiles, smem)


def block_solve(Li, Xc, L_R, rhs, index_maps, lay: BlockLayout):
    """(B, n) f64 right-hand sides -> (B, n) f64, as block_solve_plain; the
    index maps are int64 tensors. On the card one launch, a thread-block
    cluster of n_k CTAs a lane laid out by block_solve_geometry: each CTA
    solves a frame's interior with its factor in shared memory, rank 0 the
    reduced system after gathering the frames' products through distributed
    shared memory; raises where that layout does not fit."""
    if not rhs.is_cuda:
        return block_solve_plain(Li, Xc, L_R, rhs, index_maps, lay)
    name = 'block_solve'
    f64 = torch.float64
    chain_V, intr_V, border_V = index_maps
    _require(name, (Li, f64), (Xc, f64), (L_R, f64), (rhs, f64), (chain_V, torch.int64),
             (intr_V, torch.int64), (border_V, torch.int64))
    B, n = rhs.shape
    n_k, nx, ni, nb, nloc = lay
    if Li.shape != (B, n_k, ni, ni) or Xc.shape != (B, n_k, ni, lay.c) \
            or L_R.shape != (B, lay.nr, lay.nr) or chain_V.shape != (n_k, nx) \
            or intr_V.shape != (n_k, ni) or border_V.shape != (nb,) \
            or n != n_k * (nx + ni) + nb:
        raise ValueError(f'{name}: inconsistent shapes')
    geom = block_solve_geometry(lay)
    cluster_max_active('block_solve', geom)
    x = torch.empty_like(rhs)
    _check(name, library().block_solve(_ptr(Li), _ptr(Xc), _ptr(L_R), _ptr(rhs),
                                       _ptr(chain_V), _ptr(intr_V), _ptr(border_V), _ptr(x),
                                       B, n_k, nx, ni, nb, n, geom.ld_x, geom.smem_bytes,
                                       _stream()))
    LAUNCHES[name] += 1
    return x


# --- K10, K11: the condensed Cholesky factor and solve -------------------------

def chol_factor_batched_plain(M):
    """(B, n, n) -> (L lower, ok (B,)): the Cholesky factor of each lane and
    whether it is finite (batch.py:215-219); a failed lane's L is NaN, as
    jnp.linalg.cholesky's."""
    L = _cholesky_or_nan(M)
    return L, torch.isfinite(L).flatten(1).all(dim=1)


CHOL_CLUSTER_NB = 16        # panel width of K10's variants (K10C_NB)
CHOL_CLUSTER_MAX = 16       # CTAs a lane (K10C_MAX_CLUSTER; non-portable past 8)
CHOL_STATIC_SMEM = 3_072    # room for either variant's static shared arrays (2192 B)
CHOL_STREAM_CHUNK = 256     # rows of the stream variant's receive buffer (K10S_CHUNK): a
                            # chunk of the trailing update, or the look-ahead's 32 handed-over
                            # rows and a chunk of 224
CHOL_STREAM_HEAD = 32       # rows of its look-ahead's handoff buffer (K10S_HEAD)
CHOL_STREAM_ROWSTEP = 224   # rows a chunk of its look-ahead (K10S_ROWSTEP: warps 1 .. 7)
CHOL_STREAM_LOCAL = 6       # panels a rank of it owns at most (K10S_MAX_LOCAL)
CHOL_STREAM_MAX = CHOL_CLUSTER_NB * CHOL_CLUSTER_MAX * CHOL_STREAM_LOCAL   # 1536


class CholGeometry(NamedTuple):
    """How K10 lays one lane out: a thread-block cluster of ``C`` CTAs,
    panels of ``nb`` columns dealt block-cyclically (rank r holds
    ``panels[r]``, panel p's rows p nb .. n - 1 at leading dimension ``ld``).
    'cluster': each panel from row ``offsets[r][i]`` of its rank's shared
    memory, then a receive buffer of ``recv_rows`` rows from double
    ``recv_off`` for the panel being applied. 'stream': the panels whose
    offset is None lie in L itself, the others from that row of shared
    memory (at most ``recv_off / ld`` rows a rank), then a receive buffer of
    ``recv_rows`` (a chunk), the look-ahead's handoff buffer and each local
    panel's 16 rows of the applied one. ``smem_bytes`` of dynamic shared
    memory a rank (a launch gives every rank the same). This is the one
    place that computes the layout: the kernels take it as it is."""
    variant: str
    C: int
    nb: int
    ld: int
    panels: tuple
    offsets: tuple
    recv_off: int
    recv_rows: int
    smem_bytes: int


CHOL_CLUSTER_SIZES = (4, 8, 16)   # the cluster sizes K10's geometry tries, in order


def chol_deal(n: int, C: int, nb: int = CHOL_CLUSTER_NB):
    """K10's deal of an n x n lane over C ranks: panel p of nb columns to
    rank p % C (rank r's panels r, r + C, ..)."""
    P = -(-n // nb)
    return tuple(tuple(range(r, P, C)) for r in range(C))


def chol_cluster_layout(n: int, C: int) -> Optional[CholGeometry]:
    """K10's cluster layout of an n x n lane over min(C, panels) CTAs, or None
    where a rank's panels and the receive buffer do not fit one block's
    shared memory."""
    nb = CHOL_CLUSTER_NB
    P = -(-n // nb)
    C = min(C, P)
    ld = block_ld(nb)
    panels = chol_deal(n, C)
    offsets = tuple(tuple(itertools.accumulate([n - p * nb for p in ps[:-1]], initial=0))
                    for ps in panels)
    rows = max(sum(n - p * nb for p in ps) for ps in panels)
    recv = n - nb if P > 1 else 0
    smem = 8 * ld * (rows + recv)
    if smem + CHOL_STATIC_SMEM > SMEM_PER_BLOCK:
        return None
    return CholGeometry('cluster', C, nb, ld, panels, offsets, rows * ld, recv, smem)


def chol_stream_layout(n: int) -> Optional[CholGeometry]:
    """K10's stream layout of an n x n lane over 16 CTAs, or None where a rank
    would own more than CHOL_STREAM_LOCAL panels (n > 1536). Each rank keeps
    its last panels in shared memory, as many as ``cap`` rows hold (the
    kernel's k10s_first_resident), and the others in L."""
    nb, C, ld = CHOL_CLUSTER_NB, CHOL_CLUSTER_MAX, block_ld(CHOL_CLUSTER_NB)
    P = -(-n // nb)
    if P > C * CHOL_STREAM_LOCAL:
        return None
    fixed = CHOL_STREAM_CHUNK + CHOL_STREAM_HEAD + nb * CHOL_STREAM_LOCAL
    cap = (SMEM_PER_BLOCK - CHOL_STATIC_SMEM) // (8 * ld) - fixed
    panels = chol_deal(n, C)
    offsets = []
    for ps in panels:
        rows = [n - p * nb for p in ps]
        t_res = len(ps)
        while t_res > 0 and sum(rows[t_res - 1:]) <= cap:
            t_res -= 1
        offs = list(itertools.accumulate(rows[t_res:-1], initial=0)) if t_res < len(ps) else []
        offsets.append(tuple([None] * t_res + offs))
    return CholGeometry('stream', C, nb, ld, panels, tuple(offsets), cap * ld, CHOL_STREAM_CHUNK,
                        8 * ld * (cap + fixed))


def chol_factor_geometry(n: int) -> CholGeometry:
    """K10's variant and layout for n x n lanes: the cluster variant with the
    fewest CTAs of CHOL_CLUSTER_SIZES (4, 8, 16; never more than the lane has
    panels of 16) whose ranks hold the lower triangle and a receive buffer in
    one block's shared memory (n <= 344: 4; <= 443: 8; <= 554: 16): the
    factor is bound by its chain of pivots, which more CTAs a lane do not
    shorten, while fewer let more lanes run at once; else the stream variant
    (16 CTAs, the lane in the L2) while a rank owns at most 6 panels (n <=
    1536); beyond that it raises by name."""
    for C in CHOL_CLUSTER_SIZES:
        geom = chol_cluster_layout(n, C)
        if geom is not None:
            return geom
    geom = chol_stream_layout(n)
    if geom is None:
        raise ValueError(f'chol_factor_batched: n={n} fits no variant of K10 (the stream '
                         f'variant takes n <= {CHOL_STREAM_MAX})')
    return geom


def chol_factor_batched(M):
    """(B, n, n) f64 -> (L (B, n, n) f64, lower with zeros above, ok (B,)
    bool), as chol_factor_batched_plain; a lane whose pivot is <= 0 or not
    finite, or whose L has a non-finite entry, gets ok False and an L of
    NaN, and the other lanes' bits do not depend on it. Only M's lower
    triangle is read. On the card one launch of the variant
    chol_factor_geometry(n) gives, a thread-block cluster per lane, panels
    of 16 and the trailing update by f64 tensor-core MMAs: the lower
    triangle in the cluster's shared memory; or, for lanes no cluster
    holds, the lane in the L2 with each rank's last panels in its shared
    memory."""
    if not M.is_cuda:
        return chol_factor_batched_plain(M)
    name = 'chol_factor_batched'
    _require(name, (M, torch.float64))
    B, n, n2 = M.shape
    if n != n2:
        raise ValueError(f'{name}: square matrices expected')
    geom = chol_factor_geometry(n)
    L = torch.empty_like(M)
    ok = torch.empty(B, dtype=torch.bool, device=M.device)
    cluster_max_active(f'chol_factor_{geom.variant}', geom)
    if geom.variant == 'cluster':
        _check(name, library().chol_factor_cluster(_ptr(M), _ptr(L), _ptr(ok), B, n, geom.C,
                                                   geom.ld, geom.recv_off, geom.smem_bytes,
                                                   _stream()))
    else:
        _check(name, library().chol_factor_stream(_ptr(M), _ptr(L), _ptr(ok), B, n, geom.C,
                                                  geom.ld, geom.recv_off // geom.ld,
                                                  geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    LAUNCHES[f'chol_factor_{geom.variant}'] += 1
    return L, ok


def chol_solve_batched_plain(L, b):
    """(B, n, n) lower factor, (B, n) -> L^-T L^-1 b (batch.py:234-236)."""
    t = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), t, upper=True)[..., 0]


CHOL_SOLVE_SLOTS = 4 + 7 * 2   # K11's ring (K11_RING): warp 0's four, two for each other warp


def chol_solve_geometry(n: int) -> int:
    """K11's dynamic shared memory at n, bytes: the ring of CHOL_SOLVE_SLOTS
    tiles and the vector with the reciprocals of L's diagonal, each 32
    ceil(n / 32) doubles (156,672 + 4,608 B at n = 280); raises by name where
    that does not fit one block (n > ~4,700)."""
    smem = CHOL_SOLVE_SLOTS * SUBST_TILE_BYTES + 16 * SUBST_NB * -(-n // SUBST_NB)
    if smem + SUBST_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'chol_solve_batched: n={n} needs {smem} B of shared memory, more than '
                         f'one block has')
    return smem


def chol_solve_batched(L, b):
    """(B, n, n) f64, (B, n) f64 -> (B, n) f64, as chol_solve_batched_plain.
    On the card one launch, a CTA per lane: both substitutions in tiles of
    32, the vector in shared memory, L streamed through rings of tile slots
    (chol_solve_geometry) and read once a substitution."""
    if not L.is_cuda:
        return chol_solve_batched_plain(L, b)
    name = 'chol_solve_batched'
    f64 = torch.float64
    _require(name, (L, f64), (b, f64))
    B, n, _ = L.shape
    if b.shape != (B, n) or L.shape != (B, n, n):
        raise ValueError(f'{name}: inconsistent shapes')
    smem = chol_solve_geometry(n)
    x = torch.empty_like(b)
    _check(name, library().chol_solve_batched(_ptr(L), _ptr(b), _ptr(x), B, n, smem, _stream()))
    LAUNCHES[name] += 1
    return x


# --- K12, K13: the host solver's f64 LU factor and solve ---------------------

def lu_factor_f64_plain(K):
    """(B, N, N) f64 -> (lu, piv (B, N) int32): partial-pivot LU with LAPACK
    getrf's semantics and 1-based pivots; a singular factor is returned, not
    raised, so inf/NaN reach the solve."""
    lu, piv, _ = torch.linalg.lu_factor_ex(K)
    return lu, piv


# (B at most, C): K12's and K13's CTAs a lane follow the batch, so that B clusters run in
# one wave (an H100 runs 7 clusters of 16 at once and 15 of 8, one CTA an SM)
LU64_SOLVE_CLUSTERS = ((7, 16), (15, 8), (30, 4), (66, 2))


LU64_NB = 16                # panel width of K12 (K12_NB)
LU64_THREADS = 512          # threads of a rank (K12_THREADS)
LU64_WHOLE = 1024           # panel rows one chain of 16 columns holds (K12_WHOLE)
LU64_LAST = 2560            # panel rows a chain of 8 holds (K12_LAST): K12's reach
LU64_CHUNK = 256            # rows of L21 staged at a time (K12_CHUNK)
LU64_CHUNK_LD = 20          # their leading dimension (K12_LDC)
LU64_GROUP = 10             # panels a rank's pass takes (K12_GROUP)
LU64_RING = 2               # a warp's tile pairs in flight in a pass (K12_RING)
LU64_RING_AHEAD = 2         # and in the look-ahead, with their rows of L21 (K12_RING_AHEAD)
LU64_STATIC_SMEM = 8_192    # room for the kernel's static shared arrays (K12Shared, ~7 KB)


class LU64Geometry(NamedTuple):
    """How K12 lays one lane out: a thread-block cluster of ``C`` CTAs, panel
    p of 16 columns to rank p % C, the lane in a work buffer in the L2; a
    panel of more than LU64_WHOLE rows factored in two halves of 8;
    ``smem_bytes`` of dynamic shared memory a rank (the U12 blocks of a
    pass, the applied diagonal block, and the staged L21 with the warps'
    rings of tile pairs in flight, or the look-ahead's rings, or a right
    half)."""
    C: int
    smem_bytes: int


def lu_factor_f64_geometry(N: int, B: int = 1) -> LU64Geometry:
    """K12's layout for B lanes of N x N (C follows the batch as K13's:
    16 up to B = 7, 8 up to 15, .., never more than the lane's panels;
    169,984 B a rank, the look-ahead's rings of two tile pairs with their
    L21 rows, to N = 2304, and a right half's 8 N doubles past it: 171,968
    B at N = 2335); raises by name
    where a panel's rows exceed what a half-panel chain holds (N > 2560)."""
    if N > LU64_LAST:
        raise ValueError(f'lu_factor_f64: N={N} is beyond K12 (a half panel of {N} rows; '
                         f'its chain holds {LU64_LAST})')
    P = -(-N // LU64_NB)
    C = next((c for most, c in LU64_SOLVE_CLUSTERS if B <= most), 1)
    return LU64Geometry(min(C, P), lu_factor_f64_smem(N))


def lu_factor_f64_smem(N: int, ring: int = LU64_RING, ahead: int = LU64_RING_AHEAD) -> int:
    """K12's dynamic shared memory a rank at N (the launcher's k12_smem_bytes,
    which refuses less), with ``ring`` tile pairs in flight a warp in a pass
    and ``ahead`` in the look-ahead."""
    rest = 8 * N if N > LU64_WHOLE else 0
    old, lrows = 4 * 32 * 2, 16 * LU64_CHUNK_LD   # a warp's A22 pieces and L21 rows of a pair
    passes = LU64_CHUNK * LU64_CHUNK_LD + 16 * ring * old
    return 8 * (LU64_GROUP * 256 + 256 + max(passes, 16 * ahead * (old + lrows), rest))


def lu_factor_f64(K):
    """(B, N, N) f64 -> (lu, piv (B, N) int32), as lu_factor_f64_plain. K is
    not changed. On the card one launch, a thread-block cluster a lane
    (lu_factor_f64_geometry): the panels of 16 columns dealt over the ranks
    in a work buffer, each panel's chain on its owner after the look-ahead
    update by the panel before, the trailing updates on the f64 tensor
    cores, the factor copied out to lu."""
    if not K.is_cuda:
        return lu_factor_f64_plain(K)
    name = 'lu_factor_f64'
    _require(name, (K, torch.float64))
    B, N, N2 = K.shape
    if N != N2:
        raise ValueError(f'{name}: square matrices expected')
    geom = lu_factor_f64_geometry(N, B)
    cluster_max_active('lu_factor_f64', geom)
    lu = torch.empty_like(K)
    piv = torch.empty(B, N, dtype=torch.int32, device=K.device)
    work = torch.empty(B, -(-N // LU64_NB), N, LU64_NB, dtype=torch.float64, device=K.device)
    _check(name, library().lu_factor_f64(_ptr(K), _ptr(lu), _ptr(piv), _ptr(work), B, N, geom.C,
                                         geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return lu, piv


def lu_solve_f64_plain(lu, piv, b):
    """(B, N, N) f64 factor, (B, N) int32 pivots, (B, N) f64 -> (B, N) f64."""
    return torch.linalg.lu_solve(lu, piv, b[:, :, None])[:, :, 0]


class LUSolve64Geometry(NamedTuple):
    """How K13 lays a lane out: a thread-block cluster of ``C`` CTAs, row
    tile i (32 rows) to rank i % C, each rank with K11's ring of
    CHOL_SOLVE_SLOTS tile slots (which hold the interchanges' three int
    arrays before the rings start), the vector, the reciprocals of U's
    diagonal, the fold buffers (in and out) and 2 ceil(N / 32) mbarriers in
    ``smem_bytes`` of dynamic shared memory."""
    C: int
    smem_bytes: int


def lu_solve_f64_geometry(N: int, B: int = 1) -> LUSolve64Geometry:
    """K13's layout at N for B lanes (166,160 B a rank at N = 543: C = 16 up
    to B = 7, 8 up to 15, 4 up to 30, 2 up to 66, else 1, never more than
    the lane has row tiles); raises by name where it does not fit one block
    (N > ~4,500)."""
    T = -(-N // SUBST_NB)
    rows = SUBST_NB * T
    ring = CHOL_SOLVE_SLOTS * SUBST_TILE_BYTES
    smem = ring + 16 * rows + 16 * SUBST_NB + 16 * T
    if smem + SUBST_STATIC_SMEM > SMEM_PER_BLOCK or 12 * rows > ring:
        raise ValueError(f'lu_solve_f64: N={N} needs {smem} B of shared memory, more than one '
                         f'block has')
    C = next((c for most, c in LU64_SOLVE_CLUSTERS if B <= most), 1)
    return LUSolve64Geometry(min(C, T), smem)


def lu_solve_f64(lu, piv, b):
    """(B, N, N) f64, (B, N) int32, (B, N) f64 -> (B, N) f64, as
    lu_solve_f64_plain. On the card one launch, a thread-block cluster per
    lane (lu_solve_f64_geometry): the interchanges composed 32 at a time,
    then the unit-lower and the upper substitution in tiles of 32, the row
    tiles dealt over the ranks, each chain on its row tile's owner and its
    result handed on through distributed shared memory."""
    if not lu.is_cuda:
        return lu_solve_f64_plain(lu, piv, b)
    name = 'lu_solve_f64'
    _require(name, (lu, torch.float64), (piv, torch.int32), (b, torch.float64))
    B, N, _ = lu.shape
    if lu.shape != (B, N, N) or piv.shape != (B, N) or b.shape != (B, N):
        raise ValueError(f'{name}: inconsistent shapes')
    geom = lu_solve_f64_geometry(N, B)
    cluster_max_active('lu_solve_f64', geom)
    x = torch.empty_like(b)
    _check(name, library().lu_solve_f64(_ptr(lu), _ptr(piv), _ptr(b), _ptr(x), B, N, geom.C,
                                        geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return x


def launch_floor():
    """Launches the empty kernel once: the least a launch costs, the floor
    that chip_smoke.py times beside K1-K7. Not counted in LAUNCHES."""
    _check('noop', library().noop(1, _stream()))
