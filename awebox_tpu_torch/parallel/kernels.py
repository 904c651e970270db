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
qr_factor_batched      jnp.linalg.qr, :382, as packed Householder    f32
                       reflectors (cluster or blocked variant, by N)
qr_solve_batched       msolve = R^-1 Q^T v, :344-346                 f32
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

# newton_kkt counts its kernel pair once; lu_factor_batched counts every
# factor, lu_factor_cluster and lu_factor_blocked say which of K2's two
# variants ran (a blocked factor's launches a panel are counted once);
# likewise qr_factor_batched with qr_factor_cluster and qr_factor_blocked;
# ruiz_scale counts its three sweeps and its scaling pass once
LAUNCHES = {'newton_kkt': 0, 'kkt_assemble_scaled': 0, 'lu_factor_batched': 0,
            'lu_factor_cluster': 0, 'lu_factor_blocked': 0,
            'lu_solve_batched': 0, 'ip_step': 0,
            'kkt_assemble': 0, 'ruiz_scale': 0, 'qr_factor_batched': 0,
            'qr_factor_cluster': 0, 'qr_factor_blocked': 0, 'qr_solve_batched': 0}

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
    'ruiz_scale': [_P] * 5 + [_I] * 2 + [_P],
    'qr_factor_cluster_occupancy': [_I, _I, _P],
    'qr_factor_cluster': [_P] * 3 + [_I] * 6 + [_P],
    'qr_factor_blocked': [_P] * 5 + [_I] * 4 + [_P],
    'qr_solve_batched': [_P] * 4 + [_I] * 4 + [_P],
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


def advance_state(state, direction, ok, err_d, err_kkt, lbw, ubw,
                  tau, kappa_mu, mu_min):
    """Fraction-to-boundary step + dual safeguards + adaptive mu, batched
    over lanes (batch.py:449-512); ``err`` of the result is ``err_kkt``.
    Plain PyTorch: on the card it runs inside ip_step's kernel."""
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
    return advance_state(state, (dw, dy, dlam, ds, dzl, dzu), ok, err_d,
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


# --- K5 ----------------------------------------------------------------------

RUIZ_SWEEPS = 3             # as batch.py:377; csrc/auglu.cu's ruiz_scale launches as many


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


def ruiz_scale(K):
    """(B,N,N) f32 -> (M (B,N,N), s (B,N)) f32, equal to ruiz_scale_plain bit
    for bit (a maximum, one square root and one division a row, two
    products an entry, each rounded as PyTorch rounds them): three sweep
    launches, a warp per row, then one pass that writes M."""
    if not K.is_cuda:
        return ruiz_scale_plain(K)
    name = 'ruiz_scale'
    _require(name, (K, torch.float32))
    B, N, N2 = K.shape
    if N != N2:
        raise ValueError(f'{name}: square matrices expected')
    M = torch.empty_like(K)
    s = torch.empty(B, N, dtype=torch.float32, device=K.device)
    s_a, s_b = torch.empty_like(s), torch.empty_like(s)
    _check(name, library().ruiz_scale(_ptr(K), _ptr(M), _ptr(s), _ptr(s_a), _ptr(s_b), B, N,
                                      _stream()))
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


def qr_factor_geometry(N: int) -> QRGeometry:
    """K6's variant and layout for N x N lanes: the cluster variant when a
    lane fits the shared memory of LU_CLUSTER_MAX CTAs and a warp's
    registers hold a column, else the blocked one while a panel's N rows fit
    one block's; beyond that it raises."""
    panels = -(-N // QR_NB)
    C = min(LU_CLUSTER_MAX, panels)
    cols = -(-panels // C) * QR_NB
    ld = -(-N // 4) * 4           # float4 rows of the panel copy
    # f32: the CTA's columns and the current panel's reflectors
    smem = 4 * (cols * ld + QR_NB * ld)
    if N <= QR_ROW_MAX and smem + LU_STATIC_SMEM <= SMEM_PER_BLOCK:
        return QRGeometry('cluster', C, QR_NB, cols, ld, smem)
    lds = blocked_lds(N)
    smem = 4 * BLOCKED_NB * lds
    if smem + QR_PANEL_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f'qr_factor_batched: N={N} fits no variant of K6 (the blocked '
                         f'panel of {BLOCKED_NB} columns needs {smem} B of shared memory)')
    return QRGeometry('blocked', 1, BLOCKED_NB, BLOCKED_NB, lds, smem)


def qr_cluster_max_active(geom: QRGeometry) -> int:
    """Clusters of this geometry the card runs at once (asked once per
    geometry); raises if it cannot run one."""
    key = ('qr', geom.C, geom.smem_bytes)
    if key not in _max_clusters:
        count = ctypes.c_int(0)
        _check('qr_factor_cluster_occupancy', library().qr_factor_cluster_occupancy(
            geom.C, geom.smem_bytes, ctypes.byref(count)))
        if count.value < 1:
            raise RuntimeError(f'qr_factor_cluster: a cluster of {geom.C} CTAs with '
                               f'{geom.smem_bytes} B of shared memory each cannot be scheduled')
        _max_clusters[key] = count.value
    return _max_clusters[key]


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
        qr_cluster_max_active(geom)
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
QR_SOLVE_WARPS = (16, 8)    # warps per lane the kernel is compiled for, most first
QR_SOLVE_STATIC_SMEM = 5_120   # room for the kernel's static arrays (4480 B)


class QRSolveGeometry(NamedTuple):
    """How K7 lays one lane out: ``tiles`` panels of ``QR_SOLVE_NB``
    reflectors, then as many tile steps of the back substitution, by
    ``warps`` warps; ``smem_bytes`` of dynamic shared memory hold the
    right-hand side padded to whole tiles, a staged row of ``QR_SOLVE_LDV``
    f32 for each of its entries, and every warp's partial Gram matrix and
    partial V^T y."""
    tiles: int
    warps: int
    smem_bytes: int


def qr_solve_geometry(N: int) -> QRSolveGeometry:
    """K7's layout for N x N lanes: the most warps whose partial sums fit one
    block's shared memory beside the staged rows."""
    tiles = -(-N // QR_SOLVE_NB)
    rows = tiles * QR_SOLVE_NB
    for warps in QR_SOLVE_WARPS:
        smem = 4 * (rows * (1 + QR_SOLVE_LDV) + warps * QR_SOLVE_NB * (QR_SOLVE_LDV + 1))
        if smem + QR_SOLVE_STATIC_SMEM <= SMEM_PER_BLOCK:
            return QRSolveGeometry(tiles, warps, smem)
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
                                            geom.warps, geom.smem_bytes, _stream()))
    LAUNCHES[name] += 1
    return x


def launch_floor():
    """Launches the empty kernel once: the least a launch costs, the floor
    that chip_smoke.py times beside K1-K7. Not counted in LAUNCHES."""
    _check('noop', library().noop(1, _stream()))
