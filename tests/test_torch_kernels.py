"""The CUDA kernels of the PyTorch port (awebox_tpu_torch/parallel/kernels.py,
csrc/auglu.cu) against their plain PyTorch versions.

This file imports no JAX, so the card's machine, which has none, runs it:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX). The tests marked
``cuda`` skip without a card; the others check, on the CPU, what the kernels'
callers rely on there.
"""
import ctypes
import itertools
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
N_LADDER, LADDER = 7, 100.


def saddle_systems(lanes=5, n=24, m=17, seed=0):
    """Random saddle systems shaped like tests/test_batch_auglu.py's
    make_system: symmetric indefinite W0 with a barrier-like diagonal spread,
    rows of A over four decades, D of 1e-8 equality rows and small
    inequality rows. In the last lane variable 2 appears nowhere (zero row
    and column of W0, zero column of A), so K(delta) pins it only through
    delta: |dw_2| = |r1_2| / delta exceeds dw_cap until the delta ladder
    has raised delta, and that lane is retried alone."""
    rng = np.random.default_rng(seed)
    W0, A, D, r1, r2 = [], [], [], [], []
    for _ in range(lanes):
        Wh = rng.standard_normal((n, n))
        W0.append((Wh + Wh.T) / 2 + np.diag(10.0 ** rng.uniform(-2, 5, n)))
        A.append(rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-2, 2, (m, 1)))
        D.append(np.concatenate([1e-8 * np.ones(m - 5), np.abs(rng.standard_normal(5)) * 1e-3]))
        r1.append(rng.standard_normal(n))
        r2.append(rng.standard_normal(m))
    W0, A, D, r1, r2 = (np.stack(x) for x in (W0, A, D, r1, r2))
    W0[-1, 2, :] = 0.
    W0[-1, :, 2] = 0.
    A[-1, :, 2] = 0.
    return [torch.as_tensor(x) for x in (W0, A, D, r1, r2)] + [torch.ones(n, dtype=torch.float64)]


def random_step_inputs(B=4, n=40, n_eq=20, n_ineq=8, seed=17, device='cpu'):
    """advance_state inputs: f64 states with w within 1e-9 of finite lower
    bounds, pinned and infinite bounds, random directions, a failed lane."""
    rng = np.random.default_rng(seed)
    lbw = np.where(rng.uniform(size=n) < 0.7, -1.0, -np.inf)
    ubw = np.where(rng.uniform(size=n) < 0.5, 1.0, np.inf)
    w = np.clip(rng.uniform(-0.9, 0.9, (B, n)), -0.9, 0.9)
    w = np.where(np.isfinite(lbw) & (rng.uniform(size=(B, n)) < 0.3), lbw + 1e-9, w)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
    state = dict(w=t(w), s=t(np.abs(rng.standard_normal((B, n_ineq))) + 1e-6),
                 y=t(rng.standard_normal((B, n_eq))),
                 lam=t(np.abs(rng.standard_normal((B, n_ineq))) * 1e-2),
                 zl=t(np.abs(rng.standard_normal((B, n)))), zu=t(np.abs(rng.standard_normal((B, n)))),
                 mu=t([1e-5, 1e-3, 1e-7, 1e-2][:B]))
    direction = tuple(t(rng.standard_normal(shape)) for shape in
                      ((B, n), (B, n_eq), (B, n_ineq), (B, n_ineq), (B, n), (B, n)))
    ok = torch.as_tensor(np.arange(B) != 1, device=device)
    err_d, err_k = t(np.abs(rng.standard_normal(B))), t(np.abs(rng.standard_normal(B)))
    return (state, direction, ok, err_d, err_k, t(lbw), t(ubw), 0.99, 0.4, 1e-8)


def newton_inputs(B=3, n=40, n_eq=20, n_ineq=8, seed=5, device='cpu'):
    """newton_kkt and ip_step inputs (state, derivs_out, lbw, ubw, free):
    f32 JE, JI, H with NaN and inf entries and an all-zero row of JE, f64
    gradf, cE, cI with non-finite entries, pinned variables (free = 0),
    infinite bounds, w within 1e-9 of finite lower bounds, a lam below its
    1e-12 floor, rows of J over six decades and H over five."""
    rng = np.random.default_rng(seed)
    lbw = np.where(rng.uniform(size=n) < 0.6, -1.0, -np.inf)
    ubw = np.where(rng.uniform(size=n) < 0.5, 1.0, np.inf)
    free = (rng.uniform(size=n) > 0.15).astype(float)
    free[0] = 0.
    w = rng.uniform(-0.9, 0.9, (B, n))
    w = np.where(np.isfinite(lbw) & (rng.uniform(size=(B, n)) < 0.3), lbw + 1e-9, w)
    H = rng.standard_normal((B, n, n)) * 10.0 ** rng.uniform(-2, 3, (B, n, 1))
    JE = rng.standard_normal((B, n_eq, n)) * 10.0 ** rng.uniform(-3, 3, (B, n_eq, 1))
    JI = rng.standard_normal((B, n_ineq, n)) * 10.0 ** rng.uniform(-3, 3, (B, n_ineq, 1))
    gradf, cE, cI = (rng.standard_normal((B, k)) for k in (n, n_eq, n_ineq))
    H[0, 3, 5], H[-1, 2, 2], JE[0, 1, 4], JI[-1, 0, 6] = np.nan, np.inf, -np.inf, np.nan
    JE[-1, 5, :] = 0.
    gradf[0, 7], cE[-1, 3], cI[0, 1] = np.nan, np.inf, np.nan
    lam = np.abs(rng.standard_normal((B, n_ineq))) * 1e-2
    lam[0, 2] = 1e-14
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
    state = dict(w=f64(w), s=f64(np.abs(rng.standard_normal((B, n_ineq))) + 1e-6),
                 y=f64(rng.standard_normal((B, n_eq))), lam=f64(lam),
                 zl=f64(np.abs(rng.standard_normal((B, n)))),
                 zu=f64(np.abs(rng.standard_normal((B, n)))),
                 mu=f64(10.0 ** rng.uniform(-7, -2, B)))
    derivs = (f64(np.zeros(B)), f64(gradf), f64(cE), f64(cI), f32(JE), f32(JI), f32(H))
    return state, derivs, f64(lbw), f64(ubw), f64(free)


def step_solution(B, N, seed=6, device='cpu'):
    """A solution x (B, N) f64 of the scaled system with a NaN entry, and ok
    (B,) with lane 1 failed, for ip_step."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N)) * 10.0 ** rng.uniform(-3, 1, (B, N))
    x[0, 3] = np.nan
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(np.arange(B) != 1, device=device))


# ip_step against its plain version: the kernel sums JI dw in another order
# than the plain product, so ds agrees to 1e-13 of the sum's scale
# |cI + s| + |JI| |dw| (n f64 roundings, ~3e-14 at n = 280). alpha takes
# ds's ratio -tau s / ds where that is the least, so it agrees to the same
# relative order, and w, y, s (old + alpha d) agree to 1e-12 of
# |old| + |new - old|; zl and zu to 1e-10 relative: the corridor divides by
# the new dl, which the fraction-to-boundary rule keeps above (1 - tau) of
# its old value, amplifying alpha's gap by up to tau / (1 - tau) = 99.
# lam, mu and err do not depend on ds: 1e-14 relative (the same f64
# operations in the same order).
TOL_STEP = {'w': 1e-12, 'y': 1e-12, 's': 1e-12, 'zl': 1e-10, 'zu': 1e-10,
            'lam': 1e-14, 'mu': 1e-14, 'err': 1e-14}
TOL_DS = 1e-13


def gap_over(a, a_p, tol_scale):
    """max |a - a_p| / tol_scale over the entries where a and a_p differ;
    equal entries (both NaN, or the same infinity, included) count 0, and an
    entry NaN on one side only, or that no finite tolerance covers, counts
    inf, so a stray NaN never passes."""
    same = (a == a_p) | (torch.isnan(a) & torch.isnan(a_p))
    gap = torch.where(same, 0., (a - a_p).abs() / tol_scale)
    return float(torch.nan_to_num(gap, nan=float('inf')).max())


def step_gaps(out, out_p, state, ds, ds_p, x, ok, derivs, free):
    """The largest gap of ip_step's outputs from the plain version's, each
    over its tolerance (<= 1 passes): per TOL_STEP and TOL_DS above."""
    gaps = {}
    for k, tol in TOL_STEP.items():
        if k in ('w', 'y', 's'):
            scale = state[k].abs() + (out_p[k] - state[k]).abs()
        else:
            scale = out_p[k].abs()
        gaps[k] = gap_over(out[k], out_p[k], tol * scale)
    n = free.shape[0]
    dw = x[:, :n] * free
    dw = torch.where(ok[:, None] & torch.isfinite(dw), dw, 0.)
    fin = lambda t: torch.where(torch.isfinite(t), t, 0.)
    cI, JI = fin(derivs[3]), fin(derivs[5]).double()
    scale = (cI + state['s']).abs() + (JI.abs() @ dw.abs()[:, :, None])[:, :, 0]
    gaps['ds'] = gap_over(ds, ds_p, TOL_DS * scale)
    return gaps


def step_within_tolerance(gaps):
    """Every gap of step_gaps within its tolerance."""
    return all(g <= 1. for g in gaps.values())


def kkt_tile_mirror(state, derivs_out, lbw, ubw, free, delta_w, delta_c, nb=32):
    """Plain-PyTorch mirror of csrc/auglu.cu's newton_kkt on the CPU with the
    kernel's bookkeeping: phase 1 a row of [JE; JI] at a time (A', rn, Dr32,
    kd of the dual rows) and the variables' diagonal W0_jj and kd; phase 2
    in 32x32 tiles, each entry of a tile by its region (W0 + delta diag(free)
    with the diagonal from phase 1, A'^T read transposed from the tile of A'
    rows that its columns name, A', -diag(Dr32)) and scaled by the tile's
    kd. Every entry starts as NaN, so one that no tile writes shows. Returns
    Ks, kd, W64, A64."""
    _, _, _, _, JE, JI, H = derivs_out
    f32, f64 = torch.float32, torch.float64
    B, n = state['w'].shape
    n_eq, n_ineq = JE.shape[1], JI.shape[1]
    m = n_eq + n_ineq
    N, T = n + m, -(-(n + m) // nb)
    fin = lambda t: torch.where(torch.isfinite(t), t, 0.)
    jacobi = lambda d: torch.clamp(1.0 / torch.sqrt(torch.clamp(d, min=1e-8)), 0., 1e4)
    nan = float('nan')
    Ks = torch.full((B, N, N), nan, dtype=f32)
    kd = torch.full((B, N), nan, dtype=f32)
    W64, A64 = torch.full((B, n, n), nan, dtype=f64), torch.full((B, m, n), nan, dtype=f64)
    rn32, Dr = torch.empty(B, m, dtype=f32), torch.empty(B, m, dtype=f32)
    d32 = torch.tensor(delta_w, dtype=f64).to(f32)
    free32 = free.to(f32)

    def a_prime(lane, r, c):
        row = JE[lane, r] if r < n_eq else JI[lane, r - n_eq]
        return (fin(row[c]).to(f64) * free[c]).to(f32) * rn32[lane, r]

    for lane in range(B):
        for i in range(m):                 # phase 1: a warp per constraint row
            row = JE[lane, i] if i < n_eq else JI[lane, i - n_eq]
            a = fin(row).to(f64) * free
            rn32[lane, i] = torch.clamp(1.0 / torch.clamp(a.abs().max(), 1e-10, 1e10), 0., 1e6)
            A64[lane, i] = (a.to(f32) * rn32[lane, i]).to(f64)
            if i < n_eq:
                D = torch.tensor(delta_c, dtype=f64)
            else:
                q = i - n_eq
                D = state['s'][lane, q] / torch.clamp(state['lam'][lane, q], min=1e-12) + delta_c
            rn = rn32[lane, i].to(f64)
            Dr[lane, i] = (D * rn * rn + delta_c).to(f32)
            kd[lane, n + i] = jacobi(Dr[lane, i])
        w, zl, zu = (state[k][lane] for k in ('w', 'zl', 'zu'))   # a thread per variable
        dl, du = torch.clamp(w - lbw, min=1e-20), torch.clamp(ubw - w, min=1e-20)
        sigma = torch.clamp(zl / dl + zu / du, 0., 1e16)
        diag = ((fin(torch.diagonal(H[lane])).to(f64) + sigma) * (free * free)
                + (1. - free)).to(f32)
        kd[lane, :n] = jacobi(torch.abs(diag + d32 * free32))
        for ti in range(T):                # phase 2: the tiles
            for tj in range(T):
                i0, j0 = ti * nb, tj * nb
                kdr, kdc = kd[lane, i0:i0 + nb], kd[lane, j0:j0 + nb]
                at = torch.full((nb, nb), nan, dtype=f32)
                if i0 < n and j0 + nb > n:
                    c = torch.arange(i0, min(i0 + nb, n))
                    for k in range(nb):
                        if n <= j0 + k < N:
                            at[k, :len(c)] = a_prime(lane, j0 + k - n, c)
                j = torch.arange(j0, min(j0 + nb, N))
                tx = j - j0
                for r in range(min(nb, N - i0)):
                    i = i0 + r
                    k = torch.empty(len(j), dtype=f32)
                    left = j < n
                    if i < n:
                        jw = j[left]
                        h = fin(H[lane, i, jw]).to(f64)
                        wv = ((h + 0.) * (free[i] * free[jw]) + 0.).to(f32)
                        wv = torch.where(jw == i, diag[i], wv)
                        W64[lane, i, jw] = wv.to(f64)
                        k[left] = wv + d32 * torch.where(jw == i, free32[i], 0.)
                        k[~left] = at[tx[~left], r]
                    else:
                        k[left] = a_prime(lane, i - n, j[left])
                        k[~left] = torch.where(j[~left] == i, -Dr[lane, i - n], -0.)
                    Ks[lane, i, j] = k * kdr[r] * kdc[tx]
    return Ks, kd, W64, A64


def cluster_lu_mirror(A, C=8, nb=16):
    """Plain-PyTorch mirror of csrc/auglu.cu's lu_factor_cluster_kernel on
    one (N, N) f32 matrix, with the kernel's bookkeeping: panel g of nb
    columns lives on owner g % C as its local panel g // C; per panel the
    owner factors it (first largest |a|, NaN never chosen, a NaN column keeps
    the diagonal, no clamp of a zero pivot), then every owner applies the
    panel's row swaps to all its columns but the panel itself, solves its
    U12 block and applies the rank-nb update to its trailing local panels
    (those from lp_start on). Returns (lu, piv) like lu_factor_ex."""
    N = A.shape[0]
    panels = -(-N // nb)
    C = min(C, panels)
    n_local = [(panels - r + C - 1) // C for r in range(C)]
    local = []
    for r in range(C):
        X = torch.zeros(N, n_local[r] * nb, dtype=A.dtype)
        for lp in range(n_local[r]):
            g0 = (lp * C + r) * nb
            w = min(nb, N - g0)
            X[:, lp * nb:lp * nb + w] = A[:, g0:g0 + w]
        local.append(X)
    piv = torch.empty(N, dtype=torch.int32)
    for p in range(panels):
        owner, lpo, p0 = p % C, p // C, p * nb
        w = min(nb, N - p0)
        P = local[owner][:, lpo * nb:lpo * nb + w]
        s_piv = []
        for k in range(w):
            gk = p0 + k
            a = P[gk:, k].abs()
            a = torch.where(torch.isnan(a), torch.tensor(-1., dtype=a.dtype), a)
            pr = gk + int(torch.argmax(a)) if float(a.max()) >= 0 else gk
            if pr != gk:
                P[[gk, pr], :] = P[[pr, gk], :]
            s_piv.append(pr)
            piv[gk] = pr + 1
            P[gk + 1:, k] = P[gk + 1:, k] / P[gk, k]
            P[gk + 1:, k + 1:] -= P[gk + 1:, k:k + 1] * P[gk:gk + 1, k + 1:]
        L = P[p0:, :].clone()
        for r in range(C):
            X = local[r]
            keep = torch.ones(X.shape[1], dtype=torch.bool)
            if r == owner:
                keep[lpo * nb:lpo * nb + w] = False
            for k, pr in enumerate(s_piv):
                if pr != p0 + k:
                    rows = X[[p0 + k, pr], :]
                    X[[pr, p0 + k], :] = torch.where(keep, rows, X[[pr, p0 + k], :])
            lp_start = 0 if p < r else (p - r) // C + 1
            c0 = lp_start * nb
            if c0 < X.shape[1]:
                U = torch.linalg.solve_triangular(L[:w, :w], X[p0:p0 + w, c0:],
                                                  upper=False, unitriangular=True)
                X[p0:p0 + w, c0:] = U
                X[p0 + w:, c0:] -= L[w:, :] @ U
    lu = torch.empty_like(A)
    for r in range(C):
        for lp in range(n_local[r]):
            g0 = (lp * C + r) * nb
            w = min(nb, N - g0)
            lu[:, g0:g0 + w] = local[r][:, lp * nb:lp * nb + w]
    return lu, piv


def chunk_permutation(piv, N, nb=32):
    """csrc/auglu.cu's lu_solve_kernel pivot handling on arange(N): per chunk
    of nb interchanges, every row k of the chunk and its pivot row p_k take
    the rows found by tracing them back through the chunk's swaps (rows past
    N swap with themselves), applied chunk after chunk as gathers. Returns
    perm with (P b)[i] = b[perm[i]]."""
    T = -(-N // nb)
    p = [int(piv[k]) - 1 if k < N else k for k in range(T * nb)]
    perm = list(range(T * nb))
    for c in range(T):
        ks = range(c * nb, (c + 1) * nb)
        src = {}
        for k in ks:
            for start in (k, p[k]):
                r = start
                for q in reversed(ks):
                    r = p[q] if r == q else (q if r == p[q] else r)
                src[start] = r
        vals = {dst: perm[r] for dst, r in src.items()}   # gathered before any write
        for dst, val in vals.items():
            if dst < N:
                perm[dst] = val
    return torch.tensor(perm[:N])


def sequential_permutation(piv, N):
    """LAPACK's laswp: the interchanges applied one by one to arange(N)."""
    perm = list(range(N))
    for k in range(N):
        p = int(piv[k]) - 1
        perm[k], perm[p] = perm[p], perm[k]
    return torch.tensor(perm)


def tiled_solve_mirror(lu, piv, kd, v, nb=32):
    """Plain-PyTorch mirror of lu_solve_kernel on one lane, f32: y = P (kd v)
    by chunk_permutation; forward over column tiles of the unit-lower L, then
    back over column tiles of U from the last (ragged) one, each tile solved
    column by column (times the reciprocal of U's diagonal) and then applied to the rows
    below (above) column by column, the kernel's order of operations apart
    from its fused multiply-adds. Returns kd * y."""
    N = lu.shape[0]
    T = -(-N // nb)
    y = (kd * v)[chunk_permutation(piv, N, nb)].clone()
    for t in range(T):
        r0, r1 = t * nb, min(N, (t + 1) * nb)
        for k in range(r0, r1):
            y[k + 1:r1] -= lu[k + 1:r1, k] * y[k]
        for k in range(r0, r1):
            y[r1:] -= lu[r1:, k] * y[k]
    for t in reversed(range(T)):
        r0, r1 = t * nb, min(N, (t + 1) * nb)
        for k in reversed(range(r0, r1)):
            y[k] = y[k] * (1 / lu[k, k])
            y[r0:k] -= lu[r0:k, k] * y[k]
        for k in range(r0, r1):
            y[:r0] -= lu[:r0, k] * y[k]
    return kd * y


def larfg(alpha, x):
    """csrc/auglu.cu's larfg on one column in f32: (beta, tau, v) with
    beta = -sign(alpha) sqrt(alpha^2 + |x|^2), tau = (beta - alpha) / beta,
    v = x / (alpha - beta); a zero x gives tau = 0 (H = I)."""
    x2 = (x * x).sum()
    if float(x2) == 0.:
        return alpha, torch.zeros((), dtype=x.dtype), x
    beta = -torch.copysign(torch.sqrt(alpha * alpha + x2), alpha)
    return beta, (beta - alpha) / beta, x * (1.0 / (alpha - beta))


def panel_t(V, tau):
    """larft's forward recurrence on a panel's masked reflectors V (rows, w)
    and taus: T[k, k] = tau_k, T[:k, k] = -tau_k T[:k, :k] G[:k, k] with
    G = V^T V, so that H_0 .. H_{w-1} = I - V T V^T."""
    w = V.shape[1]
    G = V.T @ V
    T = torch.zeros(w, w, dtype=V.dtype)
    for k in range(w):
        T[k, k] = tau[k]
        T[:k, k] = -tau[k] * (T[:k, :k] @ G[:k, k])
    return T


def qr_panel_mirror(P, g0, w):
    """csrc/auglu.cu's panel factor on the local columns P (N, >= w) of a
    panel whose first global column and diagonal row is g0: a reflector at a
    time (larfg), each applied to the panel's later columns. Returns the
    taus, the masked reflectors V (N, nb: an explicit 1 on the diagonal,
    zeros above it and past w) and T (nb, nb, zeros past w)."""
    N, nb = P.shape[0], P.shape[1]
    tau = torch.zeros(nb, dtype=P.dtype)
    for k in range(w):
        gk = g0 + k
        beta, tau[k], v = larfg(P[gk, k], P[gk + 1:, k])
        P[gk, k] = beta
        P[gk + 1:, k] = v
        vv = torch.cat([torch.ones(1, dtype=P.dtype), v])
        P[gk:, k + 1:w] -= tau[k] * vv[:, None] * (vv @ P[gk:, k + 1:w])[None, :]
    V = torch.zeros(N, nb, dtype=P.dtype)
    for k in range(w):
        V[g0 + k, k] = 1.
        V[g0 + k + 1:, k] = P[g0 + k + 1:, k]
    return tau, V, panel_t(V, tau)


def cluster_qr_mirror(A, C=None, nb=16):
    """Plain-PyTorch mirror of csrc/auglu.cu's qr_factor_cluster_kernel on
    one (N, N) f32 matrix, with the kernel's bookkeeping and order: panel g
    of nb columns lives on owner g % C (C: kernels.qr_factor_geometry's by
    default) as its local panel g // C. The owner of panel p + 1 first
    applies panel p to that panel alone, factors it (qr_panel_mirror: G and
    larft's T) and publishes it; then every owner applies panel p to its
    other trailing local panels (those from lp_start on, rows p0 and below)
    as one block reflector: W = V^T A, Y = T^T W, A -= V Y. Returns (qr,
    tau) like torch.geqrf."""
    from awebox_tpu_torch.parallel import kernels
    N = A.shape[0]
    panels = -(-N // nb)
    C = min(kernels.qr_factor_geometry(N).C if C is None else C, panels)
    n_local = [(panels - r + C - 1) // C for r in range(C)]
    local = []
    for r in range(C):
        X = torch.zeros(N, n_local[r] * nb, dtype=A.dtype)
        for lp in range(n_local[r]):
            g0 = (lp * C + r) * nb
            w = min(nb, N - g0)
            X[:, lp * nb:lp * nb + w] = A[:, g0:g0 + w]
        local.append(X)
    tau = torch.zeros(N, dtype=A.dtype)

    def factor(p):
        lp, g0 = p // C, p * nb
        w = min(nb, N - g0)
        t, V, T = qr_panel_mirror(local[p % C][:, lp * nb:(lp + 1) * nb], g0, w)
        tau[g0:g0 + w] = t[:w]
        return V, T

    def block_reflector(cols, V, T, p0):
        Y = T.T @ (V[p0:].T @ cols[p0:])
        cols[p0:] -= V[p0:] @ Y

    published = factor(0)
    for p in range(panels):
        V, T = published
        p0 = p * nb
        for r in range(C):
            lp_start = 0 if p < r else (p - r) // C + 1
            c0 = lp_start * nb
            done = 0
            if p + 1 < panels and r == (p + 1) % C:     # the look-ahead
                block_reflector(local[r][:, c0:c0 + nb], V, T, p0)
                published = factor(p + 1)
                done = nb
            if c0 + done < local[r].shape[1]:
                block_reflector(local[r][:, c0 + done:], V, T, p0)
    qr = torch.empty_like(A)
    for r in range(C):
        for lp in range(n_local[r]):
            g0 = (lp * C + r) * nb
            w = min(nb, N - g0)
            qr[:, g0:g0 + w] = local[r][:, lp * nb:lp * nb + w]
    return qr, tau


def panel_qr_solve_mirror(qr, tau, v, nb=32):
    """Plain-PyTorch mirror of csrc/auglu.cu's qr_solve_kernel on one lane,
    f32. Q^T v a panel of nb reflectors at a time: w0 = V^T y and the Gram
    matrix G = V^T V from one pass over the panel's rows (V masked: an
    implied 1 on the diagonal, zeros above), the nb dependent dot products
    by the forward substitution w_c = w0_c - sum_{j<c} G_cj t_j with
    t_c = tau_c w_c, then y -= V t. R x = y over column tiles from the last
    (ragged) one, each diagonal tile solved column by column (times the
    reciprocal of the diagonal) and then applied to the rows above."""
    N = qr.shape[0]
    T = -(-N // nb)
    y = v.clone()
    for p in range(T):
        p0, p1 = p * nb, min(N, (p + 1) * nb)
        V = torch.tril(qr[p0:, p0:p1], diagonal=-1)
        V[torch.arange(p1 - p0), torch.arange(p1 - p0)] = 1.
        w0, G = V.T @ y[p0:], V.T @ V
        t = torch.zeros(p1 - p0, dtype=qr.dtype)
        for c in range(p1 - p0):
            t[c] = tau[p0 + c] * (w0[c] - (G[c, :c] * t[:c]).sum())
        y[p0:] -= V @ t
    for t in reversed(range(T)):
        r0, r1 = t * nb, min(N, (t + 1) * nb)
        for k in reversed(range(r0, r1)):
            y[k] = y[k] * (1 / qr[k, k])
            y[r0:k] -= qr[r0:k, k] * y[k]
        for k in range(r0, r1):
            y[:r0] -= qr[:r0, k] * y[k]
    return y


def panel_row_moves(piv, k0, w):
    """csrc/auglu.cu's lu_swap_kernel bookkeeping: the w interchanges of rows
    k0 + q and p_q (piv 1-based) as row moves, destination d taking the row
    found by tracing d back through the swaps from the last one. Returns
    (dst, src), 2 w entries each (a destination may repeat, with one
    source)."""
    p = [int(piv[k0 + q]) - 1 for q in range(w)]
    dst = [k0 + q for q in range(w)] + p
    src = []
    for d in dst:
        r = d
        for q in reversed(range(w)):
            r = p[q] if r == k0 + q else (k0 + q if r == p[q] else r)
        src.append(r)
    return torch.tensor(dst), torch.tensor(src)


def blocked_lu_mirror(A, nb=32):
    """Plain-PyTorch mirror of csrc/auglu.cu's blocked LU (lu_panel_kernel,
    lu_swap_kernel, lu_update_kernel) on one (N, N) f32 matrix, with the
    kernels' bookkeeping: per panel of nb columns the rows k0.. are factored
    column by column (first largest |a|, a NaN never chosen, a column of
    NaNs keeps the diagonal, whole panel rows swapped, no clamp of a zero
    pivot); the panel's interchanges reach every other column as
    panel_row_moves; U12 = L11^-1 A12; A22 -= L21 U12. Returns (lu, piv)
    like lu_factor_ex."""
    A = A.clone()
    N = A.shape[0]
    piv = torch.empty(N, dtype=torch.int32)
    for k0 in range(0, N, nb):
        w = min(nb, N - k0)
        P = A[k0:, k0:k0 + w]
        for k in range(w):
            a = P[k:, k].abs()
            a = torch.where(torch.isnan(a), torch.tensor(-1., dtype=a.dtype), a)
            p = k + int(torch.argmax(a)) if float(a.max()) >= 0 else k
            if p != k:
                P[[k, p], :] = P[[p, k], :]
            piv[k0 + k] = k0 + p + 1
            P[k + 1:, k] = P[k + 1:, k] / P[k, k]
            P[k + 1:, k + 1:] -= P[k + 1:, k:k + 1] * P[k:k + 1, k + 1:]
        others = torch.cat([torch.arange(k0), torch.arange(k0 + w, N)])
        dst, src = panel_row_moves(piv, k0, w)
        A[dst[:, None], others[None, :]] = A[src[:, None], others[None, :]].clone()
        if k0 + w < N:
            A[k0:k0 + w, k0 + w:] = torch.linalg.solve_triangular(
                A[k0:k0 + w, k0:k0 + w], A[k0:k0 + w, k0 + w:], upper=False, unitriangular=True)
            A[k0 + w:, k0 + w:] -= A[k0 + w:, k0:k0 + w] @ A[k0:k0 + w, k0 + w:]
    return A, piv


def blocked_qr_mirror(A, nb=32):
    """Plain-PyTorch mirror of csrc/auglu.cu's blocked QR (qr_panel_kernel,
    qr_w_kernel, qr_update_kernel) on one (N, N) f32 matrix: per panel of nb
    columns, rows k0.., a reflector at a time (larfg; each applied to the
    panel's later columns where its tau is not 0), the Gram matrix
    G = V^T V, T by larft's forward recurrence T[:k, k] = -tau_k T[:k, :k]
    G[:k, k], then W = V^T A22, Y = T^T W and A22 -= V Y on rows k0.. of
    the trailing columns. Returns (qr, tau) like torch.geqrf."""
    A = A.clone()
    N = A.shape[0]
    tau = torch.zeros(N, dtype=A.dtype)
    for k0 in range(0, N, nb):
        w = min(nb, N - k0)
        P = A[k0:, k0:k0 + w]
        for k in range(w):
            beta, t, v = larfg(P[k, k], P[k + 1:, k])
            P[k, k], P[k + 1:, k], tau[k0 + k] = beta, v, t
            if float(t) != 0. and k + 1 < w:
                vv = torch.cat([torch.ones(1, dtype=A.dtype), v])
                P[k:, k + 1:] -= t * vv[:, None] * (vv @ P[k:, k + 1:])[None, :]
        if k0 + w < N:
            V = torch.tril(P, diagonal=-1)
            V[torch.arange(w), torch.arange(w)] = 1.
            G = V.T @ V
            T = torch.zeros(w, w, dtype=A.dtype)
            for k in range(w):
                T[k, k] = tau[k0 + k]
                T[:k, k] = -tau[k0 + k] * (T[:k, :k] @ G[:k, k])
            Y = T.T @ (V.T @ A[k0:, k0 + w:])
            A[k0:, k0 + w:] -= V @ Y
    return A, tau


def qr_residual(M, v, x):
    """max |M x - v| / max |v| in f64, per lane."""
    r = (M.double() @ x.double()[..., None])[..., 0] - v.double()
    return (r.abs().amax(dim=-1) / v.double().abs().amax(dim=-1)).cpu().numpy()


def scaled_residual(A, kd, v, x):
    """max |A z - kd v| / max |kd v| with z = x / kd, in f64, per lane: the
    residual of the system the scaled solve solves."""
    z = (x / kd).double()
    c = (kd * v).double()
    r = (A.double() @ z[..., None])[..., 0] - c
    return (r.abs().amax(dim=-1) / c.abs().amax(dim=-1)).cpu().numpy()


def gaussian_lanes(B, N, seed, device='cpu'):
    """B Gaussian f32 matrices (pivoting on nearly every column) with kd in
    [0.5, 2] and v standard normal."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (f32(rng.standard_normal((B, N, N))), f32(rng.uniform(0.5, 2., (B, N))),
            f32(rng.standard_normal((B, N))))


@pytest.mark.parametrize('N', [37, 130, 543, 1055])
def test_tiled_solve_mirror_matches_lapack(N):
    """The solve kernel's algorithm (mirrored on the CPU) on LAPACK's f32
    factor: its composed permutation is LAPACK's sequential interchanges
    exactly, and its scaled residual is within 10x of torch.linalg.lu_solve's
    on the same factor (f32 forward and back substitution differ only in
    the order of sums). N mod 32 is 5, 2, 31 and 31: the ragged last tile."""
    from awebox_tpu_torch.parallel import kernels
    A, kd, v = gaussian_lanes(1, N, seed=N)
    lu, piv, _ = torch.linalg.lu_factor_ex(A[0])
    assert torch.equal(chunk_permutation(piv, N), sequential_permutation(piv, N))
    x = tiled_solve_mirror(lu, piv, kd[0], v[0])
    x_p = kernels.lu_solve_batched_plain(lu[None], piv[None], kd, v)[0]
    res, res_p = scaled_residual(A[0], kd[0], v[0], x), scaled_residual(A[0], kd[0], v[0], x_p)
    assert np.isfinite(res) and res <= 10 * max(res_p, 1e-7), (res, res_p)
    assert float((x - x_p).abs().max()) <= 1e-3 * float(x_p.abs().max())


def test_chunk_permutation_is_sequential_interchanges():
    """Interchanges that chain inside a chunk, across chunks, onto one row
    and onto rows past the chunk compose as LAPACK applies them one by one."""
    rng = np.random.default_rng(4)
    for N in (1, 5, 32, 33, 64, 100, 543):
        for trial in range(20):
            span = [1, 3, 40, N][trial % 4]
            piv = [k + 1 + int(rng.integers(0, min(span, N - k))) for k in range(N)]
            piv = torch.tensor(piv, dtype=torch.int32)
            assert torch.equal(chunk_permutation(piv, N), sequential_permutation(piv, N)), \
                (N, trial)


def test_tiled_solve_mirror_non_finite_lanes():
    """A singular lane (a zero column: LAPACK leaves a zero on U's diagonal)
    and a lane with a NaN column give a non-finite x in the mirror, as in the
    plain solve: nothing is skipped, so the delta ladder sees the failure."""
    from awebox_tpu_torch.parallel import kernels
    N = 41
    ones = torch.ones(N)
    for kind in ('singular', 'nan'):
        A = separated_pivots(N, seed=11)
        A[:, 17] = 0. if kind == 'singular' else float('nan')
        lu, piv, _ = torch.linalg.lu_factor_ex(A)
        x = tiled_solve_mirror(lu, piv, ones, ones)
        x_p = kernels.lu_solve_batched_plain(lu[None], piv[None], ones[None], ones[None])
        assert not bool(torch.isfinite(x).all()), kind
        assert not bool(torch.isfinite(x_p).all()), kind


@pytest.mark.parametrize('N', [37, 543, 1055, 4000])
def test_lu_solve_geometry(N):
    """K3's ring: five slots a warp at the slice's N=543 and at N=1055,
    within one block's shared memory beside the four words a padded row
    needs; a shallower ring where the vectors leave less room. A slot holds
    a 32-row tile as the nine 16-byte blocks that cover each row, the rows
    placed at 36 r + 4 (r // 8)."""
    from awebox_tpu_torch.parallel import kernels
    g = kernels.lu_solve_geometry(N)
    assert g.sw in kernels.SOLVE_RING
    assert g.sw == (5 if N <= 1055 else 2)   # 4000: 64 KB of vectors
    assert kernels.SOLVE_TILE >= 36 * 31 + 4 * 3 + 36 and kernels.SOLVE_TILE % 4 == 0
    rows = -(-N // 32) * 32
    assert g.smem_bytes == 4 * 8 * g.sw * kernels.SOLVE_TILE + 16 * rows
    assert g.smem_bytes + kernels.LU_STATIC_SMEM <= 232_448


def separated_pivots(N, seed):
    """An f32 matrix whose partial pivots are well separated: the rows of
    diag(d) + 0.05 noise with d in [1, 3], permuted, so every candidate row
    differs from the next by far more than rounding."""
    rng = np.random.default_rng(seed)
    M = np.diag(rng.uniform(1., 3., N)) + 0.05 * rng.standard_normal((N, N)) / np.sqrt(N)
    return torch.as_tensor(M[rng.permutation(N)], dtype=torch.float32)


@pytest.mark.parametrize('N', [37, 130, 543])
def test_cluster_lu_mirror_matches_lapack(N):
    """The cluster kernel's algorithm (mirrored on the CPU) against LAPACK
    getrf on the same f32 input: identical pivots where the pivots are well
    separated, and P L U reproducing a random Gaussian matrix to 1e-5 of
    max |A| (f32 backward error of partial pivoting at these N)."""
    A = separated_pivots(N, seed=N)
    lu, piv = cluster_lu_mirror(A)
    lu_ref, piv_ref, _ = torch.linalg.lu_factor_ex(A)
    assert torch.equal(piv, piv_ref)
    np.testing.assert_allclose(lu.numpy(), lu_ref.numpy(), rtol=0, atol=1e-5)
    G = torch.as_tensor(np.random.default_rng(N + 1).standard_normal((N, N)),
                        dtype=torch.float32)
    lu, piv = cluster_lu_mirror(G)
    P, L, U = torch.lu_unpack(lu, piv)
    err = float((P @ L @ U - G).abs().max()) / float(G.abs().max())
    assert err <= 1e-5, err


def test_cluster_lu_mirror_tie_nan_and_singular():
    """A tie picks the lower row; a column of NaNs keeps the diagonal; a
    singular lane (a zero column) gives non-finite factors, where LAPACK
    leaves a zero on U's diagonal: either way the solve is non-finite and
    the delta ladder retries."""
    N = 40
    A = separated_pivots(N, seed=5)
    A[:, 0] = 0.
    A[7, 0] = A[19, 0] = -2.5      # |a| ties at rows 3, 7 and 19: row 3 wins
    A[3, 0] = 2.5
    _, piv = cluster_lu_mirror(A)
    assert int(piv[0]) == 4         # row 3, 1-based
    A = separated_pivots(N, seed=6)
    A[:, 21] = float('nan')
    _, piv = cluster_lu_mirror(A)
    ref = torch.linalg.lu_factor_ex(separated_pivots(N, seed=6))[1]
    assert torch.equal(piv[:21], ref[:21])
    assert torch.equal(piv[21:], torch.arange(22, N + 1, dtype=torch.int32))
    A = separated_pivots(N, seed=7)
    A[:, 12] = 0.
    lu, piv = cluster_lu_mirror(A)
    assert not bool(torch.isfinite(lu).all())
    lu_ref, piv_ref, info = torch.linalg.lu_factor_ex(A)
    assert int(info) > 0 and float(torch.diagonal(lu_ref).abs().min()) == 0.
    b = torch.ones(N, 1)
    assert not bool(torch.isfinite(torch.linalg.lu_solve(lu, piv, b)).all())
    assert not bool(torch.isfinite(torch.linalg.lu_solve(lu_ref, piv_ref, b)).all())


@pytest.mark.parametrize('N', [37, 130, 543, 577, 590, 600, 640, 700, 1055, 1300, 2000])
def test_lu_factor_geometry(N):
    """The cluster variant at the slice's N=543 within one block's shared
    memory, the blocked one at the n_k=8 system's N=1055 and wherever a
    lane no longer fits a cluster, a lane whose panel no block holds raises
    by name; a cluster layout stays within a block's shared memory, covers
    all N columns exactly once and fits each CTA's columns, and the kernel's
    compiled limits hold (C <= 8, N <= 1024 panel rows in registers); a
    blocked panel of 32 columns holds N rows at an odd leading dimension."""
    from awebox_tpu_torch.parallel import kernels
    if N == 2000:
        with pytest.raises(ValueError, match='lu_factor_batched: N=2000 fits no variant'):
            kernels.lu_factor_geometry(N)
        return
    g = kernels.lu_factor_geometry(N)
    if N == 543:
        assert g.variant == 'cluster' and g.C == 8 and g.nb == 16
    if N >= 590:
        assert g.variant == 'blocked'
    if g.variant == 'blocked':
        assert (g.C, g.nb, g.cols_per_cta) == (1, 32, 32) == (1, kernels.BLOCKED_NB, kernels.BLOCKED_NB)
        assert g.ld >= N and g.ld % 2 == 1 and g.smem_bytes == 4 * 32 * g.ld
        assert g.smem_bytes + kernels.LU_STATIC_SMEM <= 232_448
        return
    assert g.smem_bytes + kernels.LU_STATIC_SMEM <= 232_448
    assert 1 <= g.C <= 8 and N <= 1024
    assert g.ld >= N and g.ld % 4 == 0 and g.ld % 32 != 0
    # the CTA's columns alone take cols_per_cta * ld floats of it
    assert 4 * g.cols_per_cta * g.ld < g.smem_bytes
    panels = -(-N // g.nb)
    seen = []
    for r in range(g.C):
        n_local = (panels - r + g.C - 1) // g.C
        assert 1 <= n_local and n_local * g.nb <= g.cols_per_cta
        for lp in range(n_local):
            g0 = (lp * g.C + r) * g.nb
            seen += list(range(g0, min(N, g0 + g.nb)))
    assert sorted(seen) == list(range(N))


@pytest.mark.parametrize('N, C', [(37, 8), (121, 7), (121, 8), (130, 7), (130, 8), (543, 7),
                                  (543, 8)])
def test_cluster_qr_mirror_matches_lapack(N, C):
    """The QR cluster kernel's algorithm (mirrored on the CPU: panels of 16
    dealt to C owners, a reflector at a time in the panel, then the panel's
    G and T and its block reflector on the trailing columns, the next
    panel's columns first) against LAPACK's geqrf on the same Gaussian f32
    input. Both follow larfg's sign rule, so here even the entries agree: R
    and the reflectors to 1e-4 of max |A|, tau to 1e-4, |diag R| to
    TOL_QR_DIAG of its maximum; and Q R, rebuilt from the mirror's
    reflectors, reproduces A to 1e-5 of max |A| (the f32 backward error of
    Householder QR at these N). N mod 16 is 5, 9, 2 and 15: the ragged last
    panel. Each case deals the panels its own way: N = 37 has 3 panels, one a
    CTA for any C >= 3; N = 121 has 8, one a CTA at C = 8, the ragged last
    back on the first CTA at C = 7."""
    A = gaussian_lanes(1, N, seed=N)[0][0]
    qr, tau = cluster_qr_mirror(A.clone(), C=C)
    qr_p, tau_p = torch.geqrf(A)
    amax = float(A.abs().max())
    assert float((qr - qr_p).abs().max()) <= 1e-4 * amax
    assert float((tau - tau_p).abs().max()) <= 1e-4
    dk, dp = qr.diagonal().abs(), qr_p.diagonal().abs()
    assert float((dk - dp).abs().max()) <= TOL_QR_DIAG * float(dp.max())
    Q = torch.linalg.householder_product(qr, tau)
    assert float((Q @ torch.triu(qr) - A).abs().max()) <= 1e-5 * amax


@pytest.mark.parametrize('w, zero_col', [(5, None), (16, None), (5, 2), (16, 9)])
def test_cluster_qr_panel_t_matches_householder_product(w, zero_col):
    """The panel's T as the cluster kernel forms it (qr_panel_mirror: G = V^T
    V and larft's forward recurrence) makes the block reflector of the
    panel's reflectors: I - V T V^T equals torch.linalg.householder_product
    of the same reflectors and taus to 1e-6, for a ragged panel (w = 5) and
    a whole one, with and without a zero column (tau = 0: H = I, a zero
    column of T)."""
    rows, nb, g0 = 45, 16, 3
    P = torch.as_tensor(np.random.default_rng(w).standard_normal((rows, nb)), dtype=torch.float32)
    P[:, w:] = 0.
    if zero_col is not None:
        P[:, zero_col] = 0.
    tau, V, T = qr_panel_mirror(P, g0, w)
    if zero_col is not None:
        assert float(tau[zero_col]) == 0. and not bool(T[:, zero_col].any())
    assert not bool(T[w:].any()) and not bool(T[:, w:].any())
    assert bool((torch.tril(T, diagonal=-1) == 0).all())
    m = rows - g0                           # reflector k's unit entry at row g0 + k
    H = torch.zeros(m, m)
    H[:, :w] = V[g0:, :w]
    Q = torch.linalg.householder_product(H, tau[:w])
    assert not bool(V[:g0].any())
    assert float((torch.eye(m) - V[g0:] @ T @ V[g0:].T - Q).abs().max()) <= 1e-6


@pytest.mark.parametrize('N', [37, 130, 543, 1055])
def test_panel_qr_solve_mirror_matches_lapack(N):
    """The QR solve kernel's algorithm (mirrored on the CPU: 32 reflectors at
    a time through the Gram matrix and a forward substitution, then the tiled
    back substitution) on LAPACK's factor against ormqr + solve_triangular
    on the same factor: within TOL_QR_X of max |x| and a residual
    |A x - v| / |v| within 10x. N mod 32 is 5, 2, 31 and 31: the ragged last
    panel and tile."""
    from awebox_tpu_torch.parallel import kernels
    A, _, v = gaussian_lanes(1, N, seed=N)
    qr, tau = torch.geqrf(A[0])
    x = panel_qr_solve_mirror(qr, tau, v[0])
    x_p = kernels.qr_solve_batched_plain(qr[None], tau[None], v)[0]
    assert float((x - x_p).abs().max()) <= TOL_QR_X * float(x_p.abs().max())
    res, res_p = qr_residual(A[0], v[0], x), qr_residual(A[0], v[0], x_p)
    assert np.isfinite(res) and res <= 10 * max(res_p, 1e-7), (res, res_p)


def test_qr_mirrors_non_finite_lanes():
    """A singular lane (a zero column: tau = 0 and a zero on R's diagonal, as
    LAPACK leaves it) and a lane with a NaN column give a non-finite x in the
    mirrors of K6 and K7, as in the plain factor and solve: nothing is
    skipped, so the delta ladder sees the failure."""
    from awebox_tpu_torch.parallel import kernels
    N = 41
    ones = torch.ones(N)
    for kind in ('singular', 'nan'):
        A = separated_pivots(N, seed=11)
        A[:, 17] = 0. if kind == 'singular' else float('nan')
        qr, tau = cluster_qr_mirror(A.clone())
        qr_p, tau_p = kernels.qr_factor_batched_plain(A[None])
        if kind == 'singular':
            assert float(tau[17]) == 0. == float(tau_p[0, 17])
            assert float(qr[17, 17]) == 0. == float(qr_p[0, 17, 17])
        assert not bool(torch.isfinite(panel_qr_solve_mirror(qr, tau, ones)).all()), kind
        assert not bool(torch.isfinite(
            kernels.qr_solve_batched_plain(qr_p, tau_p, ones[None])).all()), kind


@pytest.mark.parametrize('N', [37, 130, 543, 590, 640, 700, 1055, 1300, 2000])
def test_qr_factor_geometry(N):
    """The cluster variant at the slice's N=543 within one block's shared
    memory, the blocked one at the n_k=8 system's N=1055 and wherever a
    warp's registers no longer hold a column (N > 640) or the lane no
    longer fits the cluster, a lane whose panel no block holds raises by
    name; a cluster layout covers all N columns exactly once, fits each
    CTA's columns beside the panel copy and the kernel's static T and its
    copy (a cluster of 7 would need the same room at N=543), and keeps the
    float4 copy of the panel's rows inside a column (ld a multiple of 4,
    >= N); a blocked
    panel of 32 columns holds N rows at an odd leading dimension beside the
    kernel's static G and T."""
    from awebox_tpu_torch.parallel import kernels
    if N == 2000:
        with pytest.raises(ValueError, match='qr_factor_batched: N=2000 fits no variant'):
            kernels.qr_factor_geometry(N)
        return
    g = kernels.qr_factor_geometry(N)
    if N == 543:
        assert g.variant == 'cluster' and g.C == 8 and g.nb == 16
        assert kernels.qr_cluster_layout(N, 7) == g._replace(C=7)   # same room a CTA
    if N in (640, 700, 1055, 1300):
        assert g.variant == 'blocked'
    if g.variant == 'blocked':
        assert (g.C, g.nb, g.cols_per_cta) == (1, 32, 32)
        assert g.ld >= N and g.ld % 2 == 1 and g.smem_bytes == 4 * 32 * g.ld
        assert g.smem_bytes + kernels.QR_PANEL_STATIC_SMEM <= 232_448
        assert kernels.QR_PANEL_STATIC_SMEM >= 4 * (32 + 2 * 32 * 33)
        return
    assert N <= kernels.QR_ROW_MAX and g.ld <= kernels.QR_ROW_MAX
    assert g.smem_bytes + kernels.QR_CLUSTER_STATIC_SMEM <= 232_448
    assert kernels.QR_CLUSTER_STATIC_SMEM >= 4 * 2 * 16 * 16      # s_T and s_Tl
    assert 1 <= g.C <= 8 and g.ld >= N and g.ld % 4 == 0
    assert g.smem_bytes == 4 * (g.cols_per_cta + g.nb) * g.ld
    panels = -(-N // g.nb)
    seen = []
    for r in range(g.C):
        n_local = (panels - r + g.C - 1) // g.C
        assert 1 <= n_local and n_local * g.nb <= g.cols_per_cta
        for lp in range(n_local):
            g0 = (lp * g.C + r) * g.nb
            seen += list(range(g0, min(N, g0 + g.nb)))
    assert sorted(seen) == list(range(N))


@pytest.mark.parametrize('N', [130, 600, 1055])
def test_blocked_lu_mirror_matches_lapack(N):
    """The blocked LU kernels' algorithm (mirrored on the CPU: panels of 32,
    the interchanges as composed row moves, U12 and the rank-32 update)
    against LAPACK getrf on Gaussian f32 matrices: identical pivots, and
    P L U reproducing A within 10x of LAPACK's own factor (f32 backward
    error of partial pivoting, ~1e-5 of max |A| at N=1055). N mod 32 is 2,
    24 and 31: the ragged last panel."""
    for seed in (N, N + 1):
        A = gaussian_lanes(1, N, seed=seed)[0][0]
        lu, piv = blocked_lu_mirror(A)
        lu_ref, piv_ref, _ = torch.linalg.lu_factor_ex(A)
        assert torch.equal(piv, piv_ref), (N, seed)

        def dev(lu_, piv_):
            P, L, U = torch.lu_unpack(lu_, piv_)
            return float((P @ L @ U - A).abs().max())
        assert dev(lu, piv) <= 10 * max(dev(lu_ref, piv_ref), 1e-7 * float(A.abs().max()))


def nk8_anchor_systems():
    """K(delta_w) of the port's first iteration at the n_k=8 anchor
    (tests/artifacts/bench_anchor_nk8_d3.npz: n=540, m=515, N=1055), two
    lanes at 9.5 and 10.5 m/s, on the CPU: (Ks, kd) Jacobi-scaled for the
    LU factor and the unscaled K for the QR factor, f32."""
    import os
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    from awebox_tpu_torch.ocp.structured import make_structured_derivs
    from awebox_tpu_torch.parallel import kernels
    from awebox_tpu_torch.parallel.refine import wind_sweep_problem
    trial = Trial(bench_options(n_k=8), 'nk8').build()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'artifacts',
                        'bench_anchor_nk8_d3.npz')
    state, P64, lbw, ubw, free, _ = wind_sweep_problem(trial, dict(np.load(path)), 2,
                                                       device='cpu')
    vals_fn, jac_fn, hess_fn = make_structured_derivs(trial.ocp)
    w, y, lam = state['w'], state['y'], state['lam']
    dv = tuple(vals_fn(w, y, lam, P64)) + tuple(J.to(torch.float32) for J in jac_fn(w, P64)) \
        + (hess_fn(w, y, lam, P64).to(torch.float32),)
    scaled = kernels.newton_kkt_plain(state, dv, lbw, ubw, free, 1e-8, 1e-8, True)
    unscaled = kernels.newton_kkt_plain(state, dv, lbw, ubw, free, 1e-8, 1e-8, False)
    return scaled['Ks'], scaled['kd'], unscaled['K']


def test_blocked_lu_mirror_pivots_on_the_nk8_anchor_system():
    """On the n_k=8 anchor's Jacobi-scaled K (N=1055, cond ~1e9 after the
    scaling) the blocked LU's pivots are LAPACK's in both lanes, and P L U
    reproduces Ks within 10x of LAPACK's factor."""
    Ks, _, K = nk8_anchor_systems()
    assert Ks.shape == (2, 1055, 1055) and K.shape == Ks.shape
    for b in range(2):
        lu, piv = blocked_lu_mirror(Ks[b])
        lu_ref, piv_ref, _ = torch.linalg.lu_factor_ex(Ks[b])
        assert torch.equal(piv, piv_ref), b
        P, L, U = torch.lu_unpack(lu, piv)
        Pr, Lr, Ur = torch.lu_unpack(lu_ref, piv_ref)
        assert float((P @ L @ U - Ks[b]).abs().max()) \
            <= 10 * float((Pr @ Lr @ Ur - Ks[b]).abs().max())


@pytest.mark.parametrize('N', [130, 600, 1055])
def test_blocked_qr_mirror_matches_lapack(N):
    """The blocked QR kernels' algorithm (mirrored on the CPU: the panel a
    reflector at a time, G = V^T V, larft's T, A22 -= V T^T V^T A22) against
    LAPACK's geqrf on the same Gaussian f32 input: R and the reflectors to
    1e-4 of max |A|, tau to 1e-4, |diag R| to TOL_QR_DIAG of its maximum, and
    Q R reproducing A within 10x of geqrf's own factor. N mod 32 is 2, 24
    and 31: the ragged last panel."""
    A = gaussian_lanes(1, N, seed=N)[0][0]
    qr, tau = blocked_qr_mirror(A)
    qr_p, tau_p = torch.geqrf(A)
    amax = float(A.abs().max())
    assert float((qr - qr_p).abs().max()) <= 1e-4 * amax
    assert float((tau - tau_p).abs().max()) <= 1e-4
    dk, dp = qr.diagonal().abs(), qr_p.diagonal().abs()
    assert float((dk - dp).abs().max()) <= TOL_QR_DIAG * float(dp.max())

    def dev(f, t):
        return float((torch.linalg.householder_product(f, t) @ torch.triu(f) - A).abs().max())
    assert dev(qr, tau) <= 10 * max(dev(qr_p, tau_p), 1e-7 * amax)


def test_panel_row_moves_are_sequential_interchanges():
    """The blocked LU's composed row moves equal LAPACK's interchanges of a
    panel applied one by one: swaps that chain, land on one row, stay in the
    panel or reach rows far below it."""
    rng = np.random.default_rng(8)
    for N, k0 in ((40, 0), (100, 32), (100, 96), (1055, 1024)):
        for trial in range(20):
            w = min(32, N - k0)
            span = [1, 3, 40, N][trial % 4]
            piv = torch.zeros(N, dtype=torch.int32)
            for q in range(w):
                piv[k0 + q] = k0 + q + 1 + int(rng.integers(0, min(span, N - k0 - q)))
            ref = torch.arange(N)
            for q in range(w):
                p = int(piv[k0 + q]) - 1
                ref[[k0 + q, p]] = ref[[p, k0 + q]]
            dst, src = panel_row_moves(piv, k0, w)
            moved = torch.arange(N)
            moved[dst] = torch.arange(N)[src]
            assert torch.equal(moved, ref), (N, k0, trial)


def test_blocked_mirrors_non_finite_lanes():
    """A singular lane (a zero column) and a lane with a NaN column give a
    non-finite x through the blocked mirrors, as through LAPACK: nothing is
    skipped, so the delta ladder sees the failure. The zero column leaves
    tau = 0 and a zero on R's diagonal, as geqrf does, and a column of NaNs
    keeps LU's diagonal as pivot from that column on."""
    from awebox_tpu_torch.parallel import kernels
    N = 100
    ones = torch.ones(N)
    for kind in ('singular', 'nan'):
        A = separated_pivots(N, seed=12)
        A[:, 70] = 0. if kind == 'singular' else float('nan')
        lu, piv = blocked_lu_mirror(A)
        assert not bool(torch.isfinite(torch.linalg.lu_solve(lu, piv, ones[:, None])).all()), kind
        if kind == 'nan':
            ref = torch.linalg.lu_factor_ex(separated_pivots(N, seed=12))[1]
            assert torch.equal(piv[:70], ref[:70])
            assert torch.equal(piv[70:], torch.arange(71, N + 1, dtype=torch.int32))
        qr, tau = blocked_qr_mirror(A)
        qr_p, tau_p = kernels.qr_factor_batched_plain(A[None])
        if kind == 'singular':
            assert float(tau[70]) == 0. == float(tau_p[0, 70])
            assert float(qr[70, 70]) == 0. == float(qr_p[0, 70, 70])
        assert not bool(torch.isfinite(panel_qr_solve_mirror(qr, tau, ones)).all()), kind


@pytest.mark.parametrize('N', [37, 543, 800, 1055, 1216, 1300])
def test_qr_solve_geometry(N):
    """K7 pads the right-hand side and R's diagonal to whole panels of 32;
    for Q^T v it stages a row of 36 f32 for each of its entries (16-byte
    rows for the float4 reads) beside every warp's partial Gram matrix (32
    rows of 36) and partial V^T y and the warps' staging slots (a group of
    tiles' 32 rows of 9 aligned 16-byte blocks); for R x = y the same room
    holds every warp's ring of two whole tiles in K3's layout. All within
    one block's shared memory: 16 warps and a slot of 8 tiles at the
    slice's N=543, 8 warps and a slot of 4 at N=800 and at N=1055, a slot
    of one tile at the largest N; a lane too large for that raises."""
    from awebox_tpu_torch.parallel import kernels
    if N == 1300:
        with pytest.raises(ValueError, match='no room'):
            kernels.qr_solve_geometry(N)
        return
    g = kernels.qr_solve_geometry(N)
    layout = (g.warps, g.group)
    assert g.tiles == -(-N // kernels.QR_SOLVE_NB)
    assert layout in kernels.QR_SOLVE_LAYOUTS
    assert layout == {37: (16, 8), 543: (16, 8), 800: (8, 4), 1055: (8, 4), 1216: (8, 1)}[N]
    rows = g.tiles * 32
    assert kernels.QR_SOLVE_LDV % 4 == 0 and kernels.QR_SOLVE_LDV >= 32
    assert kernels.QR_SOLVE_SROW == 4 * (32 // 4 + 1)
    # K3's slot: row 31 starts 31 * 36 + 12 floats in, and takes up to 36 more
    assert kernels.SOLVE_TILE >= 31 * 36 + 12 + 36 and kernels.SOLVE_TILE % 4 == 0
    qt = g.warps * 32 * 37 + rows * 36 + g.group * 32 * 36
    assert kernels.QR_SOLVE_BACK_SLOTS == 2
    assert g.smem_bytes == 4 * (2 * rows + max(qt, g.warps * 2 * kernels.SOLVE_TILE))
    assert g.smem_bytes + kernels.QR_SOLVE_STATIC_SMEM <= 232_448
    assert kernels.QR_SOLVE_STATIC_SMEM >= 4 * (32 * 33 + 32 + 32)
    # the first layout that fits: none earlier in the list does
    for earlier in kernels.QR_SOLVE_LAYOUTS[:kernels.QR_SOLVE_LAYOUTS.index(layout)]:
        assert kernels.qr_solve_smem(N, *earlier) + kernels.QR_SOLVE_STATIC_SMEM > 232_448


def test_qr_solve_layouts_match_the_compiled_kernels():
    """Every (warps, tiles a slot) of kernels.QR_SOLVE_LAYOUTS has its case
    in csrc/auglu.cu's qr_solve_batched, which launches that instance, and
    no other instance is compiled; each warp count divides a tile's 32 rows
    and is a multiple of 4 (so all of a warp's rows share one shift)."""
    from awebox_tpu_torch.parallel import kernels
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    entry = src[src.index('int qr_solve_batched('):]
    entry = entry[:entry.index('\n}\n')]
    cases = re.findall(r'case (\d+): return k7_launch<(\d+), (\d+)>', entry)
    assert [(int(w), int(g)) for _, w, g in cases] == list(kernels.QR_SOLVE_LAYOUTS)
    assert all(int(c) == 100 * int(w) + int(g) for c, w, g in cases)
    assert all(32 % w == 0 and w % 4 == 0 and g >= 1 for w, g in kernels.QR_SOLVE_LAYOUTS)


def k7_walk(T, group):
    """csrc/auglu.cu's K7Walk (group and advance), transcribed: the groups
    (first row tile, column tile, tiles) whose rows a K7 warp streams
    through its ring in Q^T v, in order."""
    s, i, out = 0, 0, []
    while s < T:
        out.append((i, s, min(group, T - i)))
        i += group
        if i >= T:
            s += 1
            i = s
    return out


def k7_back_walk(T, warps, warp):
    """csrc/auglu.cu's K7BackRing walk (start, settle and issue),
    transcribed: the (row tile, column tile) pairs a warp streams in
    R x = y, in order."""
    c, i, out = T - 1, (T - 1 if warp == 0 else warp - 1), []

    def settle():
        nonlocal c, i
        while c >= 2 and i >= c - 1:
            c, i = c - 1, warp - 1
        if c < 2:
            c = -1
    if warp > 0:
        settle()
    while c >= 0:
        out.append((i, c))
        if warp > 0:
            i += warps - 1
            settle()
        elif i == c:
            i -= 1
            if i < 0:
                c = -1
        else:
            c = i
    return out


def test_qr_solve_ring_walks_are_the_kernels_order():
    """The rings issue their copies in the order the kernel takes the
    slots, so each take finds the tiles it expects: in Q^T v each panel's
    row tiles in groups of each compiled size; in R x = y, step by step
    from the last, warp 0's tile (t, t + 1) above diagonal tile t (its
    look-ahead, from the second step on) and then diagonal tile t, and
    every other warp w's tiles (i, t + 1) for i = w - 1 and every
    (warps - 1)-th after it, below t. Every tile of the factor is in
    exactly one group or take: each panel's tiles in Q^T v, each tile on or
    above the diagonal in R x = y. For tile counts from 1 (N <= 32) to 40
    (past the largest N)."""
    from awebox_tpu_torch.parallel import kernels
    for group in sorted({g for _, g in kernels.QR_SOLVE_LAYOUTS}):
        for T in range(1, 41):
            walk = k7_walk(T, group)
            assert walk == [(ti, p, min(group, T - ti)) for p in range(T)
                            for ti in range(p, T, group)], (group, T)
            tiles = [(ti + h, tj) for ti, tj, n in walk for h in range(n)]
            assert sorted(tiles) == sorted((ti, p) for p in range(T) for ti in range(p, T))
    for warps in sorted({w for w, _ in kernels.QR_SOLVE_LAYOUTS}):
        for T in range(1, 41):
            walks = [k7_back_walk(T, warps, w) for w in range(warps)]
            assert walks[0] == [tile for t in reversed(range(T))
                                for tile in ([(t, t + 1)] if t + 1 < T else []) + [(t, t)]]
            for w in range(1, warps):
                assert walks[w] == [(i, t + 1) for t in reversed(range(T - 1))
                                    for i in range(w - 1, t, warps - 1)], (warps, T, w)
            taken = sorted(tile for walk in walks for tile in walk)
            assert taken == sorted((i, t) for t in range(T) for i in range(t + 1))


@pytest.mark.parametrize('N,warps,G', [(37, 16, 8), (130, 8, 1), (543, 16, 8), (1055, 8, 4)])
def test_qr_solve_staging_mirror(N, warps, G):
    """K7's staging in Q^T v, transcribed (K7Ring::start and issue, and the
    realign) on a lane whose matrix starts 0..3 floats past a 16-byte
    boundary: all of a warp's rows start at one shift into their 16-byte
    blocks; each warp copies the aligned blocks that cover its rows of a
    group's tiles, reading exactly the blocks that hold an entry of a tile,
    all inside the lane's matrix; and what it reads back at that shift,
    masked, is V: the factor below the diagonal, a unit diagonal, zeros
    above it and past N. The warps' rows of a tile are its 32 rows, once
    each. Slots of 8, 4 and 1 tiles."""
    T, rpw, last = -(-N // 32), 32 // warps, N - 32 * (-(-N // 32) - 1)
    rng = np.random.default_rng(N)
    a = rng.standard_normal((N, N)).astype(np.float32)
    lanes = np.arange(32)
    for off in range(4):
        buf = np.full(off + N * N + 8, np.nan, dtype=np.float32)
        buf[off:off + N * N] = a.ravel()
        for w in range(warps):
            sh = (off + w * N) % 4
            assert {(off + r * N + 32 * tj) % 4 for r in range(w, N, warps)
                    for tj in range(T)} == {sh}
            blocks = []                     # start(): block b = 32 q + lane of a slot
            for b in range(G * rpw * 9):
                rr, c4 = b // 9, 4 * (b % 9)
                row = w + warps * (rr % rpw)
                flags = (1 if c4 < sh + last else 0) | (2 if c4 < sh + 32 else 0) \
                    | (4 if row < last else 0)
                blocks.append(((rr // rpw * 32 + row) * N + c4 - sh, rr * 36 + c4, rr // rpw,
                               flags, row, c4))
            for ti, tj, n in k7_walk(T, G):
                g0 = off + (ti * N + tj) * 32
                cols = min(32, N - 32 * tj)
                slot = np.full(G * rpw * 36, np.inf, dtype=np.float32)
                for src, dst, g, flags, row, c4 in blocks:
                    if g >= n:
                        continue
                    need = (1 if tj == T - 1 else 2) | (4 if ti + g == T - 1 else 0)
                    copy = (flags & need) == need
                    assert copy == (32 * (ti + g) + row < N and c4 < sh + cols)
                    start = g0 + src
                    if copy:
                        # within the aligned blocks that hold the lane's matrix
                        assert start % 4 == 0 and start >= off // 4 * 4
                        assert start + 4 <= (off + N * N - 1) // 4 * 4 + 4
                        slot[dst:dst + 4] = buf[start:start + 4]
                    else:
                        slot[dst:dst + 4] = 0.
                col = 32 * tj + lanes
                colc = np.minimum(col, N - 1)
                for g in range(n):
                    for j in range(rpw):
                        r = 32 * (ti + g) + w + warps * j
                        if r >= N:
                            continue
                        e = slot[(g * rpw + j) * 36 + sh + lanes]
                        v_row = np.where(col < N, e, 0.)
                        if g == 0 and ti == tj:
                            v_row = np.where(r > col, v_row, np.where(r == col, 1., 0.))
                        ref = np.where((col < N) & (r > col), a[r, colc],
                                       np.where(r == col, 1., 0.))
                        assert np.array_equal(v_row, ref)
        for ti in range(T):
            assert sorted(32 * ti + w + warps * j for w in range(warps)
                          for j in range(rpw)) == list(range(32 * ti, 32 * ti + 32))


# --- K5: the cluster schedule ------------------------------------------------

def ruiz_cluster_mirror(K, geom, clusters, offset=0):
    """csrc/auglu.cu's ruiz_cluster_kernel, transcribed: K (B, N, N) f32 lies
    in a flat memory ``offset`` floats past a 16-byte boundary; cluster c
    takes lanes c, c + clusters, ..; CTA q owns rows q R .., copies the
    first resident rows as the 16-byte blocks that cover them (keeping the
    shift), holds the next ones in registers (warp w rows nres + w + 12 k,
    k < RUIZ_REG_ROWS, where the layout has register rows) and reads
    the others from the memory; each sweep leaves a CTA's s in buffer
    ``par`` of its own two, and every CTA gathers the lane's s from the
    owners' buffers; each row of M and s follow. Returns M, s and how often
    each lane was taken."""
    from awebox_tpu_torch.parallel import kernels
    B, N, _ = K.shape
    C, R, res = geom.C, geom.rows, geom.resident_rows
    W = kernels.RUIZ_WARPS
    RR = kernels.RUIZ_REG_ROWS if geom.register_rows else 0
    mem = torch.full((offset + B * N * N + 8,), float('nan'))
    mem[offset:offset + B * N * N] = K.reshape(-1)
    M = torch.full_like(K, float('nan'))
    s = torch.full((B, N), float('nan'))
    taken = [0] * B
    i = torch.arange(N)
    owner = i // R
    for c in range(clusters):
        s_own = torch.full((C, 2, R), float('nan'))   # the C CTAs' two buffers
        par = 0
        for lane in range(c, B, clusters):
            taken[lane] += 1
            ctas = []
            for q in range(C):
                r0 = q * R
                nrows = max(0, min(R, N - r0))
                nres = min(res, nrows)
                rend = min(nrows, nres + W * RR)
                kr = offset + (lane * N + r0) * N         # the CTA's first entry
                shift = kr & 3
                blocks = (shift + nres * N + 3) >> 2
                assert (kr - shift) % 4 == 0 and 4 * blocks <= nres * N + 8
                smem = torch.full((nres * N + 8,), float('nan'))
                smem[:4 * blocks] = mem[kr - shift:kr - shift + 4 * blocks]
                src = {}
                for r in range(nres):
                    src[r] = smem[shift + r * N:shift + (r + 1) * N]
                for w in range(W):                         # the register rows, RR a warp
                    for k in range(RR):
                        r = nres + w + W * k
                        if r < rend:
                            assert r not in src
                            src[r] = mem[kr + r * N:kr + (r + 1) * N].clone()
                for r in range(rend, nrows):
                    assert r not in src
                    src[r] = mem[kr + r * N:kr + (r + 1) * N]
                assert sorted(src) == list(range(nrows))
                ctas.append((r0, nrows, nres, kr, shift, smem, src))
            s_all = [None] * C
            for sweep in range(3):
                for q, (r0, nrows, _, _, _, _, src) in enumerate(ctas):
                    for r in range(nrows):
                        si = s_all[q][r0 + r] if sweep else torch.tensor(1.)
                        v = src[r] if sweep == 0 else (src[r] * si) * s_all[q]
                        s_own[q, par, r] = si / torch.sqrt(torch.clamp(v.abs().amax(), min=1e-12))
                gathered = s_own[owner, par, i - owner * R]
                s_all = [gathered.clone() for _ in range(C)]
                par ^= 1
            for q, (r0, nrows, _, _, _, _, src) in enumerate(ctas):
                for r in range(nrows):
                    M[lane, r0 + r] = (src[r] * s_all[q][r0 + r]) * s_all[q]
                    s[lane, r0 + r] = s_all[q][r0 + r]
    return M, s, taken


@pytest.mark.parametrize('N', [37, 130, 543, 737, 1055, 1300, 2000])
def test_ruiz_geometry(N):
    """K5's layout: clusters of at most 16 CTAs (12 warps each, a warp per
    row) whose rows cover the lane with a row for every CTA; the lane's s,
    the CTA's two buffers of its s and its resident rows (with the 16-byte
    blocks that cover them) within one block's shared memory. Every row is
    resident up to N=737 (at the slice's N=543: 34 rows, few enough bytes for
    three CTAs an SM); beyond, as many rows as fit, and a cap on the clusters
    in flight keeps the other rows of the lanes in flight within the L2. A
    lane whose s alone does not fit raises by name."""
    from awebox_tpu_torch.parallel import kernels
    g = kernels.ruiz_geometry(N)
    assert kernels.RUIZ_WARPS == 12
    assert g == kernels.ruiz_layout(N, min(kernels.RUIZ_CLUSTER_MAX, -(-N // 12)))
    assert 1 <= g.C <= kernels.RUIZ_CLUSTER_MAX
    assert g.rows * (g.C - 1) < N <= g.rows * g.C
    assert g.smem_bytes == kernels.ruiz_smem(N, g.rows, g.resident_rows)
    assert g.smem_bytes == 4 * (-(-N // 4) * 4 + 2 * (-(-g.rows // 4) * 4) + g.resident_rows * N + 8)
    room = kernels.SMEM_PER_BLOCK - kernels.RUIZ_STATIC_SMEM
    assert g.smem_bytes <= room
    if N <= 737:
        assert g.mode == 'resident' and g.resident_rows == g.rows and g.register_rows == 0
        assert g.lanes_in_flight == 0
    else:
        assert 0 < g.resident_rows < g.rows
        assert kernels.ruiz_smem(N, g.rows, g.resident_rows + 1) > room
    if N == 1055:   # the rest in registers: 13 rows, at most two a warp
        assert g.mode == 'resident' and (g.resident_rows, g.register_rows) == (53, 13)
        assert g.register_rows <= 12 * kernels.RUIZ_REG_ROWS and N <= 32 * kernels.RUIZ_REG_COLS
        assert g.lanes_in_flight == 0
    if N > 1056:    # the rest re-read from the L2: a cap on the lanes in flight
        assert g.mode == 'streamed' and g.register_rows == 0
        streamed = 4 * N * (N - g.C * g.resident_rows)
        assert g.lanes_in_flight >= 1
        assert g.lanes_in_flight * streamed <= kernels.RUIZ_L2_BYTES or g.lanes_in_flight == 1
    if N == 543:
        assert (g.C, g.rows) == (16, 34)
        # three CTAs on an SM's 228 KB, each with 1 KB reserved
        assert 3 * (g.smem_bytes + kernels.RUIZ_STATIC_SMEM + 1024) <= 233_472
    with pytest.raises(ValueError, match='ruiz_scale: N=60000 fits no layout'):
        kernels.ruiz_geometry(60_000)


@pytest.mark.parametrize('N', [37, 543, 1055])
def test_ruiz_cluster_mirror_matches_plain(N):
    """The cluster schedule of K5 (rows split over the C ranks, resident and
    streamed rows, s gathered from the owners' double buffers, persistent
    clusters walking the lanes) gives ruiz_scale_plain's M and s bit for
    bit: on Gaussian lanes with rows over six decades, on a lane with a NaN
    row, an inf entry and a zero row, which leaves the other lanes' bits as
    they were; in the geometry's layout, at two clusters for B lanes (the
    parity of the buffers runs on from lane to lane) and with K 1 and 3
    floats past a 16-byte boundary; at N=37 also with rows in registers and
    with rows re-read from memory."""
    from awebox_tpu_torch.parallel import kernels
    B = 3 if N > 600 else 5
    rng = np.random.default_rng(N)
    K = torch.as_tensor(rng.standard_normal((B, N, N)) * 10.0 ** rng.uniform(-3, 3, (B, N, 1)),
                        dtype=torch.float32)
    M_p, s_p = kernels.ruiz_scale_plain(K)
    K_bad = K.clone()
    K_bad[1, N // 2, :] = float('nan')
    K_bad[1, 3, N - 2] = float('inf')
    K_bad[1, N - 1, :] = 0.
    Mb_p, sb_p = kernels.ruiz_scale_plain(K_bad)
    assert torch.isnan(sb_p[1]).any()
    geom = kernels.ruiz_geometry(N)
    layouts = [(geom, 2, 1), (geom, B, 3)]
    if N == 37:     # rows in registers; and rows re-read, as beyond N = 1056
        cap = kernels.ruiz_smem(N, 10, 4) + kernels.RUIZ_STATIC_SMEM
        layouts.append((kernels.ruiz_layout(N, 4, cap), 2, 2))
        assert layouts[-1][0][3:5] == (4, 6)
        layouts.append((layouts[-1][0]._replace(register_rows=0), 2, 2))
    for geom, clusters, offset in layouts:
        M, s, taken = ruiz_cluster_mirror(K, geom, clusters, offset)
        assert taken == [1] * B
        assert same_bits(M, M_p) and same_bits(s, s_p), (geom, clusters, offset)
        Mb, sb, _ = ruiz_cluster_mirror(K_bad, geom, clusters, offset)
        assert same_bits(Mb, Mb_p) and same_bits(sb, sb_p), (geom, clusters, offset)
        others = [0] + list(range(2, B))
        assert torch.equal(Mb[others], M[others]) and torch.equal(sb[others], s[others])


def test_kkt_assembly_plain_is_the_jax_formula():
    """K1's plain versions compute awebox_tpu/parallel/batch.py:333-336 (the
    unscaled K of the QR factor) and :409-413 (its Jacobi scaling for LU)
    exactly: the same f32 operations in the same order (checked bit for bit
    against the formula in numpy f32)."""
    from awebox_tpu_torch.parallel import kernels
    rng = np.random.default_rng(2)
    B, n, m = 3, 9, 5
    W = rng.standard_normal((B, n, n)).astype(np.float32)
    W[0, 4, 4] = 0.          # pinned and zero: |diag| clipped to 1e-8
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    Dr = np.abs(rng.standard_normal((B, m))).astype(np.float32) * 1e-3
    free = np.ones(n, np.float32)
    free[4] = 0.
    delta = np.array([1e-8, 1e-4, 1.0])
    Ks, kd = kernels.kkt_assemble_scaled(*(torch.as_tensor(a) for a in
                                           (W, A, Dr, free, delta)))
    Ku = kernels.kkt_assemble(*(torch.as_tensor(a) for a in (W, A, Dr, free, delta)))
    for b in range(B):
        d32 = np.float32(delta[b])
        Wd = W[b] + d32 * np.diag(free)
        K = np.block([[Wd, A[b].T], [A[b], -np.diag(Dr[b])]])
        kdiag = np.concatenate([np.abs(np.diag(K)[:n]), Dr[b]])
        kd_ref = np.clip(np.float32(1.0) / np.sqrt(np.clip(kdiag, np.float32(1e-8), None)),
                         np.float32(0.), np.float32(1e4))
        np.testing.assert_array_equal(kd[b].numpy(), kd_ref)
        np.testing.assert_array_equal(Ks[b].numpy(), K * kd_ref[:, None] * kd_ref[None, :])
        np.testing.assert_array_equal(Ku[b].numpy(), K)
    assert abs(float(kd[0, 4]) - 1e4) <= 1.


@pytest.mark.parametrize('n, n_eq, n_ineq', [(20, 12, 5), (70, 52, 8), (280, 247, 16)])
def test_kkt_tile_mirror_matches_plain(n, n_eq, n_ineq):
    """newton_kkt's bookkeeping, mirrored on the CPU, reproduces the plain
    composition (newton_system, equilibrate, kkt_assemble_scaled_plain)
    exactly at N = 37, 130 and 543: ragged last tiles of 5, 2 and 31 rows,
    tiles that straddle the W0/A' border (n mod 32 = 20, 6, 24), the A'^T
    tiles read transposed, the identity of pinned rows, non-finite entries
    sanitized. Every entry of Ks, kd, W64 and A64 is written."""
    from awebox_tpu_torch.parallel import kernels
    args = newton_inputs(B=2, n=n, n_eq=n_eq, n_ineq=n_ineq, seed=n)
    mirror = kkt_tile_mirror(*args, 1e-8, 1e-8)
    ref = kernels.newton_kkt_plain(*args, 1e-8, 1e-8)
    for k, v in zip(('Ks', 'kd', 'W64', 'A64'), mirror):
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize('key', list(TOL_STEP) + ['ds'])
def test_step_gate_fails_on_a_stray_nan(key):
    """The K4 gate of the card test and chip_smoke.py (step_gaps,
    step_within_tolerance) passes the plain outputs against themselves, NaN
    entries on both sides included, and fails when a single entry of one
    output, ds included, is NaN where the plain version's is finite."""
    from awebox_tpu_torch.parallel import kernels
    state, derivs, lbw, ubw, free = newton_inputs()
    sys_ = kernels.newton_kkt_plain(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
    x, ok = step_solution(*sys_['b'].shape)
    ds_p = torch.empty_like(state['s'])
    out_p = kernels.ip_step_plain(x, ok, sys_['rn'], sys_['r1'], state, derivs, lbw, ubw, free,
                                  0.99, 0.4, 1e-8, ds_out=ds_p)
    both_nan = {k: v.clone() for k, v in out_p.items()}
    both_nan[key if key != 'ds' else 'w'][0] = float('nan')
    gaps = step_gaps(both_nan, both_nan, state, ds_p, ds_p, x, ok, derivs, free)
    assert step_within_tolerance(gaps), gaps
    out, ds = {k: v.clone() for k, v in out_p.items()}, ds_p.clone()
    flat = (ds if key == 'ds' else out[key]).view(-1)
    flat[int(torch.nonzero(torch.isfinite(flat))[-1])] = float('nan')
    gaps = step_gaps(out, out_p, state, ds, ds_p, x, ok, derivs, free)
    assert gaps[key] == float('inf') and not step_within_tolerance(gaps), gaps


# --- K8-K11 and K4's advance_state: the block and condensed KKT modes --------

BLOCK_LAYOUTS = {'tiny': (2, 3, 5, 4, 15), 'n_k=4': (4, 11, 54, 20, 96),
                 'n_k=8': (8, 11, 54, 20, 96)}   # (n_k, nx, ni, nb, nloc)


def random_frames(lay, B, seed=0, device='cpu'):
    """Symmetric positive definite frames (B, n_k, nloc, nloc) laid out as
    ocp/blockkkt.py's: frame 0's x_0 slot empty (zero rows and columns);
    with the damping delta (B,) and the ownership mask own_free (n_k,
    nloc). Lane 1 (if B > 2) has an indefinite interior pivot, lane 2 a NaN
    entry: both must fail alone."""
    from awebox_tpu_torch.parallel import kernels
    lay = kernels.BlockLayout(*lay)
    n_k, nx, nloc = lay.n_k, lay.nx, lay.nloc
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n_k, nloc, nloc)) * 10.0 ** rng.uniform(-1, 1, (B, n_k, nloc, 1))
    F = G @ G.transpose(0, 1, 3, 2) / nloc + np.eye(nloc) * 0.1
    F[:, 0, :nx, :] = 0.
    F[:, 0, :, :nx] = 0.
    if B > 2:
        F[1, n_k - 1, 2 * nx + 3, 2 * nx + 3] = -1.0
        F[2, 0, 2 * nx + 1, nloc - 1] = F[2, 0, nloc - 1, 2 * nx + 1] = np.nan
    own = np.ones((n_k, nloc))
    own[0, :nx] = 0.
    own[:-1, nx:2 * nx] = 0.
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return lay, t(F), t(10.0 ** rng.uniform(-8, -2, B)), t(own)


def block_index_maps(lay, seed=0, device='cpu'):
    """chain_V, intr_V, border_V of a random partition of the n variables."""
    n = lay.n_k * (lay.nx + lay.ni) + lay.nb
    perm = np.random.default_rng(seed).permutation(n)
    nc, ni_all = lay.n_k * lay.nx, lay.n_k * lay.ni
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    return (t(perm[:nc].reshape(lay.n_k, lay.nx)), t(perm[nc:nc + ni_all].reshape(lay.n_k, lay.ni)),
            t(perm[nc + ni_all:])), n


def kb8_perm(r, nx, ni):
    """The position of frame variable r in K8's permuted frame [interior |
    x_k | x_{k+1} | border]."""
    return ni + r if r < 2 * nx else (r - 2 * nx if r < 2 * nx + ni else r)


def kb8_factor_mirror(A, npiv, w=8):
    """K8's panels (kb8_factor) on the lower triangle of A, in place: the
    first npiv columns in panels of w, each factored column by column (the
    pivot's 1/sqrt, the column scaled, the panel's later columns updated),
    then the trailing lower triangle less the panel's rank-w product.
    Returns False where a pivot is <= 0 or not finite."""
    for p0 in range(0, npiv, w):
        q0 = min(p0 + w, npiv)
        for j in range(p0, q0):
            d2 = A[j, j]
            if not (d2 > 0) or not np.isfinite(d2):
                return False
            rs = 1. / np.sqrt(d2)
            A[j + 1:, j] *= rs
            A[j, j] = d2 * rs
            for jj in range(j + 1, q0):
                A[jj:, jj] -= A[jj:, j] * A[jj, j]
        L = A[q0:, p0:q0]
        A[q0:, q0:] -= np.tril(L @ L.T)
    return True


def kb8_gather_mirror(S, lay):
    """R's lower triangle from the frames' Schur complements S[k] (c x c,
    coupling order [x_k | x_{k+1} | border]) as K8's gather forms it: each
    entry its frames' terms summed in frame order; frame 0's x_0 slot maps
    nowhere."""
    n_k, nx = lay.n_k, lay.nx
    nc, nr, xb = n_k * nx, lay.nr, 2 * nx
    blk = lambda q: divmod(q, nx) if q < nc else (n_k, q - nc)
    R = np.zeros((nr, nr))
    for i in range(nr):
        bi, oi = blk(i)
        for j in range(i + 1):
            bj, oj = blk(j)
            if bi == n_k and bj == n_k:       # border x border: every frame
                terms = [S[q][xb + oi, xb + oj] for q in range(n_k)]
            elif bi == n_k:                   # border x x_{bj+1}: frames bj, bj + 1
                terms = [S[bj][xb + oi, nx + oj]] + ([S[bj + 1][xb + oi, oj]] if bj + 1 < n_k else [])
            elif bi == bj:                    # x_{bi+1} x x_{bi+1}: frames bi, bi + 1
                terms = [S[bi][nx + oi, nx + oj]] + ([S[bi + 1][oi, oj]] if bi + 1 < n_k else [])
            elif bi == bj + 1:                # x_{bi+1} x x_{bi}: frame bi
                terms = [S[bi][nx + oi, oj]]
            else:
                terms = []
            R[i, j] = sum(terms, 0.)
    return R


def block_factor_mirror(Frame, delta, own_free, lay):
    """K8's schedule on one lane at a time, in numpy f64: each frame copied
    in the permuted order [interior | x_k | x_{k+1} | border] (NaN above the
    diagonal, which nothing may read: the bound counts the lower triangle
    alone) and damped, its
    first ni columns factored in panels (Li, Xc^T below it, S the trailing
    block), R gathered from the S in frame order, R factored in panels."""
    n_k, nx, ni, nb, nloc = lay
    nr, c = n_k * nx + nb, 2 * nx + nb
    perm = np.array([kb8_perm(r, nx, ni) for r in range(nloc)])
    B = Frame.shape[0]
    Li = np.zeros((B, n_k, ni, ni)); Xc = np.zeros((B, n_k, ni, c)); LR = np.zeros((B, nr, nr))
    ok = np.zeros(B, bool)
    for lane in range(B):
        S, failed = [], False
        for k in range(n_k):
            F = Frame[lane, k].copy()
            F[np.arange(nloc), np.arange(nloc)] += delta[lane] * own_free[k]
            P = np.zeros((nloc, nloc))
            P[np.ix_(perm, perm)] = F
            P[np.triu_indices(nloc, 1)] = np.nan   # nothing may read above the diagonal
            failed = not kb8_factor_mirror(P, ni)
            Li[lane, k] = np.tril(P[:ni, :ni])
            Xc[lane, k] = P[ni:, :ni].T
            S.append(P[ni:, ni:])
            failed = failed or not np.isfinite(Li[lane, k]).all()
            if failed:
                break
        if not failed:
            R = kb8_gather_mirror(S, lay)
            failed = not kb8_factor_mirror(R, nr)
        if not failed:
            LR[lane] = np.tril(R)
            failed = not np.isfinite(LR[lane]).all()
        if failed:
            LR[lane] = np.nan
        ok[lane] = not failed
    return Li, Xc, LR, ok


def ks_tile_sum(M, x):
    """A tile's products as warps 1 .. 7 of ks_forward / ks_backward sum them:
    four interleaved partial sums (column k into sum k % 4), then (a0 + a1)
    + (a2 + a3). M (rows, w) with w <= 32, x (w,)."""
    a = [np.zeros(M.shape[0]) for _ in range(4)]
    for k in range(M.shape[1]):
        a[k % 4] = a[k % 4] + M[:, k] * x[k]
    return (a[0] + a[1]) + (a[2] + a[3])


def tri_lower_mirror(L, b, nb=32):
    """ks_forward's order of sums: row tile i takes the column tiles c <= i - 2
    in order, each as one ks_tile_sum, then the fold of tile i - 1 (its
    products in column order, from zero), then the diagonal tile's chain,
    x_j = b_j * (1 / L_jj) with the reciprocals formed ahead."""
    m = len(b); y = b.copy(); rinv = 1. / np.diag(L)
    for i in range(-(-m // nb)):
        r0, r1 = i * nb, min(i * nb + nb, m)
        for c in range(i - 1):
            y[r0:r1] -= ks_tile_sum(L[r0:r1, c * nb:c * nb + nb], y[c * nb:c * nb + nb])
        acc = np.zeros(r1 - r0)
        for j in range(max(0, r0 - nb), r0):
            acc = acc - L[r0:r1, j] * y[j]
        t = y[r0:r1] + acc
        for j in range(r1 - r0):
            t[j] = t[j] * rinv[r0 + j]
            t[j + 1:] -= L[r0 + j + 1:r1, r0 + j] * t[j]
        y[r0:r1] = t
    return y


def tri_upper_t_mirror(L, b, nb=32):
    """ks_backward's order: row tile t takes the x tiles q >= t + 2 from the
    last (each as one ks_tile_sum over L's rows of tile q), then the fold of
    tile t + 1 (from its last row up, from zero), then the chain from the
    tile's last column, with the reciprocals of the diagonal."""
    m = len(b); y = b.copy(); rinv = 1. / np.diag(L); T = -(-m // nb)
    for t in range(T - 1, -1, -1):
        r0, r1 = t * nb, min(t * nb + nb, m)
        for q in range(T - 1, t + 1, -1):
            q0, q1 = q * nb, min(q * nb + nb, m)
            y[r0:r1] -= ks_tile_sum(L[q0:q1, r0:r1].T, y[q0:q1])
        acc = np.zeros(r1 - r0)
        for j in range(min(r1 + nb, m) - 1, r1 - 1, -1):
            acc = acc - L[j, r0:r1] * y[j]
        u = y[r0:r1] + acc
        for j in range(r1 - r0 - 1, -1, -1):
            u[j] = u[j] * rinv[r0 + j]
            u[:j] -= L[r0 + j, r0:r0 + j] * u[j]
        y[r0:r1] = u
    return y


def ks_step_tile(s, idx, T, warp):
    """ks_step_tile of csrc/auglu.cu: the idx-th tile (ti, tj) warp takes in
    step s (s < T forward, then backward, row tile 2T - 1 - s), or None."""
    if s < T:
        if warp == 0:
            return (s + idx, s) if idx == 0 or (idx == 1 and s + 1 < T) else None
        ti = s + warp + 7 * idx
        return (ti, s - 1) if s > 0 and ti < T else None
    t = 2 * T - 1 - s
    if warp == 0:
        return (t, t - idx) if idx == 0 or (idx == 1 and t > 0) else None
    tj = t - warp - 7 * idx
    return (t + 1, tj) if t + 1 < T and tj >= 0 else None


def ks_walk(T, warp):
    """The tiles a warp's ring copies, in order (KsRing's walk)."""
    for s in range(2 * T):
        idx = 0
        while (tile := ks_step_tile(s, idx, T, warp)) is not None:
            yield tile
            idx += 1


def ks_schedule_mirror(L, b, nb=32):
    """ks_forward then ks_backward step by step as the CTA runs them, each
    tile taken from its warp's walk (which must be the tile the step asks
    for): warp 0's chain with its fold, then warps 1 .. 7's tiles of the
    step, on the lane's vector padded with zeros to 32 T."""
    m = len(b); T = -(-m // nb); P = T * nb
    Lp = np.zeros((P, P)); Lp[:m, :m] = L
    y = np.zeros(P); y[:m] = b
    rinv = np.ones(P); rinv[:m] = 1. / np.diag(L)
    walks = [ks_walk(T, w) for w in range(8)]

    def take(w, ti, tj):
        assert next(walks[w]) == (ti, tj), (w, ti, tj)
        return Lp[ti * nb:ti * nb + nb, tj * nb:tj * nb + nb]

    acc = np.zeros(nb)
    for s in range(T):
        r0, h = s * nb, min(nb, m - s * nb)
        D = take(0, s, s)
        E = take(0, s + 1, s) if s + 1 < T else None
        u, an = y[r0:r0 + nb] + acc, np.zeros(nb)
        for j in range(h):
            u[j] = u[j] * rinv[r0 + j]
            u[j + 1:h] -= D[j + 1:h, j] * u[j]
            if E is not None:
                an = an - E[:, j] * u[j]
        y[r0:r0 + h] = u[:h]
        acc = an
        for w in range(1, 8):
            for i in range(s + w, T, 7) if s > 0 else ():
                rows = slice(i * nb, min(i * nb + nb, m))
                tile = take(w, i, s - 1)[:rows.stop - rows.start]
                y[rows] -= ks_tile_sum(tile, y[r0 - nb:r0])
    acc = np.zeros(nb)
    for t in range(T - 1, -1, -1):
        r0, h = t * nb, min(nb, m - t * nb)
        D = take(0, t, t)
        E = take(0, t, t - 1) if t > 0 else None
        u, an = y[r0:r0 + nb] + acc, np.zeros(nb)
        for j in range(h - 1, -1, -1):
            u[j] = u[j] * rinv[r0 + j]
            u[:j] -= D[j, :j] * u[j]
            if E is not None:
                an = an - E[j, :] * u[j]
        y[r0:r0 + h] = u[:h]
        acc = an
        for w in range(1, 8):
            for i in range(t - w, -1, -7) if t + 1 < T else ():
                y[i * nb:i * nb + nb] -= ks_tile_sum(take(w, t + 1, i).T, y[r0 + nb:r0 + 2 * nb])
    assert all(next(wk, None) is None for wk in walks)   # every copied tile was taken
    return y[:m]


def strided_sum(M, x):
    """K9's coupling products, four threads an output: thread p sums the terms
    p, p + 4, .. in order, then (s0 + s1) + (s2 + s3). M (outputs, terms)."""
    s = [np.zeros(M.shape[0]) for _ in range(4)]
    for k in range(M.shape[1]):
        s[k % 4] = s[k % 4] + M[:, k] * x[k]
    return (s[0] + s[1]) + (s[2] + s[3])


def block_solve_mirror(Li, Xc, LR, rhs, chain_V, intr_V, border_V, lay):
    """K9's schedule on one lane at a time: each frame's interior forward
    (rank k), its coupling products Xc_k^T t_k, the reduced right-hand side
    in frame order, the reduced pair (rank 0), then each frame's Xc_k x
    subtracted and its interior backward."""
    n_k, nx, ni, nb, nloc = lay
    nr, c, nc = n_k * nx + nb, 2 * nx + nb, n_k * nx
    B, n = rhs.shape
    out = np.zeros_like(rhs)
    for lane in range(B):
        v = rhs[lane]
        t = v[intr_V].reshape(n_k, ni).copy()
        rr = np.concatenate([v[chain_V.reshape(-1)], v[border_V]])
        for k in range(n_k):
            t[k] = tri_lower_mirror(Li[lane, k], t[k])
        upd = np.stack([strided_sum(Xc[lane, k].T, t[k]) for k in range(n_k)])
        for q in range(nr):
            if q < nc:
                j, a = divmod(q, nx)
                rr[q] -= upd[j, nx + a]
                if j + 1 < n_k:
                    rr[q] -= upd[j + 1, a]
            else:
                s = 0.
                for k in range(n_k):
                    s += upd[k, 2 * nx + q - nc]
                rr[q] -= s
        rr = tri_lower_mirror(LR[lane], rr)
        rr = tri_upper_t_mirror(LR[lane], rr)
        for k in range(n_k):
            xa = np.concatenate([rr[nc:nc + nx] if k == 0 else rr[(k - 1) * nx:k * nx],
                                 rr[k * nx:(k + 1) * nx], rr[nc:]])
            t[k] -= strided_sum(Xc[lane, k], xa)
            t[k] = tri_upper_t_mirror(Li[lane, k], t[k])
        out[lane, intr_V.reshape(-1)] = t.reshape(-1)
        out[lane, chain_V.reshape(-1)] = rr[:nc]
        out[lane, border_V] = rr[nc:]
    return out


def chol_factor_mirror(M, nb=32):
    """K10's schedule: panels of nb columns, right-looking."""
    B, n, _ = M.shape
    L = np.tril(M).copy(); ok = np.ones(B, bool)
    for lane in range(B):
        Lw = L[lane]; failed = False
        for j0 in range(0, n, nb):
            w = min(nb, n - j0)
            P = Lw[j0:, j0:j0 + w].copy()
            for cc in range(w):
                d2 = P[cc, cc]
                if not (d2 > 0) or not np.isfinite(d2):
                    failed = True; break
                dp = np.sqrt(d2)
                P[cc + 1:, cc] /= dp
                P[cc, cc] = dp
                for c2 in range(cc + 1, w):
                    P[c2:, c2] -= P[c2:, cc] * P[c2, cc]
            if failed:
                break
            Lw[j0:, j0:j0 + w] = np.tril(P)
            Pt = P[w:]
            Lw[j0 + w:, j0 + w:] -= np.tril(Pt @ Pt.T)
        if failed or not np.isfinite(Lw).all():
            Lw[:] = np.nan; ok[lane] = False
    return L, ok


def k10c_panel_mirror(T, w):
    """chol_factor_cluster_kernel's panel factor (k10c_panel) in place on T,
    the panel's rows from its diagonal (w columns): column by column, the
    pivot's 1/sqrt, the column below it scaled, L_jj = d2 / sqrt(d2), the
    panel's later columns updated, as warp 0's chain and the row sweep below
    the block both do. Returns False where a pivot is <= 0 or not finite."""
    ok = True
    for j in range(w):
        d2 = T[j, j]
        ok = ok and bool(d2 > 0) and bool(np.isfinite(d2))
        with np.errstate(invalid='ignore', divide='ignore'):
            rs = 1. / np.sqrt(d2)
        T[j + 1:, j] *= rs
        T[j, j] = d2 * rs
        for jj in range(j + 1, w):
            T[jj:, jj] -= T[jj:, j] * T[jj, j]
    return ok


def k10c_update_mirror(T, Pr, q0, base, w):
    """k10c_tile_pair over all of T's row tiles: T (rows q0.., w columns) less
    the rank-16 product of the applied panel Pr (rows base..), as
    k10s_tiles_mirror takes it."""
    k10s_tiles_mirror(T, Pr[q0 - base:], Pr[q0 - base:q0 - base + 16], 0, -(-T.shape[0] // 8), w)


def chol_factor_cluster_mirror(M, geom=None):
    """K10's cluster variant on one lane at a time, in numpy f64: each rank's
    panels of 16 (chol_factor_geometry's deal) copied in from M's lower
    triangle alone (M may hold NaN above the diagonal: nothing reads there),
    panel 0 factored by its owner, then a phase a panel: the owner's flag
    stops every rank; each rank receives the panel's rows below its first
    trailing column (the kernel hands them over through the L2 and, to the
    next panel's owner, its first 32 rows through distributed shared
    memory: the same values); the owner of p + 1 applies panel p to it and
    factors it (the look-ahead), every rank applies panel p to its other
    trailing panels; L gathered from the ranks' panels, NaN where the lane
    failed."""
    from awebox_tpu_torch.parallel import kernels
    B, n, _ = M.shape
    g = geom or kernels.chol_factor_geometry(n)
    nb, C = g.nb, g.C
    P = -(-n // nb)
    owner = lambda p: p % C
    L = np.zeros_like(M); ok = np.ones(B, bool)
    for lane in range(B):
        A = M[lane]
        pan = {}
        for r in range(C):
            for p in g.panels[r]:
                q0, w = p * nb, min(nb, n - p * nb)
                T = np.zeros((n - q0, nb))
                for i in range(q0, n):
                    cols = range(q0, min(q0 + w, i + 1))
                    T[i - q0, :len(cols)] = [A[i, j] for j in cols]
                pan[p] = T
        failed = not k10c_panel_mirror(pan[0], min(nb, n))
        for k in range(P - 1):
            if failed:
                break
            base = (k + 1) * nb
            recv = {}
            for r in range(C):
                later = [p for p in g.panels[r] if p > k]
                if later:
                    lo = later[0] * nb
                    recv[r] = np.full((n - base, nb), np.nan)
                    recv[r][lo - base:] = pan[k][lo - k * nb:]
            o = owner(k + 1)
            q0 = (k + 1) * nb
            k10c_update_mirror(pan[k + 1], recv[o], q0, base, min(nb, n - q0))
            failed = not k10c_panel_mirror(pan[k + 1], min(nb, n - q0))
            for r in range(C):
                for p in g.panels[r]:
                    if p > k + (1 if r == o else 0):
                        k10c_update_mirror(pan[p], recv[r], p * nb, base, min(nb, n - p * nb))
        Lw = L[lane]
        for p, T in pan.items():
            q0, w = p * nb, min(nb, n - p * nb)
            Lw[q0:, q0:q0 + w] = np.tril(T[:, :w])
        if failed or not np.isfinite(Lw).all():
            Lw[:] = np.nan; ok[lane] = False
    return L, ok


def k10s_tiles_mirror(T, A_rows, B_rows, I_lo, I_hi, w):
    """k10c_tile_pair on row tiles I_lo .. I_hi - 1 of the panel T (its rows
    from the panel's diagonal, w columns): A_rows, the applied panel's rows
    of those tiles; B_rows, its 16 rows of T's diagonal block. Each entry's
    products summed from zero in four k-steps of 4, then subtracted once;
    tile (0, 1) and the entries above the diagonal left alone."""
    h = T.shape[0]
    r_lo, r_hi = 8 * I_lo, min(8 * I_hi, h)
    if r_lo >= r_hi:
        return
    rows = np.arange(r_lo, r_hi)
    A = A_rows[:r_hi - r_lo]
    for J in range(2):
        cols = np.arange(8 * J, min(8 * J + 8, w))
        sel = rows >= 8 * J if J else np.ones(len(rows), bool)
        if len(cols) == 0 or not sel.any():
            continue
        upd = np.zeros((int(sel.sum()), len(cols)))
        for s in range(4):
            k = slice(4 * s, 4 * s + 4)
            upd = upd + A[sel][:, k] @ B_rows[cols][:, k].T
        r = rows[sel]
        blk = T[np.ix_(r, cols)]
        T[np.ix_(r, cols)] = np.where(cols[None, :] <= r[:, None], blk - upd, blk)


def k10s_pairs(I0, I1, warps=8):
    """The row tiles k10s_apply's warps take of a chunk's tiles I0 .. I1 - 1
    of a panel: warp w the pairs (I, I + 1), I = I0 + 2 w, I0 + 2 w + 16, .."""
    return sorted(t for w in range(warps) for I in range(I0 + 2 * w, I1, 2 * warps)
                  for t in (I, I + 1))


def chol_factor_stream_mirror(M, geom=None):
    """K10's stream variant on one lane at a time, in numpy f64, step by step
    as its ranks run it: the panels of chol_factor_geometry's deal copied in
    from M's lower triangle alone (M may hold NaN above the diagonal); panel 0
    factored by rank 0; then a phase a panel: the owner's flag stops every
    rank; o(p + 1) updates panel p + 1 by panel p (warp 0 its rows 0 .. 31
    from the 32 rows o(p) handed over, warp w its rows 32 w + 224 c .. + 31 of
    chunk c, fetched by itself) and factors it; every rank applies panel p to
    its other trailing panels a chunk of rows at a time, each warp the
    pairs of row tiles k10s_pairs gives, with each panel's B rows from its own
    first 16 rows of panel p (256 rows a chunk). Every buffer a step reads
    is NaN outside what
    the step fetched, so a tile taken outside its chunk shows up as NaN in L;
    the tiles the pairs cover are checked to be the chunk's. L gathered from
    the panels, NaN where the lane failed."""
    from awebox_tpu_torch.parallel import kernels
    B, n, _ = M.shape
    g = geom or kernels.chol_factor_geometry(n)
    nb, C, CH, ROWSTEP = g.nb, g.C, g.recv_rows, kernels.CHOL_STREAM_ROWSTEP
    P = -(-n // nb)
    L = np.zeros_like(M); ok = np.ones(B, bool)
    for lane in range(B):
        A = M[lane]
        pan = {}
        for ps in g.panels:
            for p in ps:
                q0, w = p * nb, min(nb, n - p * nb)
                T = np.zeros((n - q0, nb))
                for i in range(q0, n):
                    cols = range(q0, min(q0 + w, i + 1))
                    T[i - q0, :len(cols)] = [A[i, j] for j in cols]
                pan[p] = T

        def rows_of(k, lo, hi):
            """panel k's rows lo .. hi - 1 (global row numbers) as L holds them"""
            return pan[k][lo - k * nb:hi - k * nb]

        failed = not k10c_panel_mirror(pan[0], min(nb, n))
        for k in range(P - 1):
            if failed:
                break
            q0, w = (k + 1) * nb, min(nb, n - (k + 1) * nb)
            T, h = pan[k + 1], n - (k + 1) * nb
            head = np.full((32, nb), np.nan)
            head[:min(32, h)] = rows_of(k, q0, min(n, q0 + 32))   # o(k)'s hbuf
            k10s_tiles_mirror(T, head, head[:16], 0, 4, w)
            for warp in range(1, 8):
                for c in range(-(-max(h - 32 * warp, 0) // ROWSTEP)):
                    lo = q0 + 32 * warp + ROWSTEP * c
                    own = np.full((32, nb), np.nan)
                    own[:min(32, n - lo)] = rows_of(k, lo, min(n, lo + 32))
                    I = (lo - q0) // 8
                    k10s_tiles_mirror(T, own, head[:16], I, I + 4, w)
            failed = not k10c_panel_mirror(T, w)
            for r, ps in enumerate(g.panels):
                trail = [p for p in ps if p > k + (1 if r == (k + 1) % C else 0)]
                if not trail:
                    continue
                dbuf = {p: rows_of(k, p * nb, min(n, p * nb + 16)) for p in trail}
                for lo in range(trail[0] * nb, n, CH):
                    hi = min(n, lo + CH)
                    recv = np.full((CH, nb), np.nan)
                    recv[:hi - lo] = rows_of(k, lo, hi)
                    for p in trail:
                        pq0 = p * nb
                        if pq0 >= hi:
                            break
                        ph = n - pq0
                        I0, I1 = (max(lo, pq0) - pq0) // 8, (hi - pq0 + 7) // 8
                        covered = [t for t in k10s_pairs(I0, I1) if 8 * t < ph]
                        assert covered == list(range(I0, min(I1, -(-ph // 8)))), (k, r, p, lo)
                        Bm = np.full((16, nb), np.nan)
                        Bm[:len(dbuf[p])] = dbuf[p]
                        k10s_tiles_mirror(pan[p], recv[8 * I0 + pq0 - lo:], Bm, I0, I1,
                                          min(nb, ph))
        Lw = L[lane]
        for p, T in pan.items():
            q0, w = p * nb, min(nb, n - p * nb)
            Lw[q0:, q0:q0 + w] = np.tril(T[:, :w])
        if failed or not np.isfinite(Lw).all():
            Lw[:] = np.nan; ok[lane] = False
    return L, ok


def chol_test_matrices(n, B=4, seed=None):
    """SPD lanes (cond ~ 1e3) with lane 1 made indefinite and lane 2 given a
    NaN in both triangles, as test_chol_mirrors_match_plain builds them."""
    rng = np.random.default_rng(n if seed is None else seed)
    G = rng.standard_normal((B, n, n))
    M = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    M[1, n // 2, n // 2] = -1.0
    M[2, n - 1, 3] = M[2, 3, n - 1] = np.nan
    return M


@pytest.mark.parametrize('n', [37, 280, 540])
def test_chol_cluster_mirror_matches_plain(n):
    """K10's cluster schedule (chol_factor_cluster_mirror: the panel deal of
    chol_factor_geometry, the look-ahead order, tiles of 8 on or below the
    diagonal with their k-steps in order), fed M with NaN above the diagonal,
    against chol_factor_batched_plain on the symmetric M: L to 1e-13 of its
    max on SPD lanes, the indefinite and the NaN lane failing alone (ok
    False, L NaN throughout)."""
    from awebox_tpu_torch.parallel import kernels
    M = chol_test_matrices(n)
    Lp, okp = kernels.chol_factor_batched_plain(torch.as_tensor(M))
    Mu = M.copy()
    Mu[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    Lm, okm = chol_factor_cluster_mirror(Mu)
    assert okp.tolist() == okm.tolist() == [True, False, False, True]
    good = [0, 3]
    assert np.abs(Lp.numpy()[good] - Lm[good]).max() <= 1e-13 * np.abs(Lm[good]).max()
    assert np.isnan(Lp.numpy()[[1, 2]]).all() and np.isnan(Lm[[1, 2]]).all()
    assert (Lm[good][:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] == 0).all()


CHOL_CLUSTER_LAST = 554     # the largest n the cluster variant holds
CHOL_STREAM_LAST = 1536     # the largest n the stream variant holds


@pytest.mark.parametrize('n', [37, 280, 540, CHOL_CLUSTER_LAST, CHOL_CLUSTER_LAST + 1, 876, 877,
                               1190, CHOL_STREAM_LAST, CHOL_STREAM_LAST + 1])
def test_chol_factor_geometry(n):
    """K10 takes its cluster variant up to n = 554, with the fewest CTAs of 4,
    8 and 16 (a non-portable cluster) that hold the lane (never more than it
    has panels: 3 at n = 37, 4 at 280, 16 at 540), the stream variant (16
    CTAs) from 555 to 1536, and raises by name at 1537. In both layouts every
    panel of 16 is dealt to exactly one rank (panel p to rank p % C). In the
    cluster layout each rank stores each of its panels' lower-triangle rows
    (p 16 .. n - 1) once, one after another and then the receive buffer (n -
    16 rows), at leading dimension 20 (4 mod 8 doubles), within one block's
    shared memory; in the stream layout a rank keeps the longest run of its
    last panels that fits its resident rows, one after another, the others
    in L, beside a receive buffer of 256 rows, the handoff buffer's 32 and
    16 rows for each of 6 panels, within one block's shared memory."""
    from awebox_tpu_torch.parallel import kernels
    if n > CHOL_STREAM_LAST:
        with pytest.raises(ValueError, match='chol_factor_batched'):
            kernels.chol_factor_geometry(n)
        return
    g = kernels.chol_factor_geometry(n)
    assert g.smem_bytes + kernels.CHOL_STATIC_SMEM <= kernels.SMEM_PER_BLOCK
    assert g.nb == 16 and g.ld == 20 and g.ld % 8 == 4
    P = -(-n // 16)
    dealt = sorted(p for ps in g.panels for p in ps)
    assert dealt == list(range(P))
    assert all(p % g.C == r for r, ps in enumerate(g.panels) for p in ps)
    if n > CHOL_CLUSTER_LAST:
        assert (g.variant, g.C) == ('stream', 16)
        cap = g.recv_off // g.ld
        assert g.recv_off == cap * g.ld and g.recv_rows == kernels.CHOL_STREAM_CHUNK
        assert g.smem_bytes == 8 * g.ld * (cap + kernels.CHOL_STREAM_CHUNK + 32 + 16 * 6)
        assert kernels.SMEM_PER_BLOCK - kernels.CHOL_STATIC_SMEM - g.smem_bytes < 8 * g.ld
        assert max(len(ps) for ps in g.panels) <= kernels.CHOL_STREAM_LOCAL
        for ps, offs in zip(g.panels, g.offsets):
            rows = [n - 16 * p for p in ps]
            t_res = sum(o is None for o in offs)
            assert all(o is None for o in offs[:t_res])   # the first panels in L
            assert list(offs[t_res:]) == list(itertools.accumulate(rows[t_res:-1], initial=0))[
                :len(ps) - t_res]
            assert sum(rows[t_res:]) <= cap                       # the rest fits ...
            assert t_res == 0 or sum(rows[t_res - 1:]) > cap      # ... and no more does
        in_l2 = [sum(o is None for o in offs) for offs in g.offsets]
        if n == CHOL_CLUSTER_LAST + 1:
            assert in_l2 == [0] * 16                    # the whole lane fits at 555
        if n == 1190:
            assert in_l2 == [3] * 5 + [2] * 11
        return
    assert g.variant == 'cluster'
    assert g.C == {37: 3, 280: 4, 540: 16, CHOL_CLUSTER_LAST: 16}[n]
    assert all(kernels.chol_cluster_layout(n, c) is None
               for c in kernels.CHOL_CLUSTER_SIZES if c < g.C)
    stored = set()
    for r, (ps, offs) in enumerate(zip(g.panels, g.offsets)):
        end = 0
        for p, off in zip(ps, offs):
            assert off == end                   # one after another, no gap, no overlap
            end = off + n - 16 * p
            for i in range(16 * p, n):          # row i of panel p, once
                assert (p, i) not in stored
                stored.add((p, i))
        assert end * g.ld <= g.recv_off
    assert stored == {(p, i) for p in range(P) for i in range(16 * p, n)}
    assert g.recv_rows == (n - 16 if P > 1 else 0)
    assert g.smem_bytes == 8 * (g.recv_off + g.recv_rows * g.ld)
    if n == CHOL_CLUSTER_LAST:
        nxt = kernels.chol_factor_geometry(n + 1)
        assert nxt.variant == 'stream'


@pytest.mark.parametrize('n', [555, 700, 876, 1190])
def test_chol_stream_mirror_matches_plain(n):
    """K10's stream schedule (chol_factor_stream_mirror: the deal of
    chol_factor_geometry, the look-ahead's handoff of 32 rows and the warps'
    own chunks, the chunked handoff of 256 rows with each panel's B rows
    fetched ahead, tiles of 8 on or below the diagonal with their k-steps in
    order, every buffer NaN outside what its step fetched), fed M with NaN
    above the diagonal, against chol_factor_batched_plain on the symmetric M:
    L to 1e-13 of its max on SPD lanes, the indefinite and the NaN lane
    failing alone (ok False, L NaN throughout)."""
    from awebox_tpu_torch.parallel import kernels
    M = chol_test_matrices(n)
    Lp, okp = kernels.chol_factor_batched_plain(torch.as_tensor(M))
    Mu = M.copy()
    Mu[:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] = np.nan
    Lm, okm = chol_factor_stream_mirror(Mu)
    assert okp.tolist() == okm.tolist() == [True, False, False, True]
    good = [0, 3]
    assert np.abs(Lp.numpy()[good] - Lm[good]).max() <= 1e-13 * np.abs(Lm[good]).max()
    assert np.isnan(Lp.numpy()[[1, 2]]).all() and np.isnan(Lm[[1, 2]]).all()
    assert (Lm[good][:, np.triu_indices(n, 1)[0], np.triu_indices(n, 1)[1]] == 0).all()


def test_chol_stream_mirror_is_the_cluster_schedule():
    """Where both variants apply, the stream schedule gives the cluster
    schedule's bits: the chunks change where a sum's terms come from, not
    its order (n = 540 dealt over 16 ranks as the stream variant deals it,
    every panel of it in shared memory)."""
    from awebox_tpu_torch.parallel import kernels
    n = 540
    M = chol_test_matrices(n, seed=3)
    g = kernels.chol_factor_geometry(n)
    assert g.variant == 'cluster' and g.C == 16
    stream = kernels.CholGeometry('stream', 16, 16, 20, kernels.chol_deal(n, 16),
                                  tuple((0,) * len(ps) for ps in kernels.chol_deal(n, 16)),
                                  1049 * 20, kernels.CHOL_STREAM_CHUNK, 0)
    L_c, ok_c = chol_factor_cluster_mirror(M, g)
    L_s, ok_s = chol_factor_stream_mirror(M, stream)
    assert ok_c.tolist() == ok_s.tolist() == [True, False, False, True]
    assert np.array_equal(L_c, L_s, equal_nan=True)


@pytest.mark.parametrize('name', list(BLOCK_LAYOUTS))
def test_block_factor_mirror_matches_plain(name):
    """K8's schedule (each frame permuted to [interior | x_k | x_{k+1} |
    border] and its interior factored in panels of 8 on the lower triangle,
    S summed into R in frame order, R factored in panels) against
    block_factor_plain: Li and Xc to 1e-12 of their max, R = L_R L_R^T to
    1e-12 of its max (the frames are well conditioned; only the order of the
    sums differs); ok lane by lane, the indefinite and the NaN lane failing
    alone with a NaN L_R."""
    from awebox_tpu_torch.parallel import kernels
    lay, F, delta, own = random_frames(BLOCK_LAYOUTS[name], B=4, seed=len(name))
    ref = kernels.block_factor_plain(F, delta, own, lay)
    mir = block_factor_mirror(F.numpy(), delta.numpy(), own.numpy(), lay)
    np.testing.assert_array_equal(ref[3].numpy(), mir[3])
    assert ref[3].tolist() == [True, False, False, True]
    good = [0, 3]
    for k in range(2):
        a, b = ref[k].numpy()[good], mir[k][good]
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max(), k
    LR_p, LR_m = ref[2].numpy(), mir[2]
    R_p = LR_p[good] @ LR_p[good].transpose(0, 2, 1)
    R_m = LR_m[good] @ LR_m[good].transpose(0, 2, 1)
    assert np.abs(R_p - R_m).max() <= 1e-12 * np.abs(R_p).max()
    assert np.isnan(LR_p[[1, 2]]).all() and np.isnan(LR_m[[1, 2]]).all()


@pytest.mark.parametrize('name', list(BLOCK_LAYOUTS))
def test_block_solve_mirror_matches_plain(name):
    """K9's schedule (interior forward solves, the coupling updates summed in
    frame order, the reduced pair, the back substitution, in 32-row tiles)
    against block_solve_plain on the plain factor: 1e-11 of max |x| on the
    lanes that factored, NaN throughout on the lanes that failed; the
    solution satisfies the frames' M x = b."""
    from awebox_tpu_torch.parallel import kernels
    lay, F, delta, own = random_frames(BLOCK_LAYOUTS[name], B=4, seed=7)
    maps, n = block_index_maps(lay, seed=3)
    fac = kernels.block_factor_plain(F, delta, own, lay)
    rhs = torch.as_tensor(np.random.default_rng(5).standard_normal((4, n)))
    x = kernels.block_solve_plain(*fac[:3], rhs, maps, lay).numpy()
    xm = block_solve_mirror(*(f.numpy() for f in fac[:3]), rhs.numpy(),
                            *(m.numpy() for m in maps), lay)
    good = [0, 3]
    assert np.abs(x[good] - xm[good]).max() <= 1e-11 * np.abs(x[good]).max()
    assert np.isnan(x[[1, 2]]).all() and np.isnan(xm[[1, 2]]).all()
    # M from the frames, in the variables' order (frame slots -> variables)
    chain, intr, border = (m.numpy() for m in maps)
    Fd = F.numpy().copy()
    Fd[:, :, np.arange(lay.nloc), np.arange(lay.nloc)] += delta.numpy()[:, None, None] * own.numpy()
    for lane in good:
        M = np.zeros((n, n))
        for k in range(lay.n_k):
            b_slot = border[:lay.nx] if k == 0 else chain[k - 1]
            fv = np.concatenate([b_slot, chain[k], intr[k], border])
            M[np.ix_(fv, fv)] += Fd[lane, k]
        res = np.abs(M @ x[lane] - rhs.numpy()[lane]).max()
        assert res <= 1e-9 * np.abs(rhs.numpy()[lane]).max(), res


@pytest.mark.parametrize('n', [37, 280, 540])
def test_chol_mirrors_match_plain(n):
    """K10's schedule (panels of 32, each factored column by column, then the
    trailing update summed from zero) and K11's tiled substitutions against
    chol_factor_batched_plain / chol_solve_batched_plain: L to 1e-13 of its
    max, x to 1e-12 of its max on SPD lanes; a lane with a negative pivot and
    one with a NaN entry fail alone (ok False, L NaN), as potrf under
    jnp.linalg.cholesky."""
    from awebox_tpu_torch.parallel import kernels
    rng = np.random.default_rng(n)
    G = rng.standard_normal((4, n, n))
    M = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    M[1, n // 2, n // 2] = -1.0
    M[2, n - 1, 3] = M[2, 3, n - 1] = np.nan
    Lp, okp = kernels.chol_factor_batched_plain(torch.as_tensor(M))
    Lm, okm = chol_factor_mirror(M)
    assert okp.tolist() == okm.tolist() == [True, False, False, True]
    good = [0, 3]
    assert np.abs(Lp.numpy()[good] - Lm[good]).max() <= 1e-13 * np.abs(Lm[good]).max()
    assert np.isnan(Lp.numpy()[[1, 2]]).all() and np.isnan(Lm[[1, 2]]).all()
    b = rng.standard_normal((4, n))
    xp = kernels.chol_solve_batched_plain(Lp, torch.as_tensor(b)).numpy()
    xm = np.stack([tri_upper_t_mirror(Lm[i], tri_lower_mirror(Lm[i], b[i])) for i in good])
    assert np.abs(xp[good] - xm).max() <= 1e-12 * np.abs(xm).max()


@pytest.mark.parametrize('n', [37, 54, 64, 108, 280, 540])
def test_ks_schedule_matches_mirrors(n):
    """The substitutions' step schedule (warp 0's chain with its fold, warps 1
    .. 7 dealt the other tiles by ks_step_tile, each warp's ring walking its
    tiles in the order it takes them, every tile once) gives the mirrors'
    order of sums bit for bit: K11's x, and K9's frames and reduced pair."""
    rng = np.random.default_rng(n)
    G = rng.standard_normal((n, n))
    L = np.linalg.cholesky(G @ G.T / n + np.eye(n))
    b = rng.standard_normal(n)
    want = tri_upper_t_mirror(L, tri_lower_mirror(L, b))
    np.testing.assert_array_equal(ks_schedule_mirror(L, b), want)
    T = -(-n // 32)
    taken = sorted(t for w in range(8) for t in ks_walk(T, w))
    lower = sorted((i, j) for i in range(T) for j in range(i + 1))
    assert taken == sorted(lower * 2)   # each pass takes every lower tile once


@pytest.mark.parametrize('n_k', range(1, 14))
def test_block_factor_geometry(n_k):
    """K8 lays a lane out as a cluster of n_k CTAs (non-portable past 8), each
    with the larger of a frame (96 rows at leading dimension 100) and R plus
    S (42 rows at 44) in shared memory, leading dimensions 4 mod 8 doubles:
    two CTAs an SM up to n_k = 8, one block's shared memory up to n_k = 12;
    at n_k = 13 R has more rows than a panel holds and it raises by name."""
    from awebox_tpu_torch.parallel import kernels
    lay = kernels.BlockLayout(n_k, 11, 54, 20, 96)
    if n_k > 12:
        with pytest.raises(ValueError, match='block_factor'):
            kernels.block_factor_geometry(lay)
        return
    g = kernels.block_factor_geometry(lay)
    assert (g.ld_frame, g.ld_s) == (100, 44) and kernels.BLOCK_WIDTH == 8
    assert lay.nr <= g.ld_r < lay.nr + 8 and g.ld_r % 8 == 4
    assert g.smem_bytes == 8 * (max(96 * 100, lay.nr * g.ld_r) + 42 * 44)
    assert g.smem_bytes + kernels.BLOCK_STATIC_SMEM <= kernels.SMEM_PER_BLOCK
    assert {4: 91_584, 8: 108_096, 10: 152_064}.get(n_k, g.smem_bytes) == g.smem_bytes
    # two CTAs an SM (228 KB, 1 KB of it reserved a CTA) up to n_k = 8
    assert (2 * (g.smem_bytes + kernels.BLOCK_STATIC_SMEM + 1024) <= 228 * 1024) == (n_k <= 8)


@pytest.mark.parametrize('n_k', range(1, 14))
def test_block_solve_geometry(n_k):
    """K9 lays a lane out as a cluster of n_k CTAs, each with its frame's Li
    (three lower tiles at ni = 54) and Xc (54 rows at the odd leading
    dimension 43), rank 0 also L_R's lower tiles, then the vectors: every
    layout block_factor_geometry accepts (n_k <= 12) fits one block's
    shared memory, and n_k = 13 raises by name, as K8 does."""
    from awebox_tpu_torch.parallel import kernels
    lay = kernels.BlockLayout(n_k, 11, 54, 20, 96)
    if n_k > 12:
        with pytest.raises(ValueError, match='block_solve'):
            kernels.block_solve_geometry(lay)
        with pytest.raises(ValueError, match='block_factor'):
            kernels.block_factor_geometry(lay)
        return
    kernels.block_factor_geometry(lay)
    g = kernels.block_solve_geometry(lay)
    tr = -(-lay.nr // 32)
    assert (g.C, g.ld_x, g.li_tiles, g.r_tiles) == (n_k, 43, 3, tr * (tr + 1) // 2)
    assert kernels.SUBST_TILE_BYTES == 8 * 32 * 34
    assert g.smem_bytes == (g.li_tiles + g.r_tiles) * kernels.SUBST_TILE_BYTES \
        + 8 * (54 * 43 + 2 * 32 * (2 + tr) + n_k * 42)
    assert g.smem_bytes + kernels.SUBST_STATIC_SMEM <= kernels.SMEM_PER_BLOCK
    assert {4: 74_192, 8: 137_488, 12: 182_864}.get(n_k, g.smem_bytes) == g.smem_bytes


def test_advance_state_plain_takes_lanes_without_rows():
    """advance_state_plain without inequality rows (the s and lam ratios drop
    out) and without equality rows equals the full call's other outputs
    where those rows do not enter."""
    from awebox_tpu_torch.parallel import kernels
    args = random_step_inputs()
    state, direction = args[0], args[1]
    full = kernels.advance_state_plain(*args)
    for cut in ('ineq', 'eq'):
        st = dict(state)
        dr = list(direction)
        if cut == 'ineq':
            st['s'], st['lam'] = state['s'][:, :0], state['lam'][:, :0]
            dr[2], dr[3] = dr[2][:, :0], dr[3][:, :0]
        else:
            st['y'] = state['y'][:, :0]
            dr[1] = dr[1][:, :0]
        out = kernels.advance_state_plain(st, tuple(dr), *args[2:])
        assert all(bool(torch.isfinite(v).all()) for v in out.values()), cut
        if cut == 'eq':   # no y enters alpha: the step is the full call's
            for k in ('w', 's', 'lam', 'zl', 'zu', 'mu', 'err'):
                assert torch.equal(out[k], full[k]), k


def test_pointer_structs_match_the_field_orders():
    """newton_kkt and ip_step hand their tensors to csrc/auglu.cu as one array
    of pointers: kernels.NEWTON_FIELDS and STEP_FIELDS must name the fields
    of the structs NewtonPtrs and StepPtrs in their order (a mismatch would
    only show as wrong memory read on the card)."""
    from awebox_tpu_torch.parallel import kernels
    with open(kernels.SOURCE) as fh:
        src = fh.read()

    def fields(name):
        body = src[src.index(f'struct {name} {{'):]
        return tuple(re.findall(r'\*\s*(\w+);', body[:body.index('};')]))
    assert fields('NewtonPtrs') == kernels.NEWTON_FIELDS
    assert fields('StepPtrs') == kernels.STEP_FIELDS
    assert fields('AdvancePtrs') == kernels.ADVANCE_FIELDS
    assert set(kernels.NEWTON_OUTPUTS) <= set(kernels.NEWTON_FIELDS)


def test_wrappers_take_the_plain_version_on_cpu_only():
    """On CPU tensors no kernel is built or launched and no count moves,
    through the whole direction solve and the step."""
    from awebox_tpu_torch.parallel import batch, kernels
    before = dict(kernels.LAUNCHES)
    sys_ = saddle_systems()
    n = sys_[0].shape[1]
    for factor in batch.FACTORS:
        dw, dnu, ok = batch._auglu_solve(*sys_, n, 1e-8, 1e-8, N_LADDER, LADDER, factor=factor)
        assert bool(ok.all()) and bool(torch.isfinite(dw).all()), factor
    kernels.advance_state(*random_step_inputs())
    state, derivs, lbw, ubw, free = newton_inputs()
    out = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
    assert 'K' in kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8, scaled=False)
    x, ok = step_solution(*out['b'].shape)
    kernels.ip_step(x, ok, out['rn'], out['r1'], state, derivs, lbw, ubw, free, 0.99, 0.4, 1e-8)
    lay, F, delta, own = random_frames(BLOCK_LAYOUTS['tiny'], B=2)
    maps, n = block_index_maps(lay)
    fac = kernels.block_factor(F, delta, own, lay)
    kernels.block_solve(*fac[:3], torch.ones(2, n, dtype=torch.float64), maps, lay)
    L, _ = kernels.chol_factor_batched(torch.eye(5, dtype=torch.float64).expand(2, 5, 5))
    kernels.chol_solve_batched(L, torch.ones(2, 5, dtype=torch.float64))
    assert kernels.LAUNCHES == before
    assert kernels._lib is None


def test_ctypes_signatures_match_the_cuda_entry_points():
    """The argument types bound in kernels.SIGNATURES are those of the
    extern "C" functions of csrc/auglu.cu (a mismatch would only show as a
    wrong launch on the card); K5's one launch takes K, M and s, B, N and
    the layout (C, rows, resident rows, clusters, shared memory), then the
    stream, and its occupancy query the layout and a pointer to the count."""
    from awebox_tpu_torch.parallel import kernels
    with open(kernels.SOURCE) as fh:
        src = fh.read()
    extern = src[src.index('extern "C" {'):]
    kinds = {'void*': ctypes.c_void_p, 'int': ctypes.c_int, 'double': ctypes.c_double}
    found = {}
    for name, params in re.findall(r'\nint (\w+)\(([^)]*)\)\s*\{', extern):
        types = []
        for p in params.split(','):
            words = p.replace('const', '').replace('*', ' * ').split()
            types.append(kinds['void*' if '*' in words else words[0]])
        found[name] = types
    assert found == kernels.SIGNATURES
    P, I = ctypes.c_void_p, ctypes.c_int
    assert found['ruiz_scale'] == [P] * 3 + [I] * 7 + [P]
    assert found['ruiz_cluster_occupancy'] == [I] * 5 + [P]


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    from awebox_tpu_torch.parallel import kernels
    kernels.library()
    return torch.device('cuda')


@pytest.mark.cuda
def test_assembly_and_step_kernels_match_plain_on_card(cuda):
    """K1 (newton_kkt, the Newton system and K(delta_w)) and the retry
    assembly bit for bit (the same operations in the same order, no FMA
    contraction; r1 through the same cuBLAS product), and K4 (ip_step) at
    TOL_STEP / TOL_DS, each counted once per call. The inputs have NaN and
    inf entries, pinned variables and infinite bounds, at N = 37, 130, 543."""
    from awebox_tpu_torch.parallel import kernels
    for n, n_eq, n_ineq in ((20, 12, 5), (70, 52, 8), (280, 247, 16)):
        state, derivs, lbw, ubw, free = newton_inputs(B=3, n=n, n_eq=n_eq, n_ineq=n_ineq,
                                                      seed=n, device=cuda)
        before = dict(kernels.LAUNCHES)
        out = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
        ref = kernels.newton_kkt_plain(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
        torch.cuda.synchronize()
        assert set(out) == set(ref)
        for k in ref:
            assert torch.equal(out[k], ref[k]), (n, k)
        f32 = torch.float32
        delta = torch.tensor([1e-8, 1e-4, 1.0], dtype=torch.float64, device=cuda)
        args1 = (ref['W64'].to(f32), ref['A64'].to(f32), ref['Dr32'], free.to(f32), delta)
        Ks, kd = kernels.kkt_assemble_scaled(*args1)
        Ks_p, kd_p = kernels.kkt_assemble_scaled_plain(*args1)
        # the unscaled K of the QR factor: the same kernels with a null kd
        out_u = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8, scaled=False)
        ref_u = kernels.newton_kkt_plain(state, derivs, lbw, ubw, free, 1e-8, 1e-8, scaled=False)
        assert set(out_u) == set(ref_u) and 'kd' not in out_u
        for k in ref_u:
            assert torch.equal(out_u[k], ref_u[k]), (n, k, 'unscaled')
        assert torch.equal(kernels.kkt_assemble(*args1), kernels.kkt_assemble_plain(*args1)), n
        x, ok = step_solution(3, n + n_eq + n_ineq, device=cuda)
        ds, ds_p = (torch.empty(3, n_ineq, dtype=torch.float64, device=cuda) for _ in range(2))
        step = (x, ok, ref['rn'], ref['r1'], state, derivs, lbw, ubw, free, 0.99, 0.4, 1e-8)
        new = kernels.ip_step(*step, ds_out=ds)
        new_p = kernels.ip_step_plain(*step, ds_out=ds_p)
        torch.cuda.synchronize()
        assert torch.equal(Ks, Ks_p) and torch.equal(kd, kd_p), n
        assert set(new) == set(new_p)
        gaps = step_gaps(new, new_p, state, ds, ds_p, x, ok, derivs, free)
        assert step_within_tolerance(gaps), (n, gaps)
        for k, times in (('newton_kkt', 2), ('kkt_assemble_scaled', 1), ('kkt_assemble', 1),
                         ('ip_step', 1)):
            assert kernels.LAUNCHES[k] == before[k] + times, k


@pytest.mark.cuda
def test_direction_solve_on_card_matches_cpu(cuda):
    """K1-K3 inside the whole LU direction solve (two f64 refinement sweeps and
    the delta ladder) against the plain path on the CPU: ok lane by lane,
    and dw, dnu within 1e-6 of their max (the f32 factors differ in rounding;
    refinement brings both to the f64 solution of K(delta)). The ladder lane
    is retried on the card."""
    from awebox_tpu_torch.parallel import batch, kernels
    host = saddle_systems()
    n = host[0].shape[1]
    card = [t.to(cuda) for t in host]
    args = (n, 1e-8, 1e-8, N_LADDER, LADDER)
    before = kernels.LAUNCHES['lu_factor_batched']
    out_c = batch._auglu_solve(*card, *args, factor='lu')
    out_h = batch._auglu_solve(*host, *args, factor='lu')
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['lu_factor_batched'] - before >= 2   # the ladder ran
    np.testing.assert_array_equal(out_c[2].cpu().numpy(), out_h[2].numpy())
    for k in range(2):
        ref = out_h[k].numpy()
        np.testing.assert_allclose(out_c[k].cpu().numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def plu_and_residual_gates(A, lu, piv, variant):
    """Holds a factor of A (B, N, N) on the card to cuSOLVER's: max |P L U - A|
    within 10x of cuSOLVER's (f32 backward error of pivoted LU times the
    growth factor, which differ by rounding order), and the scaled residual
    |A x - c| / |c| of the K3 solve within 10x of the plain solve's."""
    from awebox_tpu_torch.parallel import kernels
    B, N, _ = A.shape
    lu_p, piv_p = kernels.lu_factor_batched_plain(A)
    lu_p, piv_p = lu_p.contiguous(), piv_p.contiguous()
    ones = torch.ones(B, N, device=A.device)
    c = torch.as_tensor(np.random.default_rng(N).standard_normal((B, N)),
                        dtype=torch.float32, device=A.device)

    def plu(lu, piv):
        P, L, U = torch.lu_unpack(lu, piv)
        return P @ L @ U

    def res(x):
        r = (A.double() @ x.double()[:, :, None])[:, :, 0] - c.double()
        return (r.abs().amax(dim=1) / c.double().abs().amax(dim=1)).cpu().numpy()
    dev_k = (plu(lu, piv) - A).abs().amax(dim=(1, 2)).cpu().numpy()
    dev_p = (plu(lu_p, piv_p) - A).abs().amax(dim=(1, 2)).cpu().numpy()
    assert (dev_k <= 10 * np.maximum(dev_p, 1e-6)).all(), (variant, dev_k, dev_p)
    res_k = res(kernels.lu_solve_batched(lu, piv, ones, c))
    res_p = res(kernels.lu_solve_batched_plain(lu_p, piv_p, ones, c))
    assert np.isfinite(res_k).all(), variant
    assert (res_k <= 10 * np.maximum(res_p, 1e-7)).all(), (variant, res_k, res_p)


@pytest.mark.cuda
def test_lu_factor_cluster_matches_plain_on_card(cuda):
    """Both variants of K2 against cuSOLVER and the CPU mirrors of their
    algorithms: the cluster variant at N = 37 and 543, the blocked one at
    N = 600 and 1055 (lanes no cluster holds), each at B = 1, 3 and 16:
    pivots equal to cuSOLVER's on matrices with well-separated pivots, the
    P L U and scaled-residual gates, a singular lane (a zero column) with a
    non-finite solve (and, from the cluster variant, non-finite factors),
    and a lane with a NaN column whose pivots are the mirror's (the diagonal
    from that column on). The counter of the variant moves once per factor.
    Then the blocked variant on Gaussian lanes at N=1055, B=2."""
    from awebox_tpu_torch.parallel import kernels
    for N, B in ((N, B) for N in (37, 543, 600, 1055) for B in (1, 3, 16)):
        variant = kernels.lu_factor_geometry(N).variant
        assert variant == ('cluster' if N <= 543 else 'blocked')
        mirror = cluster_lu_mirror if variant == 'cluster' else blocked_lu_mirror
        A = torch.stack([separated_pivots(N, seed=100 * B + b) for b in range(B)])
        bad = {}
        if B > 1:
            sing, nanl = B // 3, B - 1
            A[sing, :, N // 3] = 0.
            A[nanl, :, N // 2] = float('nan')
            bad = {sing: 'singular', nanl: 'nan'}
        Ac = A.to(cuda)
        before = dict(kernels.LAUNCHES)
        lu, piv = kernels.lu_factor_batched(Ac.clone())
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[f'lu_factor_{variant}'] == before[f'lu_factor_{variant}'] + 1
        assert kernels.LAUNCHES['lu_factor_batched'] == before['lu_factor_batched'] + 1
        good = [b for b in range(B) if b not in bad]
        piv_p = kernels.lu_factor_batched_plain(Ac[good])[1]
        assert torch.equal(piv[good], piv_p.contiguous()), (N, B)
        plu_and_residual_gates(Ac[good].contiguous(), lu[good].contiguous(),
                               piv[good].contiguous(), variant)
        for b, kind in bad.items():
            x = kernels.lu_solve_batched(lu[b:b + 1], piv[b:b + 1], torch.ones(1, N, device=cuda),
                                         torch.ones(1, N, device=cuda))
            assert not bool(torch.isfinite(x).all()), kind
            if kind == 'singular' and variant == 'cluster':
                assert not bool(torch.isfinite(lu[b]).all())
            elif kind == 'nan':
                assert torch.equal(piv[b].cpu(), mirror(A[b])[1]), (N, B)
    A = torch.as_tensor(np.random.default_rng(9).standard_normal((2, 1055, 1055)),
                        dtype=torch.float32, device=cuda)
    before = dict(kernels.LAUNCHES)
    lu, piv = kernels.lu_factor_batched(A.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['lu_factor_blocked'] == before['lu_factor_blocked'] + 1
    assert torch.equal(piv, kernels.lu_factor_batched_plain(A)[1].contiguous())
    plu_and_residual_gates(A, lu, piv, 'blocked')


@pytest.mark.cuda
def test_lu_solve_matches_plain_on_card(cuda):
    """The tiled K3 on cuSOLVER's factors at N = 37, 543 and 1055 (ragged
    last tiles of 5, 31 and 31 rows) and B = 1, 3 and 16: within 1e-3 of
    max |x| of the plain solve on the same factor (f32 forward error of the
    substitutions on Gaussian matrices), a scaled residual within 10x of the
    plain's, the counter moving once per call; a singular lane and a lane
    with a NaN column give a non-finite x, as in the plain solve."""
    from awebox_tpu_torch.parallel import kernels
    for N, B in ((N, B) for N in (37, 543, 1055) for B in (1, 3, 16)):
        A, kd, v = gaussian_lanes(B, N, seed=N + B, device=cuda)
        bad = {}
        if B > 1:
            A[0, :, N // 3] = 0.
            A[B - 1, :, N // 2] = float('nan')
            bad = {0: 'singular', B - 1: 'nan'}
        lu, piv = kernels.lu_factor_batched_plain(A)
        lu, piv = lu.contiguous(), piv.contiguous()
        before = kernels.LAUNCHES['lu_solve_batched']
        x = kernels.lu_solve_batched(lu, piv, kd, v)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['lu_solve_batched'] == before + 1
        x_p = kernels.lu_solve_batched_plain(lu, piv, kd, v)
        good = [b for b in range(B) if b not in bad]
        err = float((x[good] - x_p[good]).abs().max())
        assert err <= 1e-3 * float(x_p[good].abs().max()), (N, B, err)
        res = scaled_residual(A[good], kd[good], v[good], x[good])
        res_p = scaled_residual(A[good], kd[good], v[good], x_p[good])
        assert np.isfinite(res).all() and (res <= 10 * np.maximum(res_p, 1e-7)).all(), \
            (N, B, res, res_p)
        for b, kind in bad.items():
            assert not bool(torch.isfinite(x[b]).all()), (N, B, kind)
            assert not bool(torch.isfinite(x_p[b]).all()), (N, B, kind)


def same_bits(a, b):
    """Equal entry for entry, a NaN on both sides counting as equal."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# K6 and K7 against LAPACK's geqrf / ormqr + trsm (cuSOLVER and cuBLAS on the
# card). A QR factor is unique only up to the signs of R's rows and to
# rounding, so K6 is held by |diag R| (1e-4 of max |diag R|: the f32 backward
# error N eps |M| of Householder QR at N <= 1055) and by the solve: the
# residual |M x - v| / |v| of K6 + K7 within 10x of the library's. K7 is held
# on the same factor (K6's and the library's) against its plain version:
# 1e-3 of max |x|, the f32 forward error of 2N substitution steps on Gaussian
# matrices, and a residual within 10x.
TOL_QR_DIAG = 1e-4
TOL_QR_X = 1e-3


def hold_qr_factor_and_solve(M, v, variant, tag=''):
    """K6 on M (B, N, N) and K7 on K6's and the library's factors, on the
    card, by the gates above; returns (qr, tau) of K6."""
    from awebox_tpu_torch.parallel import kernels
    before = dict(kernels.LAUNCHES)
    qr, tau = kernels.qr_factor_batched(M)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[f'qr_factor_{variant}'] == before[f'qr_factor_{variant}'] + 1, tag
    assert kernels.LAUNCHES['qr_factor_batched'] == before['qr_factor_batched'] + 1, tag
    qr_p, tau_p = (t.contiguous() for t in kernels.qr_factor_batched_plain(M))
    dk = torch.diagonal(qr, dim1=1, dim2=2).abs()
    dp = torch.diagonal(qr_p, dim1=1, dim2=2).abs()
    assert float((dk - dp).abs().max()) <= TOL_QR_DIAG * float(dp.max()), (tag, 'diag R')
    x_lib = kernels.qr_solve_batched_plain(qr_p, tau_p, v)
    res_lib = qr_residual(M, v, x_lib)
    for name, (f, t) in (('K6', (qr, tau)), ('library', (qr_p, tau_p))):
        x_k = kernels.qr_solve_batched(f, t, v)
        x_p = kernels.qr_solve_batched_plain(f, t, v)
        torch.cuda.synchronize()
        err = float((x_k - x_p).abs().max())
        assert err <= TOL_QR_X * float(x_p.abs().max()), (tag, name, err)
        res = qr_residual(M, v, x_k)
        assert np.isfinite(res).all() and (res <= 10 * np.maximum(res_lib, 1e-7)).all(), \
            (tag, name, res, res_lib)
    assert kernels.LAUNCHES['qr_solve_batched'] == before['qr_solve_batched'] + 2, tag
    return qr, tau


@pytest.mark.cuda
def test_qr_kernels_match_plain_on_card(cuda):
    """K5 (ruiz_scale) bit for bit with its plain version in its one launch:
    at N = 543 for B = 1, 3, 16 and 128 and at N = 1055 for B = 2 and 16,
    on lanes with rows over six decades and, where B > 1, with a NaN row, an
    inf entry and a zero row in one lane, which must not change another
    lane's bits; then K5 again, K6 in both variants (the cluster kernel at
    N = 37 and 543, the blocked one at N = 1055) and K7 by the gates of
    hold_qr_factor_and_solve at B = 1, 3 and 16; a singular lane (a zero
    column: a zero on R's diagonal) and a lane with a NaN column give a
    non-finite solution, as with the library, and leave the other lanes
    alone. Each counter moves once per call."""
    from awebox_tpu_torch.parallel import kernels
    for N, B in ((543, 1), (543, 3), (543, 16), (543, 128), (1055, 2), (1055, 16)):
        rng = np.random.default_rng(N + B)
        K = torch.as_tensor(rng.standard_normal((B, N, N)) * 10.0 ** rng.uniform(-3, 3, (B, N, 1)),
                            dtype=torch.float32, device=cuda)
        before = kernels.LAUNCHES['ruiz_scale']
        M, s = kernels.ruiz_scale(K)
        M_p, s_p = kernels.ruiz_scale_plain(K)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['ruiz_scale'] == before + 1
        assert same_bits(M, M_p) and same_bits(s, s_p), (N, B)
        if B > 1:
            K[1, N // 2, :] = float('nan')
            K[1, 3, N - 2] = float('inf')
            K[1, N - 1, :] = 0.
            Mb, sb = kernels.ruiz_scale(K)
            Mb_p, sb_p = kernels.ruiz_scale_plain(K)
            torch.cuda.synchronize()
            assert same_bits(Mb, Mb_p) and same_bits(sb, sb_p), (N, B, 'non-finite')
            assert bool(torch.isnan(sb[1]).any())
            others = [0] + list(range(2, B))
            assert torch.equal(Mb[others], M[others]) and torch.equal(sb[others], s[others])
    for N, B in ((N, B) for N in (37, 543, 1055) for B in (1, 3, 16)):
        A, _, v = gaussian_lanes(B, N, seed=N + B, device=cuda)
        A = A * torch.as_tensor(10.0 ** np.random.default_rng(N).uniform(-3, 3, (B, N, 1)),
                                dtype=torch.float32, device=cuda)   # rows over six decades
        bad = {}
        if B > 1:
            A[0, :, N // 3] = 0.
            A[B - 1, :, N // 2] = float('nan')
            bad = {0: 'singular', B - 1: 'nan'}
        before = kernels.LAUNCHES['ruiz_scale']
        M, s = kernels.ruiz_scale(A)
        M_p, s_p = kernels.ruiz_scale_plain(A)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['ruiz_scale'] == before + 1
        assert same_bits(M, M_p) and same_bits(s, s_p), (N, B)
        good = [b for b in range(B) if b not in bad]
        assert bool(torch.isfinite(M[good]).all())
        variant = kernels.qr_factor_geometry(N).variant
        assert variant == ('blocked' if N == 1055 else 'cluster')
        hold_qr_factor_and_solve(M[good].contiguous(), v[good].contiguous(), variant, (N, B))
        if bad:
            qr, tau = kernels.qr_factor_batched(M)
            x = kernels.qr_solve_batched(qr, tau, v)
            x_p = kernels.qr_solve_batched_plain(*kernels.qr_factor_batched_plain(M), v)
            torch.cuda.synchronize()
            for b, kind in bad.items():
                assert not bool(torch.isfinite(x[b]).all()), (N, B, kind)
                assert not bool(torch.isfinite(x_p[b]).all()), (N, B, kind)
            res = qr_residual(M[good], v[good], x[good])
            assert np.isfinite(res).all() and (res <= 1e-3).all(), (N, B, res)


@pytest.mark.cuda
def test_qr_direction_solve_on_card_matches_cpu(cuda):
    """K1's unscaled assembly, K5, K6 and K7 inside the whole QR direction
    solve (the guarded f64 refinement sweep and the delta ladder) against
    the plain path on the CPU: ok lane by lane, and dw, dnu within 1e-4 of
    their max: one guarded sweep leaves each side at its own f32-factor
    accuracy (the solves differ in rounding, ~1e-6 relative on these
    systems; the bound leaves room for cond). The ladder lane is retried on
    the card, and no LU kernel runs."""
    from awebox_tpu_torch.parallel import batch, kernels
    host = saddle_systems()
    n = host[0].shape[1]
    card = [t.to(cuda) for t in host]
    args = (n, 1e-8, 1e-8, N_LADDER, LADDER)
    before = dict(kernels.LAUNCHES)
    out_c = batch._auglu_solve(*card, *args, factor='qr')
    out_h = batch._auglu_solve(*host, *args, factor='qr')
    torch.cuda.synchronize()
    factors = kernels.LAUNCHES['qr_factor_batched'] - before['qr_factor_batched']
    assert factors >= 2                                  # the ladder ran
    assert kernels.LAUNCHES['kkt_assemble'] - before['kkt_assemble'] == factors
    assert kernels.LAUNCHES['ruiz_scale'] - before['ruiz_scale'] == factors
    assert kernels.LAUNCHES['qr_solve_batched'] - before['qr_solve_batched'] == 2 * factors
    assert kernels.LAUNCHES['lu_factor_batched'] == before['lu_factor_batched']
    np.testing.assert_array_equal(out_c[2].cpu().numpy(), out_h[2].numpy())
    for k in range(2):
        ref = out_h[k].numpy()
        np.testing.assert_allclose(out_c[k].cpu().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.cuda
def test_advance_state_kernel_matches_plain_on_card(cuda):
    """K4's advance_state entry bit for bit against advance_state_plain (the
    same f64 operations in the same order), with a failed lane, pinned and
    infinite bounds, and without inequality or equality rows."""
    from awebox_tpu_torch.parallel import kernels
    for B, n, n_eq, n_ineq in ((4, 40, 20, 8), (4, 280, 247, 16), (3, 40, 20, 0),
                               (3, 40, 0, 8), (4, 540, 499, 16)):
        args = random_step_inputs(B=B, n=n, n_eq=n_eq, n_ineq=n_ineq, seed=n, device=cuda)
        before = kernels.LAUNCHES['advance_state']
        out = kernels.advance_state(*args)
        ref = kernels.advance_state_plain(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['advance_state'] == before + 1
        assert set(out) == set(ref)
        for k in ref:
            assert same_bits(out[k], ref[k]), (n, n_eq, n_ineq, k)


def block_gates(fac_k, fac_p, x_k, x_p, good):
    """K8 + K9 against their plain versions on lanes that factored: Li and Xc
    within 1e-10 of their max, R = L_R L_R^T within 1e-10 of its max (the
    reduced system's factor itself is as ill-conditioned as R), and x within
    1e-8 of max |x| on these well-conditioned frames."""
    for k in range(2):
        a, b = fac_k[k][good], fac_p[k][good]
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max()), k
    Rk = fac_k[2][good] @ fac_k[2][good].transpose(1, 2)
    Rp = fac_p[2][good] @ fac_p[2][good].transpose(1, 2)
    assert float((Rk - Rp).abs().max()) <= 1e-10 * float(Rp.abs().max())
    assert float((x_k[good] - x_p[good]).abs().max()) <= 1e-8 * float(x_p[good].abs().max())


@pytest.mark.cuda
def test_block_kernels_match_plain_on_card(cuda):
    """K8 (block_factor) and K9 (block_solve) against their plain versions on
    random frames of the n_k = 4 and n_k = 8 layouts (B = 1, 16, 128 and
    16) and of K8's other cluster sizes (n_k = 1; 10 and 12, non-portable
    clusters; K9's cluster has the same sizes), with an indefinite lane and a
    NaN lane that fail alone (ok False, L_R NaN, x NaN) while the other lanes
    keep the bits of a clean run; two K9 calls give the same bits; each
    launch counted."""
    from awebox_tpu_torch.parallel import kernels
    layouts = dict(BLOCK_LAYOUTS, **{f'n_k={n_k}': (n_k, 11, 54, 20, 96) for n_k in (1, 10, 12)})
    for name, B in (('tiny', 4), ('n_k=4', 1), ('n_k=4', 16), ('n_k=4', 128),
                    ('n_k=8', 16), ('n_k=1', 4), ('n_k=10', 4), ('n_k=12', 4)):
        lay, F, delta, own = random_frames(layouts[name], B=B, seed=B, device=cuda)
        maps, n = block_index_maps(lay, seed=B, device=cuda)
        rhs = torch.as_tensor(np.random.default_rng(B).standard_normal((B, n)), device=cuda)
        before = dict(kernels.LAUNCHES)
        fac_k = kernels.block_factor(F, delta, own, lay)
        x_k = kernels.block_solve(*fac_k[:3], rhs, maps, lay)
        fac_p = kernels.block_factor_plain(F, delta, own, lay)
        x_p = kernels.block_solve_plain(*fac_p[:3], rhs, maps, lay)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['block_factor'] == before['block_factor'] + 1
        assert kernels.LAUNCHES['block_solve'] == before['block_solve'] + 1
        assert torch.equal(fac_k[3], fac_p[3]), (name, B, fac_k[3], fac_p[3])
        bad = [b for b in (1, 2) if b < B]
        good = [b for b in range(B) if b not in bad]
        block_gates(fac_k, fac_p, x_k, x_p, good)
        assert not bool(fac_k[3][bad].any()) and bool(torch.isnan(fac_k[2][bad]).all())
        assert bool(torch.isnan(x_k[bad]).all())
        x_2 = kernels.block_solve(*fac_k[:3], rhs, maps, lay)   # a second call: the same bits
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['block_solve'] == before['block_solve'] + 2
        assert torch.equal(x_k.view(torch.int64), x_2.view(torch.int64))
        if bad:   # the failing lanes change no other lane's bits
            F_clean = F.clone()
            F_clean[bad] = F[good[0]]
            fac_c = kernels.block_factor(F_clean, delta, own, lay)
            x_c = kernels.block_solve(*fac_c[:3], rhs, maps, lay)
            for t, tc in zip(fac_k[:3] + (x_k,), fac_c[:3] + (x_c,)):
                assert torch.equal(t[good], tc[good])


@pytest.mark.cuda
def test_chol_kernels_match_plain_on_card(cuda):
    """K10 (chol_factor_batched) and K11 (chol_solve_batched) against their
    plain versions at n = 37, 280 and 540 (K10's cluster variant) and 555,
    700, 876 and 1190 (its stream variant), B = 16 (B = 4 from 876 on): L
    within 1e-12 of its max and x within 1e-10 of max |x| on SPD lanes (cond
    ~ 1e3; only the order of the sums differs); a negative pivot and a NaN
    entry fail their lane alone (ok False, L NaN, x NaN) and change no other
    lane's bits; two calls of each give the same bits; each launch counted
    (K10's under the variant chol_factor_geometry gives); K11 at every n."""
    from awebox_tpu_torch.parallel import kernels
    for n in (37, 280, 540, 555, 700, 876, 1190):
        variant = kernels.chol_factor_geometry(n).variant
        assert variant == ('stream' if n > 554 else 'cluster')
        nB = 16 if n < 876 else 4
        M = chol_test_matrices(n, B=nB)
        M_clean = M.copy()
        M_clean[[1, 2]] = M[0]
        M_clean = torch.as_tensor(M_clean, device=cuda)
        Mt = torch.as_tensor(M, device=cuda)
        b = torch.as_tensor(np.random.default_rng(n).standard_normal((nB, n)), device=cuda)
        before = dict(kernels.LAUNCHES)
        L, ok = kernels.chol_factor_batched(Mt)
        x = kernels.chol_solve_batched(L, b)
        Lp, okp = kernels.chol_factor_batched_plain(Mt)
        xp = kernels.chol_solve_batched_plain(Lp, b)
        L_c, _ = kernels.chol_factor_batched(M_clean)
        L_2, ok_2 = kernels.chol_factor_batched(Mt)
        x_c = kernels.chol_solve_batched(L_c, b)
        x_2 = kernels.chol_solve_batched(L, b)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['chol_factor_batched'] == before['chol_factor_batched'] + 3
        assert kernels.LAUNCHES[f'chol_factor_{variant}'] \
            == before[f'chol_factor_{variant}'] + 3
        assert kernels.LAUNCHES['chol_solve_batched'] == before['chol_solve_batched'] + 3
        assert torch.equal(x.view(torch.int64), x_2.view(torch.int64))
        assert ok.tolist() == okp.tolist() == [b_ not in (1, 2) for b_ in range(nB)]
        good = [b_ for b_ in range(nB) if b_ not in (1, 2)]
        assert float((L[good] - Lp[good]).abs().max()) <= 1e-12 * float(Lp[good].abs().max())
        assert float((x[good] - xp[good]).abs().max()) <= 1e-10 * float(xp[good].abs().max())
        assert bool(torch.isnan(L[[1, 2]]).all()) and torch.equal(L[good], L_c[good])
        assert bool(torch.isnan(x[[1, 2]]).all()) and torch.equal(x[good], x_c[good])
        assert torch.equal(L.view(torch.int64), L_2.view(torch.int64)) and torch.equal(ok, ok_2)


# --- K12, K13: the host solver's f64 LU factor and solve ---------------------

def k13_step_tile(s, idx, T, rank, C, warp):
    """k13_step_tile of csrc/auglu.cu: the idx-th tile (ti, tj) warp of rank
    (of C) takes in step s (s < T forward, then backward, row tile 2T - 1 -
    s), or None: warp 0 the diagonal and fold tiles of its rank's row tiles'
    steps, warps 1 .. 7 the rank's own row tiles' other tiles of the step."""
    if s < T:
        if warp == 0:
            ok = s % C == rank and (idx == 0 or (idx == 1 and s + 1 < T))
            return (s + idx, s) if ok else None
        ti = s + 1 + (rank - s - 1) % C + C * (warp - 1 + 7 * idx)
        return (ti, s - 1) if s > 0 and ti < T else None
    t = 2 * T - 1 - s
    if warp == 0:
        ok = t % C == rank and (idx == 0 or (idx == 1 and t > 0))
        return (t - idx, t) if ok else None
    ti = t - 1 - (t - 1 - rank) % C - C * (warp - 1 + 7 * idx)
    return (ti, t + 1) if t + 1 < T and ti >= 0 else None


def k13_walk(T, rank, C, warp):
    """The tiles a warp's ring copies, in order (KsRing<K13Walk>'s walk)."""
    for s in range(2 * T):
        idx = 0
        while (tile := k13_step_tile(s, idx, T, rank, C, warp)) is not None:
            yield tile
            idx += 1


def k13_schedule_mirror(lu, piv, b, C=1, nb=32):
    """K13 step by step as its cluster of C ranks runs it: y = P b by
    chunk_permutation (the interchanges composed 32 at a time); each rank a
    vector of its own holding its own row tiles (row tile i is rank i % C's)
    and NaN elsewhere until a chain publishes x there (rows past N zeros);
    the chain of row tile s on its owner's warp 0 from the diagonal tile
    and the fold its predecessor handed over (ks_forward's chain with a unit
    diagonal; backward K13's on U's tiles as rows), its x written into every
    rank's vector and its fold into the next owner's buffer; warps 1 .. 7 of
    every rank applying the column just solved to the rank's own row tiles.
    Each tile comes from its warp's walk, which must be the tile the step asks
    for. Returns x from the owners' vectors."""
    m = len(b); T = -(-m // nb); P = T * nb
    F = np.zeros((P, P)); F[:m, :m] = lu
    yb = np.zeros(P); yb[:m] = np.asarray(b)[chunk_permutation(piv, m, nb).numpy()]
    rinv = np.ones(P); rinv[:m] = 1. / np.diag(lu)
    own = np.arange(P) // nb % C
    Y = [np.where((own == r) | (np.arange(P) >= m), yb, np.nan) for r in range(C)]
    fold = [np.full(nb, np.nan) for _ in range(C)]
    walks = {(r, w): k13_walk(T, r, C, w) for r in range(C) for w in range(8)}

    def take(r, w, ti, tj):
        assert next(walks[r, w]) == (ti, tj), (r, w, ti, tj)
        return F[ti * nb:ti * nb + nb, tj * nb:tj * nb + nb]

    def publish(r0, h, u, to, an):
        for Yr in Y:
            Yr[r0:r0 + h] = u[:h]
        if to is not None:
            fold[to] = an

    for s in range(T):
        r0, h, o = s * nb, min(nb, m - s * nb), s % C
        D = take(o, 0, s, s)
        E = take(o, 0, s + 1, s) if s + 1 < T else None
        u, an = Y[o][r0:r0 + nb] + (fold[o] if s > 0 else 0.), np.zeros(nb)
        for j in range(h):
            u[j + 1:h] -= D[j + 1:h, j] * u[j]
            if E is not None:
                an = an - E[:, j] * u[j]
        publish(r0, h, u, (s + 1) % C if E is not None else None, an)
        for r in range(C):
            for w in range(1, 8):
                i = s + 1 + (r - s - 1) % C + C * (w - 1)
                while s > 0 and i < T:
                    rows = slice(i * nb, min(i * nb + nb, m))
                    tile = take(r, w, i, s - 1)[:rows.stop - rows.start]
                    Y[r][rows] -= ks_tile_sum(tile, Y[r][r0 - nb:r0])
                    i += 7 * C
    for t in range(T - 1, -1, -1):
        r0, h, o = t * nb, min(nb, m - t * nb), t % C
        D = take(o, 0, t, t)
        E = take(o, 0, t - 1, t) if t > 0 else None
        u, an = Y[o][r0:r0 + nb] + (fold[o] if t + 1 < T else 0.), np.zeros(nb)
        for j in range(h - 1, -1, -1):
            u[j] = u[j] * rinv[r0 + j]
            u[:j] -= D[:j, j] * u[j]
            if E is not None:
                an = an - E[:, j] * u[j]
        publish(r0, h, u, (t - 1) % C if E is not None else None, an)
        for r in range(C):
            for w in range(1, 8):
                i = t - 1 - (t - 1 - r) % C - C * (w - 1)
                while t + 1 < T and i >= 0:
                    Y[r][i * nb:i * nb + nb] -= ks_tile_sum(take(r, w, i, t + 1),
                                                            Y[r][r0 + nb:r0 + 2 * nb])
                    i -= 7 * C
    assert all(next(wk, None) is None for wk in walks.values())   # every copied tile was taken
    return np.concatenate([Y[i % C][i * nb:i * nb + nb] for i in range(T)])[:m]


def host_kkt_matrices(N, B, seed=0, n=None):
    """(B, N, N) f64 saddle matrices [[W, A^T], [A, -D]] shaped like the host
    solver's augmented K (n primal rows, D of 1e-8 and small entries), with
    its right-hand sides."""
    rng = np.random.default_rng(seed)
    n = n or (N * 280) // 543
    m = N - n
    K = np.zeros((B, N, N))
    for lane in range(B):
        Wh = rng.standard_normal((n, n))
        W = (Wh + Wh.T) / 2 + np.diag(10.0 ** rng.uniform(-2, 4, n))
        A = rng.standard_normal((m, n)) * 10.0 ** rng.uniform(-1, 1, (m, 1))
        D = np.concatenate([1e-8 * np.ones(m - m // 16), np.abs(rng.standard_normal(m // 16))])
        K[lane] = np.block([[W, A.T], [A, -np.diag(D)]])
    return K, rng.standard_normal((B, N))


def k12_moves(pk, base, w):
    """k12_compose: the w interchanges of rows base + q and pk[q] (0-based),
    applied in order, as 2 w row moves; destination d takes the row found by
    tracing d back through the swaps from the last one."""
    dst = [base + q for q in range(w)] + [int(r) for r in pk[:w]]
    src = []
    for d in dst:
        r = d
        for q in reversed(range(w)):
            r = int(pk[q]) if r == base + q else (base + q if r == pk[q] else r)
        src.append(r)
    return np.array(dst), np.array(src)


def k12_chain_mirror(V, d0, w, pv):
    """k12_chain on V (a panel's rows from its diagonal, a block of its
    columns, in place): column d0 + j pivots at the first largest |a| of rows
    d0 + j .. (a NaN never; a column of NaNs keeps the diagonal), the two rows
    swapped, the rows below scaled by the pivot's reciprocal (divided below
    DBL_MIN, as LAPACK's getf2) and updated; pivots (local rows) to pv."""
    tiny = np.finfo(np.float64).tiny
    for j in range(w):
        d = d0 + j
        a = np.abs(V[d:, j])
        a = np.where(np.isnan(a), -1., a)
        p = d + int(np.argmax(a)) if a.max() >= 0 else d
        V[[d, p]] = V[[p, d]]
        pivot = V[d, j]
        with np.errstate(all='ignore'):
            col = V[d + 1:, j]
            V[d + 1:, j] = col / pivot if not abs(pivot) >= tiny else col * (1. / pivot)
            V[d + 1:, j + 1:] -= np.outer(V[d + 1:, j], V[d, j + 1:])
        pv[d] = p


def k12_pair_mirror(T, A, U, lo, hi):
    """k12_pair on rows lo .. hi - 1 of the panel T: less A (the applied
    panel's rows lo .. hi - 1) times U (U12), each entry's 16 products summed
    from zero in four k-steps of 4 and subtracted once."""
    upd = np.zeros((hi - lo, T.shape[1]))
    with np.errstate(all='ignore'):
        for s4 in range(4):
            upd = upd + A[:, 4 * s4:4 * s4 + 4] @ U[4 * s4:4 * s4 + 4]
        T[lo:hi] = T[lo:hi] - upd


def k12_u12_mirror(L11, U):
    """U12 = L11^-1 A12 a column at a time (unit lower L11; U, 16 rows, in
    place): row i less L11[i, t] U[t] for t = 0 .. i - 1 in order."""
    with np.errstate(all='ignore'):
        for i in range(1, U.shape[0]):
            for t in range(i):
                U[i] = U[i] - L11[i, t] * U[t]


def k12_schedule_mirror(K, C):
    """K12 (lu_factor_f64_kernel) on one (N, N) f64 matrix, in numpy, step by
    step as its C ranks run it: panel p of 16 columns (N rows, zeros past
    column N) to rank p % C; panel 0 factored by rank 0; then a step a panel:
    o(k + 1) applies panel k's interchanges, U12 and update to panel k + 1
    (its L21 read whole) and factors it, whole (panel rows <= LU64_WHOLE) or
    in two halves of 8 (the right half: the left's interchanges, U12 by the
    left's L11, its update by the left's L21, its chain; then its
    interchanges on the left half); every rank then takes its panels
    LU64_GROUP at a time: the trailing ones (p > k) panel k's interchanges,
    U12 and update (L21 fetched LU64_CHUNK rows at a time, each chunk's
    (panel, tile pair) jobs dealt to the 16 warps), the ones left of panel k
    - 1 panel k - 1's interchanges, which a rank may apply only once every
    rank has read their L21 (two steps after; asserted); after the last
    step, the last panel's. Every buffer a step reads (the staged L21, the
    U12 blocks, L11, a right half) is NaN outside what the step fetched, and
    a panel is read only once published (asserted). Returns (lu, piv) like
    lu_factor_ex."""
    from awebox_tpu_torch.parallel import kernels
    nb, G, CH = kernels.LU64_NB, kernels.LU64_GROUP, kernels.LU64_CHUNK
    N = K.shape[0]
    P = -(-N // nb)
    C = min(C, P)
    W = np.zeros((P, N, nb))
    for p in range(P):
        W[p, :, :min(nb, N - p * nb)] = K[:, p * nb:(p + 1) * nb]
    piv = np.zeros(N, np.int64)
    state = {'published': -1}
    read_at = {}

    def take(k, lo, hi, step):
        assert k <= state['published'], (k, step)
        read_at[k] = step
        return W[k, lo:hi].copy()

    def pivots(k):
        assert k <= state['published']
        return piv[k * nb:min(N, (k + 1) * nb)] - 1

    def factor(q):
        k0 = q * nb
        h, w = N - k0, min(nb, N - k0)
        pv = {}
        if h <= kernels.LU64_WHOLE:
            V = W[q, k0:].copy()
            k12_chain_mirror(V, 0, w, pv)
            W[q, k0:] = V
        else:
            V = W[q, k0:, :8].copy()
            rh = np.full((kernels.LU64_LAST, 8), np.nan)
            rh[:h] = W[q, k0:, 8:]
            k12_chain_mirror(V, 0, 8, pv)
            W[q, k0:, :8] = V
            for j in range(8):
                rh[[j, pv[j]]] = rh[[pv[j], j]]
            k12_u12_mirror(V[:8], rh[:8])
            acc = np.zeros((h - 8, 8))
            with np.errstate(all='ignore'):
                for t in range(8):
                    acc = acc + np.outer(V[8:, t], rh[t])
            R = rh[:h].copy()
            R[8:] = rh[8:h] - acc
            k12_chain_mirror(R, 8, 8, pv)
            W[q, k0:, 8:] = R
            dst, src = k12_moves([pv[8 + j] for j in range(8)], 8, 8)
            W[q, k0 + dst, :8] = W[q, k0 + src, :8].copy()
        for d, p in pv.items():
            piv[k0 + d] = k0 + p + 1
        state['published'] = q

    def prep(k, group, step):
        """moves and U12 of a pass; returns the U12 blocks (NaN where unset)"""
        k0, k1 = k * nb, (k - 1) * nb
        kinds = {kind for _, kind in group}
        Ub = np.full((G, nb, nb), np.nan)
        mv = {}
        if 1 in kinds:
            w = min(nb, N - k0)
            L11 = np.tril(take(k, k0, k0 + w, step), -1)
            mv[1] = k12_moves(pivots(k), k0, w)
        if 2 in kinds:
            mv[2] = k12_moves(pivots(k - 1), k1, min(nb, N - k1))
        for m, (p, kind) in enumerate(group):
            if not kind:
                continue
            if kind == 2:   # the barrier: at step k every rank is through step k - 2
                assert read_at.get(p, -1) <= step - 2, (p, step, read_at.get(p))
            dst, src = mv[kind]
            vals = W[p, src].copy()
            for d, r in enumerate(dst):
                if kind == 1 and r < k0 + nb:
                    Ub[m, r - k0] = vals[d]
                else:
                    W[p, r] = vals[d]
        for m, (p, kind) in enumerate(group):
            if kind == 1:
                k12_u12_mirror(L11, Ub[m])
                W[p, k0:k0 + nb] = Ub[m]
        return Ub

    def update(k, group, Ub, step):
        trl = [m for m, (_, kind) in enumerate(group) if kind == 1]
        for lo in range((k + 1) * nb, N, CH):
            hi = min(N, lo + CH)
            Lc = np.full((CH, nb), np.nan)
            Lc[:hi - lo] = take(k, lo, hi, step)
            pairs = -(-(hi - lo) // 16)
            jobs = sorted(j for warp in range(16) for j in range(warp, len(trl) * pairs, 16))
            assert jobs == list(range(len(trl) * pairs))
            for m in trl:
                k12_pair_mirror(W[group[m][0]], Lc[:hi - lo], Ub[m], lo, hi)

    def passes(k, rank, skip, step):
        local = list(range(rank, P, C))
        for t0 in range(0, len(local), G):
            group = []
            for p in local[t0:t0 + G]:
                kind = 0 if p == skip else 1 if p > k else 2 if k >= 1 and p <= k - 2 else 0
                group.append((p, kind))
            group += [(-1, 0)] * (G - len(group))
            if any(kind for _, kind in group):
                Ub = prep(k, group, step)
                if any(kind == 1 for _, kind in group):
                    update(k, group, Ub, step)

    factor(0)
    for k in range(P):
        if k + 1 < P:
            U1 = prep(k, [(k + 1, 1)] + [(-1, 0)] * (G - 1), k)[0]
            lo = (k + 1) * nb
            k12_pair_mirror(W[k + 1], take(k, lo, N, k), U1, lo, N)
            factor(k + 1)
        for rank in range(C):
            passes(k, rank, k + 1 if k + 1 < P and rank == (k + 1) % C else -1, k)
    for rank in range(C):   # after a cluster barrier: every read is done
        passes(P, rank, -1, P + 1)
    lu = np.zeros((N, N))
    for p in range(P):
        lu[:, p * nb:(p + 1) * nb] = W[p, :, :min(nb, N - p * nb)]
    return lu, piv.astype(np.int32)


def lu_backward_error(K, lu, piv):
    """max |P L U - K| / (P |L| |U|) entry by entry (an entry whose
    denominator is 0 counts its error alone), as chip_smoke.py gates K12."""
    lu_t, piv_t, K_t = (torch.as_tensor(np.asarray(a)) for a in (lu, piv, K))
    P_, L_, U_ = torch.lu_unpack(lu_t, piv_t)
    e, d = (P_ @ L_ @ U_ - K_t).abs(), P_ @ (L_.abs() @ U_.abs())
    return float(torch.where(d > 0, e / d, e).max())


@pytest.mark.parametrize('N, C', [(N, C) for N in (37, 130, 543, 1311) for C in (1, 4, 16)]
                         + [(1823, 16)])
def test_k12_cluster_mirror_matches_lapack(N, C):
    """K12's schedule at C ranks (k12_schedule_mirror: the panel deal, the
    look-ahead, the half panels past LU64_WHOLE rows at N = 1311 and 1823,
    the staged chunks of L21, the late interchanges) against LAPACK getrf on
    the host solver's saddle matrices: its backward error max |P L U - K| /
    (P |L| |U|) within 10x LAPACK's (at least one epsilon), and its pivots
    LAPACK's but where a tie decides them (the first differing pivot's |U_kk|
    equal in both to 1e-12)."""
    from awebox_tpu_torch.parallel import kernels
    K, _ = host_kkt_matrices(N, 1, seed=N)
    lu, piv = k12_schedule_mirror(K[0], C)
    lu_p, piv_p = (a[0].numpy() for a in kernels.lu_factor_f64_plain(torch.as_tensor(K)))
    eps = np.finfo(np.float64).eps
    assert lu_backward_error(K[0], lu, piv) <= 10 * max(lu_backward_error(K[0], lu_p, piv_p), eps)
    diff = np.nonzero(piv != piv_p)[0]
    if diff.size:
        k0 = int(diff[0])
        assert abs(abs(lu[k0, k0]) - abs(lu_p[k0, k0])) <= 1e-12 * abs(lu_p[k0, k0]), (N, C, k0)


def test_k12_mirror_bits_do_not_depend_on_c():
    """Every panel update is the same routine wherever it runs and the late
    interchanges only move rows: K12's factor is the same bits at C = 1, 3,
    7 and 16 (C follows the batch, and a lane's bits must not)."""
    K, _ = host_kkt_matrices(300, 1, seed=300)
    lu1, piv1 = k12_schedule_mirror(K[0], 1)
    for C in (3, 7, 16):
        lu, piv = k12_schedule_mirror(K[0], C)
        assert np.array_equal(lu.view(np.int64), lu1.view(np.int64)) and np.array_equal(piv, piv1)


def test_k12_mirror_tie_nan_and_singular():
    """A tie picks the lower row; a column of NaNs keeps the diagonal; a
    singular matrix (a zero column) gives a non-finite factor, where LAPACK
    leaves a zero on U's diagonal: either way the solve is not finite and the
    delta ladder retries."""
    N = 40
    A = separated_pivots(N, seed=5).double().numpy()
    A[:, 0] = 0.
    A[7, 0] = A[19, 0] = -2.5      # |a| ties at rows 3, 7 and 19: row 3 wins
    A[3, 0] = 2.5
    _, piv = k12_schedule_mirror(A, 4)
    assert int(piv[0]) == 4         # row 3, 1-based
    A = separated_pivots(N, seed=6).double().numpy()
    A[:, 21] = np.nan
    _, piv = k12_schedule_mirror(A, 4)
    ref = torch.linalg.lu_factor_ex(separated_pivots(N, seed=6).double())[1].numpy()
    assert np.array_equal(piv[:21], ref[:21])
    assert np.array_equal(piv[21:], np.arange(22, N + 1))
    A = separated_pivots(N, seed=7).double().numpy()
    A[:, 12] = 0.
    lu, piv = k12_schedule_mirror(A, 4)
    assert not np.isfinite(lu).all()
    lu_ref, piv_ref, info = torch.linalg.lu_factor_ex(torch.as_tensor(A))
    assert int(info) > 0 and float(torch.diagonal(lu_ref).abs().min()) == 0.
    b = torch.ones(N, 1, dtype=torch.float64)
    x = torch.linalg.lu_solve(torch.as_tensor(lu), torch.as_tensor(piv), b)
    assert not bool(torch.isfinite(x).all())
    assert not bool(torch.isfinite(torch.linalg.lu_solve(lu_ref, piv_ref, b)).all())


@pytest.mark.parametrize('N', [37, 64, 130, 543, 1055])
def test_k13_schedule_mirror_matches_lapack(N):
    """K13's schedule at the cluster size lu_solve_f64_geometry gives a lane
    at B = 1 (the composed interchanges, the row tiles dealt over the ranks,
    each chain on its owner with the fold handed over, every tile from its
    warp's walk in the order it takes them) solves the system as LAPACK's
    getrs does, to 1e-10 relative; every lower tile is taken once forward and
    every upper tile once backward, each by the rank that owns its row tile
    or, for a diagonal or fold tile, by the rank whose chain takes it (its
    column tile's)."""
    from awebox_tpu_torch.parallel import kernels
    K, b = host_kkt_matrices(N, 1, seed=N + 1)
    lu, piv = kernels.lu_factor_f64_plain(torch.as_tensor(K))
    want = kernels.lu_solve_f64_plain(lu, piv, torch.as_tensor(b))[0].numpy()
    C = kernels.lu_solve_f64_geometry(N).C
    got = k13_schedule_mirror(lu[0].numpy(), piv[0].numpy(), b[0], C)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    T = -(-N // 32)
    walked = {(r, w): list(k13_walk(T, r, C, w)) for r in range(C) for w in range(8)}
    tiles = [t for ts in walked.values() for t in ts]
    lower = [(i, j) for i in range(T) for j in range(i + 1)]
    assert sorted(tiles) == sorted(lower + [(j, i) for (i, j) in lower])
    for (r, w), ts in walked.items():   # warps 1 .. 7: the rank's row tiles; warp 0: its chains'
        assert all((tj if w == 0 else ti) % C == r for ti, tj in ts)


@pytest.mark.parametrize('N, C', [(37, 1), (37, 2), (543, 8), (543, 16), (1055, 16), (1311, 4),
                                  (1311, 16)])
def test_k13_cluster_mirror_matches_plain(N, C):
    """K13's cluster schedule at C ranks against lu_solve_f64_plain to 1e-10
    relative, and bit for bit the schedule of one rank (the one-CTA
    solve's order): dealing the row tiles changes which SM sums a row, not the order
    of its sums. A rank that read an entry of x before its chain published
    it would read NaN."""
    from awebox_tpu_torch.parallel import kernels
    K, b = host_kkt_matrices(N, 1, seed=N + 2)
    lu, piv = kernels.lu_factor_f64_plain(torch.as_tensor(K))
    want = kernels.lu_solve_f64_plain(lu, piv, torch.as_tensor(b))[0].numpy()
    got = k13_schedule_mirror(lu[0].numpy(), piv[0].numpy(), b[0], C)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    if N <= 543:
        assert np.array_equal(got, k13_schedule_mirror(lu[0].numpy(), piv[0].numpy(), b[0], 1))


@pytest.mark.parametrize('B', [1, 7, 8, 15, 16, 30, 31, 66, 67, 128])
def test_lu_solve_f64_geometry_follows_the_batch(B):
    """K13's cluster size follows B so that the B clusters run in one wave
    (an H100 runs 7 clusters of 16 at once and 15 of 8): 16 up to B = 7, 8
    up to 15, 4 up to 30, 2 up to 66, then 1; never more than the lane's row
    tiles (2 at N = 37); the shared memory does not depend on B."""
    from awebox_tpu_torch.parallel import kernels
    want = 16 if B <= 7 else 8 if B <= 15 else 4 if B <= 30 else 2 if B <= 66 else 1
    g = kernels.lu_solve_f64_geometry(543, B)
    assert g.C == want and g.smem_bytes == kernels.lu_solve_f64_geometry(543).smem_bytes
    assert B * g.C <= 132 or g.C == 1
    assert kernels.lu_solve_f64_geometry(37, B).C == min(want, 2)


@pytest.mark.parametrize('N', [37, 543, 1055, 1807, 1808, 1823, 2335, 2560, 2561])
def test_lu_f64_geometry(N):
    """K12 is a cluster a lane at every N to 2560 (a half panel's rows in
    its chain's registers, 5 a thread), 169,984 B of shared memory a rank to
    N = 2304 (the U12 blocks of a pass, L11, and the look-ahead's rings of
    two tile pairs with their L21 rows, which also hold the passes' staged
    L21 and rings, or a right half) and the right half's 8 N doubles past it
    (171,968 B at N = 2335), C = 16 at B = 1 but never more than the lane's
    panels; it raises by name from N = 2561. K13's layout a rank is K11's
    ring (which holds the interchanges' three int arrays first) beside two
    N-long vectors, the two fold buffers and two mbarriers a tile step,
    166,160 B at N = 543, and fits every N K12 takes and N = 2656 (the
    one-CTA solve's reach); it raises by name at N = 4600."""
    from awebox_tpu_torch.parallel import kernels
    assert kernels.lu_solve_f64_geometry(N).smem_bytes <= kernels.SMEM_PER_BLOCK
    if N == 543:
        assert kernels.lu_solve_f64_geometry(N).smem_bytes == 166_160
    assert kernels.lu_solve_f64_geometry(2656).smem_bytes + 1024 <= kernels.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match='lu_solve_f64'):
        kernels.lu_solve_f64_geometry(4600)
    if N > 2560:
        with pytest.raises(ValueError, match='lu_factor_f64'):
            kernels.lu_factor_f64_geometry(N)
        return
    g = kernels.lu_factor_f64_geometry(N)
    P = -(-N // 16)
    assert g.C == min(16, P) and kernels.lu_factor_f64_geometry(N, 16).C == min(4, P)
    assert kernels.LU64_WHOLE == 1024 and -(-P // g.C) <= kernels.LU64_GROUP
    assert g.smem_bytes + kernels.LU64_STATIC_SMEM <= kernels.SMEM_PER_BLOCK
    assert g.smem_bytes >= 8 * (11 * 256 + max(8 * N, 256 * 20 + 16 * 2 * 256))
    assert g.smem_bytes == (171_968 if N == 2335 else 169_984 if N <= 2304 else 8 * (11 * 256 + 8 * N))


def test_lu_f64_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors K12 and K13 run their plain versions, count nothing and
    build nothing; a singular and a NaN lane give a non-finite solution, not
    an exception, and leave the other lanes as they are alone."""
    from awebox_tpu_torch.parallel import kernels
    K, b = host_kkt_matrices(37, 3, seed=3)
    K[1, :, 5] = 0.                         # singular
    K[2, 4, 7] = np.nan
    before = dict(kernels.LAUNCHES)
    Kt, bt = torch.as_tensor(K), torch.as_tensor(b)
    lu, piv = kernels.lu_factor_f64(Kt)
    x = kernels.lu_solve_f64(lu, piv, bt)
    assert kernels.LAUNCHES == before and kernels._lib is None
    assert not bool(torch.isfinite(x[1]).all()) and not bool(torch.isfinite(x[2]).all())
    lu0, piv0 = kernels.lu_factor_f64(Kt[:1])
    assert torch.equal(x[0], kernels.lu_solve_f64(lu0, piv0, bt[:1])[0])
    assert float((Kt[0] @ x[0] - bt[0]).abs().max()) <= 1e-8 * float(bt[0].abs().max())


def lu_f64_residuals(K, lu, piv, x, b):
    """Per lane: ||P L U - K|| / ||K|| (max norms) and the solve's relative
    residual max |K x - b| / (max |K| max |x| + max |b|)."""
    L = torch.tril(lu, -1) + torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device)
    U = torch.triu(lu)
    perm = torch.arange(lu.shape[-1], device=lu.device).repeat(lu.shape[0], 1)
    for k in range(lu.shape[-1]):
        p = (piv[:, k] - 1).long()
        a, c = perm[:, k].clone(), perm.gather(1, p[:, None])[:, 0].clone()
        perm[:, k] = c
        perm.scatter_(1, p[:, None], a[:, None])
    LU = L @ U
    fac = (LU - K.gather(1, perm[:, :, None].expand_as(K))).abs().flatten(1).amax(1) \
        / K.abs().flatten(1).amax(1)
    res = (K @ x[:, :, None])[:, :, 0] - b
    sol = res.abs().amax(1) / (K.abs().flatten(1).amax(1) * x.abs().amax(1) + b.abs().amax(1))
    return fac, sol


@pytest.mark.cuda
def test_lu_f64_kernels_match_plain_on_card(cuda):
    """K12 (lu_factor_f64) and K13 (lu_solve_f64) against their plain
    versions at N = 37, 543 (B = 1 and 16), 1055, 1311, 1823 and 2335 (B =
    1; K13 also alone on the plain factor at 2335), and B = 4 with a singular
    and a NaN lane: ||P L U - K|| / ||K|| <= 1e-13 and the solve's relative
    residual <= 1e-13 on every finite lane, x within 1e-8 of the plain
    version's relative to max |x|, the pivots equal; the singular and the NaN
    lane give a non-finite x and change no other lane's bits; K is not
    changed; two calls give the same bits; one launch counted each."""
    from awebox_tpu_torch.parallel import kernels
    K, b = host_kkt_matrices(2335, 1, seed=2335)
    Kt, bt = torch.as_tensor(K, device=cuda), torch.as_tensor(b, device=cuda)
    lu, piv = kernels.lu_factor_f64_plain(Kt)
    lu, piv = lu.contiguous(), piv.contiguous()
    x, x2 = kernels.lu_solve_f64(lu, piv, bt), kernels.lu_solve_f64(lu, piv, bt)
    x_p = kernels.lu_solve_f64_plain(lu, piv, bt)
    _, sol = lu_f64_residuals(Kt, lu, piv, x, bt)
    assert float(sol.max()) <= 1e-13 and torch.equal(x.view(torch.int64), x2.view(torch.int64))
    assert float((x - x_p).abs().max() / x_p.abs().max()) <= 1e-8
    for N, B in ((37, 4), (543, 1), (543, 16), (1055, 1), (1311, 1), (1823, 1), (2335, 1)):
        K, b = host_kkt_matrices(N, B, seed=N + B)
        bad = []
        if B >= 3:
            K[1, :, 5] = 0.
            K[2, 4, 7] = np.nan
            bad = [1, 2]
        Kt, bt = torch.as_tensor(K, device=cuda), torch.as_tensor(b, device=cuda)
        K0 = Kt.clone()
        before = dict(kernels.LAUNCHES)
        lu, piv = kernels.lu_factor_f64(Kt)
        x = kernels.lu_solve_f64(lu, piv, bt)
        lu2, piv2 = kernels.lu_factor_f64(Kt)
        x2 = kernels.lu_solve_f64(lu2, piv2, bt)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES['lu_factor_f64'] == before['lu_factor_f64'] + 2
        assert kernels.LAUNCHES['lu_solve_f64'] == before['lu_solve_f64'] + 2
        assert torch.equal(Kt.view(torch.int64), K0.view(torch.int64))
        assert torch.equal(lu.view(torch.int64), lu2.view(torch.int64))
        assert torch.equal(x.view(torch.int64), x2.view(torch.int64)) and torch.equal(piv, piv2)
        lu_p, piv_p = kernels.lu_factor_f64_plain(Kt)
        x_p = kernels.lu_solve_f64_plain(lu_p, piv_p, bt)
        good = [i for i in range(B) if i not in bad]
        fac, sol = lu_f64_residuals(Kt[good], lu[good], piv[good], x[good], bt[good])
        assert float(fac.max()) <= 1e-13 and float(sol.max()) <= 1e-13, (N, B, fac, sol)
        assert torch.equal(piv[good], piv_p[good])
        gap = (x[good] - x_p[good]).abs().amax(1) / x_p[good].abs().amax(1)
        assert float(gap.max()) <= 1e-8, (N, B, gap)
        for i in bad:
            assert not bool(torch.isfinite(x[i]).all())
        if bad:
            lu_c, piv_c = kernels.lu_factor_f64(Kt[good].contiguous())
            assert torch.equal(lu_c.view(torch.int64), lu[good].view(torch.int64))
            x_c = kernels.lu_solve_f64(lu_c, piv_c, bt[good].contiguous())
            assert torch.equal(x_c.view(torch.int64), x[good].view(torch.int64))
