"""The CUDA kernels of the PyTorch port (awebox_tpu_torch/parallel/kernels.py,
csrc/auglu.cu) against their plain PyTorch versions.

This file imports no JAX, so the card's machine, which has none, runs it:

    python -m pytest tests/test_torch_kernels.py -q -m cuda --noconftest

(``--noconftest``: tests/conftest.py configures JAX). The tests marked
``cuda`` skip without a card; the others check, on the CPU, what the kernels'
callers rely on there.
"""
import ctypes
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


def cluster_qr_mirror(A, C=8, nb=16):
    """Plain-PyTorch mirror of csrc/auglu.cu's qr_factor_cluster_kernel on
    one (N, N) f32 matrix, with the kernel's bookkeeping: panel g of nb
    columns lives on owner g % C as its local panel g // C; per panel the
    owner factors its columns one reflector at a time (each applied to the
    panel's later columns), then every owner applies the panel's reflectors,
    one after the other and masked to their rows (an implied 1 on the
    diagonal, zeros above), to its trailing local panels (those from
    lp_start on), rows p0 and below. Returns (qr, tau) like torch.geqrf."""
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
    tau = torch.zeros(N, dtype=A.dtype)

    def apply(k, gk, V, t, cols):
        v = V[gk:, k].clone()
        v[0] = 1.
        cols[gk:] -= t * v[:, None] * (v @ cols[gk:])[None, :]

    for p in range(panels):
        owner, lpo, p0 = p % C, p // C, p * nb
        w = min(nb, N - p0)
        P = local[owner][:, lpo * nb:lpo * nb + w]
        for k in range(w):
            gk = p0 + k
            beta, tau[gk], v = larfg(P[gk, k], P[gk + 1:, k])
            P[gk, k] = beta
            P[gk + 1:, k] = v
            apply(k, gk, P, tau[gk], P[:, k + 1:])
        V = P.clone()
        for r in range(C):
            lp_start = 0 if p < r else (p - r) // C + 1
            c0 = lp_start * nb
            if c0 < local[r].shape[1]:
                for k in range(w):
                    apply(k, p0 + k, V, tau[p0 + k], local[r][:, c0:])
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


@pytest.mark.parametrize('N', [37, 130, 543])
def test_cluster_qr_mirror_matches_lapack(N):
    """The QR cluster kernel's algorithm (mirrored on the CPU: panels of 16
    dealt to 8 owners, a reflector at a time in the panel, the panel's
    reflectors one after the other on the trailing columns) against LAPACK's
    geqrf on the same Gaussian f32 input. Both follow larfg's sign rule, so
    here even the entries agree: R and the reflectors to 1e-4 of max |A|,
    tau to 1e-4, |diag R| to TOL_QR_DIAG of its maximum; and Q R, rebuilt
    from the mirror's reflectors, reproduces A to 1e-5 of max |A| (the f32
    backward error of Householder QR at these N). N mod 16 is 5, 2 and 15:
    the ragged last panel."""
    A = gaussian_lanes(1, N, seed=N)[0][0]
    qr, tau = cluster_qr_mirror(A.clone())
    qr_p, tau_p = torch.geqrf(A)
    amax = float(A.abs().max())
    assert float((qr - qr_p).abs().max()) <= 1e-4 * amax
    assert float((tau - tau_p).abs().max()) <= 1e-4
    dk, dp = qr.diagonal().abs(), qr_p.diagonal().abs()
    assert float((dk - dp).abs().max()) <= TOL_QR_DIAG * float(dp.max())
    Q = torch.linalg.householder_product(qr, tau)
    assert float((Q @ torch.triu(qr) - A).abs().max()) <= 1e-5 * amax


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
    CTA's columns beside the panel copy, and keeps the float4 copy of the
    panel's rows inside a column (ld a multiple of 4, >= N); a blocked
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
    if N in (640, 700, 1055, 1300):
        assert g.variant == 'blocked'
    if g.variant == 'blocked':
        assert (g.C, g.nb, g.cols_per_cta) == (1, 32, 32)
        assert g.ld >= N and g.ld % 2 == 1 and g.smem_bytes == 4 * 32 * g.ld
        assert g.smem_bytes + kernels.QR_PANEL_STATIC_SMEM <= 232_448
        assert kernels.QR_PANEL_STATIC_SMEM >= 4 * (32 + 2 * 32 * 33)
        return
    assert N <= kernels.QR_ROW_MAX and g.ld <= kernels.QR_ROW_MAX
    assert g.smem_bytes + kernels.LU_STATIC_SMEM <= 232_448
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


@pytest.mark.parametrize('N', [37, 543, 1055, 1300])
def test_qr_solve_geometry(N):
    """K7 pads the right-hand side to whole panels of 32 and stages a row of
    36 f32 for each of its entries (16-byte rows for the float4 reads),
    beside every warp's partial Gram matrix (32 rows of 36) and partial
    V^T y: 16 warps at the slice's N=543, 8 where the staged rows leave less
    room (N=1055), within one block's shared memory; a lane too large for
    that raises."""
    from awebox_tpu_torch.parallel import kernels
    if N == 1300:
        with pytest.raises(ValueError, match='no room'):
            kernels.qr_solve_geometry(N)
        return
    g = kernels.qr_solve_geometry(N)
    assert g.tiles == -(-N // kernels.QR_SOLVE_NB)
    assert g.warps in kernels.QR_SOLVE_WARPS and g.warps == (8 if N == 1055 else 16)
    rows = g.tiles * 32
    assert kernels.QR_SOLVE_LDV % 4 == 0 and kernels.QR_SOLVE_LDV >= 32
    assert g.smem_bytes == 4 * (rows * 37 + g.warps * 32 * 37)
    assert g.smem_bytes + kernels.QR_SOLVE_STATIC_SMEM <= 232_448
    assert kernels.QR_SOLVE_STATIC_SMEM >= 4 * (32 * 33 + 32 + 32)


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
    assert kernels.LAUNCHES == before
    assert kernels._lib is None


def test_ctypes_signatures_match_the_cuda_entry_points():
    """The argument types bound in kernels.SIGNATURES are those of the
    extern "C" functions of csrc/auglu.cu (a mismatch would only show as a
    wrong launch on the card)."""
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
    """K5 (ruiz_scale) bit for bit with its plain version, NaN rows
    included; K6 in both variants (the cluster kernel at N = 37 and 543, the
    blocked one at N = 1055) and K7 by the gates of hold_qr_factor_and_solve
    at B = 1, 3 and 16; a singular lane (a zero column: a zero on R's
    diagonal) and a lane with a NaN column give a non-finite solution, as
    with the library, and leave the other lanes alone. Each counter moves
    once per call."""
    from awebox_tpu_torch.parallel import kernels
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
