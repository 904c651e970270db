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


@pytest.mark.parametrize('N', [37, 130, 543, 577, 600, 1055])
def test_lu_factor_geometry(N):
    """The cluster variant at the slice's N=543 within one block's shared
    memory, the unblocked one at the n_k=8 system's N=1055; a cluster
    layout stays within a block's shared memory, covers all N columns
    exactly once and fits each CTA's columns, and the kernel's compiled
    limits hold (C <= 8, N <= 1024 panel rows in registers)."""
    from awebox_tpu_torch.parallel import kernels
    g = kernels.lu_factor_geometry(N)
    if N == 543:
        assert g.variant == 'cluster' and g.C == 8 and g.nb == 16
    if N == 1055:
        assert g.variant == 'unblocked'
    if g.variant == 'unblocked':
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


def test_kkt_assembly_plain_is_the_jax_formula():
    """K1's plain version computes awebox_tpu/parallel/batch.py:333-336,
    409-413 exactly: the same f32 operations in the same order (checked bit
    for bit against the formula in numpy f32)."""
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
    for b in range(B):
        d32 = np.float32(delta[b])
        Wd = W[b] + d32 * np.diag(free)
        K = np.block([[Wd, A[b].T], [A[b], -np.diag(Dr[b])]])
        kdiag = np.concatenate([np.abs(np.diag(K)[:n]), Dr[b]])
        kd_ref = np.clip(np.float32(1.0) / np.sqrt(np.clip(kdiag, np.float32(1e-8), None)),
                         np.float32(0.), np.float32(1e4))
        np.testing.assert_array_equal(kd[b].numpy(), kd_ref)
        np.testing.assert_array_equal(Ks[b].numpy(), K * kd_ref[:, None] * kd_ref[None, :])
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
    dw, dnu, ok = batch._auglu_solve(*sys_, n, 1e-8, 1e-8, N_LADDER, LADDER)
    assert bool(ok.all()) and bool(torch.isfinite(dw).all())
    kernels.advance_state(*random_step_inputs())
    state, derivs, lbw, ubw, free = newton_inputs()
    out = kernels.newton_kkt(state, derivs, lbw, ubw, free, 1e-8, 1e-8)
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
        for k in ('newton_kkt', 'kkt_assemble_scaled', 'ip_step'):
            assert kernels.LAUNCHES[k] == before[k] + 1, k


@pytest.mark.cuda
def test_direction_solve_on_card_matches_cpu(cuda):
    """K1-K3 inside the whole direction solve (two f64 refinement sweeps and
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
    out_c = batch._auglu_solve(*card, *args)
    out_h = batch._auglu_solve(*host, *args)
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
    """The cluster variant of K2 against cuSOLVER and the CPU mirror of its
    algorithm, at N = 37 and 543 and B = 1, 3 and 16: pivots equal to cuSOLVER's on matrices
    with well-separated pivots, the P L U and scaled-residual gates, a
    singular lane (a zero column) with a non-finite factor and solve, and a
    lane with a NaN column whose pivots are the mirror's (the diagonal from
    that column on). The counter of the cluster variant moves once per
    factor. Then the unblocked variant at N=1055, B=2, which no cluster
    holds."""
    from awebox_tpu_torch.parallel import kernels
    for N, B in ((N, B) for N in (37, 543) for B in (1, 3, 16)):
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
        assert kernels.LAUNCHES['lu_factor_cluster'] == before['lu_factor_cluster'] + 1
        assert kernels.LAUNCHES['lu_factor_batched'] == before['lu_factor_batched'] + 1
        good = [b for b in range(B) if b not in bad]
        piv_p = kernels.lu_factor_batched_plain(Ac[good])[1]
        assert torch.equal(piv[good], piv_p.contiguous())
        plu_and_residual_gates(Ac[good].contiguous(), lu[good].contiguous(),
                               piv[good].contiguous(), 'cluster')
        for b, kind in bad.items():
            x = kernels.lu_solve_batched(lu[b:b + 1], piv[b:b + 1], torch.ones(1, N, device=cuda),
                                         torch.ones(1, N, device=cuda))
            assert not bool(torch.isfinite(x).all()), kind
            if kind == 'singular':
                assert not bool(torch.isfinite(lu[b]).all())
            else:
                assert torch.equal(piv[b].cpu(), cluster_lu_mirror(A[b])[1])
    A = torch.as_tensor(np.random.default_rng(9).standard_normal((2, 1055, 1055)),
                        dtype=torch.float32, device=cuda)
    before = dict(kernels.LAUNCHES)
    lu, piv = kernels.lu_factor_batched(A.clone())
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['lu_factor_unblocked'] == before['lu_factor_unblocked'] + 1
    plu_and_residual_gates(A, lu, piv, 'unblocked')


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
