"""Batched interior-point iteration over scenario lanes.

Counterpart of ``awebox_tpu/parallel/batch.py`` for ``kkt='auglu'`` with
``auglu_factor='lu'``: a fixed-iteration primal-dual step (no line search)
with fraction-to-boundary steps and a monotone barrier schedule, written
over an explicit leading lane axis instead of ``vmap``.

The direction factors the row-equilibrated augmented KKT system

    K(delta) = [[W0 + delta diag(free), A'^T], [A', -(D' + delta_ce)]],
    A' = R A,  D' = R D R,  duals nu = R nu'

in f32 with Jacobi scaling and partial-pivot LU, then runs two sweeps of
f64-residual refinement, inside a delta ladder (x100, at most ``n_ladder``
retries) that re-attempts only the lanes whose solution is non-finite or
larger than ``dw_cap``. The O(n^3) factor and the O(n^2) assembly and
triangular solves are the hand-written kernels of ``kernels.py``; the
sanitising, sigma, W0, A, D, r1/r2, the f64 residual matvecs and
ds/dzl/dzu/err stay plain torch, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ocp.structured import make_structured_derivs
from ..tree import to_tensors, tree_map
from . import kernels


def make_ip_step(ocp, delta_w: float = 1e-8, delta_c: float = 1e-8,
                 tau: float = 0.99, kappa_mu: float = 0.8,
                 mu_min: float = 1e-8, n_ladder: int = 7,
                 ladder_factor: float = 100., kkt: str = 'auglu',
                 hessian: str = 'exact', split: bool = True,
                 auglu_factor: str = 'lu'):
    """Returns (derivs_fn, direction_fn) for a batch of lanes.

    derivs_fn(W, Y, LAM, P) -> (fval, gradf, cE, cI, JE, JI, H), every
    output with a leading lane axis, in the dtype of W.
    direction_fn(state, derivs_out, lbw, ubw, free) -> new state, where
    state holds w, s, y, lam, zl, zu (B, .), mu and err (B,), all f64."""
    if kkt != 'auglu':
        raise NotImplementedError(f'kkt={kkt!r} is not ported')
    if not split:
        raise NotImplementedError('split=False (the fused step) is not ported')
    if auglu_factor != 'lu':
        raise NotImplementedError(f'auglu_factor={auglu_factor!r} is not ported')
    n = ocp.vstruct.total
    n_eq, n_ineq = ocp.n_eq, ocp.n_ineq
    if not n_ineq:
        raise NotImplementedError('problems without inequalities are not ported')
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp, hessian)

    def derivs_fn(W, Y, LAM, P):
        return tuple(vals_fn(W, Y, LAM, P)) + tuple(jac_fn(W, P)) \
            + (hess_fn(W, Y, LAM, P),)

    def direction(state, derivs_out, lbw, ubw, free):
        s, zl, zu, mu = state['s'], state['zl'], state['zu'], state['mu']
        m_ = mu[:, None]
        sys_ = newton_system(state, derivs_out, lbw, ubw, free, delta_c)
        dl, du, r1, cE, cI = (sys_[k] for k in ('dl', 'du', 'r1', 'cE', 'cI'))
        dw, dnu, ok = _auglu_solve(sys_['W0'], sys_['A'], sys_['D'], r1,
                                   sys_['r2'], free, n, delta_w, delta_c,
                                   n_ladder, ladder_factor)
        okc = ok[:, None]
        dw = torch.where(okc & torch.isfinite(dw), dw, 0.)
        dnu = torch.where(okc & torch.isfinite(dnu), dnu, 0.)
        dy, dlam = dnu[:, :n_eq].contiguous(), dnu[:, n_eq:].contiguous()
        ds = -(cI + s) - (sys_['JI'].to(dw.dtype) @ dw[:, :, None])[:, :, 0]
        dzl = m_ / dl - zl - zl * dw / dl
        dzu = m_ / du - zu + zu * dw / du
        err_d = torch.abs(r1).amax(dim=1)
        err_p = torch.maximum(torch.abs(cE).amax(dim=1),
                              torch.abs(cI + s).amax(dim=1))
        return kernels.advance_state(
            state, (dw, dy, dlam, ds, dzl, dzu), ok, err_d,
            torch.maximum(err_d, err_p), lbw, ubw, tau, kappa_mu, mu_min)

    return derivs_fn, direction


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
    # non-finite derivatives (iterate escaped the model's domain) must not
    # poison the linear algebra: sanitize, the ladder then produces a
    # heavily damped (near-gradient) step
    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.)
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


def _auglu_solve(W0, A, D, r1, r2, free, n, delta_w, delta_ce, n_ladder,
                 ladder_factor, dw_cap=1e4, n_refine=2):
    """f32 LU of the row-equilibrated augmented KKT system with f64-residual
    refinement, batched over lanes (batch.py:275-336, 404-446, factor='lu').

    W0 (B,n,n), A (B,m,n), D, r2 (B,m), r1 (B,n) are f64, free (n,) f64.
    Returns (dw (B,n), dnu (B,m), ok (B,) bool). A lane is ok when its
    solution is finite and |dw|_inf <= dw_cap; failed lanes retry with
    delta raised x ladder_factor, at most n_ladder times."""
    fdt, rdt = torch.float32, W0.dtype
    B = W0.shape[0]
    eq = equilibrate(W0, A, D, r1, r2, free, delta_ce)
    rn, W32, A32, Dr32, free32 = (eq[k] for k in ('rn', 'W32', 'A32', 'Dr32', 'free32'))
    D_reg, r2_e, b = eq['D_reg'], eq['r2_e'], eq['b']
    W64 = W32.to(rdt)
    A64 = A32.to(rdt)

    def attempt(idx, delta):
        """Solve for the lanes idx at their regularizations delta (len(idx),)."""
        Ks, kd = kernels.kkt_assemble_scaled(W32[idx], A32[idx], Dr32[idx],
                                             free32, delta)
        lu, piv = kernels.lu_factor_batched(Ks)

        def ksolve(v):
            return kernels.lu_solve_batched(lu, piv, kd, v.to(fdt).contiguous()).to(rdt)

        x = ksolve(b[idx])
        Wi, Ai, Di = W64[idx], A64[idx], D_reg[idx]
        for _ in range(n_refine):
            xw, xnu = x[:, :n], x[:, n:]
            r_w = r1[idx] - ((Wi @ xw[:, :, None])[:, :, 0]
                             + delta[:, None] * (free * xw)
                             + (Ai.transpose(1, 2) @ xnu[:, :, None])[:, :, 0])
            r_nu = -r2_e[idx] - ((Ai @ xw[:, :, None])[:, :, 0] - Di * xnu)
            x = x + ksolve(torch.cat([r_w, r_nu], dim=1))
        ok = torch.isfinite(x).all(dim=1) & (torch.abs(x[:, :n]).amax(dim=1) <= dw_cap)
        return x, ok

    all_lanes = torch.arange(B, device=W0.device)
    delta = torch.full((B,), delta_w, dtype=rdt, device=W0.device)
    x, ok = attempt(all_lanes, delta)
    # the ladder: retry only the lanes that still fail
    for _ in range(n_ladder):
        bad = torch.nonzero(~ok).flatten()
        if bad.numel() == 0:
            break
        delta[bad] = torch.clamp(delta[bad] * ladder_factor, min=delta_w)
        xb, okb = attempt(bad, delta[bad])
        x[bad] = xb
        ok[bad] = okb
    dw = x[:, :n] * free
    dnu = rn * x[:, n:]
    return dw, dnu, ok


def stack_p(p_list):
    """Stack per-scenario parameter trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *p_list)


def p_from_numpy(P_np, device, dtype=torch.float64):
    """A parameter tree P (cost/ref/weights/theta0 with numpy leaves, batched
    or not) as tensors of ``dtype`` on ``device``."""
    return to_tensors(P_np, dtype, device)


def state_from_numpy(state_np, device):
    """A primal-dual state (w, s, y, lam, zl, zu, mu[, err]) as f64 tensors on
    ``device``: the state stays f64 on purpose, active bounds sit ~1e-8 from
    their relaxed values, below f32 resolution."""
    return {k: torch.as_tensor(np.array(v), dtype=torch.float64, device=device)
            for k, v in state_np.items()}
