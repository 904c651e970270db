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
larger than ``dw_cap``. Every piece but the refinement is a hand-written
kernel of ``kernels.py``: the Newton system with its equilibration and
K(delta_w) (newton_kkt), the factor, the triangular solves, and the
direction from the solution with the step (ip_step). The f64 residual
matvecs and the ladder's bookkeeping stay plain torch.
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
        sys_ = kernels.newton_kkt(state, derivs_out, lbw, ubw, free, delta_w, delta_c)
        x, ok = _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor)
        return kernels.ip_step(x, ok, sys_['rn'], sys_['r1'], state, derivs_out, lbw, ubw,
                               free, tau, kappa_mu, mu_min)

    return derivs_fn, direction


def _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor, dw_cap=1e4,
                  n_refine=2):
    """f32 LU of the row-equilibrated augmented KKT system with f64-residual
    refinement, batched over lanes (batch.py:404-446, factor='lu'), from
    newton_kkt's output: the first attempt factors its Ks (K(delta_w) of
    every lane); lanes whose solution is non-finite or has |dw|_inf > dw_cap
    retry with delta raised x ladder_factor, at most n_ladder times, each
    retry assembling K(delta) of its lanes alone.

    Returns (x (B, N) f64, the solution [dw'; dnu'] of the scaled system,
    and ok (B,) bool)."""
    fdt = torch.float32
    W64, A64, D_reg, r1, r2_e, b = (sys_[k] for k in ('W64', 'A64', 'D_reg', 'r1', 'r2_e', 'b'))
    rdt = b.dtype
    B = b.shape[0]

    def attempt(Ks, kd, idx, delta):
        """Solve for the lanes idx (None: all) at their regularizations
        delta, a (len(idx),) tensor or, for all lanes, a float."""
        lu, piv = kernels.lu_factor_batched(Ks)
        take = (lambda t: t) if idx is None else (lambda t: t[idx])
        dcol = delta if idx is None else delta[:, None]

        def ksolve(v):
            return kernels.lu_solve_batched(lu, piv, kd, v.to(fdt).contiguous()).to(rdt)

        x = ksolve(take(b))
        Wi, Ai, Di, r1i, r2i = (take(t) for t in (W64, A64, D_reg, r1, r2_e))
        for _ in range(n_refine):
            xw, xnu = x[:, :n], x[:, n:]
            r_w = r1i - ((Wi @ xw[:, :, None])[:, :, 0] + dcol * (free * xw)
                         + (Ai.transpose(1, 2) @ xnu[:, :, None])[:, :, 0])
            r_nu = -r2i - ((Ai @ xw[:, :, None])[:, :, 0] - Di * xnu)
            x = x + ksolve(torch.cat([r_w, r_nu], dim=1))
        ok = torch.isfinite(x).all(dim=1) & (torch.abs(x[:, :n]).amax(dim=1) <= dw_cap)
        return x, ok

    x, ok = attempt(sys_['Ks'], sys_['kd'], None, delta_w)
    # the ladder: retry only the lanes that still fail
    delta = None
    for _ in range(n_ladder):
        bad = torch.nonzero(~ok).flatten()
        if bad.numel() == 0:
            break
        if delta is None:
            delta = torch.full((B,), delta_w, dtype=rdt, device=b.device)
            free32, Dr32 = free.to(fdt), sys_['Dr32']
        delta[bad] = torch.clamp(delta[bad] * ladder_factor, min=delta_w)
        Ks, kd = kernels.kkt_assemble_scaled(W64[bad].to(fdt), A64[bad].to(fdt), Dr32[bad],
                                             free32, delta[bad])
        xb, okb = attempt(Ks, kd, bad, delta[bad])
        x[bad] = xb
        ok[bad] = okb
    return x, ok


def _auglu_solve(W0, A, D, r1, r2, free, n, delta_w, delta_ce, n_ladder,
                 ladder_factor, dw_cap=1e4, n_refine=2):
    """The direction solve from an assembled Newton system (batch.py:275-336,
    404-446, factor='lu'): equilibrate, K(delta_w) by the retry assembly,
    then _ladder_solve.

    The direction no longer calls it (newton_kkt builds the system and
    K(delta_w) in one kernel pair); it stays as the counterpart of the JAX
    package's _auglu_solve, the entry for raw (W0, A, D, r1, r2) systems
    through which the parity tests and chip_smoke.py hold the LU solve and
    the delta ladder to the JAX package and to the CPU.

    W0 (B,n,n), A (B,m,n), D, r2 (B,m), r1 (B,n) are f64, free (n,) f64.
    Returns (dw (B,n), dnu (B,m), ok (B,) bool)."""
    rdt = W0.dtype
    eq = kernels.equilibrate(W0, A, D, r1, r2, free, delta_ce)
    delta = torch.full((W0.shape[0],), delta_w, dtype=rdt, device=W0.device)
    Ks, kd = kernels.kkt_assemble_scaled(eq['W32'], eq['A32'], eq['Dr32'], eq['free32'], delta)
    sys_ = dict(Ks=Ks, kd=kd, W64=eq['W32'].to(rdt), A64=eq['A32'].to(rdt), D_reg=eq['D_reg'],
                Dr32=eq['Dr32'], r1=r1, r2_e=eq['r2_e'], b=eq['b'])
    x, ok = _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor, dw_cap, n_refine)
    return x[:, :n] * free, eq['rn'] * x[:, n:], ok


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
