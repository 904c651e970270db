"""Batched interior-point iteration over scenario lanes.

Counterpart of ``awebox_tpu/parallel/batch.py`` for ``kkt='auglu'`` with
either factor, stateless (``auglu_mode=None``): a fixed-iteration
primal-dual step (no line search) with fraction-to-boundary steps and a
monotone barrier schedule, written over an explicit leading lane axis
instead of ``vmap``.

The direction factors the row-equilibrated augmented KKT system

    K(delta) = [[W0 + delta diag(free), A'^T], [A', -(D' + delta_ce)]],
    A' = R A,  D' = R D R,  duals nu = R nu'

in f32, inside a delta ladder (x100, at most ``n_ladder`` retries) that
re-attempts only the lanes whose solution fails its test:

``auglu_factor='qr'`` (the default, as in the JAX package): three Ruiz
    sweeps M = s K s, Householder QR of M, the solve R^-1 Q^T v, and one
    guarded sweep of f64-residual refinement that keeps whichever iterate
    has the smaller residual; a lane fails when its solution is non-finite,
    larger than ``dw_cap``, or leaves a relative residual above 1e-3.
``auglu_factor='lu'``: Jacobi scaling, partial-pivot LU and two sweeps of
    f64-residual refinement; a lane fails when its solution is non-finite
    or larger than ``dw_cap``.

Every piece but the refinement is a hand-written kernel of ``kernels.py``:
the Newton system with its equilibration and K(delta_w) (newton_kkt), the
Ruiz sweeps, the factors, the solves, and the direction from the solution
with the step (ip_step). The f64 residual products and the ladder's
bookkeeping stay plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ocp.structured import make_structured_derivs
from ..opti.ipsolver import InteriorPointSolver
from ..tree import to_tensors, tree_map
from . import kernels

FACTORS = ('qr', 'lu')


def resolve_kkt(ocp, kkt: str) -> str:
    """``kkt`` as the JAX package resolves it (batch.py:94-106): 'auto' is
    'block' wherever the zoh interval layout has no horizon-coupling rows
    (no vortex or averaged induction, no integral outputs, u_param neither
    'poly' nor 'ms', no xi parameters, no MPC trajectory), else 'dense'."""
    if kkt != 'auto':
        return kkt
    if not hasattr(ocp, 'model'):
        return 'dense'
    dense_only = (
        ocp.model.cfg.get('induction_model') in ('vortex', 'averaged')
        or ocp.options['model']['integral_outputs']
        or ocp.vstruct.u_param in ('poly', 'ms')
        or getattr(ocp.vstruct, 'with_xi', False)
        or ocp.options['user_options']['trajectory']['type'] == 'mpc')
    return 'dense' if dense_only else 'block'


def make_ip_step(ocp, delta_w: float = 1e-8, delta_c: float = 1e-8,
                 tau: float = 0.99, kappa_mu: float = 0.8,
                 mu_min: float = 1e-8, n_ladder: int = 7,
                 ladder_factor: float = 100., kkt: str = 'auto',
                 hessian: str = 'exact', split: bool = False,
                 auglu_factor: str = 'qr', auglu_mode=None):
    """Returns (derivs_fn, direction_fn) for a batch of lanes.

    The defaults are the JAX package's (``kkt='auto'``, ``split=False``),
    which the port does not run yet: 'auto' resolves as there (resolve_kkt),
    and its 'block' and 'dense' modes raise, as does the fused step of
    ``split=False``. The ported path is ``kkt='auglu', split=True``.

    derivs_fn(W, Y, LAM, P) -> (fval, gradf, cE, cI, JE, JI, H), every
    output with a leading lane axis, in the dtype of W.
    direction_fn(state, derivs_out, lbw, ubw, free) -> new state, where
    state holds w, s, y, lam, zl, zu (B, .), mu and err (B,), all f64."""
    resolved = resolve_kkt(ocp, kkt)
    if resolved != 'auglu':
        how = f' (resolved from {kkt!r})' if resolved != kkt else ''
        raise NotImplementedError(f'kkt={resolved!r}{how} is not ported')
    if not split:
        raise NotImplementedError('split=False (the fused step) is not ported')
    if auglu_factor not in FACTORS:
        raise ValueError(f'auglu_factor={auglu_factor!r}: one of {FACTORS}')
    if auglu_mode is not None:
        raise NotImplementedError(f'auglu_mode={auglu_mode!r} (a factor kept across '
                                  'iterations) is not ported')
    n = ocp.vstruct.total
    n_eq, n_ineq = ocp.n_eq, ocp.n_ineq
    if not n_ineq:
        raise NotImplementedError('problems without inequalities are not ported')
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp, hessian)
    scaled = auglu_factor == 'lu'

    def derivs_fn(W, Y, LAM, P):
        return tuple(vals_fn(W, Y, LAM, P)) + tuple(jac_fn(W, P)) \
            + (hess_fn(W, Y, LAM, P),)

    def direction(state, derivs_out, lbw, ubw, free):
        sys_ = kernels.newton_kkt(state, derivs_out, lbw, ubw, free, delta_w, delta_c, scaled)
        x, ok = _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor)
        return kernels.ip_step(x, ok, sys_['rn'], sys_['r1'], state, derivs_out, lbw, ubw,
                               free, tau, kappa_mu, mu_min)

    return derivs_fn, direction


def _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor, dw_cap=1e4,
                  n_refine=2):
    """The f32-factored solve of the row-equilibrated augmented KKT system
    with f64-residual refinement, batched over lanes, from newton_kkt's
    output: with its Ks and kd the LU recipe (batch.py:404-446), with its
    unscaled K the QR recipe (batch.py:338-402, stateless). The first
    attempt factors K(delta_w) of every lane as newton_kkt left it; lanes
    whose solution fails the recipe's test retry with delta raised x
    ladder_factor, at most n_ladder times, each retry assembling K(delta)
    of its lanes alone. ``n_refine`` is the LU recipe's; the QR recipe runs
    its one guarded sweep.

    Returns (x (B, N) f64, the solution [dw'; dnu'] of the scaled system,
    and ok (B,) bool)."""
    fdt = torch.float32
    qr = 'K' in sys_
    W64, A64, D_reg, r1, r2_e, b = (sys_[k] for k in ('W64', 'A64', 'D_reg', 'r1', 'r2_e', 'b'))
    rdt = b.dtype
    B = b.shape[0]

    def attempt_lu(Ks, kd, idx, delta):
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

    def attempt_qr(K, idx):
        """Ruiz-equilibrate and QR-factor K of the lanes idx (None: all),
        solve, and refine once under the guard: the residual is taken
        against the f64 image of the f32 M, the system being solved."""
        M, s32 = kernels.ruiz_scale(K)
        fac, tau_ = kernels.qr_factor_batched(M)

        def msolve(v):
            return kernels.qr_solve_batched(fac, tau_, v.to(fdt).contiguous()).to(rdt)

        M64, s = M.to(rdt), s32.to(rdt)
        c = (b if idx is None else b[idx]) * s
        z = msolve(c)
        res = c - (M64 @ z[:, :, None])[:, :, 0]
        best = res.abs().amax(dim=1)
        z1 = z + msolve(res)
        b1 = (c - (M64 @ z1[:, :, None])[:, :, 0]).abs().amax(dim=1)
        z = torch.where((b1 < best)[:, None], z1, z)
        best = torch.minimum(best, b1)
        x = s * z
        rel = best / torch.clamp(c.abs().amax(dim=1), min=1e-30)
        ok = torch.isfinite(x).all(dim=1) & (torch.abs(x[:, :n]).amax(dim=1) <= dw_cap) \
            & (rel <= 1e-3)
        return x, ok

    if qr:
        x, ok = attempt_qr(sys_['K'], None)
    else:
        x, ok = attempt_lu(sys_['Ks'], sys_['kd'], None, delta_w)
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
        pieces = (W64[bad].to(fdt), A64[bad].to(fdt), Dr32[bad], free32, delta[bad])
        if qr:
            xb, okb = attempt_qr(kernels.kkt_assemble(*pieces), bad)
        else:
            xb, okb = attempt_lu(*kernels.kkt_assemble_scaled(*pieces), bad, delta[bad])
        x[bad] = xb
        ok[bad] = okb
    return x, ok


def _auglu_solve(W0, A, D, r1, r2, free, n, delta_w, delta_ce, n_ladder,
                 ladder_factor, dw_cap=1e4, n_refine=2, factor='qr'):
    """The direction solve from an assembled Newton system (batch.py:275-446,
    stateless): equilibrate, K(delta_w) by the retry assembly of ``factor``,
    then _ladder_solve.

    The direction does not call it (newton_kkt builds the system and
    K(delta_w) in one kernel pair); it stays as the counterpart of the JAX
    package's _auglu_solve, the entry for raw (W0, A, D, r1, r2) systems
    through which the parity tests and chip_smoke.py hold both solves and
    the delta ladder to the JAX package and to the CPU.

    W0 (B,n,n), A (B,m,n), D, r2 (B,m), r1 (B,n) are f64, free (n,) f64.
    Returns (dw (B,n), dnu (B,m), ok (B,) bool)."""
    if factor not in FACTORS:
        raise ValueError(f'factor={factor!r}: one of {FACTORS}')
    rdt = W0.dtype
    eq = kernels.equilibrate(W0, A, D, r1, r2, free, delta_ce)
    delta = torch.full((W0.shape[0],), delta_w, dtype=rdt, device=W0.device)
    pieces = (eq['W32'], eq['A32'], eq['Dr32'], eq['free32'], delta)
    if factor == 'qr':
        mats = dict(K=kernels.kkt_assemble(*pieces))
    else:
        Ks, kd = kernels.kkt_assemble_scaled(*pieces)
        mats = dict(Ks=Ks, kd=kd)
    sys_ = dict(mats, W64=eq['W32'].to(rdt), A64=eq['A32'].to(rdt), D_reg=eq['D_reg'],
                Dr32=eq['Dr32'], r1=r1, r2_e=eq['r2_e'], b=eq['b'])
    x, ok = _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor, dw_cap, n_refine)
    return x[:, :n] * free, eq['rn'] * x[:, n:], ok


def init_batched_state(ocp, V_init_batch, P, lb, ub, mu0=1e-2, with_err: bool = False,
                       device='cuda'):
    """Stack per-scenario initial states (batch.py:625-632): one state per
    initial guess of ``V_init_batch``, all under the parameters ``P`` (a tree
    of numpy arrays or tensors) and the bounds lb, ub, as f64 tensors on
    ``device`` (the card unless the caller passes 'cpu'; without a card a
    CUDA device raises). With ``with_err`` the state carries err = inf."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'init_batched_state: device {device!r} asked for, but no '
                           "CUDA card is available (pass device='cpu' for the CPU)")
    P_cpu = to_tensors(P, torch.float64, 'cpu')
    states = [_single_state(ocp, V0, P_cpu, lb, ub, mu0) for V0 in V_init_batch]
    out = {k: np.stack([st[k] for st in states]) for k in states[0]}
    if with_err:
        out['err'] = np.full(len(states), np.inf)
    return state_from_numpy(out, device)


def _single_state(ocp, V0, P, lb, ub, mu0):
    """One scenario's interior starting point in numpy (batch.py:635-652):
    w pushed inside its bounds, violation-scale slacks, and duals at the
    barrier's level."""
    lbw, ubw, free, center = InteriorPointSolver.split_pins(lb, ub)
    w = np.where(free > 0.5, np.asarray(V0), center)
    span = np.minimum(1e-2 * np.maximum(1., np.abs(w)), 0.5 * (ubw - lbw))
    w = np.clip(w, np.where(np.isfinite(lbw), lbw + span, -np.inf),
                np.where(np.isfinite(ubw), ubw - span, np.inf))
    cI = ocp.ineq_fn(torch.as_tensor(w, dtype=torch.float64), P).numpy()
    s = np.maximum(np.abs(cI), mu0)   # violation-scale slacks (see ipsolver)
    lam = np.maximum(mu0 / s, 1e-8)
    dl = np.where(np.isfinite(lbw), np.maximum(w - lbw, 1e-8), np.inf)
    du = np.where(np.isfinite(ubw), np.maximum(ubw - w, 1e-8), np.inf)
    zl = np.where(np.isfinite(lbw), mu0 / dl, 0.)
    zu = np.where(np.isfinite(ubw), mu0 / du, 0.)
    return dict(w=w, s=s, y=np.zeros(ocp.n_eq), lam=lam, zl=zl, zu=zu, mu=np.asarray(float(mu0)))


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
