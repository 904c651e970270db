"""Batched interior-point iteration over scenario lanes.

Counterpart of ``awebox_tpu/parallel/batch.py``: a fixed-iteration
primal-dual step (no line search) with fraction-to-boundary steps and a
monotone barrier schedule, written over an explicit leading lane axis
instead of ``vmap``, and ``make_batched_solver``, the loop over it. Three
KKT modes give the direction, as in the JAX package:

``kkt='block'`` (what 'auto' picks for the structured collocation layout):
    the block-structured two-level Cholesky of ocp/blockkkt.py, K8 and K9.
``kkt='dense'`` (what 'auto' picks otherwise, and for a caller's
    derivs_fn): the condensed M = W0 + delta diag(free) + A_s^T A_s in
    ``solve_dtype``, its Cholesky inside a delta ladder (K10) and three
    solves (K11): one, then two refinement sweeps.
``kkt='auglu'``: the f32-factored row-equilibrated augmented system

    K(delta) = [[W0 + delta diag(free), A'^T], [A', -(D' + delta_ce)]],
    A' = R A,  D' = R D R,  duals nu = R nu'

  with f64-residual refinement inside a delta ladder (x100, at most
  ``n_ladder`` retries) that re-attempts only the lanes whose solution fails
  its test:

  ``auglu_factor='qr'`` (the default, as in the JAX package): three Ruiz
      sweeps M = s K s, Householder QR of M, the solve R^-1 Q^T v, and one
      guarded sweep of f64-residual refinement that keeps whichever iterate
      has the smaller residual; a lane fails when its solution is
      non-finite, larger than ``dw_cap``, or leaves a relative residual
      above 1e-3.
  ``auglu_factor='lu'``: Jacobi scaling, partial-pivot LU and two sweeps of
      f64-residual refinement; a lane fails when its solution is non-finite
      or larger than ``dw_cap``.

  Every piece but the refinement is a hand-written kernel of ``kernels.py``:
  the Newton system with its equilibration and K(delta_w) (newton_kkt), the
  Ruiz sweeps, the factors, the solves, and the direction from the solution
  with the step (ip_step).

The block and condensed directions step through K4's advance_state entry.
The f64 residual products, the assemblies around the factors and the
ladders' bookkeeping stay plain torch.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value, jacfwd, vmap

from ..ocp.structured import make_structured_derivs
from ..opti.ipsolver import InteriorPointSolver
from ..tree import to_tensors, tree_map
from . import kernels

FACTORS = ('qr', 'lu')
KKT_MODES = ('auglu', 'dense', 'block')


def resolve_kkt(ocp, kkt: str, derivs_fn=None) -> str:
    """``kkt`` as the JAX package resolves it (batch.py:94-106): 'auto' is
    'dense' for a caller's ``derivs_fn`` or an OCP without a model, else
    'block' wherever the zoh interval layout has no horizon-coupling rows
    (no vortex or averaged induction, no integral outputs, u_param neither
    'poly' nor 'ms', no xi parameters, no MPC trajectory), else 'dense'."""
    if kkt != 'auto':
        return kkt
    if derivs_fn is not None or not hasattr(ocp, 'model'):
        return 'dense'
    dense_only = (
        ocp.model.cfg.get('induction_model') in ('vortex', 'averaged')
        or ocp.options['model']['integral_outputs']
        or ocp.vstruct.u_param in ('poly', 'ms')
        or getattr(ocp.vstruct, 'with_xi', False)
        or ocp.options['user_options']['trajectory']['type'] == 'mpc')
    return 'dense' if dense_only else 'block'


def _solve_dtype(solve_dtype):
    """None, a torch dtype or a dtype's name ('float64') -> a torch dtype or None."""
    if solve_dtype is None or isinstance(solve_dtype, torch.dtype):
        return solve_dtype
    return getattr(torch, str(solve_dtype))


def lane_derivs(derivs_fn):
    """A caller's single-lane derivs_fn(w, y, lam, p) -> (fval, gradf, cE,
    cI, JE, JI, H) mapped over lanes with torch.func.vmap (p with a lane
    axis on every leaf); raises naming derivs_fn where vmap refuses it."""
    mapped = vmap(derivs_fn)

    def derivs(W, Y, LAM, P):
        try:
            return tuple(mapped(W, Y, LAM, P))
        except Exception as exc:   # vmap's refusals come as several types
            raise RuntimeError(f'derivs_fn could not be mapped over lanes with '
                               f'torch.func.vmap: {exc}') from exc
    return derivs


def dense_autodiff_derivs(ocp):
    """Dense autodiff derivatives for an OCP without the structured layout
    (batch.py:125-144): gradient, constraint Jacobians and the Lagrangian's
    Hessian by torch.func, over lanes."""
    f, eq, ineq = ocp.f_fn, ocp.eq_fn, ocp.ineq_fn
    n = ocp.vstruct.total
    n_eq, n_ineq = ocp.n_eq, ocp.n_ineq

    def lagrangian(w, y, lam, p):
        L = f(w, p)
        if n_eq:
            L = L + y @ eq(w, p)
        if n_ineq:
            L = L + lam @ ineq(w, p)
        return L

    def one(w, y, lam, p):
        gradf, fval = grad_and_value(f)(w, p)
        cE = eq(w, p) if n_eq else w.new_zeros(0)
        cI = ineq(w, p) if n_ineq else w.new_zeros(0)
        JE = jacfwd(eq)(w, p) if n_eq else w.new_zeros(0, n)
        JI = jacfwd(ineq)(w, p) if n_ineq else w.new_zeros(0, n)
        H = torch.func.hessian(lagrangian)(w, y, lam, p)
        return fval, gradf, cE, cI, JE, JI, H
    return lane_derivs(one)


def _structured_ok(ocp):
    """The structured per-node derivatives cover the zoh layout without
    horizon-coupling rows (batch.py:113-121)."""
    return (hasattr(ocp, 'model')
            and ocp.vstruct.u_param == 'zoh'
            and ocp.model.cfg.get('induction_model') not in ('vortex', 'averaged')
            and not ocp.options['model']['integral_outputs']
            and not getattr(ocp.vstruct, 'with_xi', False)
            and ocp.options['user_options']['trajectory']['type'] != 'mpc')


def _max_abs(x):
    """max |x| over each lane, 0 for a lane of width 0 (jnp.max's initial)."""
    return torch.abs(x).amax(dim=1) if x.shape[1] else x.new_zeros(x.shape[0])


def _err_p(cE, cI, s):
    err_p = _max_abs(cE)
    if cI.shape[1]:
        err_p = torch.maximum(err_p, _max_abs(cI + s))
    return err_p


def _keep_err(state, out):
    """The new state carries err only where the old one did (batch.py:510)."""
    if 'err' not in state:
        out.pop('err')
    return out


def make_ip_step(ocp, derivs_fn=None, delta_w: float = 1e-8, delta_c: float = 1e-8,
                 tau: float = 0.99, kappa_mu: float = 0.8,
                 mu_min: float = 1e-8, n_ladder: int = 7,
                 ladder_factor: float = 100., kkt: str = 'auto',
                 hessian: str = 'exact', split: bool = False, solve_dtype=None,
                 auglu_factor: str = 'qr', auglu_mode=None):
    """One interior-point iteration for a batch of lanes, with the JAX
    package's parameters and defaults (batch.py:24-272) but ``step_cap``,
    which is not ported.

    state = dict(w, s, y, lam, zl, zu (B, .), mu (B,)[, err (B,)]), all f64;
    p = the parameter tree, every leaf with a lane axis. ``kkt`` resolves as
    in the JAX package (resolve_kkt). 'block' returns the fused step
    ``step(state, p, lbw, ubw, free) -> state`` whatever ``split`` says, as
    there. Otherwise ``split=False`` returns that step and ``split=True``
    (derivs_fn, direction_fn):

        derivs_fn(W, Y, LAM, P) -> (fval, gradf, cE, cI, JE, JI, H), every
        output with a leading lane axis, in the dtype of W (the caller's
        derivs_fn, mapped over lanes, or the structured or dense autodiff
        derivatives);
        direction_fn(state, derivs_out, lbw, ubw, free) -> new state.

    The 'auglu' direction takes JE, JI and H in f32 (the fused step rounds
    them so, as bench.py and refine.make_refiner do); the 'dense' one takes
    them as they come and solves in ``solve_dtype`` (None: W0's dtype; on
    the card f64 only). Problems without inequalities run in every mode;
    there the auglu step assembles its Newton system in plain torch (K1
    takes both row kinds) and steps through advance_state, so K4's ip_step
    is not reached."""
    kkt = resolve_kkt(ocp, kkt, derivs_fn)
    if kkt not in KKT_MODES:
        raise ValueError(f'kkt={kkt!r}: one of {KKT_MODES} or \'auto\'')
    if hessian != 'exact':
        raise NotImplementedError(f'hessian={hessian!r} is not ported')
    if auglu_factor not in FACTORS:
        raise ValueError(f'auglu_factor={auglu_factor!r}: one of {FACTORS}')
    if auglu_mode is not None:
        raise NotImplementedError(f'auglu_mode={auglu_mode!r} (a factor kept across '
                                  'iterations) is not ported')
    if kkt == 'block':
        return _make_block_ip_step(ocp, delta_w=delta_w, delta_c=delta_c, tau=tau,
                                   kappa_mu=kappa_mu, mu_min=mu_min)
    n = ocp.vstruct.total
    n_eq, n_ineq = ocp.n_eq, ocp.n_ineq
    sdt = _solve_dtype(solve_dtype)

    if derivs_fn is not None:
        derivs = lane_derivs(derivs_fn)
    elif _structured_ok(ocp):
        vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp, hessian)

        def derivs(W, Y, LAM, P):
            return tuple(vals_fn(W, Y, LAM, P)) + tuple(jac_fn(W, P)) \
                + (hess_fn(W, Y, LAM, P),)
    else:
        derivs = dense_autodiff_derivs(ocp)

    scaled = auglu_factor == 'lu'

    def auglu_direction(state, derivs_out, lbw, ubw, free):
        if not (n_eq and n_ineq):
            return _unfused_auglu_step(state, derivs_out, lbw, ubw, free)
        sys_ = kernels.newton_kkt(state, derivs_out, lbw, ubw, free, delta_w, delta_c, scaled)
        x, ok = _ladder_solve(sys_, free, n, delta_w, n_ladder, ladder_factor)
        return _keep_err(state, kernels.ip_step(x, ok, sys_['rn'], sys_['r1'], state,
                                                derivs_out, lbw, ubw, free, tau, kappa_mu,
                                                mu_min))

    def _unfused_auglu_step(state, derivs_out, lbw, ubw, free):
        """The auglu step of a problem without equality or inequality rows,
        which K1 and K4's ip_step do not take (batch.py:146-198)."""
        sys_ = kernels.newton_system(state, derivs_out, lbw, ubw, free, delta_c)
        dw, dnu, ok = _auglu_solve(sys_['W0'], sys_['A'], sys_['D'], sys_['r1'], sys_['r2'],
                                   free, n, delta_w, delta_c, n_ladder, ladder_factor,
                                   factor=auglu_factor)
        okc = ok[:, None]
        dw = torch.where(okc & torch.isfinite(dw), dw, 0.)
        dnu = torch.where(okc & torch.isfinite(dnu), dnu, 0.)
        return _step_from(state, sys_, dw, dnu, ok, lbw, ubw)

    def _step_from(state, sys_, dw, dnu, ok, lbw, ubw):
        """ds, dzl, dzu, the errors and advance_state (batch.py:189-198,
        251-263) from a sanitized (dw, dnu) and newton_system's output."""
        s, zl, zu = state['s'], state['zl'], state['zu']
        m_ = state['mu'][:, None]
        dl, du, cE, cI, JI = (sys_[k] for k in ('dl', 'du', 'cE', 'cI', 'JI'))
        dy, dlam = dnu[:, :n_eq].contiguous(), dnu[:, n_eq:].contiguous()
        if n_ineq:
            ds = -(cI + s) - (JI.to(dw.dtype) @ dw[:, :, None])[:, :, 0]
        else:
            ds = s
        dzl = m_ / dl - zl - zl * dw / dl
        dzu = m_ / du - zu + zu * dw / du
        err_d = torch.abs(sys_['r1']).amax(dim=1)
        err_kkt = torch.maximum(err_d, _err_p(cE, cI, s))
        return _keep_err(state, kernels.advance_state(
            state, (dw, dy, dlam, ds, dzl, dzu), ok, err_d, err_kkt, lbw, ubw, tau, kappa_mu,
            mu_min))

    def dense_direction(state, derivs_out, lbw, ubw, free):
        """The condensed direction (batch.py:199-263): M(delta) = W0 +
        delta diag(free) + A_s^T A_s, A_s = A / sqrt(D), factored by K10
        inside the delta ladder, then one solve and two refinement sweeps by
        K11, all in the solve dtype."""
        sys_ = kernels.newton_system(state, derivs_out, lbw, ubw, free, delta_c)
        W0, A, D, r1, r2 = (sys_[k] for k in ('W0', 'A', 'D', 'r1', 'r2'))
        idt = W0.dtype
        dt = sdt or idt
        W0s = W0.to(dt)
        As = A.to(dt) / torch.sqrt(D.to(dt))[:, :, None]
        AtA = As.transpose(1, 2) @ As
        free_s = free.to(dt)

        def M_of(idx, delta):
            Wd = W0s[idx] + delta[:, None, None] * torch.diag(free_s)
            return (Wd + AtA[idx]).contiguous()

        B = W0.shape[0]
        all_lanes = torch.arange(B, device=W0.device)
        delta = torch.full((B,), delta_w, dtype=dt, device=W0.device)
        LM, ok = kernels.chol_factor_batched(M_of(all_lanes, delta))
        # the ladder: raise delta on the lanes whose factor failed, and
        # re-factor those lanes alone
        for _ in range(n_ladder):
            bad = torch.nonzero(~ok).flatten()
            if bad.numel() == 0:
                break
            delta[bad] = torch.clamp(delta[bad] * ladder_factor, min=delta_w)
            LM[bad], ok[bad] = kernels.chol_factor_batched(M_of(bad, delta[bad]))

        def msolve(v):
            return kernels.chol_solve_batched(LM, v.contiguous())

        def mv(X, v):
            return (X @ v[:, :, None])[:, :, 0]

        Wd = W0s + delta[:, None, None] * torch.diag(free_s)
        rhs_w = (r1 - mv(A.transpose(1, 2), r2 / D)).to(dt)
        dw = msolve(rhs_w)
        for _ in range(2):   # refinement against the 1/delta_ce conditioning
            dw = dw + msolve(rhs_w - (mv(Wd, dw) + mv(As.transpose(1, 2), mv(As, dw))))
        dw = (dw * free_s).to(idt)
        dnu = ((mv(A, dw) + r2) / D).to(idt)
        # if even the maximally damped factorization failed, stand still
        okc = ok[:, None]
        dw = kernels.fin(torch.where(okc, dw, 0.))
        dnu = kernels.fin(torch.where(okc, dnu, 0.))
        return _step_from(state, sys_, dw, dnu, ok, lbw, ubw)

    direction = dense_direction if kkt == 'dense' else auglu_direction
    if split:
        return derivs, direction
    f32 = torch.float32

    def step(state, p, lbw, ubw, free):
        derivs_out = derivs(state['w'], state['y'], state['lam'], p)
        if kkt == 'auglu':
            fval, gradf, cE, cI = derivs_out[:4]
            derivs_out = (fval, gradf, cE, cI) + tuple(J.to(f32) for J in derivs_out[4:])
        return direction(state, derivs_out, lbw, ubw, free)

    return step


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


def _make_block_ip_step(ocp, delta_w=1e-8, delta_c=1e-8, tau=0.99, kappa_mu=0.8,
                        mu_min=1e-8):
    """The interior-point step whose direction comes from the block-structured
    factorization (ocp/blockkkt.py; batch.py:515-541): block derivatives,
    kkt_solve (K8, K9), then advance_state (K4)."""
    from ..ocp.blockkkt import make_block_kkt
    derivs_fn, kkt_solve, _ = make_block_kkt(ocp)

    def step(state, p, lbw, ubw, free):
        w, s, y, lam = state['w'], state['s'], state['y'], state['lam']
        blocks = derivs_fn(w, y, lam, p)
        dw, dy, dlam, ds, dzl, dzu, ok, info = kkt_solve(
            blocks, w, s, y, lam, state['zl'], state['zu'], lbw, ubw, free, state['mu'],
            delta_w, delta_c, delta_c)
        err_p = _err_p(kernels.fin(blocks['cE']), kernels.fin(blocks['cI']), s)
        direction = tuple(t.contiguous() for t in (dw, dy, dlam, ds, dzl, dzu))
        return _keep_err(state, kernels.advance_state(
            state, direction, ok, info['err_d'], torch.maximum(info['err_d'], err_p), lbw, ubw,
            tau, kappa_mu, mu_min))

    return step


def make_batched_solver(ocp, lb, ub, n_iter: int = 100, mesh=None, axis_name: str = 'scenario',
                        batch_p: bool = False, tol: float = 0.0, kkt: str = 'auto',
                        **ip_kwargs):
    """The interior-point solve of a batch of lanes (batch.py:544-609 on one
    device): returns solve(state, P) -> state, stepping make_ip_step(ocp,
    kkt=kkt, **ip_kwargs)'s fused step where the state's tensors lie (the
    card unless the caller passes CPU tensors).

    ``batch_p=True``: every leaf of P carries the lane axis (parameter
    sweeps); False: one P, shared by every lane. ``tol > 0`` turns the
    ``n_iter`` fixed steps into a loop gated by convergence, as the JAX
    package's vmapped while_loop: it runs until every lane's err is <= tol
    or n_iter steps, and a lane whose err has reached tol stops changing
    (its state is kept bit for bit while the others step). ``solve.n_iter``
    holds the steps the last call took. ``mesh`` (data parallelism over
    several devices) is not ported."""
    if mesh is not None:
        raise NotImplementedError('make_batched_solver: mesh= (lanes sharded over several '
                                  'devices) is not ported')
    lbw_np, ubw_np, free_np, _ = InteriorPointSolver.split_pins(lb, ub)
    step = make_ip_step(ocp, kkt=kkt, **ip_kwargs)
    bounds = {}

    def on(device):
        if device not in bounds:
            bounds[device] = tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
                                   for a in (lbw_np, ubw_np, free_np))
        return bounds[device]

    def solve(state, P):
        w = state['w']
        B, device = w.shape[0], w.device
        lbw, ubw, free = on(device)
        P = to_tensors(P, torch.float64, device)
        if not batch_p:
            P = tree_map(lambda x: x.expand(B, *x.shape), P)
        state = dict(state)
        it = 0
        if tol > 0.:
            if 'err' not in state:
                state['err'] = torch.full((B,), torch.inf, dtype=w.dtype, device=device)
            while it < n_iter:
                active = state['err'] > tol
                if not bool(active.any()):
                    break
                new = step(state, P, lbw, ubw, free)
                state = {k: torch.where(active.view(-1, *([1] * (v.dim() - 1))), new[k], v)
                         for k, v in state.items()}
                it += 1
        else:
            for it in range(1, n_iter + 1):
                state = step(state, P, lbw, ubw, free)
        solve.n_iter = it
        return state

    solve.n_iter = 0
    return solve


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
