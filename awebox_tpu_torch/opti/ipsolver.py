"""Primal-dual interior-point NLP solver.

Counterpart of ``awebox_tpu/opti/ipsolver.py``: the host-driven robust
solver behind the homotopy (``opti/homotopy.py::solve_homotopy``) of

    min  f(w, p)
    s.t. c_E(w, p)  = 0
         c_I(w, p) <= 0
         lbw <= w <= ubw

with the Fiacco-McCormick barrier in primal-dual form, the delta_w ladders,
the soft watchdog, fraction-to-boundary steps and the filter line search.

The iterate lives in f64 tensors on the solver's device (the card unless
the caller passes ``device='cpu'``); the loop's decisions are taken on the
host from scalars read back each iteration, as in the JAX package. The
dense direction (``kkt_solve``) runs through hand-written kernels on the
card: the inertia test chol(M) through K10 (``kernels.chol_factor_batched``,
only its ``ok`` is used), the LU factor of the augmented system through K12
(``kernels.lu_factor_f64``) and both of its solves through K13
(``kernels.lu_solve_f64``). The derivatives are dense reverse-mode
``torch.func`` transforms of f, c_E and c_I; a ``block_kkt`` pair (ocp/blockkkt.py, K8 and
K9) replaces them and the direction on structured collocation problems.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad, grad_and_value, jacrev, vjp

from ..parallel import kernels
from ..tree import to_tensors, tree_map
from ..utils.logging import awelogger


@dataclass
class IPOptions:
    tol: float = 1e-8
    mu_init: float = 1e-1
    mu_target: float = 0.0       # relaxed barrier target (hippo)
    mu_linear_decrease: float = 0.2
    mu_superlinear_power: float = 1.5
    kappa_eps: float = 10.0      # barrier-subproblem tolerance factor
    tau_min: float = 0.99
    max_iter: int = 3000
    delta_w_init: float = 1e-6
    delta_w_max: float = 1e10
    # step-norm guard: |dw|_inf > dw_cap * max(1, |w|_inf) counts as a
    # factorization failure and climbs the regularization ladder (a
    # chol-successful factor of a near-singular KKT matrix returns a finite
    # but absurd direction)
    dw_cap: float = 300.0
    delta_c: float = 1e-7
    armijo_eta: float = 1e-4
    max_ls: int = 25
    bound_relax: float = 1e-8
    bound_push: float = 1e-2     # kappa_1: minimal distance of w0 from bounds
    slack_min: float = 1e-8
    verbose: bool = False


@dataclass
class IPResult:
    w: torch.Tensor
    y: torch.Tensor              # equality multipliers
    lam: torch.Tensor            # inequality multipliers (>= 0)
    s: torch.Tensor              # inequality slacks
    zl: torch.Tensor
    zu: torch.Tensor
    mu: float
    kkt_error: float
    iterations: int
    success: bool
    status: str = ''


def solver_device(device, who: str) -> torch.device:
    """``device`` as a torch.device, the card for None; raises naming ``who``
    where a CUDA device is asked for and no card is available."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{who}: device {str(dev)!r} asked for, but no CUDA card is '
                           "available (pass device='cpu' for the CPU)")
    return dev


def _numpy(x):
    """A bound vector (numpy or tensor) as numpy."""
    return x.cpu().numpy() if torch.is_tensor(x) else x


def _max_abs(x):
    """max |x|, 0 for an empty x (jnp.max's initial=0.)."""
    return torch.abs(x).max() if x.numel() else x.new_zeros(())


class InteriorPointSolver:
    """One solver instance per (f, eq, ineq) function triple; the parameter
    tree ``p`` flows through every call, so homotopy steps (which only change
    p and the bounds) reuse the instance."""

    def __init__(self, f, eq, ineq, n, n_eq, n_ineq, options: IPOptions = None,
                 derivs_fn=None, block_kkt=None, device=None):
        self.f = f
        self.eq = eq
        self.ineq = ineq
        self.n = n
        self.n_eq = n_eq
        self.n_ineq = n_ineq
        self.opts = options or IPOptions()
        self.device = solver_device(device, 'InteriorPointSolver')
        self._build()
        if derivs_fn is not None:
            # structure-exploiting override: (w, y, lam, p) ->
            # (fval, gradf, cE, cI, JE, JI, H)
            self._derivs = derivs_fn
        # block-structured KKT path (ocp/blockkkt.make_block_kkt): a
        # (derivs_fn, kkt_solve) pair over a lane axis; the solve loop then
        # never materializes dense jacobians/hessians and the direction comes
        # from the two-level factorization with its own regularization ladder
        self._block = block_kkt
        if block_kkt is not None:
            self._block_derivs, self._block_solve = block_kkt

    # ------------------------------------------------------------------
    def _build(self):
        f, eq, ineq = self.f, self.eq, self.ineq
        n, n_eq, n_ineq = self.n, self.n_eq, self.n_ineq

        def lagrangian(w, y, lam, p):
            L = f(w, p)
            if n_eq:
                L = L + y @ eq(w, p)
            if n_ineq:
                L = L + lam @ ineq(w, p)
            return L

        def with_value(fn):
            def both(w, p):
                c = fn(w, p)
                return c, c
            return both

        def derivs(w, y, lam, p):
            # reverse mode throughout (the JAX package takes jacfwd and
            # hessian = jacfwd(jacrev)): the same derivatives to rounding
            # (1.5e-16 relative at the bench anchor) from 56k aten operations
            # instead of 105k, 1.03 s instead of 1.61 s of host dispatch an
            # iteration on an H100 80GB HBM3 at 700 W (probes/host_solver.py);
            # c_E and c_I are the values of their Jacobians' forward passes
            gradf, fval = grad_and_value(f)(w, p)
            JE, cE = jacrev(with_value(eq), has_aux=True)(w, p) if n_eq \
                else (w.new_zeros(0, n), w.new_zeros(0))
            JI, cI = jacrev(with_value(ineq), has_aux=True)(w, p) if n_ineq \
                else (w.new_zeros(0, n), w.new_zeros(0))
            H = jacrev(jacrev(lagrangian))(w, y, lam, p)
            return fval, gradf, cE, cI, JE, JI, H

        self._derivs = derivs

        def augmented(gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu,
                      lbw, ubw, free, mu, delta_w, delta_c, delta_ce):
            """The direction's two systems (ipsolver.py:148-192): the
            condensed M = W + A^T D_test^-1 A of the inertia test, and the
            augmented K = [W, A^T; A, -D] with its right-hand side."""
            # barrier diagonal
            dl = torch.clamp(w - lbw, min=1e-20)
            du = torch.clamp(ubw - w, min=1e-20)
            sigma = zl / dl + zu / du

            eye = torch.eye(n, dtype=w.dtype, device=w.device)
            W = H + torch.diag(sigma) + delta_w * eye
            # exact elimination of pinned variables: identity rows/cols on the
            # pinned block, zeroed Jacobian columns, zeroed rhs => dw_pin = 0
            W = W * (free[:, None] * free[None, :]) + torch.diag(1. - free)

            A = torch.cat([JE, JI], dim=0) * free[None, :]
            lam_safe = torch.clamp(lam, min=1e-12)
            # D for the inertia test must be > 0 on all rows (Forsgren-Gill);
            # the solve itself keeps equality rows exact
            ones_eq = w.new_ones(n_eq)
            D_test = torch.cat([delta_c * ones_eq, s / lam_safe + delta_c])
            D = torch.cat([delta_ce * ones_eq, s / lam_safe + delta_c])
            r2 = torch.cat([cE, cI + mu / lam_safe]) if n_ineq else cE

            # primal-dual dual-infeasibility rhs
            r1 = -(gradf + A.T @ torch.cat([y, lam]) - mu / dl + mu / du) * free

            # inertia certificate: with D > 0, [W, A^T; A, -D] has the correct
            # inertia (n, m, 0) iff M = W + A^T D^-1 A is positive definite
            As = A * (1.0 / torch.sqrt(D_test))[:, None]
            M = W + As.T @ As
            K = torch.cat([torch.cat([W, A.T], dim=1),
                           torch.cat([A, -torch.diag(D)], dim=1)], dim=0)
            return dict(M=M, K=K, rhs=torch.cat([r1, -r2]), A=A, dl=dl, du=du, sigma=sigma)

        self._augmented = augmented

        def kkt_solve(gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu,
                      lbw, ubw, free, mu, delta_w, delta_c, delta_ce):
            sys_ = augmented(gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu,
                             lbw, ubw, free, mu, delta_w, delta_c, delta_ce)
            M, K, rhs, dl, du = (sys_[k] for k in ('M', 'K', 'rhs', 'dl', 'du'))
            _, ok = kernels.chol_factor_batched(M[None].contiguous())
            ok = ok[0]
            diag = (_max_abs(M), torch.isfinite(M).all(), _max_abs(sys_['A']),
                    sys_['sigma'].max() if n else w.new_zeros(()))

            # direction from the full augmented system, with one step of
            # iterative refinement
            lu, piv = kernels.lu_factor_f64(K[None].contiguous())
            sol = kernels.lu_solve_f64(lu, piv, rhs[None].contiguous())[0]
            resid = rhs - K @ sol
            sol = sol + kernels.lu_solve_f64(lu, piv, resid[None].contiguous())[0]
            dw = sol[:n] * free
            dnu = sol[n:]

            dy = dnu[:n_eq]
            dlam = dnu[n_eq:]
            ds = -(cI + s) - JI @ dw if n_ineq else w.new_zeros(0)
            dzl = mu / dl - zl - zl * dw / dl
            dzu = mu / du - zu + zu * dw / du
            return dw, dy, dlam, ds, dzl, dzu, ok, diag

        self._kkt_solve = kkt_solve

        def barrier_phi_theta(w, s, p, mu, lbw, ubw, vals=None):
            """(barrier objective phi, constraint violation theta); ``vals`` =
            (f, c_E, c_I) at w where they are at hand."""
            fw, cE, cI = vals if vals is not None else (f(w, p), None, None)
            phi = fw
            dl = w - lbw
            du = ubw - w
            phi = phi - mu * torch.where(torch.isfinite(lbw),
                                         torch.log(torch.clamp(dl, min=1e-300)), 0.).sum()
            phi = phi - mu * torch.where(torch.isfinite(ubw),
                                         torch.log(torch.clamp(du, min=1e-300)), 0.).sum()
            theta = w.new_zeros(())
            if n_ineq:
                phi = phi - mu * torch.log(torch.clamp(s, min=1e-300)).sum()
                theta = theta + torch.abs((ineq(w, p) if cI is None else cI) + s).sum()
            if n_eq:
                theta = theta + torch.abs(eq(w, p) if cE is None else cE).sum()
            feasible = (w > lbw).all() & (w < ubw).all()
            if n_ineq:
                feasible = feasible & (s > 0).all()
            phi = torch.where(feasible, phi, torch.inf)
            return phi, theta

        self._barrier_phi_theta = barrier_phi_theta

        def kkt_parts(w, s, y, lam, zl, zu, p, lbw, ubw, free, dense=None):
            """What kkt_error needs at one iterate, before the barrier level
            enters: the scaled dual and primal errors and the complementarity
            products (bound ones masked to finite bounds). ``dense`` = (gradf,
            cE, cI, JE, JI) at w, where the dense derivatives are at hand:
            the Jacobians' transposed products then take the place of the
            vector-Jacobian products (the same sums in another order)."""
            if dense is None:
                gradf = grad(f)(w, p)
                cE = eq(w, p) if n_eq else None
                cI = ineq(w, p) if n_ineq else None
                r_w = gradf - zl + zu
                if n_eq:
                    r_w = r_w + vjp(lambda ww: eq(ww, p), w)[1](y)[0]
                if n_ineq:
                    r_w = r_w + vjp(lambda ww: ineq(ww, p), w)[1](lam)[0]
            else:
                gradf, cE, cI, JE, JI = dense
                r_w = gradf - zl + zu
                if n_eq:
                    r_w = r_w + JE.T @ y
                if n_ineq:
                    r_w = r_w + JI.T @ lam

            # IPOPT-style scaling of the dual residual
            s_max = 100.
            mults = torch.abs(y).sum() + torch.abs(lam).sum() \
                + torch.abs(zl).sum() + torch.abs(zu).sum()
            n_mults = n_eq + n_ineq + 2 * n
            s_d = torch.clamp(mults / max(n_mults, 1), min=s_max) / s_max

            err_d = _max_abs(r_w * free) / s_d
            err_p = w.new_zeros(())
            if n_eq:
                err_p = torch.maximum(err_p, _max_abs(cE))
            if n_ineq:
                err_p = torch.maximum(err_p, _max_abs(cI + s))
            return dict(err_d=err_d, err_p=err_p, s_d=s_d, fin_l=torch.isfinite(lbw),
                        fin_u=torch.isfinite(ubw), zl_dl=zl * (w - lbw),
                        zu_du=zu * (ubw - w), lam_s=lam * s if n_ineq else None)

        def kkt_error_of(parts, mu):
            """The KKT error of kkt_parts' iterate at the barrier level mu."""
            comp_l = torch.where(parts['fin_l'], parts['zl_dl'] - mu, 0.0)
            comp_u = torch.where(parts['fin_u'], parts['zu_du'] - mu, 0.0)
            err_c = torch.maximum(_max_abs(comp_l), _max_abs(comp_u))
            if n_ineq:
                err_c = torch.maximum(err_c, _max_abs(parts['lam_s'] - mu))
            err_c = err_c / parts['s_d']
            return torch.maximum(torch.maximum(parts['err_d'], parts['err_p']), err_c)

        def kkt_error(w, s, y, lam, zl, zu, p, mu, lbw, ubw, free):
            return kkt_error_of(kkt_parts(w, s, y, lam, zl, zu, p, lbw, ubw, free), mu)

        self._kkt_parts = kkt_parts
        self._kkt_error_of = kkt_error_of
        self._kkt_error = kkt_error

    # ------------------------------------------------------------------
    @staticmethod
    def split_pins(lbw, ubw):
        """Detect fixed variables (lb == ub): they are eliminated exactly by
        masking while keeping problem shapes static across homotopy steps.
        Returns (lbw_free, ubw_free, free_mask, center), numpy."""
        lbw = np.asarray(lbw, dtype=float)
        ubw = np.asarray(ubw, dtype=float)
        with np.errstate(invalid='ignore'):
            center = 0.5 * (lbw + ubw)
            eps_pin = 1e-9 * (1. + np.abs(np.where(np.isfinite(center), center, 0.)))
            pinned = (ubw - lbw) < 2. * eps_pin
        lbw_free = np.where(pinned, -np.inf, lbw)
        ubw_free = np.where(pinned, np.inf, ubw)
        return lbw_free, ubw_free, (1. - pinned.astype(float)), \
            np.where(pinned, center, 0.)

    def _t(self, x):
        """x (numpy, tensor or sequence) as an f64 tensor on the device."""
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float64).to(self.device)

    def _p(self, p):
        """The parameter tree p (numpy or tensor leaves, or None) on the device."""
        return None if p is None else to_tensors(p, torch.float64, self.device)

    def init_state(self, w0, p, lbw, ubw, y0=None, lam0=None, mu=None):
        o = self.opts
        p = self._p(p)
        lbw, ubw, free, center = self.split_pins(_numpy(lbw), _numpy(ubw))
        free, center = self._t(free), self._t(center)
        w0 = torch.where(free > 0.5, self._t(w0), center)
        lbw = self._t(lbw)
        ubw = self._t(ubw)
        # push strictly inside bounds
        span = torch.minimum(o.bound_push * torch.clamp(torch.abs(w0), min=1.),
                             0.5 * (ubw - lbw))
        w = torch.minimum(torch.maximum(w0, lbw + span), ubw - span)
        w = torch.where(torch.isfinite(w), w, 0.0)

        mu = float(o.mu_init if mu is None else mu)
        cI = self.ineq(w, p) if self.n_ineq else w.new_zeros(0)
        # |cI| (not -cI): rows violated at the start need slacks at the
        # violation scale, or the fraction-to-boundary rule jams on them
        s = torch.clamp(torch.abs(cI), min=o.slack_min * 10)
        s = torch.clamp(s, min=mu / 100.)
        y = w.new_zeros(self.n_eq) if y0 is None else self._t(y0)
        lam = torch.clamp(mu / s, min=1e-8) if lam0 is None \
            else torch.clamp(self._t(lam0), min=1e-8)
        dl = torch.clamp(w - lbw, min=1e-8)
        du = torch.clamp(ubw - w, min=1e-8)
        zl = torch.where(torch.isfinite(lbw), mu / dl, 0.0)
        zu = torch.where(torch.isfinite(ubw), mu / du, 0.0)
        return dict(w=w, s=s, y=y, lam=lam, zl=zl, zu=zu, mu=mu)

    # ------------------------------------------------------------------
    def _direction_block(self, blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu,
                         delta_w, delta_c, delta_ce):
        """One attempt of the block path: ocp/blockkkt.py's kkt_solve over one
        lane. Its info['delta_used'] is a (1,) tensor of the lane axis where
        the JAX package's single-lane solve returns a scalar; the lane is
        taken here."""
        lane = lambda t: t[None]
        out = self._block_solve(blocks, lane(w), lane(s), lane(y), lane(lam), lane(zl),
                                lane(zu), lbw, ubw, free, w.new_full((1,), mu),
                                delta_w, delta_c, delta_ce)
        dw, dy, dlam, ds, dzl, dzu, ok, info = out
        return (dw[0], dy[0], dlam[0], ds[0], dzl[0], dzu[0], ok[0],
                info['delta_used'][0])

    def solve(self, w0, p, lbw, ubw, state=None, tol=None, mu_init=None,
              mu_target=None, max_iter=None, verbose=None, callback=None,
              callback_step=1, **kw) -> IPResult:
        """callback(it=..., w=..., mu=..., err=..., f=..., alpha=...,
        delta_w=...) is invoked every `callback_step` iterations, the
        per-iteration recording hook."""
        o = copy.copy(self.opts)
        p = self._p(p)
        lbw, ubw, free_np, center_np = self.split_pins(_numpy(lbw), _numpy(ubw))
        relax = o.bound_relax * np.maximum(1., np.abs(np.where(np.isfinite(lbw), lbw, 0.)))
        lbw = np.where((free_np > 0.5) & np.isfinite(lbw), lbw - relax, lbw)
        relax_u = o.bound_relax * np.maximum(1., np.abs(np.where(np.isfinite(ubw), ubw, 0.)))
        ubw = np.where((free_np > 0.5) & np.isfinite(ubw), ubw + relax_u, ubw)
        free = self._t(free_np)
        pin_center = self._t(center_np)
        if tol is not None:
            o.tol = tol
        if mu_init is not None:
            o.mu_init = mu_init
        if mu_target is not None:
            o.mu_target = mu_target
        if max_iter is not None:
            o.max_iter = max_iter
        if verbose is not None:
            o.verbose = verbose
        lbw = self._t(lbw)
        ubw = self._t(ubw)
        if state is None:
            kw.setdefault('mu', o.mu_init)
            state = self.init_state(w0, p, lbw, ubw, **kw)
        w, s, y, lam = (self._t(state[k]) for k in ('w', 's', 'y', 'lam'))
        zl, zu = self._t(state['zl']), self._t(state['zu'])
        mu = float(state['mu'])
        w = torch.where(free > 0.5, w, pin_center)
        if self._block is not None:
            p_lane = tree_map(lambda x: x[None], p)

        mu_min = max(o.mu_target, o.tol / 10.)
        delta_w_last = 0.0
        filter_list = []
        theta_init = None
        best_err = np.inf
        best_state = None
        bad_streak = 0
        acceptable_streak = 0
        status = 'max_iter'
        success = False
        it = 0

        for it in range(1, o.max_iter + 1):
            if self._block is not None:
                blocks = self._block_derivs(w[None], y[None], lam[None], p_lane)
                fval, gradf = blocks['fval'][0], blocks['gradf'][0]
                cE, cI = blocks['cE'][0], blocks['cI'][0]
            else:
                fval, gradf, cE, cI, JE, JI, H = self._derivs(w, y, lam, p)
            if not np.isfinite(float(fval)):
                status = 'nan_objective'
                break
            if self._block is not None:
                if not bool(torch.isfinite(gradf).all()):
                    status = 'nan_derivatives'
                    break
            elif not bool(torch.isfinite(H).all() & torch.isfinite(JE).all()
                          & torch.isfinite(JI).all() & torch.isfinite(gradf).all()):
                status = 'nan_derivatives'
                break

            # convergence at the target barrier level (one evaluation of the
            # residuals serves both barrier levels of this iterate)
            parts = self._kkt_parts(w, s, y, lam, zl, zu, p, lbw, ubw, free,
                                    None if self._block is not None else (gradf, cE, cI, JE, JI))
            err_target = float(self._kkt_error_of(parts, mu_min if o.mu_target > 0 else 0.))
            if err_target <= o.tol:
                success = True
                status = 'solved'
                break
            if err_target <= max(1e2 * o.tol, 1e-6) and mu <= mu_min * 1.01:
                acceptable_streak += 1
                if acceptable_streak >= 15:
                    success = True
                    status = 'solved_acceptable'
                    break
            else:
                acceptable_streak = 0

            # barrier subproblem convergence -> decrease mu
            err_mu = float(self._kkt_error_of(parts, mu))
            if err_mu <= o.kappa_eps * mu and mu > mu_min + 1e-16:
                mu = max(mu_min, min(o.mu_linear_decrease * mu,
                                     mu ** o.mu_superlinear_power))
                filter_list = []
                best_err = np.inf  # err is measured per-barrier-level

            # soft watchdog: restore the best iterate of this barrier level if
            # the iteration has catastrophically diverged
            if err_mu < best_err:
                best_err = err_mu
                best_state = (w, s, y, lam, zl, zu)
                bad_streak = 0
            elif err_mu > max(100. * best_err, best_err + 1e2):
                bad_streak += 1
                if bad_streak >= 8 and best_state is not None:
                    w, s, y, lam, zl, zu = best_state
                    y = 0.5 * y
                    lam = torch.clamp(0.5 * lam, min=1e-8)
                    delta_w_last = max(delta_w_last, 1e-2)
                    filter_list = []
                    bad_streak = 0
                    if o.verbose:
                        awelogger.info(f'  [watchdog] restored best iterate '
                                       f'(err {best_err:.2e}), damped duals')
                    continue

            # KKT solve with primal regularization ladder
            delta_w = 0.0
            ladder_hist = []
            # iterate-relative step cap (see IPOptions.dw_cap)
            cap = o.dw_cap * max(1.0, float(_max_abs(w)))
            if self._block is not None:
                # the block path self-escalates; start from the decayed last
                # delta and let its internal ladder do the work. The retry
                # loop additionally enforces the step-norm guard.
                delta_w = max(delta_w_last / 3., 0.0)
                delta_ce = o.delta_c * max(mu, 1e-6) ** 0.25
                for trial in range(8):
                    dw, dy, dlam, ds, dzl, dzu, ok_t, dused = self._direction_block(
                        blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu,
                        delta_w, o.delta_c, delta_ce)
                    ok, dir_finite, dw_norm, delta_w = self._direction_check(
                        ok_t, dw, dy, dlam, dused)
                    if ok and dir_finite and dw_norm <= cap:
                        break
                    delta_w = min(max(delta_w * 8., o.delta_w_init * 100.),
                                  o.delta_w_max)
                    if o.verbose and dir_finite and dw_norm > cap:
                        awelogger.info(f'  [step cap] |dw|={dw_norm:.1e} > '
                                       f'{cap:g}, delta_w -> {delta_w:.1e}')
                if not (ok and dir_finite and dw_norm <= cap):
                    # over-cap exhaustion is a factorization failure too
                    status = 'regularization_failed'
                    if o.verbose:
                        awelogger.info(f'  [block ladder exhausted] ok={ok} '
                                       f'|dw|={dw_norm:.1e} delta={delta_w:.1e}')
                    break
            else:
                ladder_failed = False
                for trial in range(12):
                    delta_ce = 0.0 if trial == 0 else o.delta_c * max(mu, 1e-6) ** 0.25
                    dw, dy, dlam, ds, dzl, dzu, ok_t, kdiag = self._kkt_solve(
                        gradf, cE, cI, JE, JI, H, w, s, y, lam, zl, zu,
                        lbw, ubw, free, mu, delta_w, o.delta_c, delta_ce)
                    ok, dir_finite, dw_norm, _ = self._direction_check(ok_t, dw, dy, dlam)
                    ladder_hist.append((delta_w, ok, dir_finite))
                    if ok and dir_finite and dw_norm <= cap:
                        break
                    if ok and dir_finite and o.verbose:
                        awelogger.info(f'  [step cap] |dw|={dw_norm:.1e} > '
                                       f'{cap:g}, raising delta_w')
                    if delta_w == 0.0:
                        delta_w = min(max(o.delta_w_init, delta_w_last / 3.), 1e4)
                    else:
                        delta_w *= 100. if delta_w_last == 0 else 8.
                    if delta_w > o.delta_w_max:
                        break
                else:
                    ladder_failed = True
                if ladder_failed:
                    status = 'regularization_failed'
                    if o.verbose:
                        awelogger.info(f'  [ladder exhausted] ok={ok} '
                                       f'|dw|={float(_max_abs(dw)):.2e} '
                                       f'|H|={float(_max_abs(H)):.2e} '
                                       f'|y|={float(_max_abs(y)):.2e} '
                                       f'|lam|={float(lam.max()) if lam.numel() else 0.:.2e} '
                                       f'min_s={float(s.min()) if s.numel() else 1.:.2e}')
                    break
                if delta_w > o.delta_w_max:
                    status = 'regularization_failed'
                    if o.verbose:
                        awelogger.info(f'  [ladder overflow] ok={ok} '
                                       f'|H|={float(_max_abs(H)):.2e} '
                                       f'|y|={float(_max_abs(y)):.2e} '
                                       f'|M|={float(kdiag[0]):.2e} Mfin={bool(kdiag[1])} '
                                       f'|A|={float(kdiag[2]):.2e} sig={float(kdiag[3]):.2e}')
                        awelogger.info('  ladder history: %s',
                                       [(f'{d:.1e}', o2, f2) for (d, o2, f2) in ladder_hist])
                    break
            if delta_w > 0:
                delta_w_last = min(delta_w, o.delta_w_max)
            else:
                delta_w_last = delta_w_last / 3.  # decay when no damping needed

            # fraction-to-boundary
            tau = max(o.tau_min, 1. - mu)
            dl = w - lbw
            du = ubw - w
            alpha_max, a_l, a_u, a_s, a_zl, a_zu, a_lam = (float(v) for v in torch.stack([
                w.new_ones(()), _ftb(dl, dw, tau), _ftb(du, -dw, tau),
                _ftb(s, ds, tau) if self.n_ineq else w.new_ones(()),
                _ftb(torch.clamp(zl, min=1e-300), dzl, tau),
                _ftb(torch.clamp(zu, min=1e-300), dzu, tau),
                _ftb(lam, dlam, tau) if self.n_ineq else w.new_ones(())]).tolist())
            alpha_max = min(alpha_max, a_l, a_u)
            if self.n_ineq:
                alpha_max = min(alpha_max, a_s)
            alpha_z = 1.0
            alpha_z = min(alpha_z, a_zl, a_zu)
            if self.n_ineq:
                alpha_z = min(alpha_z, a_lam)

            # filter line search (Waechter-Biegler style, lean variant); at
            # the iterate the dense derivatives' values serve
            vals = None if self._block is not None else (fval, cE, cI)
            phi_c, theta_c = (float(v) for v in torch.stack(
                self._barrier_phi_theta(w, s, p, mu, lbw, ubw, vals)).tolist())
            if theta_init is None:
                theta_init = max(theta_c, 1e-8)
            theta_min = 1e-4 * max(1., theta_init)
            # Waechter-Biegler theta_max: never accept a trial point whose
            # constraint violation exceeds a multiple of the initial one
            theta_max = 1e2 * max(1., theta_init)

            # barrier directional derivative
            dd = gradf @ dw \
                - mu * torch.where(torch.isfinite(lbw), dw / torch.clamp(dl, min=1e-300), 0.).sum() \
                + mu * torch.where(torch.isfinite(ubw), dw / torch.clamp(du, min=1e-300), 0.).sum()
            ddphi = float(dd)
            if self.n_ineq:
                ddphi += float(-mu * (ds / torch.clamp(s, min=1e-300)).sum())

            gamma_theta, gamma_phi = 1e-5, 1e-8
            alpha = alpha_max
            accepted = False
            for _ in range(o.max_ls):
                w_new = w + alpha * dw
                s_new = s + alpha * ds if self.n_ineq else s
                phi_a, theta_a = (float(v) for v in torch.stack(
                    self._barrier_phi_theta(w_new, s_new, p, mu, lbw, ubw)).tolist())
                if np.isfinite(phi_a) and theta_a <= theta_max:
                    in_filter = any(theta_a >= th_f and phi_a >= ph_f
                                    for (th_f, ph_f) in filter_list)
                    if not in_filter:
                        if theta_c <= theta_min and ddphi < 0:
                            # f-type: Armijo on the barrier objective
                            if phi_a <= phi_c + o.armijo_eta * alpha * ddphi:
                                accepted = True
                                break
                        if (theta_a <= (1. - gamma_theta) * theta_c
                                or phi_a <= phi_c - gamma_phi * theta_c):
                            # h-type: progress on feasibility or objective
                            if not (theta_c <= theta_min and ddphi < 0):
                                accepted = True
                                filter_list.append((
                                    (1. - gamma_theta) * theta_c,
                                    phi_c - gamma_phi * theta_c))
                                if len(filter_list) > 60:
                                    filter_list.pop(0)
                                break
                alpha *= 0.5
            if not accepted:
                # watchdog: take a tiny step to escape, with more regularization
                # next time (growth capped)
                alpha = min(1e-4, alpha_max)
                delta_w_last = min(max(delta_w_last, o.delta_w_init) * 10., 1e5)

            w = w + alpha * dw
            dy_step = torch.clamp(alpha * dy, -1e4, 1e4)
            y = y + dy_step
            y_norm = float(_max_abs(y))
            if y_norm > 1e6:
                y = y * (1e6 / y_norm)
            lam = torch.clamp(lam + alpha_z * dlam, min=1e-16) if self.n_ineq else lam
            if self.n_ineq:
                s = torch.clamp(s + alpha * ds, min=1e-16)
            zl = zl + alpha_z * dzl
            zu = zu + alpha_z * dzu
            # keep bound duals in IPOPT's safeguard corridor
            dl = torch.clamp(w - lbw, min=1e-20)
            du = torch.clamp(ubw - w, min=1e-20)
            kappa_sigma = 1e10
            zl = torch.minimum(torch.maximum(zl, mu / (kappa_sigma * dl)), kappa_sigma * mu / dl)
            zu = torch.minimum(torch.maximum(zu, mu / (kappa_sigma * du)), kappa_sigma * mu / du)
            zl = torch.where(torch.isfinite(lbw), zl, 0.)
            zu = torch.where(torch.isfinite(ubw), zu, 0.)

            if callback is not None and it % callback_step == 0:
                callback(it=it, w=w.cpu().numpy(), mu=float(mu),
                         err=float(err_mu), f=float(fval),
                         alpha=float(alpha), delta_w=float(delta_w))

            if o.verbose and (it % 10 == 0 or it <= 30):
                awelogger.info(f'  ip iter {it:4d}: mu={mu:9.2e} err={err_mu:9.2e} '
                               f'alpha={alpha:8.1e} dw={delta_w:8.1e} f={float(fval):13.6e}')

        # return the best iterate of the last barrier level if the final
        # iterate is worse (watchdog cycling can end on a bad step)
        if best_state is not None:
            err_now = float(self._kkt_error(w, s, y, lam, zl, zu, p, mu, lbw, ubw, free))
            if best_err < err_now:
                w, s, y, lam, zl, zu = best_state
        err_final = float(self._kkt_error(w, s, y, lam, zl, zu, p,
                                          mu_min if o.mu_target > 0 else 0., lbw, ubw, free))
        return IPResult(w=w, y=y, lam=lam, s=s, zl=zl, zu=zu, mu=mu,
                        kkt_error=err_final, iterations=it,
                        success=success or err_final <= o.tol * 100,
                        status=status)

    @staticmethod
    def _direction_check(ok, dw, dy, dlam, delta=None):
        """(ok, dir_finite, |dw|_inf or inf, delta) of one ladder attempt,
        read back in one transfer."""
        finite = torch.isfinite(dw).all() & torch.isfinite(dy).all() & torch.isfinite(dlam).all()
        vals = torch.stack([ok.to(dw.dtype), finite.to(dw.dtype), _max_abs(dw),
                            dw.new_zeros(()) if delta is None else delta.to(dw.dtype)])
        ok_v, fin_v, norm, dlt = vals.tolist()
        dir_finite = bool(fin_v)
        return bool(ok_v), dir_finite, norm if dir_finite else np.inf, dlt


def _ftb(val, dval, tau):
    """Largest step in (0, 1] keeping val + a dval >= (1 - tau) val, as a
    0-d tensor (jnp.min(ratios, initial=1.0))."""
    neg = dval < 0
    ratios = torch.where(neg, -tau * val / torch.where(neg, dval, -1.), torch.inf)
    return torch.cat([ratios, val.new_ones(1)]).min()
