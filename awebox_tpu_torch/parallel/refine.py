"""Batched wind-sweep refinement: B scenario lanes continue from one solved
primal-dual state to their own optima.

Counterpart of the main loop of ``bench.py`` (scenario set-up :223-291, one
iteration :384-395, convergence accounting :603-613). Each iteration has
four pieces:

    vals       f64 objective, gradient, equalities, inequalities
    jac        f32 per-node constraint Jacobians scattered into dense JE/JI
    hess       f32 per-node exact Lagrangian Hessians scattered into dense H
    direction  the f32-factored augmented-KKT direction with f64 refinement
               (Ruiz-equilibrated Householder QR by default, as bench.py
               runs it, or Jacobi-scaled LU), then the f64 step and barrier
               update

The state and the values stay f64. The Jacobians and the Hessian enter the
direction in f32, as in the JAX package, but are evaluated in f64 and then
rounded: PyTorch's forward-mode AD materializes the tangent of a Python
scalar as a 0-d f64 tensor, so a 0-d f32 intermediate (a dot product, a
segment length) combined with a Python float gets an f64 tangent, and the
nested jvp/jacfwd of the f32 model then fails with a dtype mismatch. On the
card these per-node evaluations are bound by launches, not by f64 rate. A
lane latches once its KKT error reaches ``tol`` at any
iteration, and counts as converged when it latched and the f64 dynamics
residual of its final iterate is within ``verify_tol``.
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..ocp.structured import make_structured_derivs
from ..opti.homotopy import build_p_fix, final_bounds, final_cost_values
from ..opti.initialization import build_initial_guess, build_reference
from ..opti.ipsolver import InteriorPointSolver
from ..tree import tree_map
from .batch import make_ip_step, p_from_numpy, stack_p, state_from_numpy
from .kernels import STATE_KEYS


def wind_sweep_problem(trial, anchor, B, spread=0.05, u_ref=10.0,
                       device='cuda', mu0=1e-5):
    """Lanes with u_ref spread +-spread around u_ref, all starting from the
    solved state ``anchor`` (a mapping with w, s, y, lam, zl, zu), under the
    final-step bounds relaxed by 1e-8 as the host solver left them.

    Returns (state, P64, lbw, ubw, free, u_refs), tensors on ``device``: the
    card unless the caller passes ``device='cpu'``. Without a card, a CUDA
    device raises instead of leaving the lanes on the CPU."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'wind_sweep_problem: device {device!r} asked for, but no '
                           "CUDA card is available (pass device='cpu' for the CPU)")
    ocp = trial.ocp
    V0 = build_initial_guess(ocp)
    base_P = build_p_fix(ocp, build_reference(ocp, V0))
    lbf, ubf = sweep_bounds(trial, V0)
    fc = final_cost_values(ocp)

    u_refs = u_ref * (1.0 + spread * np.linspace(-1., 1., B))
    p_list = []
    for u in u_refs:
        theta0 = copy.deepcopy(tree_map(np.asarray, base_P['theta0']))
        theta0['wind']['u_ref'] = np.asarray(float(u))
        p_list.append({'cost': {k: np.asarray(fc[k]) for k in fc},
                       'ref': base_P['ref'], 'weights': base_P['weights'],
                       'theta0': theta0})
    P64 = p_from_numpy(stack_p(p_list), device)

    state_np = {k: np.stack([np.asarray(anchor[k])] * B) for k in STATE_KEYS}
    state_np['mu'] = np.full(B, mu0)
    state_np['err'] = np.full(B, np.inf)
    state = state_from_numpy(state_np, device)

    lbw, ubw, free, _ = InteriorPointSolver.split_pins(lbf, ubf)
    as64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return state, P64, as64(lbw), as64(ubw), as64(free), u_refs


def sweep_bounds(trial, V0=None, relax=1e-8):
    """The final-step bounds (lbf, ubf), numpy, with every finite bound that
    does not pin its variable relaxed by ``relax`` (relative, at least
    absolute), as the host solver left them: the bounds of the sweep's
    lanes, before split_pins (make_batched_solver takes these). ``V0`` is
    the initial guess the bounds are set around, built when not given."""
    ocp = trial.ocp
    V0 = build_initial_guess(ocp) if V0 is None else V0
    lbf, ubf = final_bounds(ocp, trial.lb_nominal, trial.ub_nominal, V0)
    fin_l = np.isfinite(lbf) & (lbf != ubf)
    fin_u = np.isfinite(ubf) & (lbf != ubf)
    lbf = np.where(fin_l, lbf - relax * np.maximum(1., np.abs(lbf)), lbf)
    ubf = np.where(fin_u, ubf + relax * np.maximum(1., np.abs(ubf)), ubf)
    return lbf, ubf


def make_refiner(ocp, lbw, ubw, free, kappa_mu=0.4, auglu_factor='qr'):
    """Returns one_iter(state, P64, times=None) -> state, its direction
    through the ``auglu_factor`` factor ('qr' or 'lu'). With a dict
    ``times``, each piece is synchronized and its seconds added under
    vals/jac/hess/direction."""
    vals_fn, jac_fn, hess_fn = make_structured_derivs(ocp)
    _, direction = make_ip_step(ocp, kkt='auglu', split=True,
                                kappa_mu=kappa_mu, auglu_factor=auglu_factor)

    def one_iter(state, P64, times=None):
        clock = _Clock(state['w'].device, times)
        f32 = torch.float32
        w, y, lam = state['w'], state['y'], state['lam']
        vals = vals_fn(w, y, lam, P64)
        clock.lap('vals')
        JE, JI = (J.to(f32) for J in jac_fn(w, P64))
        clock.lap('jac')
        H = hess_fn(w, y, lam, P64).to(f32)
        clock.lap('hess')
        out = direction(state, tuple(vals) + (JE, JI, H), lbw, ubw, free)
        clock.lap('direction')
        return out

    return one_iter


class _Clock:
    def __init__(self, device, times):
        self.times = times
        self.cuda = torch.device(device).type == 'cuda'
        self.t = self._now() if times is not None else None

    def _now(self):
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def lap(self, name):
        if self.times is None:
            return
        t = self._now()
        self.times[name] = self.times.get(name, 0.) + (t - self.t)
        self.t = t


def refine(ocp, state, P64, lbw, ubw, free, tol=1e-5, verify_tol=1e-4,
           max_iter=100, kappa_mu=0.4, time_pieces=False, auglu_factor='qr'):
    """Iterate every lane until all lanes latched at ``tol`` or ``max_iter``,
    with the direction of ``auglu_factor`` ('qr', the default, or 'lu').

    Returns a dict: state, n_iter, latched (B,), eq_res (B,) (f64 max |eq|
    of the final iterate), converged (B,), seconds (loop wall time, device
    synchronized), and with ``time_pieces`` the per-piece seconds."""
    one_iter = make_refiner(ocp, lbw, ubw, free, kappa_mu, auglu_factor)
    B = state['w'].shape[0]
    cuda = state['w'].is_cuda
    latched = torch.zeros(B, dtype=torch.bool, device=state['w'].device)
    times = {} if time_pieces else None
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_iter = 0
    while n_iter < max_iter:
        state = one_iter(state, P64, times)
        n_iter += 1
        latched |= state['err'] <= tol
        if bool(latched.all()):
            break
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    eq = torch.func.vmap(ocp.eq_fn)(state['w'], P64)
    eq_res = torch.abs(eq).amax(dim=1)
    finite = torch.isfinite(state['w']).all(dim=1)
    converged = finite & latched & (eq_res <= verify_tol)
    return dict(state=state, n_iter=n_iter, latched=latched, eq_res=eq_res,
                converged=converged, seconds=seconds, times=times)


def average_power(ocp, W, P64):
    """Per-lane average power [W]: final energy over the period."""
    e = torch.func.vmap(ocp.e_final_si_fn)(W, P64)
    T = torch.func.vmap(ocp.time_period_fn)(W)
    return e / T
