"""Warmstart remapping: reuse a saved solution on a (possibly) different grid.

Counterpart of ``awebox_tpu/api/warmstart.py``: a stored solution with
discretization (n_k_src, d_src) is interpolated in normalized time onto the
target NLP's (n_k, d) grid: states through the source collocation
polynomials, zoh controls by interval membership, algebraic variables
through the d-node basis; theta/phi copy over with the t_f 1<->2 component
remap for phase-fix changes. Everything here is numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ocp.collocation import Collocation


def tf_per_k(ocp, V) -> np.ndarray:
    """(n_k,) interval durations of the flat V (numpy)."""
    return ocp.tf_per_k_fn(torch.as_tensor(np.asarray(V, dtype=float))).numpy()


def solution_payload(trial) -> dict:
    """Grid + arrays needed to remap this solution onto another grid."""
    ocp = trial.ocp
    vs = ocp.vstruct
    V = np.asarray(trial.solution.V_opt)
    poly_u = (vs.u_param == 'poly')
    CZ = np.asarray(vs.get_coll_z(V))
    if poly_u:
        CU = np.asarray(vs.get_coll_u(V))
        U = CU.mean(axis=1)                # per-interval mean for zoh targets
        XD = np.zeros((ocp.n_k, vs.nxd))
    else:
        CU = None
        U = np.asarray(vs.get_u_all(V))
        XD = np.asarray(vs.get_xdot_all(V))
    return {
        'n_k': ocp.n_k, 'd': ocp.d,
        'scheme': ocp.options['nlp']['collocation']['scheme'],
        'tf_k': tf_per_k(ocp, V),
        'X': np.asarray(vs.get_x_all(V)),
        'U': U, 'XD': XD, 'Z': CZ.mean(axis=1) if poly_u else np.asarray(vs.get_z_all(V)),
        'CU': CU,
        'CX': np.asarray(vs.get_coll_x(V)),
        'CZ': CZ,
        'theta': {name: np.asarray(V[vs.theta_slice(name)])
                  for name in vs.theta_names},
        'phi': np.asarray(V[vs.phi_slice]),
        'x_names': [n for n, _ in trial.model.layout.entries['x']],
        'u_names': [n for n, _ in trial.model.layout.entries['u']],
        'z_names': [n for n, _ in trial.model.layout.entries['z']],
    }


def _eval_src(payload, coll_src, tau_global):
    """(x, xdot, u, z) of the source solution at normalized time tau in
    [0, 1] (fraction of the full period)."""
    n_k = payload['n_k']
    tf_k = payload['tf_k']
    t_x = np.concatenate([[0.], np.cumsum(tf_k / n_k)])
    T = t_x[-1]
    t = min(max(tau_global, 0.), 1.) * T
    k = min(max(int(np.searchsorted(t_x, t, side='right')) - 1, 0), n_k - 1)
    h_k = tf_k[k] / n_k
    tau = min(max((t - t_x[k]) / h_k, 0.), 1.)
    lx = coll_src.interp_x(tau)
    lu = coll_src.interp_u(tau)
    dlx = coll_src.interp_dx(tau)
    stack = np.concatenate([payload['X'][k][None, :], payload['CX'][k]], axis=0)
    x = lx @ stack
    xdot = (dlx @ stack) / h_k
    z = lu @ payload['CZ'][k]
    if payload.get('CU') is not None:      # poly source: interpolate controls
        u = lu @ payload['CU'][k]
    else:
        u = payload['U'][k]
    return x, xdot, u, z


def remap_to_v(payload: dict, ocp_dst) -> np.ndarray:
    """Interpolate the stored solution onto the target OCP's V layout.

    Variable layouts (model options) must match; only the time grid
    (n_k, d, phase fix) may differ."""
    vs = ocp_dst.vstruct
    layout = ocp_dst.model.layout
    for t, key in (('x', 'x_names'), ('u', 'u_names'), ('z', 'z_names')):
        dst_names = [n for n, _ in layout.entries[t]]
        if dst_names != payload[key]:
            raise ValueError(
                f'warmstart remap requires matching {t}-variable sets; '
                f'stored {payload[key]} vs target {dst_names}')

    coll_src = Collocation.build(payload['d'], payload['scheme'])
    n_k, d = ocp_dst.n_k, ocp_dst.d
    V = np.zeros(vs.total)

    # shooting nodes + collocation nodes in normalized global time
    for k in range(n_k + 1):
        x, _, _, _ = _eval_src(payload, coll_src, k / n_k)
        V[vs.x_slice(k)] = x
    poly_dst = (vs.u_param == 'poly')
    for k in range(n_k):
        if not poly_dst:
            tau_mid = (k + 0.5) / n_k
            x, xdot, u, z = _eval_src(payload, coll_src, tau_mid)
            V[vs.u_slice(k)] = _eval_src(payload, coll_src, k / n_k)[2]
            V[vs.xdot_slice(k)] = xdot
            V[vs.z_slice(k)] = z
        for j in range(d):
            tau_node = (k + ocp_dst.coll.tau_root[j + 1]) / n_k
            xj, _, uj, zj = _eval_src(payload, coll_src, tau_node)
            V[vs.coll_x_slice(k, j)] = xj
            V[vs.coll_z_slice(k, j)] = zj
            if poly_dst:
                V[vs.coll_u_slice(k, j)] = uj

    # theta: copy, remapping t_f between 1 and 2 components
    T_src = float(np.sum(payload['tf_k']) / payload['n_k'])
    for name in vs.theta_names:
        sl = vs.theta_slice(name)
        dim_dst = sl.stop - sl.start
        src = payload['theta'].get(name)
        if name == 't_f':
            V[sl] = T_src  # broadcast mean period to 1 or 2 components
        elif src is None:
            V[sl] = 1.0
        elif len(src) == dim_dst:
            V[sl] = src
        else:
            V[sl] = np.resize(src, dim_dst)

    phi_sl = vs.phi_slice
    V[phi_sl] = np.resize(payload['phi'], phi_sl.stop - phi_sl.start)
    return V
