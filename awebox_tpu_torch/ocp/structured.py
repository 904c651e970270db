"""Structure-exploiting NLP derivatives for the batched interior-point step.

Counterpart of ``awebox_tpu/ocp/structured.py`` (``make_local_kit`` and
``make_structured_derivs(parts=True)``). The direct-collocation Lagrangian
separates into per-node local functions plus linear coupling
(continuity/periodicity) and a small global term, so the constraint
Jacobians and the Lagrangian Hessian are computed as per-node dense blocks
with ``torch.func.vmap`` over nodes (and, outside it, over scenario lanes)
of ``jacfwd``/``hessian``, then scattered into dense (JE, JI, H).

Local variables of a collocation node (k, j):
    [x_k, coll_x[k, 0..d-1], u_k, coll_z[k, j], theta_V, phi]
Local variables of a shooting node k:
    [x_k, xdot_k, u_k, z_k, theta_V, phi]
theta/phi are shared (arrowhead coupling): their Hessian blocks accumulate
across nodes.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch.func import grad_and_value, hessian, jacfwd, vmap

from ..model.builder import take
from ..model.lagrangian import const
from ..model.system import PHI_NAMES
from .transcription import OCP, REG_CATEGORIES, kite_betas


def _idx(sl: slice) -> np.ndarray:
    return np.arange(sl.start, sl.stop)


def make_local_kit(ocp: OCP) -> SimpleNamespace:
    """Static index maps + per-node local functions of the collocation NLP."""
    model = ocp.model
    layout = model.layout
    vs = ocp.vstruct
    n_k, d = ocp.n_k, ocp.d
    nx, nu, nxd, nz = vs.nx, vs.nu, vs.nxd, vs.nz
    n = vs.total
    ntheta_V = vs.ntheta
    nphi = len(PHI_NAMES)
    h = 1. / n_k

    C = ocp.coll.coeff_collocation
    cont = ocp.coll.coeff_continuity
    int_w = ocp.coll.quad_weights

    n_eq_m = model.n_eq
    n_ineq_m = model.n_ineq
    keep_rows = np.asarray(ocp.keep_rows)
    n_sh = len(keep_rows)

    tf_sl_V = vs.theta_slice('t_f')
    tf_dim = tf_sl_V.stop - tf_sl_V.start

    # --- gather index arrays ----------------------------------------------
    theta_idx = _idx(slice(vs.offsets['theta'], vs.offsets['theta'] + ntheta_V))
    phi_idx = _idx(vs.phi_slice)

    coll_idx = np.zeros((n_k * d, nx * (d + 1) + nu + nz + ntheta_V + nphi), dtype=np.int64)
    c_rows = np.zeros((n_k * d, d + 1))
    sel_rows = np.zeros((n_k * d, d + 1))
    phase_ws = np.zeros((n_k * d, tf_dim))
    int_ws = np.zeros(n_k * d)
    for k in range(n_k):
        for j in range(d):
            i = k * d + j
            cols = [_idx(vs.x_slice(k))]
            for r in range(d):
                cols.append(_idx(vs.coll_x_slice(k, r)))
            cols += [_idx(vs.u_slice(k)), _idx(vs.coll_z_slice(k, j)),
                     theta_idx, phi_idx]
            coll_idx[i] = np.concatenate(cols)
            c_rows[i] = C[:, j + 1]
            sel_rows[i, j + 1] = 1.0
            phase_ws[i, ocp.phase_idx[k] if tf_dim == 2 else 0] = 1.0
            int_ws[i] = int_w[j]

    sh_idx = np.zeros((n_k, nx + nxd + nu + nz + ntheta_V + nphi), dtype=np.int64)
    sh_phase_ws = np.zeros((n_k, tf_dim))
    for k in range(n_k):
        sh_idx[k] = np.concatenate([
            _idx(vs.x_slice(k)), _idx(vs.xdot_slice(k)), _idx(vs.u_slice(k)),
            _idx(vs.z_slice(k)), theta_idx, phi_idx])
        sh_phase_ws[k, ocp.phase_idx[k] if tf_dim == 2 else 0] = 1.0

    # offsets of pieces inside the local vectors
    c_u = slice(nx * (d + 1), nx * (d + 1) + nu)
    c_z = slice(c_u.stop, c_u.stop + nz)
    c_th = slice(c_z.stop, c_z.stop + ntheta_V)
    c_phi = slice(c_th.stop, c_th.stop + nphi)

    s_x = slice(0, nx)
    s_xd = slice(nx, nx + nxd)
    s_u = slice(nx + nxd, nx + nxd + nu)
    s_z = slice(s_u.stop, s_u.stop + nz)
    s_th = slice(s_z.stop, s_z.stop + ntheta_V)
    s_phi = slice(s_th.stop, s_th.stop + nphi)

    # model theta vector from V-theta entries + phase weight
    theta_V_offsets = {}
    cursor = 0
    for name, dim in zip(vs.theta_names, vs.theta_dims):
        theta_V_offsets[name] = slice(cursor, cursor + dim)
        cursor += dim

    def model_theta_from_entries(theta_entries, phase_w):
        pieces = []
        for name, dim in layout.entries['theta']:
            if name == 't_f':
                pieces.append((phase_w @ theta_entries[theta_V_offsets['t_f']])[None])
            elif name in theta_V_offsets:
                pieces.append(theta_entries[theta_V_offsets[name]])
            else:
                pieces.append(torch.zeros(dim, dtype=theta_entries.dtype,
                                          device=theta_entries.device))
        return torch.cat(pieces)

    # --- per-node model-vec assembly --------------------------------------
    def coll_model_vec(local, c_row, sel_row, phase_w):
        x_stack = local[:nx * (d + 1)].reshape(d + 1, nx)
        theta_entries = local[c_th]
        tf = phase_w @ theta_entries[theta_V_offsets['t_f']]
        xdot = (c_row @ x_stack) / (h * tf)
        x_node = sel_row @ x_stack
        theta_model = model_theta_from_entries(theta_entries, phase_w)
        return torch.cat([x_node, xdot, local[c_u], local[c_z], theta_model])

    def sh_model_vec(local, phase_w):
        theta_model = model_theta_from_entries(local[s_th], phase_w)
        return torch.cat([local[s_x], local[s_xd], local[s_u],
                          local[s_z], theta_model])

    def coll_eq_local(local, c_row, sel_row, phase_w, theta0):
        mv = coll_model_vec(local, c_row, sel_row, phase_w)
        return model.eq_fn(mv, local[c_phi], theta0)

    def sh_eq_local(local, phase_w, theta0):
        mv = sh_model_vec(local, phase_w)
        return take(model.eq_fn(mv, local[s_phi], theta0), keep_rows)

    def sh_ineq_local(local, phase_w, theta0):
        mv = sh_model_vec(local, phase_w)
        return model.ineq_fn(mv, local[s_phi], theta0)

    # node objective terms: quadratic regularization (power_cycle tracking
    # blend psi) and, for 6-DOF kites, the beta cost
    cat_mask = np.asarray(ocp.cat_mask_matrix)
    norm = ocp.normalization
    psi_i = PHI_NAMES.index('psi')
    kite_dof = model.cfg['kite_dof']

    def coll_cost_local(local, c_row, sel_row, phase_w, iw, ref_vec, P, theta0):
        mv = coll_model_vec(local, c_row, sel_row, phase_w)
        diffsq = P['weights'] * (mv - ref_vec) ** 2
        per_cat = const(cat_mask, local) @ diffsq
        cost = 0.
        for i, cat in enumerate(REG_CATEGORIES):
            factor = local[c_phi][psi_i] if cat == 'tracking' else 1.0
            cost = cost + factor * P['cost'][cat] / norm[cat] * per_cat[i]
        if kite_dof == 6:
            beta_sq = torch.sum(kite_betas(model, mv, theta0) ** 2)
            cost = cost + P['cost']['beta'] / norm['beta'] * beta_sq
        return iw * cost

    def coll_scalar(local, c_row, sel_row, phase_w, iw, ref_vec, lam_node, P, theta0):
        return lam_node @ coll_eq_local(local, c_row, sel_row, phase_w, theta0) \
            + coll_cost_local(local, c_row, sel_row, phase_w, iw, ref_vec, P, theta0)

    def sh_scalar(local, phase_w, lam_eq_node, lam_ineq_node, theta0):
        val = lam_eq_node @ sh_eq_local(local, phase_w, theta0)
        if n_ineq_m:
            val = val + lam_ineq_node @ sh_ineq_local(local, phase_w, theta0)
        return val

    # --- global objective piece: power + time cost -------------------------
    e_pos_in_x = layout.slices['x']['e'].start
    eN_idx = vs.x_slice(n_k).start + e_pos_in_x
    psi_V_idx = vs.phi_slice.start + psi_i
    glob_idx = np.concatenate([[eN_idx], _idx(tf_sl_V), [psi_V_idx]])
    switch_kdx = ocp.switch_kdx

    def global_cost(gvars, P):
        e_end = gvars[0]
        tf = gvars[1:-1]
        psi = gvars[-1]
        ref_tf = P['ref'][tf_sl_V]
        if tf_dim == 2:
            T = tf[0] * switch_kdx / n_k + tf[1] * (n_k - switch_kdx) / n_k
            T_ref = ref_tf[0] * switch_kdx / n_k + ref_tf[1] * (n_k - switch_kdx) / n_k
        else:
            T = tf[0]
            T_ref = ref_tf[0]
        cost = (1. - psi) * P['cost']['power'] * (-1.) * e_end / T
        cost = cost + P['cost']['t_f'] * (T - T_ref) ** 2
        return cost

    # --- linear constraint rows (constant triplets) ------------------------
    eq_slices = ocp.eq_slices
    triplets_rows, triplets_cols, triplets_vals = [], [], []

    r0 = eq_slices['initial_e'].start
    triplets_rows.append([r0])
    triplets_cols.append([vs.x_slice(0).start + e_pos_in_x])
    triplets_vals.append([1.0])

    cont_rows = eq_slices['continuity']
    for k in range(n_k):
        base = cont_rows.start + k * nx
        for i in range(nx):
            triplets_rows.append([base + i])
            triplets_cols.append([vs.x_slice(k + 1).start + i])
            triplets_vals.append([1.0])
            # minus the continuity-weighted stack
            triplets_rows.append([base + i])
            triplets_cols.append([vs.x_slice(k).start + i])
            triplets_vals.append([-cont[0]])
            for r in range(d):
                triplets_rows.append([base + i])
                triplets_cols.append([vs.coll_x_slice(k, r).start + i])
                triplets_vals.append([-cont[r + 1]])

    radau = ocp.coll.scheme == 'radau'
    p_rows = eq_slices['periodic']
    for i, xi in enumerate(np.asarray(ocp.periodic_idx)):
        triplets_rows.append([p_rows.start + i])
        triplets_cols.append([vs.x_slice(0).start + int(xi)])
        triplets_vals.append([1.0])
        triplets_rows.append([p_rows.start + i])
        if radau:
            triplets_cols.append([vs.coll_x_slice(n_k - 1, d - 1).start + int(xi)])
        else:
            triplets_cols.append([vs.x_slice(n_k).start + int(xi)])
        triplets_vals.append([-1.0])

    lin_rows = np.concatenate(triplets_rows).astype(np.int64)
    lin_cols = np.concatenate(triplets_cols).astype(np.int64)
    lin_vals = np.concatenate(triplets_vals)

    # t_f bound inequalities (linear in tf entries)
    ineq_lin = []
    if ocp.single_reelout and 't_f_bounds' in ocp.ineq_slices:
        tf_bounds_rows = ocp.ineq_slices['t_f_bounds']
        scale = ocp.options['nlp']['phase_fix_reelout']
        wts = np.array([switch_kdx / n_k, (n_k - switch_kdx) / n_k]) / scale
        for i, col in enumerate(_idx(tf_sl_V)):
            ineq_lin.append((tf_bounds_rows.start, int(col), wts[i]))
            ineq_lin.append((tf_bounds_rows.start + 1, int(col), -wts[i]))

    # reference model-vec per coll node, from one lane's P (zero xdot)
    def ref_nodes_from_P(P):
        ref = P['ref']
        locs = ref[torch.as_tensor(coll_idx, device=ref.device)]

        def ref_vec(local, sel_row, phase_w):
            theta_model = model_theta_from_entries(local[c_th], phase_w)
            x_node = sel_row @ local[:nx * (d + 1)].reshape(d + 1, nx)
            return torch.cat([x_node, torch.zeros(nxd, dtype=local.dtype, device=local.device),
                              local[c_u], local[c_z], theta_model])
        return vmap(ref_vec)(locs, const(sel_rows, ref), const(phase_ws, ref))

    return SimpleNamespace(
        n=n, n_k=n_k, d=d, nx=nx, nu=nu, nxd=nxd, nz=nz,
        ntheta_V=ntheta_V, nphi=nphi, n_eq_m=n_eq_m, n_ineq_m=n_ineq_m,
        n_sh=n_sh, tf_dim=tf_dim, keep_rows=keep_rows,
        coll_idx=coll_idx, sh_idx=sh_idx, theta_idx=theta_idx, phi_idx=phi_idx,
        c_rows=c_rows, sel_rows=sel_rows, phase_ws=phase_ws, int_ws=int_ws,
        sh_phase_ws=sh_phase_ws,
        coll_eq_local=coll_eq_local, sh_eq_local=sh_eq_local,
        sh_ineq_local=sh_ineq_local, coll_scalar=coll_scalar,
        sh_scalar=sh_scalar, coll_cost_local=coll_cost_local,
        coll_model_vec=coll_model_vec,
        cat_mask=cat_mask, norm=norm,
        global_cost=global_cost, glob_idx=glob_idx,
        ref_nodes_from_P=ref_nodes_from_P,
        lin_rows=lin_rows, lin_cols=lin_cols, lin_vals=lin_vals,
        ineq_lin=ineq_lin, cont=np.asarray(cont), radau=radau,
    )


def _scatter_blocks(out, rows, cols, blocks):
    """out[b, rows[i, r], cols[i, c]] += blocks[b, i, r, c] over lanes b and
    nodes i, out of the traced region (``out`` is a fresh zeros tensor)."""
    B = out.shape[0]
    dev = out.device
    rows_t = torch.as_tensor(rows, device=dev)[:, :, None]
    cols_t = torch.as_tensor(cols, device=dev)[:, None, :]
    shape = blocks.shape
    b_idx = torch.arange(B, device=dev).view(B, 1, 1, 1).expand(shape)
    out.index_put_((b_idx, rows_t.expand(shape), cols_t.expand(shape)),
                   blocks, accumulate=True)
    return out


def make_structured_derivs(ocp: OCP, hessian_mode: str = 'exact'):
    """Returns (vals_fn, jac_fn, hess_fn), each batched over a leading lane
    axis (the counterpart of ``make_structured_derivs(parts=True)`` under a
    lane vmap):

        vals_fn(W, Y, LAM, P) -> (fval (B,), gradf (B, n), cE (B, m_e), cI (B, m_i))
        jac_fn(W, P)          -> (JE (B, m_e, n), JI (B, m_i, n))
        hess_fn(W, Y, LAM, P) -> H (B, n, n)

    P is a dict whose leaves all carry the lane axis. The outputs take the
    dtype of W. Run them in f64: under PyTorch's forward-mode AD a 0-d f32
    intermediate combined with a Python float gets an f64 tangent, so the
    nested transforms of jac/hess do not stay in f32."""
    if hessian_mode != 'exact':
        raise NotImplementedError(f'hessian={hessian_mode!r} is not ported')
    kit = make_local_kit(ocp)
    n = kit.n
    n_k, d = kit.n_k, kit.d
    n_eq_m, n_sh, n_ineq_m = kit.n_eq_m, kit.n_sh, kit.n_ineq_m

    eq_slices = ocp.eq_slices
    coll_rows0 = eq_slices['collocation'].start
    sh_rows0 = eq_slices['shooting'].start
    path_sl = ocp.ineq_slices['path']

    n_eq_total = ocp.n_eq
    n_ineq_total = ocp.n_ineq
    f_fn, eq_fn, ineq_fn = ocp.f_fn, ocp.eq_fn, ocp.ineq_fn

    rows_c = coll_rows0 + np.arange(n_k * d)[:, None] * n_eq_m + np.arange(n_eq_m)[None, :]
    rows_s = sh_rows0 + np.arange(n_k)[:, None] * n_sh + np.arange(n_sh)[None, :]
    rows_p = path_sl.start + np.arange(n_k)[:, None] * n_ineq_m + np.arange(n_ineq_m)[None, :]

    def node_consts(like):
        return {k: const(getattr(kit, k), like)
                for k in ('c_rows', 'sel_rows', 'phase_ws', 'sh_phase_ws', 'int_ws')}

    def vals_one(w, P):
        gradf, fval = grad_and_value(f_fn)(w, P)
        return fval, gradf, eq_fn(w, P), ineq_fn(w, P)

    def vals_fn(W, Y, LAM, P):
        return vmap(vals_one)(W, P)

    def jac_blocks(w, theta0, nc):
        coll_locals = w[torch.as_tensor(kit.coll_idx, device=w.device)]
        sh_locals = w[torch.as_tensor(kit.sh_idx, device=w.device)]
        J_coll = vmap(jacfwd(kit.coll_eq_local), in_dims=(0, 0, 0, 0, None))(
            coll_locals, nc['c_rows'], nc['sel_rows'], nc['phase_ws'], theta0)
        J_sh = vmap(jacfwd(kit.sh_eq_local), in_dims=(0, 0, None))(
            sh_locals, nc['sh_phase_ws'], theta0)
        if n_ineq_m:
            J_path = vmap(jacfwd(kit.sh_ineq_local), in_dims=(0, 0, None))(
                sh_locals, nc['sh_phase_ws'], theta0)
        else:
            J_path = J_sh[:, :0]
        return J_coll, J_sh, J_path

    def jac_fn(W, P):
        B = W.shape[0]
        nc = node_consts(W)
        J_coll, J_sh, J_path = vmap(jac_blocks, in_dims=(0, 0, None))(
            W, P['theta0'], nc)
        JE = torch.zeros(B, n_eq_total, n, dtype=W.dtype, device=W.device)
        _scatter_blocks(JE, rows_c, kit.coll_idx, J_coll)
        _scatter_blocks(JE, rows_s, kit.sh_idx, J_sh)
        _scatter_blocks(JE, kit.lin_rows[:, None], kit.lin_cols[:, None],
                        const(kit.lin_vals, W).view(1, -1, 1, 1).expand(B, -1, 1, 1))
        JI = torch.zeros(B, n_ineq_total, n, dtype=W.dtype, device=W.device)
        if n_ineq_m:
            _scatter_blocks(JI, rows_p, kit.sh_idx, J_path)
        for (r, c, v) in kit.ineq_lin:
            JI[:, r, c] += v
        return JE, JI

    def hess_blocks(w, y, lam, P, nc):
        theta0 = P['theta0']
        coll_locals = w[torch.as_tensor(kit.coll_idx, device=w.device)]
        sh_locals = w[torch.as_tensor(kit.sh_idx, device=w.device)]
        lam_coll = y[eq_slices['collocation']].reshape(n_k * d, n_eq_m)
        lam_sh = y[eq_slices['shooting']].reshape(n_k, n_sh)
        lam_path = lam[path_sl].reshape(n_k, n_ineq_m)
        ref_vecs = kit.ref_nodes_from_P(P)
        H_coll = vmap(hessian(kit.coll_scalar),
                      in_dims=(0, 0, 0, 0, 0, 0, 0, None, None))(
            coll_locals, nc['c_rows'], nc['sel_rows'], nc['phase_ws'],
            nc['int_ws'], ref_vecs, lam_coll, P, theta0)
        H_sh = vmap(hessian(kit.sh_scalar), in_dims=(0, 0, 0, 0, None))(
            sh_locals, nc['sh_phase_ws'], lam_sh, lam_path, theta0)
        glob = w[torch.as_tensor(kit.glob_idx, device=w.device)]
        H_glob = hessian(kit.global_cost)(glob, P)
        return H_coll, H_sh, H_glob

    def hess_fn(W, Y, LAM, P):
        B = W.shape[0]
        nc = node_consts(W)
        H_coll, H_sh, H_glob = vmap(hess_blocks, in_dims=(0, 0, 0, 0, None))(
            W, Y, LAM, P, nc)
        H = torch.zeros(B, n, n, dtype=W.dtype, device=W.device)
        _scatter_blocks(H, kit.coll_idx, kit.coll_idx, H_coll)
        _scatter_blocks(H, kit.sh_idx, kit.sh_idx, H_sh)
        _scatter_blocks(H, kit.glob_idx[None, :], kit.glob_idx[None, :],
                        H_glob[:, None])
        return H

    return vals_fn, jac_fn, hess_fn
