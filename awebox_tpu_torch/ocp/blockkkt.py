"""Block-structured KKT factorization for direct collocation NLPs.

Counterpart of ``awebox_tpu/ocp/blockkkt.py``: the condensed primal-dual
system

    M dw = rhs,   M = W + A^T D^-1 A,
    W = H + Sigma + delta_w I  (masked to free variables),

is factorized without materializing M. Ordering the variables of interval k
as the frame

    [x_k | x_{k+1} | interior_k | border],   border = [x_0, theta, phi],

puts every Hessian and Jacobian contribution of interval k inside its frame,
and the factorization is a two-level Cholesky: the interior of each frame is
eliminated (Cholesky, triangular solve, Schur update onto the coupling
[x_k | x_{k+1} | border]), and the Schur complements sum into one dense
reduced system over [x_1 .. x_{n_k} | border] of size n_k nx + nb, which one
more Cholesky factors. The factor succeeds only where M is positive
definite, so its success is the inertia test (Forsgren-Gill), and a Lanczos
probe of M's smallest eigenvalue sets the first regularization.

Everything is batched over a leading lane axis (the JAX package vmaps the
single-lane functions). The per-node derivative blocks come from
``torch.func`` (one ``vmap(jacfwd(.., has_aux=True))`` per node family, as
the JAX package); the two-level factor is K8 (``kernels.block_factor``) and
the structured solve K9 (``kernels.block_solve``). The frame assembly, the
Lanczos probe and the augmented-system refinement are plain torch. Sums
over repeated indices (a frame's entries back into the n variables) go
through fixed gather tables, so they are summed in one order on every
device.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jacfwd, vmap

from ..model.system import PHI_NAMES
from ..parallel import kernels
from .structured import make_local_kit
from .transcription import OCP


# ---------------------------------------------------------------------------
# static maps
# ---------------------------------------------------------------------------

def build_block_maps(ocp: OCP, kit=None) -> SimpleNamespace:
    """The frame layout and the static index maps (numpy), as
    ``awebox_tpu/ocp/blockkkt.py::build_block_maps``."""
    if kit is None:
        kit = make_local_kit(ocp)
    vs = ocp.vstruct
    n_k, d = kit.n_k, kit.d
    nx, nu, nxd, nz = kit.nx, kit.nu, kit.nxd, kit.nz
    ntheta_V, nphi = kit.ntheta_V, kit.nphi
    n_eq_m, n_sh, n_ineq_m = kit.n_eq_m, kit.n_sh, kit.n_ineq_m

    ni = nu + nxd + nz + d * nx + d * nz
    nb = nx + ntheta_V + nphi
    nloc = 2 * nx + ni + nb

    off_b, off_bn, off_i = 0, nx, 2 * nx
    off_g = 2 * nx + ni
    i_u, i_xd = 0, nu
    i_z = nu + nxd
    i_cx = i_z + nz
    i_cz = i_cx + d * nx
    g_x0, g_th, g_phi = 0, nx, nx + ntheta_V

    ar = np.arange

    # frame positions of the local (per-node) jacobian columns; x_k maps to
    # the border x0 block for k=0, to the b slot otherwise
    def xk_pos(k):
        return (off_g + g_x0 + ar(nx)) if k == 0 else (off_b + ar(nx))

    loc_c = nx * (d + 1) + nu + nz + ntheta_V + nphi
    coll_cols = np.zeros((n_k, d, loc_c), dtype=np.int32)
    for k in range(n_k):
        for j in range(d):
            cols = [xk_pos(k)]
            for r in range(d):
                cols.append(off_i + i_cx + r * nx + ar(nx))
            cols.append(off_i + i_u + ar(nu))
            cols.append(off_i + i_cz + j * nz + ar(nz))
            cols.append(off_g + g_th + ar(ntheta_V))
            cols.append(off_g + g_phi + ar(nphi))
            coll_cols[k, j] = np.concatenate(cols)

    loc_s = nx + nxd + nu + nz + ntheta_V + nphi
    sh_cols = np.zeros((n_k, loc_s), dtype=np.int32)
    for k in range(n_k):
        sh_cols[k] = np.concatenate([
            xk_pos(k), off_i + i_xd + ar(nxd), off_i + i_u + ar(nu),
            off_i + i_z + ar(nz), off_g + g_th + ar(ntheta_V),
            off_g + g_phi + ar(nphi)])

    # one-hot embeddings local -> frame
    E_coll = np.zeros((n_k, d, loc_c, nloc), dtype=np.float64)
    for k in range(n_k):
        for j in range(d):
            E_coll[k, j, ar(loc_c), coll_cols[k, j]] = 1.0
    E_sh = np.zeros((n_k, loc_s, nloc), dtype=np.float64)
    for k in range(n_k):
        E_sh[k, ar(loc_s), sh_cols[k]] = 1.0

    # continuity rows: x_{k+1} - cont0*x_k - sum_r cont_r*coll_x[k,r] = 0
    cont = kit.cont
    A_cont = np.zeros((n_k, nx, nloc))
    for k in range(n_k):
        A_cont[k, ar(nx), off_bn + ar(nx)] = 1.0
        A_cont[k, ar(nx), xk_pos(k)] = -cont[0]
        for r in range(d):
            A_cont[k, ar(nx), off_i + i_cx + r * nx + ar(nx)] = -cont[r + 1]

    # extra (global) rows pinned to one interval each, zero-padded elsewhere
    extra_rows = []   # (k_owner, gid, nloc-coefficient-row)
    eq_slices = ocp.eq_slices
    layout = ocp.model.layout
    n_eq, n_ineq = ocp.n_eq, ocp.n_ineq
    trash = n_eq + n_ineq

    if 'initial_e' in eq_slices and eq_slices['initial_e'].stop > eq_slices['initial_e'].start:
        e_pos = layout.slices['x']['e'].start
        row = np.zeros(nloc)
        row[off_g + g_x0 + e_pos] = 1.0
        extra_rows.append((0, eq_slices['initial_e'].start, row))

    if ocp.periodic and 'periodic' in eq_slices:
        pidx = np.asarray(ocp.periodic_idx)
        p0 = eq_slices['periodic'].start
        for i, xi in enumerate(pidx):
            row = np.zeros(nloc)
            row[off_g + g_x0 + int(xi)] = 1.0
            if kit.radau:
                row[off_i + i_cx + (d - 1) * nx + int(xi)] = -1.0
            else:
                row[off_bn + int(xi)] = -1.0
            extra_rows.append((n_k - 1, p0 + i, row))

    if ocp.single_reelout and 't_f_bounds' in ocp.ineq_slices:
        tf_sl_V = vs.theta_slice('t_f')
        th_off = vs.offsets['theta']
        scale = ocp.options['nlp']['phase_fix_reelout']
        wts = np.array([ocp.switch_kdx / n_k, (n_k - ocp.switch_kdx) / n_k]) / scale
        r0 = n_eq + ocp.ineq_slices['t_f_bounds'].start
        row_p = np.zeros(nloc)
        row_m = np.zeros(nloc)
        for i in range(tf_sl_V.stop - tf_sl_V.start):
            pos = off_g + g_th + (tf_sl_V.start - th_off) + i
            row_p[pos] = wts[i]
            row_m[pos] = -wts[i]
        extra_rows.append((0, r0, row_p))
        extra_rows.append((0, r0 + 1, row_m))

    n_extra = len(extra_rows)
    A_extra = np.zeros((n_k, n_extra, nloc))
    extra_gid = np.full((n_k, n_extra), trash, dtype=np.int32)
    for i, (k_own, gid, row) in enumerate(extra_rows):
        A_extra[k_own, i] = row
        extra_gid[k_own, i] = gid

    # global row ids per interval row stack
    sh_rows0 = eq_slices['shooting'].start
    coll_rows0 = eq_slices['collocation'].start
    cont_rows0 = eq_slices['continuity'].start
    path_rows0 = (n_eq + ocp.ineq_slices['path'].start) if n_ineq_m else None

    sh_gid = sh_rows0 + ar(n_k)[:, None] * n_sh + ar(n_sh)[None, :]
    coll_gid = coll_rows0 + ar(n_k)[:, None] * (d * n_eq_m) + ar(d * n_eq_m)[None, :]
    cont_gid = cont_rows0 + ar(n_k)[:, None] * nx + ar(nx)[None, :]
    gid_parts = [sh_gid, coll_gid, cont_gid]
    if n_ineq_m:
        gid_parts.append(path_rows0 + ar(n_k)[:, None] * n_ineq_m + ar(n_ineq_m)[None, :])
    gid_parts.append(extra_gid)
    row_gid = np.concatenate(gid_parts, axis=1).astype(np.int32)
    m_rows = row_gid.shape[1]

    # V-index maps for (chain, interior, border) routing
    chain_V = np.zeros((n_k, nx), dtype=np.int32)
    intr_V = np.zeros((n_k, ni), dtype=np.int32)
    for k in range(n_k):
        chain_V[k] = ar(vs.x_slice(k + 1).start, vs.x_slice(k + 1).stop)
        parts = [ar(vs.u_slice(k).start, vs.u_slice(k).stop),
                 ar(vs.xdot_slice(k).start, vs.xdot_slice(k).stop),
                 ar(vs.z_slice(k).start, vs.z_slice(k).stop)]
        for r in range(d):
            parts.append(ar(vs.coll_x_slice(k, r).start, vs.coll_x_slice(k, r).stop))
        for r in range(d):
            parts.append(ar(vs.coll_z_slice(k, r).start, vs.coll_z_slice(k, r).stop))
        intr_V[k] = np.concatenate(parts)
    border_V = np.concatenate([
        ar(vs.x_slice(0).start, vs.x_slice(0).stop),
        ar(vs.offsets['theta'], vs.offsets['theta'] + ntheta_V),
        ar(vs.phi_slice.start, vs.phi_slice.stop)]).astype(np.int32)

    # frame -> V gather map; the b slot of interval 0 is unused (all-zero
    # rows/cols) and points at x_0
    frame_V = np.zeros((n_k, nloc), dtype=np.int32)
    for k in range(n_k):
        frame_V[k, off_b:off_b + nx] = ar(vs.x_slice(k).start, vs.x_slice(k).stop)
        frame_V[k, off_bn:off_bn + nx] = chain_V[k]
        frame_V[k, off_i:off_i + ni] = intr_V[k]
        frame_V[k, off_g:] = border_V

    # diagonal ownership inside the frames: x_k owned by frame k's b slot for
    # k >= 1, x_0 / theta / phi by frame 0's border slot, x_{n_k} by the last
    # frame's bn slot, interiors by their own frame
    own = np.zeros((n_k, nloc))
    for k in range(n_k):
        if k >= 1:
            own[k, off_b:off_b + nx] = 1.0
        own[k, off_i:off_i + ni] = 1.0
    own[n_k - 1, off_bn:off_bn + nx] = 1.0
    own[0, off_g:] = 1.0

    # H_glob frame positions (inside the LAST frame): [e(x_{n_k}), t_f, psi]
    e_pos = layout.slices['x']['e'].start
    tf_sl_V = vs.theta_slice('t_f')
    th_off = vs.offsets['theta']
    glob_frame = np.concatenate([
        [off_bn + e_pos],
        off_g + g_th + (ar(tf_sl_V.start, tf_sl_V.stop) - th_off),
        [off_g + g_phi + PHI_NAMES.index('psi')],
    ]).astype(np.int32)

    return SimpleNamespace(
        kit=kit, n_k=n_k, d=d, nx=nx, ni=ni, nb=nb, nloc=nloc,
        off_b=off_b, off_bn=off_bn, off_i=off_i, off_g=off_g,
        n_eq_m=n_eq_m, n_sh=n_sh, n_ineq_m=n_ineq_m, m_rows=m_rows,
        coll_cols=coll_cols, sh_cols=sh_cols,
        E_coll=E_coll, E_sh=E_sh,
        A_cont=A_cont, A_extra=A_extra, n_extra=n_extra,
        row_gid=row_gid, trash=trash,
        chain_V=chain_V, intr_V=intr_V, border_V=border_V, frame_V=frame_V,
        own=own, glob_frame=glob_frame,
        n_eq=n_eq, n_ineq=n_ineq, n=kit.n,
    )


def gather_table(targets, n):
    """For the flat index array ``targets`` (source position p adds into
    target targets[p]), an (n, c) table of source positions per target,
    padded with len(targets) (a zero slot): ``sum_into`` sums through it in
    the order of the sources, the same on every device (index_add_ on a
    card sums in no fixed order)."""
    targets = np.asarray(targets).reshape(-1)
    count = np.bincount(targets, minlength=n)
    table = np.full((n, max(1, int(count.max()))), targets.size, dtype=np.int64)
    fill = np.zeros(n, dtype=np.int64)
    for p, t in enumerate(targets):
        table[t, fill[t]] = p
        fill[t] += 1
    return table


def sum_into(src, table):
    """out[:, t] = sum of src[:, p] over the sources p of target t (the rows
    of ``table``), src (B, P) -> (B, n)."""
    padded = torch.cat([src, torch.zeros_like(src[:, :1])], dim=1)
    return padded[:, table].sum(dim=2)


class _Consts:
    """Numpy constants as tensors, built once per (device, dtype)."""

    def __init__(self, arrays):
        self.arrays = arrays
        self.cache = {}

    def get(self, device, dtype):
        key = (str(device), dtype)
        if key not in self.cache:
            self.cache[key] = {
                k: torch.as_tensor(v, device=device,
                                   dtype=dtype if np.issubdtype(v.dtype, np.floating)
                                   else torch.long)
                for k, v in self.arrays.items()}
        return self.cache[key]


# ---------------------------------------------------------------------------
# derivative blocks + NLP values assembled from per-node locals
# ---------------------------------------------------------------------------

def make_block_derivs(ocp: OCP, maps=None) -> Callable:
    """(W, Y, LAM, P) -> blocks dict with per-node jacobians/hessians and NLP
    values, every entry with a leading lane axis (P's leaves carry it too);
    never materializes (n_eq x n) or (n x n), and never re-evaluates the
    full-horizon eq_fn/ineq_fn/f_fn: residuals, objective and gradient are
    assembled from the per-node local functions that produce the derivative
    blocks (awebox_tpu/ocp/blockkkt.py:264-408)."""
    if maps is None:
        maps = build_block_maps(ocp)
    kit = maps.kit
    vs = ocp.vstruct
    layout = ocp.model.layout
    n_k, d = maps.n_k, maps.d
    n = kit.n
    n_eq_m, n_sh, n_ineq_m = maps.n_eq_m, maps.n_sh, maps.n_ineq_m
    eq_slices = ocp.eq_slices
    radau = kit.radau
    has_initial_e = 'initial_e' in eq_slices \
        and eq_slices['initial_e'].stop > eq_slices['initial_e'].start
    e_sl_x = layout.slices['x']['e'] if layout.has('x', 'e') else None
    periodic = ocp.periodic and 'periodic' in eq_slices
    single_reelout = ocp.single_reelout and 't_f_bounds' in ocp.ineq_slices
    if single_reelout:
        tf_scale = ocp.options['nlp']['phase_fix_reelout']
        tf_bounds = ocp.options['model']['system_bounds']['theta']['t_f']
    phi_sl = vs.phi_slice
    phi_idx = np.arange(phi_sl.start, phi_sl.stop)
    path_sl = ocp.ineq_slices['path'] if n_ineq_m else None

    consts = _Consts(dict(
        coll_idx=kit.coll_idx, sh_idx=kit.sh_idx, glob_idx=kit.glob_idx,
        c_rows=kit.c_rows, sel_rows=kit.sel_rows, phase_ws=kit.phase_ws,
        sh_phase_ws=kit.sh_phase_ws, int_ws=kit.int_ws, cont=np.asarray(kit.cont, float),
        periodic_idx=np.asarray(ocp.periodic_idx if periodic else [], dtype=np.int64),
        # gradf = coll node gradients + global-cost gradient + phi weights,
        # summed into n in that order
        grad_table=gather_table(np.concatenate([kit.coll_idx.reshape(-1), kit.glob_idx,
                                                phi_idx]), n)))

    def coll_all(local, c_row, sel_row, phase_w, iw, ref_vec, lam_node, P, theta0):
        eq = kit.coll_eq_local(local, c_row, sel_row, phase_w, theta0)

        def scal(loc):
            return kit.coll_scalar(loc, c_row, sel_row, phase_w, iw, ref_vec, lam_node, P,
                                   theta0)
        g, val = grad_and_value(scal)(local)
        # jacfwd primary -> (J_eq, H); aux -> primal values
        return (eq, g), (eq, val, g)

    def sh_all(local, phase_w, lam_eq_node, lam_ineq_node, theta0):
        eq = kit.sh_eq_local(local, phase_w, theta0)
        iq = kit.sh_ineq_local(local, phase_w, theta0) if n_ineq_m \
            else local.new_zeros(0)

        def scal(loc):
            return kit.sh_scalar(loc, phase_w, lam_eq_node, lam_ineq_node, theta0)
        g = grad(scal)(local)
        return (eq, iq, g), (eq, iq)

    coll_ad = vmap(jacfwd(coll_all, has_aux=True), in_dims=(0, 0, 0, 0, 0, 0, 0, None, None))
    sh_ad = vmap(jacfwd(sh_all, has_aux=True), in_dims=(0, 0, 0, 0, None))

    def lane(w, y, lam, P, c):
        theta0 = P['theta0']
        coll_locals = w[c['coll_idx']]
        sh_locals = w[c['sh_idx']]
        ref_vecs = kit.ref_nodes_from_P(P)
        lam_coll = y[eq_slices['collocation']].reshape(n_k * d, n_eq_m)
        lam_sh = y[eq_slices['shooting']].reshape(n_k, n_sh)
        lam_path = lam[path_sl].reshape(n_k, n_ineq_m) if n_ineq_m \
            else w.new_zeros(n_k, 0)

        (J_coll, H_coll), (r_coll, scal_coll, g_scal) = coll_ad(
            coll_locals, c['c_rows'], c['sel_rows'], c['phase_ws'], c['int_ws'],
            ref_vecs, lam_coll, P, theta0)
        (J_sh, J_path, H_sh), (r_sh, r_path) = sh_ad(
            sh_locals, c['sh_phase_ws'], lam_sh, lam_path, theta0)

        # residual values (constraint groups are contiguous)
        X = vs.get_x_all(w)
        CX = vs.get_coll_x(w)
        X_stack = torch.cat([X[:n_k, None, :], CX], dim=1)
        xf = torch.einsum('j,kjn->kn', c['cont'], X_stack)
        r_cont = (X[1:] - xf).reshape(-1)
        parts = []
        if has_initial_e:
            ref_x0 = vs.get_x_all(P['ref'])[0]
            parts.append(X[0][e_sl_x] - ref_x0[e_sl_x])
        parts += [r_sh.reshape(-1), r_coll.reshape(-1), r_cont]
        if periodic:
            terminal = CX[n_k - 1, d - 1] if radau else X[n_k]
            parts.append((X[0] - terminal)[c['periodic_idx']])
        cE = torch.cat(parts)
        cI_parts = [r_path.reshape(-1)] if n_ineq_m else [w.new_zeros(0)]
        if single_reelout:
            T = ocp.time_period_fn(w)
            cI_parts.append(torch.stack([(T - tf_bounds[1]) / tf_scale,
                                         (tf_bounds[0] - T) / tf_scale]))
        cI = torch.cat(cI_parts)

        # node cost = scalar - lam.eq; node cost grad = grad(scalar) - J^T lam
        node_costs = scal_coll - torch.einsum('nr,nr->n', lam_coll, r_coll)
        g_nodes = g_scal - torch.einsum('nr,nrl->nl', lam_coll, J_coll)
        glob = w[c['glob_idx']]
        g_glob, gval = grad_and_value(kit.global_cost)(glob, P)
        phi_w = torch.stack([P['cost'][nm] for nm in PHI_NAMES])
        fval = node_costs.sum() + gval + phi_w @ w[phi_sl]
        H_glob = hessian(kit.global_cost)(glob, P)
        return (fval, torch.cat([g_nodes.reshape(-1), g_glob, phi_w]), cE, cI,
                J_coll, J_sh, J_path, H_coll, H_sh, H_glob)

    lanes = vmap(lane, in_dims=(0, 0, 0, 0, None))

    def derivs(W, Y, LAM, P):
        c = consts.get(W.device, W.dtype)
        (fval, g_src, cE, cI, J_coll, J_sh, J_path, H_coll, H_sh,
         H_glob) = lanes(W, Y, LAM, P, c)
        B = W.shape[0]
        return dict(fval=fval, gradf=sum_into(g_src, c['grad_table']), cE=cE, cI=cI,
                    J_coll_nodes=J_coll.reshape(B, n_k, d, n_eq_m, -1),
                    J_sh=J_sh, J_path=J_path if n_ineq_m else None,
                    H_coll=H_coll.reshape(B, n_k, d, H_coll.shape[-1], H_coll.shape[-1]),
                    H_sh=H_sh, H_glob=H_glob)

    return derivs


# ---------------------------------------------------------------------------
# assembly + factorization + solve
# ---------------------------------------------------------------------------

LANCZOS_K = 16


def make_block_kkt(ocp: OCP, n_ladder: int = 7, ladder_factor: float = 100.,
                   n_refine: int = 2):
    """Returns (derivs_fn, kkt_solve, maps) as the JAX package's
    make_block_kkt (awebox_tpu/ocp/blockkkt.py:415-750), over a lane axis:

        kkt_solve(blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu,
                  delta_w, delta_c, delta_ce)
            -> (dw, dy, dlam, ds, dzl, dzu, ok, info)

    with w .. zu (B, .), mu (B,), lbw, ubw, free (n,), and info =
    {'delta_used': (B,) ladder outcome, 'err_d': (B,) max |dual residual|}.
    ``maps.assemble`` exposes the frame assembly to the tests. The two-level
    factor is K8 and each structured solve K9 (kernels.block_factor,
    block_solve): K8 once per ladder attempt, on the attempt's lanes; K9
    1 + n_refine times on the final factor."""
    maps = build_block_maps(ocp)
    derivs_fn = make_block_derivs(ocp, maps)
    kit = maps.kit
    n_k, nx, ni, nb, nloc = maps.n_k, maps.nx, maps.ni, maps.nb, maps.nloc
    n_eq, n_ineq, n = maps.n_eq, maps.n_ineq, maps.n
    n_eq_m, n_ineq_m, d = maps.n_eq_m, maps.n_ineq_m, maps.d
    lay = kernels.BlockLayout(n_k, nx, ni, nb, nloc)
    m = n_eq + n_ineq
    # where each global constraint row sits in the per-frame row stacks (a
    # row no frame holds reads the zero slot past the end)
    row_pos = np.full(m, maps.row_gid.size, dtype=np.int64)
    for p, g in enumerate(maps.row_gid.reshape(-1)):
        if g < m:
            row_pos[g] = p
    consts = _Consts(dict(
        E_coll=maps.E_coll, E_sh=maps.E_sh, A_cont=maps.A_cont, A_extra=maps.A_extra,
        own=maps.own, probe_v0=np.cos(1.618 * np.arange(n)) + 0.3,
        row_gid=maps.row_gid.astype(np.int64), frame_V=maps.frame_V.astype(np.int64),
        chain_V=maps.chain_V.astype(np.int64), intr_V=maps.intr_V.astype(np.int64),
        border_V=maps.border_V.astype(np.int64), glob_frame=maps.glob_frame.astype(np.int64),
        frame_table=gather_table(maps.frame_V, n), row_pos=row_pos,
        sh_idx=kit.sh_idx.astype(np.int64)))
    path_sl = ocp.ineq_slices['path'] if n_ineq_m else None
    diag = lambda X: X.diagonal(dim1=-2, dim2=-1)

    def build_A_frame(blocks, c):
        """(B, n_k, m_rows, nloc) constraint jacobian in frame coordinates,
        by the one-hot embeddings."""
        B = blocks['J_sh'].shape[0]
        As = torch.einsum('bkrl,klA->bkrA', blocks['J_sh'], c['E_sh'])
        Ac = torch.einsum('bkjrl,kjlA->bkjrA', blocks['J_coll_nodes'], c['E_coll'])
        rows = [As, Ac.reshape(B, n_k, d * n_eq_m, nloc), c['A_cont'].expand(B, -1, -1, -1)]
        if n_ineq_m:
            rows.append(torch.einsum('bkrl,klA->bkrA', blocks['J_path'], c['E_sh']))
        rows.append(c['A_extra'].expand(B, -1, -1, -1))
        return torch.cat(rows, dim=2)

    def frames_to_n(frames, c):
        """(B, n_k, nloc) frame vectors summed into (B, n)."""
        return sum_into(frames.reshape(frames.shape[0], -1), c['frame_table'])

    def assemble(blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu, delta_c, delta_ce):
        """Frame matrices + constraint data (awebox_tpu/ocp/blockkkt.py:467-523)."""
        c = consts.get(w.device, w.dtype)
        B = w.shape[0]
        fin = kernels.fin
        gradf, cE, cI = fin(blocks['gradf']), fin(blocks['cE']), fin(blocks['cI'])
        m_ = mu[:, None]
        dl = torch.clamp(w - lbw, min=1e-20)
        du = torch.clamp(ubw - w, min=1e-20)
        sigma = torch.clamp(zl / dl + zu / du, 0., 1e16)
        lam_safe = torch.clamp(lam, min=1e-12)
        D_glob = torch.cat([torch.full_like(y, delta_ce), s / lam_safe + delta_c], dim=1)
        D_ext = torch.cat([D_glob, torch.full_like(D_glob[:, :1], 1e30)], dim=1)
        r2_glob = torch.cat([cE, cI + m_ / lam_safe], dim=1) if n_ineq else cE
        r2_ext = torch.cat([r2_glob, torch.zeros_like(r2_glob[:, :1])], dim=1)
        D_k = D_ext[:, c['row_gid']]
        r2_k = r2_ext[:, c['row_gid']]

        frame_V = c['frame_V']
        free_frame = free[frame_V]
        A = fin(build_A_frame(blocks, c)) * free_frame[None, :, None, :]

        # frame assembly: H embeds + sigma + mask + A^T D^-1 A
        HcE = torch.einsum('zkjab,kjbB->zkjaB', fin(blocks['H_coll']), c['E_coll'])
        Frame = torch.einsum('zkjaB,kjaA->zkAB', HcE, c['E_coll'])
        HsE = torch.einsum('zkab,kbB->zkaB', fin(blocks['H_sh']), c['E_sh'])
        Frame = Frame + torch.einsum('zkaB,kaA->zkAB', HsE, c['E_sh'])
        gf = c['glob_frame']
        Frame[:, n_k - 1, gf[:, None], gf[None, :]] += fin(blocks['H_glob'])
        diag(Frame).add_(c['own'] * sigma[:, frame_V])
        Frame = Frame * (free_frame[:, :, None] * free_frame[:, None, :])
        diag(Frame).add_(c['own'] * (1. - free[frame_V]))
        Frame = Frame + (A * (1. / D_k)[..., None]).transpose(-1, -2) @ A

        # r1 = -(gradf + A^T nu - mu/dl + mu/du) * free, per interval and
        # summed back (each constraint row lives in exactly one frame)
        nu = torch.cat([y, lam], dim=1) if n_ineq else y
        nu_ext = torch.cat([nu, torch.zeros_like(nu[:, :1])], dim=1)
        Atnu = frames_to_n((nu_ext[:, c['row_gid']][..., None, :] @ A)[..., 0, :], c)
        r1 = -(gradf + Atnu - m_ / dl + m_ / du) * free
        Atr2D = frames_to_n(((r2_k / D_k)[..., None, :] @ A)[..., 0, :], c)
        return dict(Frame=Frame, A=A, D_k=D_k, r2_k=r2_k, rhs_w=r1 - Atr2D, r1=r1, dl=dl,
                    du=du, cI=cI)

    def lanczos_lambda_min(mv, v0, iters=LANCZOS_K):
        """Smallest Ritz value of ``iters`` Lanczos steps from v0, per lane."""
        q = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
        q_prev = torch.zeros_like(q)
        beta_prev = torch.zeros_like(q[:, 0])
        alphas, betas = [], []
        for _ in range(iters):
            r = mv(q) - beta_prev[:, None] * q_prev
            alpha = (q * r).sum(dim=1)
            r = r - alpha[:, None] * q
            beta = torch.linalg.norm(r, dim=1) + 1e-30
            alphas.append(alpha)
            betas.append(beta)
            q_prev, q, beta_prev = q, r / beta[:, None], beta
        al, be = torch.stack(alphas, dim=1), torch.stack(betas, dim=1)[:, :-1]
        T = torch.diag_embed(al) + torch.diag_embed(be, 1) + torch.diag_embed(be, -1)
        return torch.linalg.eigvalsh(T).amin(dim=1)

    def JI_dw(blocks, dw, c):
        """JI @ dw without materializing JI: path rows + t_f rows."""
        parts = dw.new_zeros(dw.shape[0], n_ineq)
        if n_ineq_m:
            Jp = kernels.fin(blocks['J_path'])
            vals = (Jp @ dw[:, c['sh_idx']][..., None])[..., 0]
            parts[:, path_sl] = vals.reshape(dw.shape[0], -1)
        for (r, col, v) in kit.ineq_lin:
            parts[:, r] += v * dw[:, col]
        return parts

    def kkt_solve(blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu, delta_w, delta_c,
                  delta_ce):
        c = consts.get(w.device, w.dtype)
        B = w.shape[0]
        asm = assemble(blocks, w, s, y, lam, zl, zu, lbw, ubw, free, mu, delta_c, delta_ce)
        Frame, A, D_k, r2_k = asm['Frame'], asm['A'], asm['D_k'], asm['r2_k']
        frame_V = c['frame_V']
        own_free = (c['own'] * free[frame_V]).contiguous()   # delta goes on free owners only

        def frame_matvec(v):
            return frames_to_n((Frame @ v[:, frame_V][..., None])[..., 0], c)

        # inertia correction: a Lanczos probe of the undamped M0's smallest
        # eigenvalue drives delta to ~ -lambda_min, so the factor succeeds
        # with near-minimal damping; the ladder stays as the safety net
        lam_min = lanczos_lambda_min(frame_matvec, c['probe_v0'].expand(B, -1))
        delta_fg = torch.where(lam_min < 0., -lam_min * 1.5 + 1e-8, torch.zeros_like(lam_min))
        delta = torch.clamp(delta_fg, min=delta_w)
        Frame = Frame.contiguous()
        Li, Xc, L_R, ok = kernels.block_factor(Frame, delta, own_free, lay)
        # the ladder: re-factor only the lanes that still fail
        for _ in range(n_ladder):
            bad = torch.nonzero(~ok).flatten()
            if bad.numel() == 0:
                break
            delta[bad] = torch.clamp(delta[bad] * ladder_factor, min=1e-8)
            fb = kernels.block_factor(Frame[bad].contiguous(), delta[bad].contiguous(),
                                      own_free, lay)
            for t, tb in zip((Li, Xc, L_R, ok), fb):
                t[bad] = tb
        index_maps = (c['chain_V'], c['intr_V'], c['border_V'])

        def solve(rhs):
            return kernels.block_solve(Li, Xc, L_R, rhs.contiguous(), index_maps, lay)

        def matvec(v):
            """M v via the frames + the ladder's damping (the ownership of
            each free variable sums to 1, so the damping is delta * free)."""
            return frame_matvec(v) + delta[:, None] * free * v

        def A_rows(v):
            return (A @ v[:, frame_V][..., None])[..., 0]

        def At_rows(rows):
            return frames_to_n((rows[..., None, :] @ A)[..., 0, :], c)

        # primal-dual direction with augmented-system iterative refinement:
        # each round corrects both dw and dnu through the same factor
        r1 = asm['r1']
        dw = solve(asm['rhs_w'])
        dnu_rows = (A_rows(dw) + r2_k) / D_k
        for _ in range(n_refine):
            Adw_rows = A_rows(dw)
            e1 = r1 - (matvec(dw) - At_rows(Adw_rows / D_k)) - At_rows(dnu_rows)
            e2 = -r2_k - (Adw_rows - D_k * dnu_rows)
            ddw = solve(e1 + At_rows(e2 / D_k))
            dnu_rows = dnu_rows + (A_rows(ddw) - e2) / D_k
            dw = dw + ddw
        dw = kernels.fin(dw * free)
        flat = dnu_rows.reshape(B, -1)
        dnu = kernels.fin(torch.cat([flat, torch.zeros_like(flat[:, :1])], dim=1)[:, c['row_pos']])
        dy, dlam = dnu[:, :n_eq], dnu[:, n_eq:]
        if n_ineq:
            ds = -(asm['cI'] + s) - JI_dw(blocks, dw, c)
        else:
            ds = s.new_zeros(B, 0)
        m_ = mu[:, None]
        dl, du = asm['dl'], asm['du']
        dzl = m_ / dl - zl - zl * dw / dl
        dzu = m_ / du - zu + zu * dw / du
        info = dict(delta_used=delta, err_d=torch.abs(r1).amax(dim=1))
        return dw, dy, dlam, ds, dzl, dzu, ok, info

    maps.assemble = assemble
    maps.layout = lay
    return derivs_fn, kkt_solve, maps
