"""Direct-collocation transcription: model -> NLP functions over a flat V.

Counterpart of ``awebox_tpu/ocp/transcription.py`` for the periodic
power_cycle problem under zero-order-hold controls: the per-node model
residuals are evaluated with one ``torch.func.vmap`` over the collocation and
shooting nodes, the objective's regularization sums are one weighted-square
pass over nodes, and continuity/periodicity are static linear maps.

Everything returned is a plain function of (V, P) where
P = {'cost': {...}, 'ref': V-like vector, 'weights': model-var vector,
'theta0': parameter dict}, all tensors of one dtype and device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from ..model.aero import kite_aero
from ..model.builder import Model, take
from ..model.lagrangian import const
from ..model.system import PHI_NAMES
from ..tree import to_tensors
from .collocation import Collocation
from .vstruct import VStruct

REG_CATEGORIES = ('tracking', 'xdot_regularisation', 'u_regularisation',
                  'fictitious', 'theta_regularisation')


@dataclass
class OCP:
    model: Model
    vstruct: VStruct
    coll: Collocation
    options: dict
    n_k: int
    d: int
    phase_idx: np.ndarray          # (n_k,) 0/1 phase of each interval
    switch_kdx: int
    f_fn: Callable                 # (V, P) -> scalar
    eq_fn: Callable                # (V, P) -> vector
    ineq_fn: Callable              # (V, P) -> vector (<= 0)
    eq_slices: Dict[str, slice]
    ineq_slices: Dict[str, slice]
    n_eq: int
    n_ineq: int
    time_period_fn: Callable       # (V) -> scalar SI seconds
    tf_per_k_fn: Callable          # (V) -> (n_k,)
    e_final_si_fn: Callable = None  # (V, P) -> final energy [J]
    cost_components_fn: Callable = None   # (V, P) -> dict of scalars
    keep_rows: np.ndarray = None          # shooting-eq model rows kept
    periodic_idx: np.ndarray = None       # x entries in the periodicity map
    cat_mask_matrix: np.ndarray = None    # (ncat, nv_model) regularization masks
    normalization: dict = None            # per-category cost normalization
    single_reelout: bool = False
    periodic: bool = False
    assemble_nodes_fn: Callable = None    # V -> (shooting, coll_vecs)


def check_ported(options):
    """Refuse NLP options outside the port's scope, naming the option."""
    nlp_opts = options['nlp']
    disc = nlp_opts.get('discretization', 'direct_collocation')
    if disc != 'direct_collocation':
        raise NotImplementedError(f'nlp.discretization={disc!r} is not ported')
    u_param = nlp_opts['collocation']['u_param']
    if u_param != 'zoh':
        raise NotImplementedError(f'nlp.collocation.u_param={u_param!r} is not ported')
    traj_type = options['user_options']['trajectory']['type']
    if traj_type != 'power_cycle':
        raise NotImplementedError(
            f'user_options.trajectory.type={traj_type!r} is not ported')


def kite_betas(model: Model, vec, theta0):
    """Side-slip angle of each 6-DOF kite at one node's model vector, the
    quantity of the beta cost."""
    si = model.to_si(vec)
    arch = model.arch
    betas = []
    for kite in arch.kite_nodes:
        label = arch.node_label(kite)
        kite_dcm = si['x']['r' + label].reshape(3, 3)
        vec_u = kite_aero.get_u_eff_earth(model.cfg, si, theta0, arch, kite)
        betas.append(kite_aero.get_beta(vec_u, kite_dcm))
    return torch.stack(betas)


def keep_rows_of(model: Model) -> np.ndarray:
    """Model equality rows that depend on more than x: the shooting-node
    equalities keep only those (the x-only rows would duplicate continuity).
    Found from a Jacobian at a fixed seeded test point, in f64 on the CPU."""
    layout = model.layout
    rng = np.random.default_rng(0)
    v_test = torch.as_tensor(rng.normal(size=layout.total_dim) * 0.1 + 0.8,
                             dtype=torch.float64)
    phi_test = torch.ones(len(PHI_NAMES), dtype=torch.float64)
    theta0 = to_tensors(model.theta0_init, torch.float64, 'cpu')
    J_test = torch.func.jacfwd(model.eq_fn)(v_test, phi_test, theta0).numpy()
    non_x = np.ones(layout.total_dim, dtype=bool)
    non_x[layout.type_offsets['x']:layout.type_offsets['x'] + layout.dims['x']] = False
    return np.where(np.abs(J_test[:, non_x]).sum(axis=1) > 1e-12)[0]


def build_ocp(model: Model, options: dict) -> OCP:
    check_ported(options)
    nlp_opts = options['nlp']
    n_k = int(nlp_opts['n_k'])
    d = int(nlp_opts['collocation']['d'])
    scheme = nlp_opts['collocation']['scheme']
    coll = Collocation.build(d, scheme)
    layout = model.layout
    arch = model.arch

    traj = options['user_options']['trajectory']
    phase_fix = traj['lift_mode']['phase_fix']
    single_reelout = phase_fix == 'single_reelout' and traj['type'] == 'power_cycle'

    vstruct = VStruct.build(layout, n_k, d, single_reelout, 'zoh')

    switch_kdx = round(n_k * nlp_opts['phase_fix_reelout']) if single_reelout else n_k
    phase_idx = np.array([0 if k < switch_kdx else 1 for k in range(n_k)])

    nx, nu, nxd = vstruct.nx, vstruct.nu, vstruct.nxd
    ntheta_model = layout.dims['theta']

    C_deriv = coll.coeff_collocation[:, 1:]   # derivative at coll nodes 1..d
    cont = coll.coeff_continuity
    int_w = coll.quad_weights                 # (d,)
    h = 1. / n_k

    def tf_per_k(V):
        tf = vstruct.get_theta(V, 't_f')
        if single_reelout:
            return take(tf, phase_idx)
        return tf.expand(n_k)

    def time_period(V):
        """SI time period (theta t_f is unit-scaled)."""
        tf = vstruct.get_theta(V, 't_f')
        if single_reelout:
            return tf[0] * switch_kdx / n_k + tf[1] * (n_k - switch_kdx) / n_k
        return tf[0]

    def model_theta_all(V):
        """(n_k, ntheta_model) model theta vector per interval."""
        tfk = tf_per_k(V)
        cols = []
        for name, dim in layout.entries['theta']:
            if name == 't_f':
                cols.append(tfk[:, None])
            else:
                cols.append(vstruct.get_theta(V, name)[None, :].expand(n_k, dim))
        return torch.cat(cols, dim=1)

    def assemble_nodes(V):
        """Returns (shooting_vecs (n_k, nv), coll_vecs (n_k*d, nv))."""
        X = vstruct.get_x_all(V)             # (n_k+1, nx)
        CX = vstruct.get_coll_x(V)           # (n_k, d, nx)
        CZ = vstruct.get_coll_z(V)           # (n_k, d, nz)
        TH = model_theta_all(V)              # (n_k, nt)

        # polynomial state derivative at collocation nodes
        X_stack = torch.cat([X[:n_k, None, :], CX], dim=1)  # (n_k, d+1, nx)
        tfk = tf_per_k(V)
        Xdot_coll = torch.einsum('rj,krn->kjn', const(C_deriv, V), X_stack) \
            / (h * tfk[:, None, None])

        TH_c = TH[:, None, :].expand(n_k, d, ntheta_model)
        U = vstruct.get_u_all(V)             # (n_k, nu)
        XD = vstruct.get_xdot_all(V)         # (n_k, nxd)
        Z = vstruct.get_z_all(V)             # (n_k, nz)
        shooting = torch.cat([X[:n_k], XD, U, Z, TH], dim=1)
        U_c = U[:, None, :].expand(n_k, d, nu)
        coll_vecs = torch.cat([CX, Xdot_coll, U_c, CZ, TH_c], dim=2)
        return shooting, coll_vecs.reshape(n_k * d, -1)

    def assemble_ref_nodes(Vref):
        """Same as assemble_nodes but with zero xdot at the reference."""
        CX = vstruct.get_coll_x(Vref)
        CZ = vstruct.get_coll_z(Vref)
        TH = model_theta_all(Vref)
        U_c = vstruct.get_u_all(Vref)[:, None, :].expand(n_k, d, nu)
        TH_c = TH[:, None, :].expand(n_k, d, ntheta_model)
        XD0 = torch.zeros(n_k, d, nxd, dtype=Vref.dtype, device=Vref.device)
        coll_vecs = torch.cat([CX, XD0, U_c, CZ, TH_c], dim=2)
        return coll_vecs.reshape(n_k * d, -1)

    # --- structural row selection for shooting equalities ------------------
    keep_rows = keep_rows_of(model)
    n_sh = len(keep_rows)

    # periodicity mask over x entries
    periodic_keep = np.ones(nx, dtype=bool)
    periodic_keep[layout.slices['x']['e']] = False
    for name in layout.names('x'):
        if name.startswith('w') or name.startswith('dw'):
            periodic_keep[layout.slices['x'][name]] = False
    periodic_idx = np.where(periodic_keep)[0]

    n_ineq_model = model.n_ineq

    # --- equality constraint layout ---------------------------------------
    eq_slices: Dict[str, slice] = {}
    cursor = 0

    def add_eq(name, dim):
        nonlocal cursor
        eq_slices[name] = slice(cursor, cursor + dim)
        cursor += dim

    add_eq('initial_e', 1)
    add_eq('shooting', n_k * n_sh)
    add_eq('collocation', n_k * d * model.n_eq)
    add_eq('continuity', n_k * nx)
    add_eq('periodic', int(periodic_keep.sum()))
    n_eq_total = cursor

    radau = (scheme == 'radau')
    e_slice_in_x = layout.slices['x']['e']

    def terminal_x(V):
        if radau:
            return vstruct.get_coll_x(V)[n_k - 1, d - 1]
        return vstruct.get_x_all(V)[n_k]

    def eq_fn(V, P):
        phi = vstruct.get_phi(V)
        theta0 = P['theta0']
        shooting, coll_vecs = assemble_nodes(V)

        X = vstruct.get_x_all(V)
        ref_x0 = vstruct.get_x_all(P['ref'])[0]
        res = [X[0][e_slice_in_x] - ref_x0[e_slice_in_x]]

        eq_sh = torch.func.vmap(model.eq_fn, in_dims=(0, None, None))(
            shooting, phi, theta0)
        res.append(take(eq_sh.T, keep_rows).T.reshape(-1))

        eq_coll = torch.func.vmap(model.eq_fn, in_dims=(0, None, None))(
            coll_vecs, phi, theta0)
        res.append(eq_coll.reshape(-1))

        # continuity: x_{k+1} = sum_j cont_j * Xstack[k, j]
        CX = vstruct.get_coll_x(V)
        X_stack = torch.cat([X[:n_k, None, :], CX], dim=1)
        xf = torch.einsum('j,kjn->kn', const(cont, V), X_stack)
        res.append((X[1:] - xf).reshape(-1))

        diff = X[0] - terminal_x(V)
        res.append(take(diff, periodic_idx))
        return torch.cat(res)

    # --- inequality layout --------------------------------------------------
    ineq_slices: Dict[str, slice] = {}
    icursor = 0

    def add_ineq(name, dim):
        nonlocal icursor
        ineq_slices[name] = slice(icursor, icursor + dim)
        icursor += dim

    add_ineq('path', n_k * n_ineq_model)
    if single_reelout:
        add_ineq('t_f_bounds', 2)
    n_ineq_total = icursor

    tf_bounds = options['model']['system_bounds']['theta']['t_f']

    def ineq_fn(V, P):
        phi = vstruct.get_phi(V)
        theta0 = P['theta0']
        shooting, _ = assemble_nodes(V)
        res = []
        if n_ineq_model:
            path = torch.func.vmap(model.ineq_fn, in_dims=(0, None, None))(
                shooting, phi, theta0)
            res.append(path.reshape(-1))
        else:
            res.append(V[:0])
        if single_reelout:
            T = time_period(V)
            scale = nlp_opts['phase_fix_reelout']
            res.append(torch.stack([(T - tf_bounds[1]) / scale,
                                    (tf_bounds[0] - T) / scale]))
        return torch.cat(res)

    # --- objective ----------------------------------------------------------
    # category id per model-variable entry
    nv_model = layout.total_dim
    cat_masks = {c: np.zeros(nv_model) for c in REG_CATEGORIES}
    for t, cat in (('x', 'tracking'), ('xdot', 'xdot_regularisation'),
                   ('u', 'u_regularisation'), ('z', 'tracking'),
                   ('theta', 'theta_regularisation')):
        off = layout.type_offsets[t]
        for name, dim in layout.entries[t]:
            sl = layout.slices[t][name]
            use_cat = cat
            if t == 'x' and name == 'e':
                use_cat = None
            if t == 'theta' and name == 't_f':
                use_cat = None
            if t == 'u' and ('f_fict' in name or 'm_fict' in name):
                use_cat = 'fictitious'
            if use_cat is not None:
                cat_masks[use_cat][off + sl.start:off + sl.stop] = 1.0
    cat_mask_matrix = np.stack([cat_masks[c] for c in REG_CATEGORIES])

    N_nodes = arch.number_of_nodes
    N_kites = arch.number_of_kites
    normalization = {
        'tracking': n_k * N_nodes,
        'u_regularisation': n_k * N_kites,
        'theta_regularisation': n_k,
        'xdot_regularisation': n_k * N_nodes,
        'fictitious': n_k * N_kites,
        'beta': n_k * N_kites,
    }

    def e_final_scaled(V, P):
        return vstruct.get_x_all(V)[n_k][e_slice_in_x][0]

    e_state_scale = float(model.scaling['x'][e_slice_in_x][0])

    def e_final_si(V, P):
        return e_final_scaled(V, P) * e_state_scale

    int_w_tiled = np.tile(int_w, n_k)   # (n_k*d,) quadrature weight per node
    kite_dof = model.cfg['kite_dof']

    def cost_components(V, P):
        phi = vstruct.get_phi(V)
        _, coll_vecs = assemble_nodes(V)
        coll_refs = assemble_ref_nodes(P['ref'])

        weights = P['weights']
        diffsq = weights[None, :] * (coll_vecs - coll_refs) ** 2   # (N, nv)
        per_cat_per_node = diffsq @ const(cat_mask_matrix, V).T    # (N, ncat)
        cat_sums = const(int_w_tiled, V) @ per_cat_per_node        # (ncat,)

        comp = {}
        for i, cat in enumerate(REG_CATEGORIES):
            comp[cat + '_cost'] = P['cost'][cat] / normalization[cat] * cat_sums[i]

        for i, name in enumerate(PHI_NAMES):
            comp[name + '_cost'] = P['cost'][name] * phi[i]

        T = time_period(V)
        T_ref = time_period(P['ref'])
        comp['time_cost'] = P['cost']['t_f'] * (T - T_ref) ** 2

        comp['power_cost'] = P['cost']['power'] * (-1.) * e_final_scaled(V, P) / T
        if kite_dof == 6:
            betas = torch.func.vmap(kite_betas, in_dims=(None, 0, None))(
                model, coll_vecs, P['theta0'])
            beta_sq = torch.sum(betas ** 2, dim=1)
            comp['beta_cost'] = P['cost']['beta'] / normalization['beta'] \
                * (const(int_w_tiled, V) @ beta_sq)
        else:
            comp['beta_cost'] = 0.

        comp['tracking_problem_cost'] = comp['tracking_cost']
        comp['power_problem_cost'] = comp['power_cost']
        comp['general_problem_cost'] = (
            comp['fictitious_cost'] + comp['u_regularisation_cost']
            + comp['xdot_regularisation_cost'] + comp['theta_regularisation_cost']
            + comp['beta_cost'] + comp['time_cost'])
        comp['homotopy_cost'] = sum(comp[name + '_cost'] for name in PHI_NAMES)
        return comp

    psi_i = PHI_NAMES.index('psi')

    def f_fn(V, P):
        comp = cost_components(V, P)
        phi = vstruct.get_phi(V)
        psi = phi[psi_i]
        return psi * comp['tracking_problem_cost'] \
            + (1. - psi) * comp['power_problem_cost'] \
            + comp['general_problem_cost'] + comp['homotopy_cost']

    return OCP(model=model, vstruct=vstruct, coll=coll, options=options,
               n_k=n_k, d=d, phase_idx=phase_idx, switch_kdx=switch_kdx,
               f_fn=f_fn, eq_fn=eq_fn, ineq_fn=ineq_fn,
               eq_slices=eq_slices, ineq_slices=ineq_slices,
               n_eq=n_eq_total, n_ineq=n_ineq_total,
               time_period_fn=time_period, tf_per_k_fn=tf_per_k,
               e_final_si_fn=e_final_si,
               cost_components_fn=cost_components,
               keep_rows=keep_rows, periodic_idx=periodic_idx,
               cat_mask_matrix=cat_mask_matrix,
               normalization=normalization,
               single_reelout=single_reelout, periodic=True,
               assemble_nodes_fn=assemble_nodes)
