"""Actuator-disk induction models (PyTorch).

Counterpart of ``awebox_tpu/model/aero/actuator.py``. The support quantities
of a layer (rotation center, disk normal, rotor frame, skew angle, annulus
radius and area, dynamic pressure) are closed-form functions of the state
evaluated inside the residual; the only lifted unknowns are the implicit
ones:

  - the induction factors ``a_{q|u}{axi|asym}{layer}`` (and ``acos_`` /
    ``asin_`` in the asymmetric variants): algebraic (q*) or dynamic
    Pitt-Peters states (u*),
  - the per-kite induced velocity ``ui{kite}{parent}``, handled by the
    induction manager (induction.py).

The variants: momentum theory (qaxi), steady Pitt-Peters (qasym), unsteady
Pitt-Peters in nondimensional time (uaxi, uasym), with the skew and
wake-angle corrections of the options.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import atmosphere, wind
from ..lagrangian import const
from . import frames
from . import geometry as geometry_mod

# Pitt-Peters apparent-mass matrix
MM_DIAG = np.array([1.69765, 0.113177, 0.113177])


def smooth_norm(v, eps=1e-8):
    return torch.sqrt(v @ v + eps ** 2)


def layer_support(cfg, si, theta0, arch, layer):
    """Closed-form actuator support quantities for one layer node: a dict
    with center/dcenter, n_hat, rotor frame (y_rotor, z_rotor), u_zero,
    qzero, gamma (cos/sin), per-kite (varrho, cospsi, sinpsi), bar_varrho,
    area and b_ref."""
    kites = arch.kites_map[layer]
    b_ref = theta0['geometry']['b_ref']

    center, dcenter = geometry_mod.center_and_velocity(
        cfg.get('act_geometry_model', 'averaged'), si, arch, layer)

    # normal vector (default tether_parallel)
    if cfg['act_normal_vector_model'] == 'xhat':
        n_hat = const([1., 0., 0.], center)
    else:
        if layer == 0:
            n_raw = center
        else:
            q_layer = si['x']['q' + arch.node_label(layer)]
            n_raw = q_layer if arch.parent_map[layer] == 0 \
                else q_layer - si['x']['q' + arch.node_label(arch.parent_map[layer])]
        n_hat = n_raw / smooth_norm(n_raw)

    # apparent velocity at the disk center
    u_infty = wind.get_velocity(cfg['wind_model'], theta0['wind'], center[2])
    u_zero = u_infty - dcenter
    u_mag = smooth_norm(u_zero)
    u_hat = u_zero / u_mag

    # skew angle gamma between u_zero and the disk normal
    cosgamma = u_hat @ n_hat
    u_perp = u_zero - (u_zero @ n_hat) * n_hat
    singamma = smooth_norm(u_perp) / u_mag

    # rotor frame: z along the in-plane wind component, y = n x z
    z_rotor = u_perp / smooth_norm(u_perp)
    y_rotor = frames.cross(n_hat, z_rotor)

    rho = atmosphere.get_density(cfg['atmosphere_model'], theta0['atmosphere'],
                                 center[2])
    qzero = 0.5 * rho * u_mag ** 2

    # annulus geometry
    varrho = {}
    cospsi = {}
    sinpsi = {}
    for k in kites:
        vec = si['x']['q' + arch.node_label(k)] - center
        r_in_plane = vec - (vec @ n_hat) * n_hat
        radius = smooth_norm(r_in_plane)
        varrho[k] = radius / b_ref
        cospsi[k] = (vec @ z_rotor) / radius
        sinpsi[k] = -(vec @ y_rotor) / radius
    if len(kites) == 1:
        bar_varrho = varrho[kites[0]]
    else:
        bar_varrho = sum(varrho.values()) / len(kites)
    area = 2. * np.pi * b_ref ** 2 * bar_varrho

    return {
        'kites': kites, 'center': center, 'dcenter': dcenter,
        'n_hat': n_hat, 'y_rotor': y_rotor, 'z_rotor': z_rotor,
        'u_zero': u_zero, 'u_mag': u_mag, 'qzero': qzero,
        'cosgamma': cosgamma, 'singamma': singamma,
        'varrho': varrho, 'cospsi': cospsi, 'sinpsi': sinpsi,
        'bar_varrho': bar_varrho, 'area': area, 'b_ref': b_ref,
    }


def get_a_vars(si, layer, label):
    """Lifted induction factors for one layer and actuator label."""
    holder = 'x' if label[0] == 'u' else 'z'
    a = si[holder]['a_' + label + str(layer)][0]
    if 'asym' in label:
        acos = si[holder]['acos_' + label + str(layer)][0]
        asin = si[holder]['asin_' + label + str(layer)][0]
        return a, acos, asin
    return a, None, None


def wake_angle_chi(cfg, a, sup):
    """Wake skew angle; default 'coleman'."""
    model = cfg['act_wake_skew']
    gamma = torch.atan2(sup['singamma'], sup['cosgamma'])
    if model == 'not_in_use':
        return 0. * gamma
    if model == 'equal':
        return gamma
    # coleman (default): chi = (0.6 a + 1) gamma
    return (0.6 * a + 1.) * gamma


def corr_val(cfg, a, sup, chi):
    """Skew correction factor; default 'simple'."""
    model = cfg['act_actuator_skew']
    if model == 'not_in_use':
        return 1. - a
    if model == 'glauert':
        return torch.sqrt(1. - a * (2. * sup['cosgamma'] - a))
    if model == 'coleman':
        return sup['cosgamma'] + torch.tan(chi / 2.) * sup['singamma'] \
            - a / torch.cos(chi / 2.) ** 2
    # 'simple' (default)
    return sup['cosgamma'] - a


def ll_matrix(corr, chi):
    """Pitt-Peters gain matrix."""
    th = torch.tan(chi / 2.)
    sh = 1. / torch.cos(chi / 2.)
    zero = torch.zeros_like(th)
    return torch.stack([
        torch.stack([0.25 / corr, zero, -0.368155 * th]),
        torch.stack([zero, -sh ** 2, zero]),
        torch.stack([0.368155 * th / corr, zero, -1. + th ** 2]),
    ])


def residuals_for_layer(cfg, si, theta0, arch, layer, label, f_earth,
                        scaling_refs):
    """Actuator residual rows for one (layer, label).

    scaling_refs: dict with 'thrust_ref' (z.f_aero scaling), 'moment_ref'
    (z.m_aero scaling), 'u_ref' (wind reference speed), 'a_ref',
    'varrho_ref' and 'b_ref'."""
    sup = layer_support(cfg, si, theta0, arch, layer)
    a, acos, asin = get_a_vars(si, layer, label)
    a_ref = scaling_refs['a_ref']
    thrust_ref = scaling_refs['thrust_ref']
    moment_ref = scaling_refs['moment_ref']

    # thrust and in-plane moments about the center
    thrust = 0.
    moment = torch.zeros_like(sup['center'])
    for k in sup['kites']:
        f = f_earth[k]
        thrust = thrust + f @ sup['n_hat']
        lever = si['x']['q' + arch.node_label(k)] - sup['center']
        moment = moment + frames.cross(lever, f)
    moment_y = moment @ sup['y_rotor']
    moment_z = moment @ sup['z_rotor']

    chi = wake_angle_chi(cfg, a, sup)
    corr = corr_val(cfg, a, sup, chi)
    thrust_den = sup['qzero'] * sup['area']

    if label == 'qaxi':
        # momentum theory: thrust = 4 corr (1 - a) qzero A
        resi = (thrust - 4. * corr * (1. - a) * thrust_den) / thrust_ref
        return torch.atleast_1d(resi)

    # unsteady variants: Pitt-Peters dynamics in nondimensional time
    # tau = t / t_star, t_star = b_ref (bar_varrho + 0.5) / |u_zero|; the
    # lifted states carry d(a)/dt in xdot
    t_num = sup['b_ref'] * (sup['bar_varrho'] + 0.5)
    t_den = sup['u_mag']
    t_num_ref = scaling_refs['b_ref'] * (scaling_refs['varrho_ref'] + 0.5)
    t_den_ref = scaling_refs['u_ref']

    if label == 'uaxi':
        # (the JAX package stacks the asymmetric modes, None here, before it
        # reaches this branch and raises; these rows are its formula)
        da = si['xdot']['da_' + label + str(layer)][0]
        term_1 = MM_DIAG[0] * da * t_num * thrust_den
        term_2 = 4. * corr * a * thrust_den * t_den
        term_3 = -thrust * t_den
        term_1_ref = MM_DIAG[0] * a_ref * t_num_ref * thrust_ref
        return torch.atleast_1d((term_1 + term_2 + term_3) / term_1_ref)

    radius_bar = sup['bar_varrho'] * sup['b_ref']
    moment_den = thrust_den * radius_bar
    c_all = torch.stack([thrust * radius_bar, moment_y, moment_z])
    LL = ll_matrix(corr, chi)
    a_all = torch.stack([a, acos, asin])

    if label == 'qasym':
        # steady Pitt-Peters
        term3_ref = 1. / (4. * a_ref * (1. - a_ref)) * moment_ref
        return (a_all * moment_den - LL @ c_all) / term3_ref

    # uasym
    da_all = torch.stack([
        si['xdot']['da_' + label + str(layer)][0],
        si['xdot']['dacos_' + label + str(layer)][0],
        si['xdot']['dasin_' + label + str(layer)][0],
    ])
    MM = torch.diag(const(MM_DIAG, da_all))
    term_1 = (LL @ (MM @ da_all)) * t_num * moment_den
    term_2 = a_all * moment_den * t_den
    term_3 = -(LL @ c_all) * t_den
    term_2_ref = a_ref * moment_ref * t_den_ref
    return (term_1 + term_2 + term_3) / term_2_ref


def local_induction_factor(cfg, si, arch, kite, label):
    """a at the kite location: (a, acos, asin, mu); mu = 1 evaluates the
    Fourier modes of the asymmetric variants at the annulus edge."""
    a, acos, asin = get_a_vars(si, arch.parent_map[kite], label)
    if 'asym' in label:
        return a, acos, asin, 1.
    return a, None, None, None


def induced_velocity_at_kite(cfg, si, theta0, arch, kite, label):
    """u_ind = -a_local |u_zero| n_hat."""
    sup = layer_support(cfg, si, theta0, arch, arch.parent_map[kite])
    a, acos, asin, mu = local_induction_factor(cfg, si, arch, kite, label)
    if 'asym' in label:
        a_local = a + acos * sup['cospsi'][kite] * mu \
            + asin * sup['sinpsi'][kite] * mu
    else:
        a_local = a
    return -a_local * sup['u_mag'] * sup['n_hat']


def collect_outputs(cfg, si, theta0, arch, label, f_earth):
    """Actuator diagnostics per layer."""
    out = {}
    for layer in arch.layer_nodes:
        sup = layer_support(cfg, si, theta0, arch, layer)
        a, _, _ = get_a_vars(si, layer, label)
        thrust = sum(f_earth[k] @ sup['n_hat'] for k in sup['kites'])
        s = str(layer)
        out['a_' + label + s] = a
        out['ct' + s] = thrust / (sup['qzero'] * sup['area'])
        out['area' + s] = sup['area']
        out['bar_varrho' + s] = sup['bar_varrho']
        out['gamma' + s] = torch.atan2(sup['singamma'], sup['cosgamma'])
        out['thrust' + s] = thrust
        out['u_zero_mag' + s] = sup['u_mag']
    return out
