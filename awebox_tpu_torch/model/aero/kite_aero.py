"""Kite aerodynamic forces, moments and indicator outputs (PyTorch).

Counterpart of ``awebox_tpu/model/aero/kite_aero.py``: per-kite forces in
the earth frame from either the 3-DOF roll-control model (coeff = [CL, psi])
or the 6-DOF stability-derivative model (moments in the body frame), plus
the outputs the flight-envelope constraints read (airspeed, alpha/beta,
aero-validity residuals) and the power-balance bookkeeping, with the lifted
induced velocity in the apparent velocity when an induction model is on.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import atmosphere, wind
from . import frames, stability_derivatives


def get_alpha(ua, kite_dcm):
    """Small-angle AoA: (ua.ehat3)/|ua.ehat1|."""
    x_comp = frames.smooth_norm(torch.atleast_1d(ua @ kite_dcm[:, 0]))
    return (ua @ kite_dcm[:, 2]) / x_comp


def get_beta(ua, kite_dcm):
    x_comp = frames.smooth_norm(torch.atleast_1d(ua @ kite_dcm[:, 0]))
    return (ua @ kite_dcm[:, 1]) / x_comp


def get_u_eff_earth(cfg, si, theta0, arch, kite):
    """Effective air velocity at the kite in the earth frame: the apparent
    velocity u_wind(z) - dq, plus the lifted induced velocity ui when an
    induction model is active."""
    label = arch.node_label(kite)
    q = si['x']['q' + label]
    dq = si['x']['dq' + label]
    uw = wind.get_velocity(cfg['wind_model'], theta0['wind'], q[2])
    u_app = uw - dq
    if cfg.get('induction_lifted', False):
        u_app = u_app + si['z']['ui' + label]
    return u_app


def get_kite_dcm_3dof(cfg, si, theta0, arch, kite):
    """Roll-controlled DCM from apparent velocity, tether direction, and the
    roll angle coeff[1]."""
    label = arch.node_label(kite)
    parent = arch.parent_map[kite]
    vec_u_eff = get_u_eff_earth(cfg, si, theta0, arch, kite)

    q_node = si['x']['q' + label]
    if parent == 0:
        vec_t = q_node
    else:
        vec_t = q_node - si['x']['q' + arch.parent_label(kite)]

    vec_v = frames.cross(vec_t, vec_u_eff)
    vec_w = frames.cross(vec_u_eff, vec_v)
    uhat = frames.smooth_normalize(vec_u_eff)
    vhat = frames.smooth_normalize(vec_v)
    what = frames.smooth_normalize(vec_w)

    psi = si['x']['coeff' + label][1]
    ehat1 = uhat
    ehat2 = torch.cos(psi) * vhat + torch.sin(psi) * what
    ehat3 = torch.cos(psi) * what - torch.sin(psi) * vhat
    return torch.stack([ehat1, ehat2, ehat3], dim=1)


def forces_and_outputs(cfg, si, theta0, arch):
    """Per-kite aero forces (earth frame), moments (body frame), outputs.

    Returns (f_earth: {kite: (3,)}, m_body: {kite: (3,)}, outputs: dict).
    """
    kite_dof = cfg['kite_dof']
    outputs = {'aerodynamics': {}, 'aero_validity': {}, 'power_balance': {}}
    f_earth = {}
    m_body = {}

    for kite in arch.kite_nodes:
        label = arch.node_label(kite)
        q = si['x']['q' + label]
        rho = atmosphere.get_density(cfg['atmosphere_model'], theta0['atmosphere'], q[2])
        vec_u = get_u_eff_earth(cfg, si, theta0, arch, kite)
        airspeed = frames.smooth_norm(vec_u)

        if kite_dof == 3:
            kite_dcm = get_kite_dcm_3dof(cfg, si, theta0, arch, kite)
            coeff = si['x']['coeff' + label]
            CL = coeff[0]
            CD = float(cfg['CD0']) + CL ** 2 / float(np.pi * cfg['geometry_static']['ar'])
            s_ref = theta0['geometry']['s_ref']
            Lhat = kite_dcm[:, 2]
            f_lift = CL * 0.5 * rho * (vec_u @ vec_u) * s_ref * Lhat
            f_drag = CD * 0.5 * rho * airspeed * s_ref * vec_u
            f_aero_earth = f_lift + f_drag
            m_aero_body = torch.zeros_like(f_aero_earth)
            alpha = get_alpha(vec_u, kite_dcm)
            beta = get_beta(vec_u, kite_dcm)
            outputs['aerodynamics']['CL' + str(kite)] = CL
            outputs['aerodynamics']['CD' + str(kite)] = CD
            # lift/drag split for the power balance
            f_lift_earth, f_drag_earth = f_lift, f_drag
            f_side_earth = torch.zeros_like(f_lift)
        else:
            kite_dcm = si['x']['r' + label].reshape(3, 3)
            omega = si['x']['omega' + label]
            if cfg['surface_control'] == 0:
                delta = si['u']['delta' + label]
            else:
                delta = si['x']['delta' + label]
            alpha = get_alpha(vec_u, kite_dcm)
            beta = get_beta(vec_u, kite_dcm)
            CF, CM = stability_derivatives.evaluate(
                cfg['stab_derivs_structure'], alpha, beta, airspeed, omega,
                delta, theta0, cfg['force_frame'], cfg['moment_frame'])
            dyn_pressure = 0.5 * rho * (vec_u @ vec_u)
            s_ref = theta0['geometry']['s_ref']
            force_found = CF * dyn_pressure * s_ref
            ref_lengths = torch.stack([theta0['geometry']['b_ref'],
                                       theta0['geometry']['c_ref'],
                                       theta0['geometry']['b_ref']])
            moment_found = dyn_pressure * s_ref * (ref_lengths * CM)

            f_aero_earth = frames.from_named_frame_to_earth(
                cfg['force_frame'], vec_u, kite_dcm, force_found)
            m_aero_body = frames.from_named_frame_to_body(
                cfg['moment_frame'], vec_u, kite_dcm, moment_found)

            # wind-frame coefficients for indicators/quality
            f_wind = frames.from_earth_to_wind(vec_u, kite_dcm, f_aero_earth)
            CFw = f_wind / torch.clamp(dyn_pressure * s_ref, min=1e-12)
            outputs['aerodynamics']['CD' + str(kite)] = CFw[0]
            outputs['aerodynamics']['CS' + str(kite)] = CFw[1]
            outputs['aerodynamics']['CL' + str(kite)] = CFw[2]

            Dhat = frames.smooth_normalize(vec_u)
            Lhat = frames.smooth_normed_cross(vec_u, kite_dcm[:, 1])
            Shat = frames.smooth_normed_cross(Lhat, Dhat)
            f_drag_earth = (f_aero_earth @ Dhat) * Dhat
            f_side_earth = (f_aero_earth @ Shat) * Shat
            f_lift_earth = (f_aero_earth @ Lhat) * Lhat

        f_earth[kite] = f_aero_earth
        m_body[kite] = m_aero_body

        dq = si['x']['dq' + label]
        outputs['aerodynamics']['air_velocity' + str(kite)] = vec_u
        outputs['aerodynamics']['airspeed' + str(kite)] = airspeed
        outputs['aerodynamics']['alpha' + str(kite)] = alpha
        outputs['aerodynamics']['beta' + str(kite)] = beta
        outputs['aerodynamics']['alpha_deg' + str(kite)] = alpha * 180. / np.pi
        outputs['aerodynamics']['beta_deg' + str(kite)] = beta * 180. / np.pi
        outputs['aerodynamics']['dyn_pressure' + str(kite)] = 0.5 * rho * (vec_u @ vec_u)
        outputs['aerodynamics']['air_density' + str(kite)] = rho
        outputs['aerodynamics']['ehat_chord' + str(kite)] = kite_dcm[:, 0]
        outputs['aerodynamics']['ehat_span' + str(kite)] = kite_dcm[:, 1]
        outputs['aerodynamics']['ehat_up' + str(kite)] = kite_dcm[:, 2]
        outputs['aerodynamics']['f_aero_earth' + str(kite)] = f_aero_earth
        outputs['aerodynamics']['m_aero_body' + str(kite)] = m_body[kite]
        outputs['power_balance']['P_lift' + str(kite)] = f_lift_earth @ dq
        outputs['power_balance']['P_drag' + str(kite)] = f_drag_earth @ dq
        outputs['power_balance']['P_side' + str(kite)] = f_side_earth @ dq
        if kite_dof == 6:
            outputs['power_balance']['P_moment' + str(kite)] = m_body[kite] @ omega

        # aero-validity residuals, enforced as inequalities <= 0 when
        # cfg['aero_validity_include']
        av = cfg['aero_validity']
        tight = float(cfg['aero_validity_scaling'])
        airspeed_ref = float(cfg['airspeed_ref'])
        ehat1, ehat2, ehat3 = kite_dcm[:, 0], kite_dcm[:, 1], kite_dcm[:, 2]
        alpha_min = av['alpha_min_deg'] * np.pi / 180.
        alpha_max = av['alpha_max_deg'] * np.pi / 180.
        beta_min = av['beta_min_deg'] * np.pi / 180.
        beta_max = av['beta_max_deg'] * np.pi / 180.
        sm = lambda x: float(np.sqrt(x ** 2 + 1e-16))
        outputs['aero_validity']['alpha_ub' + str(kite)] = \
            ((vec_u @ ehat3) - (vec_u @ ehat1) * alpha_max) * tight / airspeed_ref / sm(alpha_max)
        outputs['aero_validity']['alpha_lb' + str(kite)] = \
            (-(vec_u @ ehat3) + (vec_u @ ehat1) * alpha_min) * tight / airspeed_ref / sm(alpha_min)
        outputs['aero_validity']['beta_ub' + str(kite)] = \
            ((vec_u @ ehat2) - (vec_u @ ehat1) * beta_max) * tight / airspeed_ref / sm(beta_max)
        outputs['aero_validity']['beta_lb' + str(kite)] = \
            (-(vec_u @ ehat2) + (vec_u @ ehat1) * beta_min) * tight / airspeed_ref / sm(beta_min)

    return f_earth, m_body, outputs
