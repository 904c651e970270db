"""Tether segment properties and drag models (PyTorch).

Counterpart of ``awebox_tpu/model/tether.py``: per-segment multi-element drag
with the elements as a leading tensor axis, split between the upper and lower
nodes by midpoint-rule lever arms.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import atmosphere, wind


def _const(x, like):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=like.dtype,
                           device=like.device)


def segment_endpoints(si, arch, upper_node):
    """(q_upper, q_lower, dq_upper, dq_lower) for the segment below node."""
    label = arch.node_label(upper_node)
    lower = arch.parent_map[upper_node]
    q_upper = si['x']['q' + label]
    dq_upper = si['x']['dq' + label]
    if lower == 0:
        q_lower = torch.zeros_like(q_upper)
        dq_lower = torch.zeros_like(dq_upper)
    else:
        plabel = arch.parent_label(upper_node)
        q_lower = si['x']['q' + plabel]
        dq_lower = si['x']['dq' + plabel]
    return q_upper, q_lower, dq_upper, dq_lower


def segment_diam(si, arch, upper_node):
    lower = arch.parent_map[upper_node]
    if lower == 0:
        return si['theta']['diam_t'][0]
    elif upper_node in arch.kite_nodes:
        return si['theta']['diam_s'][0]
    else:
        return si['theta']['diam_t'][0]


def segment_properties(cfg, si, theta0, arch, upper_node):
    """SI segment properties."""
    lower = arch.parent_map[upper_node]
    main = (lower == 0)
    secondary = upper_node in arch.kite_nodes

    q_upper, q_lower, _, _ = segment_endpoints(si, arch, upper_node)
    seg_vector = q_upper - q_lower
    seg_length = torch.sqrt(seg_vector @ seg_vector + 1e-16)

    seg_diam = segment_diam(si, arch, upper_node)
    density = theta0['tether']['rho']
    cross_section_area = np.pi * (seg_diam / 2.) ** 2.
    seg_mass = cross_section_area * density * seg_length

    if main:
        length_scaling_name = ('x', 'l_t') if cfg['system_type'] == 'lift_mode' else ('theta', 'l_t')
        diam_name = 'diam_t'
    elif secondary:
        length_scaling_name = ('theta', 'l_s')
        diam_name = 'diam_s'
    else:
        length_scaling_name = ('theta', 'l_i')
        diam_name = 'diam_t'

    return {
        'seg_length': seg_length,
        'seg_diam': seg_diam,
        'cross_section_area': cross_section_area,
        'seg_mass': seg_mass,
        'density': density,
        'length_scaling_name': length_scaling_name,
        'diam_name': diam_name,
    }


def reynolds_number(cfg, theta0, zz, ua_norm, diam):
    rho = atmosphere.get_density(cfg['atmosphere_model'], theta0['atmosphere'], zz)
    mu = atmosphere.get_viscosity(cfg['atmosphere_model'], theta0['atmosphere'], zz)
    return rho * ua_norm * diam / mu


def _step_in_out(x, lb, ub, eps):
    """Smooth indicator of lb < x < ub."""
    step_in = torch.atan((x - lb) / eps) / np.pi + 0.5
    step_out = torch.atan((x - ub) / eps) / np.pi + 0.5
    return step_in - step_out


def drag_coefficient(cfg, theta0, reynolds):
    """cd(Re) per the selected model: 'constant' uses theta0.tether.cd;
    'piecewise' is Roshko's unit steps of linear fits (Stokes regime,
    laminar plateau, laminar separation, level, drag crisis, turbulent
    separation, high-Re plateau), smoothed with arctan steps in log10(Re);
    'polyfit' uses the same curve (the reference's polyfit interpolates the
    piecewise fit)."""
    model = cfg.get('tether_cd_model', 'constant')
    if model == 'constant':
        return theta0['tether']['cd']
    if model not in ('piecewise', 'polyfit'):
        raise ValueError(f'invalid tether cd model {model!r}')
    eps = cfg.get('tether_reynolds_smoothing', 1e-4)
    re = torch.clamp(reynolds, min=1.0)
    log_re = torch.log10(re)
    segs = [
        (0.0, 2.0, 100. / re),
        (2.0, 4.0, torch.ones_like(re)),
        (4.0, 4.3, 1.02198077356237e-5 * re + 1.01141242),
        (4.3, 5.26, -1.03659206648679e-7 * re + 1.2046901692),
        (5.26, 5.74, -3.28441892597317e-6 * re + 1.8415437577),
        (5.74, 7.0, 7.10799367510221e-8 * re + 0.2824178662),
        (7.0, 10.0, 0.8 * torch.ones_like(re)),
    ]
    cd = 0.
    for lb, ub, val in segs:
        cd = cd + _step_in_out(log_re, lb, ub, eps) * val
    return cd


def element_drag(cfg, theta0, q_upper, q_lower, dq_upper, dq_lower, diam):
    """Drag force of tether elements, vectorized over a leading element axis
    of the q/dq arguments."""
    q_avg = 0.5 * (q_upper + q_lower)
    zz = q_avg[..., 2]
    uw = wind.get_velocity(cfg['wind_model'], theta0['wind'], zz)
    dq_avg = 0.5 * (dq_upper + dq_lower)
    ua = uw - dq_avg

    eps = 1.e-6
    ua_norm = torch.sqrt(torch.sum(ua ** 2, dim=-1) + eps ** 2)
    ehat_ua = ua / ua_norm[..., None]

    tether = q_upper - q_lower
    length_sq = torch.sum(tether ** 2, dim=-1)
    length_parallel = torch.sum(tether * ehat_ua, dim=-1)
    length_perp = torch.sqrt(torch.clamp(length_sq - length_parallel ** 2, min=0.)
                             + eps ** 4)

    cd = drag_coefficient(cfg, theta0, reynolds_number(cfg, theta0, zz, ua_norm, diam))
    cd = cd[..., None] if cd.ndim else cd
    rho = atmosphere.get_density(cfg['atmosphere_model'], theta0['atmosphere'], zz)
    drag = cd * 0.5 * rho[..., None] * ua_norm[..., None] * diam \
        * length_perp[..., None] * ua
    return drag


def distributed_segment_forces(cfg, si, theta0, arch, upper_node, n_elements):
    """(force_lower, force_upper) from n_elements element drags attributed by
    midpoint-rule lever arms."""
    q_top, q_bot, dq_top, dq_bot = segment_endpoints(si, arch, upper_node)
    diam = segment_diam(si, arch, upper_node)

    phi_lower = _const(np.arange(n_elements) / n_elements, q_top)
    phi_upper = _const((np.arange(n_elements) + 1) / n_elements, q_top)
    q_lower = q_bot[None, :] + (q_top - q_bot)[None, :] * phi_lower[:, None]
    q_upper = q_bot[None, :] + (q_top - q_bot)[None, :] * phi_upper[:, None]
    dq_lower = dq_bot[None, :] + (dq_top - dq_bot)[None, :] * phi_lower[:, None]
    dq_upper = dq_bot[None, :] + (dq_top - dq_bot)[None, :] * phi_upper[:, None]

    drags = element_drag(cfg, theta0, q_upper, q_lower, dq_upper, dq_lower, diam)

    ds = 1.0 / n_elements
    s_grid = _const(np.linspace(0.5 * ds, 1 - 0.5 * ds, n_elements), q_top)
    force_upper = torch.sum(s_grid[:, None] * drags, dim=0)
    force_lower = torch.sum((1 - s_grid)[:, None] * drags, dim=0)
    return force_lower, force_upper


def tether_drag_forces(cfg, si, theta0, arch) -> Dict[str, torch.Tensor]:
    """Earth-frame drag force per node. Returns {'f{node}{parent}': (3,)}."""
    model = cfg['tether_drag_model']
    n_elements = cfg['tether_aero_elements']
    like = si['x']['q10']

    forces = {f'f{arch.node_label(n)}': torch.zeros_like(like)
              for n in range(1, arch.number_of_nodes)}

    if model == 'not_in_use':
        return forces

    for node in range(1, arch.number_of_nodes):
        if model == 'multi':
            lower, upper = distributed_segment_forces(cfg, si, theta0, arch, node, n_elements)
        elif model == 'split':
            lower, upper = distributed_segment_forces(cfg, si, theta0, arch, node, 1)
        elif model == 'kite_only':
            lower = torch.zeros_like(like)
            upper = torch.zeros_like(like)
            if node in arch.kite_nodes:
                _, up = distributed_segment_forces(cfg, si, theta0, arch, node, 1)
                upper = 0.5 * up
        else:
            raise ValueError(f'tether drag model {model} not supported')

        label = arch.node_label(node)
        forces['f' + label] = forces['f' + label] + upper
        parent = arch.parent_map[node]
        if parent > 0:
            plabel = arch.parent_label(node)
            forces['f' + plabel] = forces['f' + plabel] + lower

    return forces
