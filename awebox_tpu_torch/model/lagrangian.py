"""Lagrangian mechanics for tree-structured tethered-kite systems (PyTorch).

Counterpart of ``awebox_tpu/model/lagrangian.py``: the Euler-Lagrange terms
come from ``torch.func.grad`` (generalized-momentum gradient) and a
``torch.func.jvp``-based total-time-derivative operator (d/dt terms), applied
to a scalar Lagrangian written in plain torch.

All functions take a single flat "model variables" vector ``v`` (scaled),
laid out by a :class:`~awebox_tpu_torch.model.vars.VarLayout` as
[x, xdot, u, z, theta]. Every op here has forward-mode, reverse-mode and
batching rules, and nothing writes in place, so the structured derivatives
can nest ``hessian`` over ``jvp(jvp(grad(...)))`` under ``vmap``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from . import tether


def const(x, like):
    """numpy constant as a tensor with ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=like.dtype,
                           device=like.device)


def skew(omega):
    """The cross-product matrix of a 3-vector: skew(w) @ a = w x a."""
    wx, wy, wz = omega[0], omega[1], omega[2]
    zero = torch.zeros_like(wx)
    return torch.stack([torch.stack([zero, -wz, wy]),
                        torch.stack([wz, zero, -wx]),
                        torch.stack([-wy, wx, zero])])


def make_splitters(layout, scaling):
    """Build (split, to_si) helpers for the flat model-variables vector."""
    offsets = layout.type_offsets
    scale_full = np.concatenate([
        np.asarray(scaling[t]) if layout.dims[t] else np.zeros(0)
        for t in ('x', 'xdot', 'u', 'z', 'theta')])

    def split(v):
        return {t: v[offsets[t]:offsets[t] + layout.dims[t]]
                for t in ('x', 'xdot', 'u', 'z', 'theta')}

    def to_si(v):
        vs = v * const(scale_full, v)
        parts = split(vs)
        return {t: layout.unpack(t, parts[t]) for t in parts}

    return split, to_si, scale_full


def make_time_derivative(layout, scaling, arch, kite_dof):
    """Total-time-derivative operator d/dt along the trajectory.

    For an expression f(v) of the scaled model variables, df/dt is the jvp of
    f in the tangent direction where each scaled state s moves with the rate
    named 'd'+s, taken from the state or control of that name when one exists
    and from the xdot variables otherwise (the reference package's choice,
    which fixes the Jacobian structure of gddot). A 6-DOF kite's DCM state r
    moves with R skew(omega) instead. All other variables are frozen. The
    tangent is assembled out of place with ``torch.cat`` so that the outer
    transforms can trace through it.
    """
    x_off = layout.type_offsets['x']
    nx = layout.dims['x']
    total = layout.total_dim
    scale_x = np.asarray(scaling['x'])

    # DCM states of 6-DOF kites: name -> (absolute slice of omega, omega's
    # scale, r's scale)
    dcm = {}
    if kite_dof == 6:
        for kite in arch.kite_nodes:
            label = arch.node_label(kite)
            om_rel = layout.slices['x']['omega' + label]
            r_rel = layout.slices['x']['r' + label]
            dcm['r' + label] = (slice(x_off + om_rel.start, x_off + om_rel.stop),
                                scale_x[om_rel], scale_x[r_rel])

    # per x entry, in x order: ('rate', absolute source slice in v, scale
    # ratio) or ('dcm', absolute slice of r, omega's slice, scales)
    routes = []
    for name, dim in layout.entries['x']:
        dst = layout.slices['x'][name]
        if name in dcm:
            om_abs, om_scale, r_scale = dcm[name]
            routes.append(('dcm', slice(x_off + dst.start, x_off + dst.stop),
                           om_abs, om_scale, r_scale))
            continue
        dname = 'd' + name
        if layout.has('x', dname):
            src_type = 'x'
        elif layout.has('u', dname):
            src_type = 'u'
        else:
            src_type = 'xdot'
        src_rel = layout.slices[src_type][dname]
        src_abs = slice(layout.type_offsets[src_type] + src_rel.start,
                        layout.type_offsets[src_type] + src_rel.stop)
        ratio = np.asarray(scaling[src_type])[src_rel] / scale_x[dst]
        routes.append(('rate', src_abs, ratio))

    def piece(v, route):
        if route[0] == 'rate':
            return v[route[1]] * const(route[2], v)
        _, r_abs, om_abs, om_scale, r_scale = route
        R = (v[r_abs] * const(r_scale, v)).reshape(3, 3)
        omega_si = v[om_abs] * const(om_scale, v)
        dr_si = (R @ skew(omega_si)).reshape(9)
        return dr_si / const(r_scale, v)

    def tangent(v):
        pieces = [torch.zeros(x_off, dtype=v.dtype, device=v.device)]
        pieces += [piece(v, route) for route in routes]
        pieces.append(torch.zeros(total - x_off - nx, dtype=v.dtype,
                                  device=v.device))
        return torch.cat(pieces)

    def time_derivative(f: Callable):
        def df(v):
            return torch.func.jvp(f, (v,), (tangent(v),))[1]
        return df

    return time_derivative


# --- energies --------------------------------------------------------------

def reelout_speed(si):
    q10 = si['x']['q10']
    ehat = q10 / torch.sqrt(q10 @ q10 + 1e-16)
    return si['x']['dq10'] @ ehat


def node_kinetic_energies(cfg, si, theta0, arch) -> Dict[str, torch.Tensor]:
    out = {}
    for node in range(1, arch.number_of_nodes):
        label = arch.node_label(node)
        props = tether.segment_properties(cfg, si, theta0, arch, node)
        mass_segment = props['seg_mass']
        dq_node = si['x']['dq' + label]
        if node == 1:
            q10 = si['x']['q10']
            ehat = q10 / torch.sqrt(q10 @ q10 + 1e-16)
            dq_parent = reelout_speed(si) * ehat
        else:
            dq_parent = si['x']['dq' + arch.parent_label(node)]
        e_kin_trans = 0.5 * mass_segment / 3. * (
            dq_node @ dq_node + dq_parent @ dq_parent + dq_node @ dq_parent)
        out['tether' + label] = e_kin_trans

        if node in arch.kite_nodes:
            m_k = theta0['geometry']['m_k']
            out['kite_trans' + label] = 0.5 * m_k * (dq_node @ dq_node)
            if cfg['kite_dof'] == 6:
                omega = si['x']['omega' + label]
                J = theta0['geometry']['j']
                out['kite_rot' + label] = 0.5 * omega @ (J @ omega)
    return out


def node_potential_energies(cfg, si, theta0, arch) -> Dict[str, torch.Tensor]:
    out = {}
    gravity = theta0['atmosphere']['g']
    for node in range(1, arch.number_of_nodes):
        label = arch.node_label(node)
        q_node = si['x']['q' + label]
        if node == 1:
            q_mean = 0.5 * q_node
        else:
            q_mean = 0.5 * (q_node + si['x']['q' + arch.parent_label(node)])
        props = tether.segment_properties(cfg, si, theta0, arch, node)
        out['tether' + label] = gravity * props['seg_mass'] * q_mean[2]
        if node in arch.kite_nodes:
            out['kite' + label] = gravity * theta0['geometry']['m_k'] * q_node[2]
    return out


# --- holonomic constraints -------------------------------------------------

def tether_length_constraints(cfg, si, theta0, arch) -> Dict[str, torch.Tensor]:
    """g = 0.5(|q_n - q_p|^2 - l^2) per tether segment."""
    if cfg['cross_tether'] and arch.number_of_kites > 1:
        raise NotImplementedError('cross tethers are not ported')
    g = {}
    for node in range(1, arch.number_of_nodes):
        label = arch.node_label(node)
        q = si['x']['q' + label]
        if node == 1:
            seg = q
            if cfg['system_type'] == 'lift_mode':
                seg_length = si['x']['l_t'][0]
            else:
                seg_length = si['theta']['l_t'][0]
        elif node in arch.kite_nodes:
            seg = q - si['x']['q' + arch.parent_label(node)]
            seg_length = si['theta']['l_s'][0]
        else:
            seg = q - si['x']['q' + arch.parent_label(node)]
            seg_length = si['theta']['l_i'][0]
        g['c' + label] = 0.5 * (seg @ seg - seg_length ** 2.)
    return g


def holonomic_names(cfg, arch):
    if cfg['cross_tether'] and arch.number_of_kites > 1:
        raise NotImplementedError('cross tethers are not ported')
    return ['c' + arch.node_label(n) for n in range(1, arch.number_of_nodes)]


def work_holonomic(cfg, si, theta0, arch):
    """sum_segments lambda * g."""
    g = tether_length_constraints(cfg, si, theta0, arch)
    total = 0.
    for name in holonomic_names(cfg, arch):
        lam_name = 'lambda' + name[1:]
        total = total + si['z'][lam_name][0] * g[name]
    return total
