"""Orbit-geometry estimators for induction models: averaged / parent / frenet.

Counterpart of ``awebox_tpu/model/aero/geometry.py``: the rotation center
and center velocity of a kite layer, selected by model.aero.geometry.model
('averaged' by default).

- averaged: center = mean of kite positions
- parent:   center = parent-node position
- frenet:   per-kite osculating-circle center from the Frenet frame,
            averaged over kites. Terms needing the third time derivative
            (trajectory torsion) are not representable with the available
            states and are dropped from the center velocity.
"""
from __future__ import annotations

import torch


def _smooth_norm(v, eps=1e-8):
    return torch.sqrt(v @ v + eps ** 2)


def _frenet_center_and_velocity(si, arch, kite):
    label = arch.node_label(kite)
    q = si['x']['q' + label]
    v = si['x']['dq' + label]                     # gamma'
    a = si['xdot']['ddq' + label]                 # gamma''
    v_norm = _smooth_norm(v)
    t_hat = v / v_norm
    a_perp = a - (a @ t_hat) * t_hat
    a_perp_norm = _smooth_norm(a_perp)
    e2 = a_perp / a_perp_norm                     # principal normal
    radius = v_norm ** 2 / a_perp_norm            # |v|^3/|v x a| = v^2/|a_perp|
    center = q + radius * e2

    # center velocity, jerk-free part: d/dt(q + R e2) with de2/dt restricted
    # to the curvature rotation -|a_perp|/|v| t_hat (torsion dropped)
    de2_dt = -(a_perp_norm / v_norm) * t_hat
    dcenter = v + radius * de2_dt
    return center, dcenter


def center_and_velocity(model_name: str, si, arch, layer):
    """(center, dcenter) of the layer's rotation plane per the selected
    geometry model."""
    kites = arch.kites_map[layer]
    if model_name == 'averaged':
        qs = torch.stack([si['x']['q' + arch.node_label(k)] for k in kites])
        dqs = torch.stack([si['x']['dq' + arch.node_label(k)] for k in kites])
        return torch.mean(qs, dim=0), torch.mean(dqs, dim=0)
    if model_name == 'parent':
        if layer == 0:
            like = si['x']['q' + arch.node_label(kites[0])]
            return torch.zeros_like(like), torch.zeros_like(like)
        label = arch.node_label(layer)
        return si['x']['q' + label], si['x']['dq' + label]
    if model_name == 'frenet':
        centers = []
        dcenters = []
        for k in kites:
            c, dc = _frenet_center_and_velocity(si, arch, k)
            centers.append(c)
            dcenters.append(dc)
        return (torch.mean(torch.stack(centers), dim=0),
                torch.mean(torch.stack(dcenters), dim=0))
    raise ValueError(f'unknown geometry model {model_name!r}')
