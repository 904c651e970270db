"""Induction manager: lifted induced velocities with iota-homotopy blend.

Counterpart of ``awebox_tpu/model/aero/induction.py``. Per kite, a lifted
algebraic variable ``ui{kite}{parent}`` carries the induced velocity; the
model equality blends the trivial residual (ui = 0) with the physical model
residual through the homotopy parameter iota:

    resi = iota * (ui - 0) + (1 - iota) * (ui - ui_model)

Comparison mode builds several actuator variants at once: the variable set
carries one induction-factor block per comparison label, and ``ui`` follows
the primary label chosen by the user options.
"""
from __future__ import annotations

import torch

from . import actuator


def actuator_labels(cfg):
    """Comparison labels like ['qaxi'] or ['qaxi', 'uaxi']."""
    return cfg.get('act_comparison_labels', [])


def primary_label(cfg):
    return cfg.get('act_primary_label', 'qaxi')


def residual_names_and_dims(cfg, arch):
    """(name, dim) rows contributed to the model equality block, in order."""
    rows = []
    for kite in arch.kite_nodes:
        rows.append(('induction' + arch.node_label(kite), 3))
    for layer in arch.layer_nodes:
        for label in actuator_labels(cfg):
            rows.append((f'actuator_{label}{layer}', 3 if 'asym' in label else 1))
    return rows


def residuals(cfg, si, theta0, arch, phi_iota, f_earth, scaling_refs):
    """Stacked induction equality residuals (order of
    residual_names_and_dims)."""
    res = []
    label = primary_label(cfg)
    force_zero = cfg.get('act_force_zero', False)
    u_ref = scaling_refs['u_ref']
    for kite in arch.kite_nodes:
        ui = si['z']['ui' + arch.node_label(kite)]
        if force_zero:
            ui_model = torch.zeros_like(ui)
        else:
            ui_model = actuator.induced_velocity_at_kite(
                cfg, si, theta0, arch, kite, label)
        res.append((phi_iota * ui + (1. - phi_iota) * (ui - ui_model)) / u_ref)
    for layer in arch.layer_nodes:
        for lbl in actuator_labels(cfg):
            res.append(actuator.residuals_for_layer(
                cfg, si, theta0, arch, layer, lbl, f_earth, scaling_refs))
    return torch.cat([torch.atleast_1d(r) for r in res])


def collect_outputs(cfg, si, theta0, arch, f_earth):
    out = {}
    for kite in arch.kite_nodes:
        out['ui' + str(kite)] = si['z']['ui' + arch.node_label(kite)]
    for lbl in actuator_labels(cfg):
        out.update(actuator.collect_outputs(cfg, si, theta0, arch, lbl, f_earth))
    return out
