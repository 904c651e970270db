"""Polynomial stability-derivative evaluation (PyTorch).

Counterpart of ``awebox_tpu/model/aero/stability_derivatives.py``. Evaluates
force/moment coefficient tables ``stab_derivs[Ccoeff][input] = [c0, c1, ...]``
meaning the contribution ``(c0 + c1*alpha + c2*alpha^2 + ...) * input`` to the
coefficient, with inputs alpha, beta, normalized body rates p, q, r and
surface deflections. The 6-DOF kite model uses it; the 3-DOF model does not.
"""
from __future__ import annotations

import torch

from . import frames

FORCE_COEFFS_BY_FRAME = {
    'control': ['CX', 'CY', 'CZ'],
    'earth': ['Cx', 'Cy', 'Cz'],
    'body': ['CA', 'CY', 'CN'],
    'wind': ['CD', 'CS', 'CL'],
}
MOMENT_COEFFS_BY_FRAME = {'control': ['Cl', 'Cm', 'Cn']}

MOMENT_COEFF_NAMES = ('Cl', 'Cm', 'Cn')
DEFLECTION_INPUTS = ('deltaa', 'deltae', 'deltar')


def collect_inputs(alpha, beta, airspeed, omega, delta, geometry, named_frame):
    """Input dict for the derivative tables; omega is in body frame."""
    if named_frame == 'control':
        omega = frames.from_body_to_control(omega)
        beta = -beta

    omega_hat = omega / (2. * airspeed)
    lengths = torch.stack([geometry['b_ref'], geometry['c_ref'], geometry['b_ref']])
    omega_hat = omega_hat * lengths

    return {
        '0': torch.ones((), dtype=omega.dtype, device=omega.device),
        'alpha': alpha, 'beta': beta,
        'p': omega_hat[0], 'q': omega_hat[1], 'r': omega_hat[2],
        'deltaa': delta[0], 'deltae': delta[1], 'deltar': delta[2],
    }


def evaluate(stab_derivs_structure, alpha, beta, airspeed, omega, delta,
             theta0, force_frame, moment_frame):
    """Returns (CF_3vec, CM_3vec) in their declared frames.

    stab_derivs_structure: static dict coeff -> list of input names.
    theta0['aero']['stab_derivs'][coeff][input]: coefficient stacks.
    """
    geometry = theta0['geometry']
    tables = theta0['aero']['stab_derivs']
    moment_factor = theta0['aero']['moment_factor']

    inputs = collect_inputs(alpha, beta, airspeed, omega, delta, geometry,
                            force_frame)
    if moment_frame != force_frame:
        moment_inputs = collect_inputs(alpha, beta, airspeed, omega, delta,
                                       geometry, moment_frame)
    else:
        moment_inputs = inputs

    coeffs = {}
    for coeff_name, input_names in stab_derivs_structure.items():
        if coeff_name == 'frame':
            continue
        use_inputs = moment_inputs if coeff_name in MOMENT_COEFF_NAMES else inputs
        alpha_val = use_inputs['alpha']
        total = 0.
        for input_name in input_names:
            stack = tables[coeff_name][input_name]
            # contribution = sum_l stack[l] * input * alpha^l; built by
            # cumprod, NOT alpha**arange: d/da a**0 is NaN at a=0 under AD
            if stack.shape[0] == 1:
                alpha_powers = torch.ones_like(stack)
            else:
                alpha_powers = torch.cumprod(torch.cat(
                    [torch.ones_like(stack[:1]),
                     alpha_val.expand(stack.shape[0] - 1)]), dim=0)
            is_weighted = (coeff_name in MOMENT_COEFF_NAMES
                           and input_name in DEFLECTION_INPUTS)  # static
            weight = moment_factor if is_weighted else 1.0
            total = total + weight * torch.sum(stack * alpha_powers) * use_inputs[input_name]
        coeffs[coeff_name] = total

    zero = torch.zeros((), dtype=omega.dtype, device=omega.device)
    CF = torch.stack([coeffs[c] for c in FORCE_COEFFS_BY_FRAME[force_frame]])
    CM_names = MOMENT_COEFFS_BY_FRAME[moment_frame]
    CM = torch.stack([coeffs.get(c, zero) for c in CM_names])
    return CF, CM
