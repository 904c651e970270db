"""Wind profile models (log / power-law / uniform) as PyTorch functions.

Counterpart of ``awebox_tpu/model/wind.py``. The wind blows along +x.
Parameters (u_ref, z_ref, z0_air, exp_ref) come in as a dict of tensors so a
wind-speed sweep is one vmapped axis. The measured-profile ('datafile') model
is not ported yet.
"""
from __future__ import annotations

import torch


def smooth_abs(x, epsilon=1.0):
    return torch.sqrt(x ** 2 + epsilon ** 2)


def get_speed(model: str, params, zz):
    z_cropped = smooth_abs(zz, 1.0)
    if model == 'log_wind':
        return params['u_ref'] * torch.log10(z_cropped / params['z0_air']) \
            / torch.log10(params['z_ref'] / params['z0_air'])
    elif model == 'power':
        return params['u_ref'] * (z_cropped / params['z_ref']) ** params['exp_ref']
    elif model == 'uniform':
        return params['u_ref'] * torch.ones_like(zz)
    elif model == 'datafile':
        raise NotImplementedError("wind model 'datafile' is not ported")
    raise ValueError(f'unsupported wind model {model}')


def get_velocity(model: str, params, zz):
    """3-vector wind velocity at altitude zz, along +x."""
    u = get_speed(model, params, zz)
    return torch.stack([u, torch.zeros_like(u), torch.zeros_like(u)], dim=-1)
