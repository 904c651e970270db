"""Atmosphere models (ISA / uniform / log_wind-constant) as PyTorch functions.

Counterpart of ``awebox_tpu/model/atmosphere.py``. Parameters come in as a
dict of tensors (from params.atmosphere) so a batch of scenarios can carry
its own values along a vmapped axis.
"""
from __future__ import annotations

import torch


def get_temperature(model: str, params, zz):
    if model in ('isa', 'windshear', 'datafile'):
        return params['t_ref'] - params['gamma_air'] * zz
    elif model in ('log_wind', 'uniform'):
        return params['t_ref'] * torch.ones_like(zz)
    raise ValueError(f'unsupported atmosphere model {model}')


def get_density(model: str, params, zz):
    if model == 'isa':
        t = get_temperature(model, params, zz)
        return params['rho_ref'] * (t / params['t_ref']) ** (
            params['g'] / params['gamma_air'] / params['r'] - 1.0)
    elif model in ('log_wind', 'uniform'):
        return params['rho_ref'] * torch.ones_like(zz)
    raise ValueError(f'unsupported atmosphere model {model}')


def get_viscosity(model: str, params, zz):
    if model in ('isa', 'datafile'):
        t = get_temperature(model, params, zz)
        return params['mu_ref'] * (params['t_ref'] + params['c_sutherland']) / (
            t + params['c_sutherland']) * (t / params['t_ref']) ** 1.5
    elif model in ('log_wind', 'uniform'):
        return params['mu_ref'] * torch.ones_like(zz)
    raise ValueError(f'unsupported atmosphere model {model}')
