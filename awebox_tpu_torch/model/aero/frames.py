"""Reference frames and conversions for kite aerodynamics (PyTorch).

Counterpart of the parts of ``awebox_tpu/model/aero/frames.py`` that the
3-DOF model and the stability-derivative tables read:
  earth   : inertial, wind along +x, z up
  body    : kite DCM columns (ehat1 chord LE->TE, ehat2 span, ehat3 up)
  control : body with x and z negated (flight-dynamics convention)
The wind-axis and named-frame conversions of the 6-DOF model are not
ported.
"""
from __future__ import annotations

import torch


def cross(a, b):
    """3-vector cross product written out elementwise: every op in it has
    forward- and reverse-mode and batching rules under torch.func."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def smooth_norm(v, eps=1e-8):
    return torch.sqrt(torch.sum(v ** 2) + eps ** 2)


def smooth_normalize(v, eps=1e-8):
    return v / smooth_norm(v, eps)


def _control_signs(like):
    return torch.tensor([-1., 1., -1.], dtype=like.dtype, device=like.device)


def from_body_to_control(vector):
    return _control_signs(vector) * vector
