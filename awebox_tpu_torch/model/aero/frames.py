"""Reference frames and conversions for kite aerodynamics (PyTorch).

Counterpart of ``awebox_tpu/model/aero/frames.py``:
  earth   : inertial, wind along +x, z up
  body    : kite DCM columns (ehat1 chord LE->TE, ehat2 span, ehat3 up)
  control : body with x and z negated (flight-dynamics convention)
  wind    : drag/side/lift axes from the apparent air velocity

The kite DCM is stored as a row-major 9-vector: ``R = r.reshape(3, 3)`` with
columns ehat1, ehat2, ehat3 expressed in the earth frame. All conversions are
orthonormal-matrix transposes.
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


def smooth_normed_cross(a, b, eps=1e-8):
    return smooth_normalize(cross(a, b), eps)


def get_wind_dcm(vec_u, kite_dcm):
    """[Dhat, Shat, Lhat] columns from apparent velocity and kite span."""
    ehat_span = kite_dcm[:, 1]
    Dhat = smooth_normalize(vec_u)
    Lhat = smooth_normed_cross(vec_u, ehat_span)
    Shat = smooth_normed_cross(Lhat, Dhat)
    return torch.stack([Dhat, Shat, Lhat], dim=1)


def _control_signs(like):
    return torch.tensor([-1., 1., -1.], dtype=like.dtype, device=like.device)


def from_body_to_earth(kite_dcm, vector):
    return kite_dcm @ vector


def from_earth_to_body(kite_dcm, vector):
    return kite_dcm.T @ vector


def from_body_to_control(vector):
    return _control_signs(vector) * vector


def from_control_to_body(vector):
    return _control_signs(vector) * vector


def from_control_to_earth(kite_dcm, vector):
    return from_body_to_earth(kite_dcm, from_control_to_body(vector))


def from_earth_to_control(kite_dcm, vector):
    return from_body_to_control(from_earth_to_body(kite_dcm, vector))


def from_wind_to_earth(vec_u, kite_dcm, vector):
    return get_wind_dcm(vec_u, kite_dcm) @ vector


def from_earth_to_wind(vec_u, kite_dcm, vector):
    return get_wind_dcm(vec_u, kite_dcm).T @ vector


def from_named_frame_to_earth(name, vec_u, kite_dcm, vector):
    if name == 'earth':
        return vector
    if name == 'body':
        return from_body_to_earth(kite_dcm, vector)
    if name == 'control':
        return from_control_to_earth(kite_dcm, vector)
    if name == 'wind':
        return from_wind_to_earth(vec_u, kite_dcm, vector)
    raise ValueError(f'unknown frame {name}')


def from_named_frame_to_body(name, vec_u, kite_dcm, vector):
    if name == 'body':
        return vector
    if name == 'control':
        return from_control_to_body(vector)
    return from_earth_to_body(kite_dcm, from_named_frame_to_earth(name, vec_u, kite_dcm, vector))
