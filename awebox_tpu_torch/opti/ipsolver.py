"""Interior-point helpers.

Counterpart of ``awebox_tpu/opti/ipsolver.py``. Only the fixed-variable
split that the batched refinement needs is ported; the host-driven robust
solver (filter line search, ladders, watchdog) is not.
"""
from __future__ import annotations

import numpy as np


class InteriorPointSolver:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'the host-driven interior-point solver is not ported; use '
            'awebox_tpu_torch.parallel.refine')

    @staticmethod
    def split_pins(lbw, ubw):
        """Detect fixed variables (lb == ub): they are eliminated exactly by
        masking while keeping problem shapes static. Returns
        (lbw_free, ubw_free, free_mask, center)."""
        lbw = np.asarray(lbw, dtype=float)
        ubw = np.asarray(ubw, dtype=float)
        with np.errstate(invalid='ignore'):
            center = 0.5 * (lbw + ubw)
            eps_pin = 1e-9 * (1. + np.abs(np.where(np.isfinite(center), center, 0.)))
            pinned = (ubw - lbw) < 2. * eps_pin
        lbw_free = np.where(pinned, -np.inf, lbw)
        ubw_free = np.where(pinned, np.inf, ubw)
        return lbw_free, ubw_free, (1. - pinned.astype(float)), \
            np.where(pinned, center, 0.)
