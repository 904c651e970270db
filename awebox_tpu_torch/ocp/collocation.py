"""Radau/Legendre collocation coefficients and interpolation.

Numpy build-time computation of the Lagrange-polynomial machinery used by the
reference (awebox ocp/collocation.py:67-200): differentiation
matrix on the collocation nodes, continuity coefficients, and quadrature
weights. The coefficients are small static matrices baked into jitted
transcription code.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from numpy.polynomial import legendre as npleg


def collocation_points(d: int, scheme: str = 'radau') -> np.ndarray:
    """Collocation points on (0, 1]; matches casadi.collocation_points."""
    if scheme == 'radau':
        # right-Radau points: tau = (1 - x)/2 for roots x of P_{d-1} + P_d
        c = np.zeros(d + 1)
        c[d - 1] = 1.0
        c[d] += 1.0
        roots = npleg.legroots(c)
        taus = np.sort((1.0 - roots) / 2.0)
    elif scheme == 'legendre':
        c = np.zeros(d + 1)
        c[d] = 1.0
        roots = npleg.legroots(c)
        taus = np.sort((roots + 1.0) / 2.0)
    else:
        raise ValueError(f'unknown collocation scheme {scheme}')
    return taus


def _lagrange_poly(tau_root: np.ndarray, j: int) -> np.poly1d:
    """Lagrange basis polynomial l_j over the given nodes."""
    others = np.delete(tau_root, j)
    poly = np.poly1d(np.array([1.0]))
    for r in others:
        poly = poly * np.poly1d([1.0, -r]) / (tau_root[j] - r)
    return poly


@dataclass(frozen=True)
class Collocation:
    """Collocation coefficient bundle.

    Attributes:
      tau_root: (d+1,) nodes [0, tau_1..tau_d]
      coeff_collocation: (d+1, d+1); [j, r] = dl_j/dtau at tau_r
      coeff_continuity: (d+1,); l_j(1)
      coeff_collocation_u: (d, d) same for the d-node (z/u) basis
      quad_weights: (d,) quadrature weights over one unit interval
      lambda_mat: (d, d) integration matrix (Lambda in the reference)
    """
    d: int
    scheme: str
    tau_root: np.ndarray
    coeff_collocation: np.ndarray
    coeff_continuity: np.ndarray
    coeff_collocation_u: np.ndarray
    quad_weights: np.ndarray
    lambda_mat: np.ndarray

    @staticmethod
    def build(d: int, scheme: str = 'radau') -> 'Collocation':
        taus = collocation_points(d, scheme)
        tau_root = np.concatenate([[0.0], taus])

        coeff_collocation = np.zeros((d + 1, d + 1))
        coeff_continuity = np.zeros(d + 1)
        for j in range(d + 1):
            lj = _lagrange_poly(tau_root, j)
            coeff_continuity[j] = lj(1.0)
            dlj = lj.deriv()
            for r in range(d + 1):
                coeff_collocation[j, r] = dlj(tau_root[r])

        coeff_collocation_u = np.zeros((d, d))
        for j in range(1, d + 1):
            lj = _lagrange_poly(tau_root[1:], j - 1)
            dlj = lj.deriv()
            for r in range(1, d + 1):
                coeff_collocation_u[j - 1, r - 1] = dlj(tau_root[r])

        lambda_mat = np.linalg.solve(coeff_collocation[1:, 1:], np.eye(d))
        quad_weights = np.linalg.solve(coeff_collocation[1:, 1:], coeff_continuity[1:])

        return Collocation(d=d, scheme=scheme, tau_root=tau_root,
                           coeff_collocation=coeff_collocation,
                           coeff_continuity=coeff_continuity,
                           coeff_collocation_u=coeff_collocation_u,
                           quad_weights=quad_weights,
                           lambda_mat=lambda_mat)

    # --- evaluation helpers (numpy, post-processing) ----------------------
    def interp_x(self, tau: float) -> np.ndarray:
        """(d+1,) basis values l_j(tau) for the state basis."""
        return np.array([_lagrange_poly(self.tau_root, j)(tau)
                         for j in range(self.d + 1)])

    def interp_u(self, tau: float) -> np.ndarray:
        """(d,) basis values for the control/algebraic basis."""
        return np.array([_lagrange_poly(self.tau_root[1:], j)(tau)
                         for j in range(self.d)])

    def interp_dx(self, tau: float) -> np.ndarray:
        """(d+1,) basis derivative values dl_j/dtau(tau)."""
        return np.array([_lagrange_poly(self.tau_root, j).deriv()(tau)
                         for j in range(self.d + 1)])
