"""NLP decision-vector layout for direct collocation.

Flat-vector counterpart of the reference's casadi V struct
(awebox ocp/var_struct.py:39-115). Two control
parameterizations (var_struct.py:59-81):

zoh:  V = [theta, phi, x[0..nk], u[0..nk-1], xdot[0..nk-1], z[0..nk-1],
           coll_x[nk, d], coll_z[nk, d]]
poly: V = [theta, phi, x[0..nk], coll_x[nk, d], coll_z[nk, d],
           coll_u[nk, d]]
      (controls live on the collocation nodes as degree d-1 polynomials; no
      u/xdot/z at shooting nodes, and path constraints move to the
      collocation nodes, constraints.py:263-268)

All indexing is static numpy; jitted code sees only constant-offset gathers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..model.system import PHI_NAMES


@dataclass
class VStruct:
    n_k: int
    d: int
    nx: int
    nu: int
    nxd: int
    nz: int
    theta_names: list        # names in model theta order, t_f possibly dim 2
    theta_dims: list
    offsets: Dict[str, int]
    total: int
    u_param: str = 'zoh'
    with_xi: bool = False    # xi_0/xi_f boundary-trajectory parameters

    @staticmethod
    def build(layout, n_k, d, phase_fix_single_reelout: bool, u_param='zoh',
              with_xi: bool = False):
        nx = layout.dims['x']
        nu = layout.dims['u']
        nxd = layout.dims['xdot']
        nz = layout.dims['z']

        theta_names = layout.names('theta')
        theta_dims = []
        for name in theta_names:
            dim = layout.dim('theta', name)
            if name == 't_f' and phase_fix_single_reelout:
                dim = 2
            theta_dims.append(dim)
        ntheta = sum(theta_dims)

        offsets = {}
        cursor = 0
        offsets['theta'] = cursor; cursor += ntheta
        offsets['phi'] = cursor; cursor += len(PHI_NAMES)
        if with_xi:   # xi = [xi_0, xi_f] (var_struct.py:39 'xi' entry)
            offsets['xi'] = cursor; cursor += 2
        offsets['x'] = cursor; cursor += (n_k + 1) * nx
        if u_param in ('zoh', 'ms'):
            offsets['u'] = cursor; cursor += n_k * nu
            offsets['xdot'] = cursor; cursor += n_k * nxd
            offsets['z'] = cursor; cursor += n_k * nz
        elif u_param != 'poly':
            raise ValueError(f'unknown u_param {u_param!r}')
        if u_param != 'ms':   # multiple shooting carries no stage variables
            offsets['coll_x'] = cursor; cursor += n_k * d * nx
            offsets['coll_z'] = cursor; cursor += n_k * d * nz
        if u_param == 'poly':
            offsets['coll_u'] = cursor; cursor += n_k * d * nu

        return VStruct(n_k=n_k, d=d, nx=nx, nu=nu, nxd=nxd, nz=nz,
                       theta_names=theta_names, theta_dims=theta_dims,
                       offsets=offsets, total=cursor, u_param=u_param,
                       with_xi=with_xi)

    # --- slices -----------------------------------------------------------
    @property
    def ntheta(self):
        return sum(self.theta_dims)

    def theta_slice(self, name) -> slice:
        cursor = self.offsets['theta']
        for n, dim in zip(self.theta_names, self.theta_dims):
            if n == name:
                return slice(cursor, cursor + dim)
            cursor += dim
        raise KeyError(name)

    @property
    def phi_slice(self) -> slice:
        return slice(self.offsets['phi'], self.offsets['phi'] + len(PHI_NAMES))

    @property
    def xi_slice(self) -> slice:
        return slice(self.offsets['xi'], self.offsets['xi'] + 2)

    def get_xi(self, V):
        return V[self.xi_slice]

    def x_slice(self, k) -> slice:
        start = self.offsets['x'] + k * self.nx
        return slice(start, start + self.nx)

    def u_slice(self, k) -> slice:
        start = self.offsets['u'] + k * self.nu
        return slice(start, start + self.nu)

    def xdot_slice(self, k) -> slice:
        start = self.offsets['xdot'] + k * self.nxd
        return slice(start, start + self.nxd)

    def z_slice(self, k) -> slice:
        start = self.offsets['z'] + k * self.nz
        return slice(start, start + self.nz)

    def coll_x_slice(self, k, j) -> slice:
        start = self.offsets['coll_x'] + (k * self.d + j) * self.nx
        return slice(start, start + self.nx)

    def coll_z_slice(self, k, j) -> slice:
        start = self.offsets['coll_z'] + (k * self.d + j) * self.nz
        return slice(start, start + self.nz)

    def coll_u_slice(self, k, j) -> slice:
        start = self.offsets['coll_u'] + (k * self.d + j) * self.nu
        return slice(start, start + self.nu)

    # --- reshaping views (for jnp arrays) ----------------------------------
    def get_x_all(self, V):
        """(n_k+1, nx)"""
        o = self.offsets['x']
        return V[o:o + (self.n_k + 1) * self.nx].reshape(self.n_k + 1, self.nx)

    def get_u_all(self, V):
        o = self.offsets['u']
        return V[o:o + self.n_k * self.nu].reshape(self.n_k, self.nu)

    def get_xdot_all(self, V):
        o = self.offsets['xdot']
        return V[o:o + self.n_k * self.nxd].reshape(self.n_k, self.nxd)

    def get_z_all(self, V):
        o = self.offsets['z']
        return V[o:o + self.n_k * self.nz].reshape(self.n_k, self.nz)

    def get_coll_x(self, V):
        """(n_k, d, nx)"""
        o = self.offsets['coll_x']
        return V[o:o + self.n_k * self.d * self.nx].reshape(self.n_k, self.d, self.nx)

    def get_coll_z(self, V):
        o = self.offsets['coll_z']
        return V[o:o + self.n_k * self.d * self.nz].reshape(self.n_k, self.d, self.nz)

    def get_coll_u(self, V):
        """(n_k, d, nu); poly controls only."""
        o = self.offsets['coll_u']
        return V[o:o + self.n_k * self.d * self.nu].reshape(
            self.n_k, self.d, self.nu)

    def get_theta(self, V, name):
        return V[self.theta_slice(name)]

    def get_phi(self, V):
        return V[self.phi_slice]
