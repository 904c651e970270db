"""Solution interpolation and CSV export.

Counterpart of ``awebox_tpu/api/postprocessing.py``: interpolates the
collocation solution onto a uniform time grid (states by the d+1-node
Lagrange basis, algebraic variables by the d-node basis, zoh controls) and
evaluates the model outputs along it, producing the plot_dict that feeds the
CSV export and the sweep's per-case records. Host-side numpy, with the model
outputs evaluated by ``torch.func.vmap`` on the CPU.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..tree import to_tensors, tree_map
from .warmstart import tf_per_k


def interpolate_solution(trial, n_points: int = 100) -> Dict:
    ocp = trial.ocp
    vs = ocp.vstruct
    model = trial.model
    layout = model.layout
    V = np.asarray(trial.solution.V_opt)
    n_k = ocp.n_k

    tf_k = tf_per_k(ocp, V)
    t_x = np.concatenate([[0.], np.cumsum(tf_k / n_k)])
    T = t_x[-1]
    t_ip = np.linspace(0., T, n_points)

    poly_u = (vs.u_param == 'poly')
    X = np.asarray(vs.get_x_all(V))
    CX = np.asarray(vs.get_coll_x(V))
    CZ = np.asarray(vs.get_coll_z(V))
    if poly_u:
        CU = np.asarray(vs.get_coll_u(V))
    else:
        U = np.asarray(vs.get_u_all(V))

    x_ip = np.zeros((n_points, vs.nx))
    z_ip = np.zeros((n_points, vs.nz))
    u_ip = np.zeros((n_points, vs.nu))
    xdot_ip = np.zeros((n_points, vs.nx))

    for i, t in enumerate(t_ip):
        k = min(int(np.searchsorted(t_x, t, side='right')) - 1, n_k - 1)
        k = max(k, 0)
        tau = (t - t_x[k]) / (tf_k[k] / n_k)
        tau = min(max(tau, 0.), 1.)
        lx = ocp.coll.interp_x(tau)          # (d+1,)
        lu = ocp.coll.interp_u(tau)          # (d,)
        dlx = ocp.coll.interp_dx(tau)
        stack = np.concatenate([X[k][None, :], CX[k]], axis=0)
        x_ip[i] = lx @ stack
        xdot_ip[i] = (dlx @ stack) / (tf_k[k] / n_k)
        z_ip[i] = lu @ CZ[k]
        u_ip[i] = (lu @ CU[k]) if poly_u else U[k]

    scaling = model.scaling
    plot_dict = {
        'time_grids': {'ip': t_ip, 'x': t_x},
        'x': {}, 'u': {}, 'z': {}, 'xdot': {},
    }
    for name, _ in layout.entries['x']:
        sl = layout.slices['x'][name]
        plot_dict['x'][name] = (x_ip[:, sl] * scaling['x'][sl]).T
        plot_dict['xdot']['d' + name] = (xdot_ip[:, sl] * scaling['x'][sl]).T
    for name, _ in layout.entries['u']:
        sl = layout.slices['u'][name]
        plot_dict['u'][name] = (u_ip[:, sl] * scaling['u'][sl]).T
    for name, _ in layout.entries['z']:
        sl = layout.slices['z'][name]
        plot_dict['z'][name] = (z_ip[:, sl] * scaling['z'][sl]).T

    # model outputs along the interpolated grid
    phi = np.asarray(vs.get_phi(V))
    theta0 = to_tensors(trial.solution.P['theta0'], torch.float64, 'cpu')
    ntheta_model = layout.dims['theta']
    theta_model = np.zeros(ntheta_model)
    for name in vs.theta_names:
        msl = layout.slices['theta'][name]
        val = V[vs.theta_slice(name)]
        if name == 't_f':
            theta_model[msl.start] = val[0]
        else:
            theta_model[msl] = val
    node_vecs = np.concatenate([
        x_ip, xdot_ip, u_ip, z_ip,
        np.broadcast_to(theta_model, (n_points, ntheta_model))], axis=1)
    outputs = torch.func.vmap(model.outputs_fn, in_dims=(0, None, None))(
        torch.as_tensor(node_vecs), torch.as_tensor(phi), theta0)
    plot_dict['outputs'] = tree_map(lambda a: a.numpy().T, outputs)

    go = trial.global_outputs()
    plot_dict['power_and_performance'] = {
        'avg_power': go['avg_power_watts'],
        'e_final': go['e_final_joules'],
        'time_period': go['time_period'],
    }
    geom = trial.options['processed']['geometry']
    plot_dict['geometry'] = {'b_ref': float(geom['b_ref']),
                             'c_ref': float(geom['c_ref'])}
    plot_dict['u_ref'] = float(
        trial.options['user_options']['wind']['u_ref'])
    return plot_dict


def write_csv(trial, filename: str, n_points: int = 100):
    """CSV export of the interpolated solution."""
    import csv
    plot_dict = interpolate_solution(trial, n_points)
    cols = {'time': plot_dict['time_grids']['ip']}
    for group in ('x', 'u', 'z'):
        for name, arr in plot_dict[group].items():
            for i in range(arr.shape[0]):
                cols[f'{group}_{name}_{i}'] = arr[i]
    with open(filename, 'w', newline='') as fh:
        writer = csv.writer(fh)
        names = list(cols.keys())
        writer.writerow(names)
        for i in range(len(cols['time'])):
            writer.writerow([cols[c][i] for c in names])
    return filename
