"""Both packages' batched solver on the B=2 wind sweep (u_ref 9.5 and 10.5 m/s
from the committed anchor), on the CPU in f64, in the block or the condensed
('dense', f64) KKT mode. Not a test: a script that prints what the tests and
PERF.md quote.

    python -m tests.sweep_modes_cpu traj MODE ITERS    # per-iteration err of
        # both packages, each stepping from the same start on its own (no tol
        # gate), and max |w_port - w_jax| per lane
    python -m tests.sweep_modes_cpu converge MODE CAP  # make_batched_solver(
        # n_iter=CAP, batch_p=True, tol=1e-5) in both packages: steps, err,
        # max |eq|, average power and period per lane

Run from the repository root with JAX_PLATFORMS=cpu; MODE is block or dense.
"""
import sys

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU, x64)
import jax
import jax.numpy as jnp

from tests.test_torch_support import anchor, jax_sweep, jax_trial, torch_trial


def traj(mode, iters):
    from awebox_tpu.parallel.batch import make_ip_step as make_j
    from awebox_tpu_torch.parallel.batch import make_ip_step as make_t, p_from_numpy
    state, P64, lbw, ubw, free = jax_sweep(2)
    step_t = make_t(torch_trial().ocp, kkt=mode,
                    **(dict(solve_dtype=torch.float64) if mode == 'dense' else {}))
    step_j = make_j(jax_trial().ocp, kkt=mode,
                    **(dict(solve_dtype='float64') if mode == 'dense' else {}))
    lb, ub, fr = (jnp.asarray(a) for a in (lbw, ubw, free))
    sj = jax.jit(jax.vmap(lambda st, p: step_j(st, p, lb, ub, fr)))
    st_t = {k: torch.as_tensor(v) for k, v in state.items()}
    P_t = p_from_numpy(P64, 'cpu')
    bounds = [torch.as_tensor(a) for a in (lbw, ubw, free)]
    st_j = {k: jnp.asarray(v) for k, v in state.items()}
    for it in range(iters):
        st_j = sj(st_j, P64)
        st_t = step_t(st_t, P_t, *bounds)
        gap = np.abs(np.asarray(st_j['w']) - st_t['w'].numpy()).max(axis=1)
        print(it + 1, 'err jax', np.asarray(st_j['err']), 'port', st_t['err'].numpy(),
              'max|w diff|', gap, flush=True)


def converge(mode, cap):
    from awebox_tpu.parallel.batch import make_batched_solver as mbs_j
    from awebox_tpu_torch.parallel.batch import make_batched_solver as mbs_t
    from awebox_tpu_torch.parallel.refine import average_power, sweep_bounds, wind_sweep_problem
    lbf, ubf = sweep_bounds(torch_trial())
    state, P64 = jax_sweep(2)[:2]
    kw_j = dict(solve_dtype='float64') if mode == 'dense' else {}
    ocp_j = jax_trial().ocp
    out = mbs_j(ocp_j, lbf, ubf, n_iter=cap, batch_p=True, tol=1e-5, kkt=mode, **kw_j)(
        {k: jnp.asarray(v) for k, v in state.items()}, P64)
    w = out['w']
    T = jax.vmap(ocp_j.time_period_fn)(w)
    np.set_printoptions(precision=17)
    print('jax ', mode, 'err', np.asarray(out['err']),
          'eq', np.abs(np.asarray(jax.vmap(ocp_j.eq_fn)(w, P64))).max(axis=1),
          'P', repr(np.asarray(jax.vmap(ocp_j.e_final_si_fn)(w, P64) / T)),
          'T', repr(np.asarray(T)), flush=True)
    trial = torch_trial()
    ocp = trial.ocp
    state_t, P_t = wind_sweep_problem(trial, anchor(), 2, device='cpu')[:2]
    kw = dict(solve_dtype=torch.float64) if mode == 'dense' else {}
    solve = mbs_t(ocp, lbf, ubf, n_iter=cap, batch_p=True, tol=1e-5, kkt=mode, **kw)
    out = solve(state_t, P_t)
    print('port', mode, 'steps', solve.n_iter, 'err', out['err'].numpy(),
          'eq', torch.func.vmap(ocp.eq_fn)(out['w'], P_t).abs().amax(dim=1).numpy(),
          'P', repr(average_power(ocp, out['w'], P_t).numpy()),
          'T', repr(torch.func.vmap(ocp.time_period_fn)(out['w']).numpy()), flush=True)


if __name__ == '__main__':
    torch.set_num_threads(2)
    what, mode, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    {'traj': traj, 'converge': converge}[what](mode, n)
