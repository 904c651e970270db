"""The host solver on the PyTorch port's 6-DOF kite against the JAX
package's, on the CPU in f64, from the cold start of the single-kite 6-DOF
health configuration (n_k=4, d=3: n=569, m=556, an augmented K of 1125):

- the first direction on the JAX package's own arguments, and per
  iteration of the first ITERS mu, the delta_w ladder's factorizations,
  alpha, delta_w, the KKT error and f, as tests/test_torch_nk10.py holds
  them at 3-DOF;
- in the slow tier, the whole first homotopy step ('initial_0') of both
  packages: the same iterations and status, the KKT error within 1e-6
  relative.

On the CPU the port's kernel wrappers run their plain versions; the card's
kernels are held to those on this path by chip_smoke.py's
[slice-trial-6dof].
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU before the packages load)

from tests.test_torch_ipsolver import counted_initial_step, rel_gap

torch.set_num_threads(1)
ITERS = 3
# The first direction of the cold start: the port's LU (LAPACK through
# torch.linalg) against the JAX package's on one system, whose condition
# number bounds how far two f64 solves may part (~cond x eps); a wrong
# assembly or solve parts by O(1)
TOL_DIRECTION = 1e-6


@pytest.fixture(scope='module')
def runs():
    """Both packages' cold 'initial' step of the 6-DOF health configuration,
    capped at ITERS iterations, with the JAX package's first kkt_solve
    kept."""
    kept = {}
    tj, rec_j, ladder_j = counted_initial_step('jax', ITERS, 4, kept, dof=6)
    tt, rec_t, ladder_t = counted_initial_step('torch', ITERS, 4, dof=6)
    return dict(tj=tj, rec_j=rec_j, ladder_j=ladder_j, tt=tt, rec_t=rec_t, ladder_t=ladder_t,
                kept=kept)


def test_first_direction_matches_the_reference(runs):
    """The port's kkt_solve on the JAX package's arguments of its first call
    (the 'initial' step's first iterate, delta_w 0): the same inertia
    verdict, and dw, dy, dlam, ds, dzl, dzu within TOL_DIRECTION of their
    max."""
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    ocp = runs['tt'].ocp
    assert ocp.vstruct.total + ocp.n_eq + ocp.n_ineq == 1125
    st = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=ocp.vstruct.total,
                             n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, device='cpu')
    args = [torch.as_tensor(np.array(a)) if hasattr(a, 'shape') and np.ndim(a) else a
            for a in runs['kept']['args']]
    args = [float(np.asarray(a)) if not torch.is_tensor(a) else a for a in args]
    out_t = st._kkt_solve(*args)
    out_j = runs['kept']['out']
    assert bool(out_t[6]) == bool(out_j[6])
    gaps = {name: rel_gap(u.numpy(), np.asarray(v))
            for name, u, v in zip(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu'), out_t[:6], out_j[:6])}
    assert max(gaps.values()) <= TOL_DIRECTION, gaps


def test_first_iterations_match_the_reference(runs):
    """The first ITERS iterations of the cold 'initial' step in both
    packages: per iteration the same mu and delta_w ladder factorizations,
    alpha, delta_w, the KKT error and f within 1e-9 relative; the same
    status; the iterates within 1e-9 of max(1, max |w|)."""
    rec_t, rec_j = runs['rec_t'], runs['rec_j']
    assert len(rec_t) == len(rec_j) == ITERS
    assert runs['ladder_t'] == runs['ladder_j']
    for rt, rj in zip(rec_t, rec_j):
        assert rt['it'] == rj['it'] and rt['mu'] == rj['mu']
        for k in ('alpha', 'delta_w', 'err', 'f'):
            assert abs(rt[k] - rj[k]) <= 1e-9 * max(abs(rj[k]), 1e-300), (rt['it'], k)
    tt, tj = runs['tt'], runs['tj']
    assert tt.solution.step_results['initial_0']['status'] \
        == tj.solution.step_results['initial_0']['status']
    vj = np.asarray(tj.solution.V_opt)
    assert np.abs(tt.solution.V_opt - vj).max() <= 1e-9 * max(1., np.abs(vj).max())


@pytest.mark.slow
def test_initial_step_matches_the_reference():
    """The whole 'initial' homotopy step of the 6-DOF cold solve, uncut, in
    both packages: the same iterations and status, the KKT error within 1e-6
    relative."""
    from tests.test_torch_support import options_of
    results = {}
    for package in ('jax', 'torch'):
        if package == 'jax':
            from awebox_tpu.api.trial import Trial
            kw = {}
        else:
            from awebox_tpu_torch.api.trial import Trial
            kw = dict(device='cpu')
        trial = Trial(options_of(package, 6)(4), f'{package}_initial6').build()
        trial.optimize(final_homotopy_step='initial', verbose=False, **kw)
        res = trial.solution.step_results['initial_0']
        results[package] = (trial.solution.stats['iterations']['initial_0'], res['status'],
                            res['kkt_error'])
        print(f'{package} initial_0: {res["status"]}, {results[package][0]} iterations, '
              f'KKT error {res["kkt_error"]!r}')
    (it_j, st_j, err_j), (it_t, st_t, err_t) = results['jax'], results['torch']
    assert (it_t, st_t) == (it_j, st_j)
    assert abs(err_t - err_j) <= 1e-6 * abs(err_j)
