"""The PyTorch port's host solver against the JAX package's at n_k=10: the
bench configuration (Ampyx AP2, 3-DOF, power_cycle, d=3) on the grid where
Trial.optimize's dense direction takes K10's stream variant (n=670
variables, m=641 constraints, an augmented K of 1311 x 1311), both packages
on the CPU in f64 from the same cold start:

- the problem's size and the reference's linear-solver rule ('dense' below
  1200 variables), and the kernels' geometries at these sizes;
- the first direction of the cold solve (kkt_solve at the 'initial' step's
  first iterate, on the JAX package's own arguments): the same inertia
  verdict and the direction within TOL_DIRECTION_NK10;
- the first three iterations of the 'initial' homotopy step: per iteration
  mu, the delta_w ladder's factorizations, alpha, delta_w, the KKT error and
  f, as tests/test_torch_ipsolver.py holds them at n_k=4.

On the CPU the port's kernel wrappers run their plain versions (torch.linalg's
Cholesky and LU); the card's kernels are held to those in
tests/test_torch_kernels.py and, on this path, by chip_smoke.py's
[slice-trial-nk10].
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU before the packages load)

from tests.test_torch_ipsolver import counted_initial_step, rel_gap

torch.set_num_threads(1)
N_K, ITERS = 10, 3
# The first direction of the cold start: K's condition number there is
# 4.5e8, so two LU solves of one system (LAPACK's through jax.scipy and
# through torch.linalg) may part by up to ~cond x eps = 1e-7 of the
# direction (measured: 1.1e-13 on dy, the largest); a wrong assembly or
# solve parts by O(1)
TOL_DIRECTION_NK10 = 1e-6


@pytest.fixture(scope='module')
def runs():
    """Both packages' cold 'initial' step at n_k=10, capped at ITERS
    iterations, with the JAX package's first kkt_solve kept."""
    kept = {}
    tj, rec_j, ladder_j = counted_initial_step('jax', ITERS, N_K, kept)
    tt, rec_t, ladder_t = counted_initial_step('torch', ITERS, N_K)
    return dict(tj=tj, rec_j=rec_j, ladder_j=ladder_j, tt=tt, rec_t=rec_t, ladder_t=ladder_t,
                kept=kept)


def test_problem_size_and_kernel_geometry():
    """n=670, m=641 in both packages and the port's 'auto' choice 'dense'
    (the reference's rule, awebox_tpu/opti/homotopy.py:334-365: 'block' only
    from 1200 variables); on the card the inertia test's M (670 x 670) takes
    K10's stream variant and the augmented K (1311 x 1311) K12 and K13 at a
    cluster of 16 (B = 1)."""
    from awebox_tpu_torch.opti.homotopy import linear_solver_choice
    from awebox_tpu_torch.parallel import kernels
    from tests.test_torch_support import jax_trial, torch_trial
    ot, oj = torch_trial(N_K).ocp, jax_trial(N_K).ocp
    assert (ot.vstruct.total, ot.n_eq + ot.n_ineq) == (670, 641)
    assert (oj.vstruct.total, oj.n_eq + oj.n_ineq) == (670, 641)
    assert linear_solver_choice(ot) == 'dense'
    assert kernels.chol_factor_geometry(670).variant == 'stream'
    assert kernels.lu_factor_f64_geometry(1311).smem_bytes <= kernels.SMEM_PER_BLOCK
    assert kernels.lu_solve_f64_geometry(1311).C == 16


def test_kkt_solve_at_the_cold_start_matches_the_reference(runs):
    """The port's kkt_solve on the JAX package's arguments of its first call
    (the 'initial' step's first iterate, delta_w 0): the same inertia
    verdict ok, and dw, dy, dlam, ds, dzl, dzu within TOL_DIRECTION_NK10 of
    their max."""
    from tests.test_torch_support import torch_trial
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    ocp = torch_trial(N_K).ocp
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
    assert max(gaps.values()) <= TOL_DIRECTION_NK10, gaps


def test_initial_step_iterations_match_the_reference(runs):
    """The first ITERS iterations of the cold 'initial' step in both
    packages: per iteration the same barrier level mu, the same number of
    delta_w ladder factorizations, and alpha, delta_w, the KKT error and f
    within 1e-9 relative; the same status; the iterates within 1e-9 of
    max(1, max |w|)."""
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
