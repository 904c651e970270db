"""The end-to-end configurations of tests/test_e2e_configs.py in the PyTorch
port against the JAX package, on the CPU in f64: the machinery the files
tests/test_torch_e2e_*.py share, each over its own configurations (split so
that ``--dist loadfile`` spreads the JAX builds over workers).

For each configuration (awebox_tpu_torch.configs.E2E_NAMES; the JAX
package's side is tests/test_options.py::make_ampyx_options with the same
overrides) ``parity_tests(names)`` makes the tests:

- the options trees, the problem's size and the slices of its rows;
- the initial guess, the tracking reference and the bounds, bit for bit;
- f, eq and ineq at V0 (the initial cost weights) and at a numpy-seeded
  perturbation of it (the final cost weights), within TOL;
- the homotopy schedule (steps, costs and bounds to update, the homotopy
  parameters in use) and the bounds of its first step, equal;
- 'auto' takes the dense direction in both packages;
- the JAX package's cold solve, tests/artifacts/e2e_<name>.pkl (from
  ``python -m tests.trial_cold_cpu e2e jax NAME --save PATH``, with
  ``--max-iter 150`` where the uncut solve runs a step to the 2000-iteration
  cap: CAPPED), installed in the port: f, eq and ineq at its V_opt within
  TOL, the power and period within TOL_OUTPUTS, the design parameters, and
  for the averaged induction model the momentum balance at the solution. A
  solve whose every step solved ends on the dynamics (max |eq| <= 1e-8); a
  capped one that stalled does not, and installs only where the port's
  residual there is the JAX package's;
- the first direction of the cold solve (the 'initial' step's first
  kkt_solve, on the JAX package's own arguments) within TOL_DIRECTION, and
  the first ITERS iterations of that step within TOL_ITER.

``structured_tests(names)`` makes the tests of the structured derivatives
(ocp/structured.py: vals, J and H over the nodes) against the JAX package's
make_structured_derivs(parts=True), for configurations that are not
dense-only: Sweep and make_batched_solver take the block path on them from
n_k = 19. Batched over two lanes, the initial guess and the perturbed point
(the final cost weights), with random multipliers. Tolerances as
tests/test_torch_structured.py: values 1e-12; gradient 1e-10 abs / 1e-8 rel;
J 1e-9 abs / 1e-7 rel; H 1e-8 abs / 1e-6 rel.
"""
import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from awebox_tpu_torch import configs
from tests.test_torch_sixdof_flagship import same_tree
from tests.test_torch_support import HERE, lanes, to_numpy_tree

torch.set_num_threads(1)
# model and NLP functions: the summation order inside dot products and
# reductions differs, worth a few ulp of the O(1..1e3) values (as
# tests/test_torch_sixdof.py)
TOL = 1e-12
# the installed solution's average power and period: the e state times its
# scale and the t_f entry are the same bits in both packages; under
# integral_outputs the energy is a quadrature of the power over the nodes,
# summed in another order
TOL_OUTPUTS = 1e-13
# the first direction of the cold start: two LU solves of one system (LAPACK
# through jax.scipy and through torch.linalg) part by up to ~cond(K) x eps
# (as tests/test_torch_nk10.py)
TOL_DIRECTION = 1e-6
# the first ITERS iterations of the cold 'initial' step: alpha, delta_w, the
# KKT error and f, relative, and the iterate relative to max(1, max |w|)
ITERS, TOL_ITER = 3, 1e-9
# the configurations whose uncut JAX solve runs a step to the 2000-iteration
# cap: their payloads are the solves capped at 150 iterations a step
CAPPED = ('dual_kite', 'actuator_qaxi', 'integral_outputs')
# (variables, equality rows, inequality rows) of each configuration
SIZES = {'dual_kite': (516, 461, 40), 'drag_mode': (216, 182, 16),
         'actuator_qaxi': (344, 311, 16), 'averaged_induction': (281, 248, 16),
         'poly_controls': (280, 199, 48), 'single_homotopy': (280, 247, 16),
         'integral_outputs': (166, 139, 12), 'reynolds_cd': (280, 247, 16)}


def jax_options(name):
    """The JAX package's options of the end-to-end configuration ``name``."""
    from tests.test_options import make_ampyx_options
    return configs.apply_overrides(make_ampyx_options(), configs.E2E_OVERRIDES[name])


def payload_path(name):
    return os.path.join(HERE, 'artifacts', f'e2e_{name}.pkl')


@functools.lru_cache(maxsize=None)
def payload(name):
    with open(payload_path(name), 'rb') as fh:
        return pickle.load(fh)


@functools.lru_cache(maxsize=None)
def trials(name):
    """Both packages' built trials of ``name``: (JAX, port)."""
    from awebox_tpu.api.trial import Trial as TJ
    from awebox_tpu_torch.api.trial import Trial as TT
    return (TJ(jax_options(name), f'e2e_{name}').build(),
            TT(configs.e2e_options(name), f'e2e_{name}').build())


@functools.lru_cache(maxsize=None)
def starts(name):
    """The JAX package's V0, V_ref and P (initial cost weights), and the
    perturbed point with P under the final cost weights, numpy."""
    from awebox_tpu.opti import homotopy as hj
    from awebox_tpu.opti.initialization import build_initial_guess, build_reference
    ocp = trials(name)[0].ocp
    V0 = np.asarray(build_initial_guess(ocp))
    V_ref = np.asarray(build_reference(ocp, V0))
    P0 = to_numpy_tree(hj.build_p_fix(ocp, V_ref))
    P1 = to_numpy_tree(hj.build_p_fix(ocp, V_ref))
    P1['cost'] = {k: np.asarray(v) for k, v in hj.final_cost_values(ocp).items()}
    rng = np.random.default_rng(sum(map(ord, name)))
    V1 = V0 * (1. + 0.05 * rng.standard_normal(V0.shape))
    return V0, V_ref, {'V0': (V0, P0), 'perturbed': (V1, P1)}


@functools.lru_cache(maxsize=None)
def jax_values(name, point):
    V, P = starts(name)[2][point]
    ocp = trials(name)[0].ocp
    return [np.asarray(jax.jit(fn)(jnp.asarray(V), P))
            for fn in (ocp.f_fn, ocp.eq_fn, ocp.ineq_fn)]


def port_values(ocp, V, P):
    from awebox_tpu_torch.tree import to_tensors
    Pt = to_tensors(P, torch.float64, 'cpu')
    V = torch.as_tensor(np.array(V))
    return [fn(V, Pt).numpy() for fn in (ocp.f_fn, ocp.eq_fn, ocp.ineq_fn)]


def solved(name):
    """Whether every homotopy step of the payload's solve solved."""
    return all(s == 'solved' for s in payload(name)['step_statuses'].values())


@functools.lru_cache(maxsize=None)
def installed(name):
    """The port's trial with the JAX package's solution installed, and the
    JAX package's f, eq and ineq at V_opt under the P install_solution
    builds (the reference from V_init, the final cost weights), with P. A
    solved payload installs within 1e-8 of the dynamics; a stalled one
    within its own max |eq| in the JAX package plus TOL."""
    from awebox_tpu.opti import homotopy as hj
    from awebox_tpu.opti.initialization import build_reference
    from awebox_tpu_torch.api.trial import Trial, install_solution
    pl = payload(name)
    ocp = trials(name)[0].ocp
    P = to_numpy_tree(hj.build_p_fix(ocp, build_reference(ocp, np.asarray(pl['V_init']))))
    P['cost'] = {k: np.asarray(v) for k, v in hj.final_cost_values(ocp).items()}
    V = jnp.asarray(pl['V_opt'])
    vals = [np.asarray(jax.jit(fn)(V, P)) for fn in (ocp.f_fn, ocp.eq_fn, ocp.ineq_fn)]
    eq_tol = 1e-8 if solved(name) else float(np.abs(vals[1]).max()) + TOL
    trial = Trial(configs.e2e_options(name), f'e2e_{name}_installed').build()
    assert install_solution(trial, payload_path(name), eq_tol=eq_tol)
    return trial, vals, P


@functools.lru_cache(maxsize=None)
def cold_starts(name):
    """Both packages' cold 'initial' step capped at ITERS iterations, with
    the JAX package's first kkt_solve kept."""
    from tests.test_torch_ipsolver import counted_initial_step
    kept = {}
    tj, rec_j, ladder_j = counted_initial_step('jax', ITERS, kept=kept,
                                               options=jax_options(name))
    tt, rec_t, ladder_t = counted_initial_step('torch', ITERS,
                                               options=configs.e2e_options(name))
    return dict(tj=tj, rec_j=rec_j, ladder_j=ladder_j, tt=tt, rec_t=rec_t, ladder_t=ladder_t,
                kept=kept)


def parity_tests(names):
    """The parity tests over the configurations ``names``, as a dict of
    module-level test functions."""
    by_name = pytest.mark.parametrize('name', names)

    @by_name
    def test_options_and_sizes_match(name):
        """The port's configs.e2e_options(name) is the JAX package's tree,
        and both build a problem of SIZES[name] with the same row slices."""
        tj, tt = trials(name)
        assert same_tree(configs.e2e_options(name).as_dict(), jax_options(name).as_dict()) == []
        for ocp in (tj.ocp, tt.ocp):
            assert (ocp.vstruct.total, ocp.n_eq, ocp.n_ineq) == SIZES[name]
        assert tt.ocp.eq_slices == tj.ocp.eq_slices
        assert tt.ocp.ineq_slices == tj.ocp.ineq_slices
        assert tt.model.eq_slices == tj.model.eq_slices
        assert tt.model.ineq_slices == tj.model.ineq_slices
        assert tt.model.layout.entries == tj.model.layout.entries

    @by_name
    def test_kernels_take_the_dense_direction_shapes(name):
        """On the card the direction's inertia test takes M (n x n) in K10's
        cluster variant (n <= 554) and K12/K13 take K (N = n + m) whole, K12
        in full panels (N <= 1024), with no other variant and no fallback."""
        from awebox_tpu_torch.parallel import kernels
        n, m_eq, m_ineq = SIZES[name]
        N = n + m_eq + m_ineq
        assert kernels.chol_factor_geometry(n).variant == 'cluster'
        assert N <= kernels.LU64_WHOLE
        assert kernels.lu_factor_f64_geometry(N, 1).smem_bytes <= kernels.SMEM_PER_BLOCK
        assert kernels.lu_solve_f64_geometry(N, 1).C >= 1

    @by_name
    @pytest.mark.parametrize('what', ['V0', 'V_ref', 'lb', 'ub'])
    def test_guess_bounds_and_reference_match(name, what):
        from awebox_tpu_torch.opti import initialization as it
        tj, tt = trials(name)
        V0, V_ref, _ = starts(name)
        a, b = {'V0': (V0, it.build_initial_guess(tt.ocp)),
                'V_ref': (V_ref, it.build_reference(tt.ocp, V0)),
                'lb': (tj.lb_nominal, tt.lb_nominal),
                'ub': (tj.ub_nominal, tt.ub_nominal)}[what]
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape == (SIZES[name][0],)
        np.testing.assert_array_equal(b, a)

    @by_name
    @pytest.mark.parametrize('point', ['V0', 'perturbed'])
    @pytest.mark.parametrize('which', ['f', 'eq', 'ineq'])
    def test_nlp_functions_match(name, which, point):
        i = ('f', 'eq', 'ineq').index(which)
        V, P = starts(name)[2][point]
        a = jax_values(name, point)[i]
        b = port_values(trials(name)[1].ocp, V, P)[i]
        assert a.shape == b.shape == ((), (SIZES[name][1],), (SIZES[name][2],))[i]
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)

    @by_name
    def test_homotopy_schedule_matches(name):
        """define_schedule's steps, costs and bounds to update and the
        homotopy parameters in use, and the bounds of the first step."""
        from awebox_tpu.opti import homotopy as hj
        from awebox_tpu_torch.opti import homotopy as ht
        tj, tt = trials(name)
        sj, st = hj.define_schedule(tj.ocp), ht.define_schedule(tt.ocp)
        assert st == sj
        V0 = starts(name)[0]
        bj = hj.set_initial_bounds(tj.ocp, tj.lb_nominal, tj.ub_nominal, V0, sj)
        bt = ht.set_initial_bounds(tt.ocp, tt.lb_nominal, tt.ub_nominal, V0, st)
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        # the JAX package's solve walked this schedule
        solved = payload(name)['stats']['iterations']
        assert list(dict.fromkeys(k.rsplit('_', 1)[0] for k in solved)) == sj['steps']

    @by_name
    def test_auto_takes_the_dense_direction(name, monkeypatch):
        """'auto' takes 'dense' in both packages: the JAX package's
        solve_homotopy builds its solver with no block KKT, and the port's
        rule gives 'dense'."""
        from awebox_tpu.opti import homotopy as hj
        from awebox_tpu_torch.opti.homotopy import linear_solver_choice
        built = {}

        class Stop(Exception):
            pass

        def solver_stub(*args, **kwargs):
            built['block_kkt'] = kwargs.get('block_kkt')
            raise Stop
        monkeypatch.setattr(hj, 'InteriorPointSolver', solver_stub)
        tj, tt = trials(name)
        V0, V_ref, _ = starts(name)
        with pytest.raises(Stop):
            hj.solve_homotopy(tj.ocp, V0, V_ref, tj.lb_nominal, tj.ub_nominal, verbose=False)
        assert built == {'block_kkt': None}
        assert linear_solver_choice(tt.ocp) == 'dense'

    @by_name
    @pytest.mark.parametrize('which', ['f', 'eq', 'ineq'])
    def test_installed_solution_matches(name, which):
        """The JAX package's solution in the port: f, eq and ineq at V_opt
        under the final cost weights within TOL; the dynamics hold there
        where every step solved (a CAPPED solve stops at the cap in the
        steps where it stalls, off the dynamics)."""
        trial, vals_j, P = installed(name)
        i = ('f', 'eq', 'ineq').index(which)
        b = port_values(trial.ocp, payload(name)['V_opt'], P)[i]
        a = vals_j[i]
        assert a.shape == b.shape and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
        assert solved(name) == (name not in CAPPED)
        if which == 'eq' and solved(name):
            assert np.abs(a).max() <= 1e-8 and np.abs(b).max() <= 1e-8

    @by_name
    def test_installed_solution_outputs_match(name):
        """The installed solution's power and period are the JAX package's
        solve's, its design parameters the payload's, and its record the
        solve's; the averaged induction model's momentum balance holds at
        the solution, with a in [0, 0.5]."""
        trial = installed(name)[0]
        pl = payload(name)
        go, stored = trial.global_outputs(), pl['global_outputs']
        for k in ('avg_power_watts', 'time_period', 'e_final_joules'):
            assert abs(go[k] / stored[k] - 1.) <= TOL_OUTPUTS, (k, go[k], stored[k])
        for k, v in pl['theta_opt'].items():
            np.testing.assert_allclose(trial.theta_opt()[k], v, rtol=1e-12, atol=0.)
        assert trial.solution.stats['iterations'] == pl['stats']['iterations']
        assert trial.solve_succeeded == pl['success']
        if name == 'averaged_induction':
            a_opt = float(trial.theta_opt()['a'][0])
            assert 0. <= a_opt <= 0.5
            V, P = trial._V_P()
            res = trial.ocp.eq_fn(V, P)[trial.ocp.eq_slices['avg_induction']]
            assert abs(float(res[0])) < 1e-6

    @by_name
    def test_first_direction_matches(name):
        """The port's kkt_solve on the JAX package's arguments of its first
        call in the cold solve (the 'initial' step's first iterate): the
        same inertia verdict, and dw, dy, dlam, ds, dzl, dzu within
        TOL_DIRECTION of their max."""
        from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
        from tests.test_torch_ipsolver import rel_gap
        runs = cold_starts(name)
        ocp = trials(name)[1].ocp
        st = InteriorPointSolver(ocp.f_fn, ocp.eq_fn, ocp.ineq_fn, n=ocp.vstruct.total,
                                 n_eq=ocp.n_eq, n_ineq=ocp.n_ineq, device='cpu')
        args = [torch.as_tensor(np.array(a)) if hasattr(a, 'shape') and np.ndim(a) else a
                for a in runs['kept']['args']]
        args = [float(np.asarray(a)) if not torch.is_tensor(a) else a for a in args]
        out_t = st._kkt_solve(*args)
        out_j = runs['kept']['out']
        assert bool(out_t[6]) == bool(out_j[6])
        gaps = {k: rel_gap(u.numpy(), np.asarray(v)) for k, u, v in
                zip(('dw', 'dy', 'dlam', 'ds', 'dzl', 'dzu'), out_t[:6], out_j[:6])}
        assert max(gaps.values()) <= TOL_DIRECTION, gaps

    @by_name
    def test_initial_iterations_match(name):
        """The first ITERS iterations of the cold 'initial' step in both
        packages: per iteration the same barrier level mu and number of
        delta_w ladder factorizations, and alpha, delta_w, the KKT error and
        f within TOL_ITER relative; the same status; the iterates within
        TOL_ITER of max(1, max |w|)."""
        runs = cold_starts(name)
        rec_t, rec_j = runs['rec_t'], runs['rec_j']
        assert len(rec_t) == len(rec_j) == ITERS
        assert runs['ladder_t'] == runs['ladder_j']
        for rt, rj in zip(rec_t, rec_j):
            assert rt['it'] == rj['it'] and rt['mu'] == rj['mu']
            for k in ('alpha', 'delta_w', 'err', 'f'):
                assert abs(rt[k] - rj[k]) <= TOL_ITER * max(abs(rj[k]), 1e-300), (rt['it'], k)
        tt, tj = runs['tt'], runs['tj']
        assert tt.solution.step_results['initial_0']['status'] \
            == tj.solution.step_results['initial_0']['status']
        vj = np.asarray(tj.solution.V_opt)
        assert np.abs(tt.solution.V_opt - vj).max() <= TOL_ITER * max(1., np.abs(vj).max())

    return {k: v for k, v in locals().items() if k.startswith('test_')}


@functools.lru_cache(maxsize=None)
def structured_parts(name, B=2):
    """Both packages' (vals, (JE, JI), H) on the two lanes."""
    from awebox_tpu.ocp.structured import make_structured_derivs as make_j
    from awebox_tpu_torch.ocp.structured import make_structured_derivs as make_t
    from awebox_tpu_torch.parallel.batch import p_from_numpy
    tj, tt = trials(name)
    V0, _, points = starts(name)
    V1, P = points['perturbed']
    rng = np.random.default_rng(31)
    w = np.stack([V0, V1])
    y = rng.standard_normal((B, tj.ocp.n_eq))
    lam = np.abs(rng.standard_normal((B, tj.ocp.n_ineq))) + 0.1
    P = lanes(P, B)
    vj, jj, hj = make_j(tj.ocp, parts=True)
    out_j = ([np.asarray(v) for v in jax.jit(jax.vmap(vj))(w, y, lam, P)],
             [np.asarray(j) for j in jax.jit(jax.vmap(jj))(w, P)],
             np.asarray(jax.jit(jax.vmap(hj))(w, y, lam, P)))
    vt, jt, ht = make_t(tt.ocp)
    wt, yt, lt = (torch.as_tensor(a) for a in (w, y, lam))
    Pt = p_from_numpy(P, 'cpu')
    out_t = ([v.numpy() for v in vt(wt, yt, lt, Pt)], [j.numpy() for j in jt(wt, Pt)],
             ht(wt, yt, lt, Pt).numpy())
    return out_j, out_t


def structured_tests(names):
    """The structured-derivative tests over the configurations ``names``,
    as a dict of module-level test functions."""
    by_name = pytest.mark.parametrize('name', names)

    @by_name
    def test_structured_values_and_gradient_match(name):
        (vj, _, _), (vt, _, _) = structured_parts(name)
        for what, a, b, atol, rtol in zip(('fval', 'gradf', 'cE', 'cI'), vj, vt,
                                          (1e-12, 1e-10, 1e-12, 1e-12),
                                          (1e-12, 1e-8, 1e-12, 1e-12)):
            assert a.shape == b.shape and a.shape[0] == 2, what
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=what)

    @by_name
    @pytest.mark.parametrize('which', ['JE', 'JI'])
    def test_structured_constraint_jacobians_match(name, which):
        (_, jj, _), (_, jt, _) = structured_parts(name)
        i = ('JE', 'JI').index(which)
        n, m_eq, m_ineq = SIZES[name]
        assert jj[i].shape == jt[i].shape == (2, (m_eq, m_ineq)[i], n)
        np.testing.assert_allclose(jt[i], jj[i], atol=1e-9, rtol=1e-7)

    @by_name
    def test_structured_lagrangian_hessian_matches(name):
        (_, _, hj), (_, _, ht) = structured_parts(name)
        n = SIZES[name][0]
        assert ht.shape == hj.shape == (2, n, n)
        np.testing.assert_allclose(ht, hj, atol=1e-8, rtol=1e-6)
        np.testing.assert_allclose(ht, np.swapaxes(ht, 1, 2), atol=1e-8, rtol=1e-6)

    return {k: v for k, v in locals().items() if k.startswith('test_')}
