"""The PyTorch port's Sweep (awebox_tpu_torch/api/sweep.py) against the JAX
package's (awebox_tpu/api/sweep.py), on the CPU, in f64, from the committed
anchor (tests/artifacts/bench_anchor_nk4_d3.npz) installed as each
package's solved Trial, over the cases u_ref = 9.5 and 10.5 m/s:

- Sweep.batched_problem, what run_batched solves: the relaxed final-step
  bounds, the per-case P and the start, against the JAX package's recipe
  (tests/test_torch_support.jax_sweep), entry for entry;
- run_batched for two iterations in both packages;
- the refusals (mesh=, plot_comparison, an override that is no theta0 leaf).

The slow tier runs run_batched to convergence in both packages (ROADMAP
A17a's gate) and the serial Sweep.run.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_support import jax_bench_options, jax_sweep, to_numpy_tree
from tests.test_torch_trial import installed

torch.set_num_threads(1)
CASES = [{'user_options.wind.u_ref': 9.5}, {'user_options.wind.u_ref': 10.5}]


def sweeps():
    from awebox_tpu.api.sweep import Sweep as SweepJ
    from awebox_tpu_torch.api.sweep import Sweep as SweepT
    from awebox_tpu_torch.configs import bench_options
    return SweepJ(jax_bench_options(), CASES), SweepT(bench_options(), CASES)


def flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f'{prefix}.{k}'))
        return out
    return {prefix: np.asarray(tree)}


def test_batched_problem_is_the_reference_recipe():
    """Sweep.batched_problem from the installed anchor: after split_pins the
    bounds and free mask, every leaf of the two cases' P, and the start
    (the anchor's state in both lanes, mu = 1e-5, err = inf) equal to the
    JAX package's run_batched set-up, entry for entry."""
    from awebox_tpu_torch.opti.ipsolver import InteriorPointSolver
    sweep = sweeps()[1]
    lbf, ubf, P, state = sweep.batched_problem(installed('torch'), device='cpu')
    state_j, P_j, lbw_j, ubw_j, free_j = jax_sweep(2)
    lbw, ubw, free, _ = InteriorPointSolver.split_pins(lbf, ubf)
    for a, b in ((lbw, lbw_j), (ubw, ubw_j), (free, free_j)):
        np.testing.assert_array_equal(a, b)
    fp, fj = flat(P), flat(to_numpy_tree(P_j))
    assert set(fp) == set(fj)
    for k in fj:
        np.testing.assert_array_equal(fp[k], fj[k], err_msg=k)
    assert set(state) == set(state_j)
    for k in state_j:
        np.testing.assert_array_equal(state[k].numpy(), state_j[k], err_msg=k)


# two iterations from the anchor: the block direction there is determined to
# ~1% of the step (cond of the reduced system ~1e19; the lockstep test
# tests/test_torch_sweep_lockstep.py holds it to 0.3 of the step), so the
# cases' power after two steps agrees to ~1e-4 relative
TOL_TWO_STEPS = 1e-3


def test_run_batched_two_iterations_match_the_reference():
    """run_batched(n_iter=2) in both packages from the installed anchor: the
    same case labels, every case's iterate finite with max |eq| within 1e-4
    (its success test), the average power and period within TOL_TWO_STEPS
    relative of the JAX package's, and the batched loop's two iterations."""
    sj, st = sweeps()
    sj.run_batched(anchor_trial=installed('jax'), n_iter=2)
    st.run_batched(anchor_trial=installed('torch'), n_iter=2, device='cpu')
    assert st.n_iter == 2 and list(st.sweep_dict) == list(sj.sweep_dict)
    for label, rj in sj.sweep_dict.items():
        rt = st.sweep_dict[label]
        assert rt['success'] == rj['success'] and np.isfinite(rt['V_opt']).all()
        for k in ('avg_power_watts', 'time_period'):
            a, b = rt['global_outputs'][k], rj['global_outputs'][k]
            assert abs(a / b - 1.) <= TOL_TWO_STEPS, (label, k, a, b)
    labels, powers = st.power_curve()
    assert labels == ['9.5', '10.5'] and len(powers) == 2


def test_sweep_refusals():
    """run_batched(mesh=...) and plot_comparison raise by name; an override
    that maps onto no theta0 leaf raises."""
    from awebox_tpu_torch.api.sweep import Sweep, _override_theta0
    from awebox_tpu_torch.configs import bench_options
    sweep = Sweep(bench_options(), CASES)
    with pytest.raises(NotImplementedError, match='mesh'):
        sweep.run_batched(anchor_trial=installed('torch'), mesh=object(), device='cpu')
    with pytest.raises(NotImplementedError, match='plot_comparison'):
        sweep.plot_comparison()
    theta0 = installed('torch').solution.P['theta0']
    with pytest.raises(ValueError, match='theta0'):
        _override_theta0(theta0, {'nlp.n_k': 5})
    out = _override_theta0(theta0, {'user_options.wind.u_ref': 9.5})
    assert float(out['wind']['u_ref']) == 9.5 and float(theta0['wind']['u_ref']) == 10.


@pytest.mark.slow
@pytest.mark.parametrize('case', [0, 1])
def test_run_batched_matches_the_reference(case):
    """ROADMAP A17a's gate: Sweep.run_batched from the installed anchor
    (n_iter=200, its default tol 1e-7) in both packages, per case: the same
    success, the average power within 1e-6 and the period within 1e-6
    relative of the JAX package's (~4 min on the CPU, each)."""
    sj, st = sweeps()
    sj.run_batched(anchor_trial=installed('jax'), n_iter=200)
    st.run_batched(anchor_trial=installed('torch'), n_iter=200, device='cpu')
    label = list(sj.sweep_dict)[case]
    rj, rt = sj.sweep_dict[label], st.sweep_dict[label]
    assert rt['success'] == rj['success'] is True
    for k in ('avg_power_watts', 'time_period'):
        a, b = rt['global_outputs'][k], rj['global_outputs'][k]
        assert abs(a / b - 1.) <= 1e-6, (label, k, a, b)


@pytest.mark.slow
def test_serial_run_chains_the_cases():
    """Sweep.run over the two cases on the CPU, each Trial.optimize warm
    started from the previous case's solution: both cases solved, positive
    power rising with the wind, and an interpolated record each."""
    st = sweeps()[1]
    st.run(device='cpu')
    assert all(r['success'] for r in st.sweep_dict.values())
    labels, powers = st.power_curve()
    assert labels == ['9.5', '10.5'] and 0. < powers[0] < powers[1]
    assert all(st.plot_dict[label] is not None for label in labels)
