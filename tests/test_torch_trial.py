"""The PyTorch port's Trial (awebox_tpu_torch/api/trial.py), its warm start
(api/warmstart.py) and post-processing (api/postprocessing.py) against the
JAX package's, on the CPU, in f64, from the committed anchor
(tests/artifacts/bench_anchor_nk4_d3.npz) installed as each package's
solution:

- remap_to_v of the anchor onto an n_k = 6, d = 2 grid;
- global_outputs, theta_opt and the interpolated solution of the anchor;
- Trial.optimize warm-started from the anchor with warmstart_schedule
  'resume' (the final step only), from a Trial and from a saved payload;
- optimize's refusals: no card without device='cpu', the KKT health check.

The slow tier runs the cold solve of the bench configuration on the CPU.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_torch_support import ANCHOR, anchor, jax_bench_options

torch.set_num_threads(1)


def jax_trial_of(n_k=4, d=3, **opts):
    from awebox_tpu.api.trial import Trial
    o = jax_bench_options(n_k)
    o['nlp.collocation.d'] = d
    for k, v in opts.items():
        o[k] = v
    return Trial(o, f'jax_{n_k}_{d}').build()


def torch_trial_of(n_k=4, d=3, **opts):
    from awebox_tpu_torch.api.trial import Trial
    from awebox_tpu_torch.configs import bench_options
    o = bench_options(n_k=n_k, d=d)
    for k, v in opts.items():
        o[k] = v
    return Trial(o, f'torch_{n_k}_{d}').build()


def installed(package, **opts):
    """A bench-configuration trial of ``package`` with the anchor installed as
    its final-step solution (the JAX package's through tests/conftest.py's
    loader, which records no completed step: it is set to 'final' here, as
    the port's install_anchor does)."""
    if package == 'jax':
        from tests.conftest import _install_solution_from_anchor
        trial = jax_trial_of(**opts)
        assert _install_solution_from_anchor(trial, ANCHOR)
        trial._final_homotopy_step = 'final'
    else:
        from awebox_tpu_torch.api.trial import install_anchor
        trial = torch_trial_of(**opts)
        assert install_anchor(trial, ANCHOR)
    return trial


@pytest.fixture(scope='module')
def pair():
    return installed('jax'), installed('torch')


def test_remap_to_v_matches_the_reference(pair):
    """The anchor's solution payload remapped onto an n_k = 6, d = 2 grid (its
    states through the source's collocation polynomials, zoh controls by
    interval, theta and phi copied): the same V as the JAX package's, to
    1e-12 of max |V|."""
    from awebox_tpu.api import warmstart as ws_j
    from awebox_tpu_torch.api import warmstart as ws_t
    src_j, src_t = pair
    dst_j, dst_t = jax_trial_of(6, 2), torch_trial_of(6, 2)
    Vj = ws_j.remap_to_v(ws_j.solution_payload(src_j), dst_j.ocp)
    Vt = ws_t.remap_to_v(ws_t.solution_payload(src_t), dst_t.ocp)
    assert Vt.shape == Vj.shape == (dst_t.ocp.vstruct.total,)
    assert np.abs(Vt - Vj).max() <= 1e-12 * np.abs(Vj).max()


def test_installed_anchor_outputs_match_the_reference(pair):
    """global_outputs (period, final energy, average power) and theta_opt of
    the installed anchor: within 1e-12 relative of the JAX package's, and the
    power and period those the anchor recorded; the solution table names
    them."""
    tj, tt = pair
    gj, gt = tj.global_outputs(), tt.global_outputs()
    for k in gj:
        assert abs(gt[k] - gj[k]) <= 1e-12 * abs(gj[k]), k
    a = anchor()
    assert abs(gt['avg_power_watts'] / float(a['avg_power_watts']) - 1.) <= 1e-9
    assert abs(gt['time_period'] / float(a['time_period']) - 1.) <= 1e-9
    thj, tht = tj.theta_opt(), tt.theta_opt()
    assert set(thj) == set(tht)
    for k in thj:
        np.testing.assert_allclose(tht[k], np.asarray(thj[k]), rtol=1e-12, atol=0)
    table = tt.solution_table()
    assert 'average power' in table and 'theta t_f' in table
    np.testing.assert_allclose(tt.x_traj_si('q10'), np.asarray(tj.x_traj_si('q10')), rtol=1e-12)


def test_interpolation_and_csv_match_the_reference(pair, tmp_path):
    """interpolate(40) of the installed anchor: the time grid, states, their
    derivatives, controls, algebraic variables and every model output within
    1e-10 relative of the JAX package's; write_to_csv writes the same header
    and the same numbers."""
    tj, tt = pair
    pj, pt = tj.interpolate(40), tt.interpolate(40)
    for group in ('x', 'xdot', 'u', 'z'):
        assert set(pt[group]) == set(pj[group]), group
        for k in pj[group]:
            b = np.asarray(pj[group][k])
            assert np.abs(pt[group][k] - b).max() <= 1e-10 * max(np.abs(b).max(), 1.), (group, k)
    np.testing.assert_allclose(pt['time_grids']['ip'], pj['time_grids']['ip'], rtol=1e-12)

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f'{prefix}.{k}')
        else:
            yield prefix, np.asarray(tree)
    out_j, out_t = dict(leaves(pj['outputs'])), dict(leaves(pt['outputs']))
    assert set(out_t) == set(out_j)
    for k, b in out_j.items():
        assert np.abs(out_t[k] - b).max() <= 1e-10 * max(np.abs(b).max(), 1.), k
    fj, ft = tt.write_to_csv(str(tmp_path / 't.csv')), tj.write_to_csv(str(tmp_path / 'j.csv'))
    rows = [np.genfromtxt(p, delimiter=',', names=True) for p in (fj, ft)]
    assert rows[0].dtype.names == rows[1].dtype.names
    for name in rows[1].dtype.names:
        np.testing.assert_allclose(rows[0][name], rows[1][name], rtol=1e-10, atol=1e-10)


# The final step re-solved from the anchor's remapped primal (fresh duals,
# mu = 1e-2) wanders: the JAX package's solve runs its 2000-iteration cap
# from there (and stops at 9547.9 W). The parity test cuts it to RESUME_ITERS
# iterations in both packages.
RESUME_ITERS = 6


def test_resume_from_the_anchor_matches_the_reference(pair):
    """Trial.optimize(warmstart=<the installed anchor>,
    warmstart_schedule='resume'), solver.max_iter = RESUME_ITERS: only the
    final step runs, with the same status and iterations (within 2) as the
    JAX package's same call, and the average power within 1e-8 relative."""
    src_j, src_t = pair
    tj = jax_trial_of(**{'solver.max_iter': RESUME_ITERS})
    tt = torch_trial_of(**{'solver.max_iter': RESUME_ITERS})
    tj.optimize(warmstart=src_j, warmstart_schedule='resume', verbose=False)
    tt.optimize(warmstart=src_t, warmstart_schedule='resume', verbose=False, device='cpu')
    assert list(tt.solution.stats['iterations']) == ['final_0']
    rj, rt = tj.solution.step_results['final_0'], tt.solution.step_results['final_0']
    assert rt['status'] == rj['status'] and abs(rt['iterations'] - rj['iterations']) <= 2
    assert tt.solve_succeeded == tj.solve_succeeded
    pj, pt = tj.global_outputs()['avg_power_watts'], tt.global_outputs()['avg_power_watts']
    assert abs(pt / pj - 1.) <= 1e-8


def test_saved_payload_warmstart_resumes_as_the_trial_does(pair, tmp_path):
    """A payload file (the anchor's solution_payload and its completed step)
    warm-starts optimize as the Trial it came from does: with 'auto' it
    resumes after the recorded step, and the iterates are the same bits."""
    from awebox_tpu_torch.api import warmstart as ws
    src = pair[1]
    path = str(tmp_path / 'anchor.pkl')
    with open(path, 'wb') as fh:
        pickle.dump({'remap': ws.solution_payload(src), 'final_homotopy_step': 'final'}, fh)
    a = torch_trial_of(**{'solver.max_iter': 2})
    b = torch_trial_of(**{'solver.max_iter': 2})
    a.optimize(warmstart=path, verbose=False, device='cpu')
    b.optimize(warmstart=src, warmstart_schedule='resume', verbose=False, device='cpu')
    assert list(a.solution.stats['iterations']) == ['final_0']
    assert np.array_equal(a.solution.V_opt, b.solution.V_opt)


def test_optimize_refusals():
    """Without a card optimize raises unless asked for the CPU; a KKT health
    check other than 'never', plot and check_quality raise by name."""
    tt = torch_trial_of()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.optimize(verbose=False)
    hc = torch_trial_of(**{'solver.health_check.when': 'final'})
    with pytest.raises(NotImplementedError, match='health'):
        hc.optimize(verbose=False, device='cpu')
    for call in (tt.plot, tt.check_quality, tt.health_check):
        with pytest.raises(NotImplementedError, match='not ported'):
            call()


@pytest.mark.slow
def test_cold_solve_on_the_cpu_reaches_the_anchor():
    """The cold homotopy solve of the bench configuration on the CPU: every
    step solved, the JAX package's iterations a step (23, 5, 2, 30, 1, 47),
    and the average power and period within 1e-6 relative of the anchor's
    (~7 min on one core)."""
    tt = torch_trial_of()
    tt.optimize(verbose=False, device='cpu')
    assert tt.solve_succeeded
    assert tt.solution.stats['iterations'] == {
        'initial_0': 23, 'fictitious_0': 5, 'fictitious_1': 2, 'power_0': 30, 'power_1': 1,
        'final_0': 47}
    a = anchor()
    go = tt.global_outputs()
    assert abs(go['avg_power_watts'] / float(a['avg_power_watts']) - 1.) <= 1e-6
    assert abs(go['time_period'] / float(a['time_period']) - 1.) <= 1e-6
