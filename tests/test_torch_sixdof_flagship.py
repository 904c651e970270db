"""The JAX package's solved 6-DOF flagship state in the PyTorch port, on the
CPU in f64: tests/artifacts/flagship_coarse_nk20_d3.pkl (the JAX package's
Trial.save payload of the flagship's coarse stage, n_k=20, d=3: n=2713,
m=2504 + 180; numpy only) installed through api/trial.py::install_solution
into Trial(flagship_options(20, 3)).

- the port's f, eq and ineq at the payload's V_opt against the JAX
  package's under the same P (the final cost weights), within TOL relative
  and absolute (as tests/test_torch_model.py: at the solution each scaled
  dynamics row is the cancellation of O(1) terms down to ~1e-12, so its
  floor is absolute), and the dynamics residual as small;
- the installed solution's global outputs: the stored power and period
  within 1e-9 relative;
- install_solution's checks: the payload's options are the flagship's, its
  duals and stats are the solution's, and a payload of another grid, a
  V_opt off the dynamics or a theta_opt other than V_opt's is refused.
"""
import copy
import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_support import HERE, to_numpy_tree

torch.set_num_threads(1)
PAYLOAD = os.path.join(HERE, 'artifacts', 'flagship_coarse_nk20_d3.pkl')
POWER, PERIOD = 4739.506282714117, 36.52297252328758
TOL = 1e-12


@functools.lru_cache(maxsize=None)
def payload():
    with open(PAYLOAD, 'rb') as fh:
        return pickle.load(fh)


@functools.lru_cache(maxsize=None)
def port_trial():
    from awebox_tpu_torch.api.trial import Trial, install_solution
    from awebox_tpu_torch.configs import flagship_options
    trial = Trial(flagship_options(20, 3), 'flagship').build()
    assert install_solution(trial, PAYLOAD, eq_tol=1e-8)
    return trial


@functools.lru_cache(maxsize=None)
def jax_values():
    """The JAX package's f, eq and ineq at V_opt, built from the payload's
    own options tree, under the final cost weights and the reference from
    V_init; and that P, numpy."""
    from awebox_tpu.api.trial import Trial
    from awebox_tpu.opti import homotopy as hm
    from awebox_tpu.opti.initialization import build_reference
    from awebox_tpu.options.options import Options
    pl = payload()
    trial = Trial(Options.from_tree(pl['options_tree']), 'flagship').build()
    ocp = trial.ocp
    P = hm.build_p_fix(ocp, build_reference(ocp, np.asarray(pl['V_init'])))
    P['cost'] = {k: np.asarray(v) for k, v in hm.final_cost_values(ocp).items()}
    P = to_numpy_tree(P)
    V = jnp.asarray(pl['V_opt'])
    vals = [np.asarray(jax.jit(fn)(V, P)) for fn in (ocp.f_fn, ocp.eq_fn, ocp.ineq_fn)]
    return vals, P


def same_tree(a, b, path=''):
    """Paths where two options trees differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f'{path}.{k}' for k in set(a) ^ set(b)]
        for k in set(a) & set(b):
            out += same_tree(a[k], b[k], f'{path}.{k}')
        return out
    try:
        equal = np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))
    except ValueError:
        equal = False
    return [] if equal else [path]


def test_payload_is_the_flagship_coarse_stage():
    """The payload's options are flagship_options(20, 3)'s, and the port
    builds its problem at the payload's size."""
    from awebox_tpu_torch.configs import flagship_options
    pl = payload()
    assert same_tree(flagship_options(20, 3).as_dict(), pl['options_tree']) == []
    ocp = port_trial().ocp
    assert (ocp.vstruct.total, ocp.n_eq, ocp.n_ineq) == (2713, 2504, 180)


@pytest.mark.parametrize('which', ['f', 'eq', 'ineq'])
def test_nlp_functions_at_the_solution_match(which):
    from awebox_tpu_torch.tree import to_tensors
    vals_j, P = jax_values()
    i = ('f', 'eq', 'ineq').index(which)
    ocp = port_trial().ocp
    fn = (ocp.f_fn, ocp.eq_fn, ocp.ineq_fn)[i]
    b = fn(torch.as_tensor(np.array(payload()['V_opt'])), to_tensors(P, torch.float64, 'cpu'))
    a, b = vals_j[i], b.numpy()
    assert a.shape == b.shape == ((), (2504,), (180,))[i]
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    if which == 'eq':
        # the dynamics hold at the solution in both packages, equally well
        assert np.abs(a).max() <= 1e-10 and np.abs(b).max() <= 1e-10
        assert abs(np.abs(b).max() - np.abs(a).max()) <= TOL


def test_installed_solution_outputs_match_the_stored_ones():
    trial = port_trial()
    go = trial.global_outputs()
    assert abs(go['avg_power_watts'] / POWER - 1.) <= 1e-9
    assert abs(go['time_period'] / PERIOD - 1.) <= 1e-9
    stored = payload()['global_outputs']
    assert abs(go['e_final_joules'] / stored['e_final_joules'] - 1.) <= 1e-9
    for k, v in payload()['theta_opt'].items():
        np.testing.assert_allclose(trial.theta_opt()[k], v, rtol=1e-12, atol=0.)


def test_installed_solution_carries_the_state_and_stats():
    trial = port_trial()
    pl = payload()
    sol = trial.solution
    assert sol.success and trial.solve_succeeded
    np.testing.assert_array_equal(sol.V_opt, pl['V_opt'])
    np.testing.assert_array_equal(trial.V_init, pl['V_init'])
    for k in ('w', 's', 'y', 'lam', 'zl', 'zu'):
        np.testing.assert_array_equal(sol.final_state[k], pl['duals'][k])
    assert sol.stats['iterations'] == pl['stats']['iterations']
    assert sol.step_results['final_0']['iterations'] == pl['stats']['iterations']['final_0']
    assert trial._final_homotopy_step == 'final'


@pytest.mark.parametrize('spoil', ['grid', 'dynamics', 'theta_opt'])
def test_install_solution_refuses_a_payload_that_does_not_fit(spoil):
    """A payload of another grid (the 20-interval state on the 6-DOF n_k=4
    problem), a V_opt off the dynamics (one position entry moved) or a
    theta_opt other than V_opt's is refused, and the trial keeps no
    solution."""
    from awebox_tpu_torch.api.trial import Trial, install_solution
    from awebox_tpu_torch.configs import flagship_options
    pl = copy.deepcopy(payload())
    if spoil == 'grid':
        trial = Trial(flagship_options(4, 3), 'small').build()
    else:
        trial = Trial(flagship_options(20, 3), 'flagship_spoiled').build()
        if spoil == 'dynamics':
            pl['V_opt'][trial.ocp.vstruct.x_slice(3).start] += 0.1
        else:
            pl['theta_opt']['diam_t'] = pl['theta_opt']['diam_t'] * (1. + 1e-6)
    assert not install_solution(trial, pl, eq_tol=1e-4)
    assert trial.solution is None
