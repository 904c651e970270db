"""The batched wind-sweep refinement of the PyTorch port with its default
factor, the Ruiz-equilibrated Householder QR (parallel/refine.py,
auglu_factor='qr'), against the JAX package's QR recipe: the checks of
tests/test_torch_refine.py, which holds the LU factor, in a file of their own
so that the two factors' loops run side by side under pytest-xdist.

The JAX package's CPU QR "stalls near the 1e-5 tol"
(tests/test_batched_refine.py:66-67), so the loops are compared over three
iterations, not at convergence; the port alone does converge on the CPU.
"""
import pytest
import torch

from tests.test_torch_refine import converges_both_lanes, lockstep_with_jax

torch.set_num_threads(1)


def test_three_qr_iterations_in_lockstep_with_jax():
    """lockstep_with_jax with the QR factor on both sides."""
    lockstep_with_jax('qr')


@pytest.mark.slow
def test_port_converges_both_lanes_with_qr():
    """converges_both_lanes with the QR factor: 52 iterations on the CPU
    (LU: 22), the same average powers. In the slow tier for its length
    alone (1.5 to 5 minutes, more than twice the LU loop's)."""
    converges_both_lanes('qr')
