"""The end-to-end configurations of tests/test_e2e_configs.py in the PyTorch
port against the JAX package (tests/e2e_parity.py): the dual kites on a
Y-tether (with its structured derivatives), the integral outputs and the
polynomial controls (both dense-only)."""
from tests.e2e_parity import parity_tests, structured_tests

globals().update(parity_tests(['dual_kite', 'integral_outputs', 'poly_controls']))
globals().update(structured_tests(['dual_kite']))
