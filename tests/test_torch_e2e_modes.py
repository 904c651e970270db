"""The end-to-end configurations of tests/test_e2e_configs.py in the PyTorch
port against the JAX package (tests/e2e_parity.py): drag mode and the
Reynolds-dependent tether drag, with their structured derivatives."""
from tests.e2e_parity import parity_tests, structured_tests

globals().update(parity_tests(['drag_mode', 'reynolds_cd']))
globals().update(structured_tests(['drag_mode', 'reynolds_cd']))
