"""The end-to-end configurations of tests/test_e2e_configs.py in the PyTorch
port against the JAX package (tests/e2e_parity.py): the actuator-disk
(qaxi) model with its structured derivatives, the trajectory-averaged
induction model (dense-only), and the 'single' homotopy with its structured
derivatives."""
from tests.e2e_parity import parity_tests, structured_tests

globals().update(parity_tests(['actuator_qaxi', 'averaged_induction', 'single_homotopy']))
globals().update(structured_tests(['actuator_qaxi', 'single_homotopy']))
