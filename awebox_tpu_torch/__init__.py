"""awebox_tpu_torch: the PyTorch / CUDA port of awebox_tpu.

The JAX package ``awebox_tpu`` is the reference; this package mirrors its
module tree (``awebox_tpu_torch/model/builder.py`` is the counterpart of
``awebox_tpu/model/builder.py``) and is held to its outputs by the
``tests/test_torch_*.py`` parity tests. It covers the batched wind-sweep
refinement of the 3-DOF single-kite power cycle and the single-problem
solve behind ``Trial.optimize``: options, model, collocation transcription,
structured derivatives via ``torch.func``, the host-driven interior-point
solver with its homotopy, the augmented-KKT interior-point direction and the
batched loop, with hand-written CUDA kernels (``csrc/``) for the KKT
assembly, the LU, QR and Cholesky factors and solves, and the per-lane step.
"""

__version__ = '0.1.0'

__all__ = ['Trial', 'Sweep']


def __getattr__(name):
    # lazy imports keep `import awebox_tpu_torch` light
    if name == 'Trial':
        from .api.trial import Trial
        return Trial
    if name == 'Sweep':
        from .api.sweep import Sweep
        return Sweep
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
