"""awebox_tpu_torch: the PyTorch / CUDA port of awebox_tpu.

The JAX package ``awebox_tpu`` is the reference; this package mirrors its
module tree (``awebox_tpu_torch/model/builder.py`` is the counterpart of
``awebox_tpu/model/builder.py``) and is held to its outputs by the
``tests/test_torch_*.py`` parity tests. It covers the batched wind-sweep
refinement of the 3-DOF single-kite power cycle: options, model,
collocation transcription, structured derivatives via ``torch.func``, the
augmented-KKT interior-point direction and the batched loop, with
hand-written CUDA kernels (``csrc/``) for the KKT assembly, the batched LU
factor and solve, and the per-lane step.
"""

__version__ = '0.1.0'
