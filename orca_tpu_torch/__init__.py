"""orca_tpu_torch — the PyTorch/CUDA port of orca_tpu for NVIDIA Hopper.

Mirrors the JAX package's module names (utils, ops, nn, models, data,
predict, viz, colormaps) and its channels-last layouts. The bp-resolution encoder tower runs as
hand-written CUDA kernels (csrc/, built with nvcc on first use); the rest is
PyTorch. Entry points take `device=None`, meaning CUDA, and raise when CUDA is
absent; pass device="cpu" to run the plain versions on the CPU.
"""

__version__ = "0.1.0"
