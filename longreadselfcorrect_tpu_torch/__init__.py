"""longreadselfcorrect_tpu_torch — the PyTorch/CUDA port of longreadselfcorrect_tpu.

Mirrors the JAX package's layout (core/, index/, io/, ops/, cli.py).  The
host engine (numpy) is kept as its own copy; the device seed phase runs as
hand-written CUDA kernels (csrc/) on CUDA tensors and as plain torch on
CPU tensors.  Imports torch and numpy, never jax.
"""

__version__ = "0.1.0"
