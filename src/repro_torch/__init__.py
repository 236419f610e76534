"""AcceleratedLiNGAM in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA port of the JAX/Pallas package ``repro``, with the same
module layout. It imports ``torch`` and numpy, never ``jax`` and nothing
of ``repro``. Entry points run on the CUDA card unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"
