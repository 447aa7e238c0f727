"""cess_tpu_torch — the PyTorch/CUDA port of cess_tpu for NVIDIA Hopper.

The JAX package `cess_tpu` is the reference; this package imports none of
it (and never imports jax).  Host-only modules are copies
(ops/bls12_381.py, ops/_sswu_g1.py, ops/podr2.py, proof/backend.py,
proof/cpu_backend.py); device code is PyTorch plus four hand-written
CUDA kernels under csrc/ (K1 map, K2 GLV fold, K3 ladder, K4 pow chain),
each with a plain tensor twin used on CPU tensors.
"""

__version__ = "0.1.0"
