"""cess_tpu_torch — the PyTorch/CUDA port of cess_tpu for NVIDIA Hopper.

The JAX package `cess_tpu` is the reference; this package imports none of
it (and never imports jax).  Host-only modules are copies with their
imports bound to the port (ops/bls12_381.py, ops/_sswu_g1.py,
ops/podr2.py, ops/gf256.py, ops/rsa.py, proof/backend.py,
proof/cpu_backend.py, proof/frontend.py, proof/ias.py, the host parts of
ops/bls_agg.py and consensus/vrf.py, consensus/engine.py, utils/ and
chain/ with its multi-role simulator NodeSim, node/ with the CLI of
__main__.py, light/); native.py binds the C++
host core (native/*.cpp, built with g++ at first use) that hashes the
verify path's chunk points.  Device code is PyTorch plus four
hand-written CUDA kernels under csrc/ (K1 map, K2 GLV fold, K3 ladder, K4
pow chain), each with a plain tensor twin used on CPU tensors.  Device
code that the JAX package leaves to plain XLA (the Fr contractions, the
RS products, the RSA modexp of ops/bigmod.py) is plain torch.
"""

__version__ = "0.1.0"
