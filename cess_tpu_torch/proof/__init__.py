"""ProofBackend seam of the port: `cpu` (the host reference, a copy of the
JAX package's) and `torch` (the fused GPU pipeline, the default: on the
card unless `device="cpu"` is passed).  Both produce identical verdict
bitmaps for identical inputs."""

from .backend import ProofBackend, VerifyItem
from .cpu_backend import CpuBackend
from .torch_backend import TorchBackend


def get_backend(name: str = "torch", **kwargs) -> ProofBackend:
    if name == "cpu":
        return CpuBackend(**kwargs)
    if name == "torch":
        return TorchBackend(**kwargs)
    raise ValueError(f"unknown proof backend {name!r}")


__all__ = [
    "ProofBackend",
    "VerifyItem",
    "CpuBackend",
    "TorchBackend",
    "get_backend",
]
