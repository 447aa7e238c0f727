"""TorchBackend — the port's ProofBackend on an NVIDIA GPU.

Verification runs the fused per-chunk pipeline of proof/fused.py (kernels
K1–K4 on CUDA tensors) inside the shared bisection of proof/backend.py,
so verdict bitmaps equal CpuBackend's.  Proving aggregates μ with the Fr
limb contraction (ops/fr.py) and σ with one grouped ladder (K3) per
chunk of fragments.

`device=None` means CUDA; construction fails when no CUDA device is
present.  `device="cpu"` runs every kernel's plain tensor twin (the CPU
test path).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bls12_381 as bls
from ..ops import fr, g1, glv, podr2
from ..ops.bls12_381 import G1Point
from ..ops.podr2 import Podr2Params, Podr2Proof
from .backend import ProofBackend, ProveRequest, VerifyItem
from .fused import combined_check_fused, pack_points_limbs

# Fragment-axis chunk for prove_batch (bounds host staging and device
# footprint: 47×265×36 limb bytes ≈ 448 KB per fragment).
_PROVE_CHUNK = 1024

# Challenge coefficients are 20-byte randoms.
_COEFF_BITS = 160


class TorchBackend(ProofBackend):
    name = "torch"

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        # wall seconds per fused stage, accumulated over every check
        self.stage_seconds: dict[str, float] = {}

    # ------------------------------------------------------------ verify

    def _combined_check(self, pk, items, seed, params: Podr2Params) -> bool:
        return combined_check_fused(
            pk, items, seed, params, stages=self.stage_seconds,
            device=self.device,
        )

    def verify_batch(
        self,
        pk: bytes,
        items: list[VerifyItem],
        seed: bytes,
        params: Podr2Params,
    ) -> list[bool]:
        def single_check(pk_, item, params_):
            name, challenge, proof = item
            return podr2.verify(pk_, name, challenge, proof, s=params_.s)

        return self._verdicts_by_bisection(
            pk, items, seed, params, self._combined_check, single_check
        )

    # ------------------------------------------------------------ prove

    def prove_batch(self, request: ProveRequest) -> list[Podr2Proof]:
        """μ from the challenged sector rows only (ops/fr.py), σ as one
        grouped ladder over the challenged tags per chunk."""
        params = request.params
        challenge = request.challenge
        coeffs = challenge.coefficients()
        proofs: list[Podr2Proof] = []
        for start in range(0, len(request.data), _PROVE_CHUNK):
            chunk_data = request.data[start : start + _PROVE_CHUNK]
            chunk_tags = request.tags[start : start + _PROVE_CHUNK]
            batches = []
            for data in chunk_data:
                matrix = podr2.fragment_sectors(data, params)
                batches.append(
                    fr.sectors_to_limbs([matrix[i] for i in challenge.indices])
                )
            mu_all = fr.mu_aggregate(coeffs, np.stack(batches), self.device)
            flat = bls.g1_decompress_batch(
                [tags[i] for tags in chunk_tags for i in challenge.indices],
                check_subgroup=False,
            )
            self._require_subgroup(flat)
            k = len(challenge.indices)
            tag_pts = [flat[b * k : (b + 1) * k] for b in range(len(chunk_tags))]
            sigmas = g1.msm_grouped(
                tag_pts, [list(coeffs)] * len(tag_pts), bits=_COEFF_BITS,
                device=self.device,
            )
            for b, sigma in enumerate(sigmas):
                proofs.append(
                    Podr2Proof(sigma.to_bytes(), fr.limbs_to_ints(mu_all[b]))
                )
        return proofs

    def _require_subgroup(self, points: list[G1Point]) -> None:
        """The scalar path's 'point not in G1 subgroup' ValueError: one
        K3 [r]-chain over the batch on CUDA, the host ladder on the CPU
        path."""
        if not points:
            return
        if self.device.type == "cuda":
            X, Y, Z = (
                torch.as_tensor(a, device=self.device)
                for a in pack_points_limbs(points)
            )
            ok = bool((glv.subgroup_mask(X, Y, Z) == 1).all())
        else:
            ok = all(p.in_subgroup() for p in points)
        if not ok:
            raise ValueError("point not in G1 subgroup")
