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

import os
import threading

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


# ------------------------------------------------------- stage telemetry
#
# Always-on per-stage histograms of the combined check, in a process-wide
# registry of their own, as cess_tpu/proof/xla_backend.py keeps them: any
# host embedding a backend (node RPC, TEE client) exposes them without
# threading a registry through the proof API, and the node's
# `system_metrics` merges this registry into its exposition
# (node/rpc.py).  The names are the JAX package's, so both expositions
# list the same families: the fused path (proof/fused.py, the only verify
# path of the port) marks host_prep, chunk_program, dispatch_wait, u_fold
# and pairing, and `sigma_fold` (a stage of the JAX package's staged
# path) stays at count 0.  A mark is one perf_counter call and one locked
# observe; CESS_STAGE_METRICS=0 switches the marks off.

STAGE_NAMES = ("host_prep", "u_fold", "sigma_fold", "chunk_program",
               "dispatch_wait", "pairing")
STAGE_METRICS_ENABLED = os.environ.get(
    "CESS_STAGE_METRICS", "1") not in ("0", "false", "off")

_stage_lock = threading.Lock()
_stage_registry = None
_stage_hists: dict = {}
_stage_counters: dict = {}

_STAGE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def proof_stage_registry():
    """The process-wide metrics registry for the proof data plane
    (created on first use; node/metrics is imported lazily to keep the
    proof↔node package import graph acyclic)."""
    global _stage_registry
    with _stage_lock:
        if _stage_registry is None:
            from ..node import metrics as m

            reg = m.Registry()
            for name in STAGE_NAMES:
                _stage_hists[name] = m.Histogram(
                    f"cess_proof_stage_{name}_seconds",
                    f"combined-check {name} stage time",
                    buckets=_STAGE_BUCKETS, registry=reg)
            _stage_counters["proofs"] = m.Counter(
                "cess_proofs_verified",
                "proof items covered by combined checks", reg)
            _stage_counters["checks"] = m.Counter(
                "cess_proof_checks",
                "combined pairing checks executed", reg)
            _stage_counters["seconds"] = m.Counter(
                "cess_proof_verify_seconds_total",
                "wall-clock seconds spent in combined checks", reg)
            _stage_registry = reg
    return _stage_registry


def _observe_stage(name: str, seconds: float) -> None:
    proof_stage_registry()
    _stage_hists[name].observe(seconds)


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
