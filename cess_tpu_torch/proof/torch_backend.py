"""TorchBackend — the port's ProofBackend on an NVIDIA GPU.

Verification runs inside the shared bisection of proof/backend.py, so
verdict bitmaps equal CpuBackend's, by one of two routes:

 * fused: the per-chunk pipeline of proof/fused.py, kernels K1–K4 on
   CUDA tensors;
 * staged: the JAX package's XlaBackend route off a TPU and on a mesh —
   the σ subgroup gate (one K3 [r]-chain), the Fr limb contraction of μ,
   and one K3 ladder fold per MSM (σ^ρ, the per-item H fold, its ρ fold,
   the u fold), each stage ending in host values.  On the card, at batch
   scale, the chunk points are hashed on the device (K1 with K4) and stay
   there for the H fold, with h_eff folded into the coefficients; on the
   CPU they are hashed on the host.

`fused` picks the route as XlaBackend's does: None (the default) is the
fused route without a mesh and the staged route with one; True is the
fused route and refuses a mesh (the fused pipeline is single-device, so
a mesh beside it would be silently ignored); False is the staged route.
`mesh` (parallel/verify.py Mesh, of the backend's device type) shards the
staged route's μ combination over its ranks (parallel.combine_mu_sharded);
the σ gate and the folds stay on `device`, as in the JAX package.

Proving aggregates μ with the Fr limb contraction (ops/fr.py) and σ with
one grouped ladder (K3) per chunk of fragments.

`device=None` means CUDA; construction fails when no CUDA device is
present.  `device="cpu"` runs every kernel's plain tensor twin (the CPU
test path).
"""

from __future__ import annotations

import os
import threading
import time as _time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import bls12_381 as bls
from ..ops import fr, g1, glv, h2c, podr2
from ..ops.bls12_381 import G1Point, G2Point
from ..ops.podr2 import Podr2Params, Podr2Proof
from . import frontend
from .backend import ProofBackend, ProveRequest, VerifyItem
from .fused import combined_check_fused, pack_points_limbs

# Fragment-axis chunk for prove_batch (bounds host staging and device
# footprint: 47×265×36 limb bytes ≈ 448 KB per fragment).
_PROVE_CHUNK = 1024

# Challenge coefficients are 20-byte randoms; batch weights ρ are 128-bit
# by construction (podr2.batch_rho).
_COEFF_BITS = 160
_RHO_BITS = 128
# Coefficients reach the device H fold multiplied by the effective
# cofactor (ops/h2c.py's cofactor-folding contract): 160 + 64 bits.
_COEFF_HEFF_BITS = _COEFF_BITS + 64

# Below this many (proof, chunk) pairs the staged route hashes the chunk
# points on the host (native hash_to_g1) even on the card.
_DEVICE_H2C_MIN_PAIRS = 256


# ------------------------------------------------------- stage telemetry
#
# Always-on per-stage histograms of the combined check, in a process-wide
# registry of their own, as cess_tpu/proof/xla_backend.py keeps them: any
# host embedding a backend (node RPC, TEE client) exposes them without
# threading a registry through the proof API, and the node's
# `system_metrics` merges this registry into its exposition
# (node/rpc.py).  The names are the JAX package's, so both expositions
# list the same families: the fused route (proof/fused.py) marks
# host_prep, chunk_program, dispatch_wait, u_fold and pairing; the staged
# route marks host_prep, sigma_fold, u_fold, sigma_fold, chunk_program,
# u_fold and pairing, in the JAX package's order.  A mark is one
# perf_counter call and one locked observe; CESS_STAGE_METRICS=0 switches
# the marks off.

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


def _stage_marker(stages: dict | None):
    """mark(name, t0): charge the wall clock since t0 to stage `name` in
    `stages` (when given) and in the process-wide histograms (unless
    CESS_STAGE_METRICS=0); returns the new t0.  Honest only where the
    stage ends in host values: a stage that leaves work queued on the
    card must synchronise first, or its time moves to the next mark."""
    metered = STAGE_METRICS_ENABLED

    def mark(name: str, t0: float) -> float:
        if not metered and stages is None:
            return t0
        now = _time.perf_counter()
        if stages is not None:
            stages[name] = stages.get(name, 0.0) + (now - t0)
        if metered:
            _observe_stage(name, now - t0)
        return now

    return mark


def _count_check(n_items: int, check_t0: float) -> None:
    """Bump the cess_proof* counters for one combined check that reached
    its folds."""
    if STAGE_METRICS_ENABLED:
        proof_stage_registry()
        _stage_counters["checks"].inc()
        _stage_counters["proofs"].inc(n_items)
        _stage_counters["seconds"].inc(_time.perf_counter() - check_t0)


def _subgroup_ok(points: list[G1Point], device: torch.device) -> bool:
    """True iff every point is in the r-order subgroup (or ∞): one K3
    [r]-chain over the batch (glv.subgroup_mask) on the card, the host
    ladder on the CPU — the deferred test behind
    g1_decompress_batch(check_subgroup=False).  The route follows the
    backend's device and nothing else."""
    if not points:
        return True
    if device.type != "cuda":
        return all(p.in_subgroup() for p in points)
    X, Y, Z = (torch.as_tensor(a, device=device) for a in pack_points_limbs(points))
    return bool((glv.subgroup_mask(X, Y, Z) == 1).all())


def h_fold_pairs(items: list[VerifyItem]):
    """The staged H fold's (name, index) pairs: (names, name_ids,
    indices, counts), with zip-truncation semantics, as the host
    reference's zip(coefficients(), indices)."""
    B = len(items)
    names = [name for name, _, _ in items]
    counts = [min(len(ch.indices), len(ch.randoms)) for _, ch, _ in items]
    name_ids = np.repeat(np.arange(B, dtype=np.uint32), counts)
    indices = np.concatenate(
        [np.asarray(ch.indices[:c], dtype=np.uint64) for (_, ch, _), c in zip(items, counts)]
    )
    return names, name_ids, indices, counts


def h_fold_grouped(items: list[VerifyItem], counts: list[int], points) -> list[G1Point]:
    """Per-item Π_c [v_c·h_eff]Q_c over the uncleared hash points (X, Y,
    Z) of `h_fold_pairs`' pairs, in pair order: one grouped K3 fold at
    224 bits on the points' device, and its tree."""
    B = len(items)
    device = points[0].device
    # each item's lanes padded to a power-of-two group; a dead lane
    # has scalar 0, an ∞ contribution whatever point it gathers
    g = 1 << max(0, (max(counts) - 1).bit_length())
    lane_map = np.zeros((B, g), dtype=np.int64)
    digits = np.zeros((B, g, g1.R_LIMBS), dtype=np.int32)
    cache: dict[int, np.ndarray] = {}
    pos = 0
    for b, ((_, ch, _), cnt) in enumerate(zip(items, counts)):
        for k, v in enumerate(ch.coefficients()[:cnt]):
            if v not in cache:
                cache[v] = g1.scalars_to_digits([v * h2c.H_EFF], g1.R_LIMBS)[:, 0]
            lane_map[b, k] = pos + k
            digits[b, k] = cache[v]
        pos += cnt
    flat = torch.as_tensor(lane_map.reshape(-1), device=device)
    s = g1.limbs_from_numpy(digits.reshape(B * g, g1.R_LIMBS).T, device)
    rX, rY, rZ = g1._msm_kernel(
        *(c.index_select(1, flat) for c in points), s,
        bits=_COEFF_HEFF_BITS, group=g,
    )
    return g1.projective_to_points(rX.T, rY.T, rZ.T)


class TorchBackend(ProofBackend):
    name = "torch"

    def __init__(self, device=None, fused: bool | None = None, mesh=None) -> None:
        self.device = resolve_device(device)
        if mesh is not None:
            mesh.require_type(self.device)
        if fused and mesh is not None:
            raise ValueError(
                "fused=True is single-device and incompatible with a "
                "mesh; use fused=None/False on meshed backends"
            )
        self.mesh = mesh
        self.fused = fused
        # wall seconds per stage, accumulated over every check
        self.stage_seconds: dict[str, float] = {}
        # H points of one verify_batch call: the bisection revisits the
        # same (name, index) pairs, so each is hashed once per call
        self._h_memo: dict[tuple[bytes, int], G1Point] = {}

    # ------------------------------------------------------------ verify

    def _chunk_points(self, pairs: list[tuple[bytes, int]]) -> list[G1Point]:
        missing = [p for p in pairs if p not in self._h_memo]
        if missing:
            for p, pt in zip(missing, podr2.chunk_points_batch(missing)):
                self._h_memo[p] = pt
        return [self._h_memo[p] for p in pairs]

    def _h_inner_fold_device(self, items: list[VerifyItem]) -> list[G1Point]:
        """Per-item Π_c H(name‖i_c)^{v_c} on the device: host XMD → SSWU
        map (K1 with K4; uncleared points) → one grouped K3 fold with
        v_c·h_eff scalars ([v·h_eff]Q = [v]([h_eff]Q), so the result is
        the cleared fold).  The scalars are NOT reduced mod r: the points
        have order h·r."""
        names, name_ids, indices, counts = h_fold_pairs(items)
        (X, Y, Z), _ = h2c.hash_pairs_device(
            names, name_ids, indices, podr2.H_DST, device=self.device
        )
        return h_fold_grouped(items, counts, (X, Y, Z))

    @torch.inference_mode()
    def _combined_check(self, pk, items, seed, params: Podr2Params) -> bool:
        """One pairing equation for the whole batch:

          e(Π_b σ_b^{ρ_b}, −g2) · e(Π_b (Π_c H_{b,c}^{v_c})^{ρ_b}
                                     · Π_j u_j^{Σ_b ρ_b μ_bj}, pk) == 1
        """
        if not items:
            return True
        if self.fused is not False and self.mesh is None:
            return combined_check_fused(
                pk, items, seed, params, stages=self.stage_seconds,
                device=self.device,
            )
        mark = _stage_marker(self.stage_seconds)
        dev = self.device
        # the front end sits after check_t0, as on the fused route; early
        # rejections return before any mark
        check_t0 = t0 = _time.perf_counter()
        try:
            pk_point = G2Point.from_bytes(pk)
        except ValueError:
            return False
        sigmas = frontend.decompress_sigmas(items)
        if sigmas is None:
            return False
        if any(len(p.mu) != params.s for _, _, p in items):
            return False
        encs = frontend.encode_proofs(items)
        if encs is None:
            return False
        words = frontend.mu_words(encs, params.s)
        if not frontend.mu_in_range(words):
            return False
        batch_items = [podr2.BatchItem(n, c, p) for n, c, p in items]
        rhos = podr2.batch_rho(
            podr2.batch_transcript(seed, batch_items, encodings=encs), len(items)
        )
        mu_limbs = frontend.mu_limbs(words)
        t0 = mark("host_prep", t0)

        # σ subgroup gate, deferred from decompression
        sub_ok = _subgroup_ok(sigmas, dev)
        t0 = mark("sigma_fold", t0)
        if not sub_ok:
            return False

        # u-side exponents Σ_b ρ_b μ_bj, sharded over the mesh when one is
        # given (ρ=0 padding rows contribute nothing)
        if self.mesh is not None:
            from ..parallel import combine_mu_sharded, pad_batch_rows

            n = self.mesh.size
            exps = fr.limbs_to_ints(combine_mu_sharded(
                self.mesh, pad_batch_rows(frontend.rho_limbs7(rhos), n),
                pad_batch_rows(mu_limbs, n),
            ))
        else:
            exps = fr.limbs_to_ints(fr.combine_mu(rhos, mu_limbs, dev))
        t0 = mark("u_fold", t0)

        lhs = g1.msm(sigmas, rhos, bits=_RHO_BITS, device=dev)
        t0 = mark("sigma_fold", t0)

        # H side: per-item Π_c H^{v_c}, then the ρ fold across items
        n_pairs = sum(len(ch.indices) for _, ch, _ in items)
        if dev.type == "cuda" and n_pairs >= _DEVICE_H2C_MIN_PAIRS:
            inner = self._h_inner_fold_device(items)
        else:
            counts = [min(len(ch.indices), len(ch.randoms)) for _, ch, _ in items]
            flat = self._chunk_points(
                [(name, i) for (name, ch, _), c in zip(items, counts) for i in ch.indices[:c]]
            )
            h_pts, pos = [], 0
            for c in counts:
                h_pts.append(flat[pos : pos + c])
                pos += c
            h_coeffs = [list(ch.coefficients()[:c]) for (_, ch, _), c in zip(items, counts)]
            inner = g1.msm_grouped(h_pts, h_coeffs, bits=_COEFF_BITS, device=dev)
        rhs = g1.msm(inner, rhos, bits=_RHO_BITS, device=dev)
        t0 = mark("chunk_program", t0)

        rhs = rhs + g1.msm(list(podr2.u_generators(params.s)), exps, device=dev)
        t0 = mark("u_fold", t0)

        verdict = bls.pairing_check([(lhs, -bls.G2_GENERATOR), (rhs, pk_point)])
        mark("pairing", t0)
        _count_check(len(items), check_t0)
        return verdict

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

        self._h_memo = {}
        try:
            return self._verdicts_by_bisection(
                pk, items, seed, params, self._combined_check, single_check
            )
        finally:
            self._h_memo = {}

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
        """The scalar path's 'point not in G1 subgroup' ValueError."""
        if not _subgroup_ok(points, self.device):
            raise ValueError("point not in G1 subgroup")
