"""Aggregate / batched BLS signature verification (BASELINE config 4).

The reference verifies miner/TEE BLS signatures one at a time
(utils/verify-bls-signatures/src/lib.rs:85-100: one 2-pairing check per
signature).  At audit scale — thousands of miners submitting signed
verdicts per round — that is 2N Miller loops.  This module re-expresses
the workload TPU-first:

 * **Small-exponent batch test.**  Draw Fiat–Shamir weights r_i (128-bit,
   nonzero, bound to the full (pk, msg, sig) transcript) and check

       e(Π_i sig_i^{r_i}, −g2) · Π_{K} e(Π_{i: pk_i=K} H(m_i)^{r_i}, K) == 1

   which holds iff every per-signature equation holds, except with
   probability ≤ 2^-128 over the weights (the prover cannot pick
   cancelling deviations because r depends on the submitted signatures —
   same argument as ops/podr2.py batch_transcript).

 * **Device G1 folds.**  Both the signature-side fold Π sig_i^{r_i}
   (`g1.msm`) and the per-key message folds Π H(m_i)^{r_i}
   (`g1.msm_grouped`) run on the card, each one K3 ladder launch
   (csrc/ladder.cu) at 128 bits and a pairwise tree; this is where the
   group exponentiations — the O(N) work — live.

 * **Pairing collapse by key.**  Pairings (host-side, O(1) each) shrink
   from 2N to 1 + #distinct-keys.  In the protocol the dominant batches
   are signed under few keys (the network-wide TeePodr2Pk,
   c-pallets/tee-worker/src/lib.rs:120-121, and per-TEE controller
   keys), so the pairing count is effectively constant.

`verify_signatures` recovers the per-signature verdict bitmap by
bisection when a batch fails, mirroring the ProofBackend contract
(proof/backend.py).

A copy of `cess_tpu/ops/bls_agg.py` bound to the port: the device entry
points take a torch device (None = the card, "cpu" = the plain tensor
twins) and, as the JAX package's do, an optional `mesh`
(parallel/verify.py Mesh, of the device's type) that shards the
signature-side fold over its ranks (parallel.msm_sharded); the message
folds stay on the device.  `verify_batch_host` keeps the pure-Python
folds and is reached only by name: a missing card never selects it.
"""

from __future__ import annotations

import hashlib
import time

from ..device import resolve_device
from . import bls12_381 as bls
from . import g1
from .bls12_381 import G1Point, G2Point

AGG_DST = b"CESS_TPU_BLS_AGG_V1"
_RHO_BITS = 128

# (pk bytes, msg bytes, sig bytes) — the argument order of the reference
# crate's entry point, verify_bls_signature(sig, msg, key), normalized to
# pk-first like ops/bls12_381.verify.
SigTriple = tuple[bytes, bytes, bytes]


def agg_transcript(seed: bytes, triples: list[SigTriple]) -> bytes:
    """Fiat–Shamir transcript binding the batch weights to every
    (pk, msg, sig) in the batch."""
    h = hashlib.blake2b(digest_size=32)
    h.update(AGG_DST)
    h.update(seed)
    for pk, msg, sig in triples:
        h.update(pk)
        h.update(hashlib.sha256(msg).digest())
        h.update(sig)
    return h.digest()


def batch_weights(transcript: bytes, count: int) -> list[int]:
    """128-bit nonzero weights, deterministic in the transcript."""
    out = []
    for b in range(count):
        digest = hashlib.blake2b(
            AGG_DST + transcript + b.to_bytes(8, "little"), digest_size=16
        ).digest()
        out.append(int.from_bytes(digest, "little") | 1)
    return out


def _hash_points(msgs: list[bytes]) -> list[G1Point]:
    """H(msg) per message, hashing each distinct message once."""
    memo: dict[bytes, G1Point] = {}
    for m in msgs:
        if m not in memo:
            memo[m] = bls.hash_to_g1(m)
    return [memo[m] for m in msgs]


def _batch_folds(sig_pts, rhos, groups, device, mesh=None):
    """The two G1 folds of the weighted equation: Π sig_i^{r_i} and, per
    key, Π H(m_i)^{r_i}.  device: a torch device (one K3 launch each,
    through g1.msm and g1.msm_grouped; with a mesh the signature fold is
    parallel.msm_sharded over its ranks instead), or None for the
    pure-Python host ladders.  Returns (signature fold, [fold per key in
    `groups` order])."""
    if device is not None:
        if mesh is not None:
            from ..parallel.msm import msm_sharded

            lhs = msm_sharded(mesh, sig_pts, rhos, bits=_RHO_BITS)
        else:
            lhs = g1.msm(sig_pts, rhos, bits=_RHO_BITS, device=device)
        folds = g1.msm_grouped(
            [pts for pts, _ in groups.values()],
            [rs for _, rs in groups.values()],
            bits=_RHO_BITS,
            device=device,
        )
        return lhs, folds
    lhs = G1Point.infinity()
    for sig, r in zip(sig_pts, rhos):
        lhs = lhs + sig._mul_raw(r)
    folds = []
    for pts, rs in groups.values():
        acc = G1Point.infinity()
        for h, r in zip(pts, rs):
            acc = acc + h._mul_raw(r)
        folds.append(acc)
    return lhs, folds


def _weighted_batch_check(
    triples: list[SigTriple], seed: bytes, device, stages: dict | None = None,
    mesh=None,
) -> bool:
    """THE weighted batch equation, shared by the device and host entry
    points: parse, Fiat–Shamir weights, per-key grouping and the pairs
    assembly are single-sourced on purpose — this check IS a consensus
    rule (block import on one node, catch-up batches on another must
    accept identical batches), so the two backends may only differ in
    HOW the two G1 folds are computed, never in what is folded.

    device: a torch device for the folds, or None for the host ladders;
    mesh: shards the signature fold (device folds only).  stages, when given, accumulates wall seconds under "parse", "hash",
    "folds" and "pairing"."""
    if not triples:
        return True
    clock = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        if stages is not None:
            stages[name] = stages.get(name, 0.0) + now - clock
        clock = now

    try:
        sig_pts = [G1Point.from_bytes(sig) for _, _, sig in triples]
        # decompress each DISTINCT key once: batches are signed under a
        # handful of authority keys, and G2 decompression (~46 ms of
        # sqrt + subgroup ladder) per TRIPLE was the dominant cost of a
        # 64-block import batch — a dict comprehension pays it before
        # the dict dedups
        pk_pts: dict[bytes, G2Point] = {}
        for pk, _, _ in triples:
            if pk not in pk_pts:
                pk_pts[pk] = G2Point.from_bytes(pk)
    except ValueError:
        return False
    rhos = batch_weights(agg_transcript(seed, triples), len(triples))
    lap("parse")

    # message-side grouping by distinct public key
    h_pts = _hash_points([msg for _, msg, _ in triples])
    groups: dict[bytes, tuple[list[G1Point], list[int]]] = {}
    for (pk, _, _), h, r in zip(triples, h_pts, rhos):
        pts, rs = groups.setdefault(pk, ([], []))
        pts.append(h)
        rs.append(r)
    lap("hash")

    lhs, folds = _batch_folds(sig_pts, rhos, groups, device, mesh)
    lap("folds")

    pairs = [(lhs, -bls.G2_GENERATOR)]
    pairs.extend((fold, pk_pts[k]) for k, fold in zip(groups, folds))
    ok = bls.pairing_check(pairs)
    lap("pairing")
    return ok


def batch_verify_signatures(
    triples: list[SigTriple], seed: bytes = b"", device=None,
    stages: dict | None = None, mesh=None,
) -> bool:
    """One combined pairing check for the whole batch.  False if ANY
    signature is invalid (or any pk/sig fails to parse).  device: None =
    the card (both folds through kernel K3), "cpu" = the plain tensor
    twins; without a card the default raises.  mesh: optional Mesh of the
    device's type; the signature-side fold is sharded over it.  stages:
    see `_weighted_batch_check`."""
    device = resolve_device(device)
    if mesh is not None:
        mesh.require_type(device)
    return _weighted_batch_check(triples, seed, device, stages, mesh)


def verify_signatures(
    triples: list[SigTriple], seed: bytes = b"", device=None, mesh=None
) -> list[bool]:
    """Per-signature verdicts: one combined check on the all-honest path,
    bisection to isolate the invalid signatures otherwise (every check on
    the mesh when one is given)."""
    device = resolve_device(device)
    if mesh is not None:
        mesh.require_type(device)
    if not triples:
        return []
    if batch_verify_signatures(triples, seed, device, mesh=mesh):
        return [True] * len(triples)
    if len(triples) == 1:
        return [False]
    mid = len(triples) // 2
    return verify_signatures(
        triples[:mid], seed, device, mesh
    ) + verify_signatures(triples[mid:], seed, device, mesh)


def verify_batch_host(triples: list[SigTriple], seed: bytes = b"") -> bool:
    """The same Fiat–Shamir small-exponent batch equation as
    `batch_verify_signatures` (one shared implementation,
    `_weighted_batch_check`), with the two G1 folds computed HOST-side
    (pure-Python ladders) instead of on device.

    This is the live block-import path (node/service.py in the JAX
    package): import batches are tiny (one block signature + one VRF
    proof + a handful of extrinsics), so a few 128-bit host scalar muls
    (~2 ms each) beat any device round-trip.  Soundness is the point,
    not speed: unlike `verify_aggregate`, the per-triple weights r_i
    (bound to the full transcript, signatures included) make the check
    hold iff EVERY signature individually verifies — a plain aggregate
    is malleable (sig_a+Δ, sig_b−Δ passes), and consensus derives the
    VRF output from the proof BYTES, so malleability there would let an
    author grind epoch randomness.  Verdict is bit-identical to the
    device path by construction."""
    return _weighted_batch_check(triples, seed, None)


# ------------------------------------------------------- plain aggregation


def aggregate_pubkeys(pks: list[bytes]) -> bytes:
    """Σ pk_i — the summed verification key (96-byte compressed G2).

    For an aggregate signature over ONE shared message the aggregate
    equation e(agg, −g2) · Π_K e(H(m), K) == 1 collapses to
    e(agg, −g2) · e(H(m), Σ pk) == 1, which is exactly the
    single-signature equation under the summed key — so a whole 2/3
    finality justification enters the weighted batch check as ONE
    SigTriple (node/sync.py verify_justifications_batch), and N
    justifications under the same signer set share one memoized G2
    decompression inside `_weighted_batch_check`.  Raises ValueError on
    a malformed key, like G2Point.from_bytes."""
    acc = G2Point.infinity()
    for pk in pks:
        acc = acc + G2Point.from_bytes(pk)
    return acc.to_bytes()


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    """Σ sig_i — the standard BLS aggregate (48-byte compressed G1)."""
    acc = G1Point.infinity()
    for s in sigs:
        acc = acc + G1Point.from_bytes(s)
    return acc.to_bytes()


def verify_aggregate(
    pks: list[bytes], msgs: list[bytes], agg_sig: bytes
) -> bool:
    """e(agg, −g2) · Π_K e(Σ_{i: pk_i=K} H(m_i), K) == 1.

    Sound only for distinct messages per key (rogue-key/replay caveats are
    the caller's contract, as in every BLS aggregate API); the batched
    `batch_verify_signatures` path above has no such restriction."""
    if len(pks) != len(msgs):
        raise ValueError("pks/msgs length mismatch")
    try:
        agg = G1Point.from_bytes(agg_sig)
        pk_pts = {pk: G2Point.from_bytes(pk) for pk in pks}
    except ValueError:
        return False
    h_pts = _hash_points(msgs)
    groups: dict[bytes, G1Point] = {}
    for pk, h in zip(pks, h_pts):
        groups[pk] = groups.get(pk, G1Point.infinity()) + h
    pairs = [(agg, -bls.G2_GENERATOR)]
    pairs.extend((fold, pk_pts[k]) for k, fold in groups.items())
    return bls.pairing_check(pairs)
