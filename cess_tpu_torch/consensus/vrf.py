"""BLS-VRF over BLS12-381 G1 — provable slot claims.

The reference proves slot ownership with a Schnorrkel (sr25519) VRF
inside `cessc-consensus-rrsc`; this framework's signature stack is BLS,
so the VRF is the classic BLS-VRF (Boneh–Lynn–Shacham as a VRF, the
construction behind proofs-of-possession randomness beacons):

    proof  π = [sk]·H(msg)          (exactly a BLS signature — the RFC
                                     9380 hash-to-curve of ops/h2c.py +
                                     the G1 scalar ladder)
    output y = blake2b(DST ‖ π)

BLS signatures are UNIQUE for a (key, message) pair — π is the one
valid point, so y is deterministic and the prover cannot grind it:
unbiasability falls out of uniqueness, with no extra zero-knowledge
machinery.  Verification is the standard pairing check
e(π, g2) == e(H(msg), pk) plus the output re-derivation.

Batching is where the device shape appears: `batch_verify` checks any
number of header claims in ONE Fiat–Shamir-weighted pairing product
(1 + #distinct-authors pairings total, never 2N), with the weighted
G1 folds on the card (ops/bls_agg.py, kernel K3 — the catch-up and
epoch-sim path).  The small-exponent weights are
load-bearing: a plain aggregate Σπ_i is malleable (shift one proof by
Δ, another by −Δ), and a shifted proof would change the VRF OUTPUT a
malicious author feeds into epoch randomness — the weighted product
pins each proof individually (soundness argument: ops/bls_agg.py).

A copy of `cess_tpu/consensus/vrf.py` bound to the port.  `batch_verify`
and `verify_claims` take a torch device (None = the card, "cpu" = the
plain tensor twins) and an optional `mesh` (parallel/verify.py Mesh),
passed through to bls_agg, which shards the proof-side fold over it.
The JAX package's host-fold choice (`device=False`, or no TPU) is not
here: the pure-Python folds are `bls_agg.verify_batch_host`, reached
only by name.
"""

from __future__ import annotations

import hashlib

from ..device import resolve_device
from ..ops import bls12_381 as bls
from ..ops import bls_agg

VRF_DST = b"CESS_TPU_VRF_BLS12381G1_BLAKE2B_V1"

# Claims are (pk bytes, msg bytes, output bytes, proof bytes).
Claim = tuple[bytes, bytes, bytes, bytes]

OUTPUT_BYTES = 32
_OUTPUT_SPACE = 1 << (8 * OUTPUT_BYTES)


def vrf_input(genesis: str, epoch_index: int, randomness: bytes,
              slot: int) -> bytes:
    """The VRF message for one slot claim.  Binds the chain (genesis
    hash — a dev and a local chain share the all-zero genesis
    randomness at epoch 0, so the chain id must separate them), the
    epoch (index + randomness) and the slot: a proof replayed at any
    other slot or epoch verifies against a different message and
    fails."""
    return (
        VRF_DST + b"/in" + genesis.encode() + b"/"
        + epoch_index.to_bytes(8, "little") + randomness
        + slot.to_bytes(8, "little")
    )


def proof_to_output(proof: bytes) -> bytes:
    """y = blake2b(DST ‖ π): the unbiasable randomness contribution.
    Derived from the PROOF POINT, not the message — uniqueness of BLS
    signatures makes it a deterministic function of (sk, msg)."""
    return hashlib.blake2b(
        VRF_DST + b"/out" + proof, digest_size=OUTPUT_BYTES
    ).digest()


def prove(sk: int, msg: bytes) -> tuple[bytes, bytes]:
    """(output, proof) for this key and message."""
    proof = bls.sign(sk, msg)
    return proof_to_output(proof), proof


def verify(pk: bytes, msg: bytes, output: bytes, proof: bytes) -> bool:
    """Full single-claim check: output derivation + the pairing."""
    if proof_to_output(proof) != output:
        return False
    return bls.verify(pk, msg, proof)


# ------------------------------------------------------------ threshold


def threshold(weight: int, total_weight: int,
              c_num: int, c_den: int) -> int:
    """Primary slot-claim threshold τ = c·w/W scaled to the output
    space: the claim wins when int(output) < τ·2^256.

    Scope-cut register (docs/consensus.md): BABE computes
    τ = 1 − (1−c)^(w/W); this is its first-order (linear) form, chosen
    because it is exact integer arithmetic — every replica computes the
    identical threshold with no transcendental-function rounding to
    disagree over.  Monotone in stake, same security role."""
    if total_weight <= 0 or weight <= 0:
        return 0
    return min(
        _OUTPUT_SPACE, _OUTPUT_SPACE * c_num * weight // (c_den * total_weight)
    )


def output_wins(output: bytes, thresh: int) -> bool:
    return int.from_bytes(output, "big") < thresh


# ------------------------------------------------------------ batching


def _check_outputs(claims: list[Claim]) -> list[bool]:
    return [proof_to_output(proof) == out for _, _, out, proof in claims]


def batch_verify(
    claims: list[Claim], seed: bytes = b"", device=None, mesh=None
) -> bool:
    """True iff EVERY claim verifies, with all the pairings folded into
    one weighted product: host output re-derivations (cheap hashes),
    then a single batched pairing call over the proofs, its G1 folds on
    `device` (None = the card; without one this raises), the proof-side
    fold sharded over `mesh` when one is given.  The same
    Fiat–Shamir-weighted equation as the host fold, bit-identical
    verdicts."""
    device = resolve_device(device)
    if mesh is not None:
        mesh.require_type(device)
    if not claims:
        return True
    if not all(_check_outputs(claims)):
        return False
    triples = [(pk, msg, proof) for pk, msg, _, proof in claims]
    return bls_agg.batch_verify_signatures(triples, seed, device, mesh=mesh)


def batch_claim_triples(
    claims: list[Claim],
) -> tuple[list[tuple[bytes, bytes, bytes]], int]:
    """Pairing triples for the longest claim PREFIX whose outputs
    re-derive from their proofs — the batch-import entry point
    (node/service.py import_batch folds these into one weighted
    pairing alongside the author/extrinsic signatures).

    A claim whose output does not match its proof must never be
    silently dropped from the batch: the pairing is the only check
    that catches a forged proof, so dropping the claim while keeping
    its block in the batch would let the forgery import.  Truncating
    at the first bad claim keeps every returned triple aligned with a
    block the caller will import under the batch verdict; the bad
    claim's block falls to the per-block path, where
    classify_claim/verify pin the exact failure.  Returns (triples,
    prefix_len)."""
    n = 0
    for _, _, out, proof in claims:
        if proof_to_output(proof) != out:
            break
        n += 1
    return [(pk, msg, proof) for pk, msg, _, proof in claims[:n]], n


def verify_claims(
    claims: list[Claim], seed: bytes = b"", device=None, mesh=None
) -> list[bool]:
    """Per-claim verdicts: output mismatches are isolated host-side for
    free; the surviving claims take the one-batch fast path, with
    bisection only when a batch fails (the ProofBackend contract shape,
    ops/bls_agg.verify_signatures).  device: None = the card; mesh: as
    `batch_verify`."""
    device = resolve_device(device)
    if mesh is not None:
        mesh.require_type(device)
    ok = _check_outputs(claims)
    live = [c for c, good in zip(claims, ok) if good]
    if not live:
        return ok
    if batch_verify(live, seed, device, mesh):
        return ok
    if len(live) == 1:
        verdicts = [False]
    else:
        mid = len(live) // 2
        verdicts = (
            verify_claims(live[:mid], seed, device, mesh)
            + verify_claims(live[mid:], seed, device, mesh)
        )
    it = iter(verdicts)
    return [next(it) if good else False for good in ok]
