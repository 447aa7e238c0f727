"""PoDR2: proofs of data reduplication & recovery — scheme definition.

The reference chain carries PoDR2 artifacts but computes them off-chain in
TEE/miner tooling that is not in the tree (reference: the Podr2Key on chain
at c-pallets/tee-worker/src/lib.rs:120-121, the σ proof blobs at
c-pallets/audit/src/types.rs:33-41, the 47-index/47-coefficient challenge at
c-pallets/audit/src/lib.rs:906-924, and the declared verification seam at
audit/src/lib.rs:484).  This module defines the framework's scheme —
a Shacham–Waters compact proof of retrievability over BLS12-381, chosen
over the reference's RSA flavour because it batch-verifies as MXU-friendly
Zr matrix products plus a constant number of pairings:

  setup     TEE keypair x ∈ Zr, pk = g2^x  (network Podr2Key)
  generators u_j = hash_to_g1("cess/podr2/u" ‖ j) — global, so the
            verifier's u-side collapses across a batch (see batch_verify)
  tag       fragment `name`, data split into n chunks × s sectors × 31 B;
            σ_i = (H(name ‖ i) · Π_j u_j^{m_ij})^x           (48 B each)
  challenge Q = {(i_c, v_c)}: chunk indices + 20-byte coefficients —
            exactly the audit pallet's random_index_list/random_list
  prove     μ_j = Σ_c v_c·m_{i_c j} mod r;   σ = Π_c σ_{i_c}^{v_c}
  verify    e(σ, g2) == e(Π_c H(name‖i_c)^{v_c} · Π_j u_j^{μ_j}, pk)

Batch verification folds N proofs into ONE equation with random 128-bit
weights ρ_b (Bellare–Garay–Rabin small-exponent test):

  e(Π_b σ_b^{ρ_b}, g2) == e( Π_{b,c} H_b,c^{ρ_b v_c} · Π_j u_j^{Σ_b ρ_b μ_bj}, pk )

The Σ_b ρ_b μ_bj term is an (N×s) matrix-vector product over Zr — the part
ops/fr.py runs on the device; the σ/H MSMs are the ops/g1.py batch kernels; the
two pairings are O(1) per batch.

This host implementation is the bit-exactness reference for the backends in
the port's proof package (a copy of the JAX package's ops/podr2.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

from .. import native
from . import bls12_381 as bls
from .bls12_381 import G1Point, G2Point, R

SECTOR_SIZE = 31  # bytes per sector; 31*8 = 248 bits < |r| = 255

# Protocol geometry (reference: primitives/common/src/lib.rs:61-62 — 8 MiB
# fragments of 1024 chunks): chunk = 8 KiB = 265 sectors (last one short).
PROTO_CHUNKS = 1024
PROTO_SECTORS = (8192 + SECTOR_SIZE - 1) // SECTOR_SIZE  # 265

U_DST = b"cess/podr2/u/v1"
H_DST = b"cess/podr2/h/v1"
RHO_DST = b"cess/podr2/rho/v1"


@dataclass(frozen=True)
class Podr2Params:
    """Scheme geometry: n chunks of s sectors per fragment."""

    n: int = PROTO_CHUNKS
    s: int = PROTO_SECTORS

    @property
    def chunk_bytes(self) -> int:
        return self.s * SECTOR_SIZE

    @property
    def fragment_bytes(self) -> int:
        return self.n * self.chunk_bytes


@dataclass
class Podr2Proof:
    sigma: bytes          # 48-byte compressed G1
    mu: list[int]         # s scalars mod r

    def encode(self) -> bytes:
        out = [self.sigma]
        out.extend(m.to_bytes(32, "little") for m in self.mu)
        return b"".join(out)

    @classmethod
    def decode(cls, data: bytes, s: int) -> "Podr2Proof":
        if len(data) != 48 + 32 * s:
            raise ValueError("bad proof length")
        sigma = data[:48]
        mu = [
            int.from_bytes(data[48 + 32 * j : 80 + 32 * j], "little")
            for j in range(s)
        ]
        return cls(sigma, mu)

    def commitment(self) -> bytes:
        """On-chain ≤SigmaMax blob: σ plus a binding digest of μ (the full
        proof travels off-chain to the TEE, as in the reference)."""
        return self.sigma + hashlib.sha256(self.encode()).digest()


def keygen(seed: bytes) -> tuple[int, bytes]:
    """TEE keypair; pk is the network Podr2Key (tee-worker lib.rs:166-168)."""
    sk = bls.keygen(b"podr2" + seed)
    return sk, G2Point.from_bytes(bls.sk_to_pk(sk)).to_bytes()


@lru_cache(maxsize=8)
def u_generators(s: int) -> tuple[G1Point, ...]:
    """Global sector generators (cached; deterministic across processes)."""
    return tuple(
        bls.hash_to_g1(U_DST + j.to_bytes(4, "little"), U_DST) for j in range(s)
    )


@lru_cache(maxsize=1 << 16)
def chunk_point(name: bytes, index: int) -> G1Point:
    """H(name ‖ i) — the per-chunk random-oracle point.  Cached: the
    bisection fallback in the proof backends re-visits identical (name, i)
    pairs across overlapping subsets."""
    return bls.hash_to_g1(name + b"/" + index.to_bytes(8, "little"), H_DST)


def chunk_points_batch(
    pairs: list[tuple[bytes, int]], threads: int = 8
) -> list[G1Point]:
    """Batched H(name ‖ i) through the native hash-to-curve kernel
    (native/blsmap.cpp, `threads` threads) — bit-identical to chunk_point
    (tests/test_torch_native.py).  A batch holding a message longer than
    the native framing takes goes the cached scalar path, as in the JAX
    package; a failed build or load of the native library raises."""
    msgs = [name + b"/" + index.to_bytes(8, "little") for name, index in pairs]
    if any(len(m) > native.MAX_MSG for m in msgs):
        return [chunk_point(name, index) for name, index in pairs]
    return [
        G1Point.infinity() if x == 0 and y == 0 else G1Point(x, y)
        for x, y in native.hash_to_g1_batch(msgs, H_DST, threads=threads)
    ]


def split_sectors(chunk: bytes, s: int) -> list[int]:
    """Chunk bytes → s sector scalars (zero-padded little-endian)."""
    chunk = chunk.ljust(s * SECTOR_SIZE, b"\x00")
    return [
        int.from_bytes(chunk[j * SECTOR_SIZE : (j + 1) * SECTOR_SIZE], "little")
        for j in range(s)
    ]


def fragment_sectors(data: bytes, params: Podr2Params) -> list[list[int]]:
    """Fragment bytes → n×s sector matrix."""
    data = data.ljust(params.fragment_bytes, b"\x00")
    return [
        split_sectors(
            data[i * params.chunk_bytes : (i + 1) * params.chunk_bytes], params.s
        )
        for i in range(params.n)
    ]


# ---------------------------------------------------------------- tagging


def tag_chunk(sk: int, name: bytes, index: int, sectors: list[int]) -> bytes:
    """σ_i = (H(name‖i) · Π_j u_j^{m_ij})^x, 48-byte compressed."""
    us = u_generators(len(sectors))
    acc = chunk_point(name, index)
    for u, m in zip(us, sectors):
        if m:
            acc = acc + u.mul(m)
    return acc.mul(sk).to_bytes()


def tag_fragment(sk: int, name: bytes, data: bytes, params: Podr2Params) -> list[bytes]:
    """All n chunk tags for a fragment (the TEE's tag-calculation duty,
    rate-assumed 64 MiB/block in the reference:
    c-pallets/file-bank/src/constants.rs:4)."""
    matrix = fragment_sectors(data, params)
    return [tag_chunk(sk, name, i, row) for i, row in enumerate(matrix)]


# ---------------------------------------------------------------- challenge


@dataclass(frozen=True)
class Challenge:
    """The audit round's (index, coefficient) pairs (reference:
    audit/src/lib.rs:906-924 — 47 of 1024 chunks, 20-byte randoms)."""

    indices: tuple[int, ...]
    randoms: tuple[bytes, ...]  # 20-byte each

    def coefficients(self) -> list[int]:
        return [int.from_bytes(v, "little") for v in self.randoms]

    @classmethod
    def from_net_snapshot(cls, snap) -> "Challenge":
        return cls(tuple(snap.random_index_list), tuple(snap.random_list))


# ---------------------------------------------------------------- prove


def prove(
    tags: list[bytes],
    data: bytes,
    challenge: Challenge,
    params: Podr2Params,
) -> Podr2Proof:
    """Miner-side response: μ vector + aggregated σ."""
    matrix = fragment_sectors(data, params)
    vs = challenge.coefficients()
    mu = [0] * params.s
    for v, i in zip(vs, challenge.indices):
        row = matrix[i]
        for j in range(params.s):
            mu[j] = (mu[j] + v * row[j]) % R
    sigma = G1Point.infinity()
    for v, i in zip(vs, challenge.indices):
        sigma = sigma + G1Point.from_bytes(tags[i]).mul(v)
    return Podr2Proof(sigma.to_bytes(), mu)


# ---------------------------------------------------------------- verify


def _rhs_point(
    name: bytes, challenge: Challenge, mu: list[int]
) -> G1Point:
    """Π_c H(name‖i_c)^{v_c} · Π_j u_j^{μ_j}"""
    us = u_generators(len(mu))
    acc = G1Point.infinity()
    for v, i in zip(challenge.coefficients(), challenge.indices):
        acc = acc + chunk_point(name, i).mul(v)
    for u, m in zip(us, mu):
        if m:
            acc = acc + u.mul(m)
    return acc


def verify(
    pk: bytes,
    name: bytes,
    challenge: Challenge,
    proof: Podr2Proof,
    s: int | None = None,
) -> bool:
    """Single-proof pairing check.  `s` pins the expected sector count; a
    proof of any other μ width is rejected outright (malformed-input
    handling must be identical across backends — consensus-critical)."""
    try:
        sigma = G1Point.from_bytes(proof.sigma)
        pk_point = G2Point.from_bytes(pk)
    except ValueError:
        return False
    if s is not None and len(proof.mu) != s:
        return False
    if any(not 0 <= m < R for m in proof.mu):
        return False
    rhs = _rhs_point(name, challenge, proof.mu)
    return bls.pairing_check([(sigma, -bls.G2_GENERATOR), (rhs, pk_point)])


@dataclass
class BatchItem:
    name: bytes
    challenge: Challenge
    proof: Podr2Proof


@lru_cache(maxsize=256)
def _challenge_bytes(challenge: Challenge) -> bytes:
    """The challenge's transcript contribution, packed once.  A live
    audit round shares ONE Challenge across every proof of the batch, so
    the per-proof transcript loop re-serialized the same 47 (index,
    random) pairs N times; Challenge is a frozen (hashable) dataclass,
    so the packed bytes cache by value.  Same zip-truncation semantics
    as the rest of the scheme."""
    return b"".join(
        i.to_bytes(4, "little") + v
        for i, v in zip(challenge.indices, challenge.randoms)
    )


def batch_transcript(
    seed: bytes,
    items: list["BatchItem"],
    encodings: list[bytes] | None = None,
) -> bytes:
    """Fiat–Shamir transcript binding the ρ weights to the proofs.

    The small-exponent batch test is only sound when the prover cannot
    predict the weights; hashing every (name, challenge, proof) into the
    seed makes ρ depend on the submitted proofs themselves, so cancelling
    deviations cannot be pre-computed.

    `encodings` optionally supplies precomputed proof.encode() blobs so
    one shared encode pass can feed both this transcript and the
    verifier's μ word packing (proof/frontend.py); the digest is
    byte-identical either way (blake2b streaming is concatenation-
    associative), asserted in tests/test_proof_hotpath.py."""
    h = hashlib.blake2b(digest_size=32)
    h.update(RHO_DST)
    h.update(seed)
    sha256 = hashlib.sha256
    for k, it in enumerate(items):
        h.update(sha256(it.name).digest())
        h.update(_challenge_bytes(it.challenge))
        h.update(
            encodings[k] if encodings is not None else it.proof.encode()
        )
    return h.digest()


def batch_rho(transcript: bytes, count: int) -> list[int]:
    """Deterministic 128-bit batch weights from a transcript digest (both
    backends derive identical combinations from identical inputs).  The
    (RHO_DST ‖ transcript) prefix is absorbed once and copied per weight
    — hash-state copy + one 8-byte tail instead of re-hashing the prefix
    N times; byte-identical to the one-shot form."""
    prefix = hashlib.blake2b(digest_size=16)
    prefix.update(RHO_DST)
    prefix.update(transcript)
    out = []
    for b in range(count):
        h = prefix.copy()
        h.update(b.to_bytes(8, "little"))
        out.append(int.from_bytes(h.digest(), "little") | 1)  # nonzero
    return out


def batch_verify(
    pk: bytes,
    items: list[BatchItem],
    seed: bytes,
    u_exponents: list[int] | None = None,
    s: int | None = None,
) -> bool:
    """One combined check for N proofs under the same pk (module docstring
    equation).  Returns False if ANY proof in the batch is invalid; callers
    needing per-proof verdicts bisect or fall back to verify().

    `u_exponents` lets a backend supply the device-computed
    Σ_b ρ_b μ_bj vector (same ρ derivation) — the single seam where the
    xla backend differs from this host reference.  `s` pins the expected
    sector count; when None it is derived from the first item (all items
    must agree either way)."""
    if not items:
        return True
    try:
        pk_point = G2Point.from_bytes(pk)
        sigmas = [G1Point.from_bytes(it.proof.sigma) for it in items]
    except ValueError:
        return False
    if s is None:
        s = len(items[0].proof.mu)
    if any(len(it.proof.mu) != s for it in items):
        return False
    if any(not 0 <= m < R for it in items for m in it.proof.mu):
        return False
    rhos = batch_rho(batch_transcript(seed, items), len(items))

    # left: Π σ_b^{ρ_b}
    lhs = G1Point.infinity()
    for sigma, rho in zip(sigmas, rhos):
        lhs = lhs + sigma.mul(rho)

    # right, H side: Π_{b,c} H_{b,c}^{ρ_b v_c}
    rhs = G1Point.infinity()
    for it, rho in zip(items, rhos):
        for v, i in zip(it.challenge.coefficients(), it.challenge.indices):
            rhs = rhs + chunk_point(it.name, i).mul(rho * v % R)

    # right, u side: Π_j u_j^{Σ_b ρ_b μ_bj} — the device matmul term.
    us = u_generators(s)
    if u_exponents is None:
        u_exponents = []
        for j in range(s):
            e = 0
            for it, rho in zip(items, rhos):
                e = (e + rho * it.proof.mu[j]) % R
            u_exponents.append(e)
    for u, e in zip(us, u_exponents):
        if e:
            rhs = rhs + u.mul(e)

    return bls.pairing_check([(lhs, -bls.G2_GENERATOR), (rhs, pk_point)])


# ---------------------------------------------------------------- idle data


def filler_data(filler_hash: bytes, params: Podr2Params) -> bytes:
    """Deterministic idle-space filler content: expandable from its hash so
    idle proofs need no stored plaintext (reference fillers are 8 MiB
    pseudo-files, c-pallets/file-bank/src/lib.rs:830-836)."""
    out = bytearray()
    counter = 0
    while len(out) < params.fragment_bytes:
        out.extend(
            hashlib.blake2b(
                b"cess/filler" + filler_hash + counter.to_bytes(8, "little"),
                digest_size=64,
            ).digest()
        )
        counter += 1
    return bytes(out[: params.fragment_bytes])
