"""RSA PKCS#1 v1.5 (SHA-256) signature verification — host + batched GPU.

Re-expresses the capability of the reference's IAS-report signature check
(reference: primitives/enclave-verify/src/lib.rs:165-169 — webpki
RSA_PKCS1_2048_8192_SHA256 — and lib.rs:221-228 `verify_rsa` over the rsa
crate; the underlying modexp lives in the vendored ring fork, reference:
utils/ring).  Here the batched verify path runs s^65537 mod n as limb
products on the card (ops/bigmod.py) with host-side padding checks.

A copy of `cess_tpu/ops/rsa.py` bound to the port's `bigmod`;
`verify_batch` runs on the card unless `device="cpu"` is passed.

Also provides keygen/sign: the node simulator fabricates attestation
fixtures with them (the reference's tests do the same round-trip,
enclave-verify/src/lib.rs:242-255).
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from ..device import resolve_device
from . import bigmod

# DigestInfo prefix for SHA-256 (RFC 8017 §9.2 notes).
SHA256_DIGEST_INFO = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)

F4 = 65537


@dataclass(frozen=True)
class RsaPublicKey:
    n: int
    e: int = F4

    @property
    def size_bytes(self) -> int:
        return (self.n.bit_length() + 7) // 8


@dataclass(frozen=True)
class RsaPrivateKey:
    n: int
    e: int
    d: int

    def public(self) -> RsaPublicKey:
        return RsaPublicKey(self.n, self.e)


# ---------------------------------------------------------------- padding


def emsa_pkcs1_v15(digest: bytes, em_len: int) -> bytes:
    """0x00 0x01 FF… 0x00 DigestInfo ‖ H (RFC 8017 §9.2)."""
    t = SHA256_DIGEST_INFO + digest
    if em_len < len(t) + 11:
        raise ValueError("modulus too small for PKCS#1 v1.5 SHA-256")
    ps = b"\xff" * (em_len - len(t) - 3)
    return b"\x00\x01" + ps + b"\x00" + t


def _check_padding(em: bytes, message: bytes) -> bool:
    digest = hashlib.sha256(message).digest()
    try:
        expected = emsa_pkcs1_v15(digest, len(em))
    except ValueError:
        return False
    return em == expected


# ---------------------------------------------------------------- verify


def verify(key: RsaPublicKey, message: bytes, signature: bytes) -> bool:
    """Host-path PKCS#1 v1.5 SHA-256 verification."""
    if len(signature) != key.size_bytes:
        return False
    s = int.from_bytes(signature, "big")
    if s >= key.n:
        return False
    em = pow(s, key.e, key.n).to_bytes(key.size_bytes, "big")
    return _check_padding(em, message)


def verify_batch(
    key: RsaPublicKey, pairs: list[tuple[bytes, bytes]], device=None
) -> list[bool]:
    """Batched (message, signature) verification: one device modexp batch
    per call (all items share the modulus — the IAS shape: one Intel
    signing key per attestation batch), padding checks on host.
    Bit-identical verdicts to `verify`.  device: None = the card."""
    device = resolve_device(device)
    if key.e != F4:
        return [verify(key, m, s) for m, s in pairs]
    sigs: list[int] = []
    ok_shape: list[bool] = []
    for _, sig in pairs:
        good = len(sig) == key.size_bytes
        s = int.from_bytes(sig, "big") if good else 0
        good = good and s < key.n
        ok_shape.append(good)
        sigs.append(s if good else 0)
    if not sigs:
        return []
    ems = bigmod.modexp_65537_batch(sigs, key.n, device)
    out = []
    for good, em_int, (message, _) in zip(ok_shape, ems, pairs):
        if not good:
            out.append(False)
            continue
        em = em_int.to_bytes(key.size_bytes, "big")
        out.append(_check_padding(em, message))
    return out


# ---------------------------------------------------------------- sign


def sign(key: RsaPrivateKey, message: bytes) -> bytes:
    digest = hashlib.sha256(message).digest()
    em = emsa_pkcs1_v15(digest, (key.n.bit_length() + 7) // 8)
    m = int.from_bytes(em, "big")
    return pow(m, key.d, key.n).to_bytes((key.n.bit_length() + 7) // 8, "big")


# ---------------------------------------------------------------- keygen


def _is_probable_prime(n: int, rounds: int = 24) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _random_prime(bits: int, rng=None) -> int:
    get = rng.getrandbits if rng is not None else secrets.randbits
    while True:
        p = get(bits) | (1 << (bits - 1)) | 1
        if p % F4 != 1 and _is_probable_prime(p):
            return p


def keygen(bits: int = 2048, rng=None) -> RsaPrivateKey:
    """Deterministic when given a seeded random.Random (test fixtures)."""
    while True:
        p = _random_prime(bits // 2, rng)
        q = _random_prime(bits // 2, rng)
        if p == q:
            continue
        n = p * q
        if n.bit_length() != bits:
            continue
        phi = (p - 1) * (q - 1)
        d = pow(F4, -1, phi)
        return RsaPrivateKey(n=n, e=F4, d=d)
