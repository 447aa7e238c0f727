"""Host-side hashing helpers and the Hash64 digest convention.

The reference stores file/segment/fragment digests as 64 ASCII hex characters
(`Hash([u8;64])`, reference: primitives/common/src/lib.rs:16) — i.e. the hex
string of a 32-byte hash, not the raw bytes.  We keep that convention at the
protocol layer (`Hash64`) because deal/file identity, dedup, and restoral
orders all key on it.

Hashing stays on the host CPU (SURVEY.md §7: only field/coding math goes to
TPU); the C++ native core (native/chaincore.cpp) carries bit-identical
SHA-256/BLAKE2b for the host runtime path, tested in tests/test_native.py.
"""

from __future__ import annotations

import hashlib


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def blake2b_256(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class Hash64(str):
    """64-char lowercase hex digest (the reference's on-chain hash type)."""

    __slots__ = ()

    def __new__(cls, value: str) -> "Hash64":
        value = value.lower()
        if len(value) != 64 or any(c not in "0123456789abcdef" for c in value):
            raise ValueError(f"Hash64 must be 64 hex chars, got {value!r}")
        return super().__new__(cls, value)

    @classmethod
    def of(cls, data: bytes) -> "Hash64":
        return cls(hashlib.sha256(data).hexdigest())

    @classmethod
    def zero(cls) -> "Hash64":
        return cls("0" * 64)

    def raw(self) -> bytes:
        return bytes.fromhex(self)

    def ascii_bytes(self) -> bytes:
        """The 64 ASCII bytes as stored on-chain by the reference."""
        return self.encode("ascii")
