"""Canonical deterministic codec (SCALE-compatible core).

The reference chain hashes SCALE-encoded challenge info to form the quorum
proposal (reference: c-pallets/audit/src/lib.rs:376-378) — every validator must
produce byte-identical encodings or quorum never commits.  This module provides
the minimal SCALE-compatible primitives the protocol needs: little-endian fixed
ints, compact (parity-scale-codec) length prefixes, vectors, and byte strings.

Pure python, dependency-free; used by both the host protocol layer and the
golden-vector tests that anchor the C++/JAX implementations.
"""

from __future__ import annotations


def encode_uint(value: int, nbytes: int) -> bytes:
    """Fixed-width little-endian unsigned int (SCALE fixed integer)."""
    if value < 0 or value >= (1 << (8 * nbytes)):
        raise ValueError(f"value {value} out of range for u{8 * nbytes}")
    return value.to_bytes(nbytes, "little")


def decode_uint(data: bytes, offset: int, nbytes: int) -> tuple[int, int]:
    if offset + nbytes > len(data):
        raise ValueError("truncated input decoding fixed integer")
    return int.from_bytes(data[offset : offset + nbytes], "little"), offset + nbytes


def encode_compact(value: int) -> bytes:
    """SCALE compact integer encoding.

    mode 0b00: single byte, value << 2          (0..=63)
    mode 0b01: two bytes  (value << 2) | 0b01   (64..=2**14-1)
    mode 0b10: four bytes (value << 2) | 0b10   (2**14..=2**30-1)
    mode 0b11: (len-4) in upper 6 bits, then len little-endian bytes
    """
    if value < 0:
        raise ValueError("compact encoding is unsigned")
    if value < 1 << 6:
        return bytes([value << 2])
    if value < 1 << 14:
        return ((value << 2) | 0b01).to_bytes(2, "little")
    if value < 1 << 30:
        return ((value << 2) | 0b10).to_bytes(4, "little")
    nbytes = (value.bit_length() + 7) // 8
    if nbytes > 67:
        raise ValueError("compact value too large")
    return bytes([((nbytes - 4) << 2) | 0b11]) + value.to_bytes(nbytes, "little")


def decode_compact(data: bytes, offset: int = 0) -> tuple[int, int]:
    """Decode a compact integer, rejecting truncated and non-canonical forms
    (parity-scale-codec errors on non-minimal encodings; so must we, or
    byte-distinct inputs alias to one value and the quorum hash diverges)."""
    if offset >= len(data):
        raise ValueError("truncated input decoding compact")
    first = data[offset]
    mode = first & 0b11
    if mode == 0b00:
        return first >> 2, offset + 1
    if mode == 0b01:
        if offset + 2 > len(data):
            raise ValueError("truncated input decoding compact u16")
        value = int.from_bytes(data[offset : offset + 2], "little") >> 2
        if value < 1 << 6:
            raise ValueError("non-canonical compact encoding")
        return value, offset + 2
    if mode == 0b10:
        if offset + 4 > len(data):
            raise ValueError("truncated input decoding compact u32")
        value = int.from_bytes(data[offset : offset + 4], "little") >> 2
        if value < 1 << 14:
            raise ValueError("non-canonical compact encoding")
        return value, offset + 4
    nbytes = (first >> 2) + 4
    if offset + 1 + nbytes > len(data):
        raise ValueError("truncated input decoding compact big")
    value = int.from_bytes(data[offset + 1 : offset + 1 + nbytes], "little")
    if value < 1 << 30 or value < 1 << (8 * (nbytes - 1)):
        raise ValueError("non-canonical compact encoding")
    return value, offset + 1 + nbytes


def encode_bytes(data: bytes) -> bytes:
    """Compact-length-prefixed byte string (SCALE Vec<u8>)."""
    return encode_compact(len(data)) + data


def decode_bytes(data: bytes, offset: int = 0) -> tuple[bytes, int]:
    n, offset = decode_compact(data, offset)
    if offset + n > len(data):
        raise ValueError("truncated input decoding byte string")
    return data[offset : offset + n], offset + n


def encode_vec(items: list[bytes]) -> bytes:
    """Compact-length-prefixed vector of pre-encoded items."""
    out = [encode_compact(len(items))]
    out.extend(items)
    return b"".join(out)


def encode_bool(value: bool) -> bytes:
    return b"\x01" if value else b"\x00"


class Writer:
    """Accumulating canonical encoder."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "Writer":
        self._parts.append(encode_uint(v, 1))
        return self

    def u16(self, v: int) -> "Writer":
        self._parts.append(encode_uint(v, 2))
        return self

    def u32(self, v: int) -> "Writer":
        self._parts.append(encode_uint(v, 4))
        return self

    def u64(self, v: int) -> "Writer":
        self._parts.append(encode_uint(v, 8))
        return self

    def u128(self, v: int) -> "Writer":
        self._parts.append(encode_uint(v, 16))
        return self

    def compact(self, v: int) -> "Writer":
        self._parts.append(encode_compact(v))
        return self

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(bytes(b))
        return self

    def bytes(self, b: bytes) -> "Writer":
        self._parts.append(encode_bytes(b))
        return self

    def boolean(self, v: bool) -> "Writer":
        self._parts.append(encode_bool(v))
        return self

    def finish(self) -> bytes:
        return b"".join(self._parts)
