"""Keccak-256 (original pad 0x01 — NOT FIPS SHA3's 0x06).

The EVM's hash (used by chain/evm.py for CREATE addresses, storage-slot
derivation in contracts, and the KECCAK256 opcode).  hashlib ships only
the FIPS-202 variant, whose domain-separation padding differs, so the
permutation is implemented here.  Capability match: the reference gets
this from Frontier's sp-core hashing (pallet_evm, reference:
runtime/src/lib.rs:1322-1344).

Checked against the standard empty-string / "abc" vectors in
tests/test_evm.py.
"""

from __future__ import annotations

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

_ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)

_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n &= 63
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    """keccak-f[1600] over a 5x5 lane state (state[x * 5 + y])."""
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [
            state[x * 5] ^ state[x * 5 + 1] ^ state[x * 5 + 2]
            ^ state[x * 5 + 3] ^ state[x * 5 + 4]
            for x in range(5)
        ]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y * 5 + (2 * x + 3 * y) % 5] = _rol(
                    state[x * 5 + y], _ROTATIONS[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                state[x * 5 + y] = b[x * 5 + y] ^ (
                    (~b[((x + 1) % 5) * 5 + y] & _MASK)
                    & b[((x + 2) % 5) * 5 + y]
                )
        # iota
        state[0] ^= rc


def keccak256(data: bytes) -> bytes:
    """32-byte Keccak-256 digest (rate 136, pad10*1 with marker 0x01)."""
    rate = 136
    state = [0] * 25
    # pad
    padded = bytearray(data)
    padded.append(0x01)
    while len(padded) % rate:
        padded.append(0x00)
    padded[-1] ^= 0x80
    # absorb
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lane = int.from_bytes(block[i * 8 : i * 8 + 8], "little")
            x, y = i % 5, i // 5
            state[x * 5 + y] ^= lane
        _keccak_f(state)
    # squeeze (32 bytes < rate: one block)
    out = bytearray()
    for i in range(rate // 8):
        x, y = i % 5, i // 5
        out += state[x * 5 + y].to_bytes(8, "little")
        if len(out) >= 32:
            break
    return bytes(out[:32])
