"""GF(2^8) arithmetic — numpy reference implementation and shared tables.

The port's own copy of `cess_tpu/ops/gf256.py` (numpy only): the
reference its RS data plane (ops/rs.py) is held to, and the source of
that module's constants.

The reference erasure-codes every 16 MiB segment into fragments (2 data + 1
parity at the protocol layer, reference: runtime/src/lib.rs:1025,
c-pallets/file-bank/src/lib.rs:468 `needed = segments * SEGMENT_SIZE * 1.5`),
with the actual GF(2^8) Reed-Solomon math living off-chain in miner tooling.
This module is the single source of truth for the field: primitive polynomial
0x11D (x^8+x^4+x^3+x^2+1, the standard erasure-coding field), log/exp tables,
and matrix routines.
"""

from __future__ import annotations

import numpy as np

PRIM_POLY = 0x11D
FIELD = 256

# ---------------------------------------------------------------- tables


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP, LOG = _build_tables()

# Full 256x256 multiplication table (64 KiB) — used by the gather product
# (ops/rs.py) and the numpy reference.
_a = np.arange(256, dtype=np.int32)
_mul = np.zeros((256, 256), dtype=np.uint8)
_nz = _a[1:]
_mul[1:, 1:] = EXP[(LOG[_nz][:, None] + LOG[_nz][None, :]) % 255]
MUL_TABLE = _mul

# INV[x] = multiplicative inverse (INV[0] = 0 by convention).
INV = np.zeros(256, dtype=np.uint8)
INV[1:] = EXP[255 - LOG[_nz]]


# ---------------------------------------------------------------- scalar ops


def gf_mul(a: int, b: int) -> int:
    return int(MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % 255])


def gf_pow(a: int, n: int) -> int:
    if a == 0:
        return 0 if n else 1
    return int(EXP[(int(LOG[a]) * (n % 255)) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of zero")
    return int(INV[a])


# ---------------------------------------------------------------- matrix ops


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(256) matrix product (XOR-accumulated table lookups)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.shape[1] == b.shape[0]
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[1]):
        # out ^= MUL_TABLE[a[:, i][:, None], b[i][None, :]]
        np.bitwise_xor(out, MUL_TABLE[a[:, i][:, None], b[i][None, :]], out)
    return out


def mat_inv(m: np.ndarray) -> np.ndarray:
    """GF(256) matrix inverse by Gauss-Jordan elimination."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = INV[aug[col, col]]
        aug[col] = MUL_TABLE[inv_p, aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= MUL_TABLE[aug[r, col], aug[col]]
    return aug[:, n:].copy()


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """m x k Cauchy parity matrix: M[j, i] = 1 / ((k + j) ^ i).

    Any k rows of [I_k; M] are invertible, which is the erasure-recovery
    property the fragment/segment accounting relies on.
    """
    if k + m > FIELD:
        raise ValueError("k + m must be <= 256")
    xs = np.arange(k, k + m, dtype=np.int32)
    ys = np.arange(k, dtype=np.int32)
    return INV[(xs[:, None] ^ ys[None, :])].astype(np.uint8)


def encode_matrix(k: int, m: int) -> np.ndarray:
    """(k+m) x k systematic generator [I_k; Cauchy]."""
    return np.concatenate([np.eye(k, dtype=np.uint8), cauchy_matrix(k, m)], axis=0)


def bit_matrix(m: np.ndarray) -> np.ndarray:
    """Expand a GF(256) matrix (r x c) to its GF(2) bit-matrix (8r x 8c).

    Multiplication by a GF(256) constant is GF(2)-linear on the 8 bits of the
    operand: column t of the 8x8 block for constant g is bits(g * x^t).  This
    turns RS encoding into a 0/1 matrix product mod 2 (ops/rs.py bitplane
    path).

    Bit order: little-endian (bit 0 = LSB) in both row and column blocks.
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    out = np.zeros((8 * r, 8 * c), dtype=np.uint8)
    for t in range(8):
        prod = MUL_TABLE[m, 1 << t]  # (r, c) = g * x^t
        for q in range(8):
            out[q::8, t::8] = (prod >> q) & 1
    return out


def rs_encode_ref(data: np.ndarray, k: int, m: int) -> np.ndarray:
    """Reference RS encode: data (k, n) uint8 -> parity (m, n) uint8."""
    data = np.asarray(data, dtype=np.uint8)
    assert data.shape[0] == k
    return mat_mul(cauchy_matrix(k, m), data)


def rs_decode_ref(
    shards: np.ndarray, present: list[int], k: int, m: int
) -> np.ndarray:
    """Recover the k data shards from any k surviving shards.

    `shards` is (k_surviving, n) rows ordered to match `present` (global shard
    indices 0..k+m-1, data shards first).
    """
    shards = np.asarray(shards, dtype=np.uint8)
    assert len(present) >= k
    gen = encode_matrix(k, m)
    sub = gen[present[:k]]
    inv = mat_inv(sub)
    return mat_mul(inv, shards[:k])
