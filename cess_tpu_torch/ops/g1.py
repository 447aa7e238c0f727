"""Batched BLS12-381 G1 arithmetic in PyTorch: Fp limbs, complete point
ops, and the double-and-add ladder (kernel K3).

The layout at every function boundary is the JAX package's: an Fp
element is 33 "loose" base-4096 limbs (each in [0, 4096], value
< 2^384 + 8192·p), arrays are limb-major — shape (33, N…) int32 — and the
point at infinity is (0 : 1 : 0).  A tensor produced here can stand in
for the JAX package's arrays limb for limb (`limbs_from_numpy` /
`limbs_to_numpy` move them across).

Plain tensor code (the "twin" of each CUDA kernel) follows the JAX
algorithm limb for limb — the same carry passes, the same 2^(12k) mod p
fold tables, the same borrow-free subtraction pad — so its outputs equal
the JAX package's limbs exactly.  It differs only in shape: independent
field products of one formula step are stacked on a batch axis and
multiplied in one call (`pt_add` runs two stacked `mulm`s instead of
twelve), which cuts the op count the CPU pays per formula.  `mulm` is an
outer product plus a scatter-add over the anti-diagonals.

The ladder [s]P (`scalar_mul_ladder`) is kernel K3: on a CUDA tensor it
launches csrc/ladder.cu, on a CPU tensor it runs `batch_scalar_mul`.
Point formulas are the complete a = 0 projective ones (Renes–Costello–
Batina 2016, Alg. 7/9): exception-free on BLS12-381's odd-order E(Fp),
so every kernel is straight-line, data-oblivious code.

`msm_wide` is the flat Pippenger MSM (windowed buckets over raw, unreduced
scalars): plain tensor code on either device, as the JAX package computes
it in plain XLA, with no kernel of its own.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from . import _cuda
from .bls12_381 import G1Point, P, R

LIMB_BITS = 12
BASE = 1 << LIMB_BITS
NP_LIMBS = (381 + LIMB_BITS - 1) // LIMB_BITS  # 32 limbs hold an Fp value
L = NP_LIMBS + 1  # loose representation length

R_LIMBS = (255 + LIMB_BITS - 1) // LIMB_BITS  # 22 limbs hold a scalar < r
SCALAR_BITS = 255

B3 = 12  # 3·b for y² = x³ + 4

I32 = torch.int32


# ---------------------------------------------------------------- host codec


def fp_to_limbs(x: int, n: int = L) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & (BASE - 1)
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit the requested limb count")
    return out


def limbs_to_fp(limbs) -> int:
    x = 0
    for i, v in enumerate(np.asarray(limbs).astype(object).tolist()):
        x += int(v) << (LIMB_BITS * i)
    return x


def limbs_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy limb array (any shape, JAX-package layout) → int32 tensor on
    `device` (the card unless the caller asks for the CPU)."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(a, dtype=np.int32)), device=device
    )


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor → numpy array in the JAX-package layout."""
    return t.detach().to("cpu").numpy()


def scalars_to_limbs(scalars) -> np.ndarray:
    """Scalars (< r) → (N, 22) int32 little-endian limbs."""
    from .fr import ints_to_words, words_to_limbs

    if any(not 0 <= int(s) < R for s in scalars):
        raise ValueError("scalar out of range")
    return words_to_limbs(
        ints_to_words(scalars, 32), LIMB_BITS, R_LIMBS, np.int32
    )


def be48_to_limb_rows(be: np.ndarray) -> np.ndarray:
    """(…, 48) big-endian canonical Fp bytes → (…, 33) int32 limbs."""
    b = np.ascontiguousarray(be).astype(np.int32)
    trip = b.reshape(b.shape[:-1] + (16, 3))
    hi = (trip[..., 0] << 4) | (trip[..., 1] >> 4)
    lo = ((trip[..., 1] & 0xF) << 8) | trip[..., 2]
    pairs = np.stack([lo, hi], axis=-1)  # (…, 16, 2), BE triple order
    pairs = pairs[..., ::-1, :]  # reverse triples → little-endian
    limbs = pairs.reshape(b.shape[:-1] + (NP_LIMBS,))
    out = np.zeros(b.shape[:-1] + (L,), dtype=np.int32)
    out[..., :NP_LIMBS] = limbs
    return out


def points_to_projective(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host G1Points → (X, Y, Z) limb arrays ((N, 33) int32 each);
    infinity encodes as (0 : 1 : 0)."""
    n = len(points)
    if n == 0:
        z = np.zeros((0, L), dtype=np.int32)
        return z, z.copy(), z.copy()
    raw = bytearray(n * 96)
    finite = np.zeros(n, dtype=bool)
    for i, pt in enumerate(points):
        if pt.is_infinity():
            continue
        raw[i * 96 : i * 96 + 48] = pt.x.to_bytes(48, "big")
        raw[i * 96 + 48 : i * 96 + 96] = pt.y.to_bytes(48, "big")
        finite[i] = True
    limbs = be48_to_limb_rows(
        np.frombuffer(bytes(raw), dtype=np.uint8).reshape(n, 2, 48)
    )
    X = limbs[:, 0].copy()
    Y = limbs[:, 1].copy()
    Z = np.zeros_like(X)
    Y[~finite, 0] = 1
    Z[finite, 0] = 1
    return X, Y, Z


def projective_to_points(X, Y, Z) -> list[G1Point]:
    """Loose limbs ((N, 33) each, numpy or tensors) → host G1Points, with
    one Montgomery batch inversion of the Z coordinates."""
    X, Y, Z = (
        limbs_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
        for a in (X, Y, Z)
    )
    n = X.shape[0]
    xs = [limbs_to_fp(X[i]) % P for i in range(n)]
    ys = [limbs_to_fp(Y[i]) % P for i in range(n)]
    zs = [limbs_to_fp(Z[i]) % P for i in range(n)]
    idx = [i for i in range(n) if zs[i] != 0]
    prefix = []
    acc = 1
    for i in idx:
        prefix.append(acc)
        acc = acc * zs[i] % P
    inv = pow(acc, P - 2, P)
    zinv = {}
    for j in range(len(idx) - 1, -1, -1):
        i = idx[j]
        zinv[i] = inv * prefix[j] % P
        inv = inv * zs[i] % P
    out = []
    for i in range(n):
        if zs[i] == 0:
            out.append(G1Point.infinity())
        else:
            out.append(G1Point(xs[i] * zinv[i] % P, ys[i] * zinv[i] % P))
    return out


# ---------------------------------------------------------------- tables


@lru_cache(maxsize=None)
def _pow_table(start: int, count: int) -> np.ndarray:
    """(count, 32) limbs of 2^(12k) mod p, k = start…start+count-1."""
    out = np.zeros((count, NP_LIMBS), dtype=np.int32)
    for k in range(count):
        out[k] = fp_to_limbs(pow(2, LIMB_BITS * (start + k), P), NP_LIMBS)
    return out


@lru_cache(maxsize=None)
def _sub_pad() -> np.ndarray:
    """Limbs of a multiple of p, each limb in [4096, 8192): a + pad − b
    is non-negative in every limb for loose a, b."""
    floor = sum(BASE << (LIMB_BITS * i) for i in range(L))  # all-4096 limbs
    k = -(-floor // P) + 1
    rem = k * P - floor
    digits = fp_to_limbs(rem)  # each < 4096 by construction
    if k * P >= 1 << (LIMB_BITS * (L + 1)):
        raise AssertionError("sub pad exceeds one extra limb")
    return digits + BASE


@lru_cache(maxsize=None)
def _fold_matrix(high: int, device: str) -> torch.Tensor:
    """(32, high) float64 transpose of the 2^(12k) mod p table.  The fold
    runs as a float64 matmul — CUDA has no integer matmul — which is
    exact: each sum is ≤ 35 · 4096 · 4095 < 2^31 ≪ 2^53."""
    t = _pow_table(NP_LIMBS, high).T.astype(np.float64)
    return torch.as_tensor(np.ascontiguousarray(t), device=device)


@lru_cache(maxsize=None)
def _pad_tensor(device: str) -> torch.Tensor:
    return torch.as_tensor(_sub_pad(), device=device)


@lru_cache(maxsize=None)
def _antidiag_index(device: str) -> torch.Tensor:
    """Row i·33 + j of the outer product lands on anti-diagonal i + j."""
    i = torch.arange(L)
    return (i[:, None] + i[None, :]).reshape(-1).to(device)


def _dev(x: torch.Tensor) -> str:
    return str(x.device)


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(33,) constant → (33, 1, …) broadcastable against `like`."""
    return v.reshape((L,) + (1,) * (like.dim() - 1))


# ---------------------------------------------------------------- Fp twin
# Field elements are (33, …) int32 tensors, limb-major.  All ops accept any
# trailing batch shape, and every op returns a fresh tensor.


def _norm(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Value-preserving carry passes for NON-NEGATIVE limbs, in place:
    every caller hands over a fresh tensor of its own."""
    n = x.shape[0]
    upper = x.narrow(0, 1, n - 1)
    for _ in range(passes):
        carry = x.narrow(0, 0, n - 1) >> LIMB_BITS
        x.bitwise_and_(BASE - 1)
        upper.add_(carry)
    return x


def _fold(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Normalized limbs (any length, each ≤ 4096) → loose (33, …) limbs,
    congruent mod p: each round folds the limbs ≥ 32 through the
    2^(12k) mod p table (ops/g1.py `_fold` of the JAX package)."""
    batch = x.shape[1:]
    for _ in range(rounds):
        k = x.shape[0]
        high = x[NP_LIMBS:].reshape(k - NP_LIMBS, -1).to(torch.float64)
        folded = (_fold_matrix(k - NP_LIMBS, _dev(x)) @ high).to(I32)
        y = x.new_zeros((NP_LIMBS + 2,) + batch)
        y[:NP_LIMBS] = x[:NP_LIMBS] + folded.reshape((NP_LIMBS,) + batch)
        x = _norm(y, 3)
    return x[:L]


MUL_COUNT = [0]  # Fp products computed by `mulm` (lanes · calls)
SQR_COUNT = [0]  # of those, squarings: `mulm(a, a)`, and pt_double's two


def _batch(a: torch.Tensor, b: torch.Tensor) -> torch.Size:
    """The broadcast batch shape of two limb tensors."""
    if a.shape == b.shape:
        return a.shape[1:]
    return torch.broadcast_shapes(a.shape[1:], b.shape[1:])


def mulm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Loose × loose → loose: outer product, scatter-add over the
    anti-diagonals (each sums ≤ 33 products ≤ 4096² < 2^29), three carry
    passes, two folds."""
    batch = _batch(a, b)
    MUL_COUNT[0] += math.prod(batch)
    if a is b:
        SQR_COUNT[0] += math.prod(batch)
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape((L * L,) + batch)
    acc = prod.new_zeros((2 * L + 1,) + batch)
    acc.index_add_(0, _antidiag_index(_dev(prod)), prod)
    return _fold(_norm(acc, 3), rounds=2)


def addm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = _batch(a, b)
    s = a.new_zeros((L + 1,) + batch)
    s[:L] = a + b
    return _fold(_norm(s, 2), rounds=1)


def subm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = _batch(a, b)
    s = a.new_zeros((L + 1,) + batch)
    s[:L] = a + _bcast(_pad_tensor(_dev(a)), a) - b
    return _fold(_norm(s, 2), rounds=1)


def smallmul(a: torch.Tensor, c: int) -> torch.Tensor:
    """a · c for a small positive constant (c ≤ 2^17)."""
    s = a.new_zeros((L + 2,) + a.shape[1:])
    s[:L] = a * c
    return _fold(_norm(s, 3), rounds=1)


def _st(*xs: torch.Tensor) -> torch.Tensor:
    """Stack field elements on a new batch axis right after the limbs."""
    return torch.stack(torch.broadcast_tensors(*xs), dim=1)


def limb_one(like: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(like)
    out[0] = 1
    return out


def infinity(like: torch.Tensor):
    zero = torch.zeros_like(like)
    return zero, limb_one(like), zero.clone()


# ---------------------------------------------------------------- points


def pt_add(p, q):
    """Complete projective addition (RCB Alg. 7, a = 0), the JAX
    package's formula sequence with independent products stacked."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s = addm(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    m = mulm(
        _st(X1, Y1, Z1, s[:, 0], s[:, 1], s[:, 2]),
        _st(X2, Y2, Z2, s[:, 3], s[:, 4], s[:, 5]),
    )
    t0, t1, t2 = m[:, 0], m[:, 1], m[:, 2]
    d = subm(m[:, 3:6], addm(_st(t0, t1, t0), _st(t1, t2, t2)))
    t3, t4, ty = d[:, 0], d[:, 1], d[:, 2]  # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1
    t0 = addm(addm(t0, t0), t0)  # 3·X1X2
    k = smallmul(_st(t2, ty), B3)
    t2, ty = k[:, 0], k[:, 1]  # 3b·Z1Z2, 3b(X1Z2 + X2Z1)
    Z3 = addm(t1, t2)  # Y1Y2 + 3bZ1Z2
    t1 = subm(t1, t2)  # Y1Y2 − 3bZ1Z2
    m = mulm(_st(t3, t4, t1, ty, Z3, t0), _st(t1, ty, Z3, t0, t4, t3))
    X3 = subm(m[:, 0], m[:, 1])
    YZ = addm(_st(m[:, 2], m[:, 4]), _st(m[:, 3], m[:, 5]))
    return X3, YZ[:, 0], YZ[:, 1]


def pt_double(p):
    """Complete projective doubling (RCB Alg. 9, a = 0)."""
    X, Y, Z = p
    m = mulm(_st(Y, Y, Z, X), _st(Y, Z, Z, Y))
    SQR_COUNT[0] += 2 * math.prod(m.shape[2:])  # Y·Y and Z·Z of the stack
    t0, t1, zz, xy = m[:, 0], m[:, 1], m[:, 2], m[:, 3]
    Z3 = addm(t0, t0)
    Z3 = addm(Z3, Z3)
    Z3 = addm(Z3, Z3)  # 8Y²
    t2 = smallmul(zz, B3)  # 3bZ²
    m = mulm(_st(t2, t1), _st(Z3, Z3))
    X3, Z3 = m[:, 0], m[:, 1]  # 24bY²Z², 8Y³Z
    Y3 = addm(t0, t2)
    t2 = addm(addm(t2, t2), t2)  # 9bZ²
    t0 = subm(t0, t2)  # Y² − 9bZ²
    m = mulm(_st(t0, t0), _st(Y3, xy))
    s = addm(_st(X3, m[:, 1]), _st(m[:, 0], m[:, 1]))
    return s[:, 1], s[:, 0], Z3


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """cond: (…) bool over the batch shape; a, b: (33, …) limb tensors."""
    return torch.where(cond.unsqueeze(0), a, b)


def select_point(cond, a, b):
    return tuple(_select(cond, x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------- exact digits


def _shift_up(x: torch.Tensor, fill: int = 0) -> torch.Tensor:
    """out[i] = x[i-1], out[0] = fill (along the limb axis)."""
    out = torch.full_like(x, fill)
    out[1:] = x[:-1]
    return out


def _prefix_or_and(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive Kogge–Stone scan of carry/borrow propagation along axis
    0: out_i = g_i | (p_i & out_{i-1}), on int32 {0, 1} tensors."""
    n = g.shape[0]
    d = 1
    while d < n:
        g2 = g.clone()
        g2[d:] |= p[d:] & g[:-d]
        p2 = p.clone()
        p2[d:] &= p[:-d]
        g, p = g2, p2
        d *= 2
    return g


def exact_digits(x: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Non-negative limbs → the EXACT base-4096 digits of the same value
    (same length; the caller guarantees the value fits).  `passes` carry
    sweeps bound the limbs to ≤ 4096 (3 suffice for limbs < 2^28), then
    one Kogge–Stone scan resolves the unit carries left, which could
    otherwise cascade the full length."""
    x = _norm(x.clone(), passes)
    a = (x & (BASE - 1)) + _shift_up(x >> LIMB_BITS)
    g = (a >= BASE).to(I32)
    p = (a == BASE - 1).to(I32)
    return (a + _shift_up(_prefix_or_and(g, p))) & (BASE - 1)


def limb_product_digits(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Exact digits of the integer product of two exact-digit limb
    values: a (ka, …) × b (kb, …) → (out_len, …), wide MSM scalars (such
    as ρ·v·h_eff) formed on the device instead of in host big-ints."""
    ka, kb = a.shape[0], b.shape[0]
    if min(ka, kb) > 16:
        # anti-diagonal sums of min(ka, kb) 4095² products must stay
        # below 2^28 for exact_digits' three carry passes to be exact
        raise ValueError("limb_product_digits: operand too wide (>16 limbs)")
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = a.new_zeros((max(ka + kb, out_len),) + batch)
    for i in range(ka):
        acc[i : i + kb] += a[i : i + 1] * b
    return exact_digits(acc, passes=3)[:out_len]


# ---------------------------------------------------------------- ladder


def batch_scalar_mul(points, scalars: torch.Tensor, bits: int = SCALAR_BITS):
    """Twin of kernel K3: [s_i]P_i by MSB-first double-and-add over
    `bits` bits with a masked select (JAX package `batch_scalar_mul`).

    points: (X, Y, Z) of (33, …); scalars: (22, …) int32 limbs."""
    acc = infinity(points[0])
    for i in range(bits):
        j = bits - 1 - i
        acc = pt_double(acc)
        s = pt_add(acc, points)
        bit = ((scalars[j // LIMB_BITS] >> (j % LIMB_BITS)) & 1) == 1
        acc = select_point(bit, s, acc)
    return acc


def ladder_work(scalars, bits: int = SCALAR_BITS) -> tuple[int, int]:
    """(Fp products, of which squarings) that [s]P needs over all lanes
    of a (22, N) limb array: one doubling (8 products, 2 squarings) per
    bit below a lane's top set bit and one addition (12 products) per set
    bit, counting bits below `bits` only.  Steps outside these leave the
    accumulator as it is, which is what kernel K3 skips."""
    s = np.asarray(scalars.cpu() if isinstance(scalars, torch.Tensor) else scalars)
    doublings = additions = 0
    for j in range(s.shape[1]):
        v = limbs_to_fp(s[:, j] & (BASE - 1)) & ((1 << bits) - 1)
        doublings += max(v.bit_length() - 1, 0)
        additions += bin(v).count("1")
    return 8 * doublings + 12 * additions, 2 * doublings


def _check_points(points, *others):
    """(33, N) int32 coordinates and (k, N) int32 companions on one device."""
    X = points[0]
    for a in tuple(points) + others:
        if a.dtype != I32 or a.device != X.device:
            raise TypeError("limb tensors must be int32 on one device")
        if a.dim() != 2 or a.shape[1] != X.shape[1]:
            raise ValueError(f"expected (k, N) limbs, got {tuple(a.shape)}")
    if X.shape[0] != L or any(a.shape != X.shape for a in points):
        raise ValueError(f"expected (33, N) coordinates, got {tuple(X.shape)}")


def scalar_mul_ladder(points, scalars: torch.Tensor, bits: int = SCALAR_BITS):
    """Kernel K3 (csrc/ladder.cu) on CUDA tensors, its twin
    `batch_scalar_mul` on CPU tensors.  (33, N) points, (22, N) scalars
    → projective (33, N) triple.  Mod p, coordinate by coordinate, both
    give the JAX package's `batch_scalar_mul`."""
    _check_points(points, scalars)
    if not 1 <= bits <= SCALAR_BITS + 9:
        raise ValueError("bits out of range")
    dev = points[0].device
    if dev.type == "cuda":
        out = _cuda.ladder(*points, scalars, bits)
        scalar_mul_ladder.launches += 1
        return out
    if dev.type != "cpu":
        raise RuntimeError(f"no K3 kernel for device {dev}")
    return batch_scalar_mul(points, scalars, bits)


scalar_mul_ladder.launches = 0


def tree_reduce(points, axis_size: int):
    """Σ over the LAST batch axis (a power of two) by pairwise halving."""
    X, Y, Z = points
    n = axis_size
    while n > 1:
        h = n // 2
        X, Y, Z = pt_add(
            (X[..., :h], Y[..., :h], Z[..., :h]),
            (X[..., h:], Y[..., h:], Z[..., h:]),
        )
        n = h
    return X[..., 0], Y[..., 0], Z[..., 0]


def _pad_pow2(arrs: list[np.ndarray], n: int, axis: int = 0, y_index: int = 1):
    """Pad point/scalar batches along `axis` to the next power of two with
    (∞ = (0,1,0), scalar 0) entries; `y_index` names the Y array."""
    m = 1 << max(0, (n - 1).bit_length())
    if m == n:
        return arrs, n
    out = []
    for k, a in enumerate(arrs):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, m - n)
        a = np.pad(a, pad)
        if k == y_index:
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(n, m)
            a[tuple(sl)][..., 0] = 1
        out.append(a)
    return out, m


# ---------------------------------------------------------------- host API


def _prepare(points, scalars, bits: int, device):
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    scalars = [s % R for s in scalars]
    if bits < SCALAR_BITS and any(s >> bits for s in scalars):
        raise ValueError("scalar exceeds the bits cap")
    X, Y, Z = points_to_projective(points)
    s = scalars_to_limbs(scalars)
    (X, Y, Z, s), m = _pad_pow2([X, Y, Z, s], len(points))
    return tuple(limbs_from_numpy(a.T, device) for a in (X, Y, Z, s)) + (m,)


def _msm_kernel(X, Y, Z, scalars, bits=SCALAR_BITS, group=None):
    """(33, N) inputs → per-group MSM through K3 and a pairwise tree."""
    acc = scalar_mul_ladder((X, Y, Z), scalars, bits=bits)
    n = X.shape[1]
    if group is not None:
        acc = tuple(a.reshape(L, n // group, group) for a in acc)
        return tree_reduce(acc, group)
    return tree_reduce(tuple(a[:, None, :] for a in acc), n)


def msm(points, scalars, bits: int = SCALAR_BITS, device="cuda") -> G1Point:
    """Π P_i^{s_i}; every scalar must satisfy s % r < 2^bits."""
    if not points:
        if len(scalars):
            raise ValueError("points/scalars length mismatch")
        return G1Point.infinity()
    X, Y, Z, s, _ = _prepare(points, scalars, bits, device)
    rX, rY, rZ = _msm_kernel(X, Y, Z, s, bits=bits)
    return projective_to_points(rX.T, rY.T, rZ.T)[0]


def msm_grouped(points, scalars, bits: int = SCALAR_BITS, device="cuda"):
    """Per-group MSMs in one K3 launch: result[b] = Π_i P[b][i]^{s[b][i]}
    (groups padded to a common power-of-two width with (∞, 0) pairs)."""
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return []
    width = max(len(g) for g in points)
    g = 1 << max(0, (width - 1).bit_length())
    B = len(points)
    flatpts: list[G1Point] = []
    flatsc: list[int] = []
    inf = G1Point.infinity()
    for prow, srow in zip(points, scalars):
        if len(prow) != len(srow):
            raise ValueError("group length mismatch")
        flatpts.extend(prow)
        flatpts.extend([inf] * (g - len(prow)))
        flatsc.extend(srow)
        flatsc.extend([0] * (g - len(srow)))
    flatsc = [s % R for s in flatsc]
    if bits < SCALAR_BITS and any(s >> bits for s in flatsc):
        raise ValueError("scalar exceeds the bits cap")
    X, Y, Z = points_to_projective(flatpts)
    s = scalars_to_limbs(flatsc)
    X = X.reshape(B, g, L)
    Y = Y.reshape(B, g, L)
    Z = Z.reshape(B, g, L)
    s = s.reshape(B, g, R_LIMBS)
    (X, Y, Z, s), Bp = _pad_pow2([X, Y, Z, s], B)
    flat = [
        limbs_from_numpy(a.reshape(Bp * g, -1).T, device) for a in (X, Y, Z, s)
    ]
    rX, rY, rZ = _msm_kernel(*flat, bits=bits, group=g)
    return projective_to_points(rX.T[:B], rY.T[:B], rZ.T[:B])


def scalar_mul_batch(points, scalars, bits: int = SCALAR_BITS, device="cuda"):
    """[s_i]P_i per element, returned as host points."""
    if not points:
        if len(scalars):
            raise ValueError("points/scalars length mismatch")
        return []
    n = len(points)
    X, Y, Z, s, _ = _prepare(points, scalars, bits, device)
    rX, rY, rZ = scalar_mul_ladder((X, Y, Z), s, bits=bits)
    return projective_to_points(rX.T[:n], rY.T[:n], rZ.T[:n])


# ---------------------------------------------------------------- flat MSM
# Pippenger-style windowed-bucket MSM for ONE large flat sum Σ_i s_i·P_i
# (the JAX package's msm_wide path).  The window width is the limb width,
# so a scalar's exact base-4096 digits are its bucket indices.  Each window
# (a) sorts the lanes by digit, (b) sums the runs of equal digits with a
# segmented Hillis–Steele scan whose combine is the complete addition, and
# (c) scatters the run totals into buckets.  It then needs Σ_d d·B_d.
#
# The JAX package keeps 4,096 dense buckets (XLA wants static shapes) and
# takes Σ_d d·B_d by a suffix scan over all of them: 12 × 4,096 additions a
# window whatever the lane count.  Here the run totals go to compact
# buckets in digit order (K = the power of two ≥ min(lanes, 4,096), one
# more column absorbs every other lane), and Σ_d d·B_d = Σ_b 2^b M_b with
# M_b = Σ_{d: bit b of d set} B_d: twelve masked tree sums over K buckets,
# then a 12-step Horner.  At width (K = 4,096) that is the same 12 × 4,096
# additions a window; on a few lanes it is a few dozen.  All windows of a
# lane chunk go through the sort, scan and tree at once.  Results are the
# same group element as the JAX package's; the projective limbs differ
# with the order of the additions, so callers compare affine points.
#
# Scalars may be WIDER than r: nothing here reduces mod r, which is what
# the cofactor-folding contract needs (ops/h2c.py: scalars multiplied by
# h_eff on points whose group order is h·r).

# Window-lanes (windows × points) one bucket fold takes at once: the
# scan's point additions hold ~30 KB of temporaries a lane, so 2^18 keeps a
# chunk's peak near 8 GB on the card.
_FLAT_CHUNK = 1 << 18


def _window_bucket_fold(points, digits: torch.Tensor, n_buckets: int):
    """Σ_i digit_{w,i}·P_i for every window w: points (33, N) each,
    digits (W, N) in [0, n_buckets) → (33, W) projective window sums."""
    W, n = digits.shape
    order = torch.argsort(digits, dim=1, stable=True)
    sd = torch.gather(digits, 1, order)
    pts = tuple(c[:, order] for c in points)  # (33, W, N), sorted by digit
    d = 1
    while d < n:
        same = sd[:, d:] == sd[:, :-d]
        s = pt_add(tuple(c[..., :-d] for c in pts), tuple(c[..., d:] for c in pts))
        pts = tuple(
            torch.cat([c[..., :d], _select(same, a, c[..., d:])], dim=-1)
            for c, a in zip(pts, s)
        )
        d *= 2
    # a run's total sits at its last lane; digit-0 runs add nothing
    nxt = torch.cat([sd[:, 1:], torch.full_like(sd[:, :1], -1)], dim=1)
    is_end = (sd != nxt) & (sd != 0)
    k = 1 << (min(n, n_buckets) - 1).bit_length()
    idx = torch.where(is_end, torch.cumsum(is_end, dim=1) - 1, k)
    # column k is the dump: duplicate writes land only there
    buckets = infinity(points[0].new_zeros((L, W, k + 1)))
    for b, c in zip(buckets, pts):
        b.scatter_(2, idx.unsqueeze(0).expand(L, W, n), c)
    bd = sd.new_zeros((W, k + 1)).scatter_(1, idx, sd)[:, :k]
    bit = (bd.unsqueeze(1) >> torch.arange(LIMB_BITS, device=bd.device).view(1, -1, 1)) & 1
    inf = infinity(points[0].new_zeros((L, 1, 1, 1)))
    M = tree_reduce(
        select_point(bit == 1, tuple(b[..., :k].unsqueeze(2) for b in buckets), inf), k
    )  # (33, W, 12): M_b of every window
    acc = tuple(m[..., LIMB_BITS - 1] for m in M)
    for b in range(LIMB_BITS - 2, -1, -1):
        acc = pt_add(pt_double(acc), tuple(m[..., b] for m in M))
    return acc


def _msm_flat_kernel(X, Y, Z, digits: torch.Tensor, n_windows: int):
    """digits: (≥ n_windows, N) EXACT base-4096 scalar digits.  Returns
    the MSM total as a projective (33,) limb triple.  Window sums add
    across lane chunks; one Horner over the windows closes."""
    n = X.shape[1]
    if n == 0:
        return infinity(X.new_zeros((L,)))
    step = 1 << max(0, (_FLAT_CHUNK // n_windows).bit_length() - 1)
    sums = None
    for start in range(0, n, step):
        sl = slice(start, min(start + step, n))
        part = _window_bucket_fold((X[:, sl], Y[:, sl], Z[:, sl]), digits[:n_windows, sl], BASE)
        sums = part if sums is None else pt_add(sums, part)
    acc = tuple(c[:, n_windows - 1] for c in sums)
    for j in range(n_windows - 2, -1, -1):
        for _ in range(LIMB_BITS):
            acc = pt_double(acc)
        acc = pt_add(acc, tuple(c[:, j] for c in sums))
    return acc


def msm_flat_device(points, digits: torch.Tensor, bits: int):
    """Flat MSM over device-resident limb points with exact-digit device
    scalars.  points: (X, Y, Z) each (33, N); digits: (K, N) with
    K ≥ ⌈bits/12⌉.  Returns the projective total as numpy (33,) triples."""
    n_windows = -(-bits // LIMB_BITS)
    if digits.shape[0] < n_windows:
        raise ValueError("digit rows < windows for the requested bits")
    total = _msm_flat_kernel(*points, digits, n_windows)
    return tuple(limbs_to_numpy(t) for t in total)


def scalars_to_digits(scalars, n_limbs: int) -> np.ndarray:
    """Raw integer scalars (possibly ≥ r: flat-MSM semantics never
    reduce) → (n_limbs, N) exact base-4096 digits."""
    from .fr import ints_to_words, words_to_limbs

    scalars = [int(s) for s in scalars]
    if any(s < 0 for s in scalars):
        raise ValueError("negative scalar")
    if any(s >> (LIMB_BITS * n_limbs) for s in scalars):
        raise ValueError("scalar exceeds digit width")
    words = ints_to_words(scalars, 4 * -(-LIMB_BITS * n_limbs // 32))
    return words_to_limbs(words, LIMB_BITS, n_limbs, np.int32).T


def msm_wide(points, scalars, bits: int, device="cuda") -> G1Point:
    """Host-list flat-MSM entry: Σ [s_i]P_i with raw (unreduced) integer
    scalars up to `bits` wide — the Pippenger path, plain tensor code on
    `device` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if len(points) != len(scalars):
        raise ValueError("points/scalars length mismatch")
    if not points:
        return G1Point.infinity()
    d = scalars_to_digits(scalars, -(-bits // LIMB_BITS))
    pts = tuple(limbs_from_numpy(a.T, device) for a in points_to_projective(points))
    rX, rY, rZ = msm_flat_device(pts, limbs_from_numpy(d, device), bits)
    return projective_to_points(rX[None], rY[None], rZ[None])[0]
