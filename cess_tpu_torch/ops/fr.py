"""Batched BLS12-381 scalar-field (Fr) linear algebra in PyTorch.

The PoDR2 pipeline's data-heavy arithmetic has one shape — "contract an
array of field elements against a coefficient vector, mod r":

 * prove:          μ_j  = Σ_c v_c · m_{c,j}
 * batch combine:  e_j  = Σ_b ρ_b · μ_{b,j}

Elements are base-128 limbs (int8 on the wire).  The pipeline follows the
JAX package's ops/fr.py: limb contraction and anti-diagonal fold, carry
normalisation, folds through a 2^(7k) mod r table, conditional
subtractions, exact carry.  This is plain device code in the JAX package
(no Pallas kernel), so plain tensor code is its port.

Both contractions run as float64 matmuls — CUDA has no integer matmul —
and stay exact: every partial sum is ≤ K · 127² · 37 < 2^53 for the
K ≤ SAFE_CONTRACTION (2048) terms of one call.  Output is bit-identical
to Python `sum(w*v) % R`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

LIMB_BITS = 7
BASE = 1 << LIMB_BITS
NLIMBS = (255 + LIMB_BITS - 1) // LIMB_BITS  # 37 limbs for an Fr element

I32 = torch.int32
F64 = torch.float64


# ---------------------------------------------------------------- host codec


def int_to_limbs(x: int, n: int) -> np.ndarray:
    if x < 0 or x >> (LIMB_BITS * n):
        raise ValueError(f"{x} does not fit in {n} base-128 limbs")
    out = np.zeros(n, dtype=np.int8)
    for i in range(n):
        out[i] = x & (BASE - 1)
        x >>= LIMB_BITS
    return out


def ints_to_limbs(xs, n: int) -> np.ndarray:
    """Iterable of ints -> (len, n) int8 little-endian limb array."""
    return np.stack([int_to_limbs(int(x), n) for x in xs])


def ints_to_words(xs, nbytes: int) -> np.ndarray:
    """Iterable of ints (each < 2^(8·nbytes), nbytes % 4 == 0) →
    (len, nbytes/4) uint32 little-endian words."""
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    n = len(buf) // nbytes if nbytes else 0
    return np.frombuffer(buf, dtype="<u4").reshape(n, nbytes // 4)


def words_to_limbs(
    words: np.ndarray, limb_bits: int, nlimbs: int, dtype=np.int8
) -> np.ndarray:
    """(…, W) uint32 little-endian words → (…, nlimbs) exact
    base-2^limb_bits limbs (limb_bits ≤ 25: a limb spans ≤ two words)."""
    if limb_bits > 25:
        raise ValueError("words_to_limbs: limb_bits must be <= 25")
    w = np.asarray(words).astype(np.uint32, copy=False)
    nwords = w.shape[-1]
    out = np.zeros(w.shape[:-1] + (nlimbs,), dtype=np.uint32)
    mask = np.uint32((1 << limb_bits) - 1)
    for i in range(nlimbs):
        lo_bit = limb_bits * i
        wi, sh = lo_bit // 32, lo_bit % 32
        if wi >= nwords:
            break
        val = w[..., wi] >> np.uint32(sh)
        if sh + limb_bits > 32 and wi + 1 < nwords:
            val = val | (w[..., wi + 1] << np.uint32(32 - sh))
        out[..., i] = val & mask
    return out.astype(dtype)


def limbs_to_int(limbs) -> int:
    x = 0
    for i, limb in enumerate(np.asarray(limbs).astype(np.int64).tolist()):
        x += int(limb) << (LIMB_BITS * i)
    return x


def limbs_to_ints(arr) -> list[int]:
    """(..., n) limb array (numpy or tensor) -> flat list of ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu").numpy()
    a = np.asarray(arr)
    flat = a.reshape(-1, a.shape[-1])
    return [limbs_to_int(row) for row in flat]


@lru_cache(maxsize=None)
def _fold_matrix(li: int, lj: int) -> np.ndarray:
    """(li, lj, li+lj-1) one-hot: out[i, j, i+j] = 1."""
    out = np.zeros((li, lj, li + lj - 1), dtype=np.int8)
    for i in range(li):
        for j in range(lj):
            out[i, j, i + j] = 1
    return out


@lru_cache(maxsize=None)
def _pow_table(start: int, count: int) -> np.ndarray:
    """(count, NLIMBS) limbs of 2^(7k) mod r for k = start..start+count-1."""
    return ints_to_limbs(
        [pow(2, LIMB_BITS * k, R) for k in range(start, start + count)], NLIMBS
    )


@lru_cache(maxsize=None)
def _dev_table(kind: str, a: int, b: int, device: str) -> torch.Tensor:
    if kind == "fold":
        t = _fold_matrix(a, b).reshape(a * b, -1)
    else:
        t = _pow_table(a, b)
    return torch.as_tensor(t.astype(np.float64), device=device)


@lru_cache(maxsize=None)
def _r_limbs(length: int, device: str) -> torch.Tensor:
    r = np.zeros(length, dtype=np.int32)
    r[:NLIMBS] = int_to_limbs(R, NLIMBS)
    return torch.as_tensor(r, device=device)


# ---------------------------------------------------------------- device ops


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n))


def _carry_pass(x: torch.Tensor) -> torch.Tensor:
    """One base-128 carry pass along the last axis (length preserved)."""
    carry = x >> LIMB_BITS
    x = x & (BASE - 1)
    x[..., 1:] += carry[..., :-1]
    return x


def _normalize(x: torch.Tensor, passes: int = 6) -> torch.Tensor:
    """Carry-normalize int32 limbs (each < 2^31) to limbs ≤ 128."""
    for _ in range(passes):
        x = _carry_pass(x)
    return x


def _shift_last(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[..., 1:] = x[..., :-1]
    return out


def _prefix_last(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive Kogge–Stone scan along the last axis:
    out_i = g_i | (p_i & out_{i-1})."""
    n = g.shape[-1]
    d = 1
    while d < n:
        g2 = g.clone()
        g2[..., d:] |= p[..., d:] & g[..., :-d]
        p2 = p.clone()
        p2[..., d:] &= p[..., :-d]
        g, p = g2, p2
        d *= 2
    return g


def _carry_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact base-128 digits of limbs in [0, 128] (the caller guarantees
    the value fits): one split into digit + carry bit, then the carry
    chain resolved by prefix scan — the same digits as the JAX package's
    sequential scan."""
    a = (x & (BASE - 1)) + _shift_last(x >> LIMB_BITS)  # ≤ 128
    gen = (a >= BASE).to(I32)
    prop = (a == BASE - 1).to(I32)
    return (a + _shift_last(_prefix_last(gen, prop))) & (BASE - 1)


def _cond_sub_r(x: torch.Tensor) -> torch.Tensor:
    """x (…, L) normalized limbs → where(x >= r, x - r, x), borrows
    resolved by prefix scan: limb i borrows iff d_i < 0, or d_i = 0 and
    limb i−1 borrows; the output limb is d_i − b_in + 128·b_out, exactly
    the JAX package's sequential borrow chain."""
    d = x - _r_limbs(x.shape[-1], str(x.device))
    bout = _prefix_last((d < 0).to(I32), (d == 0).to(I32))
    sub = d - _shift_last(bout) + BASE * bout
    return torch.where((bout[..., -1] == 0).unsqueeze(-1), sub, x)


def _fold_once(x: torch.Tensor) -> torch.Tensor:
    """One fold of limbs ≥ NLIMBS through the 2^(7k) mod r table."""
    low, high = x[..., :NLIMBS], x[..., NLIMBS:]
    if high.shape[-1] == 0:
        return _normalize(_pad_last(x, 2))
    table = _dev_table("pow", NLIMBS, high.shape[-1], str(x.device))
    folded = (high.to(F64) @ table).to(I32)
    return _normalize(_pad_last(low + folded, 2))


def _fold_to_canonical(x: torch.Tensor) -> torch.Tensor:
    """Normalized limbs of any length → canonical NLIMBS representative:
    four folds, twenty conditional subtractions, one exact carry."""
    x = _fold_once(x)
    for _ in range(3):
        x = _fold_once(x[..., : NLIMBS + 2])
    x = x[..., : NLIMBS + 2]
    for _ in range(20):
        x = _cond_sub_r(x)
    return _carry_exact(x[..., :NLIMBS])


SAFE_CONTRACTION = 2048


def weighted_sum_kernel(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_k w[k] · v[..., k, :] mod r.

    w: (K, Lw) int8 limbs; v: (..., K, Lv) int8 limbs.  Returns
    (..., NLIMBS) int32 canonical limbs.  Contractions beyond
    SAFE_CONTRACTION are split and their canonical partials re-reduced."""
    k = w.shape[0]
    if k > SAFE_CONTRACTION:
        total = None
        for start in range(0, k, SAFE_CONTRACTION):
            stop = min(start + SAFE_CONTRACTION, k)
            part = _weighted_sum_unchunked(w[start:stop], v[..., start:stop, :])
            total = part if total is None else total + part
        return _fold_to_canonical(_normalize(_pad_last(total, 3)))
    return _weighted_sum_unchunked(w, v)


def _weighted_sum_unchunked(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # contraction over K, then the anti-diagonal fold: two exact float64
    # matmuls (sums < 2^31, cast back to int32 like the JAX int32 path)
    t = v.to(F64).transpose(-1, -2) @ w.to(F64)  # (..., Lv, Lw)
    lv, lw = t.shape[-2], t.shape[-1]
    fold = _dev_table("fold", lv, lw, str(w.device))
    prod = (t.reshape(t.shape[:-2] + (lv * lw,)) @ fold).to(I32)
    return _fold_to_canonical(_normalize(_pad_last(prod, 5)))


# ---------------------------------------------------------------- public API


def _limb_width(max_value: int) -> int:
    return (max_value.bit_length() + LIMB_BITS - 1) // LIMB_BITS


def mu_aggregate(coefficients, sector_limbs: np.ndarray, device="cuda"):
    """Batched PoDR2 μ: the challenge coefficients against
    (..., C, S, Lm) int8 sector limbs → (..., S, NLIMBS) int32 limbs."""
    lw = max(1, _limb_width((1 << 160) - 1))
    w = torch.as_tensor(ints_to_limbs(coefficients, lw), device=device)
    v = np.ascontiguousarray(np.moveaxis(np.asarray(sector_limbs), -3, -2))
    out = weighted_sum_kernel(w, torch.as_tensor(v, device=device))
    return out.cpu().numpy()


def combine_mu(rhos: list[int], mu_limbs: np.ndarray, device="cuda"):
    """Σ_b ρ_b·μ_b per sector column: (B, S, Lm) int8 → (S, NLIMBS)."""
    lw = max(1, _limb_width(max(rhos)))
    w = torch.as_tensor(ints_to_limbs(rhos, lw), device=device)
    v = np.ascontiguousarray(np.moveaxis(np.asarray(mu_limbs), 0, -2))
    out = weighted_sum_kernel(w, torch.as_tensor(v, device=device))
    return out.cpu().numpy()


def sectors_to_limbs(matrix: list[list[int]]) -> np.ndarray:
    """PoDR2 sector matrix (n × s ints < 2^248) → (n, s, 36) int8 limbs."""
    n = len(matrix)
    s = len(matrix[0])
    lm = _limb_width((1 << 248) - 1)
    out = np.zeros((n, s, lm), dtype=np.int8)
    for i, row in enumerate(matrix):
        for j, m in enumerate(row):
            out[i, j] = int_to_limbs(m, lm)
    return out


def fr_to_limbs(values: list[int]) -> np.ndarray:
    """Canonical Fr values → (len, NLIMBS) int8 limbs."""
    return ints_to_limbs(values, NLIMBS)
