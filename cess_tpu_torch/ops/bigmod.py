"""Fixed-modulus big-integer arithmetic in PyTorch (base-128 limbs).

The port of `cess_tpu/ops/bigmod.py`: s^65537 mod n for a batch of
signatures under one RSA modulus (the IAS report-signing key), as the
JAX package computes it — outer-product limb products summed along their
anti-diagonals, folds of the high limbs through a 2^(7k) mod n table,
then shifted conditional subtractions to the canonical residue.  The JAX
package runs this in plain XLA (no Pallas kernel), so plain tensor code
is its port, and the limbs out equal the JAX package's exactly.

Two steps differ in form, not in value:

* the fold is a float64 matmul (CUDA has no integer matmul); every sum
  is ≤ (nl + 8) · 128 · 127 < 5·10^6 for RSA-2048 (nl = 293), exact in
  float64 as in the JAX package's int32;
* the conditional subtraction resolves its borrows with a prefix scan
  (`fr._prefix_last`) instead of a sequential scan along the limbs: limb
  i borrows iff d_i < 0, or d_i = 0 and limb i−1 borrows — the same
  limbs out.

The batch is walked in pieces whose temporaries (outer product and its
sheared copy) fit `TEMP_BYTES`; contexts and device tables are cached
per modulus and per (modulus, device).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from .fr import _normalize, _pad_last, _prefix_last, _shift_last

LIMB_BITS = 7
BASE = 1 << LIMB_BITS

# Bytes of temporaries one piece of a modexp batch may hold: 1,024
# RSA-2048 lanes (≈ 1.04 MB each) fit in one piece.
TEMP_BYTES = 1 << 30

I32 = torch.int32
F64 = torch.float64


def int_to_limbs(x: int, n: int) -> np.ndarray:
    if x < 0 or x >> (LIMB_BITS * n):
        raise ValueError(f"{x} does not fit in {n} limbs")
    out = np.zeros(n, dtype=np.int8)
    for i in range(n):
        out[i] = x & (BASE - 1)
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    x = 0
    for i, limb in enumerate(np.asarray(limbs).astype(np.int64).tolist()):
        x += int(limb) << (LIMB_BITS * i)
    return x


@dataclass(frozen=True)
class ModContext:
    """Host tables for arithmetic mod a fixed modulus (numpy, equal to the
    JAX package's)."""

    modulus: int
    nlimbs: int
    mod_limbs: np.ndarray = field(repr=False)
    # fold table: 2^(7k) mod n for k in [nlimbs, 2*nlimbs+6)
    fold_table: np.ndarray = field(repr=False)
    # n·2^k for k = 9..0: shifted-multiple subtraction reaches canonical in
    # 10+1 passes for ANY modulus (value after folds < 2^8·n; 2^9 margin).
    mod_shifts: np.ndarray = field(repr=False)

    @classmethod
    def create(cls, modulus: int) -> "ModContext":
        nl = (modulus.bit_length() + LIMB_BITS - 1) // LIMB_BITS
        mod_limbs = int_to_limbs(modulus, nl).astype(np.int32)
        hi = nl + 6
        fold = np.stack(
            [
                int_to_limbs(pow(2, LIMB_BITS * k, modulus), nl)
                for k in range(nl, 2 * nl + hi)
            ]
        ).astype(np.int32)
        shifts = np.stack(
            [
                int_to_limbs(modulus << k, nl + 2).astype(np.int32)
                for k in range(9, -1, -1)
            ]
        )
        return cls(
            modulus=modulus,
            nlimbs=nl,
            mod_limbs=mod_limbs,
            fold_table=fold,
            mod_shifts=shifts,
        )

    def to_device_limbs(self, values: list[int]) -> np.ndarray:
        return np.stack([int_to_limbs(v, self.nlimbs) for v in values])

    def from_device_limbs(self, arr) -> list[int]:
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().to("cpu").numpy()
        a = np.asarray(arr)
        return [limbs_to_int(row) for row in a.reshape(-1, a.shape[-1])]


@lru_cache(maxsize=8)
def _cached_ctx(modulus: int) -> ModContext:
    return ModContext.create(modulus)


@lru_cache(maxsize=16)
def _tables(modulus: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(fold table as float64, mod_shifts as int32) on `device`."""
    ctx = _cached_ctx(modulus)
    return (
        torch.as_tensor(ctx.fold_table.astype(np.float64), device=device),
        torch.as_tensor(ctx.mod_shifts, device=device),
    )


# ---------------------------------------------------------------- device ops


def _cond_sub(x: torch.Tensor, mod_limbs: torch.Tensor) -> torch.Tensor:
    """where(x >= m, x - m, x) over (…, L) limbs, the borrows resolved by
    prefix scan; the same limbs as the JAX package's sequential scan."""
    d = x - _pad_last(mod_limbs, x.shape[-1] - mod_limbs.shape[0])
    bout = _prefix_last((d < 0).to(I32), (d == 0).to(I32))
    sub = d - _shift_last(bout) + BASE * bout
    return torch.where((bout[..., -1:] == 0), sub, x)


def _fold(x: torch.Tensor, fold_table: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """One fold of limbs ≥ nlimbs through the 2^(7k) mod n table; returns
    (…, nlimbs+2) normalized limbs congruent mod n."""
    low, high = x[..., :nlimbs], x[..., nlimbs:]
    if high.shape[-1] == 0:
        return _normalize(_pad_last(x, 2))
    folded = (high.to(F64) @ fold_table[: high.shape[-1]]).to(I32)
    return _normalize(_pad_last(low + folded, 2))


def _fold_partial(x: torch.Tensor, fold_table: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """Normalized limbs of any length → (…, nlimbs+2) limbs of a value
    < 2^9·n congruent mod n (the partial form chained through a modexp)."""
    x = _fold(x, fold_table, nlimbs)
    for _ in range(3):
        x = _fold(x[..., : nlimbs + 2], fold_table, nlimbs)
    return x[..., : nlimbs + 2]


def _canonicalize(x: torch.Tensor, mod_shifts: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """Partial form → canonical < n: conditional subtraction of n·2^9 …
    n·2^0, plus one residual pass."""
    for k in range(mod_shifts.shape[0]):
        x = _cond_sub(x, mod_shifts[k])
    x = _cond_sub(x, mod_shifts[-1])
    return x[..., :nlimbs]


def _antidiagonal_sums(t: torch.Tensor) -> torch.Tensor:
    """(…, L, L) → (…, 2L-1): out[k] = Σ_{i+j=k} t[i, j] (the shear
    trick: rows padded to 2L, flattened, re-split at 2L-1, summed)."""
    length = t.shape[-1]
    flat = _pad_last(t, length).reshape(*t.shape[:-2], 2 * length * length)
    skew = flat[..., : length * (2 * length - 1)].reshape(
        *t.shape[:-2], length, 2 * length - 1
    )
    return skew.sum(dim=-2, dtype=I32)


def _modmul_partial(a, b, fold_table, nl: int) -> torch.Tensor:
    """Partial-form product of (…, ≤ nl+2) limbs; each anti-diagonal sums
    ≤ nl+2 products of limbs ≤ 128, inside int32."""
    t = a[..., :, None].to(I32) * b[..., None, :].to(I32)
    prod = _normalize(_pad_last(_antidiagonal_sums(t), 5))
    return _fold_partial(prod, fold_table, nl)


def make_modmul(ctx: ModContext):
    """(a, b) → a·b mod n over (…, nlimbs) int limb tensors, canonical."""
    nl = ctx.nlimbs

    def modmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        fold_table, mod_shifts = _tables(ctx.modulus, str(a.device))
        out = _modmul_partial(a, b, fold_table, nl)
        return _canonicalize(out, mod_shifts, nl)

    return modmul


def make_modexp_65537(ctx: ModContext):
    """s → s^65537 mod n over (…, nlimbs) int limb tensors: 16 squarings
    and one product in partial form, one canonicalization at the end."""
    nl = ctx.nlimbs

    def modexp(s: torch.Tensor) -> torch.Tensor:
        fold_table, mod_shifts = _tables(ctx.modulus, str(s.device))
        acc = _pad_last(s.to(I32), 2)
        base = acc
        for _ in range(16):
            acc = _modmul_partial(acc, acc, fold_table, nl)
        out = _modmul_partial(acc, base, fold_table, nl)
        return _canonicalize(out, mod_shifts, nl)

    return modexp


def lane_temp_bytes(nlimbs: int) -> int:
    """Temporaries one lane's product holds: the (L, L) outer product and
    its (L, 2L) sheared copy, int32, L = nlimbs + 2."""
    length = nlimbs + 2
    return 4 * 3 * length * length


# ---------------------------------------------------------------- host API


def modexp_65537_batch(signatures: list[int], modulus: int, device=None) -> list[int]:
    """Batched s^65537 mod n, on the card unless device="cpu" is passed;
    bit-identical to pow(s, 65537, n)."""
    dev = resolve_device(device)
    if not signatures:
        return []
    ctx = _cached_ctx(modulus)
    fn = make_modexp_65537(ctx)
    limbs = ctx.to_device_limbs(signatures)
    step = max(1, TEMP_BYTES // lane_temp_bytes(ctx.nlimbs))
    out = [
        fn(torch.as_tensor(limbs[o : o + step], device=dev)).cpu()
        for o in range(0, len(limbs), step)
    ]
    return ctx.from_device_limbs(torch.cat(out))
