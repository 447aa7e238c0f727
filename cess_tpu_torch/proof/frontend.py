"""Vectorized host front-end for the PoDR2 verify path (numpy only).

The fused verify pipeline (proof/fused.py) takes its inputs from this
batch form, a copy of the JAX package's proof/frontend.py bound to the
port's ops modules:

  * ONE proof.encode() pass per batch feeds the Fiat–Shamir transcript
    (ops/podr2.py batch_transcript(encodings=...)) AND the μ word/limb
    packing (numpy views over the concatenated encodings — the int→byte
    conversion happens exactly once per proof).
  * μ range validation (0 ≤ μ < r) is a vectorised lexicographic word
    compare; negative / ≥ 2^256 values surface as encode OverflowError.
    The reject set is exactly the scalar reference's.
  * ρ weights pack to 12-bit MSM digits and 7-bit fr limbs through the
    word-level codecs in ops/fr.py instead of per-limb loops.

Everything here is bit-identical to the scalar forms it replaces.
"""

from __future__ import annotations

import numpy as np

from ..ops import bls12_381 as bls
from ..ops import fr, g1
from ..ops.bls12_381 import R

MU_BYTES = 32

# little-endian uint32 words of r, for the vectorised range compare
_R_WORDS = np.frombuffer(R.to_bytes(MU_BYTES, "little"), dtype="<u4").copy()


def decompress_sigmas(items) -> list | None:
    """All σ blobs → points with the subgroup test DEFERRED (the caller
    runs one batched device [r]-chain — ops/glv.py subgroup_mask).
    Returns None when any blob is malformed: the scalar path raises
    ValueError there, which every combined check maps to the whole-batch
    False verdict (bisection then isolates the bad items)."""
    try:
        return bls.g1_decompress_batch(
            [p.sigma for _, _, p in items], check_subgroup=False
        )
    except ValueError:
        return None


def encode_proofs(items) -> list[bytes] | None:
    """One shared μ/σ encode pass (proof.encode() per item).  Returns
    None when any μ is negative or ≥ 2^256 — int.to_bytes raises
    OverflowError exactly there, and those values are a subset of what
    the scalar reference's 0 ≤ μ < r check rejects; the remaining
    out-of-range band [r, 2^256) is caught by mu_in_range on the packed
    words."""
    try:
        return [p.encode() for _, _, p in items]
    except OverflowError:
        return None


def mu_words(encodings: list[bytes], s: int) -> np.ndarray:
    """Concatenated proof encodings → (B, s, 8) uint32 little-endian μ
    words — a reinterpreting view, no per-scalar conversion."""
    buf = b"".join(e[48:] for e in encodings)
    return np.frombuffer(buf, dtype="<u4").reshape(len(encodings), s, 8)


def mu_in_range(words: np.ndarray) -> bool:
    """Vectorised 0 ≤ μ < r over packed words (strict lexicographic
    compare against r's words, most-significant first) — the word form
    of the scalar reference's per-μ range check."""
    lt = np.zeros(words.shape[:-1], dtype=bool)
    eq = np.ones(words.shape[:-1], dtype=bool)
    for k in range(words.shape[-1] - 1, -1, -1):
        wk = words[..., k]
        lt |= eq & (wk < _R_WORDS[k])
        eq &= wk == _R_WORDS[k]
    return bool(lt.all())


def mu_limbs(words: np.ndarray) -> np.ndarray:
    """(B, S, 8) μ words → (B, S, 37) int8 base-128 limbs (the fr codec
    shape the staged path and the mesh data plane consume)."""
    return fr.words_to_limbs(words, fr.LIMB_BITS, fr.NLIMBS, np.int8)


def rho_words(rhos: list[int]) -> np.ndarray:
    """128-bit ρ weights → (B, 4) uint32 words."""
    return fr.ints_to_words(rhos, 16)


def rho_digits(rhos: list[int]) -> np.ndarray:
    """ρ → (22, B) int32 base-4096 ladder digits (ops/g1.py scalar
    shape, limb-major)."""
    return fr.words_to_limbs(
        rho_words(rhos), g1.LIMB_BITS, g1.R_LIMBS, np.int32
    ).T


def rho_limbs7(rhos: list[int], width: int = 19) -> np.ndarray:
    """ρ → (B, width) int8 base-128 limbs (ops/fr.py weight shape)."""
    return fr.words_to_limbs(rho_words(rhos), fr.LIMB_BITS, width, np.int8)
