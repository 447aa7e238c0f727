"""GLV-accelerated G1 folds (kernel K2) and the subgroup test.

φ(x, y) = (βx, y) acts as [λ] on the r-order subgroup (β a cube root of
unity in Fp, λ = z² − 1).  A scalar k < r splits by exact divmod into
k = k1 + k2·λ with both halves < 2^128, so [k]P needs a 64-step 2-bit
ladder over the 16-entry table {aP + bφ(P)}.  Because φ = [λ] only on the
subgroup, `clear=True` first clears the cofactor with the fixed [h_eff]
chain (63 doublings, 6 additions).

`glv_fold` is kernel K2 (csrc/glv.cu) on CUDA tensors and its plain
tensor twin `_glv_core` on CPU tensors; both follow the JAX package's
ops/glv.py step for step.  `subgroup_mask` runs the ladder kernel K3
with the scalar r broadcast over the lanes at bits = 255 (`bin(r)` has
255 bits) — the same function as the JAX package's `fixed_mul_bits`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from .bls12_381 import BLS_X, H_EFF_G1, P, R
from .g1 import (
    I32,
    L,
    LIMB_BITS,
    R_LIMBS,
    _check_points,
    _st,
    fp_to_limbs,
    infinity,
    mulm,
    pt_add,
    pt_double,
    scalar_mul_ladder,
)

# λ = z² − 1 (z = −BLS_X): the eigenvalue of φ on the r-order subgroup.
LAMBDA = (BLS_X * BLS_X - 1) % R
assert (LAMBDA * LAMBDA + LAMBDA + 1) % R == 0

K_BITS = 128  # both divmod halves fit 128 bits
K_LIMBS = -(-K_BITS // LIMB_BITS) + 1  # 11 limbs + 1 headroom
N_WINDOWS = K_BITS // 2  # 64 two-bit windows


@lru_cache(maxsize=1)
def beta() -> int:
    """The cube root of unity β with (βx, y) = [λ](x, y) on the subgroup,
    derived by testing both non-trivial roots against the generator."""
    b = pow(2, (P - 1) // 3, P)
    assert b != 1 and pow(b, 3, P) == 1
    from .bls12_381 import G1_GENERATOR

    lg = G1_GENERATOR.mul(LAMBDA)
    for cand in (b, b * b % P):
        if G1_GENERATOR.x * cand % P == lg.x and G1_GENERATOR.y == lg.y:
            return cand
    raise AssertionError("no cube root of unity matches lambda")


def decompose(k: int) -> tuple[int, int]:
    """k (mod r) → (k1, k2) with k ≡ k1 + k2·λ, both halves < 2^128."""
    k %= R
    k2, k1 = divmod(k, LAMBDA)
    return k1, k2


def decompose_to_limbs(scalars) -> tuple[np.ndarray, np.ndarray]:
    """Scalars → ((K_LIMBS, N), (K_LIMBS, N)) int32 base-4096 digits of
    the divmod halves, limb-major."""
    n = len(scalars)
    k1 = np.zeros((n, K_LIMBS), dtype=np.int32)
    k2 = np.zeros((n, K_LIMBS), dtype=np.int32)
    for j, s in enumerate(scalars):
        a, b = decompose(int(s))
        for i in range(K_LIMBS):
            k1[j, i] = a & 0xFFF
            k2[j, i] = b & 0xFFF
            a >>= LIMB_BITS
            b >>= LIMB_BITS
    return k1.T, k2.T


# ------------------------------------------------------------ chain parts


def fixed_mul_static(P3, k: int):
    """[k]P for a static k: for each bit after the leading one, double,
    and add P where the bit is set (the JAX package's run structure)."""
    if k == 0:
        return infinity(P3[0])
    acc = P3
    for bit in bin(k)[3:]:
        acc = pt_double(acc)
        if bit == "1":
            acc = pt_add(acc, P3)
    return acc


def _glv_table(P3, beta_c):
    """(TX, TY, TZ) each (16, 33, N): T[4b + a] = [a]Q + [b]φ(Q)."""
    inf = infinity(P3[0])
    q2 = pt_double(P3)
    q3 = pt_add(q2, P3)
    base = [inf, P3, q2, q3]
    bx = mulm(_st(P3[0], q2[0], q3[0]), beta_c.unsqueeze(1))
    phis = [inf] + [(bx[:, i], base[i + 1][1], base[i + 1][2]) for i in range(3)]
    # the nine mixed entries aP + bφP (a, b ≥ 1) in one stacked add
    ab = [(a, b) for b in range(1, 4) for a in range(1, 4)]
    mixed = pt_add(
        tuple(_st(*(base[a][c] for a, _ in ab)) for c in range(3)),
        tuple(_st(*(phis[b][c] for _, b in ab)) for c in range(3)),
    )
    rows = []
    for b in range(4):
        for a in range(4):
            if a == 0:
                rows.append(phis[b])
            elif b == 0:
                rows.append(base[a])
            else:
                j = ab.index((a, b))
                rows.append(tuple(m[:, j] for m in mixed))
    return tuple(torch.stack([r[c] for r in rows]) for c in range(3))


def _sel16(tx, ty, tz, idx):
    """Per-lane 4-bit table pick: (16, 33, N) tables, (N,) index."""
    g = idx.long().reshape(1, 1, -1).expand(1, L, idx.shape[-1])
    return tuple(t.gather(0, g)[0] for t in (tx, ty, tz))


def _window_digits(l1, l2, sh):
    d1 = (l1 >> sh) & 3
    d2 = (l2 >> sh) & 3
    return d1 + 4 * d2


def _glv_ladder(tx, ty, tz, read_window):
    """64-step MSB-first 2-bit ladder: acc = 4·acc + T[window]."""
    acc = infinity(tx[0])
    for i in range(N_WINDOWS):
        acc = pt_double(pt_double(acc))
        acc = pt_add(acc, _sel16(tx, ty, tz, read_window(i)))
    return acc


@lru_cache(maxsize=None)
def _beta_tensor(device: str) -> torch.Tensor:
    return torch.as_tensor(fp_to_limbs(beta()), device=device).reshape(L, 1)


def _glv_core(X, Y, Z, k1, k2, clear: bool):
    """Twin of kernel K2: optional cofactor clear → φ table → ladder.
    k1/k2 are (K_LIMBS, N) int32 digits."""
    pts = (X, Y, Z)
    if clear:
        pts = fixed_mul_static(pts, H_EFF_G1)
    tx, ty, tz = _glv_table(pts, _beta_tensor(str(X.device)))

    def read_window(i):
        b = 2 * (N_WINDOWS - 1) - 2 * i  # MSB-first bit position
        return _window_digits(
            k1[b // LIMB_BITS], k2[b // LIMB_BITS], b % LIMB_BITS
        )

    return _glv_ladder(tx, ty, tz, read_window)


def glv_fold(X, Y, Z, k1, k2, clear: bool = True):
    """Per-lane [k1 + k2·λ]([h_eff]P) (clear=True) or [k1 + k2·λ]P
    (clear=False, subgroup inputs).  Kernel K2 on CUDA tensors, the twin
    `_glv_core` on CPU tensors; (33, N) limbs in, projective triple out."""
    _check_points((X, Y, Z), k1, k2)
    if k1.shape != (K_LIMBS, X.shape[1]) or k2.shape != k1.shape:
        raise ValueError("k1/k2 must be (12, N)")
    if X.device.type == "cuda":
        out = _cuda.glv(X, Y, Z, k1, k2, clear)
        glv_fold.launches += 1
        return out
    if X.device.type != "cpu":
        raise RuntimeError(f"no K2 kernel for device {X.device}")
    return _glv_core(X, Y, Z, k1, k2, clear)


glv_fold.launches = 0


# ------------------------------------------------------------ subgroup


@lru_cache(maxsize=1)
def _r_bits_msb() -> np.ndarray:
    bits = bin(R)[2:]
    return np.asarray([int(b) for b in bits], dtype=np.int32).reshape(-1, 1)


@lru_cache(maxsize=None)
def _r_digits(device: str) -> torch.Tensor:
    """(22, 1) base-4096 digits of r, broadcast over lanes by callers."""
    return torch.as_tensor(fp_to_limbs(R, R_LIMBS), device=device).reshape(
        R_LIMBS, 1
    )


def r_scalars(n: int, device) -> torch.Tensor:
    return _r_digits(str(torch.device(device))).expand(R_LIMBS, n).contiguous()


def subgroup_mask(X, Y, Z) -> torch.Tensor:
    """(N,) int32: 1 where [r]P = ∞ (P in the r-order subgroup, or ∞) —
    [r]P through kernel K3 at bits = 255, then a canonical zero test."""
    from .h2c import _is_zero_mod_p

    n = X.shape[1]
    _, _, accZ = scalar_mul_ladder((X, Y, Z), r_scalars(n, X.device), bits=255)
    return _is_zero_mod_p(accZ).to(I32)
