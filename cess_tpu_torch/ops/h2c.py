"""Batched SSWU hash-to-curve in PyTorch — the verifier's random oracle,
kernels K1 (the pair map) and K4 (the t^((p−3)/4) chain).

Host (`u_for_pairs`): expand_message_xmd + hash_to_field in the native
host library (native/blsmap.cpp through the port's native.py, threaded
with the GIL released), emitting per message two canonical field
elements u0, u1 and two predicate bits each (sgn0(u),
SSWU-exceptional(u)); `_u_host_fallback` is the pure-Python path.
Device (`_map_pairs_kernel`): two straight-line simplified-SWU maps onto
the 11-isogenous curve E′ (RFC 9380 F.2), one complete E′ addition and
the 11-isogeny back to E.  The output is the UNCLEARED point on E(Fp);
callers fold h_eff into their scalars or clear it in the GLV kernel.

Each function mirrors the JAX package's ops/h2c.py and keeps its limb
layout.  On CUDA tensors `_map_pairs_kernel` runs csrc/map.cu around a
launch of `_pow_c1` (csrc/powc1.cu); on CPU tensors the plain tensor
twins `_map_pairs_core` / `_pow_c1_plain` run.  The predicates the
straight-line form needs (is-square, sgn0, Z = 0) use canonical digits
from `_canon_mod_p`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import native
from . import _cuda, _sswu_g1
from .bls12_381 import H_EFF_G1, P
from .g1 import (
    BASE,
    I32,
    L,
    LIMB_BITS,
    _dev,
    _prefix_or_and,
    _select,
    _shift_up,
    _st,
    addm,
    be48_to_limb_rows,
    fp_to_limbs,
    limb_one,
    mulm,
    smallmul,
    subm,
)

H_EFF = H_EFF_G1

# ------------------------------------------------------------- constants

# Registry of the full-width Fp constants the map uses, in registration
# order (the JAX package packs the same table into its map kernel).
_CONST_VALUES: list[int] = []
_CONST_INDEX: dict[int, int] = {}


def _register_const(x: int) -> int:
    x %= P
    if x not in _CONST_INDEX:
        _CONST_INDEX[x] = len(_CONST_VALUES)
        _CONST_VALUES.append(x)
    return _CONST_INDEX[x]


@lru_cache(maxsize=None)
def _const_tensor(x: int, device: str) -> torch.Tensor:
    _register_const(x)
    return torch.as_tensor(fp_to_limbs(x % P), device=device)


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    """Full-width Fp constant, broadcastable over `like`'s batch shape."""
    c = _const_tensor(x, _dev(like))
    return c.reshape((L,) + (1,) * (like.dim() - 1))


@lru_cache(maxsize=None)
def _const_table(n_consts: int) -> np.ndarray:
    """(n_consts, 33) limb rows of the registered constants, in
    registration order."""
    out = np.zeros((n_consts, L), dtype=np.int32)
    for i, v in enumerate(_CONST_VALUES[:n_consts]):
        out[i] = fp_to_limbs(v)
    return out


def _fp_sqrt_exact(x: int) -> int:
    r = pow(x % P, (P + 1) // 4, P)
    if r * r % P != x % P:
        raise ValueError("constant is not a quadratic residue")
    return r


A_PRIME = _sswu_g1.A_PRIME
B_PRIME = _sswu_g1.B_PRIME
Z_SSWU = _sswu_g1.Z_SSWU  # 11 — small enough for smallmul
B3_PRIME = 3 * B_PRIME % P
# c2 = sqrt(−Z): the non-square branch's y = Zu³·c2·y1 squares to gx2.
C2 = _fp_sqrt_exact(-Z_SSWU % P)

# 4-bit MSB-first digits of c1 = (p-3)/4 for the fixed-window chain.
_C1 = (P - 3) // 4
_C1_DIGITS = tuple(
    (_C1 >> (4 * k)) & 0xF for k in range((_C1.bit_length() + 3) // 4)
)[::-1]


@lru_cache(maxsize=None)
def _kp_digits() -> np.ndarray:
    """(14, 33) exact base-4096 digits of k·p for k = 2^13 … 2^0."""
    out = np.zeros((14, L), dtype=np.int32)
    for row, sh in enumerate(range(13, -1, -1)):
        out[row] = fp_to_limbs((1 << sh) * P)
    return out


@lru_cache(maxsize=None)
def _kp_tensor(device: str) -> torch.Tensor:
    return torch.as_tensor(_kp_digits(), device=device)


def _ensure_const_registry() -> int:
    for v in (A_PRIME, B_PRIME, B3_PRIME, C2):
        _register_const(v)
    for lst in (
        _sswu_g1.X_NUM, _sswu_g1.X_DEN, _sswu_g1.Y_NUM, _sswu_g1.Y_DEN
    ):
        for c in lst:
            _register_const(c)
    return len(_CONST_VALUES)


# ------------------------------------------------- canonical predicates


def _canon_mod_p(x: torch.Tensor) -> torch.Tensor:
    """Loose (33, …) limbs → EXACT canonical base-4096 digits of x mod p:
    one carry resolution by prefix scan, then 14 binary compare-subtract
    rounds against 2^k·p (the JAX package's `_canon_mod_p`)."""
    e = x & (BASE - 1)
    a = e + _shift_up(x >> LIMB_BITS)  # ≤ 4096
    g = (a >= BASE).to(I32)
    pr = (a == BASE - 1).to(I32)
    f = (a + _shift_up(_prefix_or_and(g, pr))) & (BASE - 1)

    kp = _kp_tensor(_dev(x))
    for row in range(14):
        t = f - kp[row].reshape((L,) + (1,) * (x.dim() - 1))
        scan = _prefix_or_and((t < 0).to(I32), (t == 0).to(I32))
        s = (t - _shift_up(scan)) & (BASE - 1)
        f = torch.where((scan[-1] == 0).unsqueeze(0), s, f)
    return f


def _parity_mod_p(x: torch.Tensor) -> torch.Tensor:
    """sgn0 of a loose value: parity of the canonical residue, (…) int32."""
    return _canon_mod_p(x)[0] & 1


def _is_zero_mod_p(x: torch.Tensor) -> torch.Tensor:
    return (_canon_mod_p(x) == 0).all(dim=0)


def _eq_mod_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _is_zero_mod_p(subm(a, b))


# ------------------------------------------------------- K4: pow chain


def _pow_c1_plain(t: torch.Tensor) -> torch.Tensor:
    """Twin of kernel K4: t^((p−3)/4) by the 4-bit fixed-window chain —
    table t^0…t^15, then per digit four squarings and one table
    multiply (≈ 484 muls; the JAX package's `_pow_c1_xla`)."""
    pre = [limb_one(t), t]
    for _ in range(14):
        pre.append(mulm(pre[-1], t))
    table = torch.stack(pre)  # (16, 33, …)
    acc = table[_C1_DIGITS[0]]
    for d in _C1_DIGITS[1:]:
        for _ in range(4):
            acc = mulm(acc, acc)
        acc = mulm(acc, table[d])
    return acc


def _pow_c1(t: torch.Tensor) -> torch.Tensor:
    """Kernel K4 (csrc/powc1.cu) on CUDA tensors, `_pow_c1_plain` on CPU
    tensors.  (33, N) loose limbs in, (33, N) limbs out."""
    if t.dtype != I32 or t.dim() != 2 or t.shape[0] != L:
        raise ValueError("expected (33, N) int32 limbs")
    if t.device.type == "cuda":
        out = _cuda.pow_c1(t)
        _pow_c1.launches += 1
        return out
    if t.device.type != "cpu":
        raise RuntimeError(f"no K4 kernel for device {t.device}")
    return _pow_c1_plain(t)


_pow_c1.launches = 0


# ------------------------------------------------------------- SSWU map


def _sqrt_ratio(u: torch.Tensor, v: torch.Tensor):
    """RFC 9380 F.2.1.2 sqrt_ratio_3mod4 → (isQR (…) bool, y (33, …))."""
    m = mulm(_st(v, u), _st(v, v))
    tv2 = m[:, 1]  # u·v
    tv1 = mulm(m[:, 0], tv2)  # u·v³
    y1 = mulm(_pow_c1_plain(tv1), tv2)
    m = mulm(_st(y1, y1), _st(_const(C2, y1), y1))
    y2 = m[:, 0]
    tv3 = mulm(m[:, 1], v)
    is_qr = _eq_mod_p(tv3, u)
    return is_qr, _select(is_qr, y1, y2)


def _sswu_map(u: torch.Tensor, sgn_u: torch.Tensor, exc: torch.Tensor):
    """Straight-line simplified SWU onto E′ (RFC 9380 F.2): u (33, …)
    loose limbs, sgn_u/exc (…) int32 host predicate bits → projective
    (xn : y·xd : xd) on E′."""
    zero = torch.zeros_like(u)
    one = limb_one(u)
    a_c = _const(A_PRIME, u)
    b_c = _const(B_PRIME, u)

    tv1 = smallmul(mulm(u, u), Z_SSWU)  # Z·u²
    tv2 = addm(mulm(tv1, tv1), tv1)  # Z²u⁴ + Zu²
    tv3 = mulm(addm(tv2, one), b_c)  # B(tv2 + 1)
    z_c = torch.zeros_like(u)
    z_c[0] = Z_SSWU
    tv4 = _select(exc == 1, z_c, subm(zero, tv2))  # CMOV(Z, −tv2, tv2≠0)
    tv4 = mulm(tv4, a_c)
    m = mulm(_st(tv3, tv4), _st(tv3, tv4))
    t2, tv6 = m[:, 0], m[:, 1]
    tv5 = mulm(tv6, a_c)
    m = mulm(_st(addm(t2, tv5), tv6), _st(tv3, tv4))
    t2, tv6 = m[:, 0], m[:, 1]  # tv6 = tv4³
    tv5 = mulm(tv6, b_c)
    t2 = addm(t2, tv5)  # g(x1)·tv4³ numerator
    m = mulm(_st(tv1, tv1), _st(tv3, u))
    x, tu = m[:, 0], m[:, 1]
    is_qr, y1 = _sqrt_ratio(t2, tv6)
    y = mulm(tu, y1)
    x = _select(is_qr, tv3, x)
    y = _select(is_qr, y1, y)
    e1 = sgn_u == _parity_mod_p(y)
    y = _select(e1, y, subm(zero, y))
    return x, mulm(y, tv4), tv4


# --------------------------------------------------- E′ complete addition


def _pt_add_aprime(p, q):
    """Complete projective addition on E′ (a = A′ ≠ 0): RCB 2016 Alg. 1."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    a_c = _const(A_PRIME, X1)
    b3_c = _const(B3_PRIME, X1)
    s = addm(_st(X1, X1, Y1, X2, X2, Y2), _st(Y1, Z1, Z1, Y2, Z2, Z2))
    m = mulm(
        _st(X1, Y1, Z1, s[:, 0], s[:, 1], s[:, 2]),
        _st(X2, Y2, Z2, s[:, 3], s[:, 4], s[:, 5]),
    )
    t0, t1, t2 = m[:, 0], m[:, 1], m[:, 2]
    d = subm(m[:, 3:6], addm(_st(t0, t0, t1), _st(t1, t2, t2)))
    t3, t4, t5 = d[:, 0], d[:, 1], d[:, 2]
    m = mulm(_st(t4, t2), _st(a_c, b3_c))
    Z3, X3 = m[:, 0], m[:, 1]  # a·T4, 3b·T2
    Z3 = addm(X3, Z3)  # aT4 + 3bT2
    X3 = subm(t1, Z3)
    Z3 = addm(t1, Z3)
    Y3 = mulm(X3, Z3)
    t1 = addm(addm(t0, t0), t0)  # 3X1X2
    m = mulm(_st(t2, t4), _st(a_c, b3_c))
    t2, t4 = m[:, 0], m[:, 1]
    t1 = addm(t1, t2)  # 3X1X2 + aZ1Z2
    t2 = subm(t0, t2)  # X1X2 − aZ1Z2
    t2 = mulm(t2, a_c)
    t4 = addm(t4, t2)  # 3bT4 + a(X1X2 − aZ1Z2)
    m = mulm(_st(t1, t5, t3, t3, t5), _st(t4, t4, X3, t1, Z3))
    Y3 = addm(Y3, m[:, 0])
    X3 = subm(m[:, 2], m[:, 1])
    Z3 = addm(m[:, 4], m[:, 3])
    return X3, Y3, Z3


# ------------------------------------------------------------- isogeny


def _iso_eval(X, Y, Z):
    """11-isogeny E′ → E on a projective batch: homogenised Horner over
    the coefficient tables (ops/_sswu_g1.py).  x′ = XN/(Z·XD),
    y′ = (Y/Z)·YN/YD; Z ≡ 0 (isogeny kernel, or an input at infinity)
    gives exactly (0 : 1 : 0).  The four Horner chains advance stacked:
    chain k takes its step at coefficient index i once i ≤ deg_k − 2,
    the same per-chain sequence as the JAX package."""
    max_deg = 15
    zpow = [None, Z]
    for _ in range(max_deg - 1):
        zpow.append(mulm(zpow[-1], Z))
    polys = (_sswu_g1.X_NUM, _sswu_g1.X_DEN, _sswu_g1.Y_NUM, _sswu_g1.Y_DEN)
    degs = [len(c) - 1 for c in polys]

    def consts(vals):
        return _st(*(_const(v, X) for v in vals))

    # acc = k_deg·X + k_{deg-1}·Z for every chain
    m = mulm(
        _st(*([X] * 4 + [Z] * 4)),
        consts([c[d] for c, d in zip(polys, degs)]
               + [c[d - 1] for c, d in zip(polys, degs)]),
    )
    out = addm(m[:, :4], m[:, 4:])
    acc = [out[:, k] for k in range(4)]
    for i in range(max(degs) - 2, -1, -1):
        live = [k for k in range(4) if i <= degs[k] - 2]
        m = mulm(
            _st(_st(*(acc[k] for k in live)),
                _st(*(zpow[degs[k] - i] for k in live))),
            _st(X.unsqueeze(1), consts([polys[k][i] for k in live])),
        )
        out = addm(m[:, 0], m[:, 1])  # acc·X + Z^(deg−i)·k_i
        for j, k in enumerate(live):
            acc[k] = out[:, j]
    xn, xd, yn, yd = acc
    m = mulm(_st(xn, Y, Z), _st(yd, yn, xd))
    m2 = mulm(_st(m[:, 1], m[:, 2]), _st(xd, yd))
    XE, YE, ZE = m[:, 0], m2[:, 0], m2[:, 1]
    inf = _is_zero_mod_p(ZE)
    zero = torch.zeros_like(XE)
    return (
        _select(inf, zero, XE),
        _select(inf, limb_one(XE), YE),
        _select(inf, zero, ZE),
    )


# ------------------------------------------------------------- K1: map


def _map_pairs_core(u, sgn, exc):
    """Twin of kernel K1.  u: (33, 2, N) loose limbs (u0 row 0, u1 row 1);
    sgn/exc: (2, N) int32 → uncleared (X, Y, Z) (33, N) on E: map both
    elements, add on E′, apply the isogeny once."""
    x, y, z = _sswu_map(u, sgn, exc)
    p0 = (x[:, 0], y[:, 0], z[:, 0])
    p1 = (x[:, 1], y[:, 1], z[:, 1])
    return _iso_eval(*_pt_add_aprime(p0, p1))


def _map_pairs_kernel(u, sgn, exc):
    """Kernel K1 (csrc/map.cu, with K4 for the two square-root chains) on
    CUDA tensors, `_map_pairs_core` on CPU tensors."""
    if u.dtype != I32 or u.dim() != 3 or u.shape[:2] != (L, 2):
        raise ValueError("expected (33, 2, N) int32 limbs")
    if sgn.shape != (2, u.shape[2]) or exc.shape != sgn.shape:
        raise ValueError("sgn/exc must be (2, N)")
    if u.device.type == "cuda":
        out = _cuda.map_pairs(u, sgn.to(I32), exc.to(I32), _pow_c1)
        _map_pairs_kernel.launches += 1
        return out
    if u.device.type != "cpu":
        raise RuntimeError(f"no K1 kernel for device {u.device}")
    return _map_pairs_core(u, sgn, exc)


_map_pairs_kernel.launches = 0


# ------------------------------------------------------------- host API


def u_bytes_to_limbs(u_be: np.ndarray) -> np.ndarray:
    """(…, 48) big-endian canonical bytes → (33, …) int32 limbs."""
    return np.moveaxis(be48_to_limb_rows(u_be), -1, 0)


def _u_host_fallback(names, name_ids, indices, dst):
    """Pure-Python XMD path: (u (N, 2, 48) uint8 big-endian, flags (N,)
    uint8 with bit 2e = sgn0(u_e) and bit 2e+1 = exceptional(u_e))."""
    from . import bls12_381 as bls

    n = len(name_ids)
    u = np.zeros((n, 2, 48), dtype=np.uint8)
    flags = np.zeros(n, dtype=np.uint8)
    neg_inv_z = -pow(Z_SSWU, P - 2, P) % P
    for row, (k, idx) in enumerate(zip(name_ids, indices)):
        msg = names[int(k)] + b"/" + int(idx).to_bytes(8, "little")
        u0, u1 = bls.hash_to_field_fp(msg, dst, 2)
        f = 0
        for e, uu in enumerate((u0, u1)):
            u[row, e] = np.frombuffer(uu.to_bytes(48, "big"), dtype=np.uint8)
            if uu & 1:
                f |= 1 << (2 * e)
            if uu == 0 or uu * uu % P == neg_inv_z:
                f |= 1 << (2 * e + 1)
        flags[row] = f
    return u, flags


def xmd_u(names: list[bytes], name_ids, indices, dst: bytes,
          threads: int = 8):
    """(u, flags) as `_u_host_fallback` gives them, through the native
    XMD batch on `threads` threads.  A name or DST longer than the native
    framing takes goes the pure-Python way, as in the JAX package; a
    failed build or load of the native library raises."""
    if len(dst) > native.MAX_DST or any(len(n) > native.MAX_NAME for n in names):
        return _u_host_fallback(names, name_ids, indices, dst)
    return native.xmd_u_indexed(names, name_ids, indices, dst, threads=threads)


def u_for_pairs(names: list[bytes], name_ids, indices, dst: bytes,
                threads: int = 8):
    """Host front half: (u_limbs (33, 2, N), sgn (2, N), exc (2, N))
    numpy arrays for the map, via the native XMD batch (`xmd_u`)."""
    name_ids = np.ascontiguousarray(name_ids, dtype=np.uint32)
    indices = np.ascontiguousarray(indices, dtype=np.uint64)
    u, flags = xmd_u(names, name_ids, indices, dst, threads)
    u_limbs = np.swapaxes(u_bytes_to_limbs(u), 1, 2)  # (33, 2, N)
    f = flags.astype(np.int32)
    sgn = np.stack([f & 1, (f >> 2) & 1])
    exc = np.stack([(f >> 1) & 1, (f >> 3) & 1])
    return u_limbs, sgn, exc


def hash_pairs_device(names, name_ids, indices, dst: bytes, device="cuda"):
    """(name, index) pairs → UNCLEARED hash points (X, Y, Z) (33, N)
    tensors on `device`, plus the true count (lanes are padded to a power
    of two with u = 0, which maps like any other input)."""
    n = len(name_ids)
    u_limbs, sgn, exc = u_for_pairs(names, name_ids, indices, dst)
    m = 1 << max(0, (n - 1).bit_length())
    if m != n:
        u_limbs, sgn, exc = (
            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, m - n)])
            for a in (u_limbs, sgn, exc)
        )
    t = [torch.as_tensor(a, device=device) for a in (u_limbs, sgn, exc)]
    return _map_pairs_kernel(*t), n


def hash_pairs_host_points(names, name_ids, indices, dst: bytes, device="cuda"):
    """Cleared host G1Points via the device map ([h_eff]·map result)."""
    from . import g1 as g1mod

    (X, Y, Z), n = hash_pairs_device(names, name_ids, indices, dst, device)
    pts = g1mod.projective_to_points(X.T[:n], Y.T[:n], Z.T[:n])
    return [p._mul_raw(H_EFF) if not p.is_infinity() else p for p in pts]
