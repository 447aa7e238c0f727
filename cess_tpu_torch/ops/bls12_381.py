"""BLS12-381: fields, curves, pairing, signatures — host reference.

This is the framework's bit-exactness anchor for everything BLS: the batched
device code (ops/g1.py, ops/fr.py) and the PoDR2 verifier (ops/podr2.py) are
tested against this module, which re-expresses the capability of the
reference's `verify-bls-signatures` crate (reference:
utils/verify-bls-signatures/src/lib.rs — IC-style BLS: 48-byte G1
signatures, 96-byte G2 public keys, pairing check via multi-Miller-loop +
final exponentiation, lib.rs:85-100) and of `cp-enclave-verify`'s
`verify_bls` (reference: primitives/enclave-verify/src/lib.rs:230-235).

Everything here is standard, publicly specified mathematics implemented from
the curve definition:

  parameter     x  = -0xd201000000010000
  base field    p  = (x-1)^2 (x^4 - x^2 + 1)/3 + x      (381 bits)
  scalar field  r  = x^4 - x^2 + 1                      (255 bits)
  E : y^2 = x^3 + 4    over Fp        (G1)
  E': y^2 = x^3 + 4(u+1) over Fp2     (G2, M-twist)
  tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3-(u+1)); Fp12 = Fp6[w]/(w^2-v)

The module self-checks p and r against the x-parameter identities at import.

Hash-to-G1 is the full RFC 9380 suite `BLS_SIG_BLS12381G1_XMD:SHA-256_
SSWU_RO_NUL_`: expand_message_xmd, simplified SWU onto the 11-isogenous
curve, the 11-isogeny back to E (coefficients DERIVED by
tools/derive_sswu.py, carried in ops/_sswu_g1.py), and h_eff cofactor
clearing.  Interop with the reference's IC vectors is asserted verbatim in
tests/test_bls12_381.py::TestReferenceKATs.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

# ---------------------------------------------------------------- parameters

BLS_X = 0xD201000000010000  # |x|; the BLS parameter itself is -BLS_X
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Self-check the remembered constants against the defining identities.
_x = -BLS_X
assert R == _x**4 - _x**2 + 1, "r must equal x^4 - x^2 + 1"
assert P == (_x - 1) ** 2 * (_x**4 - _x**2 + 1) // 3 + _x, "p identity"
assert P % 4 == 3

# Effective G1 cofactor for hash-to-curve: h_eff = 1 - z (RFC 9380
# §8.8.1).  The FULL cofactor is (z-1)^2/3; both clear the cofactor but
# differ by a scalar on the r-torsion — the IC vectors pin h_eff.
H_EFF_G1 = 1 - (-BLS_X)  # 1 − z with z = −BLS_X
assert H_EFF_G1 == 0xD201000000010001
DST_G1 = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"


# ---------------------------------------------------------------- Fp

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """p ≡ 3 (mod 4) ⇒ sqrt = a^((p+1)/4) when it exists."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


# ---------------------------------------------------------------- Fp2

class Fq2:
    """c0 + c1·u with u^2 = -1."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int = 0) -> None:
        self.c0 = c0 % P
        self.c1 = c1 % P

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fq2":
        if isinstance(o, int):
            return Fq2(self.c0 * o, self.c1 * o)
        # Karatsuba: (a0+a1u)(b0+b1u) = a0b0 - a1b1 + ((a0+a1)(b0+b1)-a0b0-a1b1)u
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self) -> "Fq2":
        # (a0+a1u)^2 = (a0+a1)(a0-a1) + 2a0a1 u
        t = self.c0 * self.c1
        return Fq2((self.c0 + self.c1) * (self.c0 - self.c1), 2 * t)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inv(self) -> "Fq2":
        # 1/(a0+a1u) = (a0-a1u)/(a0^2+a1^2)
        norm = self.c0 * self.c0 + self.c1 * self.c1
        ninv = fp_inv(norm)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def pow(self, e: int) -> "Fq2":
        result, base = FQ2_ONE, self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fq2 | None":
        """Tonelli–Shanks in Fp2 (q = p^2, q-1 = 2^s·t)."""
        if self.is_zero():
            return FQ2_ZERO
        q1 = P * P - 1
        s = (q1 & -q1).bit_length() - 1
        t = q1 >> s
        # Deterministic non-residue search.
        z = None
        for cand in _FQ2_NONRESIDUE_CANDIDATES:
            if cand.pow(q1 // 2) == FQ2_MINUS_ONE:
                z = cand
                break
        assert z is not None
        m = s
        c = z.pow(t)
        r_ = self.pow((t + 1) // 2)
        t_ = self.pow(t)
        while t_ != FQ2_ONE:
            # find least i with t^(2^i) == 1
            i, t2 = 0, t_
            while t2 != FQ2_ONE:
                t2 = t2.square()
                i += 1
                if i == m:
                    return None  # not a square
            b = c
            for _ in range(m - i - 1):
                b = b.square()
            m = i
            c = b.square()
            t_ = t_ * c
            r_ = r_ * b
        return r_ if r_.square() == self else None

    def sgn0(self) -> int:
        """RFC 9380 sign: lexicographic over (c0, c1)."""
        if self.c0 != 0:
            return self.c0 & 1
        return self.c1 & 1

    def __repr__(self) -> str:  # pragma: no cover
        return f"Fq2({hex(self.c0)}, {hex(self.c1)})"


FQ2_ZERO = Fq2(0)
FQ2_ONE = Fq2(1)
FQ2_MINUS_ONE = Fq2(P - 1)
XI = Fq2(1, 1)  # ξ = u + 1, the sextic-twist constant
_FQ2_NONRESIDUE_CANDIDATES = [Fq2(1, 1), Fq2(2, 1), Fq2(1, 2), Fq2(3, 1), Fq2(2, 3)]


# ---------------------------------------------------------------- Fp6 / Fp12

class Fq6:
    """c0 + c1·v + c2·v^2 with v^3 = ξ."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2) -> None:
        self.c0, self.c1, self.c2 = c0, c1, c2

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o) -> "Fq6":
        if isinstance(o, (int, Fq2)):
            return Fq6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        return Fq6(
            t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI,
            (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI,
            (a0 + a2) * (b0 + b2) - t0 - t2 + t1,
        )

    __rmul__ = __mul__

    def square(self) -> "Fq6":
        return self * self

    def mul_by_v(self) -> "Fq6":
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inv(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - a1 * a2 * XI
        t1 = a2.square() * XI - a0 * a1
        t2 = a1.square() - a0 * a2
        norm = a0 * t0 + (a2 * t1 + a1 * t2) * XI
        ninv = norm.inv()
        return Fq6(t0 * ninv, t1 * ninv, t2 * ninv)

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


class Fq12:
    """c0 + c1·w with w^2 = v."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6) -> None:
        self.c0, self.c1 = c0, c1

    @classmethod
    def from_fq2(cls, a: Fq2) -> "Fq12":
        return cls(Fq6(a, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)

    @classmethod
    def from_int(cls, a: int) -> "Fq12":
        return cls.from_fq2(Fq2(a))

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def __add__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq12") -> "Fq12":
        return Fq12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq12":
        return Fq12(-self.c0, -self.c1)

    def __mul__(self, o) -> "Fq12":
        if isinstance(o, (int, Fq2)):
            return Fq12(self.c0 * o, self.c1 * o)
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq12(t0 + t1.mul_by_v(), t2 - t0 - t1)

    __rmul__ = __mul__

    def square(self) -> "Fq12":
        # complex squaring: 2 Fq6 muls instead of the generic mul's 3 —
        # the final exponentiation is square-dominated, so this is the
        # single highest-leverage pairing op
        t0 = self.c0 * self.c1
        return Fq12(
            (self.c0 + self.c1) * (self.c0 + self.c1.mul_by_v())
            - t0 - t0.mul_by_v(),
            t0 + t0,
        )

    def conjugate(self) -> "Fq12":
        """The p^6-Frobenius: c0 - c1·w."""
        return Fq12(self.c0, -self.c1)

    def inv(self) -> "Fq12":
        norm = self.c0.square() - self.c1.square().mul_by_v()
        ninv = norm.inv()
        return Fq12(self.c0 * ninv, -(self.c1 * ninv))

    def pow(self, e: int) -> "Fq12":
        """4-bit fixed-window exponentiation: the ~2000-bit final-exp
        exponent costs ~n squares + n/4 muls instead of n + n/2."""
        if e < 0:
            return self.inv().pow(-e)
        if e == 0:
            return FQ12_ONE
        table = [FQ12_ONE, self]
        for _ in range(14):
            table.append(table[-1] * self)
        digits = []
        while e:
            digits.append(e & 15)
            e >>= 4
        result = table[digits[-1]]
        for d in reversed(digits[:-1]):
            result = result.square().square().square().square()
            if d:
                result = result * table[d]
        return result

    def is_one(self) -> bool:
        return self == FQ12_ONE


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)
# w as an Fq12 element: coefficient 1 on the w term.
FQ12_W = Fq12(FQ6_ZERO, FQ6_ONE)


# ---------------------------------------------------------------- curves

def _jac_double_fp(x: int, y: int, z: int) -> tuple[int, int, int]:
    """Jacobian doubling on y^2 = x^3 + b over Fp (a = 0)."""
    if z == 0 or y == 0:
        return 0, 1, 0
    a = x * x % P
    b = y * y % P
    c = b * b % P
    t = x + b
    d = 2 * (t * t - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return x3, y3, z3


def _jac_add_fp(
    x1: int, y1: int, z1: int, x2: int, y2: int, z2: int
) -> tuple[int, int, int]:
    if z1 == 0:
        return x2, y2, z2
    if z2 == 0:
        return x1, y1, z1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return 0, 1, 0
        return _jac_double_fp(x1, y1, z1)
    h = (u2 - u1) % P
    i = (2 * h) ** 2 % P
    j = h * i % P
    r_ = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r_ * r_ - j - 2 * v) % P
    y3 = (r_ * (v - x3) - 2 * s1 * j) % P
    z3 = 2 * z1 * z2 % P * h % P
    return x3, y3, z3

class G1Point:
    """Affine point on E: y^2 = x^3 + 4 (None coords = infinity)."""

    __slots__ = ("x", "y")
    B = 4

    def __init__(self, x: int | None, y: int | None) -> None:
        self.x, self.y = x, y

    @classmethod
    def infinity(cls) -> "G1Point":
        return cls(None, None)

    def is_infinity(self) -> bool:
        return self.x is None

    def __eq__(self, o) -> bool:
        return isinstance(o, G1Point) and self.x == o.x and self.y == o.y

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        return (self.y * self.y - self.x**3 - self.B) % P == 0

    def __neg__(self) -> "G1Point":
        if self.is_infinity():
            return self
        return G1Point(self.x, (-self.y) % P)

    def __add__(self, o: "G1Point") -> "G1Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        if self.x == o.x:
            if (self.y + o.y) % P == 0:
                return G1Point.infinity()
            # doubling
            lam = 3 * self.x * self.x * fp_inv(2 * self.y) % P
        else:
            lam = (o.y - self.y) * fp_inv((o.x - self.x) % P) % P
        x3 = (lam * lam - self.x - o.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return G1Point(x3, y3)

    def mul(self, k: int) -> "G1Point":
        """Scalar mult in Jacobian coordinates (one inversion total)."""
        k %= R
        return self._mul_raw(k)

    def _mul_raw(self, k: int) -> "G1Point":
        if k == 0 or self.is_infinity():
            return G1Point.infinity()
        # Jacobian (X, Y, Z): x = X/Z^2, y = Y/Z^3; a = 0 curve.
        rx, ry, rz = 0, 1, 0  # infinity
        bx, by, bz = self.x, self.y, 1
        while k:
            if k & 1:
                rx, ry, rz = _jac_add_fp(rx, ry, rz, bx, by, bz)
            bx, by, bz = _jac_double_fp(bx, by, bz)
            k >>= 1
        if rz == 0:
            return G1Point.infinity()
        zinv = fp_inv(rz)
        z2 = zinv * zinv % P
        return G1Point(rx * z2 % P, ry * z2 % P * zinv % P)

    def in_subgroup(self) -> bool:
        return self.is_on_curve() and self._mul_raw(R).is_infinity()

    # -- zkcrypto-compatible compressed serialization (48 bytes) --------

    def to_bytes(self) -> bytes:
        if self.is_infinity():
            out = bytearray(48)
            out[0] = 0xC0
            return bytes(out)
        out = bytearray(self.x.to_bytes(48, "big"))
        out[0] |= 0x80  # compression flag
        if self.y > P - self.y:  # lexicographically largest root
            out[0] |= 0x20
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "G1Point":
        if len(data) != 48:
            raise ValueError("G1 compressed point must be 48 bytes")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 encoding unsupported")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("invalid infinity encoding")
            return cls.infinity()
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        y = fp_sqrt((x**3 + cls.B) % P)
        if y is None:
            raise ValueError("point not on curve")
        y_is_large = y > P - y
        if bool(flags & 0x20) != y_is_large:
            y = P - y
        point = cls(x, y)
        if not point.in_subgroup():
            raise ValueError("point not in G1 subgroup")
        return point

    def __repr__(self) -> str:  # pragma: no cover
        return "G1(inf)" if self.is_infinity() else f"G1({hex(self.x)},..)"


def g1_decompress_unchecked(data: bytes) -> G1Point:
    """Compressed G1 → point with encoding + on-curve validation but the
    subgroup membership test DEFERRED (the fused verify pipeline runs it
    as a batched device [r]-chain — ops/glv.py subgroup_mask — instead
    of a per-point host ladder).  Raises ValueError for exactly the
    encodings G1Point.from_bytes rejects before its subgroup test."""
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding unsupported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("invalid infinity encoding")
        return G1Point.infinity()
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("x out of range")
    y = fp_sqrt((x**3 + G1Point.B) % P)
    if y is None:
        raise ValueError("point not on curve")
    if bool(flags & 0x20) != (y > P - y):
        y = P - y
    return G1Point(x, y)


# ---------------------------------------------------- batched decompression
#
# One G1Point.from_bytes costs one fp_sqrt — a (p+1)/4 exponentiation,
# ~0.3 ms per σ — plus a ~3 ms host Python subgroup ladder.  At
# batch-verify scale that is the classic per-proof host residue.  Two
# facts shape the batch form:
#
#  * Square roots do not batch: Montgomery's trick turns N inversions
#    into one because inv(a_i) = inv(Πa)·Π_{j≠i}a_j, but the root of a
#    product gives only the PRODUCT of the roots — there is no
#    per-element relation to unwind, so each lane pays its own
#    exponentiation.  CPython's pow() (C sliding-window) was measured
#    5× faster per lane than a shared square-and-multiply chain over
#    vectorised numpy uint64 limbs (the ops/g1.py design scaled to
#    host), so the chain stays in C and the batch amortises the
#    Python-level validation instead.
#  * The subgroup ladder is the part worth moving: check_subgroup=False
#    defers it so callers run ONE batched device [r]-chain
#    (ops/glv.py subgroup_mask) over the whole batch — bit-identical
#    rejection, none of the per-point host milliseconds.
#
# Bit-identity with the scalar path (fp_sqrt / from_bytes /
# g1_decompress_unchecked), including the rejection set, is asserted in
# tests/test_proof_hotpath.py.


def fp_sqrt_batch(values: list[int]) -> list[int | None]:
    """Batch fp_sqrt — literally a loop over the scalar helper (see the
    module comment above: per-lane C pow() is the fastest chain), kept
    as the batch seam so a future backend that CAN amortise roots slots
    in without touching callers."""
    return [fp_sqrt(v % P) for v in values]


def g1_decompress_batch(
    blobs: list[bytes], check_subgroup: bool = True
) -> list[G1Point]:
    """Batched compressed-G1 decompression, bit-identical to a loop of
    G1Point.from_bytes (check_subgroup=True) or g1_decompress_unchecked
    (check_subgroup=False): the same ValueError rejection set — bad
    length, uncompressed/invalid-infinity flags, x ≥ p, non-residue x³+4,
    and (when checked) non-subgroup points — and the same points out,
    including the point at infinity and both sign flags.  Raises on the
    FIRST invalid item of each validation phase; callers that need
    per-item verdicts bisect, exactly as they do over the scalar path.

    The square roots stay per-lane C pow() (fp_sqrt_batch — see the
    module comment for why they don't batch); what the batch form
    amortises is the Python-level validation and, via
    check_subgroup=False, the subgroup ladder.  check_subgroup=False
    is the fast path for verifiers that defer the subgroup test to the
    batched device [r]-chain (ops/glv.py subgroup_mask)."""
    n = len(blobs)
    out: list[G1Point | None] = [None] * n
    lanes: list[int] = []
    xs: list[int] = []
    large: list[bool] = []
    for k, data in enumerate(blobs):
        if len(data) != 48:
            raise ValueError("G1 compressed point must be 48 bytes")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G1 encoding unsupported")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("invalid infinity encoding")
            out[k] = G1Point.infinity()
            continue
        x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        lanes.append(k)
        xs.append(x)
        large.append(bool(flags & 0x20))
    if lanes:
        roots = fp_sqrt_batch([(x * x % P * x + G1Point.B) % P for x in xs])
        for k, x, y, lg in zip(lanes, xs, roots, large):
            if y is None:
                raise ValueError("point not on curve")
            if lg != (y > P - y):
                y = P - y
            out[k] = G1Point(x, y)
        if check_subgroup:
            for k in lanes:
                if not out[k].in_subgroup():
                    raise ValueError("point not in G1 subgroup")
    return out


def _jac_double_fq2(x: Fq2, y: Fq2, z: Fq2) -> tuple[Fq2, Fq2, Fq2]:
    if z.is_zero() or y.is_zero():
        return FQ2_ZERO, FQ2_ONE, FQ2_ZERO
    a = x.square()
    b = y.square()
    c = b.square()
    d = ((x + b).square() - a - c) * 2
    e = a * 3
    f = e.square()
    x3 = f - d * 2
    y3 = e * (d - x3) - c * 8
    z3 = y * z * 2
    return x3, y3, z3


def _jac_add_fq2(
    x1: Fq2, y1: Fq2, z1: Fq2, x2: Fq2, y2: Fq2, z2: Fq2
) -> tuple[Fq2, Fq2, Fq2]:
    if z1.is_zero():
        return x2, y2, z2
    if z2.is_zero():
        return x1, y1, z1
    z1z1 = z1.square()
    z2z2 = z2.square()
    u1 = x1 * z2z2
    u2 = x2 * z1z1
    s1 = y1 * z2 * z2z2
    s2 = y2 * z1 * z1z1
    if u1 == u2:
        if s1 != s2:
            return FQ2_ZERO, FQ2_ONE, FQ2_ZERO
        return _jac_double_fq2(x1, y1, z1)
    h = u2 - u1
    i = (h * 2).square()
    j = h * i
    r_ = (s2 - s1) * 2
    v = u1 * i
    x3 = r_.square() - j - v * 2
    y3 = r_ * (v - x3) - s1 * j * 2
    z3 = z1 * z2 * h * 2
    return x3, y3, z3


class G2Point:
    """Affine point on E': y^2 = x^3 + 4(u+1) over Fp2."""

    __slots__ = ("x", "y")
    B = Fq2(4, 4)

    def __init__(self, x: Fq2 | None, y: Fq2 | None) -> None:
        self.x, self.y = x, y

    @classmethod
    def infinity(cls) -> "G2Point":
        return cls(None, None)

    def is_infinity(self) -> bool:
        return self.x is None

    def __eq__(self, o) -> bool:
        return isinstance(o, G2Point) and self.x == o.x and self.y == o.y

    def is_on_curve(self) -> bool:
        if self.is_infinity():
            return True
        return self.y.square() == self.x.square() * self.x + self.B

    def __neg__(self) -> "G2Point":
        if self.is_infinity():
            return self
        return G2Point(self.x, -self.y)

    def __add__(self, o: "G2Point") -> "G2Point":
        if self.is_infinity():
            return o
        if o.is_infinity():
            return self
        if self.x == o.x:
            if (self.y + o.y).is_zero():
                return G2Point.infinity()
            lam = (self.x.square() * 3) * (self.y * 2).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam.square() - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return G2Point(x3, y3)

    def mul(self, k: int) -> "G2Point":
        """Scalar mult in Jacobian coordinates over Fp2."""
        k %= R
        return self._mul_raw(k)

    def _mul_raw(self, k: int) -> "G2Point":
        if k == 0 or self.is_infinity():
            return G2Point.infinity()
        rx, ry, rz = FQ2_ZERO, FQ2_ONE, FQ2_ZERO
        bx, by, bz = self.x, self.y, FQ2_ONE
        while k:
            if k & 1:
                rx, ry, rz = _jac_add_fq2(rx, ry, rz, bx, by, bz)
            bx, by, bz = _jac_double_fq2(bx, by, bz)
            k >>= 1
        if rz.is_zero():
            return G2Point.infinity()
        zinv = rz.inv()
        z2 = zinv.square()
        return G2Point(rx * z2, ry * z2 * zinv)

    def in_subgroup(self) -> bool:
        return self.is_on_curve() and self._mul_raw(R).is_infinity()

    # -- compressed serialization (96 bytes, c1 first) -------------------

    def to_bytes(self) -> bytes:
        if self.is_infinity():
            out = bytearray(96)
            out[0] = 0xC0
            return bytes(out)
        out = bytearray(
            self.x.c1.to_bytes(48, "big") + self.x.c0.to_bytes(48, "big")
        )
        out[0] |= 0x80
        neg = -self.y
        # lexicographic order over (c1, c0)
        if (self.y.c1, self.y.c0) > (neg.c1, neg.c0):
            out[0] |= 0x20
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "G2Point":
        if len(data) != 96:
            raise ValueError("G2 compressed point must be 96 bytes")
        flags = data[0]
        if not flags & 0x80:
            raise ValueError("uncompressed G2 encoding unsupported")
        if flags & 0x40:
            if any(data[1:]) or flags & 0x3F:
                raise ValueError("invalid infinity encoding")
            return cls.infinity()
        c1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
        c0 = int.from_bytes(data[48:96], "big")
        if c0 >= P or c1 >= P:
            raise ValueError("x out of range")
        x = Fq2(c0, c1)
        y = (x.square() * x + cls.B).sqrt()
        if y is None:
            raise ValueError("point not on curve")
        neg = -y
        y_is_large = (y.c1, y.c0) > (neg.c1, neg.c0)
        if bool(flags & 0x20) != y_is_large:
            y = neg
        point = cls(x, y)
        if not point.in_subgroup():
            raise ValueError("point not in G2 subgroup")
        return point


G1_GENERATOR = G1Point(
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GENERATOR = G2Point(
    Fq2(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    Fq2(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)
assert G1_GENERATOR.is_on_curve()
assert G2_GENERATOR.is_on_curve()


# ---------------------------------------------------------------- pairing

def _untwist(q: G2Point) -> tuple[Fq12, Fq12]:
    """E'(Fp2) → E(Fp12): (x', y') → (x'/w^2, y'/w^3)."""
    w2_inv = (FQ12_W * FQ12_W).inv()
    w3_inv = (FQ12_W * FQ12_W * FQ12_W).inv()
    return (Fq12.from_fq2(q.x) * w2_inv, Fq12.from_fq2(q.y) * w3_inv)


def _line_coeff(t, q):
    """One chord-and-tangent step of the affine Miller loop, Q-side
    only: the slope and chord point involve no G1 input, so they are
    precomputable per Q.  Returns ((mode, lam, tx, ty), t+q) where
    mode 0 = sloped line (evaluate -((px-tx)·lam - (py-ty))) and
    mode 1 = vertical (evaluate px - tx)."""
    tx, ty = t
    qx, qy = q
    if tx == qx and ty == qy:
        lam = tx.square() * 3 * (ty * 2).inv()
    elif tx == qx:
        return (1, None, tx, ty), (None, None)
    else:
        lam = (qy - ty) * (qx - tx).inv()
    x3 = lam.square() - tx - qx
    y3 = lam * (tx - x3) - ty
    return (0, lam, tx, ty), (x3, y3)


def _q_coeffs(q: G2Point) -> list:
    """Per-Q Miller-loop line coefficients.  Every slope/inversion in
    the loop depends only on Q, so for recurring Q's (the G2 generator
    in every signature check, each validator's registered key) the
    whole inversion chain is computed once and the per-pairing work is
    evaluation only."""
    qt = _untwist(q)
    coeffs = []
    t = qt
    for bit in bin(BLS_X)[3:]:
        c, t = _line_coeff(t, t)
        coeffs.append(c)
        if bit == "1":
            c, t = _line_coeff(t, qt)
            coeffs.append(c)
    return coeffs


# LRU keyed by the affine G2 coordinates.  Verifies run concurrently
# from RPC/gossip/import threads, so all cache access is under a lock;
# recency eviction keeps hot keys (validators, the G2 generator) cached
# even when the account population exceeds the capacity.
_Q_COEFF_CACHE: "OrderedDict" = OrderedDict()
_Q_COEFF_CACHE_MAX = 256
_Q_COEFF_LOCK = threading.Lock()


def _q_coeffs_cached(q: G2Point) -> list:
    key = (q.x.c0, q.x.c1, q.y.c0, q.y.c1)
    with _Q_COEFF_LOCK:
        hit = _Q_COEFF_CACHE.get(key)
        if hit is not None:
            _Q_COEFF_CACHE.move_to_end(key)
            return hit
    coeffs = _q_coeffs(q)  # expensive inversion chain: outside the lock
    with _Q_COEFF_LOCK:
        _Q_COEFF_CACHE[key] = coeffs
        _Q_COEFF_CACHE.move_to_end(key)
        while len(_Q_COEFF_CACHE) > _Q_COEFF_CACHE_MAX:
            _Q_COEFF_CACHE.popitem(last=False)
    return coeffs


def miller_loop(p: G1Point, q: G2Point) -> Fq12:
    """Miller loop of the optimal ate pairing (negative-x BLS12:
    conjugate at the end) — reference capability:
    utils/verify-bls-signatures/src/lib.rs:85-100.  Q-side line
    coefficients come from the per-Q cache; the per-call work is the
    G1-side evaluation and the f accumulation."""
    if p.is_infinity() or q.is_infinity():
        return FQ12_ONE
    coeffs = _q_coeffs_cached(q)
    px, py = Fq12.from_int(p.x), Fq12.from_int(p.y)

    def line_at_p(c):
        mode, lam, tx, ty = c
        # vertical line (mode) vs sloped tangent/chord through T
        return px - tx if mode else -((px - tx) * lam - (py - ty))

    f = FQ12_ONE
    i = 0
    for bit in bin(BLS_X)[3:]:
        f = f.square() * line_at_p(coeffs[i])
        i += 1
        if bit == "1":
            f = f * line_at_p(coeffs[i])
            i += 1
    # x < 0 ⇒ conjugate (Frobenius^6)
    return f.conjugate()


_FINAL_EXP = (P**12 - 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r).  Easy part via conjugation/inversion, remainder by
    square-and-multiply (correctness-first; the fixed exponent makes this
    replay-safe)."""
    # easy part: f^(p^6 - 1) = conj(f) * f^-1 — cheapens the remaining pow
    f = f.conjugate() * f.inv()
    # remaining exponent: (p^6+1)(p^4-p^2+1)/r … folded into one pow of the
    # quotient of what's left.
    return f.pow(_FINAL_EXP // (P**6 - 1))


def pairing(p: G1Point, q: G2Point) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: list[tuple[G1Point, G2Point]]) -> Fq12:
    """Π e(P_i, Q_i) with a single final exponentiation (the
    multi_miller_loop pattern, reference lib.rs:85-100)."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


def pairing_check(pairs: list[tuple[G1Point, G2Point]]) -> bool:
    """Π e(P_i, Q_i) == 1 — the form every verifier reduces to."""
    return multi_pairing(pairs).is_one()


# ---------------------------------------------------------------- hash to G1

def expand_message_xmd(msg: bytes, dst: bytes, out_len: int) -> bytes:
    """RFC 9380 §5.3.1 expand_message_xmd with SHA-256 (exact)."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    b_in_bytes = 32
    r_in_bytes = 64
    ell = -(-out_len // b_in_bytes)
    if ell > 255:
        raise ValueError("expand_message_xmd: output too long")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = bytes(r_in_bytes)
    l_i_b_str = out_len.to_bytes(2, "big")
    b0 = hashlib.sha256(
        z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    ).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        blocks.append(
            hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest()
        )
    return b"".join(blocks)[:out_len]


def hash_to_field_fp(msg: bytes, dst: bytes, count: int) -> list[int]:
    """RFC 9380 §5.2 hash_to_field for Fp (m=1, L=64)."""
    length = 64
    uniform = expand_message_xmd(msg, dst, count * length)
    return [
        int.from_bytes(uniform[i * length : (i + 1) * length], "big") % P
        for i in range(count)
    ]


def _sswu_consts():
    from . import _sswu_g1

    return _sswu_g1


def map_to_curve_g1(u: int) -> G1Point:
    """RFC 9380 §6.6.2/§6.6.3 map Fp → E: simplified SWU onto the
    11-isogenous curve E' (A', B', Z = 11), then the 11-isogeny to E.

    The isogeny coefficients are DERIVED by tools/derive_sswu.py
    (division polynomial → rational kernel → Vélu → codomain scaling)
    and pinned to the IC vectors mirrored from the reference
    (utils/verify-bls-signatures/tests/tests.rs:19-127)."""
    c = _sswu_consts()
    A, B, Z = c.A_PRIME, c.B_PRIME, c.Z_SSWU
    u %= P
    tv = Z * u % P * u % P
    tv2 = (tv * tv + tv) % P
    if tv2 == 0:
        x1 = B * pow(Z * A % P, P - 2, P) % P
    else:
        x1 = (-B) % P * pow(A, P - 2, P) % P * (1 + pow(tv2, P - 2, P)) % P
    gx1 = (x1 * x1 % P * x1 + A * x1 + B) % P
    y = fp_sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = tv * x1 % P
        gx2 = (x * x % P * x + A * x + B) % P
        y = fp_sqrt(gx2)
        assert y is not None, "SSWU: neither candidate is square"
    if (y & 1) != (u & 1):  # sgn0 alignment
        y = P - y
    # 11-isogeny E' → E (x' = XN/XD, y' = y·YN/YD; poles → infinity)
    xd = _poly_eval(c.X_DEN, x)
    if xd == 0:
        return G1Point.infinity()
    X = _poly_eval(c.X_NUM, x) * pow(xd, P - 2, P) % P
    Y = y * _poly_eval(c.Y_NUM, x) % P * pow(
        _poly_eval(c.Y_DEN, x), P - 2, P
    ) % P
    return G1Point(X, Y)


def _poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def clear_cofactor_g1(p: G1Point) -> G1Point:
    """Multiply by the effective cofactor h_eff = 1 − z (RFC 9380 §8.8.1)
    — NOT the full cofactor (z−1)²/3; they differ by a scalar on the
    r-torsion and the IC vectors pin this one.  Via _mul_raw, which does
    not reduce the scalar mod r."""
    return p._mul_raw(H_EFF_G1)


def hash_to_g1(msg: bytes, dst: bytes = DST_G1) -> G1Point:
    """hash_to_curve for G1 (RFC 9380 hash_to_curve, SSWU route): two
    field elements, map both through SSWU + isogeny, add, clear
    cofactor.  With dst=IC_DST this is the exact suite the reference
    verifies (BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_)."""
    u0, u1 = hash_to_field_fp(msg, dst, 2)
    q = map_to_curve_g1(u0) + map_to_curve_g1(u1)
    return clear_cofactor_g1(q)


# ---------------------------------------------------------------- signatures

def keygen(seed: bytes) -> int:
    """Deterministic secret key from seed (nonzero scalar)."""
    sk = int.from_bytes(
        hashlib.blake2b(b"cess-bls-keygen" + seed, digest_size=48).digest(), "big"
    ) % R
    return sk or 1


def sk_to_pk(sk: int) -> bytes:
    return G2_GENERATOR.mul(sk).to_bytes()


def sign(sk: int, msg: bytes) -> bytes:
    """48-byte G1 signature (reference: verify-bls-signatures sign path,
    lib.rs:176-237)."""
    return hash_to_g1(msg).mul(sk).to_bytes()


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """e(sig, g2) == e(H(msg), pk), computed as
    e(sig, -g2)·e(H(msg), pk) == 1 (reference: lib.rs:85-100)."""
    try:
        sig_point = G1Point.from_bytes(sig)
        pk_point = G2Point.from_bytes(pk)
    except ValueError:
        return False
    h = hash_to_g1(msg)
    return pairing_check([(sig_point, -G2_GENERATOR), (h, pk_point)])


def verify_bls_signature(sig: bytes, msg: bytes, key: bytes) -> bool:
    """IC-compatible entry point with the reference crate's argument
    order (utils/verify-bls-signatures/src/lib.rs:85-100): 48-byte
    compressed G1 signature, arbitrary message, 96-byte compressed G2
    public key.  Interop is pinned by the reference KATs
    (tests/tests.rs:19-127 → tests/test_bls12_381.py)."""
    return verify(key, msg, sig)
