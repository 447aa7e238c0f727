"""Core protocol types, constants and fixed-point arithmetic.

Mirrors the reference's shared primitives (reference:
primitives/common/src/lib.rs:16,53-62,76-85 and the Perbill fixed-point type
from Substrate's sp-arithmetic) with exact integer semantics: every
percentage/proportion computation in the protocol is floor arithmetic over
parts-per-billion, so results are bit-identical across Python, C++ and the
JAX verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# ---------------------------------------------------------------- units

KIB = 1024
MIB = 1024 * KIB
G_BYTE = 1024 * MIB
T_BYTE = 1024 * G_BYTE

# File geometry (reference: primitives/common/src/lib.rs:60-62,
# runtime/src/lib.rs:1024-1025).
SEGMENT_SIZE = 16 * MIB
FRAGMENT_SIZE = 8 * MIB
CHUNK_COUNT = 1024
FRAGMENT_COUNT = 3       # 2 data + 1 parity per segment
SEGMENT_COUNT_MAX = 1000

# Token (12-decimal base unit as in the reference chain spec).
TOKEN = 10**12

# Block cadence (reference: runtime/src/lib.rs:234,245).
MILLISECS_PER_BLOCK = 6000
BLOCKS_PER_DAY = 24 * 60 * 60 * 1000 // MILLISECS_PER_BLOCK  # 14400
BLOCKS_PER_HOUR = 60 * 60 * 1000 // MILLISECS_PER_BLOCK      # 600

AccountId = str
Balance = int
BlockNumber = int


# ---------------------------------------------------------------- errors


class DispatchError(Exception):
    """An extrinsic failed; the caller must treat state as unmodified.

    Pallet methods follow checks-first discipline (validate everything, then
    mutate), matching FRAME's #[transactional] rollback semantics without a
    snapshotting store.
    """

    def __init__(self, module: str, name: str, detail: str = "") -> None:
        self.module, self.name, self.detail = module, name, detail
        super().__init__(f"{module}::{name}" + (f" ({detail})" if detail else ""))


def ensure(cond: bool, module: str, name: str, detail: str = "") -> None:
    if not cond:
        raise DispatchError(module, name, detail)


# ---------------------------------------------------------------- Perbill


BILLION = 1_000_000_000


class Perbill:
    """Parts-per-billion fixed point, floor semantics (sp-arithmetic Perbill).

    `from_rational(p, q)` rounds the ratio down to the nearest billionth and
    `mul_floor` floors the product — the exact integer pipeline the reference
    uses for power shares, reward splits and punishments
    (reference: c-pallets/sminer/src/lib.rs:654-722).
    """

    __slots__ = ("parts",)

    def __init__(self, parts: int) -> None:
        if not 0 <= parts <= BILLION:
            raise ValueError(f"Perbill parts out of range: {parts}")
        self.parts = parts

    @classmethod
    def from_percent(cls, pct: int) -> "Perbill":
        return cls(min(pct, 100) * (BILLION // 100))

    @classmethod
    def from_rational(cls, p: int, q: int) -> "Perbill":
        # sp-arithmetic clamps the denominator to >=1 (so 0/0 -> 0) and
        # saturates p/q at one.
        q = max(q, 1)
        if p >= q:
            return cls(BILLION)
        return cls(p * BILLION // q)

    def mul_floor(self, value: int) -> int:
        return value * self.parts // BILLION

    def __repr__(self) -> str:  # pragma: no cover
        return f"Perbill({self.parts})"


# ---------------------------------------------------------------- events


@dataclass(frozen=True)
class Event:
    """A deposited runtime event — the protocol's audit trail (every
    reference extrinsic deposits one, e.g. file-bank/src/lib.rs:175-208)."""

    pallet: str
    name: str
    fields: tuple = field(default_factory=tuple)

    @classmethod
    def of(cls, pallet: str, name: str, **fields) -> "Event":
        return cls(pallet, name, tuple(sorted(fields.items())))

    def get(self, key: str):
        return dict(self.fields)[key]
