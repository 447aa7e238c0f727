"""ProofBackend interface: the batch protocol between the chain layer and
the PoDR2 math.

Batch protocol (SURVEY.md §7 item 3): (challenge snapshot, proofs[], keys)
→ verdict bitmap.  Backends must be deterministic and mutually bit-identical
— the audit round's accept/reject decisions are consensus-critical.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

from ..ops.podr2 import Challenge, Podr2Params, Podr2Proof

# One verification item: a fragment name, the round challenge, the proof.
VerifyItem = tuple  # (name: bytes, challenge: Challenge, proof: Podr2Proof)


@dataclass
class ProveRequest:
    """Miner-side batch: produce proofs for many fragments under one round
    challenge (all miners share the round's indices/coefficients, reference:
    c-pallets/audit/src/types.rs:14-23 — one NetSnapShot per round)."""

    names: list[bytes]
    tags: list[list[bytes]]      # per fragment: n chunk tags
    data: list[bytes]            # per fragment: raw bytes
    challenge: Challenge
    params: Podr2Params


class ProofBackend(ABC):
    """Pluggable PoDR2 executor."""

    name: str = "abstract"

    @abstractmethod
    def verify_batch(
        self,
        pk: bytes,
        items: list[VerifyItem],
        seed: bytes,
        params: Podr2Params,
    ) -> list[bool]:
        """Per-item verdicts.  Implementations batch-combine with the shared
        ρ weights derived from `seed` and bisect on failure, so the common
        all-honest case costs O(1) pairings."""

    @abstractmethod
    def prove_batch(self, request: ProveRequest) -> list[Podr2Proof]:
        """Miner-side proof generation for a batch of fragments."""

    # -- shared bisection ------------------------------------------------

    def _verdicts_by_bisection(
        self,
        pk: bytes,
        items: list[VerifyItem],
        seed: bytes,
        params: Podr2Params,
        batch_check,
        single_check,
    ) -> list[bool]:
        """Deterministic divide-and-conquer: one combined check per node of
        the bisection tree; leaves fall back to single verification.  Both
        backends use this exact strategy so verdict computation (not just
        verdict values) matches."""
        verdicts = [False] * len(items)

        def recurse(indices: list[int], depth: int) -> None:
            subset = [items[i] for i in indices]
            if batch_check(pk, subset, seed + depth.to_bytes(2, "little"), params):
                for i in indices:
                    verdicts[i] = True
                return
            if len(indices) == 1:
                verdicts[indices[0]] = single_check(pk, subset[0], params)
                return
            mid = len(indices) // 2
            recurse(indices[:mid], depth + 1)
            recurse(indices[mid:], depth + 1)

        if items:
            recurse(list(range(len(items))), 0)
        return verdicts
