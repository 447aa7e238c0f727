"""Slot-claim rules: who may author a slot, and how import checks it.

The BABE/RRSC claim ladder, narrowed to two rungs (scope-cut register:
docs/consensus.md):

  primary    the author's VRF output over (epoch randomness, slot) falls
             below its stake-weighted threshold (vrf.threshold).  Any
             number of validators — including zero — may win a slot.
  secondary  the deterministic stake-weighted draw from the same epoch
             randomness (chain/rrsc.py slot_author) names exactly one
             fallback author per slot, so the chain never stalls when no
             primary claim lands.  Secondary blocks STILL carry the VRF
             proof for the slot (the BABE "secondary-VRF" flavor), so
             every block feeds a provably-unbiasable output into the
             epoch-randomness accumulator.

Fork choice prefers primary over secondary (rank 0 < 1), then lower
slot, then lower hash — the BABE ordering, evaluated by
node/service.py.  All functions here are host-cheap and structural;
the expensive pairing over the proof rides the block's weighted
signature batch (one pairing product per import, node/service.py
_verify_and_apply), or the range batch during catch-up (node/sync.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import vrf

# Primary-claim density c = C_NUM/C_DEN (the BABE `c` parameter): the
# expected fraction of slots with at least one primary winner.  Kept
# deliberately low so most slots resolve to the single secondary author
# — with pure-Python pairings at ~0.38 s per import, frequent
# multi-winner slots would fork-storm a live testnet (the block_time
# ≥ 500 ms constraint of node/sync.py).
C_NUM, C_DEN = 1, 4

RANK_PRIMARY = 0
RANK_SECONDARY = 1
RANK_NONE = 2


class ClaimError(ValueError):
    """Slot claim failed a structural check (output derivation,
    threshold, secondary schedule)."""


@dataclass
class SlotClaim:
    """One provable authorship claim, header-ready."""

    author: str
    slot: int
    output: bytes
    proof: bytes
    primary: bool

    @property
    def rank(self) -> int:
        return RANK_PRIMARY if self.primary else RANK_SECONDARY


def slot_message(genesis: str, rrsc, slot: int) -> bytes:
    """The VRF input for a slot under the CURRENT epoch context.  Must
    be evaluated against the parent state of the block being built or
    checked — epoch index/randomness only change inside era-boundary
    blocks, so producer and importer agree by construction."""
    return vrf.vrf_input(
        genesis, rrsc.epoch_index, rrsc.epoch_randomness, slot
    )


def primary_threshold(rrsc, author: str) -> int:
    """τ for this author from the live stake weights (the same weights
    the secondary draw uses — chain/rrsc.py stake_weights)."""
    validators, weights, total = rrsc.stake_weights()
    try:
        w = weights[validators.index(author)]
    except ValueError:
        return 0  # not a validator: can never claim
    return vrf.threshold(w, total, C_NUM, C_DEN)


def claim_rank(rrsc, author: str, slot: int, output: bytes) -> int:
    """Fork-choice rank of a claim from its output alone (no pairing):
    0 primary, 1 secondary, 2 no valid claim.  Callers comparing forks
    may rank with their own head's state — the full structural check
    against the true parent state runs at import."""
    if vrf.output_wins(output, primary_threshold(rrsc, author)):
        return RANK_PRIMARY
    if rrsc.slot_author(slot) == author:
        return RANK_SECONDARY
    return RANK_NONE


def classify_claim(
    rrsc, author: str, slot: int, output: bytes, proof: bytes
) -> bool:
    """Structural claim verification at import (parent state): output
    must re-derive from the proof (the unbiasability anchor — a stolen
    output with someone else's proof, or a ground output, dies here),
    and the output must either beat the author's threshold or the
    author must be the slot's secondary author.  Returns primary-ness;
    raises ClaimError otherwise.  The pairing over (proof, slot
    message) is the caller's job."""
    if vrf.proof_to_output(proof) != output:
        raise ClaimError("vrf output does not match proof")
    rank = claim_rank(rrsc, author, slot, output)
    if rank == RANK_NONE:
        raise ClaimError(
            f"wrong author: {author} has no slot claim at {slot} "
            f"(output above primary threshold and secondary is "
            f"{rrsc.slot_author(slot)})"
        )
    return rank == RANK_PRIMARY


def claim_slot(
    rrsc, genesis: str, author: str, sk: int, slot: int
) -> SlotClaim | None:
    """Authoring side: evaluate this validator's VRF for the slot and
    return a claim when it wins primary or owns the secondary fallback;
    None means stay silent this slot."""
    msg = slot_message(genesis, rrsc, slot)
    output, proof = vrf.prove(sk, msg)
    if vrf.output_wins(output, primary_threshold(rrsc, author)):
        return SlotClaim(author, slot, output, proof, primary=True)
    if rrsc.slot_author(slot) == author:
        return SlotClaim(author, slot, output, proof, primary=False)
    return None
