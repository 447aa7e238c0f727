"""RRSC pallet: credit-weighted rotation + VRF epoch randomness.

The reference's consensus is RRSC (Random Rotational Selection, a BABE
fork living in the forked substrate — SURVEY.md §2 external components:
`pallet_rrsc`/`cessc-consensus-rrsc`, runtime alias at
runtime/src/lib.rs:1503).  Its protocol-visible capabilities:

 * validator selection that folds TEE service reputation into the
   election (the `ValidatorCredits` trait implemented by
   scheduler-credit, c-pallets/scheduler-credit/src/lib.rs:242-251);
 * slot-based authorship driven by per-epoch randomness, with each
   block's VRF output accumulated into the NEXT epoch's randomness
   (the `ParentBlockRandomness` feed, runtime/src/lib.rs:1003,1069).

This pallet owns the on-chain consensus state for both:

  `rotate_epoch`      runs the credit-weighted election (staking.elect ×
                      scheduler_credit.credits) and pins the new epoch's
                      randomness from the VRF accumulator;
  `fold_vrf_output`   folds one block's verified VRF output into the
                      accumulator — called by the node service exactly
                      once per block, by author and importer alike, so
                      the accumulator is replicated state (covered by
                      chain/checkpoint.py's state hash and snapshot,
                      blob format v3);
  `slot_author`       the deterministic stake-weighted draw from
                      (epoch randomness, slot) — the SECONDARY-author
                      fallback of the claim ladder
                      (cess_tpu/consensus/engine.py); primary claims
                      are won by the VRF threshold instead.

Runtimes that never fold an output (the in-process protocol sims of
chain/node.py drive the runtime without headers) keep the pre-VRF
behavior: rotation falls back to the parent-block randomness hash
chain, so their determinism contract is unchanged.
"""

from __future__ import annotations

import hashlib

from .state import ChainState
from .types import AccountId

MOD = "rrsc"


class RrscPallet:
    def __init__(
        self,
        state: ChainState,
        staking,
        scheduler_credit,
        max_validators: int = 100,
    ) -> None:
        self.state = state
        self.staking = staking
        self.scheduler_credit = scheduler_credit
        self.max_validators = max_validators
        self.epoch_index: int = 0
        self.epoch_randomness: bytes = bytes(32)
        # VRF output accumulator: every imported block folds its
        # verified output here; the fold count distinguishes "no
        # VRF-bearing blocks this epoch" (hash-chain fallback) from a
        # genuinely accumulated epoch.
        self.vrf_accumulator: bytes = bytes(32)
        self.vrf_fold_count: int = 0

    # ------------------------------------------------------------ epochs

    def rotate_epoch(self) -> list[AccountId]:
        """Era-boundary rotation: elect the active set with TEE credit
        weights and pin this epoch's randomness from the accumulated
        VRF outputs (replacing the pre-VRF hash-chain snapshot; the
        chain remains the fallback for header-less sims)."""
        # scheduler_credit.credits() is already stash-keyed (it resolves
        # controller → stash through its SchedulerStashAccountFinder,
        # the runtime/src/impls.rs:30-40 role).
        credits = self.scheduler_credit.credits(self.epoch_index)
        # chilled candidacies (offences) are skipped inside elect; an
        # election that would seat nobody keeps the previous set —
        # both surfaced in the NewEpoch event so liveness drills can
        # read the rotation's health off the event stream
        chilled = sum(
            1 for c in self.staking.candidates
            if self.staking.is_chilled(c)
        )
        elected = self.staking.elect(
            self.max_validators,
            credits,
            full_credit=self.scheduler_credit.full_credit(),
        )
        self.epoch_index += 1
        if self.vrf_fold_count > 0:
            self.epoch_randomness = hashlib.blake2b(
                b"rrsc/epoch" + self.epoch_index.to_bytes(8, "little")
                + self.vrf_accumulator,
                digest_size=32,
            ).digest()
        else:
            self.epoch_randomness = self.state.randomness
        # chain epochs: the new accumulator starts from the epoch
        # randomness it will feed, so epochs are linked even if a whole
        # epoch somehow passes without a block
        self.vrf_accumulator = self.epoch_randomness
        self.vrf_fold_count = 0
        self.state.deposit_event(
            MOD, "NewEpoch", index=self.epoch_index,
            validators=len(elected), chilled_skipped=chilled,
        )
        return elected

    def fold_vrf_output(self, slot: int, output: bytes) -> None:
        """Accumulate one block's verified VRF output.  Part of the
        deterministic state transition: the author folds before
        executing the block, the importer folds after verifying the
        claim — both before run_blocks, so era-boundary rotations in
        the SAME block already see this output."""
        self.vrf_accumulator = hashlib.blake2b(
            b"rrsc/vrf-fold" + self.vrf_accumulator
            + slot.to_bytes(8, "little") + output,
            digest_size=32,
        ).digest()
        self.vrf_fold_count += 1

    # ------------------------------------------------------------ slots

    def stake_weights(self) -> tuple[list[AccountId], list[int], int]:
        """(validators, bonded weights, total) — the one weight source
        for both the secondary draw and the primary VRF threshold
        (consensus/engine.py), so the two claim rungs can never
        disagree about stake."""
        validators = list(self.staking.validators)
        weights = []
        for v in validators:
            ledger = self.staking.ledger.get(v)
            weights.append(ledger.bonded if ledger else 1)
        if not any(weights):
            weights = [1] * len(validators)  # uniform fallback
        return validators, weights, sum(weights)

    def slot_author(self, slot: int) -> AccountId | None:
        """Stake-weighted deterministic SECONDARY author for a slot —
        the fallback rung of the claim ladder: exactly one validator
        per slot, derived from shared state, so every replica agrees
        and the chain advances even when no primary VRF claim wins."""
        validators, weights, total = self.stake_weights()
        if not validators:
            return None
        digest = hashlib.blake2b(
            b"rrsc/slot" + self.epoch_randomness + slot.to_bytes(8, "little"),
            digest_size=8,
        ).digest()
        draw = int.from_bytes(digest, "little") % total
        acc = 0
        for v, w in zip(validators, weights):
            acc += w
            if draw < acc:
                return v
        return validators[-1]
