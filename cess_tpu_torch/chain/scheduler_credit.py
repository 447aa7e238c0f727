"""TEE-scheduler reputation: processed-bytes credit with decayed history.

Re-design of the reference scheduler-credit pallet (reference:
c-pallets/scheduler-credit/src/lib.rs):

 * per-period counters of bytes processed and punishments per TEE controller;
 * credit value = share_of_total×1000 − (10×punishments)², floored at 0
   (lib.rs:45-75);
 * per-period rollover on_initialize (lib.rs:112-124), keeping 5 periods of
   history;
 * credit score = weighted sum of the last 5 periods at 50/20/15/10/5%
   (lib.rs:36-42, 187-227) — fed into validator election (ValidatorCredits).
"""

from __future__ import annotations

from dataclasses import dataclass

from .state import ChainState
from .types import AccountId, Perbill

MOD = "scheduler_credit"

FULL_CREDIT_SCORE = 1000
# Percent weights for periods n-1 .. n-5 (reference: lib.rs:36-42).
PERIOD_WEIGHT = (50, 20, 15, 10, 5)


@dataclass
class SchedulerCounterEntry:
    proceed_block_size: int = 0
    punishment_count: int = 0

    def punishment_part(self) -> int:
        if self.punishment_count != 0:
            return (10 * self.punishment_count) ** 2
        return 0

    def figure_credit_value(self, total_block_size: int) -> int:
        """reference: lib.rs:62-68 (saturating subtraction)."""
        if total_block_size != 0:
            a = Perbill.from_rational(
                self.proceed_block_size, total_block_size
            ).mul_floor(FULL_CREDIT_SCORE)
            return max(0, a - self.punishment_part())
        return 0


class SchedulerCreditPallet:
    def __init__(self, state: ChainState, period_duration: int) -> None:
        self.state = state
        self.period_duration = period_duration
        self.current_counters: dict[AccountId, SchedulerCounterEntry] = {}
        # period -> controller -> credit value
        self.history_credit_values: dict[int, dict[AccountId, int]] = {}
        # controller -> stash resolution (SchedulerStashAccountFinder,
        # reference: runtime/src/impls.rs:30-40); wired by the runtime.
        self.stash_of: dict[AccountId, AccountId] = {}

    # -- SchedulerCreditCounter trait (reference: lib.rs:230-240) -------

    def record_proceed_block_size(self, scheduler: AccountId, size: int) -> None:
        self.current_counters.setdefault(
            scheduler, SchedulerCounterEntry()
        ).proceed_block_size += size

    def record_punishment(self, scheduler: AccountId) -> None:
        self.current_counters.setdefault(
            scheduler, SchedulerCounterEntry()
        ).punishment_count += 1

    # -- hooks ----------------------------------------------------------

    def on_initialize(self, now: int) -> None:
        if now % self.period_duration == 0:
            period = now // self.period_duration
            self.figure_credit_values(max(0, period - 1))

    def figure_credit_values(self, period: int) -> None:
        """Roll the live counters into history for `period` and reset
        (reference: lib.rs:144-185)."""
        total = sum(e.proceed_block_size for e in self.current_counters.values())
        snapshot = {
            acc: entry.figure_credit_value(total)
            for acc, entry in self.current_counters.items()
        }
        self.history_credit_values[period] = snapshot
        self.current_counters.clear()
        history_depth = len(PERIOD_WEIGHT)
        if period >= history_depth:
            self.history_credit_values.pop(period - history_depth, None)

    # -- scoring (reference: lib.rs:187-227, 242-251) -------------------

    def figure_credit_scores(self) -> dict[AccountId, int]:
        period = self.state.block_number // self.period_duration
        if period == 0:
            return {}
        last = period - 1
        result: dict[AccountId, int] = {}
        for ctrl in self.history_credit_values.get(last, {}):
            stash = self.stash_of.get(ctrl)
            if stash is None:
                continue
            score = 0
            for index, weight in enumerate(PERIOD_WEIGHT):
                if last >= index:
                    value = self.history_credit_values.get(last - index, {}).get(
                        ctrl, 0
                    )
                    score += Perbill.from_percent(weight).mul_floor(value)
            result[stash] = score
        return result

    # ValidatorCredits trait
    @staticmethod
    def full_credit() -> int:
        return FULL_CREDIT_SCORE

    def credits(self, _epoch_index: int = 0) -> dict[AccountId, int]:
        return self.figure_credit_scores()
