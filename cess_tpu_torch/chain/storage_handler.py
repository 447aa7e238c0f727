"""User space market: buy / expand / renew leases; global space counters.

Re-design of the reference storage-handler pallet (reference:
c-pallets/storage-handler/src/lib.rs).  Semantics preserved:

 * buy_space: gib_count GiB for 30 days at UnitPrice per GiB-month, paid to
   the file-bank pot (lib.rs:175-200);
 * expansion_space: extra GiB pro-rated at the daily unit price over the
   remaining lease days, rounded up to whole days (lib.rs:208-269);
 * renewal_space: extend the lease by N days for total_space GiB at the
   daily price (lib.rs:273-311);
 * user ledger: total/used/locked/remaining with lock → use/unlock flows
   driven by file-bank deals (lib.rs:520-560);
 * global counters: TotalIdleSpace / TotalServiceSpace / PurchasedSpace with
   the "cannot sell more than the network holds" check (lib.rs:595-618);
 * frozen_task: lease-expiry sweep — frozen after deadline, dead (files
   cleared by file-bank) after deadline + FrozenDays (lib.rs:458-519).
"""

from __future__ import annotations

from dataclasses import dataclass

from .state import ChainState
from .types import AccountId, Balance, BlockNumber, G_BYTE, ensure

MOD = "storage_handler"

SPACE_NORMAL = "normal"
SPACE_FROZEN = "frozen"
SPACE_DEAD = "dead"

FILBAK_POT = "pot/filbak"


@dataclass
class OwnedSpaceDetails:
    """reference: storage-handler/src/types.rs:6-13"""

    total_space: int
    used_space: int
    locked_space: int
    remaining_space: int
    start: BlockNumber
    deadline: BlockNumber
    state: str


class StorageHandlerPallet:
    def __init__(
        self,
        state: ChainState,
        one_day_block: int,
        frozen_days: int,
        unit_price: Balance,
    ) -> None:
        self.state = state
        self.one_day_block = one_day_block
        self.frozen_days_blocks = frozen_days * one_day_block
        self.unit_price = unit_price  # price of 1 GiB for 30 days
        self.user_owned_space: dict[AccountId, OwnedSpaceDetails] = {}
        self.total_idle_space: int = 0
        self.total_service_space: int = 0
        self.purchased_space: int = 0

    # ---------------------------------------------------------------- calls

    def buy_space(self, sender: AccountId, gib_count: int) -> None:
        """reference: lib.rs:175-200"""
        ensure(sender not in self.user_owned_space, MOD, "PurchasedSpace")
        space = G_BYTE * gib_count
        price = self.unit_price * gib_count
        # Checks-first (the reference relies on #[transactional] rollback to
        # recover from its mutate-then-check order; we must not mutate until
        # every check has passed).
        ensure(
            self.state.balances.can_slash(sender, price), MOD, "InsufficientBalance"
        )
        total = self.total_idle_space + self.total_service_space
        ensure(
            self.purchased_space + space <= total, MOD, "InsufficientAvailableSpace"
        )
        self._add_user_purchased_space(sender, space, days=30)
        self._add_purchased_space(space)
        self.state.balances.transfer(sender, FILBAK_POT, price)
        self.state.deposit_event(
            MOD, "BuySpace", acc=sender, storage_capacity=space, spend=price
        )

    def expansion_space(self, sender: AccountId, gib_count: int) -> None:
        """reference: lib.rs:208-269"""
        info = self._space(sender)
        now = self.state.block_number
        ensure(now < info.deadline, MOD, "LeaseExpired")
        ensure(info.state != SPACE_FROZEN, MOD, "LeaseFreeze")
        day_unit_price = self.unit_price // 30
        space = G_BYTE * gib_count
        diff_block = info.deadline - now
        remain_day = diff_block // self.one_day_block
        if diff_block % self.one_day_block != 0:
            remain_day += 1
        price = day_unit_price * gib_count * remain_day
        ensure(
            self.state.balances.can_slash(sender, price), MOD, "InsufficientBalance"
        )
        self._add_purchased_space(space)
        info.remaining_space += space
        info.total_space += space
        self.state.balances.transfer(sender, FILBAK_POT, price)
        self.state.deposit_event(
            MOD, "ExpansionSpace", acc=sender, expansion_space=space, fee=price
        )

    def renewal_space(self, sender: AccountId, days: int) -> None:
        """reference: lib.rs:273-311"""
        info = self._space(sender)
        ensure(info.state != SPACE_DEAD, MOD, "LeaseExpired")
        day_unit_price = self.unit_price // 30
        gib_count = info.total_space // G_BYTE
        price = day_unit_price * gib_count * days
        ensure(
            self.state.balances.can_slash(sender, price), MOD, "InsufficientBalance"
        )
        self.state.balances.transfer(sender, FILBAK_POT, price)
        # update_puchased_package (reference: lib.rs:334-359)
        now = self.state.block_number
        sur_block = self.one_day_block * days
        if now > info.deadline:
            info.start = now
            info.deadline = now + sur_block
        else:
            info.deadline += sur_block
        if info.deadline > now:
            info.state = SPACE_NORMAL
        self.state.deposit_event(
            MOD, "RenewalSpace", acc=sender, renewal_days=days, fee=price
        )

    def update_price(self, new_price: Balance) -> None:
        """Root call (reference: lib.rs:314-321)."""
        self.unit_price = new_price

    # ------------------------------------------------------------ internals

    def _space(self, acc: AccountId) -> OwnedSpaceDetails:
        info = self.user_owned_space.get(acc)
        ensure(info is not None, MOD, "NotPurchasedSpace", acc)
        return info

    def _add_user_purchased_space(
        self, acc: AccountId, space: int, days: int
    ) -> None:
        now = self.state.block_number
        self.user_owned_space[acc] = OwnedSpaceDetails(
            total_space=space,
            used_space=0,
            locked_space=0,
            remaining_space=space,
            start=now,
            deadline=now + self.one_day_block * days,
            state=SPACE_NORMAL,
        )

    def _add_purchased_space(self, size: int) -> None:
        total = self.total_idle_space + self.total_service_space
        ensure(
            self.purchased_space + size <= total, MOD, "InsufficientAvailableSpace"
        )
        self.purchased_space += size

    # -- StorageHandle trait (reference: lib.rs:622-637) ----------------

    def update_user_space(self, acc: AccountId, operation: int, size: int) -> None:
        info = self._space(acc)
        if operation == 1:
            ensure(info.state != SPACE_FROZEN, MOD, "LeaseFreeze")
            ensure(size <= info.remaining_space, MOD, "InsufficientStorage")
            info.used_space += size
            info.remaining_space -= size
        elif operation == 2:
            ensure(info.used_space >= size, MOD, "Overflow")
            info.used_space -= size
            info.remaining_space = info.total_space - info.used_space
        else:
            ensure(False, MOD, "WrongOperation")

    def lock_user_space(self, acc: AccountId, needed_space: int) -> None:
        info = self._space(acc)
        ensure(info.state != SPACE_FROZEN, MOD, "LeaseFreeze")
        ensure(info.remaining_space >= needed_space, MOD, "InsufficientStorage")
        info.locked_space += needed_space
        info.remaining_space -= needed_space

    def unlock_user_space(self, acc: AccountId, needed_space: int) -> None:
        info = self._space(acc)
        ensure(info.locked_space >= needed_space, MOD, "Overflow")
        info.locked_space -= needed_space
        info.remaining_space += needed_space

    def unlock_and_used_user_space(self, acc: AccountId, needed_space: int) -> None:
        info = self._space(acc)
        ensure(info.locked_space >= needed_space, MOD, "Overflow")
        info.locked_space -= needed_space
        info.used_space += needed_space

    def get_user_avail_space(self, acc: AccountId) -> int:
        return self._space(acc).remaining_space

    def check_user_space(self, acc: AccountId, needed_space: int) -> bool:
        return self._space(acc).remaining_space >= needed_space

    def get_total_space(self) -> int:
        total = self.total_idle_space + self.total_service_space
        if total < self.purchased_space:
            return 0
        return total - self.purchased_space

    def add_total_idle_space(self, increment: int) -> None:
        self.total_idle_space += increment

    def sub_total_idle_space(self, decrement: int) -> None:
        ensure(self.total_idle_space >= decrement, MOD, "Overflow")
        self.total_idle_space -= decrement

    def add_total_service_space(self, increment: int) -> None:
        self.total_service_space += increment

    def sub_total_service_space(self, decrement: int) -> None:
        ensure(self.total_service_space >= decrement, MOD, "Overflow")
        self.total_service_space -= decrement

    def add_purchased_space(self, size: int) -> None:
        self._add_purchased_space(size)

    def sub_purchased_space(self, size: int) -> None:
        ensure(self.purchased_space >= size, MOD, "Overflow")
        self.purchased_space -= size

    def delete_user_space_storage(self, acc: AccountId) -> None:
        """reference: lib.rs:698-712 — release the purchased allotment and
        drop the user's ledger entry (file cleanup is file-bank's job)."""
        info = self._space(acc)
        self.sub_purchased_space(info.total_space)
        del self.user_owned_space[acc]

    # -- lease-expiry sweep ---------------------------------------------

    def frozen_task(self) -> list[AccountId]:
        """Block sweep (reference: lib.rs:458-519): past deadline → frozen;
        past deadline + FrozenDays → dead, returned for file clearing."""
        now = self.state.block_number
        clear_list: list[AccountId] = []
        for acc, info in sorted(self.user_owned_space.items()):
            if now > info.deadline:
                if now > info.deadline + self.frozen_days_blocks:
                    info.state = SPACE_DEAD
                    clear_list.append(acc)
                elif info.state != SPACE_FROZEN:
                    info.state = SPACE_FROZEN
        return clear_list
