"""CDN cache market: cacher registry + download bills.

Re-design of the reference cacher pallet (reference:
c-pallets/cacher/src/{lib,types}.rs): cachers advertise a per-byte price;
users settle download bills with direct batch transfers.
"""

from __future__ import annotations

from dataclasses import dataclass

from .state import ChainState
from .types import AccountId, Balance, ensure

MOD = "cacher"

BILLS_LIMIT = 10


@dataclass
class CacherInfo:
    """reference: cacher/src/types.rs:9-15"""

    payee: AccountId
    ip: bytes
    byte_price: Balance


@dataclass
class Bill:
    """reference: cacher/src/types.rs:18-28"""

    id: bytes
    to: AccountId
    amount: Balance
    file_hash: str
    slice_hash: str
    expiration_time: int


class CacherPallet:
    def __init__(self, state: ChainState) -> None:
        self.state = state
        self.cachers: dict[AccountId, CacherInfo] = {}

    def register(self, sender: AccountId, info: CacherInfo) -> None:
        ensure(sender not in self.cachers, MOD, "AlreadyRegistered")
        self.cachers[sender] = info
        self.state.deposit_event(MOD, "Register", acc=sender)

    def update(self, sender: AccountId, info: CacherInfo) -> None:
        ensure(sender in self.cachers, MOD, "UnRegistered")
        self.cachers[sender] = info
        self.state.deposit_event(MOD, "Update", acc=sender)

    def logout(self, sender: AccountId) -> None:
        ensure(sender in self.cachers, MOD, "UnRegistered")
        del self.cachers[sender]
        self.state.deposit_event(MOD, "Logout", acc=sender)

    def pay(self, sender: AccountId, bills: list[Bill]) -> None:
        """Batch transfer settlement (reference: cacher/src/lib.rs:137-150)."""
        ensure(len(bills) <= BILLS_LIMIT, MOD, "LengthExceedsLimit")
        for bill in bills:
            self.state.balances.transfer(sender, bill.to, bill.amount)
        self.state.deposit_event(
            MOD, "Pay", acc=sender, count=len(bills)
        )
