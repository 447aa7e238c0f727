"""OSS gateway registry + delegated-operator authorization.

Re-design of the reference oss pallet (reference: c-pallets/oss/src/lib.rs):
users authorize one operator account to act for them (upload/delete via
check_permission in file-bank), and gateway providers register an endpoint.
"""

from __future__ import annotations

from .state import ChainState
from .types import AccountId, ensure

MOD = "oss"


class OssPallet:
    def __init__(self, state: ChainState) -> None:
        self.state = state
        self.authority_list: dict[AccountId, AccountId] = {}  # owner -> operator
        self.oss: dict[AccountId, bytes] = {}  # account -> endpoint/peer id

    def authorize(self, sender: AccountId, operator: AccountId) -> None:
        """reference: oss/src/lib.rs:85-96 — one operator per owner
        (re-authorizing replaces)."""
        self.authority_list[sender] = operator
        self.state.deposit_event(MOD, "Authorize", acc=sender, operator=operator)

    def cancel_authorize(self, sender: AccountId) -> None:
        ensure(sender in self.authority_list, MOD, "NoAuthorization")
        del self.authority_list[sender]
        self.state.deposit_event(MOD, "CancelAuthorize", acc=sender)

    def register(self, sender: AccountId, endpoint: bytes) -> None:
        ensure(sender not in self.oss, MOD, "Registered")
        self.oss[sender] = endpoint
        self.state.deposit_event(MOD, "OssRegister", acc=sender, endpoint=endpoint)

    def update(self, sender: AccountId, endpoint: bytes) -> None:
        ensure(sender in self.oss, MOD, "UnRegister")
        self.oss[sender] = endpoint
        self.state.deposit_event(MOD, "OssUpdate", acc=sender, new_endpoint=endpoint)

    def destroy(self, sender: AccountId) -> None:
        ensure(sender in self.oss, MOD, "UnRegister")
        del self.oss[sender]
        self.state.deposit_event(MOD, "OssDestroy", acc=sender)

    # OssFindAuthor trait (reference: oss/src/lib.rs:161-172)
    def is_authorized(self, owner: AccountId, operator: AccountId) -> bool:
        return self.authority_list.get(owner) == operator
