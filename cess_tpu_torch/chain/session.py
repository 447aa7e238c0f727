"""Session pallet: keyed authority sessions driving era rotation.

Role match: stock `pallet_session` + `pallet_session::historical` as the
reference wires them (runtime/src/lib.rs:1484-1527, session keys feeding
the RRSC/GRANDPA/im-online authority sets; SessionsPerEra = 6 with 1 h
epochs, runtime/src/lib.rs:245).  Collapsed onto this framework's
deterministic runtime:

 * accounts register session keys (`set_keys`/`purge_keys` — the opaque
   SessionKeys blob role; here a single BLS public key per authority);
 * the session index advances every `session_length` blocks; every
   `sessions_per_era`-th rotation applies the pending OFFENCES
   (chain/offences.py — convictions defer to the era boundary so every
   replica slashes in the same block), ends the staking era, and runs
   the credit-weighted RRSC election (chain/rrsc.py) — which then
   already sees the fresh chills;
 * each rotation records the validator-set digest AND the set itself in
   `historical` / `historical_validators` (the
   pallet_session::historical root used for offence proofs: a report
   naming session s is only accepted if its offender was an authority
   in s) and notifies registered observers — the offences pallet's
   im-online liveness sweep rides this hook.
"""

from __future__ import annotations

import hashlib

from .state import ChainState
from .types import AccountId, ensure

MOD = "session"

# Sessions kept in `historical` / `historical_validators`: offence
# evidence older than this can no longer prove set membership and is
# refused (offences.REPORT_HISTORY_SESSIONS derives from this).
HISTORY_DEPTH_SESSIONS = 84


class SessionPallet:
    def __init__(
        self,
        state: ChainState,
        staking,
        rrsc,
        session_length: int,
        sessions_per_era: int = 6,
        offences=None,
    ) -> None:
        self.state = state
        self.staking = staking
        self.rrsc = rrsc
        self.offences = offences
        self.session_length = max(1, session_length)
        self.sessions_per_era = max(1, sessions_per_era)
        self.session_index: int = 0
        self.keys: dict[AccountId, bytes] = {}
        # session index -> hex digest of the active validator set (the
        # historical-root role for offence proofs) + the set itself
        # (membership checks for evidence-backed reports)
        self.historical: dict[int, str] = {}
        self.historical_validators: dict[int, list] = {}
        self._observers: list = []  # on_new_session(index, validators)

    # ------------------------------------------------------------ keys

    def set_keys(self, sender: AccountId, keys: bytes) -> None:
        """Register an authority's session keys (stock set_keys; the
        reference requires a bonded controller — same gate here)."""
        ensure(len(keys) > 0, MOD, "EmptyKeys")
        ensure(
            sender in self.staking.ledger or sender in self.staking.bonded.values(),
            MOD, "NoAssociatedValidatorId",
        )
        self.keys[sender] = bytes(keys)
        self.state.deposit_event(MOD, "KeysSet", who=sender)

    def purge_keys(self, sender: AccountId) -> None:
        ensure(sender in self.keys, MOD, "NoKeys")
        del self.keys[sender]
        self.state.deposit_event(MOD, "KeysPurged", who=sender)

    # ------------------------------------------------------------ views

    def session_of_block(self, height: int) -> int:
        """The session a block height executed in (rotations happen in
        the on_initialize of every session_length-th block, so block h
        belongs to session h // session_length) — the deterministic
        anchor that pins offence evidence to one session on every
        replica."""
        return max(0, int(height)) // self.session_length

    def validators_at(self, session: int) -> list | None:
        """Authority set of a (possibly past) session, or None when it
        is outside the historical window — the
        pallet_session::historical membership proof for offence
        reports."""
        if session == self.session_index:
            return list(self.staking.validators)
        return self.historical_validators.get(session)

    # ------------------------------------------------------------ hooks

    def add_observer(self, fn) -> None:
        """fn(session_index, ending_validator_set) at each rotation."""
        self._observers.append(fn)

    def validator_set_digest(self) -> str:
        h = hashlib.blake2b(digest_size=16)
        for v in sorted(self.staking.validators):
            h.update(v.encode() + b"\x00" + self.keys.get(v, b""))
        return h.hexdigest()

    def record_genesis_set(self) -> None:
        """Pin session 0's authority set (the runtime calls this after
        seating the genesis validators) so evidence against a genesis
        authority verifies before the first rotation."""
        self.historical[0] = self.validator_set_digest()
        self.historical_validators[0] = list(self.staking.validators)

    def on_initialize(self, now: int) -> None:
        if now % self.session_length != 0:
            return
        ending = list(self.staking.validators)
        for fn in self._observers:
            fn(self.session_index, ending)
        self.session_index += 1
        # era boundary every sessions_per_era sessions: convictions
        # apply FIRST (deferred offences land in this exact block on
        # every replica), then the era closes, then the election runs
        # with the chills already visible.
        if self.session_index % self.sessions_per_era == 0:
            if self.offences is not None:
                self.offences.apply_pending()
            self.staking.end_era()
            if self.staking.candidates:
                self.rrsc.rotate_epoch()
        self.historical[self.session_index] = self.validator_set_digest()
        self.historical_validators[self.session_index] = list(
            self.staking.validators
        )
        horizon = self.session_index - HISTORY_DEPTH_SESSIONS
        if horizon >= 0:
            self.historical.pop(horizon, None)
            self.historical_validators.pop(horizon, None)
        self.state.deposit_event(
            MOD, "NewSession", index=self.session_index
        )
