"""Shared chain state: block clock, balances, events, delayed-call agenda.

This is the replicated-state-machine substrate of the framework (SURVEY.md §2
"replicated state machine"): one deterministic in-memory state advanced block
by block.  It replaces frame_system + pallet-balances + pallet-scheduler from
the reference runtime (reference: runtime/src/lib.rs:1477-1538) with the
minimum the storage protocol needs:

 * block number clock,
 * free/reserved balance ledger with pot (pallet-id) accounts,
 * event sink,
 * a named delayed-call agenda reproducing the scheduler-pallet pattern the
   file-bank deal lifecycle relies on (reference:
   c-pallets/file-bank/src/functions.rs:165-199 schedules deal_reassign_miner
   and calculate_end at future blocks, cancellable by name).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable

from .types import AccountId, Balance, BlockNumber, DispatchError, Event, ensure

MOD = "balances"


@dataclass
class AccountData:
    free: Balance = 0
    reserved: Balance = 0


class Balances:
    """free/reserved ledger with the Currency trait surface the pallets use."""

    def __init__(self, state: "ChainState") -> None:
        self._state = state
        self.accounts: dict[AccountId, AccountData] = {}
        self.total_issuance: Balance = 0

    def account(self, who: AccountId) -> AccountData:
        """Read-only view: a mere balance READ (RPC query, fee estimate,
        can_slash probe) must not perturb the state commitment, so an
        absent account yields a DETACHED zero record — never an
        insertion.  Mutators go through _mutable."""
        acct = self.accounts.get(who)
        return AccountData() if acct is None else acct

    def _mutable(self, who: AccountId) -> AccountData:
        """The write path: inserts the record if absent and marks the
        key dirty for the state trie's write-through tracking."""
        acct = self.accounts.setdefault(who, AccountData())
        touch = getattr(self.accounts, "touch", None)
        if touch is not None:
            touch(who)
        return acct

    def free(self, who: AccountId) -> Balance:
        return self.account(who).free

    def reserved(self, who: AccountId) -> Balance:
        return self.account(who).reserved

    def mint(self, who: AccountId, amount: Balance) -> None:
        """Genesis / reward issuance (resolve_creating in the reference)."""
        self._mutable(who).free += amount
        self.total_issuance += amount

    def burn(self, who: AccountId, amount: Balance) -> None:
        acct = self._mutable(who)
        ensure(acct.free >= amount, MOD, "InsufficientBalance")
        acct.free -= amount
        self.total_issuance -= amount

    def can_slash(self, who: AccountId, amount: Balance) -> bool:
        return self.free(who) >= amount

    def transfer(self, src: AccountId, dst: AccountId, amount: Balance) -> None:
        ensure(amount >= 0, MOD, "NegativeTransfer")
        a = self._mutable(src)
        ensure(a.free >= amount, MOD, "InsufficientBalance")
        a.free -= amount
        self._mutable(dst).free += amount

    def reserve(self, who: AccountId, amount: Balance) -> None:
        a = self._mutable(who)
        ensure(a.free >= amount, MOD, "InsufficientBalance")
        a.free -= amount
        a.reserved += amount

    def unreserve(self, who: AccountId, amount: Balance) -> Balance:
        """Moves up to `amount` back to free; returns what was actually moved
        (Substrate's unreserve saturates rather than erroring)."""
        a = self._mutable(who)
        moved = min(a.reserved, amount)
        a.reserved -= moved
        a.free += moved
        return moved

    def slash_reserved(
        self, who: AccountId, dst: AccountId, amount: Balance
    ) -> Balance:
        """Take up to `amount` of who's RESERVED balance and credit it to
        `dst` (the Currency::slash_reserved + OnUnbalanced-to-treasury
        route offence slashing uses).  Saturates like unreserve; returns
        what was actually taken."""
        a = self._mutable(who)
        taken = min(a.reserved, amount)
        a.reserved -= taken
        self._mutable(dst).free += taken
        return taken


@dataclass
class ScheduledCall:
    """A named delayed call: (pallet, method, args) dispatched as root."""

    name: str
    pallet: str
    method: str
    args: tuple


class Agenda:
    """pallet-scheduler equivalent: named calls executed at a target block."""

    def __init__(self) -> None:
        self._by_block: dict[BlockNumber, list[ScheduledCall]] = {}
        self._names: dict[str, BlockNumber] = {}

    def schedule_named(
        self, name: str, at: BlockNumber, pallet: str, method: str, *args
    ) -> None:
        ensure(name not in self._names, "scheduler", "AlreadyScheduled", name)
        self._by_block.setdefault(at, []).append(
            ScheduledCall(name, pallet, method, args)
        )
        self._names[name] = at

    def cancel_named(self, name: str) -> bool:
        at = self._names.pop(name, None)
        if at is None:
            return False
        self._by_block[at] = [c for c in self._by_block[at] if c.name != name]
        return True

    def take_due(self, block: BlockNumber) -> list[ScheduledCall]:
        calls = self._by_block.pop(block, [])
        for c in calls:
            self._names.pop(c.name, None)
        return calls

    def is_scheduled(self, name: str) -> bool:
        return name in self._names


class ChainState:
    """The one shared state object every pallet operates on."""

    def __init__(self) -> None:
        self.block_number: BlockNumber = 0
        self.events: list[Event] = []
        self.balances = Balances(self)
        self.agenda = Agenda()
        # Consensus account nonces (frame_system::AccountInfo.nonce role):
        # advanced only by block application, so every replica agrees and
        # a signed extrinsic can never be replayed into a later block.
        # Distinct from the node-local pool-intake high-water marks.
        self.nonces: dict[str, int] = {}
        # Per-block shared randomness (parent-block randomness in the
        # reference, supplied by RRSC — reference: runtime/src/lib.rs:1003).
        self.randomness: bytes = bytes(32)

    # -- events ---------------------------------------------------------

    def deposit_event(self, pallet: str, name: str, **fields) -> None:
        self.events.append(Event.of(pallet, name, **fields))

    def events_of(self, pallet: str, name: str | None = None) -> list[Event]:
        return [
            e
            for e in self.events
            if e.pallet == pallet and (name is None or e.name == name)
        ]

    def event_mark(self) -> int:
        """Cursor into the append-only sink: take before executing a
        block, pass to events_since after — the node service files the
        slice into its per-block ring (chain_getEvents).  Events are
        deterministic replica-identical telemetry but live OUTSIDE the
        consensus state hash (chain/checkpoint.py excludes the sink),
        exactly as the reference keeps events out of the state trie."""
        return len(self.events)

    def events_since(self, mark: int) -> list[Event]:
        return list(self.events[mark:])

    def clear_events(self) -> None:
        self.events.clear()


# ------------------------------------------------------- state commitment


class DirtyDict(dict):
    """dict that records touched keys: the write-through tracking layer
    for keyed state-trie maps.  Entry-level operations are intercepted
    here; IN-PLACE mutation of a mutable value (AccountData) is marked
    by the owning mutator via touch() — Balances._mutable does."""

    __slots__ = ("dirty",)

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.dirty: set = set()

    def touch(self, key) -> None:
        self.dirty.add(key)

    def __setitem__(self, key, value) -> None:
        self.dirty.add(key)
        super().__setitem__(key, value)

    def __delitem__(self, key) -> None:
        self.dirty.add(key)
        super().__delitem__(key)

    def setdefault(self, key, default=None):
        if key not in self:
            self.dirty.add(key)
        return super().setdefault(key, default)

    def pop(self, key, *default):
        self.dirty.add(key)
        return super().pop(key, *default)

    def popitem(self):
        key, value = super().popitem()
        self.dirty.add(key)
        return key, value

    def clear(self) -> None:
        self.dirty.update(self.keys())
        super().clear()

    def update(self, *args, **kwargs) -> None:
        merged = dict(*args, **kwargs)
        self.dirty.update(merged.keys())
        super().update(merged)


# The one map big enough to need write-through tracking instead of a
# per-commit compare scan.  Must stay in checkpoint.KEYED_MAPS.
WRITE_THROUGH = ("state", "balances.accounts")

# A state delta is a list of leaf-level changes
#   (pallet, attr, map_key_enc | None, old_enc | None, new_enc | None)
# (encodings from checkpoint's canonical codec; None key = whole-attr
# leaf; None old/new = leaf created/deleted).  Deltas both revert AND
# reapply a block — the node's reorg buffer and the store's per-block
# journal records between full checkpoints.

DeltaEntry = tuple[str, str, bytes | None, bytes | None, bytes | None]


def encode_delta(delta: list[DeltaEntry]) -> list[list]:
    """JSON-safe wire form (the store journals deltas as canonical
    JSON): byte encodings become hex."""
    def hx(b: bytes | None) -> str | None:
        return None if b is None else b.hex()

    return [[p, a, hx(k), hx(o), hx(n)] for p, a, k, o, n in delta]


def decode_delta(wire: list) -> list[DeltaEntry]:
    def unhx(s: str | None) -> bytes | None:
        return None if s is None else bytes.fromhex(s)

    return [
        (str(p), str(a), unhx(k), unhx(o), unhx(n))
        for p, a, k, o, n in wire
    ]


class StateDB:
    """Write-through state-commitment layer: the sparse-Merkle tree
    (chain/smt.py) over checkpoint.state_leaves, kept INCREMENTALLY.

    Per committed block the root costs O(touched · log N): the
    write-through map (balances.accounts — the surface that reaches
    millions of entries) contributes only its dirty keys, every other
    pallet surface is compare-scanned against cached encodings (cheap:
    those surfaces are small), and the tree rehashes only the dirty
    paths.  `checkpoint.state_hash` (full rebuild) stays the
    bit-identity oracle — checked at checkpoint cadence by the node,
    and every commit under CESS_STATE_ORACLE=1 (the test harness)."""

    def __init__(self, rt) -> None:
        self.rt = rt
        self._oracle = os.environ.get(  # cesslint: allow[det-env] debug-only oracle re-check; the root itself is env-independent and the oracle only ever raises on divergence
            "CESS_STATE_ORACLE", "") not in ("", "0", "false")
        self.rebase()

    # -- full rebuild ---------------------------------------------------

    def rebase(self) -> str:
        """Full rebuild from the live runtime — the landing point for
        every wholesale state replacement (restore/warp/import-state).
        O(N); per-block commits never come through here."""
        from . import checkpoint, smt

        leaves = checkpoint.state_leaves(self.rt)
        self._enc: dict[bytes, bytes] = {}
        self._meta: dict[bytes, tuple[str, str, bytes | None]] = {}
        self._scan_paths: set[bytes] = set()
        for path, (pallet, attr, kenc, enc) in leaves.items():
            self._enc[path] = enc
            self._meta[path] = (pallet, attr, kenc)
            if (pallet, attr) != WRITE_THROUGH:
                self._scan_paths.add(path)
        self.smt = smt.SparseMerkleTree(self._enc)
        accounts = self.rt.state.balances.accounts
        if not isinstance(accounts, DirtyDict):
            self.rt.state.balances.accounts = DirtyDict(accounts)
        self.rt.state.balances.accounts.dirty.clear()
        return self.root_hex()

    def root(self) -> bytes:
        return self.smt.root()

    def root_hex(self) -> str:
        return self.smt.root().hex()

    def leaf_encodings(self) -> dict[bytes, bytes]:
        """Snapshot of path → value encoding for every leaf — the seed
        of a read replica's FINALIZED view (light/replica.py), which
        from there advances by per-block deltas only."""
        return dict(self._enc)

    def check_oracle(self) -> str:
        """Assert the incremental root equals the full-rebuild oracle —
        loud, because a divergence means the dirty tracking missed a
        write and replicas could be committing to a stale surface."""
        from . import checkpoint

        want = checkpoint.state_hash(self.rt)
        got = self.root_hex()
        if want != got:
            raise RuntimeError(
                f"state-trie divergence: incremental root {got} != "
                f"full-rebuild oracle {want}"
            )
        return got

    # -- per-block commit ----------------------------------------------

    def commit(self) -> tuple[str, list[DeltaEntry]]:
        """Fold everything written since the last commit into the tree:
        returns (new root hex, delta).  O(touched · log N) plus a scan
        of the small non-write-through surfaces."""
        from . import checkpoint, smt as _smt

        writes: dict[bytes, bytes | None] = {}
        delta: list[DeltaEntry] = []
        accounts = self.rt.state.balances.accounts
        label = checkpoint.leaf_label(*WRITE_THROUGH)
        dirty = (
            accounts.dirty if isinstance(accounts, DirtyDict)
            else set(accounts)
        )
        for who in dirty:
            kenc = checkpoint.canon_bytes(who)
            path = _smt.key_path(label, kenc)
            new = (
                checkpoint.canon_bytes(accounts[who])
                if who in accounts else None
            )
            old = self._enc.get(path)
            if new != old:
                delta.append((*WRITE_THROUGH, kenc, old, new))
                writes[path] = new
                self._meta[path] = (*WRITE_THROUGH, kenc)
        if isinstance(accounts, DirtyDict):
            accounts.dirty.clear()
        current = checkpoint.state_leaves(self.rt, skip={WRITE_THROUGH})
        for path, (pallet, attr, kenc, enc) in current.items():
            if self._enc.get(path) != enc:
                delta.append((pallet, attr, kenc, self._enc.get(path), enc))
                writes[path] = enc
                self._meta[path] = (pallet, attr, kenc)
                self._scan_paths.add(path)
        for path in self._scan_paths - current.keys():
            pallet, attr, kenc = self._meta[path]
            delta.append((pallet, attr, kenc, self._enc[path], None))
            writes[path] = None
        root = self._write(writes)
        if self._oracle:
            self.check_oracle()
        return root.hex(), delta

    def _write(self, writes: dict[bytes, bytes | None]) -> bytes:
        if not writes:
            return self.smt.root()
        for path, enc in writes.items():
            if enc is None:
                self._enc.pop(path, None)
                self._meta.pop(path, None)
                self._scan_paths.discard(path)
            else:
                self._enc[path] = enc
        return self.smt.update(writes)

    # -- delta apply / revert ------------------------------------------

    def apply(self, delta: list[DeltaEntry]) -> str:
        """Reapply a recorded delta (reinstate a rolled-back head,
        journal fast-forward): mutates the runtime AND the tree."""
        return self._shift(delta, forward=True)

    def revert(self, delta: list[DeltaEntry]) -> str:
        """Undo a recorded delta (fork-choice rollback, failed-import
        unwind): bit-exact inverse of the commit that produced it."""
        return self._shift(delta, forward=False)

    def _shift(self, delta: list[DeltaEntry], forward: bool) -> str:
        # Two-phase for atomicity: decode every value and resolve every
        # target object FIRST (anything malformed raises here, with the
        # runtime untouched), then perform the pure assignments, which
        # cannot fail — a corrupt journal delta must never leave the
        # runtime half-mutated.
        from . import checkpoint, smt as _smt

        writes: dict[bytes, bytes | None] = {}
        staged: list = []
        for pallet, attr, kenc, old, new in delta:
            enc = new if forward else old
            label = checkpoint.leaf_label(pallet, attr)
            path = _smt.key_path(label, kenc if kenc is not None else b"")
            obj = getattr(self.rt, pallet)
            parts = attr.split(".")
            for part in parts[:-1]:
                obj = getattr(obj, part)
            if kenc is None:
                if enc is None:
                    raise ValueError(
                        f"delta deletes whole attribute {pallet}.{attr}"
                    )
                staged.append(
                    ("set", obj, parts[-1], checkpoint.decode_value(enc)))
            else:
                mapping = getattr(obj, parts[-1])
                if not isinstance(mapping, dict):
                    raise ValueError(
                        f"{pallet}.{attr} is not a keyed map")
                key = checkpoint.decode_value(kenc)
                if enc is None:
                    staged.append(("pop", mapping, key, None))
                else:
                    staged.append(
                        ("put", mapping, key, checkpoint.decode_value(enc)))
            writes[path] = enc
            if enc is not None:
                staged.append(("meta", path, (pallet, attr, kenc),
                               (pallet, attr) != WRITE_THROUGH))
        for op, target, key, value in staged:
            if op == "set":
                setattr(target, key, value)
            elif op == "pop":
                target.pop(key, None)
            elif op == "put":
                target[key] = value
            else:  # meta
                self._meta[target] = key
                if value:
                    self._scan_paths.add(target)
        root = self._write(writes)
        accounts = self.rt.state.balances.accounts
        if isinstance(accounts, DirtyDict):
            # the mutations above went through the wrapper; the tree is
            # already in lockstep, so drop the marks
            accounts.dirty.clear()
        return root.hex()

    # -- proofs ---------------------------------------------------------

    def prove(self, pallet: str, attr: str, key=None) -> dict:
        """Read proof for one keyed entry (key required for KEYED_MAPS
        surfaces) or one whole-attribute leaf (key must be None)."""
        from . import checkpoint, smt as _smt

        keyed = (pallet, attr) in checkpoint.KEYED_MAPS
        if keyed != (key is not None):
            raise ValueError(
                f"{pallet}.{attr} is {'a keyed map' if keyed else 'one leaf'}"
                f" — key {'required' if keyed else 'must be omitted'}"
            )
        label = checkpoint.leaf_label(pallet, attr)
        kenc = b"" if key is None else checkpoint.canon_bytes(key)
        path = _smt.key_path(label, kenc)
        value = self.smt.get(path)
        return {
            "root": self.root_hex(),
            "path": path.hex(),
            "proof": self.smt.prove(path).to_wire(),
            "value": None if value is None else value.hex(),
        }
