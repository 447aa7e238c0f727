"""Checkpoint / resume: canonical state codec, state hash, snapshot.

The reference's chain database IS its checkpoint — nodes resume from the
persisted state trie, bootstrap via GRANDPA warp sync, and migrate
storage layouts on upgrade (reference: node/src/service.rs:259-263 warp
sync; c-pallets/audit/src/migrations.rs:9-41 versioned migrations;
node/src/cli.rs:48-66 ExportState/ImportBlocks).  This module provides
the equivalents for the framework's in-memory runtime:

 * `state_encode(rt)` — a CANONICAL, type-tagged byte encoding of every
   pallet's storage (sorted mappings, tuple/list distinguished, closed
   under the value types the pallets use).  Two runtimes that executed
   the same extrinsics encode identically, byte for byte.
 * `state_hash(rt)` — the sparse-Merkle root over the keyed leaves of
   that encoding (chain/smt.py, `state_leaves`): the replay-determinism
   anchor (same genesis + same extrinsics ⇒ same hash), asserted in
   tests/test_checkpoint.py.  This full rebuild is the bit-identity
   ORACLE for the incremental root the node maintains per block
   (chain/state.py StateDB — O(touched) instead of O(N)).
 * `snapshot(rt)` / `restore(rt, blob)` — ExportState/warp-sync shape.
   The blob is a VERSIONED header (magic + format version) over the
   canonical encoding: a pure data format with its own decoder — no
   pickle, so an untrusted blob can at worst fail to parse, never
   execute code.  Sync catch-up exchanges these blobs between nodes of
   possibly different builds, so `restore` upgrades older payloads
   through the MIGRATIONS registry (the storage-migration role,
   reference: c-pallets/audit/src/migrations.rs:9-41) and rejects
   blobs newer than this build.  Restoring loads the data into a
   FRESHLY CONSTRUCTED runtime (same genesis config); wiring — pallet
   cross-references, injected verifiers, backends — is re-created by
   construction and never travels.

Attribute classification is LOUD: plain data is captured; known
structural values (pallet cross-references, ChainState back-refs,
callables, the nested Balances/Agenda helpers) are skipped or recursed
by explicit rule; anything else raises, so a new pallet field of an
unsupported type fails tests instead of silently vanishing from the
hash.  (Off-chain actors' stores — the node sim's miner fragment stores
— are not chain state, exactly as miner disks are not part of the
reference's chain DB.)
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

from . import smt

_PALLETS = (
    "state",
    "sminer",
    "storage_handler",
    "oss",
    "cacher",
    "scheduler_credit",
    "staking",
    "session",
    "offences",
    "tee_worker",
    "file_bank",
    "audit",
    "rrsc",
    "evm",
    "fees",
)

# Nested data-bearing helpers the extractor recurses into.
_NESTED_TYPES = {"Balances", "Agenda"}

# Injected-callable slots: wiring, never state — excluded even when unset
# (None), so the hash does not depend on whether a verifier is plugged in.
# `_observers` (session) and `evidence_verifier` (offences) are runtime
# wiring re-created by construction; session observer callbacks and the
# node-layer evidence closure must never travel in a blob.
_WIRING_FIELDS = {
    "result_verifier", "cert_verifier", "_observers", "evidence_verifier",
}

# Offchain-local storage: per-node worker state (the reference keeps it
# in the offchain DB, not the state trie).  Each validator's OCW lock
# advances independently, so including it would make replica state
# hashes diverge the moment different authorities run their workers.
_OFFCHAIN_FIELDS = {"_ocw_lock"}

# PATH-scoped exclusions ("pallet.attribute"): `state.events` is the
# deposited-event sink (ChainState.events).  Events are DERIVED from
# execution — deterministic and bit-identical across replicas
# (asserted via chain_getEvents in the lockstep tests) — but they are
# the chain's audit trail, not its state, exactly as the reference
# keeps events in per-block storage outside the state trie; hashing
# them would also make the consensus hash grow with history instead of
# live state.  The node service drains them into a per-block ring
# (NodeService.events_by_block) at each commit.  Scoped by PATH, not
# bare name, so a future pallet attribute that happens to be called
# `events` still lands in the hash (or trips the loud classifier)
# instead of silently vanishing.
_EXCLUDED_PATHS = {"state.events"}


def _is_structural(value: Any) -> bool:
    """Pallet cross-references and similar wiring reachable from pallet
    attributes — reconstructed by Runtime.__init__, never serialized."""
    tname = type(value).__name__
    return (
        callable(value)
        or tname.endswith("Pallet")
        or tname in ("ChainState", "Runtime", "RuntimeConfig")
    )


def _is_data(value: Any) -> bool:
    if value is None or isinstance(value, (bool, int, str, bytes, float)):
        return True
    if isinstance(value, (list, tuple, set, frozenset)):
        return all(_is_data(v) for v in value)
    if isinstance(value, dict):
        return all(_is_data(k) and _is_data(v) for k, v in value.items())
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return all(
            _is_data(getattr(value, f.name))
            for f in dataclasses.fields(value)
        )
    return False


def _object_state(
    obj: Any, where: str,
    skip: "set[tuple[str, str]] | frozenset" = frozenset(),
) -> dict[str, Any]:
    """The data attributes of a pallet-like object.  Loud on anything
    that is neither data nor a recognized structural reference.  `skip`
    holds (pallet, dotted-attr) surfaces the caller tracks elsewhere
    (StateDB's write-through maps): they are dropped BEFORE the _is_data
    walk — validating a million-entry map the caller will discard is
    what made the per-commit compare-scan O(N)."""
    out = {}
    pallet, _, parent = where.partition(".")
    for name, value in vars(obj).items():
        if (name in _WIRING_FIELDS or name in _OFFCHAIN_FIELDS
                or f"{where}.{name}" in _EXCLUDED_PATHS):
            continue
        if skip and (
            pallet, f"{parent}.{name}" if parent else name
        ) in skip:
            continue
        if _is_data(value):
            out[name] = value
        elif _is_structural(value):
            continue
        elif type(value).__name__ in _NESTED_TYPES:
            out[name] = (
                "__nested__",
                type(value).__name__,
                _object_state(value, f"{where}.{name}", skip),
            )
        else:
            raise TypeError(
                f"{where}.{name}: {type(value).__name__} is neither chain "
                "state nor recognized wiring — extend checkpoint.py "
                "explicitly so it cannot be dropped silently"
            )
    return out


def _extract(
    rt, skip: "set[tuple[str, str]] | frozenset" = frozenset()
) -> dict[str, dict[str, Any]]:
    return {
        name: _object_state(getattr(rt, name), name, skip)
        for name in _PALLETS
    }


# ------------------------------------------------------------ keyed leaves
#
# The sparse-Merkle state commitment (chain/smt.py) hashes the SAME
# extracted surfaces, cut into keyed leaves: most pallet attributes are
# one leaf each (their canonical encoding is the leaf value), but the
# maps in KEYED_MAPS — the surfaces that grow with usage and that
# stateless clients read — get ONE LEAF PER ENTRY, so touching one
# account re-hashes one path instead of re-encoding a million, and an
# account/file/deal read is provable on its own.

# (pallet, attr) map attributes committed entry-by-entry.  Membership is
# CONSENSUS-CRITICAL: moving a map in or out changes every root.
KEYED_MAPS = {
    ("state", "balances.accounts"),
    ("state", "nonces"),
    ("file_bank", "deal_map"),
    ("file_bank", "file"),
}


def canon_bytes(value: Any) -> bytes:
    """One value through the canonical codec."""
    out: list[bytes] = []
    _canon(value, out)
    return b"".join(out)


def decode_value(enc: bytes) -> Any:
    """Inverse of canon_bytes (exactly one value, no trailing bytes)."""
    reader = _Reader(enc, _dataclass_registry())
    value = reader.read()
    if reader.off != len(enc):
        raise ValueError("trailing bytes in encoded value")
    return value


def leaf_label(pallet: str, attr: str) -> bytes:
    return f"{pallet}:{attr}".encode()


def _flatten_fields(
    pallet: str,
    prefix: str,
    fields: dict[str, Any],
    out: dict[bytes, tuple[str, str, bytes | None, bytes]],
    skip: set[tuple[str, str]],
) -> None:
    for name, value in fields.items():
        attr = f"{prefix}{name}"
        if (
            isinstance(value, (tuple, list))
            and len(value) == 3
            and value[0] == "__nested__"
        ):
            _flatten_fields(pallet, f"{attr}.", value[2], out, skip)
            continue
        if (pallet, attr) in skip:
            continue
        label = leaf_label(pallet, attr)
        if (pallet, attr) in KEYED_MAPS and isinstance(value, dict):
            for k, v in value.items():
                kenc = canon_bytes(k)
                out[smt.key_path(label, kenc)] = (
                    pallet, attr, kenc, canon_bytes(v),
                )
        else:
            out[smt.key_path(label)] = (pallet, attr, None, canon_bytes(value))


def state_leaves(
    rt=None,
    extract: dict[str, dict[str, Any]] | None = None,
    skip: set[tuple[str, str]] = frozenset(),
) -> dict[bytes, tuple[str, str, bytes | None, bytes]]:
    """Keyed-leaf view of the chain state: tree path → (pallet, attr,
    map-key encoding | None, value encoding).  Accepts either a live
    runtime or an already-decoded payload dict (blob verification)."""
    if extract is None:
        extract = _extract(rt, skip=set(skip))
    out: dict[bytes, tuple[str, str, bytes | None, bytes]] = {}
    for pallet, fields in extract.items():
        _flatten_fields(pallet, "", fields, out, set(skip))
    return out


def _leaves_root_hex(
    leaves: dict[bytes, tuple[str, str, bytes | None, bytes]]
) -> str:
    tree = smt.SparseMerkleTree({p: m[3] for p, m in leaves.items()})
    return tree.root().hex()


def verify_read(
    root_hex: str, pallet: str, attr: str, proof_wire: dict, key=None
) -> tuple[bool, Any]:
    """STATELESS read verification: check a served proof against a
    (justified) state root and return (present, decoded value) — no
    runtime, no tree, no local state.  Raises smt.ProofError on any
    proof that does not commit to the root."""
    label = leaf_label(pallet, attr)
    path = smt.key_path(label, b"" if key is None else canon_bytes(key))
    present, enc = smt.verify_proof(
        bytes.fromhex(root_hex), path, smt.Proof.from_wire(proof_wire)
    )
    return present, decode_value(enc) if present else None


def verify_read_batch(
    root_hex: str,
    reads: list[tuple[str, str, Any]],
    proof_wires: list[dict],
) -> list[tuple[bool, Any]]:
    """verify_read over a `state_getProofBatch` reply: one (present,
    value) per (pallet, attr, key) read, EVERY wire checked against the
    same root — the caller's justified anchor, not whatever root the
    server claims.  Raises smt.ProofError on the first wire that does
    not commit to it, and ValueError on a length mismatch (a server
    that answered a different batch)."""
    if len(reads) != len(proof_wires):
        raise ValueError(
            f"{len(proof_wires)} proofs for {len(reads)} reads"
        )
    return [
        verify_read(root_hex, pallet, attr, wire, key=key)
        for (pallet, attr, key), wire in zip(reads, proof_wires)
    ]


def _apply(obj: Any, data: dict[str, Any]) -> None:
    for name, value in data.items():
        if (
            isinstance(value, (tuple, list))
            and len(value) == 3
            and value[0] == "__nested__"
        ):
            _apply(getattr(obj, name), value[2])
        else:
            setattr(obj, name, value)


# ---------------------------------------------------------------- codec
# Type-tagged canonical serialization: N/B/I/F/S/Y scalars, L list,
# T tuple, E set, e frozenset, D dict (sorted), C dataclass.


def _canon(value: Any, out: list[bytes]) -> None:
    if value is None:
        out.append(b"N")
    elif isinstance(value, bool):
        out.append(b"B1" if value else b"B0")
    elif isinstance(value, int):
        raw = value.to_bytes(
            (value.bit_length() + 8) // 8 or 1, "big", signed=True
        )
        out.append(b"I" + len(raw).to_bytes(4, "big") + raw)
    elif isinstance(value, float):
        raw = repr(value).encode()
        out.append(b"F" + len(raw).to_bytes(2, "big") + raw)
    elif isinstance(value, str):
        raw = value.encode()
        out.append(b"S" + len(raw).to_bytes(4, "big") + raw)
    elif isinstance(value, bytes):
        out.append(b"Y" + len(value).to_bytes(4, "big") + value)
    elif isinstance(value, (list, tuple)):
        tag = b"L" if isinstance(value, list) else b"T"
        out.append(tag + len(value).to_bytes(4, "big"))
        for v in value:
            _canon(v, out)
    elif isinstance(value, (set, frozenset)):
        tag = b"E" if isinstance(value, set) else b"e"
        parts: list[bytes] = []
        for v in value:
            sub: list[bytes] = []
            _canon(v, sub)
            parts.append(b"".join(sub))
        parts.sort()
        out.append(tag + len(parts).to_bytes(4, "big") + b"".join(parts))
    elif isinstance(value, dict):
        items: list[tuple[bytes, Any]] = []
        for k, v in value.items():
            sub: list[bytes] = []
            _canon(k, sub)
            items.append((b"".join(sub), v))
        items.sort(key=lambda kv: kv[0])
        out.append(b"D" + len(items).to_bytes(4, "big"))
        for kraw, v in items:
            out.append(kraw)
            _canon(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        fields = dataclasses.fields(value)
        cname = type(value).__name__.encode()
        out.append(
            b"C"
            + len(cname).to_bytes(1, "big")
            + cname
            + len(fields).to_bytes(2, "big")
        )
        for f in fields:
            _canon(f.name, out)
            _canon(getattr(value, f.name), out)
    else:  # pragma: no cover - _object_state filters these out
        raise TypeError(f"non-canonical value {type(value)!r}")


class _Reader:
    def __init__(self, data: bytes, registry: dict[str, type]) -> None:
        self.data = data
        self.off = 0
        self.registry = registry

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("truncated snapshot")
        out = self.data[self.off : self.off + n]
        self.off += n
        return out

    def read(self) -> Any:
        tag = self.take(1)
        if tag == b"N":
            return None
        if tag == b"B":
            return self.take(1) == b"1"
        if tag == b"I":
            n = int.from_bytes(self.take(4), "big")
            return int.from_bytes(self.take(n), "big", signed=True)
        if tag == b"F":
            n = int.from_bytes(self.take(2), "big")
            # cesslint: allow[det-float] decoder for the F tag: the
            # encoder wrote repr(x), and float(repr(x)) round-trips
            # bit-exactly on every IEEE-754 platform
            return float(self.take(n).decode())
        if tag == b"S":
            n = int.from_bytes(self.take(4), "big")
            return self.take(n).decode()
        if tag == b"Y":
            n = int.from_bytes(self.take(4), "big")
            return self.take(n)
        if tag in (b"L", b"T"):
            n = int.from_bytes(self.take(4), "big")
            items = [self.read() for _ in range(n)]
            return items if tag == b"L" else tuple(items)
        if tag in (b"E", b"e"):
            n = int.from_bytes(self.take(4), "big")
            items = {self.read() for _ in range(n)}
            return items if tag == b"E" else frozenset(items)
        if tag == b"D":
            n = int.from_bytes(self.take(4), "big")
            out = {}
            for _ in range(n):
                k = self.read()
                out[k] = self.read()
            return out
        if tag == b"C":
            cn = int.from_bytes(self.take(1), "big")
            cname = self.take(cn).decode()
            nfields = int.from_bytes(self.take(2), "big")
            fields = {}
            for _ in range(nfields):
                fname = self.read()
                fields[fname] = self.read()
            cls = self.registry.get(cname)
            if cls is None:
                raise ValueError(f"unknown dataclass {cname!r} in snapshot")
            return cls(**fields)
        raise ValueError(f"bad tag {tag!r} in snapshot")


def _dataclass_registry() -> dict[str, type]:
    """name → class for every dataclass defined in the chain package (the
    value types pallet storages hold)."""
    import importlib
    import pkgutil

    pkg = importlib.import_module(__package__)

    out: dict[str, type] = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{__package__}.{info.name}")
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                out[obj.__name__] = obj
    return out


# ------------------------------------------------------------ versioning
#
# Snapshot blobs travel between nodes (sync_checkpoint catch-up) and
# across builds (export-state files), so the format is version-tagged:
#
#   MAGIC ‖ u16 version ‖ canonical payload
#
# v1: bare canonical encoding, no header (the original format — still
#     accepted on read).
# v2: header introduced; payload layout unchanged.
# v3: VRF consensus state on the rrsc pallet (epoch-randomness
#     accumulator + fold count, cess_tpu/consensus) — epoch randomness
#     became accumulated consensus state instead of a derived snapshot.
# v4: session + offences pallets entered the replicated state
#     (chain/{session,offences}.py — session clock, historical
#     authority sets, heartbeat record, offence registry/strikes, and
#     staking's chill register).
# v5: the deposited-event sink left the consensus state (events are
#     the audit trail, kept per block outside the state hash —
#     see _OFFCHAIN_FIELDS); blobs no longer carry state.events.
# v6: the fees pallet entered the replicated state (chain/fees.py —
#     per-block fee escrow, lifetime fee totals, per-author payout
#     ledger for the 20/80 treasury/author split).
# v7: the state hash became the sparse-Merkle ROOT over keyed leaves
#     (chain/smt.py + state_leaves) instead of sha256 of the flat
#     encoding.  The blob payload layout is UNCHANGED (the migration is
#     the identity) but every state_hash a block commits to is
#     re-rooted, so v7 is consensus-incompatible with v6 heads
#     (SYNC_PROTO_VERSION bumped alongside).
#
# MIGRATIONS[v] upgrades a decoded v payload dict to v+1; restore runs
# the chain v → FORMAT_VERSION, so any supported older blob loads into
# the current runtime (the on_runtime_upgrade role, reference:
# c-pallets/audit/src/migrations.rs:9-41).  Later format bumps add an
# entry here instead of breaking old fixtures.

MAGIC = b"CESSCKPT"
FORMAT_VERSION = 7


def _migrate_v1_to_v2(data: dict) -> dict:
    """v2 introduced the versioned header; the payload itself is
    unchanged, so the migration is the identity on the decoded dict."""
    return data


def _migrate_v2_to_v3(data: dict) -> dict:
    """Pre-VRF blobs carry no accumulator: seed it empty with a zero
    fold count, which rrsc.rotate_epoch reads as "no VRF-bearing blocks
    yet" and keeps the old hash-chain rotation until outputs arrive."""
    rrsc = data.get("rrsc")
    if isinstance(rrsc, dict):
        rrsc.setdefault("vrf_accumulator", bytes(32))
        rrsc.setdefault("vrf_fold_count", 0)
    return data


def _migrate_v3_to_v4(data: dict) -> dict:
    """Pre-offences blobs carry no session/offences pallets: seed both
    EXPLICITLY empty (not merely absent) so a migrated blob restores to
    the same state on every replica regardless of what the receiving
    runtime held before — a fresh session clock, no heartbeats, no
    offences, no chills.  (session_length/sessions_per_era stay as the
    receiving runtime's genesis config derived them — consensus
    parameters, not snapshot state.)"""
    if "session" not in data:
        data["session"] = {
            "session_index": 0, "keys": {}, "historical": {},
            "historical_validators": {},
        }
    if "offences" not in data:
        data["offences"] = {
            "reports": {}, "pending": [], "heartbeats": {}, "strikes": {},
        }
    staking = data.get("staking")
    if isinstance(staking, dict):
        staking.setdefault("chilled_until", {})
    return data


def _migrate_v4_to_v5(data: dict) -> dict:
    """v4 blobs carried the cumulative event sink inside the state
    payload; v5 moved events outside the consensus state (they are
    per-block telemetry, not state), so the restored runtime starts
    with an empty sink — the per-block event ring is node bookkeeping
    rebuilt as blocks execute."""
    state = data.get("state")
    if isinstance(state, dict):
        state.pop("events", None)
    return data


def _migrate_v5_to_v6(data: dict) -> dict:
    """Pre-fee-market blobs carry no fees pallet: seed it EXPLICITLY
    zeroed (mirroring _migrate_v3_to_v4's explicit-empty rule) so a
    migrated blob restores to the same state on every replica.  The
    fee constants (base_fee / fee_per_weight / block_weight_limit) are
    genesis config, not snapshot state — the receiving runtime's values
    stand, exactly like session_length."""
    if "fees" not in data:
        data["fees"] = {
            "block_fees": 0, "total_fees": 0,
            "paid_author": {}, "paid_treasury": 0,
        }
    return data


def _migrate_v6_to_v7(data: dict) -> dict:
    """v7 re-rooted the state hash (sparse-Merkle root over keyed
    leaves) without touching the payload layout: the migration is the
    identity on the decoded dict, and the receiving node derives the
    new root from the restored state."""
    return data


MIGRATIONS = {1: _migrate_v1_to_v2, 2: _migrate_v2_to_v3,
              3: _migrate_v3_to_v4, 4: _migrate_v4_to_v5,
              5: _migrate_v5_to_v6, 6: _migrate_v6_to_v7}


# ---------------------------------------------------------------- API


def state_encode(rt) -> bytes:
    out: list[bytes] = []
    _canon(_extract(rt), out)
    return b"".join(out)


def state_hash(rt) -> str:
    """Deterministic hex digest of the full chain state: the sparse-
    Merkle root over the keyed leaves (header-independent, and the
    FULL-REBUILD bit-identity oracle for the incremental StateDB root
    in chain/state.py)."""
    return _leaves_root_hex(state_leaves(rt))


def encode_events(events: list) -> bytes:
    """Canonical byte encoding of a deposited-event list (the same
    type-tagged codec the state hash uses).  Replicas that executed
    one block identically encode its events byte-for-byte identically
    — the bit-identity contract `chain_getEvents` is asserted on."""
    out: list[bytes] = []
    _canon(list(events), out)
    return b"".join(out)


def events_digest(events: list) -> str:
    """blake2b-256 over encode_events — the per-block event commitment
    served next to the event list so replicas can be diffed cheaply."""
    return hashlib.blake2b(
        encode_events(events), digest_size=32
    ).hexdigest()


def snapshot(rt) -> bytes:
    """Serialized chain state (the ExportState role): versioned header
    over the canonical encoding."""
    return snapshot_and_hash(rt)[0]


def snapshot_and_hash(rt) -> tuple[bytes, str]:
    """One extraction pass for callers that need both the blob and the
    state hash (genesis, checkpoint cadence, export-state): the hash is
    the sparse-Merkle root over the same extracted surfaces the blob
    encodes."""
    extract = _extract(rt)
    out: list[bytes] = []
    _canon(extract, out)
    payload = b"".join(out)
    header = MAGIC + FORMAT_VERSION.to_bytes(2, "big")
    return header + payload, _leaves_root_hex(state_leaves(extract=extract))


def blob_payload_hash(blob: bytes) -> str:
    """State hash a CURRENT-version blob's payload commits to — the
    integrity gate the on-disk store (node/store.py) runs before
    restoring a checkpoint: the value must equal the state_hash the
    signed head block commits to, so a torn or bit-flipped checkpoint
    file fails closed before any restore work.  Since v7 this decodes
    the payload and roots its keyed leaves (checkpoint-cadence cost,
    never per block).  Only meaningful for FORMAT_VERSION blobs (older
    versions hash differently after migration); anything else raises."""
    if not blob.startswith(MAGIC):
        raise ValueError("headerless blob has no comparable payload hash")
    version = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 2], "big")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"payload hash is version-bound (blob v{version}, "
            f"build v{FORMAT_VERSION})"
        )
    payload = blob[len(MAGIC) + 2:]
    reader = _Reader(payload, _dataclass_registry())
    data = reader.read()
    if reader.off != len(payload):
        raise ValueError("trailing bytes in snapshot")
    if not isinstance(data, dict):
        raise ValueError("snapshot payload is not a state mapping")
    return _leaves_root_hex(state_leaves(extract=data))


def decode_blob(blob: bytes) -> tuple[int, dict]:
    """Parse a snapshot blob → (version, payload dict), migrations NOT
    yet applied.  Headerless blobs are v1 (the pre-header format)."""
    version = 1
    if blob.startswith(MAGIC):
        version = int.from_bytes(blob[len(MAGIC):len(MAGIC) + 2], "big")
        blob = blob[len(MAGIC) + 2:]
    reader = _Reader(blob, _dataclass_registry())
    data = reader.read()
    if reader.off != len(blob):
        raise ValueError("trailing bytes in snapshot")
    if not isinstance(data, dict):
        raise ValueError("snapshot payload is not a state mapping")
    return version, data


def restore(rt, blob: bytes) -> None:
    """Load a snapshot into a freshly constructed runtime (same genesis
    config), upgrading older format versions through MIGRATIONS.
    Wiring (pallet cross-refs, verifiers, backend) stays as the fresh
    construction made it; only data state is replaced.  The blob is
    parsed by the canonical decoder — malformed input raises ValueError,
    nothing in the format can execute code."""
    version, data = decode_blob(blob)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"snapshot format v{version} is newer than this build "
            f"(v{FORMAT_VERSION})"
        )
    while version < FORMAT_VERSION:
        migrate = MIGRATIONS.get(version)
        if migrate is None:
            raise ValueError(f"no migration from snapshot format v{version}")
        data = migrate(data)
        version += 1
    for name, fields in data.items():
        _apply(getattr(rt, name), fields)
