"""Crash-safe on-disk node store: block journal + atomic checkpoints.

The reference validator survives `kill -9` because its chain lives in
RocksDB-backed Substrate storage (reference: node/src/service.rs — the
client database); this module is that durability layer for the
framework's in-memory runtime, under `--data-dir` (node/cli.py):

 * **Write-ahead block journal** (`journal/seg-%08d.wal`): one
   length-prefixed, blake2b-checksummed record per committed block —
   header + extrinsics (the full signed Block wire form), the block's
   deposited-events digest, its keyed state delta (chain/state.py —
   replay applies the delta and checks the resulting trie root against
   the signed header, skipping re-execution when it matches), and any
   justification known at commit — fsync'd BEFORE the block is
   acknowledged to the network
   (NodeService._commit_block runs the append under the service lock,
   ahead of the gossip announce).  Finality advancing later appends a
   justification record, so replay recovers the finalized head too.
   Segments rotate at SEGMENT_MAX_BYTES and are pruned once every
   record they hold is at or below the last durable checkpoint.

 * **Atomic checkpoints** (`checkpoints/ckpt-*.bin` + `MANIFEST.json`):
   the versioned chain/checkpoint.py blobs, written temp-file → fsync →
   `os.rename`, with a manifest (itself renamed atomically) pointing at
   the newest valid blob and keeping one predecessor.  A crash at any
   byte offset leaves the old manifest or the new one — never a torn
   checkpoint reachable from either.

 * **Recovery ladder** (`recover()`): newest valid checkpoint (blob
   payload hash must equal the signed head's state_hash — a flipped
   bit fails closed to the older checkpoint) → journal replay through
   the DETERMINISTIC IMPORT PATH (NodeService.import_block — the same
   author-signature / VRF-claim / re-execution / state-hash
   verification node/sync.py catch-up uses, so a tampered journal can
   reject but never smuggle state) → truncate the journal at the first
   checksum-invalid or short record (and drop later segments — their
   continuity is gone) → whatever is still missing falls to the
   existing peer catch-up / warp sync when the sync loop starts.
   Every rung emits trace events and `cess_store_*` metrics.

 * **Fault discipline**: every write path catches OSError (real ENOSPC
   or the injected storage faults of node/faults.py), repairs the tail
   it may have torn, bumps `cess_store_write_errors`, and marks the
   store DEGRADED instead of raising — the node keeps authoring and
   importing from memory (`system_health.storageDegraded`), and the
   flag clears on the next successful append.

Scope cuts vs the reference's RocksDB/paritydb are recorded in
docs/persistence.md (whole-state checkpoints instead of a keyed trie,
JSON record bodies, no background compaction).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import threading

from ..chain import checkpoint
from . import metrics as m
from .sync import Block, BlockImportError, Justification, SyncGap, \
    canonical_json

# Journal record wire format (docs/persistence.md):
#   u32 body_len (big-endian) ‖ body ‖ blake2b-16(body)
# The length field is NOT covered by the checksum; a flipped length
# byte either points past EOF (short record) or misframes the body so
# the checksum fails — both read as "truncate here", never as a torn
# record accepted (tests/test_persistence.py tortures every byte).
_LEN_BYTES = 4
_SUM_BYTES = 16

# Rotate the active journal segment past this size: bounds the bytes a
# single truncation can discard and keeps pruning granular.
SEGMENT_MAX_BYTES = 4 << 20

# Checkpoints kept reachable from the manifest: the newest plus one
# predecessor (the fall-back rung when the newest blob fails its
# payload-hash check after a torn checkpoint write).
CHECKPOINT_KEEP = 2

_SEG_RE = re.compile(r"^seg-(\d{8})\.wal$")
_MANIFEST = "MANIFEST.json"


def _record_sum(body: bytes) -> bytes:
    return hashlib.blake2b(body, digest_size=_SUM_BYTES).digest()


def encode_record(body: bytes) -> bytes:
    """One journal record's wire bytes."""
    return len(body).to_bytes(_LEN_BYTES, "big") + body + _record_sum(body)


def scan_records(data: bytes) -> tuple[list[bytes], int]:
    """Parse a segment's bytes into record bodies.  Returns (bodies,
    valid_len): the bodies of every intact record in order, and the
    byte offset of the first checksum-invalid or short record —
    everything at or past valid_len is torn/corrupt and must be
    truncated.  Pure function; the journal torture test drives it over
    every byte boundary of a tail record."""
    bodies: list[bytes] = []
    off = 0
    while off < len(data):
        if off + _LEN_BYTES > len(data):
            break
        n = int.from_bytes(data[off:off + _LEN_BYTES], "big")
        end = off + _LEN_BYTES + n + _SUM_BYTES
        if n == 0 or end > len(data):
            break
        body = data[off + _LEN_BYTES:off + _LEN_BYTES + n]
        if data[off + _LEN_BYTES + n:end] != _record_sum(body):
            break
        bodies.append(body)
        off = end
    return bodies, off


def _fsync_dir(path: str) -> None:
    """Durably persist a rename: fsync the containing directory (best
    effort — not every filesystem exposes a dir fd)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class BlockStore:
    """One node's durable state under `data_dir`.  Thread-safe: the
    service calls the journal hooks under its own lock, but warp resets
    and metrics scrapes arrive from other threads."""

    def __init__(
        self,
        data_dir: str,
        registry: "m.Registry | None" = None,
        faults=None,
        checkpoint_every: int = 16,
    ) -> None:
        self.data_dir = data_dir
        self.journal_dir = os.path.join(data_dir, "journal")
        self.ckpt_dir = os.path.join(data_dir, "checkpoints")
        os.makedirs(self.journal_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.faults = faults  # node/faults.py FaultInjector (or None)
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.degraded = False
        self._warned = False
        self._replaying = False
        self._lock = threading.RLock()
        self._fh = None           # active segment file object
        self._seq = 0             # active segment sequence number
        self._seg_max: dict[int, int] = {}  # seq → max block number held
        self._ckpt_number = 0     # newest durable checkpoint's block

        reg = registry if registry is not None else m.Registry()
        self.registry = reg
        self.m_append = m.Counter(
            "cess_store_journal_appends",
            "journal records appended (fsync'd before the block is "
            "acknowledged)", reg)
        self.m_append_bytes = m.Counter(
            "cess_store_journal_append_bytes",
            "journal bytes appended", reg)
        self.m_fsync = m.Counter(
            "cess_store_fsyncs", "journal/checkpoint fsync calls", reg)
        self.m_fsync_time = m.Histogram(
            "cess_store_fsync_seconds", "fsync latency",
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1.0),
            registry=reg)
        self.m_checkpoints = m.Counter(
            "cess_store_checkpoints",
            "atomic checkpoints written (temp-file + fsync + rename)",
            reg)
        self.m_replay = m.Counter(
            "cess_store_replay_blocks",
            "journal block records imported by startup recovery", reg)
        self.m_replay_skipped = m.Counter(
            "cess_store_replay_skipped",
            "journal records rejected by import verification at "
            "recovery (tampered or orphaned by a reorg)", reg)
        self.m_replay_dedup = m.Counter(
            "cess_store_replay_deduped",
            "journal block records skipped at recovery because the "
            "restored checkpoint already covers them (at or below "
            "the restored head)", reg)
        self.m_truncated = m.Counter(
            "cess_store_truncated_records",
            "journal truncations at a checksum-invalid or short "
            "record", reg)
        self.m_recoveries = m.LabeledCounter(
            "cess_store_recoveries",
            "recovery-ladder rungs engaged (checkpoint restore, "
            "journal replay, cold start, warp fallback)", "rung", reg)
        self.m_write_errors = m.Counter(
            "cess_store_write_errors",
            "store writes degraded by OSError (ENOSPC, injected "
            "storage faults) — the node keeps running from memory",
            reg)
        self.m_pruned = m.Counter(
            "cess_store_pruned_segments",
            "journal segments pruned below the durable checkpoint",
            reg)

        self._load_manifest_number()
        self._open_segment()

    # ------------------------------------------------------ plumbing

    def _degrade(self, what: str, exc: OSError) -> None:
        self.degraded = True
        self.m_write_errors.inc()
        if not self._warned:
            self._warned = True
            print(f"store: {what} failed ({exc}); running degraded "
                  "from memory", file=sys.stderr, flush=True)

    def _fsync(self, fh) -> None:
        with self.m_fsync_time.time():
            fh.flush()
            os.fsync(fh.fileno())
        self.m_fsync.inc()

    def _segments(self) -> list[tuple[int, str]]:
        """(seq, path) of every journal segment on disk, in order."""
        out = []
        try:
            names = os.listdir(self.journal_dir)
        except OSError:
            return []
        for name in names:
            got = _SEG_RE.match(name)
            if got:
                out.append((int(got.group(1)),
                            os.path.join(self.journal_dir, name)))
        return sorted(out)

    def _open_segment(self, fresh: bool = False) -> None:
        """Open the append head: the highest-numbered existing segment,
        or a new one (`fresh` forces rotation)."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        segs = self._segments()
        self._seq = (segs[-1][0] if segs else 0) + (1 if fresh or
                                                   not segs else 0)
        path = os.path.join(self.journal_dir, f"seg-{self._seq:08d}.wal")
        try:
            self._fh = open(path, "ab")
        except OSError as e:
            self._degrade("segment open", e)

    def _rotate_if_full(self) -> None:
        try:
            if self._fh is not None and (
                self._fh.tell() >= SEGMENT_MAX_BYTES
            ):
                self._open_segment(fresh=True)
        except OSError as e:
            self._degrade("segment rotate", e)

    # ------------------------------------------------------ journal

    def _append(self, body: bytes, number: int) -> bool:
        """Append + fsync one record; never raises.  On failure the
        segment tail is repaired (truncated back, or the segment is
        abandoned for a fresh one) so a later successful append is not
        stranded behind torn bytes."""
        with self._lock:
            if self._replaying:
                return True  # replay re-commits blocks already on disk
            if self._fh is None:
                self._open_segment()
                if self._fh is None:
                    return False
            rec = encode_record(body)
            if self.faults is not None:
                try:
                    rec = self.faults.disk_write_gate(rec)
                except OSError as e:
                    self._degrade("journal append", e)
                    return False
            try:
                offset = self._fh.tell()
                self._fh.write(rec)
                self._fsync(self._fh)
            except OSError as e:
                # repair the tail this write may have torn; if even the
                # truncate fails, abandon the segment — recovery will
                # truncate it at the torn record
                try:
                    self._fh.truncate(offset)
                except (OSError, ValueError):
                    self._open_segment(fresh=True)
                self._degrade("journal append", e)
                return False
            self.degraded = False
            self._warned = False
            self.m_append.inc()
            self.m_append_bytes.inc(len(rec))
            self._seg_max[self._seq] = max(
                self._seg_max.get(self._seq, 0), number)
            self._rotate_if_full()
            return True

    def journal_block(self, block: Block, events_digest: str,
                      justification: "Justification | None" = None,
                      delta: "list | None" = None,
                      ) -> bool:
        from ..chain.state import encode_delta

        body = canonical_json({
            "t": "block",
            "block": block.to_json(),
            "eventsDigest": events_digest,
            "delta": (encode_delta(delta)
                      if delta is not None else None),
            "just": (justification.to_json()
                     if justification is not None else None),
        })
        return self._append(body, block.number)

    def journal_justification(self, just: Justification) -> bool:
        body = canonical_json({"t": "just", "just": just.to_json()})
        return self._append(body, just.number)

    # ------------------------------------------------------ checkpoints

    def _manifest_path(self) -> str:
        return os.path.join(self.data_dir, _MANIFEST)

    def _read_manifest(self) -> dict:
        try:
            raw = open(self._manifest_path(), "rb").read()
            if self.faults is not None:
                raw = self.faults.disk_read_gate(raw)
            man = json.loads(raw)
        except (OSError, ValueError):
            return {"checkpoints": []}
        if not isinstance(man, dict) or not isinstance(
            man.get("checkpoints"), list
        ):
            return {"checkpoints": []}
        return man

    def _load_manifest_number(self) -> None:
        entries = self._read_manifest()["checkpoints"]
        if entries and isinstance(entries[0], dict):
            try:
                self._ckpt_number = int(entries[0].get("number", 0))
            except (TypeError, ValueError):
                self._ckpt_number = 0

    def _write_atomic(self, path: str, data: bytes) -> None:
        """temp-file + fsync + rename: a crash at any byte leaves the
        old file or the new one, never a torn mix.  Raises OSError —
        callers own the degrade decision."""
        if self.faults is not None:
            data = self.faults.disk_write_gate(data)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            self._fsync(fh)
        os.rename(tmp, path)
        _fsync_dir(os.path.dirname(path))

    def write_checkpoint(
        self, blob: bytes, head: Block,
        justification: "Justification | None" = None,
    ) -> bool:
        """Persist one atomic checkpoint and point the manifest at it;
        prunes journal segments wholly below it.  Never raises."""
        name = (f"ckpt-{head.number:08d}-"
                f"{hashlib.blake2b(blob, digest_size=4).hexdigest()}.bin")
        path = os.path.join(self.ckpt_dir, name)
        entry = {
            "file": name,
            "number": head.number,
            "stateHash": head.state_hash,
            "head": head.to_json(),
            "justification": (justification.to_json()
                              if justification is not None else None),
        }
        with self._lock:
            man = self._read_manifest()
            entries = [e for e in man["checkpoints"]
                       if isinstance(e, dict) and e.get("file") != name]
            entries.insert(0, entry)
            dropped = entries[CHECKPOINT_KEEP:]
            entries = entries[:CHECKPOINT_KEEP]
            try:
                self._write_atomic(path, blob)
                self._write_atomic(
                    self._manifest_path(),
                    json.dumps({"checkpoints": entries},
                               sort_keys=True).encode())
            except OSError as e:
                self._degrade("checkpoint write", e)
                return False
            self.m_checkpoints.inc()
            self._ckpt_number = head.number
            for old in dropped:
                try:
                    os.unlink(os.path.join(self.ckpt_dir,
                                           str(old.get("file"))))
                except OSError:
                    pass
            self._prune_segments()
            return True

    def maybe_checkpoint(
        self, block: Block, blob,
        justification: "Justification | None" = None,
    ) -> None:
        """Checkpoint cadence: every `checkpoint_every` blocks the
        commit path hands its post-state blob here — either the bytes,
        or a zero-arg callable producing them (the service passes a
        thunk so the full state re-encode is only paid ON the cadence,
        not per block — per-block hashing is incremental now)."""
        if block.number - self._ckpt_number >= self.checkpoint_every:
            if callable(blob):
                blob = blob()
            self.write_checkpoint(blob, block, justification)

    def _prune_segments(self) -> None:
        """Drop journal segments whose every record is at or below the
        durable checkpoint (never the active segment).  A segment whose
        max block number is unknown (written by an earlier process and
        not replayed) is kept — pruning is an optimization, recovery is
        the contract."""
        for seq, path in self._segments():
            if seq == self._seq:
                continue
            known = self._seg_max.get(seq)
            if known is not None and known <= self._ckpt_number:
                try:
                    os.unlink(path)
                    self.m_pruned.inc()
                    self._seg_max.pop(seq, None)
                except OSError:
                    pass

    # ------------------------------------------------------ warp reset

    def on_warp(self, blob: bytes, head: Block,
                justification: "Justification | None" = None) -> None:
        """Called by the service after a successful peer warp sync
        (restore_checkpoint): the local journal's history no longer
        chains to the new anchor, so persist the warped state as a
        checkpoint and restart the journal from it."""
        with self._lock:
            self.m_recoveries.inc("warp")
            self.write_checkpoint(blob, head, justification)
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
            for _, path in self._segments():
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._seg_max.clear()
            self._open_segment(fresh=True)

    # ------------------------------------------------------ recovery

    def _recover_checkpoint(self, service) -> "tuple[str, int] | None":
        """Rung 1: restore the newest manifest entry whose blob is
        intact (payload hash == the signed head's state_hash) and whose
        head verifies.  Returns (file, number) or None."""
        for entry in self._read_manifest()["checkpoints"]:
            if not isinstance(entry, dict):
                continue
            try:
                head = Block.from_json(entry["head"])
                path = os.path.join(self.ckpt_dir, str(entry["file"]))
                blob = open(path, "rb").read()
                if self.faults is not None:
                    blob = self.faults.disk_read_gate(blob)
            except (OSError, KeyError, TypeError, ValueError):
                continue
            # cheap integrity gate before any restore work: a current-
            # version blob's payload hash must equal the state hash the
            # signed head commits to (chain/checkpoint.py)
            try:
                if (checkpoint.blob_payload_hash(blob)
                        != head.state_hash):
                    continue
            except ValueError:
                continue
            just = None
            if entry.get("justification"):
                try:
                    just = Justification.from_json(
                        entry["justification"])
                except (KeyError, TypeError, ValueError):
                    just = None
            if service.restore_local_checkpoint(blob, head, just):
                return str(entry["file"]), head.number
        return None

    def _recover_journal(self, service) -> tuple[int, int, int]:
        """Rung 2: replay every intact journal record through the
        deterministic import path; truncate the journal at the first
        torn record (and drop later segments — continuity is gone).

        Block records ride the BATCHED import path
        (service.import_batch): consecutive records fold their author +
        VRF + extrinsic pairings into one weighted batch instead of
        paying the serial pairing per record after every kill -9.
        Records at or below the restored head are skipped BEFORE the
        batch is built (deduped — a block in both the newest checkpoint
        and the journal tail must not pay an import at all); the flush
        barrier before every justification record preserves the
        journal's block→finality ordering.  Returns (replayed,
        truncated, deduped)."""
        replayed = 0
        truncated = 0
        deduped = 0
        batch: list[tuple[Block, int, "list | None"]] = []

        def flush() -> None:
            nonlocal replayed
            if not batch:
                return
            outcomes = service.import_batch(
                [b for b, _, _ in batch], origin="journal",
                deltas=[d for _, _, d in batch])
            for (blk, seq, _), (kind, _) in zip(batch, outcomes):
                if kind in ("rejected", "gap"):
                    # verification rejected it (tampered record, or a
                    # fork branch orphaned by a reorg whose winner
                    # follows): skip — the winning chain's records
                    # still chain onto the head.  A rejected record
                    # must not drive segment pruning either.
                    self.m_replay_skipped.inc()
                    continue
                self._seg_max[seq] = max(self._seg_max.get(seq, 0),
                                         blk.number)
                if kind == "imported":
                    self.m_replay.inc()
                    replayed += 1
            del batch[:]

        segs = self._segments()
        for i, (seq, path) in enumerate(segs):
            try:
                data = open(path, "rb").read()
                if self.faults is not None:
                    data = self.faults.disk_read_gate(data)
            except OSError:
                data = b""
            bodies, valid_len = scan_records(data)
            for body in bodies:
                kind, payload = self._parse_record(body)
                if kind == "block":
                    blk, delta = payload
                    if blk.number <= service.head_number():
                        # covered by the restored checkpoint (or an
                        # earlier batch): never reaches import
                        self.m_replay_dedup.inc()
                        deduped += 1
                        self._seg_max[seq] = max(
                            self._seg_max.get(seq, 0), blk.number)
                        continue
                    batch.append((blk, seq, delta))
                elif kind == "just":
                    flush()
                    try:
                        service.handle_justification(payload)
                    except (KeyError, TypeError, ValueError):
                        self.m_replay_skipped.inc()
            flush()
            if valid_len < len(data):
                truncated += 1
                self.m_truncated.inc()
                try:
                    with open(path, "r+b") as fh:
                        fh.truncate(valid_len)
                except OSError:
                    pass
                # later segments chain onto the torn tail: drop them
                for _, later in segs[i + 1:]:
                    try:
                        os.unlink(later)
                    except OSError:
                        pass
                break
        return replayed, truncated, deduped

    def _parse_record(self, body: bytes):
        """One journal record body → ("block", (Block, delta | None)) |
        ("just", Justification) | (None, None); malformed records count
        as skipped.  A malformed DELTA degrades to None (the block
        re-executes instead of fast-forwarding) rather than skipping
        the whole record — the delta is an optimization, the signed
        block is the contract."""
        try:
            rec = json.loads(body)
            kind = rec.get("t")
        except (ValueError, AttributeError):
            self.m_replay_skipped.inc()
            return None, None
        if kind == "just":
            try:
                return "just", Justification.from_json(rec["just"])
            except (KeyError, TypeError, ValueError):
                self.m_replay_skipped.inc()
                return None, None
        if kind != "block":
            self.m_replay_skipped.inc()
            return None, None
        try:
            block = Block.from_json(rec["block"])
        except (KeyError, TypeError, ValueError):
            self.m_replay_skipped.inc()
            return None, None
        delta = None
        if rec.get("delta") is not None:
            from ..chain.state import decode_delta
            try:
                delta = decode_delta(rec["delta"])
            except (KeyError, TypeError, ValueError):
                delta = None
        return "block", (block, delta)

    def recover(self, service) -> dict:
        """The startup recovery ladder.  Runs BEFORE the sync loop
        starts; whatever height is still missing afterwards falls to
        peer catch-up / warp sync exactly as a diskless node would.
        Attaches the store to the service so recovered commits are NOT
        re-journaled, and re-arms the journal at the recovered head."""
        with self._lock:
            self._replaying = True
            summary = {"rung": "cold", "checkpoint": None,
                       "replayed": 0, "truncated": 0, "deduped": 0}
            try:
                got = self._recover_checkpoint(service)
                if got is not None:
                    summary["rung"] = "checkpoint"
                    summary["checkpoint"] = got[0]
                    self._ckpt_number = got[1]
                    self.m_recoveries.inc("checkpoint")
                replayed, truncated, deduped = self._recover_journal(
                    service)
                summary["replayed"] = replayed
                summary["truncated"] = truncated
                summary["deduped"] = deduped
                if replayed:
                    summary["rung"] = ("checkpoint+replay"
                                       if got is not None else "replay")
                    self.m_recoveries.inc("replay")
                if got is None and not replayed:
                    self.m_recoveries.inc("cold")
            finally:
                self._replaying = False
            summary["head"] = service.head_number()
            self._open_segment()
            service.tracer.event("store.recover", tags=dict(summary))
            service.attach_store(self)
            return summary

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
