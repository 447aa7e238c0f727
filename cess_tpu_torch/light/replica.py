"""The read-replica tier: keyless followers that scale the read plane.

A `ReplicaService` is a `NodeService` with the authorship half removed
and the verification half industrialised:

 * **Keyless.**  `authority_sk` is forced to None, which disables every
   signing path in the base service — no blocks, no finality votes, no
   OCW heartbeats.  A replica can never equivocate because it can never
   sign; compromising one leaks no key and forges no finality.

 * **Batch finality.**  Incoming justifications land in a queue
   (mirroring the block-import pipeline shape) and are verified
   in batches: each justification is ONE aggregate-signature triple
   (Σ pk over its signers, the finality payload, the aggregate), so N
   of them fold into a single weighted pairing check
   (sync.verify_justifications_batch).  Amortised cost per
   justification drops with batch size; a refused batch falls back to
   per-item verification, so accept/reject decisions are bit-identical
   to the serial path.

 * **Finalized read plane.**  A `FinalizedView` — path→encoding dict +
   sparse-Merkle tree, NO runtime — tracks the FINALIZED state
   commitment, advanced by replaying the per-block leaf deltas the
   import path already records.  Every proof the replica serves
   (state_getProof / state_getProofBatch, node/rpc.py routes through
   `read_plane`) therefore verifies against a root a light client can
   justify for itself; the replica never serves unfinalised state it
   would have to walk back.

Replica count is the horizontal scaling knob: replicas follow
validators, light clients fan out across replicas, and the validator
set never sees read traffic (bench.py BENCH_ONLY=light measures the
one-vs-two-replica scaling).

The port's copy of `cess_tpu/light/replica.py`, bound to the port's node.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

from ..chain import checkpoint, smt
from ..node import metrics as m
from ..node.service import NodeService
from ..node.sync import Justification, verify_justifications_batch

# Most justifications one drain folds into a single weighted pairing.
# Matches SYNC_RANGE_MAX — a catch-up range arrives as at most one
# batch — and bounds how long the drainer holds verdicts back.
JUST_BATCH_MAX = 64

# Verdict memory for (number, hash) pairs already decided — the replica
# analogue of the import-result cache: gossip redelivers the same
# justification from every peer, and a cached verdict answers without
# re-queueing it.
JUST_RESULT_CACHE_MAX = 2048


class FinalizedView:
    """The replica's finalized state commitment: a path→encoding map
    plus its sparse-Merkle tree, advanced by per-block deltas only.
    There is no runtime behind it — it cannot execute anything, only
    commit and prove.  Guarded by the owning service's _lock."""

    def __init__(self, enc: dict[bytes, bytes], number: int) -> None:
        self._enc = dict(enc)
        self.smt = smt.SparseMerkleTree(self._enc)
        self.number = number

    def root_hex(self) -> str:
        return self.smt.root().hex()

    def apply(self, delta: list, number: int) -> str:
        """Replay one block's leaf delta (chain/state.py DeltaEntry
        list) onto the view; returns the new root."""
        writes: dict[bytes, bytes | None] = {}
        for pallet, attr, kenc, _old, new in delta:
            label = checkpoint.leaf_label(pallet, attr)
            path = smt.key_path(label, kenc if kenc is not None else b"")
            writes[path] = new
            if new is None:
                self._enc.pop(path, None)
            else:
                self._enc[path] = new
        if writes:
            self.smt.update(writes)
        self.number = number
        return self.root_hex()

    def prove(self, pallet: str, attr: str, key=None) -> dict:
        """Read proof against the FINALIZED root — same wire and same
        keyed-map validation as StateDB.prove, so rpc.py serves either
        interchangeably."""
        keyed = (pallet, attr) in checkpoint.KEYED_MAPS
        if keyed != (key is not None):
            raise ValueError(
                f"{pallet}.{attr} is "
                f"{'a keyed map' if keyed else 'one leaf'} — key "
                f"{'required' if keyed else 'must be omitted'}"
            )
        label = checkpoint.leaf_label(pallet, attr)
        kenc = b"" if key is None else checkpoint.canon_bytes(key)
        path = smt.key_path(label, kenc)
        value = self.smt.get(path)
        return {
            "root": self.root_hex(),
            "path": path.hex(),
            "proof": self.smt.prove(path).to_wire(),
            "value": None if value is None else value.hex(),
        }


class ReplicaService(NodeService):
    """See module docstring.  Construct with a spec only — any
    authority argument is meaningless here and not accepted.  `device`
    is the base service's: the card unless "cpu" is given."""

    def __init__(self, spec, registry=None, device=None, **kw) -> None:
        super().__init__(spec, authority=None, registry=registry,
                         device=device, **kw)
        # The base service derives a dev signing key for the slot
        # author on dev-seeded chains; a replica must hold NO key at
        # all — this also switches off votes, OCW and heartbeats.
        self.authority_sk = None
        # Finalized read plane, seeded from the genesis state (the
        # StateDB is exactly the genesis commitment at construction).
        self.read_plane = FinalizedView(
            self.statedb.leaf_encodings(), 0)  # guarded-by: _lock
        # Justification pipeline (the import-queue shape): one
        # drainer folds queued justifications into one pairing.  The
        # condition wraps the service lock, so `with self._just_cv`
        # IS `with self._lock` plus wait/notify.
        self._just_queue: deque[Justification] = deque()  # guarded-by: _just_cv
        self._just_queued: set[tuple[int, str]] = set()  # guarded-by: _just_cv
        self._just_results: OrderedDict[tuple[int, str], bool] = (
            OrderedDict())  # guarded-by: _just_cv
        self._just_draining = False  # guarded-by: _just_cv
        self._just_cv = threading.Condition(self._lock)
        reg = self.registry
        self.m_light_justs = m.Counter(
            "cess_light_justifications_verified",
            "justifications this replica verified for the read plane",
            reg)
        self.m_light_batch = m.Counter(
            "cess_light_batch_pairings",
            "weighted pairing checks spent verifying justification "
            "batches (amortisation = verified / pairings)", reg)
        self.m_replica_reads = m.Counter(
            "cess_replica_reads_total",
            "read proofs served from the finalized read plane", reg)
        self.m_replica_proof = m.Histogram(
            "cess_replica_proof_seconds",
            "read-proof build time (per state_getProof* request)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0),
            registry=reg)

    # ------------------------------------------------- batch finality

    def handle_justification(
        self, just: Justification, _verified: bool = False
    ) -> bool:
        """Route unverified justifications through the batch pipeline;
        already-verified ones (pending-buffer replays from _post_block,
        or the drainer applying its own verdicts) take the base path
        directly and then advance the read plane."""
        if _verified:
            got = super().handle_justification(just, _verified=True)
            if got:
                with self._lock:
                    self._advance_read_plane()
            return got
        key = (just.number, just.block_hash)
        with self._just_cv:
            if just.number <= self.finalized_number:
                return False
            if key in self._just_results:
                return self._just_results[key]
            if key not in self._just_queued:
                self._just_queue.append(just)
                self._just_queued.add(key)
        return self.flush_justifications(wait_for=key)

    def handle_justifications(self, justs: list[Justification]) -> int:
        """The batch entry point (sync catch-up ranges): enqueue the
        whole range FIRST, then drain — so one weighted pairing covers
        the lot instead of one pairing per height."""
        keys = []
        with self._just_cv:
            for just in sorted(justs, key=lambda j: j.number):
                key = (just.number, just.block_hash)
                if just.number <= self.finalized_number:
                    continue
                if (key not in self._just_queued
                        and key not in self._just_results):
                    self._just_queue.append(just)
                    self._just_queued.add(key)
                keys.append(key)
        advanced = 0
        for key in keys:
            if self.flush_justifications(wait_for=key):
                advanced += 1
        return advanced

    def flush_justifications(
        self, wait_for: tuple[int, str] | None = None
    ) -> bool:
        """Become the drainer (or wait for the active one): pop up to
        JUST_BATCH_MAX queued justifications, verify them in ONE
        weighted pairing OUTSIDE the lock, then apply the verified ones
        in height order.  Returns the advanced?-verdict for `wait_for`
        once it is decided (False for None)."""
        while True:
            with self._just_cv:
                if wait_for is not None and wait_for in self._just_results:
                    return self._just_results[wait_for]
                if not self._just_queue:
                    if not self._just_draining:
                        # queue drained and nobody is verifying — a
                        # wait_for not in results was superseded
                        # (finalized past it before its turn)
                        return False
                    self._just_cv.wait(0.5)
                    continue
                if self._just_draining:
                    if wait_for is None:
                        return False  # the active drainer will get to it
                    self._just_cv.wait(0.5)
                    continue
                self._just_draining = True
                batch = []
                while self._just_queue and len(batch) < JUST_BATCH_MAX:
                    batch.append(self._just_queue.popleft())
                validators = list(self.spec.validators)
                keyset = dict(self.keys)
                genesis = self.genesis
            # the expensive part — pairings — runs without the lock so
            # reads keep flowing while the batch verifies
            verdicts = None
            try:
                stats = {"pairings": 0}
                verdicts = verify_justifications_batch(
                    batch, genesis, validators, keyset, stats=stats)
                self.m_light_batch.inc(stats.get("pairings", 0))
            finally:
                with self._just_cv:
                    self._just_draining = False
                    if verdicts is None:  # verification crashed
                        for just in batch:
                            self._just_queued.discard(
                                (just.number, just.block_hash))
                        self._just_cv.notify_all()
            if verdicts is None:
                return False
            with self._just_cv:
                decided = sorted(
                    zip(batch, verdicts), key=lambda bv: bv[0].number)
                for just, ok in decided:
                    key = (just.number, just.block_hash)
                    adv = False
                    if ok:
                        self.m_light_justs.inc()
                        adv = self.handle_justification(
                            just, _verified=True)
                    self._just_results[key] = adv
                    self._just_queued.discard(key)
                while len(self._just_results) > JUST_RESULT_CACHE_MAX:
                    self._just_results.popitem(last=False)
                self._just_cv.notify_all()

    # --------------------------------------------------- read plane

    def _advance_read_plane(self) -> None:  # holds-lock: _lock
        """Roll the finalized view forward to the finalized head by
        replaying recorded per-block deltas.  When a delta fell out of
        the bounded cache (deep catch-up) the view rebases wholesale
        from the live trie — but only when the finalized head IS the
        live head, because the StateDB commits to head state."""
        while self.read_plane.number < self.finalized_number:
            number = self.read_plane.number + 1
            blk = self.block_by_number.get(number)
            delta = (None if blk is None
                     else self._state_deltas.get(blk.hash(self.genesis)))
            if delta is None:
                if (self.finalized_number == self.rt.state.block_number
                        and self.finalized_hash == self.head_hash):
                    self.read_plane = FinalizedView(
                        self.statedb.leaf_encodings(),
                        self.finalized_number)
                # else: the gap block's delta is gone and head is past
                # the finalized anchor mid-import — the next finality
                # advance lands on a replayable window
                return
            got = self.read_plane.apply(delta, number)
            if blk is not None and blk.state_hash != got:
                # loud, like StateDB.check_oracle: a divergent replay
                # means the served proofs would commit to a wrong root
                raise RuntimeError(
                    f"read-plane divergence at #{number}: replayed "
                    f"root {got} != committed {blk.state_hash}")

    def restore_checkpoint(self, blob, head, justification=None) -> bool:
        """Warp-sync rebases the read plane wholesale: after a restore
        the live trie IS the finalized post-state of the restored
        head."""
        ok = super().restore_checkpoint(blob, head, justification)
        if ok:
            with self._lock:
                self.read_plane = FinalizedView(
                    self.statedb.leaf_encodings(), self.finalized_number)
        return ok
