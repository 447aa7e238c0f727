"""Block sync + BLS-aggregate finality: the replicated-network layer.

Role match: the reference node's consensus networking (reference:
node/src/service.rs:219-584 — the import queue, block announce/request
protocols over libp2p, and the GRANDPA finality gadget with its 2/3
justifications) re-expressed over this framework's newline-JSON-RPC
wire (node/rpc.py):

 * **Blocks** (`Block`) carry (parent hash, slot, extrinsic root,
   post-state hash) signed by the slot author's BLS key.  Authored
   blocks are announced to every peer (`sync_announce`); importing
   nodes re-execute the extrinsics deterministically and reject
   wrong-author, bad-signature, or state-hash-mismatched blocks — the
   import-queue role, with the runtime's replay determinism
   (chain/checkpoint.py) as the verification anchor.

 * **Catch-up** (`SyncManager.catch_up`) pulls `sync_status` from
   peers; small gaps replay the missing block range (`sync_block`),
   large gaps bootstrap from a versioned checkpoint blob
   (`sync_checkpoint`, chain/checkpoint.py format) and replay from
   there — the warp-sync role (service.rs:259-263).  Warp is also the
   *last rung* of the on-disk recovery ladder (node/store.py): a node
   whose local checkpoint/journal is missing or corrupted degrades to
   peer catch-up here instead of refusing to start.

 * **Finality** (`Vote` / `Justification`) is a GRANDPA stand-in:
   every `finality_period` blocks validators sign the canonical block
   at the period boundary; 2/3 of the authority set's signatures,
   BLS-aggregated (ops/bls_agg.py), form a justification that is
   gossiped, verified at import, and exposed over RPC
   (`chain_finalized_head`).  Finalized blocks are never reorged.

The wire messages are plain JSON dicts — every constructor verifies
before trusting, so a malicious peer can at worst be ignored.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field

from ..ops import bls12_381 as bls
from ..ops import bls_agg


def _rpc(host: str, port: int, method: str, params: list,
         timeout: float):
    """Lazy one-shot RPC (node/rpc.py imports service which imports this
    module — the deferred import breaks the cycle)."""
    from .rpc import rpc_call

    return rpc_call(host, port, method, params, timeout=timeout)


def _rpc_errors() -> tuple[type, ...]:
    from .rpc import RpcError

    return (OSError, RpcError, ValueError, KeyError)

# Bumped when the sync wire format OR the deterministic state machine
# changes; peers with a different version are skipped during catch-up.
# v2: headers carry the BLS-VRF slot claim (vrfOut/vrfProof —
# consensus/).  v3: session/offences pallets joined the
# replicated state (chain/{session,offences}.py) — a v2 peer would
# re-execute our blocks to a different state hash.  v4: the deposited-
# event sink left the consensus state hash (chain/checkpoint.py v5 —
# events are per-block telemetry now), so a v3 peer computes different
# state hashes for identical chains; announce/catch-up envelopes also
# carry optional trace ids (node/tracing.py — telemetry, ignored by
# verification).  v5: the fee market (chain/fees.py) — extrinsics carry
# a tip field in their signing payload, fee charging and the 20/80
# split are consensus state (checkpoint v6), so a v4 peer computes
# different extrinsic hashes and state hashes for identical chains.
# v6: the state hash is the keyed sparse-Merkle trie root (chain/smt.py,
# checkpoint v7) instead of a hash of the whole canonical blob — a v5
# peer computes a different state_hash for identical state, so every
# header it serves fails our post-state check.
SYNC_PROTO_VERSION = 6

# Peer-gossip socket timeout: announcements are fire-and-forget, a dead
# peer must not stall the authoring loop.
# cesslint: allow[det-float] socket timeout — network plumbing, never
# consensus state
GOSSIP_TIMEOUT_S = 3.0

# Max gossip messages queued per peer.  A hung peer drains at ~1 message
# per timeout while blocks enqueue several per slot — without a cap the
# queue (full block JSON each) grows without bound.  Dropping is safe:
# gossip is best-effort and catch-up recovers anything missed.
GOSSIP_QUEUE_MAX = 64

# Catch-up RPC retry policy: transient socket failures (refused, timed
# out, chaos-injected) are retried with bounded exponential backoff and
# DETERMINISTIC jitter before the peer is given up for this lap.
# Definitive replies (RpcError, malformed JSON) never retry, and gossip
# casts keep their one-timeout guarantee — only the catch-up pull path
# retries, where one dropped packet otherwise costs a whole lap.
CATCHUP_RPC_ATTEMPTS = 3
# cesslint: allow[det-float] retry backoff base — network plumbing, never
# consensus state
CATCHUP_BACKOFF_BASE_S = 0.05

# Header-range batch verification during catch-up: above this gap the
# node fetches a block range and checks EVERY signature in it — author
# sigs, VRF slot proofs, extrinsic sigs — as one weighted pairing
# product (ops/bls_agg) instead of one ~0.38 s pairing per block, then
# imports with the per-block pairing skipped.  Below it the per-block
# path wins (no batching overhead, and a bad block is pinned exactly).
VERIFY_BATCH_MIN = 8
SYNC_RANGE_MAX = 64


# ------------------------------------------------------------ block wire


def canonical_json(obj) -> bytes:
    """THE canonical byte encoding every consensus payload is signed
    and hashed over (blocks, extrinsics, finality votes).  Single
    definition on purpose: replicas that disagree on one byte here
    reject each other's signatures and state hashes."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def extrinsic_root(extrinsics: list[dict]) -> str:
    """Commitment to the block body (the extrinsics-root role of the
    reference header): blake2b over the canonical JSON of the body."""
    return hashlib.blake2b(
        canonical_json(extrinsics), digest_size=32,
    ).hexdigest()


def header_signing_payload(genesis: str, hdr: dict) -> bytes:
    """THE block signing payload, built from a header wire dict
    (Block.header_json): the served `extRoot` stands in for
    extrinsic_root(body).  `Block.signing_payload` routes through here,
    so a stateless client folding a served header signs off on exactly
    the bytes the author signed."""
    return canonical_json(
        [
            genesis, "block", int(hdr["number"]), int(hdr["slot"]),
            str(hdr["parent"]), str(hdr["author"]), str(hdr["extRoot"]),
            str(hdr["stateHash"]), str(hdr.get("vrfOut", "")),
            str(hdr.get("vrfProof", "")),
        ]
    )


def header_hash(genesis: str, hdr: dict) -> str:
    """Block hash recomputed from a HEADER wire dict — what a light
    client checks a justification's block_hash against.  Raises
    KeyError/ValueError/TypeError on a malformed header."""
    return hashlib.blake2b(
        header_signing_payload(genesis, hdr)
        + bytes.fromhex(str(hdr["sig"])),
        digest_size=32,
    ).hexdigest()


@dataclass
class Block:
    """One announced block: header fields + full body.  `state_hash` is
    the POST-state hash (chain/checkpoint.py state_hash) — the import
    check that pins replay determinism across replicas.  `vrf_output` /
    `vrf_proof` are the author's BLS-VRF slot claim
    (consensus/vrf.py): the proof that the author won or owned
    the slot, and the output that feeds the next epoch's randomness —
    both under the author signature, so a relay cannot swap them."""

    number: int
    slot: int
    parent: str          # parent block hash (hex; genesis hash for #1)
    author: str          # validator account that owned the slot
    state_hash: str      # post-execution state hash
    extrinsics: list[dict] = field(default_factory=list)
    signature: str = ""  # author's BLS signature over signing_payload()
    vrf_output: str = ""  # hex 32-byte VRF output for (epoch, slot)
    vrf_proof: str = ""   # hex 48-byte compressed G1 proof point

    def signing_payload(self, genesis: str) -> bytes:
        # delegated through the header wire form so the two can never
        # drift: a light client recomputing the hash from a served
        # header (header_hash) folds the exact same canonical bytes
        return header_signing_payload(genesis, self.header_json())

    def header_json(self) -> dict:
        """Header-only wire form (the `light_syncHeaders` feed): the
        body is replaced by its extrinsic-root commitment, so a light
        client recomputes the block hash — and therefore checks a
        justification really covers this header — without downloading
        the extrinsics."""
        return {
            "number": self.number, "slot": self.slot,
            "parent": self.parent, "author": self.author,
            "stateHash": self.state_hash,
            "extRoot": extrinsic_root(self.extrinsics),
            "sig": self.signature,
            "vrfOut": self.vrf_output, "vrfProof": self.vrf_proof,
        }

    def sign(self, sk: int, genesis: str) -> "Block":
        self.signature = bls.sign(sk, self.signing_payload(genesis)).hex()
        return self

    def hash(self, genesis: str) -> str:
        return hashlib.blake2b(
            self.signing_payload(genesis) + bytes.fromhex(self.signature),
            digest_size=32,
        ).hexdigest()

    def to_json(self) -> dict:
        return {
            "number": self.number, "slot": self.slot,
            "parent": self.parent, "author": self.author,
            "stateHash": self.state_hash, "extrinsics": self.extrinsics,
            "sig": self.signature,
            "vrfOut": self.vrf_output, "vrfProof": self.vrf_proof,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Block":
        return cls(
            number=int(d["number"]), slot=int(d["slot"]),
            parent=str(d["parent"]), author=str(d["author"]),
            state_hash=str(d["stateHash"]),
            extrinsics=list(d.get("extrinsics", [])),
            signature=str(d.get("sig", "")),
            vrf_output=str(d.get("vrfOut", "")),
            vrf_proof=str(d.get("vrfProof", "")),
        )


class BlockImportError(ValueError):
    """Block failed verification (author, signature, parent, state)."""


class SyncGap(Exception):
    """Announced block is ahead of our head — catch-up required."""

    def __init__(self, have: int, want: int):
        super().__init__(f"gap: have {have}, announced {want}")
        self.have = have
        self.want = want


# ------------------------------------------------------------ finality


def finality_payload(genesis: str, number: int, block_hash: str) -> bytes:
    """Canonical bytes every validator signs to finalize a block —
    identical for all signers, so signatures aggregate (bls_agg)."""
    return canonical_json([genesis, "finality", number, block_hash])


@dataclass
class Vote:
    """One validator's finality vote for (number, hash)."""

    number: int
    block_hash: str
    voter: str
    signature: str  # hex BLS signature over finality_payload()

    def to_json(self) -> dict:
        return {
            "number": self.number, "hash": self.block_hash,
            "voter": self.voter, "sig": self.signature,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Vote":
        return cls(
            number=int(d["number"]), block_hash=str(d["hash"]),
            voter=str(d["voter"]), signature=str(d["sig"]),
        )


@dataclass
class Justification:
    """2/3-aggregate finality proof: the GRANDPA justification role.
    `signers` lists the contributing validators (sorted); `agg_sig` is
    the BLS aggregate of their votes (ops/bls_agg.aggregate_signatures)
    over the shared finality payload."""

    number: int
    block_hash: str
    signers: list[str]
    agg_sig: str  # hex, 48-byte compressed G1 aggregate

    def to_json(self) -> dict:
        return {
            "number": self.number, "hash": self.block_hash,
            "signers": list(self.signers), "agg": self.agg_sig,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Justification":
        return cls(
            number=int(d["number"]), block_hash=str(d["hash"]),
            signers=[str(s) for s in d["signers"]],
            agg_sig=str(d["agg"]),
        )

    @classmethod
    def from_votes(
        cls, number: int, block_hash: str, votes: dict[str, str]
    ) -> "Justification":
        signers = sorted(votes)
        agg = bls_agg.aggregate_signatures(
            [bytes.fromhex(votes[s]) for s in signers]
        )
        return cls(
            number=number, block_hash=block_hash,
            signers=signers, agg_sig=agg.hex(),
        )


def quorum(n_signers: int, n_validators: int) -> bool:
    """GRANDPA-style 2/3 supermajority over the authority set."""
    return n_validators > 0 and 3 * n_signers >= 2 * n_validators


def verify_justification(
    just: Justification,
    genesis: str,
    validators: list[str],
    keys: dict[str, bytes],
) -> bool:
    """Full check: signer set ⊆ validators, distinct, 2/3 quorum, and
    the BLS aggregate verifies over the canonical finality payload.
    Forged aggregates, non-validator signers, and sub-quorum sets are
    all rejected — asserted in tests/test_zz_sync.py."""
    signers = just.signers
    if len(set(signers)) != len(signers):
        return False
    if not set(signers) <= set(validators):
        return False
    if not quorum(len(signers), len(validators)):
        return False
    pks = []
    for s in signers:
        pk = keys.get(s)
        if pk is None:
            return False
        pks.append(pk)
    payload = finality_payload(genesis, just.number, just.block_hash)
    try:
        agg = bytes.fromhex(just.agg_sig)
    except ValueError:
        return False
    return bls_agg.verify_aggregate(pks, [payload] * len(pks), agg)


def _justification_triple(
    just: Justification,
    genesis: str,
    validators: list[str],
    keys: dict[str, bytes],
    pk_memo: dict[tuple, bytes],
) -> tuple[bytes, bytes, bytes] | None:
    """Fold one justification to a single (Σpk, payload, agg_sig)
    SigTriple, or None when a pre-pairing check fails.  The structural
    checks here mirror `verify_justification` EXACTLY (distinct
    signers, subset of the authority set, 2/3 quorum, known keys,
    parseable hex) — that equivalence is what makes the batch verdict
    bit-identical to the serial one.  `pk_memo` shares the summed key
    across justifications with the same signer set, so the batch
    check's per-distinct-key G2 decompression is paid once per SET,
    not once per justification."""
    signers = just.signers
    if len(set(signers)) != len(signers):
        return None
    if not set(signers) <= set(validators):
        return None
    if not quorum(len(signers), len(validators)):
        return None
    memo_key = tuple(signers)
    agg_pk = pk_memo.get(memo_key)
    if agg_pk is None:
        pks = []
        for s in signers:
            pk = keys.get(s)
            if pk is None:
                return None
            pks.append(pk)
        try:
            agg_pk = bls_agg.aggregate_pubkeys(pks)
        except ValueError:
            return None
        pk_memo[memo_key] = agg_pk
    try:
        sig = bytes.fromhex(just.agg_sig)
    except ValueError:
        return None
    return (
        agg_pk,
        finality_payload(genesis, just.number, just.block_hash),
        sig,
    )


def verify_justifications_batch(
    justs: list[Justification],
    genesis: str,
    validators: list[str],
    keys: dict[str, bytes],
    seed: bytes = b"",
    stats: dict | None = None,
) -> list[bool]:
    """Per-justification verdicts for a whole batch in ONE weighted
    pairing product — the replica's finality plane (light/replica.py).

    Each justification reduces to one SigTriple under the summed
    signer key (bls_agg.aggregate_pubkeys): the aggregate equation
    e(agg, −g2) · e(H(payload), Σpk) == 1 IS the single-signature
    equation, so N justifications cost one `verify_batch_host` call —
    and identical signer sets (the steady-state case: the same 2/3
    quorum every period) share one G2 decompression inside it.  A
    refused batch falls back to the serial verifier per structurally
    valid item, so accept/reject decisions are bit-identical to
    calling `verify_justification` one at a time — asserted in
    tests/test_light.py and bench.py's BENCH_ONLY=light A/B.

    `stats`, when given, accumulates "pairings": the number of pairing
    checks evaluated (1 for an accepted batch; 1 + one per candidate
    on the fallback path) — the cess_light_batch_pairings feed."""
    verdicts = [False] * len(justs)
    pk_memo: dict[tuple, bytes] = {}
    triples: list[tuple[bytes, bytes, bytes]] = []
    idx: list[int] = []
    for i, just in enumerate(justs):
        t = _justification_triple(just, genesis, validators, keys, pk_memo)
        if t is not None:
            triples.append(t)
            idx.append(i)
    if not triples:
        return verdicts
    if stats is not None:
        stats["pairings"] = stats.get("pairings", 0) + 1
    if bls_agg.verify_batch_host(triples, seed):
        for i in idx:
            verdicts[i] = True
        return verdicts
    # refused batch: isolate per justification, bit-identical to serial
    for i in idx:
        if stats is not None:
            stats["pairings"] = stats.get("pairings", 0) + 1
        verdicts[i] = verify_justification(
            justs[i], genesis, validators, keys
        )
    return verdicts


# ------------------------------------------------------------ sync manager


class SyncManager:
    """One node's view of its peers: gossip fan-out + catch-up.

    Transport is the one-shot newline-JSON RPC client (rpc.rpc_call) —
    each gossip message is its own short-lived connection, so a dead
    peer costs one timeout and nothing else.  `checkpoint_gap` is the
    warp-sync threshold: a node more than this many blocks behind
    bootstraps from a peer's versioned checkpoint blob instead of
    replaying every block."""

    def __init__(
        self,
        service,
        peers: list[tuple[str, int]],
        checkpoint_gap: int = 64,
        batch_min: int = VERIFY_BATCH_MIN,
        faults=None,
    ) -> None:
        from concurrent.futures import ThreadPoolExecutor

        from . import metrics as m

        self.service = service
        self.peers = list(peers)
        self.checkpoint_gap = checkpoint_gap
        self.batch_min = max(2, batch_min)
        self.batched_imports = 0  # blocks imported via range batches
        # node/faults.py FaultInjector (chaos harness): shapes this
        # node's OUTBOUND gossip and catch-up RPC; None = clean network.
        self.faults = faults
        self._catchup_lock = threading.Lock()
        # Per-peer gossip drops: overflow drops were previously silent,
        # which made partitions invisible — now counted per peer and
        # surfaced in the RPC health view (system_health.gossipDropped)
        # and the metrics exposition.
        self.m_gossip_dropped = m.LabeledCounter(
            "cess_gossip_dropped",
            "gossip messages dropped per peer (queue overflow)",
            label="peer", registry=service.registry,
        )
        self.m_chaos_injected = m.LabeledCounter(
            "cess_chaos_injected",
            "chaos faults injected per peer (node/faults.py)",
            label="peer", registry=service.registry,
        )
        # One single-worker pool PER PEER: gossip to a given peer is
        # delivered in submission order (a same-signer extrinsic burst
        # must not arrive nonce-reversed at a strict-nonce intake), it
        # never blocks the authoring loop, and a slow peer only backs up
        # its own queue.
        self._pools = {
            peer: ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"gossip-{peer[1]}",
            )
            for peer in self.peers
        }
        self._queue_lock = threading.Lock()
        self._queued = {peer: 0 for peer in self.peers}
        # Last successful round-trip per peer (gossip ack or catch-up
        # reply), epoch seconds: the system_health `peersSeen`
        # freshness feed — a partitioned node's peers go stale here
        # even when its drop counters are still quiet.
        self._peer_seen: dict[str, float] = {}
        service.attach_sync(self)

    def stop(self) -> None:
        """Drop queued gossip and release the worker threads."""
        for pool in self._pools.values():
            pool.shutdown(wait=False, cancel_futures=True)

    # ------------------------------------------------------ gossip out

    @staticmethod
    def _peer_label(peer) -> str:
        return f"{peer[0]}:{peer[1]}"

    def _mark_peer_seen(self, peer) -> None:
        with self._queue_lock:
            # cesslint: allow[det-wallclock] peer-freshness telemetry for
            # system_health only — never hashed or signed
            self._peer_seen[self._peer_label(peer)] = time.time()

    def peers_seen(self) -> dict[str, float]:
        """peer → epoch seconds of the last successful round-trip
        (system_health freshness view)."""
        with self._queue_lock:
            return dict(self._peer_seen)

    def _cast(self, method: str, params: list) -> None:
        """Fire-and-forget to every peer via its ordered gossip queue:
        the authoring loop must never block on a peer's import time
        (the receiving handler verifies + re-executes synchronously).
        Overflow drops are counted per peer (m_gossip_dropped) so a
        backed-up link shows up in the health view instead of failing
        silently; a chaos injector (node/faults.py) may additionally
        drop, delay, duplicate, or reorder each message."""

        def one(peer, delay, msg):
            from .rpc import RpcError

            try:
                if delay:
                    # cesslint: allow[det-wallclock] chaos-injected link
                    # latency on this peer's own gossip worker
                    # injected link latency: sleeping in the peer's own
                    # single worker backs up only that peer's queue,
                    # exactly like a slow real link
                    time.sleep(delay)
                _rpc(*peer, msg[0], msg[1], GOSSIP_TIMEOUT_S)
                self._mark_peer_seen(peer)
            except RpcError:
                # the peer ANSWERED (rejected the message): that is a
                # completed round-trip for freshness purposes — only
                # socket-level failures leave peersSeen stale
                self._mark_peer_seen(peer)
            except _rpc_errors():
                pass
            finally:
                with self._queue_lock:
                    self._queued[peer] -= 1

        for peer in self.peers:
            # cesslint: allow[det-float] gossip-delay seconds — wire
            # scheduling, never consensus state
            sends = [(0.0, (method, params))]
            if self.faults is not None:
                shape = self.faults.shape_gossip(peer, (method, params))
                sends = shape.sends
                if shape.faults:
                    self.m_chaos_injected.inc(
                        self._peer_label(peer), len(shape.faults))
            for delay, msg in sends:
                with self._queue_lock:
                    if self._queued[peer] >= GOSSIP_QUEUE_MAX:
                        # hung peer: drop rather than queue forever —
                        # counted, so partitions are observable
                        self.m_gossip_dropped.inc(self._peer_label(peer))
                        continue
                    self._queued[peer] += 1
                try:
                    self._pools[peer].submit(one, peer, delay, msg)
                except RuntimeError:  # pool shut down during service stop
                    with self._queue_lock:
                        self._queued[peer] -= 1

    def drop_counts(self) -> dict[str, int]:
        """peer → gossip messages dropped on queue overflow (the RPC
        health view's partition-visibility feed)."""
        return self.m_gossip_dropped.counts()

    def announce_block(self, block: Block, trace: str | None = None) -> None:
        """`trace` is the author-minted trace id (node/tracing.py): it
        rides the announce envelope OUTSIDE the signed payload, so
        importers stitch their spans onto the author's trace."""
        self._cast("sync_announce", [block.to_json(), trace])

    def broadcast_extrinsic(self, ext) -> None:
        """Tx gossip (the reference pool's propagation role): peers get
        the extrinsic in their own pools, so the next slot author —
        whoever it is — includes it."""
        self._cast("author_gossipExtrinsic", [ext.to_json()])

    def broadcast_vote(self, vote: Vote) -> None:
        self._cast("sync_vote", [vote.to_json()])

    def broadcast_justification(self, just: Justification) -> None:
        self._cast("sync_justification", [just.to_json()])

    def broadcast_offence(self, report) -> None:
        """Offence-report gossip (chain/offences.py OffenceReport): the
        evidence is self-verifying, so even a keyless observer's
        detection reaches a validator who can submit the extrinsic."""
        self._cast("sync_offence", [report.to_json()])

    # ------------------------------------------------------ catch-up

    def _peer_call(self, host: str, port: int, method: str, params: list,
                   timeout: float, attempts: int = CATCHUP_RPC_ATTEMPTS):
        """Catch-up RPC with bounded retry: transient socket errors
        (refused/timeout/chaos-injected) back off exponentially with
        DETERMINISTIC jitter — blake2b(peer, method, attempt), so two
        replicas replaying the same schedule behave identically — and
        give up after `attempts`.  Definitive replies (RpcError and
        malformed-shape errors) raise immediately: the peer answered,
        retrying won't change its mind."""
        from .rpc import RpcError

        last: OSError | None = None
        for attempt in range(max(1, attempts)):
            if attempt:
                # cesslint: allow[det-float] backoff jitter fraction —
                # deterministic (blake2b-seeded) and never consensus state
                frac = int.from_bytes(hashlib.blake2b(
                    f"{host}:{port}/{method}/{attempt}".encode(),
                    digest_size=2,
                ).digest(), "big") / 0xFFFF
                # cesslint: allow[det-wallclock] bounded retry backoff on
                # the catch-up pull path — wire scheduling only
                time.sleep(
                    CATCHUP_BACKOFF_BASE_S * (2 ** (attempt - 1))
                    # cesslint: allow[det-float] jitter factor, see above
                    * (1.0 + frac)
                )
            try:
                if self.faults is not None:
                    self.faults.rpc_gate((host, port), method)
                out = _rpc(host, port, method, params, timeout)
                self._mark_peer_seen((host, port))
                return out
            except RpcError:
                # a definitive reply is still a live round-trip
                self._mark_peer_seen((host, port))
                raise
            except OSError as e:
                last = e
        raise last

    def _peer_status(self, host: str, port: int) -> dict | None:
        try:
            # single attempt ON PURPOSE: the status probe runs against
            # EVERY peer each catch-up lap, so a dead peer must cost
            # one timeout, not a retry ladder — the next lap re-polls
            # anyway.  (Still routed through _peer_call so the chaos
            # injector's rpc_gate shapes it.)
            st = self._peer_call(host, port, "sync_status", [],
                                 GOSSIP_TIMEOUT_S, attempts=1)
        except _rpc_errors():
            return None
        # peer-controlled JSON: pin the shape before anyone indexes it
        if not isinstance(st, dict):
            return None
        if st.get("version") != SYNC_PROTO_VERSION:
            return None
        if st.get("genesis") != self.service.genesis:
            return None
        if not isinstance(st.get("number"), int):
            return None
        return st

    def best_peer(self) -> tuple[tuple[str, int], dict] | None:
        """The alive same-chain peer with the highest head."""
        best = None
        for peer in self.peers:
            st = self._peer_status(*peer)
            if st is None:
                continue
            if best is None or st["number"] > best[1]["number"]:
                best = (peer, st)
        return best

    def catch_up(self) -> int:
        """Close the gap to the best peer: checkpoint bootstrap when far
        behind, then block-by-block replay to head.  Returns the number
        of blocks imported.  Reentrant calls coalesce (one catch-up at
        a time; concurrent announce-triggered calls return 0)."""
        if not self._catchup_lock.acquire(blocking=False):
            return 0
        try:
            return self._catch_up_locked()
        finally:
            self._catchup_lock.release()

    def _catch_up_locked(self) -> int:
        s = self.service
        best = self.best_peer()
        if best is None:
            return 0
        (host, port), st = best
        imported = 0
        # Block replay to the peer's head (the peer may advance while we
        # replay; chase until level or the peer stops answering).  A
        # peer on another fork with a LONGER chain wins (longest-chain
        # rule): rewind to the common ancestor and replay theirs.
        # Replay verifies one aggregate pairing per block — barely
        # faster than production — so whenever the peer's FINALIZED head
        # moves past ours and the gap exceeds checkpoint_gap, warp-sync
        # again instead of crawling block by block.
        rewinds = 0
        allow_warp = True
        allow_batch = True
        batch_fetch_fails = 0
        while True:
            target = self._peer_status(host, port)
            if target is None:
                break
            if s.head_number() >= target["number"]:
                # Level with the peer's head.  Justifications are pushed
                # to the VALIDATORS' configured peers only, so a node the
                # validators don't know about (keyless observer) must
                # pull finality for blocks it already holds.
                self._pull_finality(host, port, target)
                break
            fin = target.get("finalized")
            peer_fin = fin.get("number") if isinstance(fin, dict) else 0
            if (
                allow_warp
                and target["number"] - s.head_number() > self.checkpoint_gap
                and isinstance(peer_fin, int)
                and peer_fin > s.head_number()
            ):
                before = s.head_number()
                if (self._bootstrap_checkpoint(host, port)
                        and s.head_number() > before):
                    s.m_catchup.inc()
                    continue
                allow_warp = False  # unjustified/evicted anchor: replay
            gap = target["number"] - s.head_number()
            if allow_batch and gap >= self.batch_min and rewinds == 0:
                got = self._batch_import(host, port, gap)
                if got > 0:
                    imported += got
                    batch_fetch_fails = 0
                    continue
                if got == 0:
                    # batch REFUSED (malformed range or a signature in
                    # it failed): drop to the per-block path for the
                    # rest of this run — it pins the exact failure
                    # instead of re-fetching the refused range every
                    # lap.  -1 = era-boundary cap, keep trying later
                    # laps; -2 = transient fetch failure, retry a
                    # couple of times before giving the batch up (one
                    # dropped packet must not cost a whole epoch of
                    # per-block pairings).
                    allow_batch = False
                elif got == -2:
                    batch_fetch_fails += 1
                    if batch_fetch_fails >= 2:
                        allow_batch = False
            n = s.head_number() + 1
            try:
                d = self._peer_call(host, port, "sync_block", [n],
                                    GOSSIP_TIMEOUT_S)
            except _rpc_errors():
                break
            try:
                rec = s.import_block(Block.from_json(d["block"]),
                                     trace=d.get("trace"),
                                     origin="catchup")
            except BlockImportError as e:
                if "unknown parent" in str(e) and rewinds < 2:
                    rewinds += 1
                    if self._rewind_to_common(host, port):
                        continue
                break
            except (SyncGap, KeyError, ValueError, TypeError,
                    AttributeError):
                break  # half-compliant peer response; give up on it
            if d.get("justification"):
                try:
                    s.handle_justification(
                        Justification.from_json(d["justification"])
                    )
                except (KeyError, TypeError, ValueError):
                    pass  # malformed justification: keep the block
            if rec is not None:  # None: a concurrent gossip import won
                imported += 1
        return imported

    def _batch_import(self, host: str, port: int, gap: int) -> int:
        """Range catch-up: fetch up to SYNC_RANGE_MAX consecutive blocks
        and verify ALL their signatures — author header sigs, VRF slot
        proofs, extrinsic sigs — in ONE weighted pairing product, then
        import each block with the per-block pairing skipped (structural
        claim checks and deterministic re-execution still run per
        block).  Collapses an epoch of catch-up pairings to
        1 + #distinct-signers.

        The range is capped at the next era boundary (inclusive): VRF
        messages are built from the CURRENT epoch context, which is
        exactly valid for every block up to and including the boundary
        block (rotation happens inside it, affecting only later
        claims).  Returns blocks imported; 0 means "use the per-block
        path" (range unavailable, malformed, or a signature failed —
        the slow path pins which one).  -1 means the batch was not
        applicable this lap (era-boundary cap left under two blocks) —
        the caller may try again after the boundary imports.  -2 means
        the range FETCH failed (transient peer stall / unsupported
        method) — retryable, unlike a verification refusal."""
        s = self.service
        with s.tracer.span("catchup.range", tags={"gap": gap}) as span:
            got = self._batch_import_inner(host, port, gap)
            span.tags["imported"] = got
            return got

    def _batch_import_inner(self, host: str, port: int, gap: int) -> int:
        s = self.service
        start = s.head_number() + 1
        count = min(gap, SYNC_RANGE_MAX)
        era = getattr(s.rt.config, "era_duration_blocks", 0) or 0
        if era > 0:
            boundary = start + (-start) % era  # first multiple ≥ start
            count = min(count, boundary - start + 1)
        if count < 2:
            return -1
        try:
            items = self._peer_call(host, port, "sync_block_range",
                                    [start, count], GOSSIP_TIMEOUT_S * 4)
        except _rpc_errors():
            return -2
        if not isinstance(items, list) or len(items) < 2:
            return 0
        blocks: list[Block] = []
        traces: list = []
        justs: list = []
        try:
            for want_n, d in enumerate(items, start):
                blk = Block.from_json(d["block"])
                if blk.number != want_n:
                    return 0
                blocks.append(blk)
                traces.append(d.get("trace"))
                justs.append(d.get("justification"))
        except (KeyError, TypeError, ValueError):
            return 0
        if s.head_number() + 1 != start:
            # a concurrent gossip import advanced the head while we
            # fetched — the range no longer sits on our head, and the
            # epoch context the batch would sample could postdate an
            # era boundary the range precedes.  Retryable.
            return -2
        # The service's pipelined batch path does the fold: triples
        # built under the lock against the parent state (head-motion
        # safe via the per-block VRF-message recheck), one weighted
        # pairing per import_batch_max prefix, double-buffered with
        # re-execution, per-block fallback on a refused pairing.
        outcomes = s.import_batch(blocks, traces=traces,
                                  origin="catchup-batch")
        imported = 0
        range_justs: list[Justification] = []
        for (kind, payload), just in zip(outcomes, justs):
            if kind in ("rejected", "gap"):
                # a refusal (or a gap a rejection opened) ends this
                # range; 0 with no progress drops the caller to the
                # per-block path, which pins the exact failure
                break
            if just:
                try:
                    range_justs.append(Justification.from_json(just))
                except (KeyError, TypeError, ValueError):
                    pass
            if kind == "imported":
                imported += 1
                # count only blocks whose pairings actually folded —
                # a range whose batch pairing was refused imports its
                # honest prefix through the serial fallback, and that
                # must not read as "rode the batch"
                if getattr(payload, "batch_verified", False):
                    self.batched_imports += 1
        # hand the range's justifications over as ONE batch: the base
        # service verifies them serially, a read replica
        # (light/replica.py) folds the whole batch into one weighted
        # pairing — either way they apply in height order
        if range_justs:
            s.handle_justifications(range_justs)
        return imported

    def _pull_finality(self, host: str, port: int, status: dict) -> None:
        """Fetch the justification for the peer's finalized head when it
        is ahead of ours and we already hold the block.  Verification
        (2/3 aggregate over known validators) happens inside
        ``handle_justification`` — a lying peer gains nothing."""
        s = self.service
        fin = status.get("finalized")
        peer_fin = fin.get("number") if isinstance(fin, dict) else 0
        if (
            not isinstance(peer_fin, int)
            or peer_fin <= s.finalized_number
            or peer_fin > s.head_number()
        ):
            return
        try:
            d = self._peer_call(host, port, "sync_block", [peer_fin],
                                GOSSIP_TIMEOUT_S)
        except _rpc_errors():
            return
        j = d.get("justification") if isinstance(d, dict) else None
        if j:
            try:
                s.handle_justification(Justification.from_json(j))
            except (KeyError, TypeError, ValueError):
                pass  # malformed: next poll tries another peer

    def _rewind_to_common(self, host: str, port: int) -> bool:
        """Fork resolution: walk back from our head until the peer's
        block at that height matches ours, then reorg there (bounded by
        finality and the service's state-blob window)."""
        s = self.service
        head_n = s.head_number()
        # the rewind window must stay inside the service's post-state
        # blob cache, else reorg_to finds no blob to restore
        window = getattr(s, "STATE_CACHE_BLOCKS", 64) - 8
        floor = max(s.finalized_number, head_n - window)
        for n in range(head_n, floor - 1, -1):
            if n == 0:
                return s.reorg_to(0)
            ours = s.block_by_number.get(n)
            if ours is None:
                continue
            try:
                d = self._peer_call(host, port, "sync_block", [n],
                                    GOSSIP_TIMEOUT_S)
            except _rpc_errors():
                return False
            try:
                # .hash() decodes the sig hex — a garbage "sig" raises
                # here too, and must read as "no match", not an abort
                theirs = Block.from_json(d["block"])
                matched = theirs.hash(s.genesis) == ours.hash(s.genesis)
            except (KeyError, TypeError, ValueError):
                return False
            if matched:
                return s.reorg_to(n)
        return False

    def _bootstrap_checkpoint(self, host: str, port: int) -> bool:
        """Warp-sync: restore the peer's versioned state blob and anchor
        the head so subsequent imports chain onto it."""
        try:
            # cesslint: allow[det-float] RPC timeout seconds — network
            # plumbing, never consensus state
            d = self._peer_call(host, port, "sync_checkpoint", [], 30.0)
        except _rpc_errors():
            return False
        try:
            blob = bytes.fromhex(d["blob"])
            head = Block.from_json(d["head"]) if d.get("head") else None
            just = (
                Justification.from_json(d["justification"])
                if d.get("justification") else None
            )
        except (KeyError, ValueError, TypeError, AttributeError):
            return False
        return self.service.restore_checkpoint(blob, head, just)
