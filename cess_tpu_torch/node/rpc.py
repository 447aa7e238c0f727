"""JSON-RPC server over TCP — the node's wire surface.

Role match: the reference's RPC stack (reference: node/src/rpc.rs:148-328
— System, Babe/RRSC, TransactionPayment, eth endpoints) reduced to the
capabilities this framework exposes: system info/health/metrics, chain
and state queries, extrinsic submission, and the CESS pallet views
(miner info, challenge snapshot, file metadata, TEE registry).

Framing: newline-delimited JSON-RPC 2.0 objects over a plain TCP
socket — one request per line, one response per line, connections are
persistent.  `python -m cess_tpu_torch rpc <method> [params…]` is the CLI
client; node.client.RpcClient the programmatic one."""

from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from typing import Any, Callable

from .service import Extrinsic, FeeTooLow, NodeService, PoolFull

# Most reads a state_getProofBatch request may prove in one round trip
# (one lock hold, one shared root).  Oversized batches are refused with
# the typed -32013 so a light client can split instead of guessing.
PROOF_BATCH_MAX = 64


class RpcError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _view(obj: Any) -> Any:
    """State value → JSON-safe view (dataclasses, bytes, sets, maps)."""
    import dataclasses

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _view(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, bytes):
        return {"hex": obj.hex()}
    if isinstance(obj, (list, tuple)):
        return [_view(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_view(x) for x in obj)
    if isinstance(obj, dict):
        return {str(k): _view(v) for k, v in obj.items()}
    return obj


class RpcApi:
    """Method registry bound to one NodeService."""

    def __init__(self, service: NodeService):
        self.service = service
        self.methods: dict[str, Callable] = {}
        s = service

        def method(name):
            def deco(fn):
                self.methods[name] = fn
                return fn
            return deco

        # ---- system (rpc.rs System role)
        @method("system_name")
        def _name():
            return "cess-tpu-node"

        @method("system_chain")
        def _chain():
            return s.spec.name

        @method("system_health")
        def _health():
            with s._lock:
                best = s.rt.state.block_number
                finalized = s.finalized_number
                pool = s.pool.stats(s.rt.state.nonces)
            return {
                "peers": len(s.sync.peers) if s.sync is not None else 0,
                "isSyncing": False,
                "shouldHavePeers": len(s.spec.validators) > 1,
                "txpool": pool["count"],
                # pending = executable nonce-contiguous runs; future =
                # banded ahead of the chain nonce, waiting on a gap
                "txPoolSize": {
                    "pending": pool["pending"], "future": pool["future"],
                },
                "bestBlock": best,
                # pipelined-import backlog (service.import_batch):
                # gossip blocks queued for the batch drain loop — a
                # node whose queue grows faster than it drains is
                # falling behind slot production
                "importQueue": s.import_queue_depth(),
                # durable-store health (node/store.py): True while the
                # last journal/checkpoint write hit an OSError (ENOSPC,
                # injected storage fault) and the node is running from
                # memory; clears on the next successful append.  False
                # when no --data-dir store is attached.
                "storageDegraded": (
                    bool(s.store.degraded) if s.store is not None
                    else False
                ),
                # finality lag: the observable the GRANDPA
                # accountable-safety drills need (PAPERS.md) — a node
                # whose lag grows while bestBlock advances is cut off
                # from the voter set even if gossip drops stay quiet
                "finalityLag": best - finalized,
                "finalizedBlock": finalized,
                # per-peer freshness: epoch seconds of the last
                # successful round-trip — a partitioned node's peers go
                # STALE here (drop counters only move once queues
                # overflow, which a silent partition never does)
                "peersSeen": (
                    s.sync.peers_seen() if s.sync is not None else {}
                ),
                # per-peer gossip overflow drops (node/sync.py): a
                # partitioned or hung peer shows up here instead of
                # dropping silently
                "gossipDropped": (
                    s.sync.drop_counts() if s.sync is not None else {}
                ),
            }

        @method("system_metrics")
        def _metrics():
            # merged exposition: this service's registry + the
            # process-wide proof-stage and RS-stage registries
            # (proof/fused.py and ops/rs.py observe their per-stage
            # histograms there — always on)
            from ..ops.rs import rs_stage_registry
            from ..proof.torch_backend import proof_stage_registry
            from . import metrics as _m

            return _m.render_merged(
                s.registry, proof_stage_registry(), rs_stage_registry()
            )

        @method("system_traces")
        def _traces(trace_id: str | None = None, limit: int = 32):
            """Span-tree telemetry (node/tracing.py).  Without an id:
            recent trace summaries.  With one: every span this node
            recorded for it — the CLI `trace` command merges these
            across nodes into one stitched tree.  A block number or
            hash also resolves (via the block→trace map), so `where
            did block #N spend its time?` is one call."""
            tid = trace_id
            if tid is not None:
                tid = str(tid)
                with s._lock:
                    if tid.isdigit():
                        blk = s.block_by_number.get(int(tid))
                        if blk is not None:
                            tid = s.block_traces.get(
                                blk.hash(s.genesis), tid)
                    elif tid in s.block_traces:
                        tid = s.block_traces[tid]
                spans = s.tracer.spans(trace_id=tid)
                return {
                    "traceId": tid,
                    "spans": [sp.to_json() for sp in spans],
                }
            return {"traces": s.tracer.traces(limit=int(limit))}

        @method("system_chainGenesis")
        def _genesis():
            return s.genesis

        # ---- chain
        @method("chain_getHeader")
        def _head():
            n = s.rt.state.block_number
            return {"number": n, "author": s.blocks[-1].author if s.blocks else None}

        @method("chain_getBlock")
        def _block(number: int):
            for b in s.blocks:
                if b.number == number:
                    return {
                        "number": b.number, "author": b.author,
                        "extrinsics": b.extrinsics, "receipts": b.receipts,
                    }
            raise RpcError(-32004, "block not found")

        @method("state_getStateHash")
        def _shash():
            return s.state_hash()

        @method("state_getRoot")
        def _sroot():
            """Head state-trie root (same value as state_getStateHash —
            the state hash IS the keyed sparse-Merkle root since
            checkpoint v7; kept as its own method so proof clients name
            the commitment they verify against)."""
            with s._lock:
                return s.statedb.root_hex()

        def _prover():  # holds-lock: _lock
            """The commitment read proofs are served from: a replica's
            FINALIZED view (light/replica.py — every proof verifies
            against a root a light client can justify for itself),
            else the head-state trie."""
            plane = getattr(s, "read_plane", None)
            return plane if plane is not None else s.statedb

        def _count_read(n: int, seconds: float) -> None:
            """Replica read-plane metrics, when this service carries
            them (ReplicaService): served proofs + build time."""
            reads = getattr(s, "m_replica_reads", None)
            if reads is not None:
                reads.inc(n)
                s.m_replica_proof.observe(seconds)

        @method("state_getProof")
        def _sproof(pallet: str, attr: str, key=None):
            """Merkle read proof for one state entry (chain/smt.py wire
            form) — against the FINALIZED root on a replica, the head
            root otherwise.  `key` is required for keyed maps
            (balances.accounts, nonces, deal_map, file) and must be
            omitted for whole-attribute leaves.  Verify standalone
            with chain/checkpoint.py verify_read — no local state."""
            t0 = time.perf_counter()
            with s._lock:
                try:
                    out = _prover().prove(pallet, attr, key=key)
                except (ValueError, AttributeError) as e:
                    raise RpcError(-32602, str(e))
            _count_read(1, time.perf_counter() - t0)
            return out

        @method("state_getProofBatch")
        def _sproof_batch(reads, root=None):
            """N read proofs against ONE root in one round trip — the
            light-client read path (light/client.py).  `reads` is a
            list of [pallet, attr, key-or-null] entries, all proven
            under a single lock hold so every wire commits to the
            returned root.  A caller that pins `root` (its justified
            anchor) is refused with -32014 when the serving root has
            moved past it — the client re-anchors and retries — and a
            batch above PROOF_BATCH_MAX is refused with -32013; both
            codes are typed so clients can react without string
            matching (docs/rpc.md)."""
            if not isinstance(reads, list) or not reads:
                raise RpcError(-32602, "reads must be a non-empty list")
            if len(reads) > PROOF_BATCH_MAX:
                raise RpcError(
                    -32013,
                    f"proof batch too large: {len(reads)} reads > "
                    f"max {PROOF_BATCH_MAX}")
            for r in reads:
                if not isinstance(r, (list, tuple)) or not 2 <= len(r) <= 3:
                    raise RpcError(
                        -32602,
                        "each read must be [pallet, attr, key-or-null]")
            t0 = time.perf_counter()
            with s._lock:
                prover = _prover()
                serving = prover.root_hex()
                if root is not None and root != serving:
                    raise RpcError(
                        -32014,
                        f"root mismatch: serving {serving}, "
                        f"requested {root}")
                proofs = []
                try:
                    for r in reads:
                        pallet, attr = r[0], r[1]
                        key = r[2] if len(r) == 3 else None
                        proofs.append(prover.prove(pallet, attr, key=key))
                except (ValueError, AttributeError, TypeError) as e:
                    raise RpcError(-32602, str(e))
            if any(p["root"] != serving for p in proofs):
                # cannot happen under the single lock hold above; kept
                # as a hard guard so a future prover that releases the
                # lock mid-batch fails loudly instead of mixing roots
                raise RpcError(-32014, "mixed-root batch")
            _count_read(len(reads), time.perf_counter() - t0)
            return {"root": serving, "proofs": proofs}

        @method("state_getEvents")
        def _events(last: int = 20):
            return _view(list(s.rt.state.events)[-int(last):])

        @method("chain_getEvents")
        def _block_events(block_ref):
            """Deposited events of ONE block (hash or number), with the
            digest of their canonical encoding — the lockstep tests
            assert this is bit-identical on every replica."""
            entry = s.events_of_block(block_ref)
            if entry is None:
                raise RpcError(-32004, "block events not held")
            bh, number, events, digest = entry
            return {
                "blockHash": bh,
                "number": number,
                "digest": digest,
                "events": [
                    {"pallet": e.pallet, "name": e.name,
                     "fields": _view(dict(e.fields))}
                    for e in events
                ],
            }

        # ---- author
        @method("author_submitExtrinsic")
        def _submit(ext: dict):
            # typed backpressure first (PoolFull/FeeTooLow are
            # ValueError subclasses): clients distinguish "resubmit
            # later / bump the fee" from permanent rejections
            try:
                return s.submit_extrinsic(Extrinsic.from_json(ext))
            except PoolFull as e:
                raise RpcError(-32011, str(e))
            except FeeTooLow as e:
                raise RpcError(-32012, str(e))
            except (ValueError, KeyError) as e:
                raise RpcError(-32010, str(e))

        @method("author_gossipExtrinsic")
        def _gossip(ext: dict):
            """Peer-pool intake: like author_submitExtrinsic but never
            re-broadcast (fully-connected mesh, no relay loops).  Nonce
            or duplicate mismatches are expected races, not errors."""
            try:
                return s.submit_extrinsic(
                    Extrinsic.from_json(ext), gossip=False)
            except (ValueError, KeyError) as e:
                return f"dropped: {e}"

        @method("author_pendingExtrinsics")
        def _pending():
            return len(s.pool)

        @method("author_nonce")
        def _nonce(account: str):
            # floor at the CONSENSUS nonce: the intake high-water mark
            # rolls back when pooled transactions are evicted or shed
            # in a reorg, and must never hand a signer a nonce the
            # chain has already consumed
            with s._lock:
                return max(s.nonces.get(account, 0),
                           s.rt.state.nonces.get(account, 0))

        @method("author_poolStatus")
        def _pool_status():
            """Weighted-mempool inspection: band sizes, byte usage vs
            the hard bound, lifetime evictions."""
            with s._lock:
                st = s.pool.stats(s.rt.state.nonces)
            return {
                **st,
                "maxCount": s.pool.max_count,
                "maxBytes": s.pool.max_bytes,
                "evictions": s.pool.evictions,
            }

        @method("chain_accountNonce")
        def _chain_nonce(account: str):
            """CONSENSUS nonce (state.nonces): how many of the
            account's extrinsics actually executed in blocks — the
            inclusion observable, distinct from author_nonce's
            intake high-water mark."""
            return s.rt.state.nonces.get(account, 0)

        # ---- fees (pallet-transaction-payment RPC role)
        @method("fees_estimate")
        def _fee_estimate(module: str, call: str, tip: int = 0):
            """Pre-submission fee quote: what this call costs and the
            pool priority it would enter with."""
            from ..chain import fees as fees_mod

            weight = fees_mod.weight_of(module, call)
            operational = fees_mod.is_operational(module, call)
            fee = s.rt.fees.fee_of(module, call)
            tip = int(tip)
            return {
                "weight": weight,
                "baseFee": s.rt.fees.base_fee,
                "feePerWeight": s.rt.fees.fee_per_weight,
                "fee": fee,
                "tip": tip,
                "total": fee + tip,
                "operational": operational,
                "priority": fees_mod.priority(fee, tip, weight,
                                              operational),
            }

        @method("fees_state")
        def _fee_state():
            """Fee-market consensus state: weight budget and where the
            charged fees went (20/80 treasury/author split)."""
            from ..chain.staking import TREASURY_POT

            with s._lock:
                f = s.rt.fees
                return {
                    "blockWeightLimit": f.block_weight_limit,
                    "totalFees": f.total_fees,
                    "paidAuthor": dict(f.paid_author),
                    "paidTreasury": f.paid_treasury,
                    "treasuryFree": s.rt.state.balances.free(TREASURY_POT),
                }

        # ---- cess pallet views (rpc.rs custom-API role)
        @method("balances_free")
        def _free(account: str):
            return s.rt.state.balances.free(account)

        @method("sminer_minerInfo")
        def _miner(account: str):
            info = s.rt.sminer.miner_items.get(account)
            if info is None:
                raise RpcError(-32004, "miner not found")
            return _view(info)

        @method("sminer_allMiners")
        def _miners():
            return s.rt.sminer.get_all_miner()

        @method("sminer_rewardInfo")
        def _reward(account: str):
            return _view(s.rt.sminer.reward_map.get(account))

        @method("audit_challengeSnapshot")
        def _chal():
            return _view(s.rt.audit.challenge_snap_shot)

        @method("fileBank_fileInfo")
        def _file(file_hash: str):
            f = s.rt.file_bank.file.get(file_hash)
            if f is None:
                raise RpcError(-32004, "file not found")
            return _view(f)

        @method("storage_userOwnedSpace")
        def _space(account: str):
            return _view(s.rt.storage_handler.user_owned_space.get(account))

        @method("teeWorker_podr2Key")
        def _podr2():
            pk = s.rt.tee_worker.tee_podr2_pk
            return None if pk is None else {"hex": pk.hex()}

        @method("teeWorker_controllers")
        def _tees():
            return s.rt.tee_worker.get_controller_list()

        @method("staking_validators")
        def _vals():
            return _view(s.rt.staking.validators)

        # ---- eth surface (node/src/rpc.rs:179-323 role): hex-quantity
        # in/out per the eth JSON-RPC convention
        def _h160(a: str) -> bytes:
            raw = bytes.fromhex(a[2:] if a.startswith("0x") else a)
            if len(raw) != 20:
                raise RpcError(-32602, "bad address")
            return raw

        @method("eth_chainId")
        def _eth_chain():
            from ..chain.evm import CHAIN_ID

            return hex(CHAIN_ID)

        @method("eth_blockNumber")
        def _eth_bn():
            return hex(s.rt.state.block_number)

        @method("eth_getBalance")
        def _eth_bal(address: str, block: str = "latest"):
            return hex(s.rt.evm.balances.get(_h160(address), 0))

        @method("eth_getTransactionCount")
        def _eth_nonce(address: str, block: str = "latest"):
            from ..chain.evm import EvmAccount

            return hex(s.rt.evm.accounts.get(_h160(address), EvmAccount()).nonce)

        @method("eth_getCode")
        def _eth_code(address: str, block: str = "latest"):
            from ..chain.evm import EvmAccount

            return "0x" + s.rt.evm.accounts.get(
                _h160(address), EvmAccount()
            ).code.hex()

        @method("eth_getStorageAt")
        def _eth_storage(address: str, slot: str, block: str = "latest"):
            v = s.rt.evm.storage.get((_h160(address), int(slot, 16)), 0)
            return "0x" + v.to_bytes(32, "big").hex()

        @method("eth_call")
        def _eth_call(tx: dict, block: str = "latest"):
            """Read-only execution against current state (rolled back)."""
            caller = _h160(tx.get("from", "0x" + "00" * 20))
            data = bytes.fromhex(tx.get("data", "0x")[2:])
            gas = int(tx.get("gas", "0x989680"), 16)
            # snapshot/execute/restore mutate live EVM state: without
            # the service lock a concurrent block execution on the
            # authoring/import thread interleaves with the scratch run
            # and the restore clobbers committed writes (cesslint
            # lock-rpc-private)
            with s._lock:
                snap = s.rt.evm._snapshot()
                try:
                    res = s.rt.evm.call(
                        caller, _h160(tx["to"]), data=data,
                        value=int(tx.get("value", "0x0"), 16), gas=gas,
                    )
                finally:
                    s.rt.evm._restore(snap)
            if not res.success:
                raise RpcError(-32015, f"execution reverted: {res.error}")
            return "0x" + res.return_data.hex()

        @method("eth_estimateGas")
        def _eth_estimate(tx: dict, block: str = "latest"):
            from ..chain.evm import G_TX

            caller = _h160(tx.get("from", "0x" + "00" * 20))
            data = bytes.fromhex(tx.get("data", "0x")[2:])
            # same scratch-run discipline as eth_call above
            with s._lock:
                snap = s.rt.evm._snapshot()
                try:
                    if tx.get("to"):
                        res = s.rt.evm.call(
                            caller, _h160(tx["to"]), data=data,
                            value=int(tx.get("value", "0x0"), 16),
                            gas=30_000_000,
                        )
                    else:
                        res = s.rt.evm.create(
                            caller, data,
                            value=int(tx.get("value", "0x0"), 16),
                            gas=30_000_000,
                        )
                finally:
                    s.rt.evm._restore(snap)
            if not res.success:
                raise RpcError(-32015, f"execution reverted: {res.error}")
            return hex(res.gas_used + G_TX)

        # ---- sync + finality (node/sync.py wire surface: the block
        # announce/request protocols and GRANDPA gossip of the reference,
        # service.rs:219-584)
        from .sync import (
            SYNC_PROTO_VERSION, Block, BlockImportError, Justification,
            Vote,
        )

        @method("sync_status")
        def _sync_status():
            return {
                "version": SYNC_PROTO_VERSION,
                "genesis": s.genesis,
                "number": s.rt.state.block_number,
                "hash": s.head_hash,
                "slot": s.slot,
                "finalized": {
                    "number": s.finalized_number, "hash": s.finalized_hash,
                },
            }

        @method("sync_announce")
        def _sync_announce(block: dict, trace=None):
            try:
                return s.handle_announce(block, trace=trace)
            except BlockImportError as e:
                raise RpcError(-32020, str(e))

        @method("sync_block")
        def _sync_block(number: int):
            blk = s.block_by_number.get(int(number))
            if blk is None:
                raise RpcError(-32004, "block not held")
            just = s.justifications.get(int(number))
            return {
                "block": blk.to_json(),
                "justification": None if just is None else just.to_json(),
                # trace-id envelope (telemetry): lets a catch-up
                # importer stitch its spans onto the author's trace
                "trace": s.block_traces.get(blk.hash(s.genesis)),
            }

        @method("sync_block_range")
        def _sync_block_range(start: int, count: int):
            """Consecutive held blocks from `start` (capped) with their
            justifications — the range-batch catch-up feed
            (sync.SyncManager._batch_import): the requester verifies
            every signature in the range as ONE weighted pairing."""
            from .sync import SYNC_RANGE_MAX

            out = []
            start = int(start)
            for n in range(start, start + min(int(count), SYNC_RANGE_MAX)):
                blk = s.block_by_number.get(n)
                if blk is None:
                    break
                just = s.justifications.get(n)
                out.append({
                    "block": blk.to_json(),
                    "justification": (
                        None if just is None else just.to_json()
                    ),
                    "trace": s.block_traces.get(blk.hash(s.genesis)),
                })
            return out

        @method("rrsc_epochInfo")
        def _epoch_info():
            """Epoch consensus state (consensus/): replicas on
            the same chain must report identical values — asserted by
            the testnet e2e."""
            rrsc = s.rt.rrsc
            return {
                "epochIndex": rrsc.epoch_index,
                "randomness": rrsc.epoch_randomness.hex(),
                "accumulator": rrsc.vrf_accumulator.hex(),
                "foldCount": rrsc.vrf_fold_count,
            }

        @method("sync_checkpoint")
        def _sync_checkpoint():
            # Serve the FINALIZED anchor: a warp blob is only trusted by
            # the receiver when covered by a 2/3 justification, so the
            # post-state blob / head block / justification triple must
            # all be for the same finalized height.  Catch-up replays
            # the rest of the chain block by block.
            with s._lock:
                number = s.finalized_number
                head = s.block_by_number.get(s.finalized_number)
                just = s.justifications.get(s.finalized_number)
                blob = None
                if head is not None and just is not None:
                    bh = head.hash(s.genesis)
                    if (bh == s.finalized_hash
                            and number == s.rt.state.block_number):
                        # the finalized anchor IS the current head, so
                        # its post-state is exportable directly.  (A
                        # finalized block BEHIND head has no full blob
                        # any more — the per-block blob cache became
                        # leaf deltas — so fall through to the
                        # unjustified-head path below and let the
                        # receiver replay blocks instead.)
                        blob = s.export_state()
                if blob is None:
                    # nothing finalized (or blob evicted): the receiver
                    # will reject an unjustified anchor and fall back to
                    # block replay
                    number = s.rt.state.block_number
                    head = s.block_store.get(s.head_hash)
                    just = None
                    blob = s.export_state()
                return {
                    "number": number,
                    "blob": blob.hex(),
                    "head": None if head is None else head.to_json(),
                    "justification": (
                        None if just is None else just.to_json()
                    ),
                }

        @method("sync_offence")
        def _sync_offence(report: dict):
            """Offence-report gossip intake (chain/offences.py): the
            service independently re-verifies the evidence before
            relaying or submitting anything — a forged report from a
            malicious peer is a no-op."""
            try:
                return s.handle_offence_report(report)
            except (KeyError, TypeError, ValueError) as e:
                raise RpcError(-32023, f"malformed offence report: {e!r}")

        @method("offences_state")
        def _offences_state():
            """Offence registry view: convictions, strikes, chills, and
            the live heartbeat record — what liveness drills assert."""
            off = s.rt.offences
            return {
                "reports": [
                    _view(rec) for _, rec in sorted(off.reports.items())
                ],
                "pending": len(off.pending),
                "strikes": _view(off.strikes),
                "chilledUntil": _view(s.rt.staking.chilled_until),
                "heartbeats": {
                    str(sess): sorted(who)
                    for sess, who in off.heartbeats.items()
                },
                "sessionIndex": s.rt.session.session_index,
            }

        @method("sync_vote")
        def _sync_vote(vote: dict):
            try:
                return s.add_vote(Vote.from_json(vote))
            except (KeyError, TypeError, ValueError) as e:
                raise RpcError(-32021, f"malformed vote: {e!r}")

        @method("sync_justification")
        def _sync_just(just: dict):
            try:
                return s.handle_justification(Justification.from_json(just))
            except (KeyError, TypeError, ValueError) as e:
                raise RpcError(-32022, f"malformed justification: {e!r}")

        @method("chain_finalized_head")
        def _finalized():
            return {"number": s.finalized_number, "hash": s.finalized_hash}

        @method("chain_getJustification")
        def _get_justification(ref=None):
            """Pull-RPC finality feed (light/client.py): justifications
            were push-only gossip before this — a stateless client (or
            an observer the validators never knew about) can now ASK.
            `ref` is a block number, a block hash, or null for the
            latest held justification.  The per-height store is
            bounded (service.JUST_RETENTION_BLOCKS): pruned or
            never-held heights answer -32004 and the client re-anchors
            from a newer justification."""
            with s._lock:
                just = None
                if ref is None:
                    if s.justifications:
                        just = s.justifications[max(s.justifications)]
                elif isinstance(ref, bool):
                    pass  # bool is an int subclass; refuse it as a ref
                elif isinstance(ref, int) or (
                    isinstance(ref, str) and ref.isdigit()
                ):
                    just = s.justifications.get(int(ref))
                elif isinstance(ref, str):
                    just = next(
                        (j for j in s.justifications.values()
                         if j.block_hash == ref), None)
            if just is None:
                raise RpcError(-32004, "justification not held")
            return just.to_json()

        @method("light_syncHeaders")
        def _light_headers(start: int, count: int = 1):
            """Finality-proof-carrying HEADER range for light clients:
            each entry is {header, justification-or-null}, the body
            replaced by its extRoot commitment so the client recomputes
            every block hash (sync.header_hash) — and checks each
            justification really covers its header — without
            downloading extrinsics.  Capped at SYNC_RANGE_MAX like
            sync_block_range."""
            from .sync import SYNC_RANGE_MAX

            out = []
            start = int(start)
            with s._lock:
                for n in range(
                    start, start + min(int(count), SYNC_RANGE_MAX)
                ):
                    blk = s.block_by_number.get(n)
                    if blk is None:
                        break
                    just = s.justifications.get(n)
                    out.append({
                        "header": blk.header_json(),
                        "justification": (
                            None if just is None else just.to_json()
                        ),
                    })
            return out

        # ---- audit offchain views (what the miner/TEE role clients
        # poll to drive a live audit round)
        @method("audit_unverifyProof")
        def _unverify(tee: str):
            return _view(s.rt.audit.unverify_proof.get(tee, []))

        @method("audit_challengeDuration")
        def _chal_duration():
            return {
                "challenge": s.rt.audit.challenge_duration,
                "verify": s.rt.audit.verify_duration,
            }

        @method("audit_challengeProposals")
        def _chal_proposals():
            """Open challenge-vote tallies (the quorum forming): one
            entry per proposal hash with its vote count and voters —
            how liveness drills see a stalled or split quorum."""
            return {
                h.hex()[:16]: {
                    "votes": votes,
                    "voters": sorted(
                        s.rt.audit.proposal_voters.get(h, set())),
                }
                for h, (votes, _info)
                in s.rt.audit.challenge_proposal.items()
            }

        # ---- dev helpers
        @method("dev_produceBlock")
        def _produce():
            rec = s.produce_block()
            return None if rec is None else {
                "number": rec.number, "receipts": rec.receipts,
            }

    def handle(self, request: dict) -> dict:
        rid = request.get("id")
        name = request.get("method", "")
        params = request.get("params", [])
        fn = self.methods.get(name)
        if fn is None:
            return {
                "jsonrpc": "2.0", "id": rid,
                "error": {"code": -32601, "message": f"no method {name}"},
            }
        try:
            result = fn(*params) if isinstance(params, list) else fn(**params)
            return {"jsonrpc": "2.0", "id": rid, "result": result}
        except RpcError as e:
            return {
                "jsonrpc": "2.0", "id": rid,
                "error": {"code": e.code, "message": str(e)},
            }
        except Exception as e:  # surface, don't kill the connection
            return {
                "jsonrpc": "2.0", "id": rid,
                "error": {"code": -32603, "message": f"{type(e).__name__}: {e}"},
            }


class RpcServer:
    """Threaded newline-JSON TCP server (the rpc_builder role,
    service.rs:319-354)."""

    def __init__(self, service: NodeService, host: str = "127.0.0.1",
                 port: int = 0):
        api = RpcApi(service)

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError:
                        resp = {
                            "jsonrpc": "2.0", "id": None,
                            "error": {"code": -32700, "message": "parse error"},
                        }
                    else:
                        resp = api.handle(req)
                    self.wfile.write(
                        json.dumps(resp, separators=(",", ":")).encode()
                        + b"\n"
                    )
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.api = api
        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def rpc_call(host: str, port: int, method: str, params: list | None = None,
             timeout: float = 30.0):
    """One-shot client call (shared by the CLI and tests)."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(
            json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method,
                 "params": params or []},
                separators=(",", ":"),
            ).encode() + b"\n"
        )
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    if not buf:
        # The server accepted the connection but never answered (its
        # handler starved behind the service lock, or it shut down
        # mid-request).  Surface a TRANSIENT socket-shaped error, not a
        # JSONDecodeError — callers treat OSError as retryable.
        raise ConnectionError("connection closed before response")
    resp = json.loads(buf)
    if "error" in resp:
        raise RpcError(resp["error"]["code"], resp["error"]["message"])
    return resp["result"]
