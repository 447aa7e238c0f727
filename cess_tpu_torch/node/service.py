"""Node service: signed-extrinsic pool → slot-driven block production,
block import, and BLS-aggregate finality.

Role match: the reference's service assembly (reference:
node/src/service.rs:219-584 — tx pool, import queue, RRSC authoring
loop, GRANDPA voter) collapsed onto the deterministic Runtime:
extrinsics are BLS-signed, nonce-ordered, verified at intake (the
pool's validation role), and applied in block order after
on_initialize, with per-block receipts as the event record.  The RRSC
stand-in (chain/rrsc.py) picks the slot author from a monotone slot
counter; a service configured with an authority key authors only its
own slots.

Authored blocks carry the author's BLS signature over (parent hash,
slot, extrinsic root, post-state hash) and are announced to peers via
the attached node/sync.py SyncManager; `import_block` re-executes peer
blocks deterministically and rejects wrong-author, bad-signature, or
state-hash-mismatched blocks.  Every `finality_period` blocks the
validator signs the canonical head; 2/3 BLS-aggregate justifications
finalize it (the GRANDPA-gadget role).  The slot hook also runs the
audit offchain worker for this node's authority and submits resulting
extrinsics through its own pool, so a CLI-launched chain completes
audit rounds with no external driver."""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from ..chain.runtime import Runtime
from ..chain.state import StateDB
from ..chain.types import DispatchError
from ..chain import checkpoint
from ..chain import fees as fees_mod
from ..chain import offences as offences_mod
from ..consensus import ClaimError, engine as consensus
from ..consensus import vrf as vrf_mod
from ..device import resolve_device
from ..ops import bls12_381 as bls
from .chain_spec import ChainSpec, dev_sk
from .sync import (
    Block,
    BlockImportError,
    Justification,
    SyncGap,
    Vote,
    canonical_json,
    finality_payload,
    quorum,
    verify_justification,
)
from . import metrics as m
from . import tracing


# ------------------------------------------------------------ extrinsic


@dataclass
class Extrinsic:
    """Signed call: the reference's UncheckedExtrinsic role.  args are
    JSON values; byte arguments travel as {"hex": "..."}."""

    signer: str
    module: str
    call: str
    args: list
    nonce: int
    # Fee-market priority bump (pallet-transaction-payment's tip role):
    # part of the signed payload, charged on top of the weight fee.
    tip: int = 0
    signature: str = ""  # hex BLS signature over payload()

    def payload(self, genesis: str) -> bytes:
        # sync.canonical_json is THE consensus byte encoding — block
        # signing payloads embed hashes of these bytes, so the two
        # must never diverge
        return canonical_json(
            [genesis, self.signer, self.module, self.call, self.args,
             self.nonce, self.tip]
        )

    def sign(self, sk: int, genesis: str) -> "Extrinsic":
        self.signature = bls.sign(sk, self.payload(genesis)).hex()
        return self

    def hash(self, genesis: str) -> str:
        return hashlib.blake2b(
            self.payload(genesis) + bytes.fromhex(self.signature),
            digest_size=32,
        ).hexdigest()

    def to_json(self) -> dict:
        return {
            "signer": self.signer, "module": self.module, "call": self.call,
            "args": self.args, "nonce": self.nonce, "tip": self.tip,
            "sig": self.signature,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Extrinsic":
        return cls(
            signer=d["signer"], module=d["module"], call=d["call"],
            args=list(d["args"]), nonce=int(d["nonce"]),
            tip=int(d.get("tip", 0)),
            signature=d.get("sig", ""),
        )


def _decode_arg(v):
    if isinstance(v, dict) and set(v) == {"hex"}:
        return bytes.fromhex(v["hex"])
    if isinstance(v, list):
        return [_decode_arg(x) for x in v]
    return v


def _b(v) -> bytes:
    """JSON arg → bytes ({"hex": …} or plain hex string)."""
    if isinstance(v, dict):
        return bytes.fromhex(v["hex"])
    return bytes.fromhex(v)


def _adapt_tee_register(rt, sender, args):
    from ..chain.tee_worker import SgxAttestationReport
    from ..utils.hashing import Hash64  # noqa: F401 (coercion set below)

    stash, node_key, peer, pbk, att = args
    rt.tee_worker.register(
        sender, stash, _b(node_key), _b(peer), _b(pbk),
        SgxAttestationReport(
            report_json_raw=_b(att["report"]),
            sign=_b(att["sign"]),
            cert_der=_b(att["cert"]),
        ),
    )


def _adapt_upload_declaration(rt, sender, args):
    from ..chain.file_bank import SegmentList, UserBrief
    from ..utils.hashing import Hash64

    file_hash, deal_info, brief, size = args
    segs = [
        SegmentList(
            hash=Hash64(s["hash"]),
            fragment_list=[Hash64(h) for h in s["fragments"]],
        )
        for s in deal_info
    ]
    ub = UserBrief(
        user=brief["user"], file_name=brief["fileName"],
        bucket_name=brief["bucket"],
    )
    rt.file_bank.upload_declaration(sender, Hash64(file_hash), segs, ub,
                                    int(size))


def _adapt_upload_filler(rt, sender, args):
    from ..chain.file_bank import FillerInfo
    from ..utils.hashing import Hash64

    tee, fillers = args
    infos = [
        FillerInfo(
            block_num=rt.state.block_number,
            miner_address=sender,
            filler_hash=Hash64(f),
        )
        for f in fillers
    ]
    rt.file_bank.upload_filler(sender, tee, infos)


def challenge_info_to_json(info) -> dict:
    """ChallengeInfo → JSON extrinsic argument (the OCW's unsigned
    challenge-vote payload, reference: audit lib.rs:364-416).  Every
    validator derives the identical info from shared randomness, so the
    canonical JSON round-trips to the identical proposal hash."""
    net = info.net_snap_shot
    return {
        "net": {
            "start": net.start, "life": net.life,
            "totalReward": net.total_reward,
            "totalIdle": net.total_idle_space,
            "totalService": net.total_service_space,
            "indexList": list(net.random_index_list),
            "randomList": [r.hex() for r in net.random_list],
        },
        "miners": [
            {"miner": s.miner, "idle": s.idle_space, "service": s.service_space}
            for s in info.miner_snapshot_list
        ],
    }


def challenge_info_from_json(d: dict):
    from ..chain.audit import ChallengeInfo, MinerSnapShot, NetSnapShot

    net = d["net"]
    return ChallengeInfo(
        net_snap_shot=NetSnapShot(
            start=int(net["start"]), life=int(net["life"]),
            total_reward=int(net["totalReward"]),
            total_idle_space=int(net["totalIdle"]),
            total_service_space=int(net["totalService"]),
            random_index_list=[int(i) for i in net["indexList"]],
            random_list=[bytes.fromhex(r) for r in net["randomList"]],
        ),
        miner_snapshot_list=[
            MinerSnapShot(
                miner=s["miner"], idle_space=int(s["idle"]),
                service_space=int(s["service"]),
            )
            for s in d["miners"]
        ],
    )


def _adapt_save_challenge(rt, sender, args):
    """Challenge vote intake: the validate_unsigned + call seam
    (reference: audit lib.rs:540-556).  `save_challenge_info` itself
    enforces authority membership and the per-key replay guard."""
    rt.audit.save_challenge_info(
        challenge_info_from_json(args[0]), sender, signature=None
    )


# Callable extrinsics: (module, call) → adapter (None = generic
# sender-first dispatch with JSON args).  Matches the pallets' origin
# argument (reference: each #[pallet::call]); root-only and
# scheduler-only calls (calculate_end, deal_reassign_miner,
# update_whitelist, the unsigned quorum intake) are absent by design.
EXTRINSIC_DISPATCH: dict = {
    **{("sminer", c): None for c in (
        "regnstk", "increase_collateral", "update_beneficiary",
        "update_peer_id", "receive_reward", "faucet_top_up", "faucet",
        "withdraw",
    )},
    **{("storage_handler", c): None for c in (
        "buy_space", "expansion_space", "renewal_space",
    )},
    **{("oss", c): None for c in (
        "authorize", "cancel_authorize", "register", "update", "destroy",
    )},
    **{("cacher", c): None for c in ("logout",)},
    **{("staking", c): None for c in (
        "bond", "bond_extra", "unbond", "withdraw_unbonded", "validate",
        "nominate", "chill",
    )},
    ("tee_worker", "exit"): None,
    ("tee_worker", "register"): _adapt_tee_register,
    **{("file_bank", c): None for c in (
        "transfer_report", "replace_file_report", "delete_file",
        "create_bucket", "delete_bucket", "generate_restoral_order",
        "claim_restoral_order", "restoral_order_complete",
        "miner_exit_prep",
    )},
    ("file_bank", "upload_declaration"): _adapt_upload_declaration,
    ("file_bank", "upload_filler"): _adapt_upload_filler,
    **{("audit", c): None for c in (
        "submit_proof", "submit_verify_result",
    )},
    ("audit", "save_challenge_info"): _adapt_save_challenge,
    # im-online heartbeat + offence evidence intake (reference:
    # im-online/offences pallets at runtime/src/lib.rs:1509).  Both
    # dispatch generically: heartbeat(sender, session_index) and
    # report_offence(sender, report_json) — the report re-verifies its
    # own evidence inside the pallet, so any account may carry it.
    **{("offences", c): None for c in ("heartbeat", "report_offence")},
    # pallet_evm call/create/deposit/withdraw role (reference:
    # runtime/src/lib.rs:1322-1344)
    **{("evm", c): None for c in ("deposit", "withdraw")},
    ("evm", "transact_call"): lambda rt, sender, args: rt.evm.transact_call(
        sender, _b(args[0]), _b(args[1]) if len(args) > 1 else b"",
        *[int(a) for a in args[2:]],
    ),
    ("evm", "transact_create"): lambda rt, sender, args: rt.evm.transact_create(
        sender, _b(args[0]), *[int(a) for a in args[1:]],
    ),
}


# ------------------------------------------------------------ tx pool


class PoolFull(ValueError):
    """Typed intake backpressure: the pool (or the signer's per-account
    band) is at capacity and the incoming extrinsic cannot displace
    anything — the RPC layer maps this to its own error code instead of
    silently dropping."""


class FeeTooLow(ValueError):
    """Typed intake backpressure: the extrinsic's fee is insufficient —
    an underbid replacement, or a signer who cannot pay the weight fee."""


@dataclass
class PoolEntry:
    """One pooled extrinsic with its fee-market ordering data, computed
    once at intake (chain/fees.py)."""

    ext: Extrinsic
    hash: str
    priority: int  # fees.priority(): fee-per-weight, ×1000, op-boosted
    weight: int
    fee: int       # fee + tip the signer will be charged at application
    size: int      # canonical wire bytes, counted against the byte bound
    seq: int = 0   # intake order: the priority tiebreak (older first)


class TxPool:
    """Priority-ordered weighted mempool (the reference pool's
    ready/future split plus Substrate's fee-per-weight ordering).

    Entries live in per-account nonce→entry maps.  An account's PENDING
    band is the contiguous nonce run from its chain nonce; anything
    past a gap is FUTURE, admitted only within `future_band` of the
    contiguous end so a nonce-gapped account cannot pin slots.
    Eviction always takes an account's TAIL (highest nonce), keeping
    bands contiguous; the global count/byte bounds displace the
    lowest-priority tail in the pool, and an extrinsic that cannot
    displace anything is refused with a typed error (PoolFull /
    FeeTooLow) instead of silently dropped."""

    def __init__(self, max_count: int = 2048, max_bytes: int = 1 << 20,
                 per_account: int = 16, future_band: int = 8) -> None:
        self._lock = threading.Lock()
        self.max_count = max_count
        self.max_bytes = max_bytes
        self.per_account = per_account
        self.future_band = future_band
        self._by_account: dict[str, dict[int, PoolEntry]] = {}  # guarded-by: _lock
        self._hashes: set[str] = set()  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.evictions = 0  # lifetime (cess_pool_evictions)  # guarded-by: _lock

    # -------------------------------------------------------- internals

    def _insert(self, entry: PoolEntry) -> None:  # holds-lock: _lock
        self._by_account.setdefault(
            entry.ext.signer, {})[entry.ext.nonce] = entry
        self._hashes.add(entry.hash)
        self._bytes += entry.size
        self._count += 1

    def _drop(self, entry: PoolEntry) -> None:  # holds-lock: _lock
        acct = self._by_account.get(entry.ext.signer)
        if acct is None or acct.get(entry.ext.nonce) is not entry:
            return
        del acct[entry.ext.nonce]
        if not acct:
            del self._by_account[entry.ext.signer]
        self._hashes.discard(entry.hash)
        self._bytes -= entry.size
        self._count -= 1

    def _lowest_tail(self, skip: set[str],
                     exclude_signer: str) -> "PoolEntry | None":
        """The lowest-priority account-tail entry — the only entries
        evictable without breaking a nonce band.  Never the incoming
        signer's own tail (evicting it could gap the incoming nonce)."""
        best = None
        for signer, entries in self._by_account.items():
            if signer == exclude_signer:
                continue
            # walk past already-chosen victims to the effective tail:
            # the entries above it are being dropped in the same
            # operation, so the band stays contiguous
            tail = None
            for n in sorted(entries, reverse=True):
                if entries[n].hash not in skip:
                    tail = entries[n]
                    break
            if tail is None:
                continue
            if best is None or (tail.priority, -tail.seq) < (
                best.priority, -best.seq
            ):
                best = tail
        return best

    # ---------------------------------------------------------- intake

    def submit(self, entry: PoolEntry, base: int) -> list[PoolEntry]:
        """Admit one entry; `base` is the signer's CHAIN nonce (start of
        the pending band).  Returns the entries evicted to make room.
        Raises ValueError (duplicate / future-band), FeeTooLow (underbid
        replacement), or PoolFull (capacity with nothing displaceable)."""
        ext = entry.ext
        with self._lock:
            if entry.hash in self._hashes:
                raise ValueError("duplicate extrinsic")
            acct = self._by_account.get(ext.signer, {})
            old = acct.get(ext.nonce)
            if old is not None:
                # fee-bump replacement: same account+nonce needs a ≥10%
                # priority bump over the pooled transaction
                required = old.priority + (old.priority + 9) // 10
                if entry.priority < required:
                    raise FeeTooLow(
                        f"replacement underpriced: priority "
                        f"{entry.priority} < required {required} "
                        "(>=10% bump)")
                self._seq += 1
                entry.seq = self._seq
                self._drop(old)
                self._insert(entry)
                return []
            # future-nonce banding: past the contiguous run + band → out
            nxt = base
            while nxt in acct:
                nxt += 1
            if ext.nonce > nxt + self.future_band:
                raise ValueError(
                    f"nonce {ext.nonce} too far in the future "
                    f"(accepting up to {nxt + self.future_band})")
            victims: list[PoolEntry] = []
            skip: set[str] = set()
            if len(acct) >= self.per_account:
                tail = acct[max(acct)]
                if ext.nonce >= tail.ext.nonce:
                    raise PoolFull(
                        f"account {ext.signer} already has {len(acct)} "
                        "pooled transactions")
                victims.append(tail)
                skip.add(tail.hash)
            # global count/byte bounds: displace strictly-lower-priority
            # tails, or refuse with typed backpressure
            count = self._count - len(victims)
            size = self._bytes - sum(v.size for v in victims)
            while (count + 1 > self.max_count
                   or size + entry.size > self.max_bytes):
                victim = self._lowest_tail(skip, ext.signer)
                if victim is None or victim.priority >= entry.priority:
                    raise PoolFull(
                        f"pool limit reached ({self._count} txs, "
                        f"{self._bytes} bytes) and priority "
                        f"{entry.priority} is too low to displace")
                victims.append(victim)
                skip.add(victim.hash)
                count -= 1
                size -= victim.size
            self._seq += 1
            entry.seq = self._seq
            for v in victims:
                self._drop(v)
            self._insert(entry)
            self.evictions += len(victims)
            return victims

    # -------------------------------------------------------- authoring

    def select(self, max_count: int, max_weight: int,
               bases: dict[str, int]) -> list[PoolEntry]:
        """Greedy priority packing under the block weight limit (the
        authoring drain): repeatedly take the highest-priority
        EXECUTABLE entry — an account head whose nonce chains from its
        chain nonce in `bases`.  An entry that would overflow the
        remaining weight blocks its whole account for this block (nonce
        contiguity forbids skipping just it).  Selected entries are
        REMOVED; the reorg requeue path puts retracted ones back."""
        out: list[PoolEntry] = []
        weight = 0
        with self._lock:
            heads: dict[str, int] = {}
            blocked: set[str] = set()
            while len(out) < max_count:
                best = None
                for signer, entries in self._by_account.items():
                    if signer in blocked:
                        continue
                    n = heads.get(signer, bases.get(signer, 0))
                    e = entries.get(n)
                    if e is None:
                        continue  # gapped or drained: not executable
                    if best is None or (e.priority, -e.seq) > (
                        best.priority, -best.seq
                    ):
                        best = e
                if best is None:
                    break
                if weight + best.weight > max_weight:
                    blocked.add(best.ext.signer)
                    continue
                weight += best.weight
                heads[best.ext.signer] = best.ext.nonce + 1
                self._drop(best)
                out.append(best)
        return out

    # ------------------------------------------------------ maintenance

    def requeue(self, entries: list[PoolEntry],
                bases: dict[str, int]) -> list[PoolEntry]:
        """Put retracted-block extrinsics back (the reorg path) with
        caller-recomputed priorities, skipping stale nonces and slots a
        (possibly better-paying) replacement now holds.  The caps are
        re-imposed afterwards: retraction is not a licence to exceed
        the pool's memory bound, so the lowest-priority tails are shed
        (peers that included the dead fork still hold them).  Returns
        the shed entries so the caller can roll back nonce high-water
        marks."""
        with self._lock:
            for entry in entries:
                ext = entry.ext
                if entry.hash in self._hashes:
                    continue
                if ext.nonce < bases.get(ext.signer, 0):
                    continue
                if ext.nonce in self._by_account.get(ext.signer, {}):
                    continue
                self._seq += 1
                entry.seq = self._seq
                self._insert(entry)
            shed: list[PoolEntry] = []
            skip: set[str] = set()
            while (self._count - len(shed) > self.max_count
                   or self._bytes - sum(v.size for v in shed)
                   > self.max_bytes):
                victim = self._lowest_tail(skip, "")
                if victim is None:
                    break
                shed.append(victim)
                skip.add(victim.hash)
            for v in shed:
                self._drop(v)
            self.evictions += len(shed)
            return shed

    def prune(self, hashes: set[str], bases: dict[str, int]) -> None:
        """Drop entries that just landed on chain via an imported block
        (by hash) and anything the advanced chain nonces made stale —
        several pools hold the same gossiped extrinsic; whoever authors
        first wins, the rest prune."""
        with self._lock:
            for signer, entries in list(self._by_account.items()):
                base = bases.get(signer, 0)
                for n in list(entries):
                    e = entries[n]
                    if e.hash in hashes or n < base:
                        self._drop(e)

    # ------------------------------------------------------- inspection

    def contains(self, h: str) -> bool:
        with self._lock:
            return h in self._hashes

    def has(self, signer: str, nonce: int) -> bool:
        with self._lock:
            return nonce in self._by_account.get(signer, {})

    def accounts(self) -> list[str]:
        with self._lock:
            return list(self._by_account)

    def bytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self, bases: dict[str, int]) -> dict:
        """{count, bytes, pending, future}: the pending/future band
        split against the given chain nonces (system_health's
        txPoolSize view)."""
        with self._lock:
            pending = 0
            for signer, entries in self._by_account.items():
                n = bases.get(signer, 0)
                while n in entries:
                    pending += 1
                    n += 1
            return {
                "count": self._count, "bytes": self._bytes,
                "pending": pending, "future": self._count - pending,
            }

    def __len__(self) -> int:
        with self._lock:
            return self._count


# ------------------------------------------------------------ service


@dataclass
class BlockRecord:
    number: int
    author: str
    extrinsics: list[str] = field(default_factory=list)
    receipts: list[dict] = field(default_factory=list)
    hash: str = ""
    imported: bool = False  # True when re-executed from a peer block
    # True when the author/VRF/extrinsic signatures rode a SUCCESSFUL
    # batch pairing (import_batch); False for serial verification,
    # including the per-block fallback after a refused batch
    batch_verified: bool = False


# Recent per-block state DELTAS kept for head-reorg rollback and
# state-mismatch recovery: leaf-level old+new encodings (chain/state.py
# StateDB), so rewinding k blocks reverts k deltas instead of restoring
# a full post-state blob (the reference keeps the full chain DB; this
# bounds memory on long-running nodes).  Exposed as a NodeService class
# attribute so sync.py derives its fork-rewind window from it instead
# of duplicating the number.
STATE_CACHE_BLOCKS = 64

# Per-block deposited-event ring (chain_getEvents) and block→trace-id
# map: both are telemetry bookkeeping, bounded independently of the
# state-blob cache so observability reaches further back than reorg
# depth without holding full state blobs.
EVENT_RING_BLOCKS = 256
TRACE_MAP_BLOCKS = 512

# Cumulative deposited-event sink bound: the in-block sink
# (ChainState.events) stays append-only so direct-runtime callers see
# history, but a long-running node trims the oldest half past this —
# the per-block ring above is the durable per-block record.
EVENT_SINK_MAX = 50_000

# Bounded cache of permanently-rejected extrinsic hashes (stale nonce,
# bad signature, negative tip): gossip re-delivers every extrinsic N-1
# times, and a re-delivered reject must cost a dict lookup, not a
# ~0.38s pairing — the _offences_seen guard applied to the tx
# intake path.  Transient rejections (pool full, can't pay yet) are
# deliberately NOT cached: they may succeed on redelivery.
REJECT_CACHE_MAX = 8192

# Pipelined import queue (gossip-burst / catch-up / journal-replay
# path): the most blocks whose author + VRF + extrinsic signatures
# fold into ONE weighted batch pairing (import_batch), mirroring
# sync.py's SYNC_RANGE_MAX fold, and the bound on the per-hash
# announce-verdict cache (announcers whose block a concurrent drain
# already judged read their verdict from here).
IMPORT_BATCH_MAX = 64
IMPORT_RESULT_CACHE_MAX = 2048

# Pull-RPC justification retention (chain_getJustification): one
# justification lands every finality_period blocks, and light clients
# re-anchor from RECENT ones — so the in-memory per-height store keeps
# a bounded window below the finalized head and prunes the rest (the
# full history stays in the store's journal, when one is attached).
# Heights pruned here answer -32004 over RPC; a light client simply
# re-anchors from a newer justification.
JUST_RETENTION_BLOCKS = 1024


class NodeService:
    """One chain node: Runtime + pool + block authoring + state export.

    authority: the validator name this node authors for (None = author
    every slot — the single-node dev mode).  device: where the runtime's
    TEE registration checks IAS reports (None = the card, "cpu" = the
    plain tensor path); resolved here, so a node without a card raises
    at construction rather than failing a registration receipt."""

    MAX_EXTRINSICS_PER_BLOCK = 512
    STATE_CACHE_BLOCKS = STATE_CACHE_BLOCKS

    def __init__(
        self,
        spec: ChainSpec,
        authority: str | None = None,
        ias_roots=None,
        registry: "m.Registry | None" = None,
        pool_max_count: int | None = None,
        pool_max_bytes: int | None = None,
        import_batch_max: int | None = None,
        device=None,
    ) -> None:
        self.spec = spec
        self.authority = authority
        self.device = resolve_device(device)
        if ias_roots is None and spec.dev_seed:
            # dev/local chains pin the deterministic fixture authority so
            # TEE registration (and client-minted attestations) work out
            # of the box
            from ..proof import ias
            from .chain_spec import dev_ias_authority

            root_der, _ = dev_ias_authority(spec.chain_id)
            ias_roots = ias.RootStore.from_der([root_der])
        self.rt = Runtime(spec.runtime_config(ias_roots=ias_roots),
                          device=self.device)
        self.keys = spec.public_keys()
        self.genesis = spec.genesis_hash()
        # Evidence wiring (chain/offences.py): the pallet re-verifies
        # every offence report against THIS chain's genesis and key
        # registry before anything is queued — an unverifiable report
        # is a deterministic failed receipt on every replica.
        self.rt.offences.evidence_verifier = (
            lambda rep: offences_mod.verify_report(
                rep, self.genesis, self.keys.get
            )
        )
        self.pool = TxPool(
            max_count=(pool_max_count if pool_max_count is not None
                       else 2048),
            max_bytes=(pool_max_bytes if pool_max_bytes is not None
                       else 1 << 20),
        )
        # hash → rejection reason for PERMANENTLY invalid extrinsics
        # (see REJECT_CACHE_MAX) — checked before the signature pairing
        self._ext_rejected: OrderedDict[str, str] = OrderedDict()  # guarded-by: _lock
        self.nonces: dict[str, int] = {}  # guarded-by: _lock
        self.blocks: list[BlockRecord] = []  # guarded-by: _lock
        self.slot = 0  # guarded-by: _lock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        # The identity this node signs as: blocks, finality votes, and
        # the audit OCW's challenge votes.  A dedicated authority uses
        # its own key; dev mode (authority=None) signs as the slot
        # author, whose dev key is derivable from the spec seed.
        self._ocw_identity = authority or (
            spec.validators[0] if spec.validators else None
        )
        self.authority_sk: int | None = None
        if self._ocw_identity is not None and spec.dev_seed:
            self.authority_sk = dev_sk(self._ocw_identity, spec.chain_id)

        # Block store + head anchor (the chain-DB role): parent of block
        # #1 is the genesis spec hash.  The state commitment is kept
        # INCREMENTALLY (chain/state.py StateDB — the sparse-Merkle
        # tree over keyed leaves), and recent per-block leaf deltas
        # replace the old full post-state blob cache: reverting a delta
        # rolls the head back bit-exactly, reapplying reinstates it.
        self.head_hash = self.genesis  # guarded-by: _lock
        self.block_store: dict[str, Block] = {}  # guarded-by: _lock
        self.block_by_number: dict[int, Block] = {}  # guarded-by: _lock
        self.statedb = StateDB(self.rt)  # guarded-by: _lock
        self._state_deltas: OrderedDict[str, list] = OrderedDict()  # guarded-by: _lock
        self._state_deltas[self.genesis] = []

        # Observability (node/tracing.py + the per-block event ring):
        # the tracer collects span trees; block_traces maps block hash →
        # trace id so finality/justification spans stitch into the
        # block's trace, including ids adopted from peer envelopes;
        # events_by_block holds each block's deposited events (drained
        # from the runtime sink at commit — the chain_getEvents feed,
        # deterministic and bit-identical across replicas but OUTSIDE
        # the consensus state hash).
        self.tracer = tracing.Tracer(node=authority or "dev")
        self.block_traces: OrderedDict[str, str] = OrderedDict()  # guarded-by: _lock
        self.events_by_block: OrderedDict[str, tuple[int, list]] = (
            OrderedDict())  # guarded-by: _lock

        # Finality (node/sync.py GRANDPA stand-in): collected votes per
        # (number, hash), targets this node already voted, and accepted
        # justifications by number.
        self.finalized_number = 0  # guarded-by: _lock
        self.finalized_hash = self.genesis  # guarded-by: _lock
        self._votes: dict[tuple[int, str], dict[str, str]] = {}  # guarded-by: _lock
        self._voted: set[int] = set()  # guarded-by: _lock
        # Equivocation bookkeeping: which hash each voter signed per
        # height, and voters proven to have signed two hashes at one
        # height (their weight counts for NEITHER fork — one Byzantine
        # validator must not be able to complete conflicting 2/3
        # quorums on different replicas).
        self._vote_hash: dict[int, dict[str, str]] = {}  # guarded-by: _lock
        self._equivocators: dict[int, set[str]] = {}  # guarded-by: _lock
        self.justifications: dict[int, Justification] = {}  # guarded-by: _lock
        # Verified justifications whose target block we have not
        # imported yet (gossip often outruns the ~0.4s import path);
        # retried as soon as the block at that height lands.
        self._pending_justs: dict[int, Justification] = {}  # guarded-by: _lock
        self.sync = None  # node/sync.py SyncManager, via attach_sync()
        # Durable local state (node/store.py BlockStore, via
        # attach_store / BlockStore.recover): when attached, every
        # committed block is journaled + fsync'd before the announce,
        # and the store checkpoints on its cadence.  None = the
        # in-memory-only node every test that doesn't pass --data-dir
        # still gets.
        self.store = None

        # Pipelined import queue (the decoupled import-queue role,
        # service.rs:219-584): handle_announce enqueues verified-shape
        # candidates; exactly one announcer thread at a time becomes
        # the drainer (_import_draining) and folds the whole queue's
        # pairings into batches (import_batch), double-buffering the
        # next batch's pairing on the verifier worker under the
        # current batch's re-execution.  Everyone else waits on the
        # condition for its own block's verdict.
        self.import_batch_max = max(2, import_batch_max
                                    or IMPORT_BATCH_MAX)
        self._import_queue: deque = deque()  # guarded-by: _lock
        self._import_queued: set[str] = set()  # guarded-by: _lock
        self._import_results: OrderedDict[str, tuple] = OrderedDict()  # guarded-by: _lock
        self._import_draining = False  # guarded-by: _lock
        self._import_cv = threading.Condition(self._lock)
        # lazy 1-worker pool for off-lock batch pairings (host/device
        # double-buffering); single worker keeps batches ordered
        self._import_verifier: ThreadPoolExecutor | None = None  # guarded-by: _lock

        # Offences bookkeeping (node side): sessions this node already
        # heartbeat for, offence report keys already submitted/gossiped
        # (gossip floods re-deliver each report N-1 times), and the
        # chaos knob that mutes the heartbeat OCW (--chaos-mute — a
        # deliberately lazy validator for liveness drills).
        self._hb_sent: set[int] = set()  # guarded-by: _lock
        self._offences_seen: set[tuple] = set()  # guarded-by: _lock
        self.chaos_mute = False
        # Self-healing candidacy: True once this node has observed its
        # own authority in staking.candidates — only then will the OCW
        # re-submit `validate` after an offences chill lapses (an
        # authority that never declared must not be volunteered).
        self._was_candidate = False
        self._revalidate_era = -1

        # Per-service registry by default: two services in one process
        # must not collide on metric names in the global REGISTRY.
        reg = registry if registry is not None else m.Registry()
        self.m_blocks = m.Counter(
            "cess_blocks_produced", "blocks authored by this node", reg)
        self.m_ext_ok = m.Counter(
            "cess_extrinsics_applied", "successful extrinsics", reg)
        self.m_ext_err = m.Counter(
            "cess_extrinsics_failed", "dispatch errors", reg)
        self.m_pool = m.Gauge("cess_txpool_ready", "pool depth", reg)
        self.m_block_time = m.Histogram(
            "cess_block_seconds", "block production time", registry=reg)
        self.m_imported = m.Counter(
            "cess_blocks_imported", "peer blocks imported", reg)
        self.m_import_rejected = m.Counter(
            "cess_blocks_rejected", "peer blocks failing verification", reg)
        self.m_reorgs = m.Counter(
            "cess_reorgs", "head reorgs (same-height fork choice)", reg)
        self.m_finalized = m.Gauge(
            "cess_finalized_number", "latest finalized block", reg)
        self.m_votes = m.Counter(
            "cess_finality_votes", "finality votes accepted", reg)
        self.m_catchup = m.Counter(
            "cess_catchup_runs", "checkpoint bootstraps during catch-up",
            reg)
        self.m_vrf_primary = m.Counter(
            "cess_vrf_primary_claims", "primary slot claims authored", reg)
        self.m_vrf_secondary = m.Counter(
            "cess_vrf_secondary_claims", "secondary slot claims authored",
            reg)
        self.m_heartbeats = m.Counter(
            "cess_heartbeats_sent", "im-online heartbeats submitted", reg)
        self.m_offences = m.Counter(
            "cess_offences_reported",
            "offence reports this node built or relayed", reg)
        # Import-stage histograms (the per-stage timing the tracing
        # spans record, aggregated for the fleet reporter): signature
        # batch, deterministic re-execution, post-state snapshot.
        stage_buckets = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                         1.0, 2.5, 5.0)
        self.m_import_stage = {
            stage: m.Histogram(
                f"cess_import_{stage}_seconds",
                f"block import {label} time",
                buckets=stage_buckets, registry=reg)
            for stage, label in (
                ("sig_batch", "signature batch verification"),
                ("execute", "deterministic re-execution"),
                ("snapshot", "post-state snapshot + hash"),
            )
        }
        # State-trie observability: dirty-leaf count per committed
        # block, and the root-computation cost split by path — the
        # incremental touched-path rehash every block pays vs the
        # full-rebuild oracle (checkpoint cadence / restore rebase).
        self.m_state_dirty = m.Histogram(
            "cess_state_dirty_keys",
            "state-trie leaves touched per committed block",
            buckets=(1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096),
            registry=reg)
        self.m_state_hash = {
            mode: m.Histogram(
                f"cess_state_hash_{mode}_seconds",
                f"state root {label}",
                buckets=stage_buckets, registry=reg)
            for mode, label in (
                ("incremental", "incremental (touched-path) rehash time"),
                ("full", "full-rebuild oracle time"),
            )
        }
        # Import-pipeline observability: queue depth is the gossip
        # backlog the drain loop is working off; batch size records how
        # many blocks each weighted pairing actually folded (1-bucket
        # observations mean the prefix was unbatchable and fell to the
        # per-block path).
        self.m_import_queue = m.Gauge(
            "cess_import_queue_depth",
            "gossip blocks waiting in the pipelined import queue", reg)
        self.m_import_batch = m.Histogram(
            "cess_import_batch_size",
            "blocks whose signatures folded into one import batch "
            "pairing",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128), registry=reg)
        self.m_finality_lag = m.Gauge(
            "cess_finality_lag_blocks",
            "best block minus finalized block", reg)
        self.m_events = m.Counter(
            "cess_events_deposited",
            "runtime events deposited by committed blocks", reg)
        # Fee-market pool observability (always on, merged into
        # system_metrics): depth/bytes track the weighted mempool,
        # evictions and per-reason rejections make spam backpressure
        # visible, fee_total is the fees charged by executed blocks.
        self.m_pool_size = m.Gauge(
            "cess_pool_size", "pooled transactions (pending + future)",
            reg)
        self.m_pool_bytes = m.Gauge(
            "cess_pool_bytes", "pooled transaction wire bytes", reg)
        self.m_pool_evict = m.Counter(
            "cess_pool_evictions",
            "pooled transactions evicted to make room", reg)
        self.m_pool_reject = m.LabeledCounter(
            "cess_pool_rejections", "intake rejections by reason",
            "reason", reg)
        self.m_pool_fee = m.Counter(
            "cess_pool_fee_total",
            "transaction fees charged by blocks this node executed", reg)
        self.registry = reg

    # ------------------------------------------------------ submission

    def _cache_rejection(self, h: str, reason: str) -> None:  # holds-lock: _lock
        """Remember a PERMANENTLY invalid extrinsic hash (caller holds
        the lock): redelivery re-raises from here before any pairing."""
        self._ext_rejected[h] = reason
        while len(self._ext_rejected) > REJECT_CACHE_MAX:
            self._ext_rejected.popitem(last=False)

    def _pool_entry(self, ext: Extrinsic, h: str) -> PoolEntry:
        """Price an extrinsic for the pool (chain/fees.py): weight,
        fee + tip, and the fee-per-weight priority ordering key."""
        weight = fees_mod.weight_of(ext.module, ext.call)
        operational = fees_mod.is_operational(ext.module, ext.call)
        fee = self.rt.fees.fee_of(ext.module, ext.call)
        return PoolEntry(
            ext=ext, hash=h,
            priority=fees_mod.priority(fee, ext.tip, weight, operational),
            weight=weight, fee=fee + ext.tip,
            size=len(canonical_json(ext.to_json())),
        )

    def _admission_check(self, ext: Extrinsic, h: str, span) -> None:
        """Cheap fee/nonce admission (caller holds the lock), run
        BEFORE the ~0.38s signature pairing so floods of stale, broke,
        or malformed spam cost dict lookups only.  Permanently-invalid
        shapes enter the rejection cache; transient ones (can't pay
        YET) do not."""
        chain_nonce = self.rt.state.nonces.get(ext.signer, 0)
        if ext.nonce < chain_nonce:
            msg = f"stale nonce {ext.nonce}: expected at least {chain_nonce}"
            self._cache_rejection(h, msg)
            span.tags["rejected"] = "stale-nonce"
            self.m_pool_reject.inc("stale-nonce")
            raise ValueError(msg)
        if ext.tip < 0:
            msg = "negative tip"
            self._cache_rejection(h, msg)
            span.tags["rejected"] = "negative-tip"
            self.m_pool_reject.inc("negative-tip")
            raise ValueError(msg)
        if not self.rt.fees.can_pay(ext.signer, ext.module, ext.call,
                                    ext.tip):
            span.tags["rejected"] = "cannot-pay"
            self.m_pool_reject.inc("cannot-pay")
            raise FeeTooLow(
                f"{ext.signer} cannot pay the "
                f"{self.rt.fees.fee_of(ext.module, ext.call) + ext.tip} "
                "fee")

    def _update_pool_metrics(self) -> None:
        self.m_pool.set(len(self.pool))
        self.m_pool_size.set(len(self.pool))
        self.m_pool_bytes.set(self.pool.bytes())

    def submit_extrinsic(self, ext: Extrinsic, gossip: bool = True,
                         _verified: bool = False) -> str:
        """Pool intake: signature + fee/nonce admission + weighted-pool
        insertion (the validate_transaction role).  Ordering matters:
        the payload-hash dedupe and the cheap fee/nonce checks run
        BEFORE the signature pairing, so re-gossiped or underfunded
        spam never pays the ~0.38s verify.  Accepted extrinsics gossip
        to every peer pool (`gossip=False` marks peer-received copies,
        which are not re-broadcast — the mesh is fully connected).
        `_verified=True` skips the pairing check for extrinsics this
        node signed itself moments ago (the OCW path) — a full verify
        there burns most of a slot."""
        if (ext.module, ext.call) not in EXTRINSIC_DISPATCH:
            raise ValueError(f"unknown call {ext.module}::{ext.call}")
        pk = self.keys.get(ext.signer)
        if pk is None:
            raise ValueError(f"unknown signer {ext.signer}")
        try:
            h = ext.hash(self.genesis)
        except ValueError:
            raise ValueError("undecodable signature")
        # Hash dedupe BEFORE anything expensive: a redelivered reject
        # re-raises from the cache, a redelivered accept is idempotent.
        with self._lock:
            cached = self._ext_rejected.get(h)
            if cached is None and self.pool.contains(h):
                return h
        if cached is not None:
            self.m_pool_reject.inc("cached")
            raise ValueError(cached)
        # Extrinsic intake mints a trace (the other trace root next to
        # block authorship): the span records validation cost and the
        # verdict, queryable via system_traces.
        with self.tracer.span(
            "extrinsic.intake", trace=tracing.mint_trace_id(),
            tags={"module": ext.module, "call": ext.call,
                  "signer": ext.signer},
        ) as span:
            with self._lock:
                self._admission_check(ext, h, span)
            if not _verified and not bls.verify(
                pk, ext.payload(self.genesis), bytes.fromhex(ext.signature)
            ):
                span.tags["rejected"] = "bad-signature"
                with self._lock:
                    self._cache_rejection(h, "bad signature")
                self.m_pool_reject.inc("bad-signature")
                raise ValueError("bad signature")
            # insert + high-water bookkeeping under the service lock:
            # concurrent RPC threads must agree on band positions, and
            # the chain may have advanced during the pairing above
            with self._lock:
                self._admission_check(ext, h, span)
                entry = self._pool_entry(ext, h)
                base = self.rt.state.nonces.get(ext.signer, 0)
                try:
                    evicted = self.pool.submit(entry, base)
                except PoolFull as e:
                    span.tags["rejected"] = "pool-full"
                    self.m_pool_reject.inc("pool-full")
                    raise e
                except FeeTooLow as e:
                    span.tags["rejected"] = "fee-too-low"
                    self.m_pool_reject.inc("fee-too-low")
                    raise e
                except ValueError as e:
                    span.tags["rejected"] = str(e)
                    self.m_pool_reject.inc("bad-nonce")
                    raise
                # intake high-water = chain nonce + contiguous pooled
                # run: what author_nonce hands the next client signer
                hw = base
                while self.pool.has(ext.signer, hw):
                    hw += 1
                if self.nonces.get(ext.signer, 0) < hw:
                    self.nonces[ext.signer] = hw
                for ev in evicted:
                    # an evicted tail rolls its account's high-water
                    # back so the slot can be re-signed
                    if ev.ext.nonce < self.nonces.get(ev.ext.signer, 0):
                        self.nonces[ev.ext.signer] = ev.ext.nonce
                if evicted:
                    self.m_pool_evict.inc(len(evicted))
            span.tags["hash"] = h[:16]
        self._update_pool_metrics()
        if gossip and self.sync is not None:
            self.sync.broadcast_extrinsic(ext)
        return h

    # ------------------------------------------------------ authoring

    def _slot_author(self, slot: int) -> str:
        rrsc = getattr(self.rt, "rrsc", None)
        if rrsc is not None:
            try:
                author = rrsc.slot_author(slot)
                if author is not None:
                    return author
            except Exception:
                pass
        return self.spec.validators[0] if self.spec.validators else "dev"

    def _apply_extrinsics(
        self, exts: list[Extrinsic], record: BlockRecord
    ) -> None:
        """Apply a block body in order, recording receipts.  Shared by
        authoring and import so replicas execute identically."""
        for ext in exts:
            adapter = EXTRINSIC_DISPATCH.get((ext.module, ext.call))
            receipt = {"hash": ext.hash(self.genesis), "ok": True}
            # Consensus replay gate: the nonce must match the CHAIN's
            # account nonce (state.nonces, advanced only here), so a
            # malicious author re-including an already-applied signed
            # extrinsic produces a deterministic failed receipt on every
            # replica instead of a double execution.
            expected = self.rt.state.nonces.get(ext.signer, 0)
            if ext.nonce != expected:
                receipt = {
                    **receipt, "ok": False,
                    "error": f"stale nonce {ext.nonce} "
                             f"(account is at {expected})",
                }
                self.m_ext_err.inc()
                record.extrinsics.append(receipt["hash"])
                record.receipts.append(receipt)
                continue
            self.rt.state.nonces[ext.signer] = expected + 1
            # Fee charge (chain/fees.py): happens after the nonce is
            # consumed and BEFORE dispatch, Substrate-style — a failed
            # dispatch still pays, an unpayable fee skips dispatch but
            # still burns the nonce.  Deterministic: same charge on
            # author and every importer.
            try:
                fee_paid = self.rt.fees.charge(
                    ext.signer, ext.module, ext.call, ext.tip)
            except DispatchError as e:
                receipt = {**receipt, "ok": False, "error": f"fee: {e}"}
                self.m_ext_err.inc()
                record.extrinsics.append(receipt["hash"])
                record.receipts.append(receipt)
                continue
            if fee_paid:
                receipt["fee"] = fee_paid
                self.m_pool_fee.inc(fee_paid)
            try:
                if adapter is not None:
                    adapter(self.rt, ext.signer, ext.args)
                else:
                    pallet = getattr(self.rt, ext.module)
                    fn = getattr(pallet, ext.call)
                    fn(ext.signer, *[_decode_arg(a) for a in ext.args])
                self.m_ext_ok.inc()
            except DispatchError as e:
                receipt = {**receipt, "ok": False, "error": str(e)}
                self.m_ext_err.inc()
            except (TypeError, ValueError, KeyError, IndexError,
                    AttributeError) as e:
                # malformed argument shapes (missing dict keys, wrong
                # arity, bad hex…) must not kill the authoring loop —
                # the extrinsic fails, the block goes on
                receipt = {
                    **receipt, "ok": False,
                    "error": f"invalid-call: {e!r}",
                }
                self.m_ext_err.inc()
            record.extrinsics.append(receipt["hash"])
            record.receipts.append(receipt)

    def _author_sk(self, author: str) -> int | None:
        """Secret key this node can sign the author's blocks with: its
        own authority key, or (dev/local chains) the derivable seed key
        when the service authors every slot."""
        if author == self._ocw_identity and self.authority_sk is not None:
            return self.authority_sk
        if self.authority is None and self.spec.dev_seed:
            return dev_sk(author, self.spec.chain_id)
        return None

    def _commit_block(  # holds-lock: _lock
        self, block: Block, record: BlockRecord, delta: list,
        events: list | None = None, trace: str | None = None,
    ) -> None:
        """Head bookkeeping after a block executed: store, buffer the
        block's state delta for reorg rollback, advance the head anchor
        and slot clock, file the block's deposited events into the
        per-block ring and pin its trace id."""
        h = block.hash(self.genesis)
        record.hash = h
        self.block_store[h] = block
        self.block_by_number[block.number] = block
        self.head_hash = h
        self.slot = max(self.slot, block.slot)
        self._state_deltas[h] = delta
        while len(self._state_deltas) > STATE_CACHE_BLOCKS:
            self._state_deltas.popitem(last=False)
        if events is not None:
            self.events_by_block[h] = (block.number, list(events))
            self.m_events.inc(len(events))
            while len(self.events_by_block) > EVENT_RING_BLOCKS:
                self.events_by_block.popitem(last=False)
        if trace is not None:
            self.block_traces[h] = trace
            while len(self.block_traces) > TRACE_MAP_BLOCKS:
                self.block_traces.popitem(last=False)
        # bound the cumulative runtime sink (the per-block ring above
        # is the durable record; direct-runtime callers keep history
        # up to the trim threshold)
        sink = self.rt.state.events
        if len(sink) > EVENT_SINK_MAX:
            del sink[: len(sink) - EVENT_SINK_MAX // 2]
        self.blocks.append(record)
        # Durability BEFORE acknowledgment: the journal append (fsync
        # included) runs here, under the lock, ahead of the gossip
        # announce and _post_block hooks — a block a peer heard about is
        # a block this node can replay after kill -9.  The store owns
        # its OSError handling (degraded mode), so a full disk never
        # kills the authoring/import path.
        if self.store is not None:
            self.store.journal_block(
                block,
                checkpoint.events_digest(events)
                if events is not None else "",
                self.justifications.get(block.number),
                delta=delta,
            )
            # the blob thunk keeps per-block checkpoint cost O(touched):
            # the store only materializes the full snapshot (and runs
            # the oracle check inside it) on its checkpoint cadence
            self.store.maybe_checkpoint(
                block, self._checkpoint_blob,
                self.justifications.get(block.number))
        self.m_pool.set(len(self.pool))
        self.m_finality_lag.set(block.number - self.finalized_number)

    def _checkpoint_blob(self) -> bytes:  # holds-lock: _lock
        """Full checkpoint blob, built only on the store's cadence.
        Doubles as the standing ORACLE point: the full-rebuild root must
        equal the root the committed head block carries, so a missed
        dirty key in the incremental tracking fails loudly within one
        checkpoint interval instead of silently forking replicas."""
        with self.m_state_hash["full"].time():
            blob, shash = checkpoint.snapshot_and_hash(self.rt)
        head = self.block_store.get(self.head_hash)
        if head is not None and head.state_hash != shash:
            raise RuntimeError(
                f"state-trie divergence at #{head.number}: full-rebuild "
                f"oracle {shash} != committed root {head.state_hash}")
        return blob

    def produce_block(self, slot: int | None = None) -> BlockRecord | None:
        """One slot: on_initialize hooks, then apply pooled extrinsics.
        Returns None when this node is not the slot author.  Without an
        explicit slot the counter advances by one per call (the
        single-node/dev cadence); networked slot loops pass the
        wall-clock slot so every replica agrees on who owns the current
        slot — a slot at or below the head's is already settled and
        skipped."""
        with self._lock, self.m_block_time.time():
            if slot is None:
                self.slot += 1
            else:
                if slot <= self.slot:
                    return None
                self.slot = slot
            if self.authority is None and self.sync is not None:
                # networked but keyless: observer/RPC full node.  The
                # dev fallback below would evaluate the slot owner's
                # derived key — forging claims under another
                # validator's identity — so never author here.
                return None
            # Authorship is a VRF slot claim (consensus/): a
            # dedicated authority claims for itself (primary when its
            # VRF output beats the stake threshold, secondary when the
            # fallback schedule names it); dev mode (authority=None)
            # claims as the slot's secondary owner, whose dev key is
            # derivable from the spec seed.
            author = (self.authority if self.authority is not None
                      else self._slot_author(self.slot))
            sk = self._author_sk(author)
            if sk is None:
                return None
            # The claim is evaluated BEFORE any span opens: most slots
            # are not ours on a multi-validator chain, and recording a
            # root span per unclaimed slot would evict real block
            # traces from the bounded ring.  The claim's cost is
            # back-dated into the trace as a point event once we know
            # the slot is won.
            t_claim = time.perf_counter()
            claim = consensus.claim_slot(
                self.rt.rrsc, self.genesis, author, sk, self.slot)
            claim_s = time.perf_counter() - t_claim
            if claim is None:
                return None  # neither primary nor secondary this slot
            # Trace root minted HERE — block authorship is where a
            # block's life begins; the id rides the announce envelope
            # so importers stitch their spans onto this trace.
            tid = tracing.mint_trace_id()
            with self.tracer.span(
                "block.author", trace=tid,
                tags={"slot": self.slot, "author": author},
            ) as root:
                self.tracer.event("author.claim", duration=claim_s)
                parent = self.head_hash
                slot = self.slot
                # Greedy priority packing under the block weight limit
                # (the BlockBuilder + weight-meter role): highest
                # fee-per-weight first, nonce-contiguous per account.
                entries = self.pool.select(
                    self.MAX_EXTRINSICS_PER_BLOCK,
                    self.rt.fees.block_weight_limit,
                    self.rt.state.nonces,
                )
                exts = [en.ext for en in entries]
                ev_base = self.rt.state.event_mark()
                # the output is consensus state the moment the block
                # exists: fold BEFORE run_blocks, so an era rotation
                # inside this very block already accumulates it
                # (importers do the same)
                with self.tracer.span(
                    "author.execute", tags={"extrinsics": len(exts)}
                ):
                    self.rt.rrsc.fold_vrf_output(slot, claim.output)
                    self.rt.run_blocks(1)
                    record = BlockRecord(
                        number=self.rt.state.block_number, author=author)
                    self._apply_extrinsics(exts, record)
                    # fee split lands in the SAME block's state (before
                    # the snapshot), so the state hash commits to it —
                    # importers run the identical distribute
                    self.rt.fees.distribute(author)
                with self.tracer.span("author.snapshot"), \
                        self.m_state_hash["incremental"].time():
                    shash, delta = self.statedb.commit()
                self.m_state_dirty.observe(len(delta))
                events = self.rt.state.events_since(ev_base)
                block = Block(
                    number=record.number, slot=slot, parent=parent,
                    author=author, state_hash=shash,
                    extrinsics=[e.to_json() for e in exts],
                    vrf_output=claim.output.hex(),
                    vrf_proof=claim.proof.hex(),
                )
                block.sign(sk, self.genesis)
                root.tags["number"] = record.number
                self._commit_block(block, record, delta,
                                   events=events, trace=tid)
                self.m_blocks.inc()
                (self.m_vrf_primary if claim.primary
                 else self.m_vrf_secondary).inc()
        # outside the lock: network fan-out + offchain hooks
        if self.sync is not None:
            self.sync.announce_block(block, trace=tid)
        self._post_block(record.number)
        return record

    # ------------------------------------------------------ import

    def head_number(self) -> int:
        with self._lock:
            return self.rt.state.block_number

    def attach_sync(self, sync) -> None:
        self.sync = sync

    def attach_store(self, store) -> None:
        """Wire the durable store (node/store.py): called by
        BlockStore.recover() after the recovery ladder ran, so replayed
        blocks were imported store-less and are not re-journaled."""
        self.store = store

    def _parent_slot(self, parent: str) -> int:
        blk = self.block_store.get(parent)
        return blk.slot if blk is not None else 0

    def _requeue_retracted(self, blocks: list[Block]) -> None:  # holds-lock: _lock
        """Reorg aftercare: a retracted block's extrinsics go back into
        the pool so they land on the winning chain in a later block
        (the reference pool's retraction behavior) instead of vanishing."""
        entries = []
        for blk in blocks:
            for d in blk.extrinsics:
                try:
                    ext = Extrinsic.from_json(d)
                    entries.append(
                        self._pool_entry(ext, ext.hash(self.genesis)))
                except (KeyError, TypeError, ValueError):
                    continue
        if entries:
            # the state rollback already refunded their fees (fee state
            # lives in the blob); requeue re-prices at pool priority so
            # they compete for the next block like fresh submissions
            shed = self.pool.requeue(entries, self.rt.state.nonces)
            for ev in shed:
                cur = self.nonces.get(ev.ext.signer, 0)
                if ev.ext.nonce < cur:
                    self.nonces[ev.ext.signer] = ev.ext.nonce
            self._update_pool_metrics()

    def _rollback_head(  # holds-lock: _lock
        self,
    ) -> tuple[Block, str, list, BlockRecord | None, list | None]:
        """Drop the current head (same-height fork choice lost): revert
        its state delta and rewind bookkeeping.  Pool nonces are left at
        their high-water mark — intake gating is node-local, never
        consensus state.  Returns everything needed to reinstate the
        head if the replacement block then fails verification (the fork
        choice must be transactional: an unverified announce must never
        leave the node headless).  Checks the delta BEFORE mutating
        anything, so failure leaves state untouched."""
        head = self.block_store[self.head_hash]
        head_delta = self._state_deltas.get(self.head_hash)
        if head_delta is None:
            raise BlockImportError("head state delta evicted; cannot reorg")
        head_hash = self.head_hash
        self._state_deltas.pop(head_hash)
        self.block_store.pop(head_hash)
        self.block_by_number.pop(head.number, None)
        record = None
        if self.blocks and self.blocks[-1].number == head.number:
            record = self.blocks.pop()
        # retract the head's events: drop its ring entry and (when the
        # sink tail still ends with exactly those events — delta revert
        # never touches the sink) truncate the sink, so a replica that
        # never saw the losing block reads the same ring
        head_events = self._retract_events(head_hash)
        self.statedb.revert(head_delta)
        self.head_hash = head.parent
        # NOTE: _voted deliberately keeps the retracted height.  A vote
        # for the dead hash may already be part of a forming quorum;
        # voting again for the replacement (equivocation) lets two
        # conflicting justifications finalize the same height on
        # different nodes — a permanent chain split.  The price is one
        # possibly-lapsed boundary; the next period finalizes normally.
        self._requeue_retracted([head])
        self.m_reorgs.inc()
        return head, head_hash, head_delta, record, head_events

    def _retract_events(self, block_hash: str) -> list | None:  # holds-lock: _lock
        """Drop a retracted block's ring entry and rewind the runtime
        sink if its tail is still exactly that block's events (the
        sink is append-only; checkpoint blobs no longer carry it)."""
        entry = self.events_by_block.pop(block_hash, None)
        if entry is None:
            return None
        _, events = entry
        sink = self.rt.state.events
        n = len(events)
        if n and len(sink) >= n and sink[-n:] == events:
            del sink[-n:]
        return events

    def _reinstate_head(  # holds-lock: _lock
        self, head: Block, head_hash: str, head_delta: list,
        record: BlockRecord | None, head_events: list | None,
    ) -> None:
        """Undo a _rollback_head after the competing block failed
        verification: reapply the old head's state delta (the runtime
        is back at the parent state) and restore its bookkeeping, and
        take its extrinsics back out of the pool."""
        self.statedb.apply(head_delta)
        self.block_store[head_hash] = head
        self.block_by_number[head.number] = head
        self._state_deltas[head_hash] = head_delta
        self.head_hash = head_hash
        if head_events is not None:
            self.events_by_block[head_hash] = (head.number, head_events)
            self.rt.state.events.extend(head_events)
        if record is not None:
            self.blocks.append(record)
            self.pool.prune(set(record.extrinsics), self.rt.state.nonces)

    def import_block(
        self, block: Block, sigs_verified: bool = False,
        trace: str | None = None, origin: str = "announce",
        batch_vrf_msg: bytes | None = None,
        journal_delta: list | None = None,
    ) -> BlockRecord | None:
        """Verify and re-execute a peer block (the import-queue role).

        Rejections (BlockImportError): a slot claim that does not
        verify for the claimed slot under the author's registered key
        (missing/forged VRF proof, stolen output, above-threshold
        claim by a non-secondary author), bad author signature,
        non-monotone slot, invalid extrinsic signatures, or a
        post-state hash that does not match our own deterministic
        re-execution.  A block one past our head imports; a
        same-height fork triggers fork choice (primary claim beats
        secondary, then lower slot, then lower hash).  Replicas
        sharing a head state always pick the same winner; replicas on
        OPPOSITE sides of the fork rank with their own post-states, so
        at an era-boundary fork (epoch context diverges with the fork
        itself) both may keep their own head — the longest-chain rule
        resolves such a standoff at the next authored block, exactly
        as it does for any unknown-parent fork.  Anything further
        ahead raises SyncGap for the caller to catch up.  Every
        rejection bumps m_import_rejected
        exactly once.  `sigs_verified=True` (the range-batch catch-up
        path, node/sync.py) skips the pairing work — the caller
        already verified every signature in one weighted batch — but
        every structural and state check still runs.
        `batch_vrf_msg` (the batched import path, import_batch) is the
        VRF message whose pairing the batch actually covered: if the
        message recomputed under the lock at the parent state differs
        (the epoch context moved between the batch's triple build and
        this block's turn — an era boundary or a concurrent reorg),
        sigs_verified is demoted and the per-block pairing runs, so a
        batch verdict can never vouch for the wrong message.

        `trace` is the author-minted trace id from the gossip/catch-up
        envelope (node/tracing.py): the import spans recorded here join
        the author's trace, so `system_traces` shows one stitched tree
        for the block's whole life.  Telemetry only — an absent or
        garbled id mints a local one and affects nothing else."""
        # Pin the trace id EXPLICITLY: a missing/garbled envelope id
        # mints a fresh per-block trace rather than falling back to
        # span-stack inheritance — inside a catchup.range span, N
        # envelope-less blocks would otherwise all share the range's
        # trace id and render as one merged tree.
        with self.tracer.span(
            "block.import",
            trace=(trace if tracing.valid_trace_id(trace)
                   else tracing.mint_trace_id()),
            tags={"number": block.number, "author": block.author,
                  "origin": origin},
        ) as root:
            try:
                rec = self._import_block_inner(
                    block, sigs_verified, batch_vrf_msg=batch_vrf_msg,
                    journal_delta=journal_delta)
            except BlockImportError as e:
                root.tags["rejected"] = str(e)
                self.m_import_rejected.inc()
                raise
            if rec is None:
                # known/stale/ignored: _commit_block (which pins the
                # adopted trace id into block_traces) never ran
                root.tags["outcome"] = "known-or-ignored"
            return rec

    def _claim_rank(self, block: Block) -> int:
        """Fork-choice rank of a block's slot claim (0 primary, 1
        secondary, 2 none) from its claimed output — no pairing.
        Evaluated against our CURRENT state; the strict check against
        the true parent state runs inside _verify_and_apply.  A lying
        rank needs the author's signature (the claim fields are under
        it) and still dies post-rollback, transactionally."""
        try:
            out = bytes.fromhex(block.vrf_output)
        except ValueError:
            return consensus.RANK_NONE
        if len(out) != 32:
            return consensus.RANK_NONE
        return consensus.claim_rank(
            self.rt.rrsc, block.author, block.slot, out)

    def _check_slot_claim(self, block: Block) -> bytes:
        """Structural slot-claim verification against the parent state
        (caller holds the lock, runtime is at the parent): decode the
        claim, re-derive the output from the proof, enforce the
        threshold/secondary rules.  Returns the VRF message whose
        pairing the signature batch must cover."""
        try:
            out = bytes.fromhex(block.vrf_output)
            proof = bytes.fromhex(block.vrf_proof)
        except ValueError:
            raise BlockImportError("undecodable VRF claim")
        if len(out) != 32 or not proof:
            raise BlockImportError("missing VRF claim")
        try:
            consensus.classify_claim(
                self.rt.rrsc, block.author, block.slot, out, proof)
        except ClaimError as e:
            raise BlockImportError(str(e))
        return consensus.slot_message(self.genesis, self.rt.rrsc,
                                      block.slot)

    def _import_block_inner(
        self, block: Block, sigs_verified: bool = False,
        batch_vrf_msg: bytes | None = None,
        journal_delta: list | None = None,
    ) -> BlockRecord | None:
        with self._lock:
            try:
                h = block.hash(self.genesis)
            except ValueError:  # non-hex signature in the announce
                raise BlockImportError("undecodable signature")
            if h in self.block_store:
                return None  # known
            head_n = self.rt.state.block_number
            undo = None
            if block.number == head_n and head_n > self.finalized_number:
                head = self.block_store.get(self.head_hash)
                if head is None or block.parent != head.parent:
                    return None  # unrelated fork; ignore
                author_checked = sigs_verified
                if (block.author == head.author
                        and block.slot == head.slot
                        and (offences_mod.KIND_BLOCK_EQUIV, block.author,
                             self.rt.session.session_of_block(head.number))
                        not in self._offences_seen):
                    # Two headers for ONE slot by ONE author: block
                    # equivocation.  Authenticate the competing header
                    # first — an unverified conflict must never accuse
                    # an honest author — then route the signed pair as
                    # a portable offence report regardless of which
                    # fork wins below (the loser is still evidence).
                    # Our head's signature was verified at its import;
                    # sigs_verified=True (range-batch catch-up) means
                    # the batch already verified the competing one.
                    # The _offences_seen pre-check keeps re-delivered
                    # losing conflicts (gossip repeats every announce
                    # N-1 times) from paying the ~0.4 s pairing below
                    # on every replay.
                    if not author_checked:
                        try:
                            self._check_author_signature(block)
                            author_checked = True
                        except BlockImportError:
                            pass  # forged conflict: no report
                    if author_checked:
                        self._submit_offence_report(
                            self._block_offence_report(head, block))
                rank = self._claim_rank(block)
                head_rank = self._claim_rank(head)
                if (rank, block.slot, h) >= (
                    head_rank, head.slot, self.head_hash
                ):
                    return None  # our head wins fork choice
                # Authenticate BEFORE the destructive rollback: fork
                # choice fields (number/slot/parent) are attacker-chosen,
                # so an unverified announce must not be able to knock the
                # genuine head off.  The full slot-author check still
                # runs below against the parent state; this gate pins the
                # claimed author to the validator set and to a signature
                # under that validator's key.  (Skipped when the block-
                # equivocation probe above already paid this pairing.)
                if not author_checked:
                    with self.tracer.span("import.fork_choice_auth"):
                        self._check_author_signature(block)
                undo = self._rollback_head()
                head_n -= 1
            author_verified = undo is not None
            try:
                if block.number <= head_n:
                    return None  # stale
                if block.number > head_n + 1:
                    raise SyncGap(head_n, block.number)
                if block.parent != self.head_hash:
                    raise BlockImportError("unknown parent")
                if block.slot <= self._parent_slot(block.parent):
                    raise BlockImportError("non-monotone slot")
                record = self._verify_and_apply(
                    block, author_verified=author_verified,
                    sigs_verified=sigs_verified,
                    batch_vrf_msg=batch_vrf_msg,
                    journal_delta=journal_delta)
            except BlockImportError:
                if undo is not None:
                    self._reinstate_head(*undo)
                raise
            self._commit_block(
                block, record[0], record[1], events=record[2],
                trace=self.tracer.current_trace())
            self.m_imported.inc()
        self._post_block(block.number)
        return record[0]

    def _author_pk(self, block: Block) -> bytes:
        """Structural author checks shared by every verification path:
        the claimed author is a validator with a known key and the block
        carries a signature at all."""
        if block.author not in self.spec.validators:
            raise BlockImportError("author is not a validator")
        pk = self.keys.get(block.author)
        if pk is None or not block.signature:
            raise BlockImportError("unsigned block")
        return pk

    def _check_author_signature(self, block: Block) -> None:
        """The state-independent part of block verification: the claimed
        author is a validator and signed the header payload."""
        pk = self._author_pk(block)
        try:
            sig = bytes.fromhex(block.signature)
        except ValueError:
            raise BlockImportError("undecodable signature")
        if not bls.verify(pk, block.signing_payload(self.genesis), sig):
            raise BlockImportError("bad author signature")

    def _verify_and_apply(  # holds-lock: _lock
        self, block: Block, author_verified: bool = False,
        sigs_verified: bool = False,
        batch_vrf_msg: bytes | None = None,
        journal_delta: list | None = None,
    ) -> tuple[BlockRecord, list, list]:
        """Slot-claim check + signature batch + deterministic
        re-execution; reverts the state delta on a post-state mismatch.
        Caller holds the lock, runtime is at the parent state.
        `author_verified=True` (the fork-choice path, where
        _check_author_signature already ran a full pairing) keeps the
        block signature out of the batch instead of paying for it
        twice; `sigs_verified=True` (range-batch catch-up) skips every
        pairing — the structural checks and re-execution still run.
        `journal_delta` (crash recovery) is a state delta this node
        itself journalled for the block: after the signature checks it
        is applied directly and, when the resulting root matches the
        header, re-execution is skipped entirely — the root check makes
        a tampered journal indistinguishable from a bad block.  Events
        are not replayed on that path (telemetry-only loss)."""
        pk = self._author_pk(block)
        # VRF slot claim: structural rules against the parent state
        # (output↔proof binding, threshold/secondary schedule); the
        # proof's pairing joins the weighted batch below.
        vrf_msg = self._check_slot_claim(block)
        if (sigs_verified and batch_vrf_msg is not None
                and batch_vrf_msg != vrf_msg):
            # The batch pairing covered a VRF message sampled before
            # this block's turn under the lock; the epoch context has
            # moved since (era boundary rotated by an earlier batch
            # member, or a concurrent reorg).  The batch verdict is
            # then vouching for the WRONG message — demote to the
            # per-block pairing rather than trust it.
            sigs_verified = False
        try:
            exts = [Extrinsic.from_json(e) for e in block.extrinsics]
        except (KeyError, TypeError, ValueError) as e:
            raise BlockImportError(f"malformed extrinsic: {e!r}")
        # Weight-limit re-check at import (the reference's CheckWeight
        # role): an author stuffing an overweight block is rejected
        # deterministically by every replica, BEFORE any pairing —
        # weights come from the static table, so this is dict sums.
        if len(exts) > self.MAX_EXTRINSICS_PER_BLOCK:
            raise BlockImportError(
                f"too many extrinsics: {len(exts)} > "
                f"{self.MAX_EXTRINSICS_PER_BLOCK}")
        total_weight = sum(
            fees_mod.weight_of(e.module, e.call) for e in exts)
        if total_weight > self.rt.fees.block_weight_limit:
            raise BlockImportError(
                f"overweight block: {total_weight} > "
                f"{self.rt.fees.block_weight_limit}")
        for ext in exts:
            if ext.tip < 0:
                raise BlockImportError("negative tip")
        # ONE weighted batch pairing covers the author's block
        # signature, the VRF slot proof, and every extrinsic signature
        # (1 + #distinct-keys Miller-loop groups instead of 2 per
        # signature).  The Fiat–Shamir weights (ops/bls_agg
        # verify_batch_host) make the check per-signature sound — a
        # plain aggregate is malleable, and the VRF OUTPUT is derived
        # from the proof bytes, so proof malleability would hand the
        # author a grindable randomness contribution.
        from ..ops import bls_agg

        triples: list[tuple[bytes, bytes, bytes]] = []
        seen_payloads = {block.signing_payload(self.genesis), vrf_msg}
        try:
            if not author_verified:
                triples.append((
                    pk, block.signing_payload(self.genesis),
                    bytes.fromhex(block.signature),
                ))
            triples.append((pk, vrf_msg, bytes.fromhex(block.vrf_proof)))
        except ValueError:
            raise BlockImportError("undecodable signature")
        for ext in exts:
            epk = self.keys.get(ext.signer)
            if epk is None or not ext.signature:
                raise BlockImportError("unknown or unsigned extrinsic")
            payload = ext.payload(self.genesis)
            if payload in seen_payloads:
                raise BlockImportError("duplicate extrinsic payload")
            seen_payloads.add(payload)
            try:
                triples.append((epk, payload, bytes.fromhex(ext.signature)))
            except ValueError:
                raise BlockImportError("undecodable signature")
        if not sigs_verified:
            with self.tracer.span(
                "import.sig_batch", tags={"sigs": len(triples)}
            ), self.m_import_stage["sig_batch"].time():
                ok = bls_agg.verify_batch_host(
                    triples, seed=self.genesis.encode())
            if not ok:
                raise BlockImportError("bad block/extrinsic/vrf signature")

        if journal_delta is not None:
            # Journal fast-forward: the delta came from OUR OWN journal
            # (already signature-checked above), so replaying it and
            # checking the root against the signed header is as strong
            # as re-execution — the root commits to every leaf.
            try:
                root = self.statedb.apply(journal_delta)
            except (KeyError, TypeError, ValueError, AttributeError):
                root = None
            if root == block.state_hash:
                record = BlockRecord(
                    number=block.number, author=block.author,
                    imported=True)
                # per-extrinsic receipts are not replayed (telemetry
                # loss, like events); the hashes are deterministic
                record.extrinsics = [
                    ext.hash(self.genesis) for ext in exts]
                for ext in exts:
                    cur = self.nonces.get(ext.signer, 0)
                    self.nonces[ext.signer] = max(cur, ext.nonce + 1)
                self.pool.prune(set(record.extrinsics), self.rt.state.nonces)
                self._update_pool_metrics()
                return record, journal_delta, []
            if root is not None:
                self.statedb.revert(journal_delta)
            # fall through to deterministic re-execution
        ev_base = self.rt.state.event_mark()
        # the verified output becomes consensus state before the block
        # executes — mirror of produce_block's fold order
        with self.tracer.span(
            "import.execute", tags={"extrinsics": len(exts)}
        ), self.m_import_stage["execute"].time():
            self.rt.rrsc.fold_vrf_output(
                block.slot, bytes.fromhex(block.vrf_output))
            self.rt.run_blocks(1)
            record = BlockRecord(
                number=self.rt.state.block_number, author=block.author,
                imported=True)
            self._apply_extrinsics(exts, record)
            # identical fee split to produce_block, pre-snapshot
            self.rt.fees.distribute(block.author)
        with self.tracer.span("import.snapshot"), \
                self.m_import_stage["snapshot"].time(), \
                self.m_state_hash["incremental"].time():
            shash, delta = self.statedb.commit()
        self.m_state_dirty.observe(len(delta))
        if shash != block.state_hash:
            # rewind the event sink too: the delta tracks keyed state
            # only, so the revert below cannot do it
            del self.rt.state.events[ev_base:]
            self.statedb.revert(delta)
            raise BlockImportError("post-state hash mismatch")
        events = self.rt.state.events_since(ev_base)
        # advance intake nonces so local submissions stay in step,
        # and drop now-included extrinsics from our own pool
        for ext in exts:
            cur = self.nonces.get(ext.signer, 0)
            self.nonces[ext.signer] = max(cur, ext.nonce + 1)
        self.pool.prune(set(record.extrinsics), self.rt.state.nonces)
        self._update_pool_metrics()
        return record, delta, events

    def handle_announce(self, block_json: dict,
                        trace: str | None = None) -> str:
        """`sync_announce` intake: queue for pipelined import, or catch
        up on a gap.  Concurrent announcers' blocks coalesce in the
        import queue and one drainer folds their pairings into batches
        (import_batch); each announcer gets its own block's verdict
        back.  `trace` is the author's trace-id envelope (telemetry
        only)."""
        try:
            block = Block.from_json(block_json)
        except (KeyError, TypeError, ValueError) as e:
            raise BlockImportError(f"malformed block: {e!r}")
        kind, payload = self._queued_import(block, trace)
        if kind == "gap":
            if self.sync is not None:
                self.sync.catch_up()
            return "gap"
        if kind == "rejected":
            # an unknown parent means the announcer is on another fork —
            # let catch-up walk back to the common ancestor and decide
            # by chain length rather than dropping the peer's chain.
            # (m_import_rejected was already counted by import_block.)
            if "unknown parent" in payload and self.sync is not None:
                self.sync.catch_up()
                return "fork"
            raise BlockImportError(payload)
        return "imported" if kind == "imported" else "known"

    # ------------------------------------------- pipelined import queue

    def import_queue_depth(self) -> int:
        """Blocks waiting in the pipelined import queue (the
        system_health backlog signal)."""
        with self._lock:
            return len(self._import_queue)

    def _era_boundary(self, number: int) -> bool:
        """True when `number` is the last block the CURRENT epoch
        context's VRF messages are valid for (rotation happens inside
        the boundary block, affecting only later claims) — the prefetch
        gate: pairing the next batch's messages across a boundary would
        verify soon-to-be-stale messages."""
        era = getattr(self.rt.config, "era_duration_blocks", 0) or 0
        return era > 0 and number > 0 and number % era == 0

    def _verifier(self) -> ThreadPoolExecutor:
        """The (lazy) 1-worker pairing pool: batch k+1's weighted
        pairing runs here while the import thread re-executes batch k —
        the chain-plane double-buffering mirror of the fused-verify
        prefetch worker.  One worker keeps batch verdicts ordered."""
        with self._lock:
            if self._import_verifier is None:
                self._import_verifier = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="import-verify")
            return self._import_verifier

    def _timed_pairing(self, triples: list, trace: str | None) -> bool:
        """Runs on the verifier worker: ONE weighted pairing over a
        whole batch's author + VRF + extrinsic signatures."""
        from ..ops import bls_agg

        with self.tracer.span(
            "import.batch_pairing",
            trace=(trace if tracing.valid_trace_id(trace)
                   else tracing.mint_trace_id()),
            tags={"sigs": len(triples)},
        ), self.m_import_stage["sig_batch"].time():
            return bls_agg.verify_batch_host(
                triples, seed=self.genesis.encode())

    def _batch_prefix_locked(  # holds-lock: _lock
        self, blocks: list[Block], base_n: int,
    ) -> tuple[int, list, list]:
        """The batchable prefix of `blocks` atop head number `base_n`:
        consecutive numbers, capped at import_batch_max and at the next
        era boundary (inclusive — the sync_block_range rule: VRF
        messages built from the CURRENT epoch context are valid up to
        and including the boundary block), stopping at the first block
        whose triples don't build or whose VRF output does not re-derive
        from its proof (vrf.batch_claim_triples — a bad claim must meet
        the per-block path, never be dropped from the pairing).

        Returns (n, triples, msgs): n ≥ 2 blocks covered by `triples`
        (one weighted pairing), with `msgs` their VRF messages for the
        per-block recheck; n < 2 means the prefix is not batchable."""
        n_contig = 0
        for want_n, blk in zip(range(base_n + 1, base_n + 1 + len(blocks)),
                               blocks):
            if blk.number != want_n:
                break
            n_contig += 1
        cap = min(n_contig, self.import_batch_max)
        era = getattr(self.rt.config, "era_duration_blocks", 0) or 0
        if era > 0:
            boundary = (base_n + 1) + (-(base_n + 1)) % era
            cap = min(cap, boundary - base_n)
        if cap < 2:
            return 0, [], []
        groups: list[tuple[list, tuple, bytes]] = []
        for blk in blocks[:cap]:
            try:
                pk = self.keys.get(blk.author)
                if pk is None or not blk.signature:
                    break
                msg = consensus.slot_message(self.genesis, self.rt.rrsc,
                                             blk.slot)
                entry = [(pk, blk.signing_payload(self.genesis),
                          bytes.fromhex(blk.signature))]
                for e in blk.extrinsics:
                    ext = Extrinsic.from_json(e)
                    epk = self.keys.get(ext.signer)
                    if epk is None or not ext.signature:
                        raise ValueError("unknown extrinsic signer")
                    entry.append((epk, ext.payload(self.genesis),
                                  bytes.fromhex(ext.signature)))
                claim = (pk, msg, bytes.fromhex(blk.vrf_output),
                         bytes.fromhex(blk.vrf_proof))
            except (KeyError, TypeError, ValueError):
                break
            groups.append((entry, claim, msg))
        vrf_triples, ok = vrf_mod.batch_claim_triples(
            [claim for _, claim, _ in groups])
        n = min(len(groups), ok)
        if n < 2:
            return 0, [], []
        triples: list = []
        for entry, _, _ in groups[:n]:
            triples.extend(entry)
        triples.extend(vrf_triples[:n])
        return n, triples, [msg for _, _, msg in groups[:n]]

    def _stage_batch(self, blocks: list[Block], i: int, base_n: int,
                     trace: str | None) -> dict | None:
        """Stage the batch starting at blocks[i] against head number
        `base_n`: sample the batchable prefix under the lock and submit
        its pairing to the verifier worker.  base_n is the CURRENT head
        for the first batch and the staged end of batch k for the
        prefetched batch k+1 (import_batch discards the prefetch if
        batch k lands anywhere else).  Returns the dict the drain loop
        consumes (cnt=1, fut=None when unbatchable — the per-block
        path), or None past the end."""
        if i >= len(blocks):
            return None
        with self._lock:
            n, triples, msgs = self._batch_prefix_locked(
                blocks[i:], base_n)
        if n < 2:
            return {"i": i, "cnt": 1, "msgs": [], "fut": None,
                    "end": None}
        fut = self._verifier().submit(self._timed_pairing, triples,
                                      trace)
        return {"i": i, "cnt": n, "msgs": msgs, "fut": fut,
                "end": base_n + n}

    def import_batch(
        self, blocks: list[Block], traces: list | None = None,
        origin: str = "batch", deltas: list | None = None,
    ) -> list[tuple[str, object]]:
        """Import consecutive peer blocks with their pairings folded
        into weighted batches (the pipelined import path shared by
        gossip drain, range catch-up, and journal replay).  While batch
        k's blocks re-execute on this thread, batch k+1's pairing runs
        on the verifier worker (prefetch skipped across era boundaries
        — the epoch context rotates inside them).  A failed batch
        pairing falls back to per-block verification for exactly those
        blocks, isolating the bad one without poisoning siblings; state
        hashes are checked per block either way, so the outcome is
        bit-identical to the serial path.

        Returns one outcome per block, aligned with `blocks`:
        ("imported", BlockRecord) | ("known", None) | ("gap", None) |
        ("rejected", reason-str)."""
        outcomes: list[tuple[str, object]] = []
        if not blocks:
            return outcomes
        trace = None
        if traces:
            for t in traces:
                if tracing.valid_trace_id(t):
                    trace = t
                    break
        staged = self._stage_batch(blocks, 0, self.head_number(), trace)
        while staged is not None:
            i, cnt, fut = staged["i"], staged["cnt"], staged["fut"]
            nxt = None
            if (fut is not None and i + cnt < len(blocks)
                    and not self._era_boundary(staged["end"])):
                # double-buffer: submit batch k+1's pairing before
                # executing batch k — the single verifier worker runs
                # it while this thread re-executes batch k's blocks
                nxt = self._stage_batch(blocks, i + cnt, staged["end"],
                                        trace)
            verified = bool(fut.result()) if fut is not None else False
            if fut is not None:
                self.m_import_batch.observe(cnt)
            with self.tracer.span(
                "import.batch",
                trace=(trace if tracing.valid_trace_id(trace)
                       else tracing.mint_trace_id()),
                tags={"origin": origin, "blocks": cnt,
                      "batched": verified},
            ):
                for j in range(i, i + cnt):
                    tr = (traces[j] if traces and j < len(traces)
                          else None)
                    try:
                        rec = self.import_block(
                            blocks[j], sigs_verified=verified, trace=tr,
                            origin=origin,
                            batch_vrf_msg=(staged["msgs"][j - i]
                                           if verified else None),
                            journal_delta=(deltas[j] if deltas else None))
                    except SyncGap:
                        outcomes.append(("gap", None))
                    except BlockImportError as e:
                        outcomes.append(("rejected", str(e)))
                    else:
                        if rec is not None:
                            rec.batch_verified = verified
                        outcomes.append(
                            ("imported", rec) if rec is not None
                            else ("known", None))
            if nxt is not None and self.head_number() != staged["end"]:
                # batch k did not land where the prefetch assumed (a
                # reject/gap inside it, or a concurrent import): the
                # prefetched pairing covered the wrong context —
                # discard it and re-stage from the actual head
                if nxt["fut"] is not None:
                    nxt["fut"].cancel()
                nxt = None
            staged = nxt if nxt is not None else self._stage_batch(
                blocks, i + cnt, self.head_number(), trace)
        return outcomes

    def _queued_import(self, block: Block,
                       trace: str | None) -> tuple[str, object]:
        """Gossip-path import through the pipelined queue: enqueue,
        then either become the drainer or wait for a concurrent drain
        to judge our block.  Returns the import_batch outcome tuple for
        THIS block."""
        try:
            h = block.hash(self.genesis)
        except ValueError:
            raise BlockImportError("undecodable signature")
        with self._lock:
            if h in self.block_store:
                return "known", None
            # a stale verdict must not answer a fresh announce (the
            # parent may have arrived since a past rejection)
            self._import_results.pop(h, None)
            if h not in self._import_queued:
                self._import_queued.add(h)
                self._import_queue.append((h, block, trace))
                self.m_import_queue.set(len(self._import_queue))
        while True:
            with self._lock:
                got = self._import_results.get(h)
                if got is not None:
                    return got
                if not self._import_draining:
                    self._import_draining = True
                    break
                # a drain is running; it notifies when verdicts land.
                # Timed wait: if the drainer judged our block between
                # our enqueue and this wait, the re-check above finds
                # the verdict; the timeout only bounds lost-notify
                # corner cases.
                self._import_cv.wait(0.5)
        try:
            self._drain_import_queue()
        finally:
            with self._lock:
                self._import_draining = False
                self._import_cv.notify_all()
        with self._lock:
            return self._import_results.get(h, ("known", None))

    def _drain_import_queue(self) -> None:
        """The drain loop (exactly one thread at a time,
        _import_draining): snapshot the whole queue, run it through
        import_batch sorted by number (concurrent announcers enqueue
        out of order; a contiguous run is what batches), publish
        per-hash verdicts, repeat until the queue is empty."""
        while True:
            with self._lock:
                if not self._import_queue:
                    return
                batch = list(self._import_queue)
                self._import_queue.clear()
                for h, _, _ in batch:
                    self._import_queued.discard(h)
                self.m_import_queue.set(0)
            batch.sort(key=lambda e: e[1].number)
            outcomes = self.import_batch(
                [b for _, b, _ in batch],
                traces=[t for _, _, t in batch], origin="gossip")
            with self._lock:
                for (h, _, _), out in zip(batch, outcomes):
                    self._import_results[h] = out
                while len(self._import_results) > IMPORT_RESULT_CACHE_MAX:
                    self._import_results.popitem(last=False)
                self._import_cv.notify_all()

    def reorg_to(self, ancestor_number: int) -> bool:
        """Rewind the chain to `ancestor_number` (longest-chain fork
        resolution): revert each retracted block's state delta newest
        first and drop all bookkeeping above it.  Refuses to cross
        finality or leave the delta window — checked for EVERY block in
        the retraction range BEFORE mutating anything, so a refusal
        leaves state untouched."""
        with self._lock:
            head_n = self.rt.state.block_number
            if ancestor_number < self.finalized_number:
                return False
            if ancestor_number >= head_n:
                return True
            if ancestor_number == 0:
                anchor = self.genesis
            else:
                blk = self.block_by_number.get(ancestor_number)
                if blk is None:
                    return False
                anchor = blk.hash(self.genesis)
            # transactional pre-check: every retracted block must have
            # a journalled delta, or the unwind would strand mid-chain
            chain: list[tuple[Block, str, list]] = []
            for n in range(head_n, ancestor_number, -1):
                blk = self.block_by_number.get(n)
                if blk is None:
                    return False
                bh = blk.hash(self.genesis)
                delta = self._state_deltas.get(bh)
                if delta is None:
                    return False
                chain.append((blk, bh, delta))
            retracted = []
            for blk, bh, delta in chain:
                # newest first, so the event-sink tail rewinds block by
                # block (each retraction strips its own events tail)
                self.statedb.revert(delta)
                self.block_by_number.pop(blk.number, None)
                retracted.append(blk)
                self.block_store.pop(bh, None)
                self._state_deltas.pop(bh, None)
                self._retract_events(bh)
            while self.blocks and self.blocks[-1].number > ancestor_number:
                self.blocks.pop()
            self.head_hash = anchor
            # _voted keeps retracted heights on purpose: re-voting a
            # replaced hash is equivocation (see _rollback_head)
            retracted.reverse()  # requeue oldest-first: nonce order
            self._requeue_retracted(retracted)
            self.m_reorgs.inc()
            return True

    # ------------------------------------------------------ finality

    def _finality_target(self) -> tuple[int, str] | None:
        """Highest multiple of finality_period at or below head (the
        canonical vote target every replica agrees on)."""
        period = self.spec.finality_period
        if period <= 0:
            return None
        head_n = self.rt.state.block_number
        target = head_n - head_n % period
        if target <= self.finalized_number or target == 0:
            return None
        blk = self.block_by_number.get(target)
        if blk is None:
            return None
        return target, blk.hash(self.genesis)

    def _finality_tick(self) -> Vote | None:
        """Sign + gossip this validator's vote for the current target
        (the GRANDPA voter role).  Runs from the slot loop and after
        imports; no-ops for non-validator or keyless nodes.  Returns
        the vote it cast (tests relay these between lockstep nodes)."""
        ident = self._ocw_identity
        if (ident is None or self.authority_sk is None
                or ident not in self.spec.validators):
            return None
        if self.authority is None and self.sync is not None:
            # networked but keyless: the dev fallback identity would
            # sign votes under validators[0]'s derived key — a forged
            # vote that conflicts with the real validator's evicts it
            # from every tally as an equivocator (same guard as
            # produce_block)
            return None
        with self._lock:
            tgt = self._finality_target()
            if tgt is None or tgt[0] in self._voted:
                return None
            number, block_hash = tgt
            self._voted.add(number)
            sig = bls.sign(
                self.authority_sk,
                finality_payload(self.genesis, number, block_hash),
            ).hex()
            vote = Vote(number=number, block_hash=block_hash,
                        voter=ident, signature=sig)
        # our own signature from two lines up: skip the re-verify pairing
        self.add_vote(vote, _trusted=True)
        if self.sync is not None:
            self.sync.broadcast_vote(vote)
        return vote

    def add_vote(self, vote: Vote, _trusted: bool = False) -> bool:
        """Collect one finality vote (own or gossiped).  On a 2/3 quorum
        the votes aggregate into a justification (ops/bls_agg) that is
        applied locally and gossiped.  `_trusted=True` skips the ~0.38s
        pairing for a vote this node signed itself moments ago."""
        validators = self.spec.validators
        pk = self.keys.get(vote.voter)
        if vote.voter not in validators or pk is None:
            return False
        # stale/duplicate votes drop BEFORE the ~0.4s pairing: gossip
        # re-delivers every vote N-1 times, and the RPC intake is
        # unauthenticated, so replaying one valid vote must stay cheap
        with self._lock:
            if vote.number <= self.finalized_number:
                return False
            if vote.voter in self._equivocators.get(vote.number, ()):
                return False
            seen = self._votes.get((vote.number, vote.block_hash))
            if seen is not None and vote.voter in seen:
                return True
        if not _trusted:
            with self.tracer.span(
                "finality.vote_verify",
                trace=self.block_traces.get(vote.block_hash),
                tags={"voter": vote.voter, "number": vote.number},
            ):
                ok = bls.verify(
                    pk,
                    finality_payload(
                        self.genesis, vote.number, vote.block_hash),
                    bytes.fromhex(vote.signature),
                )
            if not ok:
                return False
        just = None
        offence = None
        with self._lock:
            if vote.number <= self.finalized_number:
                return False
            if vote.voter in self._equivocators.get(vote.number, ()):
                return False
            prior = self._vote_hash.get(vote.number, {}).get(vote.voter)
            if prior is not None and prior != vote.block_hash:
                # Proven equivocation — both signatures verified (the
                # prior one at tally time, this one just above; an
                # unverified conflicting vote must never evict an
                # honest validator's weight).  Purge the voter from
                # every tally at this height and refuse further votes
                # — and turn the signature pair into a PORTABLE
                # offence report (chain/offences.py): two signatures
                # over conflicting finality payloads that any replica
                # can re-verify, so one honest observer convicts the
                # equivocator on every node (submitted below, outside
                # the lock).
                prior_sig = self._votes.get(
                    (vote.number, prior), {}).get(vote.voter)
                self._equivocators.setdefault(
                    vote.number, set()).add(vote.voter)
                for (n, _h), tally in self._votes.items():
                    if n == vote.number:
                        tally.pop(vote.voter, None)
                self._vote_hash[vote.number].pop(vote.voter, None)
                if prior_sig is not None:
                    offence = self._vote_offence_report(
                        vote, prior, prior_sig)
            else:
                tally = self._votes.setdefault(
                    (vote.number, vote.block_hash), {})
                if vote.voter in tally:
                    return True
                tally[vote.voter] = vote.signature
                self._vote_hash.setdefault(
                    vote.number, {})[vote.voter] = vote.block_hash
                self.m_votes.inc()
                self.tracer.event(
                    "finality.vote",
                    trace=self.block_traces.get(vote.block_hash),
                    tags={"voter": vote.voter, "number": vote.number,
                          "tally": len(tally)},
                )
                if quorum(len(tally), len(validators)):
                    just = Justification.from_votes(
                        vote.number, vote.block_hash, tally)
        if offence is not None:
            self._submit_offence_report(offence)
            return False
        if just is not None and self.handle_justification(
            just, _verified=True  # aggregated from individually
        ):                        # verified votes one line up
            if self.sync is not None:
                self.sync.broadcast_justification(just)
        return True

    def handle_justification(
        self, just: Justification, _verified: bool = False
    ) -> bool:
        """Verify and apply a finality justification; returns True when
        it advanced our finalized head.  Forged aggregates, sub-quorum
        signer sets, and non-validator signers are rejected
        (sync.verify_justification).  `_verified=True` skips the
        aggregate pairing for a justification this node already
        verified (buffered pending) or built from verified votes.
        Stale ones drop before the pairing — every finality period each
        validator gossips the same justification, and the RPC intake is
        unauthenticated, so replays must stay cheap."""
        with self._lock:
            if just.number <= self.finalized_number:
                return False
        if not _verified:
            with self.tracer.span(
                "finality.just_verify",
                trace=self.block_traces.get(just.block_hash),
                tags={"number": just.number,
                      "signers": len(just.signers)},
            ):
                ok = verify_justification(
                    just, self.genesis, self.spec.validators, self.keys)
            if not ok:
                return False
        with self._lock:
            if just.number <= self.finalized_number:
                return False
            blk = self.block_by_number.get(just.number)
            if blk is None or blk.hash(self.genesis) != just.block_hash:
                # Keep the (already verified) justification and retry
                # once the justified block imports.  Two ways to get
                # here: the justification outran its block (dropping it
                # can stall finality at exactly 2/3 quorum, where no
                # further votes will ever arrive), or we hold a
                # COMPETING block at that height (same-height fork) —
                # the longest-chain rule reorgs us onto the justified
                # branch within a block, and _post_block replays this.
                if (blk is not None
                        or just.number > self.rt.state.block_number):
                    self._pending_justs[just.number] = just
                return False
            self.finalized_number = just.number
            self.finalized_hash = just.block_hash
            self.justifications[just.number] = just
            self._prune_justifications()
            self.m_finalized.set(just.number)
            self.m_finality_lag.set(
                self.rt.state.block_number - just.number)
            self.tracer.event(
                "finality.finalized",
                trace=self.block_traces.get(just.block_hash),
                tags={"number": just.number,
                      "signers": len(just.signers)},
            )
            self._votes = {
                k: v for k, v in self._votes.items()
                if k[0] > just.number
            }
            self._voted = {n for n in self._voted if n > just.number}
            self._vote_hash = {
                n: v for n, v in self._vote_hash.items()
                if n > just.number
            }
            self._equivocators = {
                n: v for n, v in self._equivocators.items()
                if n > just.number
            }
            self._pending_justs = {
                n: j for n, j in self._pending_justs.items()
                if n > just.number
            }
            # durable finality: replaying the journal after a crash
            # recovers the finalized head, not just the chain tip
            if self.store is not None:
                self.store.journal_justification(just)
        return True

    def _prune_justifications(self) -> None:  # holds-lock: _lock
        """Drop held justifications below the retention horizon
        (JUST_RETENTION_BLOCKS under the finalized head): the
        chain_getJustification store must stay bounded on a
        long-running node — one entry lands every finality period."""
        floor = self.finalized_number - JUST_RETENTION_BLOCKS
        if floor <= 0:
            return
        for n in [n for n in self.justifications if n < floor]:
            del self.justifications[n]

    def handle_justifications(self, justs: list[Justification]) -> int:
        """Apply a batch of pulled justifications (catch-up ranges,
        sync.SyncManager._batch_import) in height order; returns how
        many advanced the finalized head.  The base service verifies
        each serially — a read replica (light/replica.py
        ReplicaService) overrides this to fold the whole batch's
        aggregate checks into ONE weighted pairing."""
        advanced = 0
        for just in sorted(justs, key=lambda j: j.number):
            if self.handle_justification(just):
                advanced += 1
        return advanced

    # ------------------------------------------------------ offences

    def _vote_offence_report(
        self, vote: Vote, prior_hash: str, prior_sig: str
    ) -> "offences_mod.OffenceReport":
        """Package a proven double-vote as portable evidence: the two
        finality payloads (node/sync.py canonical bytes) plus the
        offender's two verified signatures."""
        session = self.rt.session.session_of_block(vote.number)
        return offences_mod.OffenceReport(
            kind=offences_mod.KIND_VOTE_EQUIV, offender=vote.voter,
            session=session,
            evidence=[
                [finality_payload(
                    self.genesis, vote.number, prior_hash).hex(),
                 prior_sig],
                [finality_payload(
                    self.genesis, vote.number, vote.block_hash).hex(),
                 vote.signature],
            ],
        )

    def _block_offence_report(
        self, ours: Block, theirs: Block
    ) -> "offences_mod.OffenceReport":
        """Two verified headers for ONE slot by ONE author — the block
        flavor of equivocation evidence (both signing payloads carry
        the author and slot, so any replica re-verifies the conflict
        from the report alone)."""
        session = self.rt.session.session_of_block(ours.number)
        return offences_mod.OffenceReport(
            kind=offences_mod.KIND_BLOCK_EQUIV, offender=ours.author,
            session=session,
            evidence=[
                [ours.signing_payload(self.genesis).hex(),
                 ours.signature],
                [theirs.signing_payload(self.genesis).hex(),
                 theirs.signature],
            ],
        )

    def _submit_offence_report(self, report) -> None:
        """Route a locally proven (or peer-gossiped and re-verified)
        offence report: submit it as a signed extrinsic through our own
        pool when this node is a validator, and gossip the raw report so
        keyless observers' detections still reach someone who can.  Both
        paths dedup on the report key — gossip floods re-deliver every
        report N-1 times."""
        key = report.key()
        # check-then-act under the lock: this runs on the RPC/gossip
        # thread (sync_offence → handle_offence_report) concurrently
        # with the import path's _offences_seen reads — an unlocked
        # add() here raced a duplicate report into two submissions
        # (cesslint lock-guarded-write)
        with self._lock:
            if key in self._offences_seen:
                return
            self._offences_seen.add(key)
        self.m_offences.inc()
        ident = self._ocw_identity
        can_sign = (
            ident is not None and self.authority_sk is not None
            and not (self.authority is None and self.sync is not None)
        )
        if can_sign:
            with self._lock:
                if not self.rt.offences.known(key):
                    ext = Extrinsic(
                        signer=ident, module="offences",
                        call="report_offence", args=[report.to_json()],
                        nonce=self.nonces.get(ident, 0),
                    )
                    ext.sign(self.authority_sk, self.genesis)
                    try:
                        # our own signature from a line up: skip the
                        # intake pairing (the evidence itself is
                        # re-verified at dispatch on every replica)
                        self.submit_extrinsic(ext, _verified=True)
                    except ValueError:
                        pass
        if self.sync is not None:
            self.sync.broadcast_offence(report)

    def handle_offence_report(self, report_json: dict) -> str:
        """`sync_offence` intake: independently re-verify a gossiped
        report before relaying or submitting it — a forged report from
        a malicious peer dies here and is never signed into our pool."""
        try:
            report = offences_mod.OffenceReport.from_json(report_json)
        except (KeyError, TypeError, ValueError):
            return "malformed"
        if report.key() in self._offences_seen:
            return "known"
        if not offences_mod.verify_report(
            report, self.genesis, self.keys.get
        ):
            return "invalid"
        self._submit_offence_report(report)
        return "ok"

    # ------------------------------------------------------ offchain

    def _post_block(self, now: int) -> None:
        """Per-block offchain hooks: retry a justification that arrived
        before its block, then the audit OCW pass (reference:
        lib.rs:342-359) for this node's authority, submitting any
        challenge vote through its own pool as a signed extrinsic."""
        with self._lock:
            pending = self._pending_justs.pop(now, None)
        if pending is not None and self.handle_justification(
            pending, _verified=True  # verified when buffered
        ):
            if self.sync is not None:
                self.sync.broadcast_justification(pending)
        ident = self._ocw_identity
        if ident is None or self.authority_sk is None:
            return
        if self.authority is None and self.sync is not None:
            # networked but keyless: don't run the audit OCW under the
            # dev-derived validators[0] identity (same guard as
            # produce_block / _finality_tick)
            return
        # im-online heartbeat (reference: im-online lib.rs:342-359): a
        # networked authority signs ONE heartbeat per session through
        # its own pool — the same path as audit votes — so the
        # end-of-session sweep (chain/offences.py) can tell live
        # validators from silent ones.  Single-node / header-less
        # runtimes never heartbeat, and the sweep's zero-heartbeat
        # guard keeps them unchilled.  `chaos_mute` (--chaos-mute)
        # deliberately silences this node for liveness drills.
        if self.sync is not None and not self.chaos_mute:
            with self._lock:
                sess = self.rt.session.session_index
                if (sess not in self._hb_sent
                        and ident in self.rt.staking.validators):
                    self._hb_sent.add(sess)
                    self._hb_sent = {
                        s for s in self._hb_sent if s + 4 > sess
                    }
                    hb = Extrinsic(
                        signer=ident, module="offences", call="heartbeat",
                        args=[sess], nonce=self.nonces.get(ident, 0),
                    )
                    hb.sign(self.authority_sk, self.genesis)
                    try:
                        # self-signed a line up: skip the intake pairing
                        self.submit_extrinsic(hb, _verified=True)
                        self.m_heartbeats.inc()
                    except ValueError:
                        pass
        if self.sync is not None:
            # Self-healing candidacy: an offences chill suspends this
            # node's validator intent (staking.force_chill removes the
            # candidacy); once the chill lapses, a LIVE node re-declares
            # through its own pool — a spuriously chilled honest
            # validator rejoins the election, a dead one stays out.
            with self._lock:
                staking = self.rt.staking
                if ident in staking.candidates:
                    self._was_candidate = True
                elif (
                    self._was_candidate
                    and not staking.is_chilled(ident)
                    and ident in staking.ledger
                    and staking.ledger[ident].bonded
                    >= staking.min_validator_bond
                    and self._revalidate_era != staking.active_era
                ):
                    self._revalidate_era = staking.active_era
                    rv = Extrinsic(
                        signer=ident, module="staking", call="validate",
                        args=[], nonce=self.nonces.get(ident, 0),
                    )
                    rv.sign(self.authority_sk, self.genesis)
                    try:
                        self.submit_extrinsic(rv, _verified=True)
                    except ValueError:
                        pass
        with self._lock:
            if ident not in self.rt.audit.keys:
                return

            def submit(info):
                ext = Extrinsic(
                    signer=ident, module="audit",
                    call="save_challenge_info",
                    args=[challenge_info_to_json(info)],
                    nonce=self.nonces.get(ident, 0),
                )
                ext.sign(self.authority_sk, self.genesis)
                try:
                    # we signed this ourselves a line ago — skip the
                    # ~0.38s pairing re-verify while holding the lock
                    self.submit_extrinsic(ext, _verified=True)
                except ValueError:
                    pass

            with self.tracer.span(
                "ocw.audit",
                trace=self.block_traces.get(self.head_hash),
                tags={"block": now, "authority": ident},
            ):
                self.rt.audit.offchain_worker(now, ident, submit=submit)

    # ------------------------------------------------------ slot loop

    def start(self) -> None:
        """Background authoring at the spec's block time (the
        start_rrsc loop role, service.rs:459-505)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            period = self.spec.block_time_ms / 1000.0
            networked = self.sync is not None
            if networked:
                # a (re)joining node levels with its peers before taking
                # its own slots (the initial-sync role); a misbehaving
                # peer must not kill the authoring thread before it
                # produces a single block
                try:
                    self.sync.catch_up()
                except Exception:
                    pass
            while not self._stop.is_set():
                t0 = time.monotonic()
                if networked and self.authority is None:
                    # keyless observer/RPC full node: gossip only pushes
                    # to a validator's configured peers, so nothing
                    # announces to us — follow the network by polling
                    # catch-up (cheap when level: one sync_status per
                    # peer) instead of authoring
                    try:
                        self.sync.catch_up()
                    except Exception:
                        pass
                elif networked:
                    # wall-clock slots: every replica derives the same
                    # slot index from real time, so exactly one
                    # validator owns each slot (the BABE slot-clock
                    # discipline) instead of per-node drifting counters
                    self.produce_block(slot=int(time.time() / period))
                else:
                    self.produce_block()
                self._finality_tick()
                dt = time.monotonic() - t0
                self._stop.wait(max(0.0, period - dt))

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            verifier = self._import_verifier
            self._import_verifier = None
        if verifier is not None:
            verifier.shutdown(wait=False)

    # ------------------------------------------------------ state io

    def export_state(self) -> bytes:
        """Checkpoint blob (ExportState role, node/src/cli.rs:48-66)."""
        with self._lock:
            return checkpoint.snapshot(self.rt)

    def _reset_chain_index(self, anchor_hash: str, head: Block | None) -> None:  # holds-lock: _lock
        """Re-anchor block bookkeeping after a state restore: history
        before the restored state is not held, so the anchor (a synthetic
        hash, or the peer-supplied head block) becomes the parent of the
        next block."""
        self.block_store.clear()
        self.block_by_number.clear()
        self.blocks.clear()
        self._state_deltas.clear()
        # pre-restore history is gone: the event ring and the runtime
        # sink restart with the restored chain (events are per-block
        # telemetry, never part of a checkpoint blob)
        self.events_by_block.clear()
        self.rt.state.events.clear()
        self.head_hash = anchor_hash
        if head is not None:
            self.block_store[anchor_hash] = head
            self.block_by_number[head.number] = head
            self.slot = max(self.slot, head.slot)
        # the restore replaced pallet containers wholesale (destroying
        # the write-through wrappers) — rebase the state trie on the
        # restored runtime and restart the delta window from the anchor
        with self.m_state_hash["full"].time():
            self.statedb.rebase()
        self._state_deltas[anchor_hash] = []
        # Rebase the pool onto the restored consensus nonces: spent
        # slots drop, survivors keep their fee-priced priority.  The
        # rejection cache survives on purpose — a fee-rejected payload
        # must not resurrect just because the chain index moved.
        self.pool.prune(set(), self.rt.state.nonces)
        # Re-level the pool-intake high-water marks with the restored
        # consensus nonces + surviving pooled runs: a rejoined node
        # serving author_nonce from a stale map would have clients sign
        # already-spent nonces (every such extrinsic applies as a
        # failed receipt chain-wide).
        for acct in set(self.rt.state.nonces) | set(self.pool.accounts()):
            hw = self.rt.state.nonces.get(acct, 0)
            while self.pool.has(acct, hw):
                hw += 1
            if self.nonces.get(acct, 0) < hw:
                self.nonces[acct] = hw
        self._update_pool_metrics()

    def import_state(self, blob: bytes) -> None:
        """Dev/CLI restore: state only, synthetic head anchor (multi-node
        bootstrap goes through restore_checkpoint, which anchors to the
        peer's signed head block)."""
        with self._lock:
            checkpoint.restore(self.rt, blob)
            self._reset_chain_index(
                "ckpt:" + checkpoint.state_hash(self.rt), None)

    def restore_checkpoint(
        self, blob: bytes, head: Block | None,
        justification: Justification | None = None,
    ) -> bool:
        """Warp-sync bootstrap (service.rs:259-263 role): restore a
        peer's versioned state blob, verified against the signed +
        FINALIZED head block it claims to be the post-state of.  Trust
        anchors: the head must be signed by a validator, covered by a
        2/3 BLS-aggregate justification (one compromised validator must
        not be able to bootstrap a rejoining node onto a fabricated
        chain), and its state_hash must equal the restored state's
        hash; a peer lying about any of these is rejected and our state
        is rolled back."""
        if head is None or not head.signature:
            return False
        try:
            self._check_author_signature(head)
        except BlockImportError:
            return False
        bh = head.hash(self.genesis)
        if justification is None:
            return False
        if (justification.number != head.number
                or justification.block_hash != bh):
            return False
        if not verify_justification(
            justification, self.genesis, self.spec.validators, self.keys
        ):
            return False
        with self._lock:
            if head.number <= self.rt.state.block_number:
                return False
            undo = checkpoint.snapshot(self.rt)
            try:
                # the blob is peer-supplied: ANY failure mode (bad
                # format, unknown pallet names, wrong field types) must
                # land in the undo restore, or a malicious peer leaves
                # the runtime half-mutated
                checkpoint.restore(self.rt, blob)
                ok = (self.rt.state.block_number == head.number
                      and checkpoint.state_hash(self.rt)
                      == head.state_hash)
            except Exception:
                ok = False
            if not ok:
                checkpoint.restore(self.rt, undo)
                # restore replaced the pallet containers — re-attach
                # the state trie's write-through tracking
                self.statedb.rebase()
                return False
            self._reset_chain_index(bh, head)
            # the anchor arrived finalized — start from there
            self.finalized_number = head.number
            self.finalized_hash = bh
            self.justifications[head.number] = justification
            self.m_finalized.set(head.number)
            if self.store is not None:
                # the local journal's history no longer chains to the
                # warped anchor: persist the restored state (re-encoded
                # at the CURRENT format — the peer blob may be older)
                # and restart the journal from it
                self.store.on_warp(
                    checkpoint.snapshot(self.rt), head, justification)
        return True

    def restore_local_checkpoint(
        self, blob: bytes, head: Block,
        justification: Justification | None = None,
    ) -> bool:
        """Disk-recovery restore (node/store.py ladder rung 1): like
        restore_checkpoint, but for a blob from OUR OWN data dir, so
        the 2/3-justification requirement is dropped — the trust
        anchors that remain are exactly the ones a tampered disk cannot
        forge: the head block must carry a validator's signature over
        its state_hash, and the restored state must hash to it.  A
        justification stored next to the checkpoint still verifies in
        full before it advances the finalized head (an invalid one is
        ignored, not fatal — finality gossip re-delivers)."""
        if head is None or not head.signature:
            return False
        try:
            self._check_author_signature(head)
        except BlockImportError:
            return False
        bh = head.hash(self.genesis)
        with self._lock:
            if head.number <= self.rt.state.block_number:
                return False
            undo = checkpoint.snapshot(self.rt)
            try:
                checkpoint.restore(self.rt, blob)
                ok = (self.rt.state.block_number == head.number
                      and checkpoint.state_hash(self.rt)
                      == head.state_hash)
            except Exception:
                ok = False
            if not ok:
                checkpoint.restore(self.rt, undo)
                # restore replaced the pallet containers — re-attach
                # the state trie's write-through tracking
                self.statedb.rebase()
                return False
            self._reset_chain_index(bh, head)
            if (
                justification is not None
                and justification.number == head.number
                and justification.block_hash == bh
                and verify_justification(
                    justification, self.genesis, self.spec.validators,
                    self.keys)
            ):
                self.finalized_number = head.number
                self.finalized_hash = bh
                self.justifications[head.number] = justification
                self.m_finalized.set(head.number)
        return True

    def state_hash(self) -> str:
        """Head state root — O(1): the incrementally maintained trie
        root, not a full re-encode (checkpoint.state_hash stays as the
        bit-identity oracle, checked at every on-disk checkpoint)."""
        with self._lock:
            return self.statedb.root_hex()

    def events_of_block(self, block_ref) -> tuple | None:
        """Per-block deposited events (`chain_getEvents` feed): accepts
        a block hash or number; returns (hash, number, events, digest)
        with the digest over the canonical event encoding
        (chain/checkpoint.py events_digest) — replicas that executed
        the block identically serve bit-identical lists."""
        with self._lock:
            if isinstance(block_ref, int) or (
                isinstance(block_ref, str) and block_ref.isdigit()
            ):
                blk = self.block_by_number.get(int(block_ref))
                if blk is None:
                    return None
                bh = blk.hash(self.genesis)
            else:
                bh = str(block_ref)
            entry = self.events_by_block.get(bh)
            if entry is None:
                return None
            number, events = entry
            events = list(events)
        return bh, number, events, checkpoint.events_digest(events)
