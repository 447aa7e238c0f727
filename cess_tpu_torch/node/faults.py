"""Deterministic, seed-driven network fault injection (chaos harness).

The sync layer's gossip queues and catch-up RPC (node/sync.py) are the
only paths consensus messages travel, so hostile-network behavior —
lossy links, slow links, duplicating relays, reordering queues, full
partitions — can be reproduced exactly by shaping those two seams.
This module is that shaper:

 * **Determinism**: every decision is drawn from a per-peer
   `random.Random` stream keyed by blake2b(seed ‖ peer), advanced once
   per message.  Two injectors built from the same seed make identical
   decisions for identical call sequences — the property the soak test
   relies on ("the same seed reproduces the same fault schedule",
   tests/test_faults.py), and what makes a chaos failure replayable by
   re-running with the printed seed.
 * **Gossip** (`shape_gossip`): drop / delay / duplicate / reorder
   per-message, plus windowed per-peer partitions.  Reordering swaps
   adjacent messages by holding one back per peer — the strongest
   reorder an ordered single-worker queue (sync.SyncManager._pools)
   can exhibit.
 * **Catch-up RPC** (`rpc_gate`): injected `ChaosError` (an OSError —
   exercised by sync's transient-retry backoff) and injected latency,
   sharing the partition state with gossip so a partitioned peer is
   unreachable on BOTH planes.
 * **Crash-restart** (`crash_schedule`): the seed also fixes which
   node crashes at which block — harnesses (tests/test_zz_chaos_*)
   kill and relaunch accordingly, so even process death is part of the
   reproducible schedule.
 * **Storage** (`disk_write_gate` / `disk_read_gate`): the on-disk
   store (node/store.py) routes its file ops through the injector —
   seed-deterministic ENOSPC, torn writes, bit flips, and short reads
   exercise the degraded-mode and recovery-truncation contracts
   (tests/test_persistence.py).

Enabled per node via `--chaos-seed N [--chaos-profile mild|hostile]`
(node/cli.py); each node shapes only its own OUTBOUND traffic, so a
mixed fleet of chaotic and clean nodes is well-defined.
"""

from __future__ import annotations

import hashlib
import random
import threading
import time
from dataclasses import dataclass, field


class ChaosError(OSError):
    """Injected network failure — an OSError so the sync layer's
    transient-error handling (timeouts, refused sockets) treats it
    exactly like the real thing."""


@dataclass(frozen=True)
class ChaosProfile:
    """Per-message fault probabilities.  `partition` is drawn once per
    `partition_len` messages per peer; while a partition window is
    open, everything to that peer drops."""

    name: str
    drop: float = 0.0
    delay: float = 0.0
    delay_ms: tuple = (5, 50)
    duplicate: float = 0.0
    reorder: float = 0.0
    partition: float = 0.0
    partition_len: int = 8
    # Spam-flood load (the fee-market soak): the CLI spins up
    # `flood_accounts` synthetic signers per node, each submitting
    # ~`flood_rate` underpriced extrinsics per second at `flood_tip`.
    # 0 accounts = no flood (all network-only profiles).
    flood_accounts: int = 0
    flood_rate: float = 0.0
    flood_tip: int = 0
    # Storage fault plane (node/store.py wraps its file ops through
    # disk_write_gate / disk_read_gate): per-operation probabilities of
    # an injected ENOSPC (raises ChaosError before any byte lands), a
    # torn write (only a prefix reaches disk but the write "succeeds" —
    # a lying disk / power-loss model), a flipped bit, and a short
    # read.  All zero on the network-only profiles.
    disk_enospc: float = 0.0
    disk_torn: float = 0.0
    disk_flip: float = 0.0
    disk_short_read: float = 0.0


PROFILES = {
    "off": ChaosProfile("off"),
    # sustained lossy-link faults without partitions: what a soak can
    # run for minutes while the chain keeps making progress
    "light": ChaosProfile(
        "light", drop=0.04, delay=0.10, delay_ms=(5, 50),
        duplicate=0.05,
    ),
    "mild": ChaosProfile(
        "mild", drop=0.05, delay=0.10, delay_ms=(5, 60),
        duplicate=0.05, reorder=0.05, partition=0.02, partition_len=5,
    ),
    "hostile": ChaosProfile(
        "hostile", drop=0.20, delay=0.25, delay_ms=(20, 200),
        duplicate=0.10, reorder=0.10, partition=0.08, partition_len=10,
    ),
    # fee-market flood: light network faults + duplicate-heavy gossip
    # (exercising the intake dedupe) while synthetic spam accounts
    # hammer the pool with zero-tip traffic
    "flood": ChaosProfile(
        "flood", drop=0.02, delay=0.05, delay_ms=(5, 40),
        duplicate=0.10, flood_accounts=6, flood_rate=8.0, flood_tip=0,
    ),
    # hostile disk under a quiet network: the persistence drills —
    # intermittent ENOSPC, the occasional torn/bit-flipped write, and
    # short reads at recovery.  The store must degrade (never crash)
    # and recovery must truncate (never accept a torn record).
    "baddisk": ChaosProfile(
        "baddisk", disk_enospc=0.10, disk_torn=0.05, disk_flip=0.02,
        disk_short_read=0.05,
    ),
}


@dataclass
class GossipShape:
    """One gossip message's fate: `sends` is the list of (delay_s,
    message) actually dispatched (possibly empty = dropped, possibly
    >1 = duplicated, possibly containing an earlier held-back message
    = reordered); `faults` names what was injected (observability)."""

    sends: list = field(default_factory=list)
    faults: list = field(default_factory=list)


class FaultInjector:
    def __init__(self, seed: int, profile: "ChaosProfile | str" = "mild"):
        if isinstance(profile, str):
            profile = PROFILES[profile]
        self.seed = int(seed)
        self.profile = profile
        self._lock = threading.Lock()
        self._streams: dict = {}       # peer -> random.Random
        self._partition_left: dict = {}  # peer -> messages still cut
        self._since_partition: dict = {}  # peer -> msgs since last draw
        self._held: dict = {}          # peer -> held-back message
        self.injected = 0              # total faults injected

    def _stream(self, peer) -> random.Random:
        rnd = self._streams.get(peer)
        if rnd is None:
            key = f"{self.seed}/{peer[0]}:{peer[1]}".encode()
            rnd = random.Random(int.from_bytes(
                hashlib.blake2b(key, digest_size=8).digest(), "big"
            ))
            self._streams[peer] = rnd
        return rnd

    def _partitioned(self, peer, rnd: random.Random) -> bool:
        """Windowed partitions: every partition_len messages the peer
        link re-rolls; a hit cuts the next partition_len messages on
        both the gossip and RPC planes."""
        left = self._partition_left.get(peer, 0)
        if left > 0:
            self._partition_left[peer] = left - 1
            return True
        since = self._since_partition.get(peer, 0) + 1
        if since >= self.profile.partition_len:
            since = 0
            if rnd.random() < self.profile.partition:
                self._partition_left[peer] = self.profile.partition_len
        self._since_partition[peer] = since
        return False

    # ------------------------------------------------------ gossip

    def shape_gossip(self, peer, message) -> GossipShape:
        """Decide one outbound gossip message's fate.  `message` is
        opaque to the injector (the sync layer passes (method, params));
        held-back messages are returned ahead of nothing — reordering
        releases them AFTER the current message, swapping the pair."""
        with self._lock:
            rnd = self._stream(peer)
            shape = GossipShape()
            prof = self.profile
            if self._partitioned(peer, rnd):
                shape.faults.append("partition")
                self.injected += 1
                # a partition also flushes nothing: held messages die
                # with the link, exactly like a real outage
                self._held.pop(peer, None)
                return shape
            if rnd.random() < prof.drop:
                shape.faults.append("drop")
                self.injected += 1
                return shape
            delay = 0.0
            if rnd.random() < prof.delay:
                lo, hi = prof.delay_ms
                delay = rnd.uniform(lo, hi) / 1000.0
                shape.faults.append("delay")
                self.injected += 1
            if rnd.random() < prof.reorder and peer not in self._held:
                # hold this message back; the NEXT message to this peer
                # releases it afterwards — an adjacent swap
                self._held[peer] = (delay, message)
                shape.faults.append("hold")
                self.injected += 1
                return shape
            shape.sends.append((delay, message))
            if rnd.random() < prof.duplicate:
                shape.faults.append("duplicate")
                self.injected += 1
                shape.sends.append((delay, message))
            held = self._held.pop(peer, None)
            if held is not None:
                shape.faults.append("release")
                shape.sends.append(held)
            return shape

    # ------------------------------------------------------ catch-up RPC

    def rpc_gate(self, peer, method: str) -> None:
        """Consulted before every catch-up RPC attempt: raises
        ChaosError for an injected drop (or open partition) and sleeps
        an injected latency otherwise.  Each retry attempt consults
        the gate again, so sync's bounded backoff genuinely re-rolls."""
        with self._lock:
            rnd = self._stream(peer)
            prof = self.profile
            if self._partitioned(peer, rnd):
                self.injected += 1
                raise ChaosError(f"chaos: partition to {peer}")
            if rnd.random() < prof.drop:
                self.injected += 1
                raise ChaosError(f"chaos: dropped {method} to {peer}")
            delay = 0.0
            if rnd.random() < prof.delay:
                lo, hi = prof.delay_ms
                delay = rnd.uniform(lo, hi) / 1000.0
                self.injected += 1
        if delay:
            time.sleep(delay)

    # ------------------------------------------------------ storage

    def disk_write_gate(self, data: bytes) -> bytes:
        """Consulted by the store (node/store.py) with the exact bytes
        about to hit disk: raises ChaosError(ENOSPC) for an injected
        full disk, returns a truncated prefix for a torn write (the
        write APPEARS to succeed — the power-loss/lying-disk model the
        recovery ladder must truncate at), or the buffer with one bit
        flipped.  Same seed, same fault schedule — the disk draws from
        its own deterministic stream, independent of the network
        planes."""
        with self._lock:
            rnd = self._stream(("disk", "w"))
            prof = self.profile
            if rnd.random() < prof.disk_enospc:
                self.injected += 1
                raise ChaosError(28, "chaos: injected ENOSPC")
            if data and rnd.random() < prof.disk_torn:
                self.injected += 1
                return data[:rnd.randrange(len(data))]
            if data and rnd.random() < prof.disk_flip:
                self.injected += 1
                i = rnd.randrange(len(data))
                return (data[:i]
                        + bytes([data[i] ^ (1 << rnd.randrange(8))])
                        + data[i + 1:])
            return data

    def disk_read_gate(self, data: bytes) -> bytes:
        """Consulted on store reads (journal scan, checkpoint load):
        returns a short read or a bit-flipped buffer — recovery must
        treat both as a torn tail / invalid checkpoint, never accept
        them."""
        with self._lock:
            rnd = self._stream(("disk", "r"))
            prof = self.profile
            if data and rnd.random() < prof.disk_short_read:
                self.injected += 1
                return data[:rnd.randrange(len(data))]
            if data and rnd.random() < prof.disk_flip:
                self.injected += 1
                i = rnd.randrange(len(data))
                return (data[:i]
                        + bytes([data[i] ^ (1 << rnd.randrange(8))])
                        + data[i + 1:])
            return data


class SpamDriver:
    """Synthetic spam load for the fee-market soak: round-robins
    `flood_accounts` dev-seeded signers ("spam-0"…) through the node's
    OWN intake at ~`flood_rate` submissions/s, all at `flood_tip` —
    underpriced traffic that must lose the fee auction without starving
    paying users.  Only accounts present in the chain spec participate
    (the soak spec endows them with a few affordable fees each; dev and
    local specs have none, so `--chaos-profile flood` degrades to its
    network faults there).  Submissions are locally signed, so the
    pairing skip (`_verified=True`) is sound and the driver doesn't
    monopolize the host's BLS budget."""

    def __init__(self, service, profile: ChaosProfile, seed: int = 0):
        from .chain_spec import dev_sk

        self.service = service
        self.profile = profile
        self.rnd = random.Random(int.from_bytes(hashlib.blake2b(
            b"chaos-flood/%d" % int(seed), digest_size=8
        ).digest(), "big"))
        self.accounts = []
        if service.spec.dev_seed:
            for i in range(profile.flood_accounts):
                name = f"spam-{i}"
                if name in service.keys:
                    self.accounts.append(
                        (name, dev_sk(name, service.spec.chain_id)))
        self.nonces = {name: 0 for name, _ in self.accounts}
        self.submitted = 0
        self.rejected = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="spam-driver", daemon=True)

    def start(self) -> "SpamDriver":
        if self.accounts and self.profile.flood_rate > 0:
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        from .service import Extrinsic

        svc = self.service
        interval = 1.0 / self.profile.flood_rate
        i = 0
        while not self._stop.wait(interval * self.rnd.uniform(0.5, 1.5)):
            name, sk = self.accounts[i % len(self.accounts)]
            i += 1
            nonce = max(self.nonces[name], svc.nonces.get(name, 0))
            ext = Extrinsic(
                signer=name, module="oss", call="authorize",
                args=[self.accounts[i % len(self.accounts)][0]],
                nonce=nonce, tip=self.profile.flood_tip,
            ).sign(sk, svc.genesis)
            try:
                # gossip=False: the driver stress-tests THIS node's
                # admission plane; re-broadcasting would only benchmark
                # the fleet's signature-pairing throughput.  Peers still
                # see every included spam via authored blocks (batch
                # verification) and so stay in fee lockstep.
                svc.submit_extrinsic(ext, gossip=False, _verified=True)
                self.nonces[name] = nonce + 1
                self.submitted += 1
            except ValueError:
                # pool backpressure / broke account / stale nonce — all
                # expected spam fates; re-sync and keep flooding
                self.rejected += 1
                self.nonces[name] = svc.rt.state.nonces.get(name, 0)


def crash_schedule(
    seed: int, n_nodes: int, first_block: int = 6, span: int = 12
) -> list[tuple[int, int]]:
    """Deterministic crash-restart plan: ONE (node_index, at_block)
    pair drawn from the seed — node 0 is never chosen so the harness's
    primary RPC target stays up.  Harnesses kill the named node when
    its head passes at_block and relaunch it; same seed, same plan."""
    rnd = random.Random(int.from_bytes(hashlib.blake2b(
        b"chaos-crash/%d" % int(seed), digest_size=8
    ).digest(), "big"))
    if n_nodes < 2:
        return []
    victim = rnd.randrange(1, n_nodes)
    at_block = first_block + rnd.randrange(max(1, span))
    return [(victim, at_block)]
