"""PoDR2 random-challenge audit engine ("segment book").

Re-design of the reference audit pallet (reference:
c-pallets/audit/src/{lib,types,constants}.rs).  The protocol round:

 1. Validators' offchain workers each derive the *identical* challenge from
    shared randomness (~10% of miners, 47 chunk indices, 47 20-byte
    coefficients) and vote via unsigned extrinsics; a 2/3 quorum over the
    hash of the canonically-encoded challenge commits the snapshot
    (lib.rs:364-416, 846-940).
 2. Challenged miners submit σ/μ proofs before the challenge deadline; each
    proof batch is scattered to a random TEE worker (lib.rs:418-470).
 3. TEEs verify off-chain — in this framework through the ProofBackend
    (TPU-batched PoDR2) — and report two booleans; pass mints a reward order,
    double-fail punishes idle 10% / service 25% (lib.rs:472-535).
 4. Block sweeps escalate: silent miners suffer 30/60/100% clear punishment
    and forced exit at 3 strikes; late TEEs are slashed and their batch is
    reassigned to another TEE (lib.rs:559-682).

Unlike the reference (whose on-chain check is a declared TODO at
lib.rs:484), `submit_verify_result` here *does* verify the TEE result
signature against the worker's registered node key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..utils import codec
from ..utils.hashing import sha256
from ..utils.rng import ProtocolRng
from .state import ChainState
from .types import AccountId, BlockNumber, DispatchError, ensure

MOD = "audit"

# reference: audit/src/constants.rs:1-3
IDLE_FAULT_TOLERANT = 2
SERVICE_FAULT_TOLERANT = 2

# reference: runtime/src/lib.rs:986-996
CHALLENGE_MINER_MAX = 8000
VERIFY_MISSION_MAX = 500
SIGMA_MAX = 2048

CHUNK_COUNT = 1024  # reference: primitives/common/src/lib.rs:62
U64_LIMIT = (1 << 64) - 1


@dataclass
class MinerSnapShot:
    """reference: audit/src/types.rs:25-30"""

    miner: AccountId
    idle_space: int
    service_space: int

    def encode(self) -> bytes:
        return (
            codec.Writer()
            .bytes(self.miner.encode())
            .u128(self.idle_space)
            .u128(self.service_space)
            .finish()
        )


@dataclass
class NetSnapShot:
    """reference: audit/src/types.rs:14-23"""

    start: BlockNumber
    life: BlockNumber
    total_reward: int
    total_idle_space: int
    total_service_space: int
    random_index_list: list[int]
    random_list: list[bytes]  # 20-byte coefficients

    def encode(self) -> bytes:
        w = (
            codec.Writer()
            .u32(self.start)
            .u32(self.life)
            .u128(self.total_reward)
            .u128(self.total_idle_space)
            .u128(self.total_service_space)
        )
        w.compact(len(self.random_index_list))
        for i in self.random_index_list:
            w.u32(i)
        w.compact(len(self.random_list))
        for r in self.random_list:
            w.raw(r)
        return w.finish()


@dataclass
class ChallengeInfo:
    """reference: audit/src/types.rs:6-12"""

    net_snap_shot: NetSnapShot
    miner_snapshot_list: list[MinerSnapShot]

    def encode(self) -> bytes:
        """Canonical encoding — the quorum hashes this, so every validator
        must produce identical bytes (reference: lib.rs:376-378)."""
        w = codec.Writer().raw(self.net_snap_shot.encode())
        w.compact(len(self.miner_snapshot_list))
        for m in self.miner_snapshot_list:
            w.raw(m.encode())
        return w.finish()

    def proposal_hash(self) -> bytes:
        return sha256(self.encode())


@dataclass
class ProveInfo:
    """reference: audit/src/types.rs:33-41"""

    snap_shot: MinerSnapShot
    idle_prove: bytes
    service_prove: bytes


class AuditPallet:
    def __init__(
        self,
        state: ChainState,
        sminer,
        file_bank,
        tee_worker,
        one_day_block: int = 14400,
        one_hour_block: int = 600,
        lock_time: int = 10,
        result_verifier: Callable | None = None,
        chunk_count: int = CHUNK_COUNT,
    ) -> None:
        self.state = state
        self.sminer = sminer
        self.file_bank = file_bank
        self.tee_worker = tee_worker
        self.one_day_block = one_day_block
        self.one_hour_block = one_hour_block
        self.lock_time = lock_time
        # Scheme geometry: chunks per fragment (protocol value 1024,
        # reference primitives/common/src/lib.rs:62; scaled down in sims).
        self.chunk_count = chunk_count
        # verify(tee_node_key, message, signature) -> bool for
        # submit_verify_result; None disables (test mode).
        self.result_verifier = result_verifier

        self.challenge_duration: BlockNumber = 0
        self.verify_duration: BlockNumber = 0
        self.keys: list[AccountId] = []  # validator authority keys
        self.challenge_proposal: dict[bytes, tuple[int, ChallengeInfo]] = {}
        # Replay guard: the reference gets per-(session, key) uniqueness from
        # the unsigned-tx pool's `and_provides` tag (lib.rs:705); we track
        # which authorities voted which proposal explicitly.
        self.proposal_voters: dict[bytes, set[AccountId]] = {}
        self.challenge_snap_shot: ChallengeInfo | None = None
        self.unverify_proof: dict[AccountId, list[ProveInfo]] = {}
        self.counted_idle_failed: dict[AccountId, int] = {}
        self.counted_service_failed: dict[AccountId, int] = {}
        self.counted_clear: dict[AccountId, int] = {}
        # Offchain-worker local lock (per authority), reference lib.rs:782-816.
        self._ocw_lock: dict[AccountId, BlockNumber] = {}

    # ------------------------------------------------------------ randomness

    def random_number(self, seed: int) -> int:
        """u64 from (shared randomness, pallet id, seed) (reference:
        lib.rs:1019-1032)."""
        return ProtocolRng(self.state.randomness + b"rewardpt", domain=seed).u64()

    def generate_challenge_random(self, seed: int) -> bytes:
        """20-byte challenge coefficient (reference: lib.rs:1035-1048)."""
        rng = ProtocolRng(self.state.randomness + b"rewardpt:r", domain=seed + 1)
        return rng.take(20)

    # ------------------------------------------------------------ hooks

    def on_initialize(self, now: BlockNumber) -> None:
        self.clear_challenge(now)
        self.clear_verify_mission(now)

    def clear_challenge(self, now: BlockNumber) -> None:
        """Challenge deadline sweep (reference: lib.rs:559-600): every miner
        still in the snapshot is silent — escalate 30/60/100% and force exit
        at 3 strikes."""
        if now != self.challenge_duration:
            return
        snap_shot = self.challenge_snap_shot
        if snap_shot is None:
            return
        for miner_snapshot in snap_shot.miner_snapshot_list:
            count = self.counted_clear.get(miner_snapshot.miner, 0) + 1
            try:
                self.sminer.clear_punish(
                    miner_snapshot.miner,
                    count,
                    miner_snapshot.idle_space,
                    miner_snapshot.service_space,
                )
            except DispatchError:
                pass
            if count >= 3:
                try:
                    self.file_bank.force_miner_exit(miner_snapshot.miner)
                except DispatchError:
                    pass
                self.counted_clear.pop(miner_snapshot.miner, None)
            else:
                self.counted_clear[miner_snapshot.miner] = count

    def clear_verify_mission(self, now: BlockNumber) -> None:
        """Verify deadline sweep (reference: lib.rs:602-682): late TEEs are
        slashed + credit-punished, their batches reassigned to another random
        TEE; an empty round kills the snapshot."""
        if now != self.verify_duration:
            return
        seed = 0
        mission_count = 0
        tee_list = self.tee_worker.get_controller_list()
        reassign_list: dict[AccountId, list[ProveInfo]] = {}
        for acc in sorted(self.unverify_proof):
            unverify_list = self.unverify_proof[acc]
            seed += 1
            if len(unverify_list) > 0:
                try:
                    self.tee_worker.punish_scheduler(acc)
                except DispatchError:
                    pass
                mission_count += len(unverify_list)
                index = self.random_number(seed) % len(tee_list)
                tee_acc = tee_list[index]
                if acc == tee_acc:
                    index = (index + 1) % len(tee_list)
                    tee_acc = tee_list[index]
                reassign_list.setdefault(tee_acc, []).extend(unverify_list)
        for acc in list(self.unverify_proof):
            if self.unverify_proof[acc]:
                del self.unverify_proof[acc]

        if mission_count == 0:
            self.challenge_snap_shot = None
        else:
            for acc, unverify_list in sorted(reassign_list.items()):
                self.unverify_proof.setdefault(acc, []).extend(unverify_list)
            self.verify_duration = now + mission_count * 10

    # ------------------------------------------------------------ quorum

    def save_challenge_info(
        self,
        challenge_info: ChallengeInfo,
        key: AccountId,
        signature,
        signature_checker: Callable | None = None,
    ) -> None:
        """Unsigned extrinsic: one validator's challenge vote.  2/3 of the
        authority set agreeing on the hash commits the round (reference:
        lib.rs:364-416, validate_unsigned at 540-556, 684-717)."""
        # validate_unsigned equivalent
        ensure(key in self.keys, MOD, "InvalidUnsigned", "stale key")
        if signature_checker is not None:
            ensure(
                signature_checker(key, challenge_info, signature),
                MOD,
                "InvalidUnsigned",
                "bad proof",
            )

        h = challenge_info.proposal_hash()
        count = len(self.keys)
        # 2/3 supermajority, rounded UP (same threshold as the finality
        # gadget's sync.quorum — floor division would let 1 of 2 or 2 of
        # 4 authorities commit a round alone).  ceil(2n/3) is 1 for a
        # single-authority dev chain, so its own vote still commits.
        limit = max((2 * count + 2) // 3, 1)
        ensure(
            key not in self.proposal_voters.get(h, set()),
            MOD,
            "InvalidUnsigned",
            "duplicate vote",
        )
        # Stale-proposal purge, loose on purpose: under a lossy network
        # (the chaos soak, node/faults.py) validators' votes for one
        # trigger block arrive staggered across several blocks, and a
        # purge bound of `count` wiped forming tallies faster than
        # quorum could meet — the round then never commits.  4× keeps
        # state bounded while letting a staggered quorum land.
        if h not in self.challenge_proposal and len(
            self.challenge_proposal
        ) > 4 * count:
            self.challenge_proposal.clear()
            self.proposal_voters.clear()
        self.proposal_voters.setdefault(h, set()).add(key)
        votes, info = self.challenge_proposal.get(h, (0, challenge_info))
        votes += 1
        self.challenge_proposal[h] = (votes, info)
        if votes >= limit:
            now = self.state.block_number
            if now > self.challenge_duration:
                self.challenge_snap_shot = info
                duration = now + info.net_snap_shot.life
                self.challenge_duration = duration
                self.verify_duration = (
                    duration + info.net_snap_shot.life + self.one_hour_block
                )
                self.challenge_proposal.clear()
                self.proposal_voters.clear()
            self.state.deposit_event(MOD, "GenerateChallenge")

    # ------------------------------------------------------------ proofs

    def submit_proof(
        self, sender: AccountId, idle_prove: bytes, service_prove: bytes
    ) -> None:
        """Challenged miner hands in its σ proofs; batch lands on a random
        TEE (reference: lib.rs:418-470)."""
        ensure(len(idle_prove) <= SIGMA_MAX, MOD, "LengthExceedsLimit")
        ensure(len(service_prove) <= SIGMA_MAX, MOD, "LengthExceedsLimit")
        challenge = self.challenge_snap_shot
        ensure(challenge is not None, MOD, "NoChallenge")
        # Checks-first: resolve the target TEE and capacity before touching
        # the snapshot, so a failed call leaves the audit obligation intact.
        pop_index = None
        for index, snap in enumerate(challenge.miner_snapshot_list):
            if snap.miner == sender:
                now = self.state.block_number
                ensure(now < self.challenge_duration, MOD, "NoChallenge")
                pop_index = index
                break
        ensure(pop_index is not None, MOD, "NoChallenge")

        tee_list = self.tee_worker.get_controller_list()
        ensure(len(tee_list) > 0, MOD, "SystemError")
        seed = self.state.block_number
        index = self.random_number(seed) % len(tee_list)
        tee_acc = tee_list[index]
        missions = self.unverify_proof.setdefault(tee_acc, [])
        ensure(len(missions) < VERIFY_MISSION_MAX, MOD, "Overflow")

        miner_snapshot = challenge.miner_snapshot_list.pop(pop_index)
        self.counted_clear[sender] = 0
        missions.append(
            ProveInfo(
                snap_shot=miner_snapshot,
                idle_prove=bytes(idle_prove),
                service_prove=bytes(service_prove),
            )
        )
        self.state.deposit_event(MOD, "SubmitProof", miner=sender)

    @staticmethod
    def result_message(
        miner: AccountId, idle_result: bool, service_result: bool
    ) -> bytes:
        """Canonical bytes a TEE signs over its verdict."""
        return (
            codec.Writer()
            .bytes(miner.encode())
            .boolean(idle_result)
            .boolean(service_result)
            .finish()
        )

    def submit_verify_result(
        self,
        sender: AccountId,
        miner: AccountId,
        idle_result: bool,
        service_result: bool,
        tee_signature: bytes = b"",
    ) -> None:
        """TEE verdict for one miner's batch (reference: lib.rs:472-535).
        Both pass → reward order; fail twice running → idle/service punish.
        The TEE signature is checked against the registered node key (the
        seam the reference leaves as TODO at lib.rs:484)."""
        if self.result_verifier is not None:
            worker = self.tee_worker.tee_worker_map.get(sender)
            ensure(worker is not None, MOD, "NonExistentMission")
            ensure(
                self.result_verifier(
                    worker.node_key,
                    self.result_message(miner, idle_result, service_result),
                    tee_signature,
                ),
                MOD,
                "VerifyTeeSigFailed",
            )
        unverify_list = self.unverify_proof.get(sender, [])
        for index, miner_info in enumerate(unverify_list):
            if miner_info.snap_shot.miner != miner:
                continue
            snap_shot = self.challenge_snap_shot
            ensure(snap_shot is not None, MOD, "UnexpectedError")

            if idle_result and service_result:
                self.sminer.calculate_miner_reward(
                    miner,
                    snap_shot.net_snap_shot.total_reward,
                    snap_shot.net_snap_shot.total_idle_space,
                    snap_shot.net_snap_shot.total_service_space,
                    miner_info.snap_shot.idle_space,
                    miner_info.snap_shot.service_space,
                )

            if idle_result:
                self.counted_idle_failed[miner] = 0
            else:
                count = self.counted_idle_failed.get(miner, 0) + 1
                if count >= IDLE_FAULT_TOLERANT:
                    self.sminer.idle_punish(
                        miner,
                        miner_info.snap_shot.idle_space,
                        miner_info.snap_shot.service_space,
                    )
                self.counted_idle_failed[miner] = count

            if service_result:
                self.counted_service_failed[miner] = 0
            else:
                count = self.counted_service_failed.get(miner, 0) + 1
                if count >= SERVICE_FAULT_TOLERANT:
                    self.sminer.service_punish(
                        miner,
                        miner_info.snap_shot.idle_space,
                        miner_info.snap_shot.service_space,
                    )
                self.counted_service_failed[miner] = count

            unverify_list.pop(index)
            self.state.deposit_event(
                MOD, "VerifyProof", tee_worker=sender, miner=miner
            )
            return
        raise DispatchError(MOD, "NonExistentMission")

    # ------------------------------------------------------------ offchain

    def trigger_challenge(self, now: BlockNumber) -> bool:
        """≈once-a-day probability window (reference: lib.rs:739-757)."""
        time_point = self.random_number(20220509)
        probability = self.one_day_block
        window = U64_LIMIT // probability * 10
        return 2190502 < time_point < window + 2190502

    def check_working(self, now: BlockNumber, authority: AccountId) -> bool:
        """Offchain local lock (reference: lib.rs:782-816)."""
        last = self._ocw_lock.get(authority)
        if last is not None and last + self.lock_time > now:
            return False
        self._ocw_lock[authority] = now
        return True

    def unlock_offchain(self, authority: AccountId) -> None:
        self._ocw_lock.pop(authority, None)

    def offchain_worker(
        self,
        now: BlockNumber,
        authority: AccountId,
        submit: Callable | None = None,
    ):
        """One validator's OCW pass: maybe generate + vote a challenge
        (reference: lib.rs:342-359, 759-780).  Returns the ChallengeInfo it
        voted (for tests), else None.

        `submit` is the transaction-submission seam (the reference's
        SubmitTransaction::submit_unsigned_transaction): when given, the
        vote is handed to it (a live node routes it through its own tx
        pool so every replica applies it in block order) instead of being
        written into local state directly (the in-process sim path)."""
        if now <= self.verify_duration:
            return None
        if not self.trigger_challenge(now):
            return None
        if authority not in self.keys:
            return None
        if not self.check_working(now, authority):
            return None
        try:
            info = self.generation_challenge(now)
        except DispatchError:
            self.unlock_offchain(authority)
            return None
        if submit is not None:
            submit(info)
        else:
            self.save_challenge_info(info, authority, signature=None)
        self.unlock_offchain(authority)
        return info

    def generation_challenge(self, now: BlockNumber) -> ChallengeInfo:
        """Derive the round's challenge deterministically from shared
        randomness (reference: lib.rs:846-940): sample ⌈10%⌉ miners
        (skipping locked/empty ones), snapshot their spaces, then draw 47
        distinct chunk indices and 47 distinct 20-byte coefficients."""
        miner_count = self.sminer.get_miner_count()
        ensure(miner_count != 0, MOD, "GenerateInfoError")
        need_miner_count = miner_count // 10 + 1

        miner_list: list[MinerSnapShot] = []
        valid_index_list: list[int] = []
        total_idle_space = 0
        total_service_space = 0
        max_space = 0
        seed = 20230601
        while (
            len(miner_list) != need_miner_count
            and len(valid_index_list) != miner_count
        ):
            seed += 1
            index_list = self.random_select_miner(
                need_miner_count, miner_count, valid_index_list, seed
            )
            allminer = self.sminer.get_all_miner()
            for index in index_list:
                valid_index_list.append(index)
                miner = allminer[index]
                if self.sminer.get_miner_state(miner) == "lock":
                    continue
                idle_space, service_space = self.sminer.get_power(miner)
                if idle_space == 0 and service_space == 0:
                    continue
                max_space = max(max_space, idle_space + service_space)
                total_idle_space += idle_space
                total_service_space += service_space
                miner_list.append(
                    MinerSnapShot(
                        miner=miner,
                        idle_space=idle_space,
                        service_space=service_space,
                    )
                )
                if len(miner_list) > CHALLENGE_MINER_MAX:
                    raise DispatchError(MOD, "GenerateInfoError")

        # An empty snapshot would commit a round nobody can answer and
        # stall the audit until verify_duration passes — no challenge
        # without at least one challengeable (powered, unlocked) miner.
        ensure(len(miner_list) > 0, MOD, "GenerateInfoError")

        # 46/1000 density: 47 of 1024 (reference: audit/src/lib.rs:906).
        need_count = max(1, self.chunk_count * 46 // 1000)
        random_index_list: list[int] = []
        seed = 0
        while len(random_index_list) < need_count:
            seed += 1
            random_index = self.random_number(seed) % self.chunk_count
            if random_index not in random_index_list:
                random_index_list.append(random_index)

        random_list: list[bytes] = []
        seed = now
        while len(random_list) < need_count:
            seed += 1
            random_number = self.generate_challenge_random(seed)
            if random_number not in random_list:
                random_list.append(random_number)

        life = max_space // 8_947_849 + 12  # reference: lib.rs:926
        total_reward = self.sminer.get_reward()
        return ChallengeInfo(
            net_snap_shot=NetSnapShot(
                start=now,
                life=life,
                total_reward=total_reward,
                total_idle_space=total_idle_space,
                total_service_space=total_service_space,
                random_index_list=random_index_list,
                random_list=random_list,
            ),
            miner_snapshot_list=miner_list,
        )

    def random_select_miner(
        self, need: int, length: int, valid_index_list: list[int], seed: int
    ) -> list[int]:
        """reference: lib.rs:942-961 — rejection-sample distinct, unseen
        miner indices."""
        miner_index_list: list[int] = []
        seed = seed * 1000
        while len(miner_index_list) < need and (
            len(valid_index_list) + len(miner_index_list) != length
        ):
            seed += 1
            index = self.random_number(seed) % length
            if index in valid_index_list:
                continue
            if index not in miner_index_list:
                miner_index_list.append(index)
        return miner_index_list

    def initialize_keys(self, keys: list[AccountId]) -> None:
        if keys:
            assert not self.keys, "Keys are already initialized!"
            self.keys = list(keys)
