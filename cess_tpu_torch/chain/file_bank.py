"""File metadata & lifecycle: deals, fragments→miners, buckets, restoral.

Re-design of the reference file-bank pallet (reference:
c-pallets/file-bank/src/{lib,functions,types,constants}.rs).  The protocol
flow preserved end to end:

  upload_declaration → generate_deal (random miner assignment, space locks,
  scheduled retry) → transfer_report (all assigned miners reported; file
  materialises in state Calculate; idle→service accounting) → calculate_end
  (miner lock→service; file Active)

plus the failure machinery: deal reassignment (≤5 attempts then refund),
filler (idle-space) accounting, restoral-order market for lost fragments,
and the miner exit / forced-exit path with its cooling-off ledger.

Geometry: files arrive pre-erasure-coded as segments of FRAGMENT_COUNT=3
fragments (2 data + 1 parity ⇒ the 1.5× `cal_file_size` factor, reference:
lib.rs:468, runtime/src/lib.rs:1024-1025); the RS math itself lives in
cess_tpu_torch.ops.rs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.hashing import Hash64
from ..utils.rng import ProtocolRng
from .state import ChainState
from .types import (
    AccountId,
    BlockNumber,
    DispatchError,
    FRAGMENT_COUNT,
    FRAGMENT_SIZE,
    SEGMENT_SIZE,
    T_BYTE,
    ensure,
)

MOD = "file_bank"

# reference: c-pallets/file-bank/src/constants.rs:1-4
TRANSFER_RATE = 8_947_849       # bytes a miner is assumed to move per block
CALCULATE_RATE = 67_108_864     # bytes a TEE is assumed to tag per block

# reference: runtime/src/lib.rs:1024-1053
SEGMENT_COUNT_LIMIT = 1000
NAME_MIN_LENGTH = 3
NAME_STR_LIMIT = 63
UPLOAD_FILLER_LIMIT = 10
RESTORAL_ORDER_LIFE = 250
OWNER_LIMIT = 50_000

FILLER_SIZE = FRAGMENT_SIZE  # each idle filler is 8 MiB (lib.rs:830-836)

# FileState (reference: file-bank/src/types.rs FileState)
FILE_ACTIVE = "Active"
FILE_CALCULATE = "Calculate"
FILE_MISSING = "Missing"
FILE_RECOVERY = "Recovery"


# ---------------------------------------------------------------- types


@dataclass
class SegmentList:
    """Declared segment: its hash + FRAGMENT_COUNT fragment hashes
    (reference: types.rs SegmentList)."""

    hash: Hash64
    fragment_list: list[Hash64]


@dataclass
class MinerTaskList:
    miner: AccountId
    fragment_list: list[Hash64] = field(default_factory=list)


@dataclass
class UserBrief:
    user: AccountId
    file_name: str
    bucket_name: str


@dataclass
class DealInfo:
    stage: int
    count: int
    file_size: int
    segment_list: list[SegmentList]
    needed_list: list[SegmentList]
    user: UserBrief
    assigned_miner: list[MinerTaskList]
    share_info: list["SegmentInfo"] = field(default_factory=list)
    complete_list: list[AccountId] = field(default_factory=list)


@dataclass
class FragmentInfo:
    hash: Hash64
    avail: bool
    miner: AccountId


@dataclass
class SegmentInfo:
    hash: Hash64
    fragment_list: list[FragmentInfo] = field(default_factory=list)


@dataclass
class FileInfo:
    segment_list: list[SegmentInfo]
    owner: list[UserBrief]
    file_size: int
    completion: BlockNumber
    stat: str


@dataclass
class FillerInfo:
    block_num: int
    miner_address: AccountId
    filler_hash: Hash64


@dataclass
class UserFileSliceInfo:
    file_hash: Hash64
    file_size: int


@dataclass
class BucketInfo:
    object_list: list[Hash64] = field(default_factory=list)
    authority: list[AccountId] = field(default_factory=list)


@dataclass
class RestoralTargetInfo:
    miner: AccountId
    service_space: int
    restored_space: int
    cooling_block: BlockNumber


@dataclass
class RestoralOrderInfo:
    count: int
    miner: AccountId
    origin_miner: AccountId
    fragment_hash: Hash64
    file_hash: Hash64
    gen_block: BlockNumber
    deadline: BlockNumber


# ---------------------------------------------------------------- pallet


class FileBankPallet:
    """Deal/file/restoral state machine.

    Collaborators (injected, mirroring the reference Config bindings at
    runtime/src/lib.rs:1056-1100): sminer (MinerControl), storage_handler
    (StorageHandle), tee_worker (ScheduleFind), oss (OssFindAuthor).
    """

    def __init__(
        self,
        state: ChainState,
        sminer,
        storage_handler,
        tee_worker=None,
        oss=None,
        one_day_block: int = 14400,
    ) -> None:
        self.state = state
        self.sminer = sminer
        self.storage_handler = storage_handler
        self.tee_worker = tee_worker
        self.oss = oss
        self.one_day_block = one_day_block

        self.deal_map: dict[Hash64, DealInfo] = {}
        self.file: dict[Hash64, FileInfo] = {}
        self.bucket: dict[tuple[AccountId, str], BucketInfo] = {}
        self.user_bucket_list: dict[AccountId, list[str]] = {}
        self.user_hold_file_list: dict[AccountId, list[UserFileSliceInfo]] = {}
        self.filler_map: dict[tuple[AccountId, Hash64], FillerInfo] = {}
        self.pending_replacements: dict[AccountId, int] = {}
        self.restoral_order: dict[Hash64, RestoralOrderInfo] = {}
        self.restoral_target: dict[AccountId, RestoralTargetInfo] = {}
        self.miner_lock: dict[AccountId, BlockNumber] = {}
        self.clear_user_list: list[AccountId] = []

    # ------------------------------------------------------------ hooks

    def on_initialize(self, now: BlockNumber) -> None:
        """Daily lease-expiry sweep, then incremental dead-user cleanup at
        ≤300 files per block (reference: lib.rs:363-433)."""
        if now % self.one_day_block == 0:
            self.clear_user_list = self.storage_handler.frozen_task()
        count = 0
        for acc in list(self.clear_user_list):
            file_list = self.user_hold_file_list.get(acc, [])
            while file_list:
                count += 1
                if count == 300:
                    return
                info = file_list.pop()
                f = self.file.get(info.file_hash)
                if f is None:
                    continue
                try:
                    if len(f.owner) > 1:
                        self.remove_file_owner(info.file_hash, acc, user_clear=False)
                    else:
                        self.remove_file_last_owner(
                            info.file_hash, acc, user_clear=False
                        )
                except DispatchError:
                    pass
            try:
                self.storage_handler.delete_user_space_storage(acc)
            except DispatchError:
                pass
            self.clear_user_list = [a for a in self.clear_user_list if a != acc]
            self.user_hold_file_list.pop(acc, None)
            for key in [k for k in self.bucket if k[0] == acc]:
                del self.bucket[key]
            self.user_bucket_list.pop(acc, None)

    # ------------------------------------------------------------ helpers

    @staticmethod
    def cal_file_size(segments: int) -> int:
        """segments × 24 MiB — the 1.5× redundancy bill (reference:
        functions.rs:299-301)."""
        return segments * (SEGMENT_SIZE * 15 // 10)

    def check_permission(self, operator: AccountId, owner: AccountId) -> bool:
        """Owner or OSS-authorized operator (reference: functions.rs:513-518)."""
        if operator == owner:
            return True
        return self.oss is not None and self.oss.is_authorized(owner, operator)

    @staticmethod
    def check_file_spec(deal_info: list[SegmentList]) -> bool:
        return all(len(s.fragment_list) == FRAGMENT_COUNT for s in deal_info)

    def check_is_file_owner(self, acc: AccountId, file_hash: Hash64) -> bool:
        f = self.file.get(file_hash)
        return f is not None and any(b.user == acc for b in f.owner)

    def generate_random_number(self, seed: int) -> int:
        """Nonzero u32 from (shared randomness, seed) — same retry-while-zero
        shape as the reference (reference: functions.rs:424-443)."""
        counter = 0
        while True:
            rng = ProtocolRng(
                self.state.randomness + b"filbak", domain=seed + counter
            )
            v = rng.u32()
            if v != 0:
                return v
            counter += 1

    # ------------------------------------------------------------ buckets

    @staticmethod
    def check_bucket_name_spec(name: str) -> bool:
        """[a-z0-9.-], no leading/trailing dot, no '..' (reference:
        functions.rs check_bucket_name_spec)."""
        if not 3 <= len(name) <= NAME_STR_LIMIT:
            return False
        allowed = set("abcdefghijklmnopqrstuvwxyz0123456789.-")
        if any(c not in allowed for c in name):
            return False
        if name[0] == "." or name[-1] == "." or ".." in name:
            return False
        return True

    def create_bucket_helper(
        self, user: AccountId, bucket_name: str, file_hash: Hash64 | None
    ) -> None:
        """reference: functions.rs:93-123"""
        ensure(len(bucket_name) >= 3, MOD, "LessMinLength")
        ensure((user, bucket_name) not in self.bucket, MOD, "Existed")
        ensure(self.check_bucket_name_spec(bucket_name), MOD, "SpecError")
        bucket = BucketInfo(authority=[user])
        if file_hash is not None:
            bucket.object_list.append(file_hash)
        self.bucket[(user, bucket_name)] = bucket
        self.user_bucket_list.setdefault(user, []).append(bucket_name)

    def add_file_to_bucket(
        self, user: AccountId, bucket_name: str, file_hash: Hash64
    ) -> None:
        bucket = self.bucket.get((user, bucket_name))
        ensure(bucket is not None, MOD, "NonExistent")
        bucket.object_list.append(file_hash)

    def create_bucket(
        self, sender: AccountId, owner: AccountId, name: str
    ) -> None:
        ensure(self.check_permission(sender, owner), MOD, "NoPermission")
        self.create_bucket_helper(owner, name, None)
        self.state.deposit_event(
            MOD, "CreateBucket", operator=sender, owner=owner, bucket_name=name
        )

    def delete_bucket(
        self, sender: AccountId, owner: AccountId, name: str
    ) -> None:
        """reference: lib.rs:873-921 — deletes the bucket and every contained
        file the owner holds."""
        ensure(self.check_permission(sender, owner), MOD, "NoPermission")
        bucket = self.bucket.get((owner, name))
        ensure(bucket is not None, MOD, "NonExistent")
        for file_hash in list(bucket.object_list):
            f = self.file.get(file_hash)
            ensure(f is not None, MOD, "Unexpected")
            if len(f.owner) > 1:
                self.remove_file_owner(file_hash, owner, user_clear=True)
            else:
                self.remove_file_last_owner(file_hash, owner, user_clear=True)
            self.remove_user_hold_file_list(file_hash, owner)
        del self.bucket[(owner, name)]
        self.user_bucket_list[owner] = [
            n for n in self.user_bucket_list.get(owner, []) if n != name
        ]
        self.state.deposit_event(
            MOD, "DeleteBucket", operator=sender, owner=owner, bucket_name=name
        )

    # ------------------------------------------------------------ upload

    def upload_declaration(
        self,
        sender: AccountId,
        file_hash: Hash64,
        deal_info: list[SegmentList],
        user_brief: UserBrief,
        file_size: int,
    ) -> None:
        """reference: lib.rs:447-496"""
        ensure(self.check_permission(sender, user_brief.user), MOD, "NoPermission")
        ensure(self.check_file_spec(deal_info), MOD, "SpecError")
        ensure(len(deal_info) <= SEGMENT_COUNT_LIMIT, MOD, "SpecError")
        ensure(len(user_brief.file_name) >= NAME_MIN_LENGTH, MOD, "SpecError")
        ensure(len(user_brief.bucket_name) >= NAME_MIN_LENGTH, MOD, "SpecError")
        # Validate the bucket name up front: transfer_report creates the
        # bucket *after* irreversible space accounting, so a name that would
        # fail create_bucket_helper must be rejected at declaration time.
        ensure(
            (user_brief.user, user_brief.bucket_name) in self.bucket
            or self.check_bucket_name_spec(user_brief.bucket_name),
            MOD,
            "SpecError",
        )

        needed_space = self.cal_file_size(len(deal_info))
        ensure(
            self.storage_handler.get_user_avail_space(user_brief.user)
            > needed_space,
            MOD,
            "InsufficientAvailableSpace",
        )

        if file_hash in self.file:
            # Dedup: the network already stores the data; the new owner just
            # pays space and joins the owner list (lib.rs:471-486).
            self.storage_handler.update_user_space(user_brief.user, 1, needed_space)
            if (user_brief.user, user_brief.bucket_name) in self.bucket:
                self.add_file_to_bucket(
                    user_brief.user, user_brief.bucket_name, file_hash
                )
            else:
                self.create_bucket_helper(
                    user_brief.user, user_brief.bucket_name, file_hash
                )
            self.add_user_hold_fileslice(user_brief.user, file_hash, needed_space)
            self.file[file_hash].owner.append(user_brief)
        else:
            self.storage_handler.lock_user_space(user_brief.user, needed_space)
            self.generate_deal(file_hash, deal_info, user_brief, file_size)

        self.state.deposit_event(
            MOD,
            "UploadDeclaration",
            operator=sender,
            owner=user_brief.user,
            deal_hash=file_hash,
        )

    def generate_deal(
        self,
        file_hash: Hash64,
        file_info: list[SegmentList],
        user_brief: UserBrief,
        file_size: int,
    ) -> None:
        """reference: functions.rs:134-163"""
        miner_task_list = self.random_assign_miner(file_info)
        space = self.cal_file_size(len(file_info))
        life = space // TRANSFER_RATE + 1
        self.start_first_task(str(file_hash), file_hash, 1, life)
        self.deal_map[file_hash] = DealInfo(
            stage=1,
            count=0,
            file_size=file_size,
            segment_list=list(file_info),
            needed_list=list(file_info),
            user=user_brief,
            assigned_miner=miner_task_list,
        )

    def start_first_task(
        self, task_id: str, deal_hash: Hash64, count: int, life: int
    ) -> None:
        """Schedule deal_reassign_miner at now + 50·count + life
        (reference: functions.rs:165-181)."""
        at = self.state.block_number + 50 * count + life
        self.state.agenda.schedule_named(
            task_id, at, MOD, "deal_reassign_miner", deal_hash, count, life
        )

    def start_second_task(self, task_id: str, deal_hash: Hash64, life: int) -> None:
        at = self.state.block_number + life
        self.state.agenda.schedule_named(
            task_id, at, MOD, "calculate_end", deal_hash
        )

    def random_assign_miner(
        self, needed_list: list[SegmentList]
    ) -> list[MinerTaskList]:
        """Sample positive miners with enough idle space, then round-robin
        fragments across them and lock the space.  The rejection-loop
        structure follows the reference exactly for deterministic replay
        (reference: functions.rs:201-297)."""
        miner_task_list: list[MinerTaskList] = []
        miner_idle_space_list: list[int] = []
        miner_count = SEGMENT_SIZE * 15 // 10 // FRAGMENT_SIZE  # = 3
        seed = self.state.block_number

        all_miner = self.sminer.get_all_miner()
        total = len(all_miner)
        max_count = miner_count * 5
        cur_count = 0
        total_idle_space = 0

        while True:
            if total == 0:
                break
            index = self.generate_random_number(seed) % total
            seed += 1
            if cur_count == max_count:
                break
            cur_count += 1
            miner = all_miner.pop(index)
            total -= 1
            if not self.sminer.is_positive(miner):
                continue
            cur_space = self.sminer.get_miner_idle_space(miner)
            if cur_space > len(needed_list) * FRAGMENT_SIZE:
                total_idle_space += cur_space
                miner_task_list.append(MinerTaskList(miner=miner))
                miner_idle_space_list.append(cur_space)
            if len(miner_task_list) == miner_count:
                break

        ensure(len(miner_task_list) != 0, MOD, "BugInvalid")
        ensure(
            total_idle_space > SEGMENT_SIZE * 15 // 10, MOD, "NodesInsufficient"
        )

        for segment_list in needed_list:
            index = 0
            for frag_hash in segment_list.fragment_list:
                while True:
                    temp_index = index % len(miner_task_list)
                    cur_space = miner_idle_space_list[temp_index]
                    if cur_space > (
                        len(miner_task_list[temp_index].fragment_list) + 1
                    ) * FRAGMENT_SIZE:
                        miner_task_list[temp_index].fragment_list.append(frag_hash)
                        break
                    index += 1
                index += 1

        for miner_task in miner_task_list:
            self.sminer.lock_space(
                miner_task.miner, len(miner_task.fragment_list) * FRAGMENT_SIZE
            )
        return miner_task_list

    def deal_reassign_miner(
        self, deal_hash: Hash64, count: int, life: int
    ) -> None:
        """Root/scheduler call: retry assignment ≤5 times, then refund
        (reference: lib.rs:498-538)."""
        deal_info = self.deal_map.get(deal_hash)
        ensure(deal_info is not None, MOD, "NonExistent")
        if count < 5:
            for miner_task in deal_info.assigned_miner:
                self.sminer.unlock_space(
                    miner_task.miner,
                    FRAGMENT_SIZE * len(miner_task.fragment_list),
                )
            deal_info.assigned_miner = []
            try:
                new_assignment = self.random_assign_miner(
                    deal_info.needed_list
                )
            except DispatchError:
                # The reference executes this under #[transactional], so a
                # failed re-assignment rolls back and the deal waits for the
                # next scheduled retry; here the scheduler dispatch would
                # swallow the error and leak the user's locked space, so
                # terminate the deal through the refund path instead.
                self._refund_deal(deal_hash, deal_info)
                return
            deal_info.assigned_miner = new_assignment
            deal_info.complete_list = []
            deal_info.count = count
            self.start_first_task(str(deal_hash), deal_hash, count + 1, life)
        else:
            self._refund_deal(deal_hash, deal_info)

    def _refund_deal(self, deal_hash: Hash64, deal_info) -> None:
        """Abandon a deal: release the user's and miners' locked space and
        drop it (reference: lib.rs:520-536)."""
        needed_space = self.cal_file_size(len(deal_info.segment_list))
        self.storage_handler.unlock_user_space(
            deal_info.user.user, needed_space
        )
        for miner_task in deal_info.assigned_miner:
            self.sminer.unlock_space(
                miner_task.miner,
                FRAGMENT_SIZE * len(miner_task.fragment_list),
            )
        del self.deal_map[deal_hash]

    # ------------------------------------------------------------ storage

    def transfer_report(self, sender: AccountId, deal_hashes: list[Hash64]) -> None:
        """Assigned miner reports its fragments stored; the last report
        completes stage 2 (reference: lib.rs:618-709)."""
        ensure(len(deal_hashes) < 5, MOD, "LengthExceedsLimit")
        failed_list: list[Hash64] = []
        for deal_hash in deal_hashes:
            deal_info = self.deal_map.get(deal_hash)
            if deal_info is None:
                failed_list.append(deal_hash)
                continue
            task_miners = [mt.miner for mt in deal_info.assigned_miner]
            if sender not in task_miners:
                failed_list.append(deal_hash)
                continue
            if sender not in deal_info.complete_list:
                deal_info.complete_list.append(sender)
            if len(deal_info.complete_list) == len(deal_info.assigned_miner):
                deal_info.stage = 2
                self.generate_file(
                    deal_hash,
                    deal_info.segment_list,
                    deal_info.assigned_miner,
                    deal_info.share_info,
                    deal_info.user,
                    FILE_CALCULATE,
                    deal_info.file_size,
                )
                max_task_count = 0
                for miner_task in deal_info.assigned_miner:
                    count = len(miner_task.fragment_list)
                    max_task_count = max(max_task_count, count)
                    # Fragments displace fillers; until the miner reports the
                    # swap, the debt is tracked (lib.rs:666-671).
                    self.pending_replacements[miner_task.miner] = (
                        self.pending_replacements.get(miner_task.miner, 0) + count
                    )
                needed_space = self.cal_file_size(len(deal_info.segment_list))
                self.storage_handler.unlock_and_used_user_space(
                    deal_info.user.user, needed_space
                )
                self.storage_handler.sub_total_idle_space(needed_space)
                self.storage_handler.add_total_service_space(needed_space)
                self.state.agenda.cancel_named(str(deal_hash))
                max_needed_cal_space = max_task_count * FRAGMENT_SIZE
                life = max_needed_cal_space // TRANSFER_RATE + 1
                life += max_needed_cal_space // CALCULATE_RATE + 1
                self.start_second_task(str(deal_hash), deal_hash, life)
                user = deal_info.user
                if (user.user, user.bucket_name) in self.bucket:
                    self.add_file_to_bucket(user.user, user.bucket_name, deal_hash)
                else:
                    self.create_bucket_helper(
                        user.user, user.bucket_name, deal_hash
                    )
                self.add_user_hold_fileslice(user.user, deal_hash, needed_space)
                self.state.deposit_event(
                    MOD, "StorageCompleted", file_hash=deal_hash
                )
        self.state.deposit_event(
            MOD, "TransferReport", acc=sender, failed_list=tuple(failed_list)
        )

    def generate_file(
        self,
        file_hash: Hash64,
        deal_info: list[SegmentList],
        miner_task_list: list[MinerTaskList],
        share_info: list[SegmentInfo],
        user_brief: UserBrief,
        stat: str,
        file_size: int,
    ) -> None:
        """Materialise fragment→miner metadata (reference:
        functions.rs:16-90): fragments are matched to the assigning miner's
        sorted task list; when the miner pool is at the optimal count each
        segment spreads across distinct miners."""
        # Work on copies — the deal keeps its assignment for calculate_end.
        tasks = [
            MinerTaskList(mt.miner, sorted(mt.fragment_list))
            for mt in miner_task_list
        ]
        segment_info_list: list[SegmentInfo] = []
        for segment in deal_info:
            segment_info = SegmentInfo(hash=segment.hash)
            mark_miner: list[AccountId] = []
            shared = next(
                (s for s in share_info if s.hash == segment.hash), None
            )
            if shared is not None:
                segment_info.fragment_list = list(shared.fragment_list)
            else:
                best_count = SEGMENT_SIZE * 15 // 10 // FRAGMENT_SIZE
                flag = best_count == len(tasks)
                for frag_hash in segment.fragment_list:
                    for miner_task in tasks:
                        if flag and miner_task.miner in mark_miner:
                            continue
                        if frag_hash in miner_task.fragment_list:
                            segment_info.fragment_list.append(
                                FragmentInfo(
                                    hash=frag_hash,
                                    avail=True,
                                    miner=miner_task.miner,
                                )
                            )
                            miner_task.fragment_list.remove(frag_hash)
                            mark_miner.append(miner_task.miner)
                            break
            segment_info_list.append(segment_info)

        self.file[file_hash] = FileInfo(
            segment_list=segment_info_list,
            owner=[user_brief],
            file_size=file_size,
            completion=self.state.block_number,
            stat=stat,
        )

    def calculate_end(self, deal_hash: Hash64) -> None:
        """Root/scheduler call (reference: lib.rs:711-738)."""
        deal_info = self.deal_map.get(deal_hash)
        ensure(deal_info is not None, MOD, "NonExistent")
        for miner_task in deal_info.assigned_miner:
            count = len(miner_task.fragment_list)
            self.sminer.unlock_space_to_service(
                miner_task.miner, FRAGMENT_SIZE * count
            )
        f = self.file.get(deal_hash)
        ensure(f is not None, MOD, "BugInvalid")
        f.stat = FILE_ACTIVE
        del self.deal_map[deal_hash]
        self.state.deposit_event(MOD, "CalculateEnd", file_hash=deal_hash)

    # ------------------------------------------------------------ fillers

    def upload_filler(
        self, sender: AccountId, tee_worker: AccountId, filler_list: list[FillerInfo]
    ) -> None:
        """Miner idle-space proof fillers, 8 MiB each (reference:
        lib.rs:804-842)."""
        ensure(len(filler_list) <= UPLOAD_FILLER_LIMIT, MOD, "LengthExceedsLimit")
        if self.tee_worker is not None:
            ensure(
                self.tee_worker.contains_scheduler(tee_worker),
                MOD,
                "ScheduleNonExistent",
            )
        ensure(self.sminer.is_positive(sender), MOD, "NotQualified")
        for filler in filler_list:
            ensure(
                (sender, filler.filler_hash) not in self.filler_map,
                MOD,
                "FileExistent",
            )
        for filler in filler_list:
            self.filler_map[(sender, filler.filler_hash)] = filler
        idle_space = FILLER_SIZE * len(filler_list)
        self.sminer.add_miner_idle_space(sender, idle_space)
        self.storage_handler.add_total_idle_space(idle_space)
        self.state.deposit_event(
            MOD, "FillerUpload", acc=sender, file_size=idle_space
        )

    def delete_filler(self, sender: AccountId, filler_hash: Hash64) -> None:
        """reference: lib.rs:848-874"""
        ensure(self.sminer.is_positive(sender), MOD, "NotQualified")
        ensure((sender, filler_hash) in self.filler_map, MOD, "NonExistent")
        self.sminer.sub_miner_idle_space(sender, FILLER_SIZE)
        self.storage_handler.sub_total_idle_space(FILLER_SIZE)
        del self.filler_map[(sender, filler_hash)]
        self.state.deposit_event(
            MOD, "FillerDelete", acc=sender, filler_hash=filler_hash
        )

    def replace_file_report(self, sender: AccountId, filler: list[Hash64]) -> None:
        """Miner burns fillers displaced by service fragments (reference:
        lib.rs:740-772)."""
        ensure(len(filler) <= 30, MOD, "LengthExceedsLimit")
        pending = self.pending_replacements.get(sender, 0)
        ensure(len(filler) <= pending, MOD, "LengthExceedsLimit")
        count = 0
        for filler_hash in filler:
            if (sender, filler_hash) in self.filler_map:
                count += 1
                del self.filler_map[(sender, filler_hash)]
        self.pending_replacements[sender] = pending - count
        self.state.deposit_event(
            MOD, "ReplaceFiller", acc=sender, filler_list=tuple(filler)
        )

    def clear_filler(self, miner: AccountId) -> None:
        for key in [k for k in self.filler_map if k[0] == miner]:
            del self.filler_map[key]

    # ------------------------------------------------------------ deletion

    def add_user_hold_fileslice(
        self, user: AccountId, file_hash: Hash64, file_size: int
    ) -> None:
        self.user_hold_file_list.setdefault(user, []).append(
            UserFileSliceInfo(file_hash=file_hash, file_size=file_size)
        )

    def remove_user_hold_file_list(self, file_hash: Hash64, acc: AccountId) -> None:
        if acc in self.user_hold_file_list:
            self.user_hold_file_list[acc] = [
                s for s in self.user_hold_file_list[acc] if s.file_hash != file_hash
            ]

    def remove_file_owner(
        self, file_hash: Hash64, acc: AccountId, user_clear: bool
    ) -> None:
        """reference: functions.rs:352-371"""
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "Overflow")
        for index, brief in enumerate(f.owner):
            if brief.user == acc:
                if user_clear:
                    self.storage_handler.update_user_space(
                        acc, 2, self.cal_file_size(len(f.segment_list))
                    )
                f.owner.pop(index)
                break

    def remove_file_last_owner(
        self, file_hash: Hash64, acc: AccountId, user_clear: bool
    ) -> None:
        """Last owner gone ⇒ fragments die: miners lose service space (or
        their restoral cooldown credits), global service counter drops, the
        file record is removed (reference: functions.rs:374-416)."""
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "NonExistent")
        total_fragment_dec = 0
        miner_counts: dict[AccountId, int] = {}
        for segment in f.segment_list:
            for fragment in segment.fragment_list:
                total_fragment_dec += 1
                miner_counts[fragment.miner] = miner_counts.get(fragment.miner, 0) + 1
        for miner, count in sorted(miner_counts.items()):
            if miner in self.restoral_target:
                self.update_restoral_target(miner, FRAGMENT_SIZE * count)
            else:
                self.sminer.sub_miner_service_space(miner, FRAGMENT_SIZE * count)
        if user_clear:
            self.storage_handler.update_user_space(
                acc, 2, total_fragment_dec * FRAGMENT_SIZE
            )
        self.storage_handler.sub_total_service_space(
            total_fragment_dec * FRAGMENT_SIZE
        )
        del self.file[file_hash]

    def delete_user_file(self, file_hash: Hash64, acc: AccountId) -> None:
        """reference: functions.rs:303-320"""
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "NonExistent")
        ensure(f.stat != FILE_CALCULATE, MOD, "Calculate")
        if any(b.user == acc for b in f.owner):
            if len(f.owner) > 1:
                self.remove_file_owner(file_hash, acc, user_clear=True)
            else:
                self.remove_file_last_owner(file_hash, acc, user_clear=True)

    def bucket_remove_file(self, file_hash: Hash64, acc: AccountId) -> None:
        f = self.file.get(file_hash)
        briefs = [] if f is None else f.owner
        for brief in briefs:
            if brief.user == acc:
                bucket = self.bucket.get((acc, brief.bucket_name))
                ensure(bucket is not None, MOD, "NonExistent")
                bucket.object_list = [
                    h for h in bucket.object_list if h != file_hash
                ]

    def delete_file(
        self, sender: AccountId, owner: AccountId, file_hash_list: list[Hash64]
    ) -> None:
        """reference: lib.rs:773-792"""
        ensure(self.check_permission(sender, owner), MOD, "NoPermission")
        ensure(len(file_hash_list) < 10, MOD, "LengthExceedsLimit")
        for file_hash in file_hash_list:
            ensure(file_hash in self.file, MOD, "NonExistent")
            # bucket_remove_file must read the owner brief before deletion.
            self.bucket_remove_file(file_hash, owner)
            self.delete_user_file(file_hash, owner)
            self.remove_user_hold_file_list(file_hash, owner)
        self.state.deposit_event(
            MOD,
            "DeleteFile",
            operator=sender,
            owner=owner,
            file_hash_list=tuple(file_hash_list),
        )

    def ownership_transfer(
        self, sender: AccountId, target_brief: UserBrief, file_hash: Hash64
    ) -> None:
        """reference: lib.rs:557-608"""
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "FileNonExistent")
        ensure(self.check_is_file_owner(sender, file_hash), MOD, "NotOwner")
        ensure(
            not self.check_is_file_owner(target_brief.user, file_hash),
            MOD,
            "IsOwned",
        )
        ensure(f.stat == FILE_ACTIVE, MOD, "Unprepared")
        ensure(
            (target_brief.user, target_brief.bucket_name) in self.bucket,
            MOD,
            "NonExistent",
        )
        file_size = self.cal_file_size(len(f.segment_list))
        self.storage_handler.update_user_space(target_brief.user, 1, file_size)
        f.owner.append(target_brief)
        self.add_file_to_bucket(
            target_brief.user, target_brief.bucket_name, file_hash
        )
        self.add_user_hold_fileslice(target_brief.user, file_hash, file_size)
        self.bucket_remove_file(file_hash, sender)
        self.delete_user_file(file_hash, sender)
        self.remove_user_hold_file_list(file_hash, sender)

    # ------------------------------------------------------------ restoral

    def generate_restoral_order(
        self, sender: AccountId, file_hash: Hash64, restoral_fragment: Hash64
    ) -> None:
        """A miner admits fragment loss and opens an order against itself
        (reference: lib.rs:936-980)."""
        ensure(restoral_fragment not in self.restoral_order, MOD, "Existed")
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "NonExistent")
        for segment in f.segment_list:
            for fragment in segment.fragment_list:
                if fragment.hash == restoral_fragment and fragment.miner == sender:
                    fragment.avail = False
                    self.restoral_order[restoral_fragment] = RestoralOrderInfo(
                        count=0,
                        miner=sender,
                        origin_miner=sender,
                        file_hash=file_hash,
                        fragment_hash=restoral_fragment,
                        gen_block=self.state.block_number,
                        deadline=0,
                    )
                    self.state.deposit_event(
                        MOD,
                        "GenerateRestoralOrder",
                        miner=sender,
                        fragment_hash=restoral_fragment,
                    )
                    return
        raise DispatchError(MOD, "SpecError")

    def claim_restoral_order(
        self, sender: AccountId, restoral_fragment: Hash64
    ) -> None:
        """Any positive miner claims an expired/unclaimed order
        (reference: lib.rs:985-1012)."""
        ensure(self.sminer.is_positive(sender), MOD, "MinerStateError")
        now = self.state.block_number
        order = self.restoral_order.get(restoral_fragment)
        ensure(order is not None, MOD, "NonExistent")
        ensure(now > order.deadline, MOD, "SpecError")
        order.count += 1
        order.deadline = now + RESTORAL_ORDER_LIFE
        order.miner = sender
        self.state.deposit_event(
            MOD, "ClaimRestoralOrder", miner=sender, order_id=restoral_fragment
        )

    def claim_restoral_noexist_order(
        self,
        sender: AccountId,
        miner: AccountId,
        file_hash: Hash64,
        restoral_fragment: Hash64,
    ) -> None:
        """Claim restoral of a fragment whose holder exited (holder must be
        in the RestoralTarget ledger; reference: lib.rs:1014-1070)."""
        ensure(self.sminer.is_positive(sender), MOD, "MinerStateError")
        ensure(restoral_fragment not in self.restoral_order, MOD, "Existed")
        ensure(miner in self.restoral_target, MOD, "NonExistent")
        f = self.file.get(file_hash)
        ensure(f is not None, MOD, "NonExistent")
        for segment in f.segment_list:
            for fragment in segment.fragment_list:
                if fragment.hash == restoral_fragment and fragment.miner == miner:
                    now = self.state.block_number
                    fragment.avail = False
                    self.restoral_order[restoral_fragment] = RestoralOrderInfo(
                        count=0,
                        miner=sender,
                        origin_miner=fragment.miner,
                        file_hash=file_hash,
                        fragment_hash=restoral_fragment,
                        gen_block=now,
                        deadline=now + RESTORAL_ORDER_LIFE,
                    )
                    self.state.deposit_event(
                        MOD,
                        "ClaimRestoralOrder",
                        miner=sender,
                        order_id=restoral_fragment,
                    )
                    return
        raise DispatchError(MOD, "SpecError")

    def restoral_order_complete(
        self, sender: AccountId, fragment_hash: Hash64
    ) -> None:
        """Claimant proves recovery before the deadline; service space moves
        from the origin miner to the claimant (reference: lib.rs:1072-1125)."""
        ensure(self.sminer.is_positive(sender), MOD, "MinerStateError")
        order = self.restoral_order.get(fragment_hash)
        ensure(order is not None, MOD, "NonExistent")
        ensure(order.miner == sender, MOD, "SpecError")
        now = self.state.block_number
        ensure(now < order.deadline, MOD, "Expired")
        f = self.file.get(order.file_hash)
        if f is None:
            del self.restoral_order[fragment_hash]
            return
        for segment in f.segment_list:
            for fragment in segment.fragment_list:
                if (
                    fragment.hash == fragment_hash
                    and fragment.miner == order.origin_miner
                ):
                    self.sminer.sub_miner_service_space(
                        fragment.miner, FRAGMENT_SIZE
                    )
                    self.sminer.add_miner_service_space(sender, FRAGMENT_SIZE)
                    if fragment.miner in self.restoral_target:
                        self.update_restoral_target(fragment.miner, FRAGMENT_SIZE)
                    fragment.avail = True
                    fragment.miner = sender
                    break
        del self.restoral_order[fragment_hash]
        self.state.deposit_event(
            MOD, "RecoveryCompleted", miner=sender, order_id=fragment_hash
        )

    def create_restoral_target(self, miner: AccountId, service_space: int) -> None:
        """Exit cooldown: (service_space // TiB + 1) days (reference:
        functions.rs:540-566)."""
        blocks = (service_space // T_BYTE + 1) * self.one_day_block
        self.restoral_target[miner] = RestoralTargetInfo(
            miner=miner,
            service_space=service_space,
            restored_space=0,
            cooling_block=self.state.block_number + blocks,
        )

    def update_restoral_target(self, miner: AccountId, space: int) -> None:
        info = self.restoral_target.get(miner)
        ensure(info is not None, MOD, "NonExistent")
        info.restored_space += space

    # ------------------------------------------------------------ miner exit

    def miner_exit_prep(self, sender: AccountId) -> None:
        """reference: lib.rs:1128-1164"""
        if sender in self.miner_lock:
            ensure(
                self.state.block_number > self.miner_lock[sender],
                MOD,
                "MinerStateError",
            )
        ensure(self.sminer.is_positive(sender), MOD, "MinerStateError")
        self.sminer.update_miner_state(sender, "lock")
        lock_time = self.state.block_number + self.one_day_block
        self.miner_lock[sender] = lock_time
        self.state.agenda.schedule_named(
            f"exit:{sender}", lock_time, MOD, "miner_exit", sender
        )
        self.state.deposit_event(MOD, "MinerExitPrep", miner=sender)

    def miner_exit(self, miner: AccountId) -> None:
        """Root/scheduler call (reference: lib.rs:1168-1190)."""
        ensure(self.sminer.is_lock(miner), MOD, "MinerStateError")
        self.clear_filler(miner)
        idle_space, service_space = self.sminer.get_power(miner)
        self.storage_handler.sub_total_idle_space(idle_space)
        self.sminer.execute_exit(miner)
        self.create_restoral_target(miner, service_space)

    def miner_withdraw(self, sender: AccountId) -> None:
        """reference: lib.rs:1192-1212"""
        info = self.restoral_target.get(sender)
        ensure(info is not None, MOD, "MinerStateError")
        now = self.state.block_number
        if now < info.cooling_block and info.restored_space != info.service_space:
            raise DispatchError(MOD, "MinerStateError")
        self.sminer.withdraw(sender)
        self.state.deposit_event(MOD, "Withdraw", acc=sender)

    # -- RandomFileList trait surface used by audit (reference:
    # file-bank/src/lib.rs:1216-1226, functions.rs:527-538) --------------

    def force_miner_exit(self, miner: AccountId) -> None:
        self.clear_filler(miner)
        idle_space, service_space = self.sminer.get_power(miner)
        self.storage_handler.sub_total_idle_space(idle_space)
        self.sminer.force_miner_exit(miner)
        self.create_restoral_target(miner, service_space)
