"""Runtime composition + deterministic block loop.

The construct_runtime! equivalent (reference: runtime/src/lib.rs:1477-1538):
wires every pallet against the shared ChainState, binds the cross-pallet
traits, and drives the per-block lifecycle —

  block N:  advance clock → refresh shared randomness (the RRSC
            parent-block-randomness stand-in) → on_initialize hooks
            (audit sweeps, file-bank lease sweep, scheduler-credit period
            roll) → dispatch due scheduler agenda calls → (extrinsics
            applied by callers) → era rotation at era boundaries

Determinism contract: given the same genesis + extrinsic sequence, every
replica computes identical state — the replicated-state-machine property the
reference gets from Substrate (SURVEY.md §2 parallelism item 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.hashing import blake2b_256
from .audit import AuditPallet
from .rrsc import RrscPallet
from .cacher import CacherPallet
from .evm import EvmPallet
from .fees import FeesPallet
from .file_bank import FileBankPallet
from .offences import OffencesPallet
from .oss import OssPallet
from .scheduler_credit import SchedulerCreditPallet
from .session import SessionPallet
from .sminer import SminerPallet
from .staking import StakingPallet
from .state import ChainState, ScheduledCall
from .storage_handler import StorageHandlerPallet
from .tee_worker import TeeWorkerPallet
from .types import BLOCKS_PER_DAY, BLOCKS_PER_HOUR, Balance, DispatchError, TOKEN


def session_plan(era_duration_blocks: int, sessions_per_era: int = 0,
                 ) -> tuple[int, int]:
    """(session_length, sessions_per_era) for an era duration: the two
    must multiply back to era_duration_blocks exactly so the session
    clock and the legacy era clock agree on every boundary.  An
    explicit sessions_per_era that divides the era cleanly wins;
    otherwise pick the most sessions ≤ 6 that keep sessions at least 4
    blocks long (heartbeats need a couple of blocks to land before the
    end-of-session sweep reads them)."""
    era = max(1, era_duration_blocks)
    if sessions_per_era > 0:
        if era % sessions_per_era != 0:
            raise ValueError(
                f"sessions_per_era={sessions_per_era} does not divide "
                f"era_duration_blocks={era} — session and era clocks "
                "would disagree on boundaries"
            )
        return era // sessions_per_era, sessions_per_era
    for k in range(6, 1, -1):
        if era % k == 0 and era // k >= 4:
            return era // k, k
    return era, 1


@dataclass
class RuntimeConfig:
    """Genesis knobs (chain-spec equivalent, reference:
    node/src/chain_spec.rs:84-318 + runtime parameter_types)."""

    one_day_block: int = BLOCKS_PER_DAY
    one_hour_block: int = BLOCKS_PER_HOUR
    frozen_days: int = 7
    space_unit_price: Balance = 30 * TOKEN      # per GiB-month
    era_duration_blocks: int = 6 * BLOCKS_PER_HOUR
    eras_per_year: int = 1460
    # Sessions per era (pallet_session; SessionsPerEra=6 in the
    # reference, runtime/src/lib.rs:245).  0 = derive from the era
    # duration (see session_plan); an explicit value must divide it.
    sessions_per_era: int = 0
    credit_period_blocks: int = BLOCKS_PER_DAY
    audit_lock_time: int = 10                   # LockTime (runtime lib.rs:994)
    podr2_chunk_count: int = 1024               # CHUNK_COUNT (common lib.rs:62)
    genesis_randomness: bytes = bytes(32)
    endowed: dict = field(default_factory=dict)  # account -> free balance
    # Genesis authority set: bonded + seated at block 0 (the chain-spec
    # session-keys/staking genesis role, node/src/chain_spec.rs:84-318),
    # so rrsc.slot_author rotates over them from the first slot.
    genesis_validators: list = field(default_factory=list)
    genesis_validator_stake: Balance = 10_000 * TOKEN
    # Genesis validator CANDIDACIES: bonded (topped up to the genesis
    # stake if needed) and registered via staking.validate, so the
    # credit-weighted election actually rotates the set at era
    # boundaries.  Distinct from genesis_validators: candidates are
    # not seated until an election elects them.
    genesis_candidates: list = field(default_factory=list)
    # Fee market (pallet-transaction-payment role, chain/fees.py):
    # fee = base_fee + weight · fee_per_weight; a block's extrinsics may
    # not exceed block_weight_limit total weight (enforced at authorship
    # AND re-checked at import).  Defaults: ~0.0015 TOKEN for the
    # cheapest call, ~0.026 TOKEN for the heaviest; the limit holds
    # ~200 median calls per block.
    base_fee: Balance = 1_000_000_000
    fee_per_weight: Balance = 10_000_000
    block_weight_limit: int = 100_000
    # Pinned attestation trust anchors (proof/ias.RootStore).  None skips
    # the attestation gate (unit-test pallets in isolation); the node sim
    # always pins a root (reference pins Intel's at
    # primitives/enclave-verify/src/lib.rs:46-93).
    ias_roots: object | None = None


class Runtime:
    def __init__(self, config: RuntimeConfig | None = None,
                 device=None) -> None:
        """`device` is where IAS registration runs its RSA modexp (the
        port's proof/ias.py): None = the card, "cpu" = the plain tensor
        path."""
        self.config = config or RuntimeConfig()
        cfg = self.config
        self.state = ChainState()
        self.state.randomness = cfg.genesis_randomness

        # Pallet graph, wired as the reference runtime binds the traits
        # (runtime/src/lib.rs:944-1122).
        self.sminer = SminerPallet(self.state, cfg.one_day_block)
        self.storage_handler = StorageHandlerPallet(
            self.state, cfg.one_day_block, cfg.frozen_days, cfg.space_unit_price
        )
        self.oss = OssPallet(self.state)
        self.cacher = CacherPallet(self.state)
        self.scheduler_credit = SchedulerCreditPallet(
            self.state, cfg.credit_period_blocks
        )
        self.staking = StakingPallet(
            self.state, self.sminer, eras_per_year=cfg.eras_per_year
        )
        cert_verifier = None
        if cfg.ias_roots is not None:
            from ..proof import ias as _ias

            cert_verifier = lambda sign, cert, report, pbk: (  # noqa: E731
                _ias.report_binds_key(report, pbk)
                and _ias.verify_attestation(
                    sign, cert, report, cfg.ias_roots, device=device
                )
            )
        self.tee_worker = TeeWorkerPallet(
            self.state, self.staking, self.scheduler_credit,
            cert_verifier=cert_verifier,
        )
        self.file_bank = FileBankPallet(
            self.state,
            self.sminer,
            self.storage_handler,
            tee_worker=self.tee_worker,
            oss=self.oss,
            one_day_block=cfg.one_day_block,
        )
        self.audit = AuditPallet(
            self.state,
            self.sminer,
            self.file_bank,
            self.tee_worker,
            one_day_block=cfg.one_day_block,
            one_hour_block=cfg.one_hour_block,
            lock_time=cfg.audit_lock_time,
            chunk_count=cfg.podr2_chunk_count,
        )
        self.rrsc = RrscPallet(self.state, self.staking, self.scheduler_credit)
        self.evm = EvmPallet(self.state)
        self.fees = FeesPallet(
            self.state, cfg.base_fee, cfg.fee_per_weight,
            cfg.block_weight_limit,
        )

        # Offences + sessions (im-online/offences/session role,
        # runtime/src/lib.rs:1484-1527): the session clock drives era
        # rotation; the offences pallet sweeps heartbeats at every
        # session end (observer) and applies convictions at era
        # boundaries, just before the election.
        self.offences = OffencesPallet(
            self.state, self.staking, self.scheduler_credit
        )
        s_len, s_per_era = session_plan(
            cfg.era_duration_blocks, cfg.sessions_per_era
        )
        self.session = SessionPallet(
            self.state, self.staking, self.rrsc,
            session_length=s_len, sessions_per_era=s_per_era,
            offences=self.offences,
        )
        self.offences.session = self.session
        self.session.add_observer(self.offences.session_sweep)

        for acc, amount in cfg.endowed.items():
            self.state.balances.mint(acc, amount)

        # Seat the genesis authorities: top up to the genesis stake if the
        # endowment doesn't cover it (genesis injection, not a transfer),
        # bond stash=controller, and seat directly (add_validator keeps
        # them in place until real candidacies elect a replacement set).
        for v in cfg.genesis_validators:
            stake = cfg.genesis_validator_stake
            free = self.state.balances.free(v)
            if free < stake:
                self.state.balances.mint(v, stake - free)
            self.staking.bond(v, v, stake)
            self.staking.add_validator(v)
        # Genesis candidacies: bonded + validate()d so the era-boundary
        # election has a real candidate pool from block 1.
        for c in cfg.genesis_candidates:
            if c not in self.staking.bonded:
                stake = cfg.genesis_validator_stake
                free = self.state.balances.free(c)
                if free < stake:
                    self.state.balances.mint(c, stake - free)
                self.staking.bond(c, c, stake)
            self.staking.validate(c)
        # Session 0's authority set enters the historical record so
        # offence evidence against a genesis authority verifies before
        # the first rotation.
        self.session.record_genesis_set()
        # Genesis authorities are also the audit quorum keys (the
        # session-keys genesis role) so a live chain's offchain workers
        # can vote challenges from block 1 without a harness call.
        if cfg.genesis_validators:
            self.audit.initialize_keys(list(cfg.genesis_validators))

        # Root-dispatchable scheduler agenda targets.
        self._dispatch = {
            ("file_bank", "deal_reassign_miner"): self.file_bank.deal_reassign_miner,
            ("file_bank", "calculate_end"): self.file_bank.calculate_end,
            ("file_bank", "miner_exit"): self.file_bank.miner_exit,
        }

    # ------------------------------------------------------------ block loop

    def _refresh_randomness(self) -> None:
        """Per-block shared randomness — stands in for RRSC
        ParentBlockRandomness (reference: runtime/src/lib.rs:1003)."""
        self.state.randomness = blake2b_256(
            b"rrsc:" + self.state.randomness
            + self.state.block_number.to_bytes(8, "little")
        )

    def next_block(self) -> None:
        self.state.block_number += 1
        now = self.state.block_number
        self._refresh_randomness()

        # on_initialize order mirrors pallet index order in
        # construct_runtime! (runtime/src/lib.rs:1529-1537).
        self.audit.on_initialize(now)
        self.file_bank.on_initialize(now)
        self.scheduler_credit.on_initialize(now)

        # pallet-scheduler agenda.
        for call in self.state.agenda.take_due(now):
            self._dispatch_scheduled(call)

        # Session rotation → offence application → era rotation → RRSC
        # epoch rotation (the session clock ticks sessions_per_era times
        # per era, so the era boundary lands on exactly the same blocks
        # as the pre-session `now % era_duration_blocks == 0` rule; the
        # credit-weighted election still runs only when candidacies
        # exist, so genesis-seeded authority sets stay put in minimal
        # sims).
        self.session.on_initialize(now)

    def _dispatch_scheduled(self, call: ScheduledCall) -> None:
        fn = self._dispatch.get((call.pallet, call.method))
        if fn is None:
            return
        try:
            fn(*call.args)
        except DispatchError:
            # A failed scheduled call is dropped, as in pallet-scheduler.
            pass

    def run_to_block(self, target: int) -> None:
        while self.state.block_number < target:
            self.next_block()

    def run_blocks(self, count: int) -> None:
        self.run_to_block(self.state.block_number + count)
