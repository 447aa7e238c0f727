"""Storage-miner registry: stake, space ledger, rewards, punishments.

Re-design of the reference sminer pallet (reference:
c-pallets/sminer/src/{lib,types,constants}.rs).  Semantics preserved exactly:

 * miner states: positive / frozen / exit / lock / offline
   (constants.rs:3-11);
 * power = 30% idle + 70% service, floor Perbill math (lib.rs:654-662);
 * collateral limit = BASE_LIMIT * (1 + power // TiB), BASE_LIMIT = 2000
   token (lib.rs:798-804, constants.rs:29);
 * reward orders: each verified audit round mints an order paying 20%
   immediately and 80% over 180 tranches, with a 180-order ring
   (lib.rs:664-722, constants.rs:19-23);
 * punishments move reserved collateral into the reward pot and re-freeze
   under-collateralised miners: idle 10%, service 25%, clear 30/60/100%
   (lib.rs:724-796, constants.rs:25-27).

One deliberate divergence: on a punishment exceeding collateral the reference
zeroes `collaterals` *before* computing `debt = punish - collaterals`
(lib.rs:745-747), recording the full punishment as debt; we record
`punish - original_collateral`, the arithmetic the surrounding code implies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .state import ChainState
from .types import (
    AccountId,
    Balance,
    BlockNumber,
    DispatchError,
    Perbill,
    TOKEN,
    T_BYTE,
    ensure,
)

MOD = "sminer"

# Miner lifecycle states (reference: sminer/src/constants.rs:3-11).
STATE_POSITIVE = "positive"
STATE_FROZEN = "frozen"
STATE_EXIT = "exit"
STATE_LOCK = "lock"
STATE_OFFLINE = "offline"

FAUCET_VALUE = 10_000_000_000_000_000  # constants.rs:13
IDLE_MUTI = Perbill.from_percent(30)  # constants.rs:15
SERVICE_MUTI = Perbill.from_percent(70)  # constants.rs:16
ISSUE_MUTI = Perbill.from_percent(20)  # constants.rs:17
EACH_SHARE_MUTI = Perbill.from_percent(80)  # constants.rs:18
RELEASE_NUMBER = 180  # constants.rs:19
IDLE_PUNI_MUTI = Perbill.from_percent(10)  # constants.rs:25
SERVICE_PUNI_MUTI = Perbill.from_percent(25)  # constants.rs:27
BASE_LIMIT = 2_000 * TOKEN  # constants.rs:29

REWARD_POT = "pot/sminer"  # PalletId("sminer ").into_account equivalent


@dataclass
class MinerInfo:
    """reference: sminer/src/types.rs:6-17"""

    beneficiary: AccountId
    peer_id: bytes
    collaterals: Balance
    debt: Balance = 0
    state: str = STATE_POSITIVE
    idle_space: int = 0
    service_space: int = 0
    lock_space: int = 0


@dataclass
class RewardOrder:
    """reference: sminer/src/types.rs (RewardOrder)"""

    order_reward: Balance
    each_share: Balance
    award_count: int = 1
    has_issued: bool = True


@dataclass
class RewardInfo:
    total_reward: Balance = 0
    reward_issued: Balance = 0
    currently_available_reward: Balance = 0
    order_list: list[RewardOrder] = field(default_factory=list)


@dataclass
class FaucetRecord:
    last_claim_time: BlockNumber = 0


class SminerPallet:
    def __init__(self, state: ChainState, one_day_block: int) -> None:
        self.state = state
        self.one_day_block = one_day_block
        self.miner_items: dict[AccountId, MinerInfo] = {}
        self.all_miner: list[AccountId] = []
        self.reward_map: dict[AccountId, RewardInfo] = {}
        self.faucet_record: dict[AccountId, FaucetRecord] = {}
        self.currency_reward: Balance = 0

    # ---------------------------------------------------------------- calls

    def regnstk(
        self,
        sender: AccountId,
        beneficiary: AccountId,
        peer_id: bytes,
        staking_val: Balance,
    ) -> None:
        """Register + stake (reference: sminer/src/lib.rs:261-307)."""
        ensure(sender not in self.miner_items, MOD, "AlreadyRegistered")
        self.state.balances.reserve(sender, staking_val)
        self.miner_items[sender] = MinerInfo(
            beneficiary=beneficiary, peer_id=peer_id, collaterals=staking_val
        )
        self.all_miner.append(sender)
        self.reward_map[sender] = RewardInfo()
        self.state.deposit_event(MOD, "Registered", acc=sender, staking_val=staking_val)

    def increase_collateral(self, sender: AccountId, collaterals: Balance) -> None:
        """Top up stake, paying off debt first; may thaw a frozen miner
        (reference: sminer/src/lib.rs:316-360)."""
        miner = self._miner(sender)
        remaining = collaterals
        if miner.debt > 0:
            if miner.debt > collaterals:
                miner.debt -= collaterals
                remaining = 0
            else:
                remaining -= miner.debt
                miner.debt = 0
        self.state.balances.reserve(sender, remaining)
        miner.collaterals += remaining
        if miner.state == STATE_FROZEN:
            limit = self.check_collateral_limit(
                self.calculate_power(miner.idle_space, miner.service_space)
            )
            if miner.collaterals >= limit:
                miner.state = STATE_POSITIVE
        self.state.deposit_event(
            MOD, "IncreaseCollateral", acc=sender, balance=miner.collaterals
        )

    def update_beneficiary(self, sender: AccountId, beneficiary: AccountId) -> None:
        self._miner(sender).beneficiary = beneficiary
        self.state.deposit_event(MOD, "UpdataBeneficiary", acc=sender, new=beneficiary)

    def update_peer_id(self, sender: AccountId, peer_id: bytes) -> None:
        miner = self._miner(sender)
        old = miner.peer_id
        miner.peer_id = peer_id
        self.state.deposit_event(MOD, "UpdataIp", acc=sender, old=old, new=peer_id)

    def receive_reward(self, sender: AccountId) -> None:
        """Claim the currently-available tranche (reference: lib.rs:409-455)."""
        if sender not in self.miner_items:
            return
        miner = self.miner_items[sender]
        ensure(miner.state == STATE_POSITIVE, MOD, "NotpositiveState")
        reward = self.reward_map[sender]
        ensure(reward.currently_available_reward != 0, MOD, "NoReward")
        self.state.balances.transfer(
            REWARD_POT, sender, reward.currently_available_reward
        )
        reward.reward_issued += reward.currently_available_reward
        self.state.deposit_event(
            MOD, "Receive", acc=sender, reward=reward.currently_available_reward
        )
        reward.currently_available_reward = 0

    def faucet_top_up(self, sender: AccountId, award: Balance) -> None:
        self.state.balances.transfer(sender, REWARD_POT, award)
        self.state.deposit_event(MOD, "FaucetTopUpMoney", acc=sender)

    def faucet(self, _sender: AccountId, to: AccountId) -> None:
        """One FAUCET_VALUE draw per account per day (reference:
        lib.rs:479-556 including the first-day edge case)."""
        now = self.state.block_number
        record = self.faucet_record.get(to)
        if record is not None:
            if now >= self.one_day_block:
                ok = record.last_claim_time <= now - self.one_day_block
            else:
                ok = record.last_claim_time <= 0
            if not ok:
                # No event on failure: a failed extrinsic must leave state —
                # including the event stream — untouched.
                raise DispatchError(MOD, "LessThan24Hours")
        self.state.balances.transfer(REWARD_POT, to, FAUCET_VALUE)
        self.faucet_record[to] = FaucetRecord(last_claim_time=now)
        self.state.deposit_event(MOD, "DrawFaucetMoney")

    # ------------------------------------------------------------ internals

    def _miner(self, acc: AccountId) -> MinerInfo:
        miner = self.miner_items.get(acc)
        ensure(miner is not None, MOD, "NotMiner", acc)
        return miner

    @staticmethod
    def calculate_power(idle_space: int, service_space: int) -> int:
        """30% idle + 70% service (reference: lib.rs:654-662)."""
        return SERVICE_MUTI.mul_floor(service_space) + IDLE_MUTI.mul_floor(idle_space)

    @staticmethod
    def check_collateral_limit(power: int) -> Balance:
        """BASE_LIMIT * (1 + power // TiB) (reference: lib.rs:798-804)."""
        return BASE_LIMIT * (1 + power // T_BYTE)

    # -- space ledger (MinerControl, reference: lib.rs:560-652,889-924) --

    def add_miner_idle_space(self, acc: AccountId, increment: int) -> None:
        self._miner(acc).idle_space += increment

    def sub_miner_idle_space(self, acc: AccountId, decrement: int) -> None:
        miner = self._miner(acc)
        if miner.state == STATE_EXIT:
            return
        ensure(miner.idle_space >= decrement, MOD, "Overflow")
        miner.idle_space -= decrement

    def add_miner_service_space(self, acc: AccountId, increment: int) -> None:
        # Silently no-op for deregistered miners (the reference tolerates a
        # missing entry here so restoral completion survives a withdrawn
        # origin miner, sminer/src/lib.rs:609-652).
        miner = self.miner_items.get(acc)
        if miner is None:
            return
        miner.service_space += increment

    def sub_miner_service_space(self, acc: AccountId, decrement: int) -> None:
        miner = self.miner_items.get(acc)
        if miner is None:
            return
        if miner.state == STATE_EXIT:
            return
        ensure(miner.service_space >= decrement, MOD, "Overflow")
        miner.service_space -= decrement

    def lock_space(self, acc: AccountId, space: int) -> None:
        miner = self._miner(acc)
        ensure(miner.idle_space >= space, MOD, "Overflow")
        miner.idle_space -= space
        miner.lock_space += space

    def unlock_space(self, acc: AccountId, space: int) -> None:
        miner = self._miner(acc)
        ensure(miner.lock_space >= space, MOD, "Overflow")
        miner.lock_space -= space
        miner.idle_space += space

    def unlock_space_to_service(self, acc: AccountId, space: int) -> None:
        miner = self._miner(acc)
        ensure(miner.lock_space >= space, MOD, "Overflow")
        miner.lock_space -= space
        miner.service_space += space

    def get_power(self, acc: AccountId) -> tuple[int, int]:
        miner = self._miner(acc)
        return miner.idle_space, miner.service_space

    def get_miner_idle_space(self, acc: AccountId) -> int:
        return self._miner(acc).idle_space

    def miner_is_exist(self, acc: AccountId) -> bool:
        return acc in self.miner_items

    def get_miner_state(self, acc: AccountId) -> str:
        return self._miner(acc).state

    def get_all_miner(self) -> list[AccountId]:
        return list(self.all_miner)

    def get_miner_count(self) -> int:
        return len(self.all_miner)

    def get_reward(self) -> Balance:
        return self.currency_reward

    def is_positive(self, acc: AccountId) -> bool:
        return self._miner(acc).state == STATE_POSITIVE

    def is_lock(self, acc: AccountId) -> bool:
        return self._miner(acc).state == STATE_LOCK

    def update_miner_state(self, acc: AccountId, new_state: str) -> None:
        ensure(
            new_state
            in (STATE_POSITIVE, STATE_FROZEN, STATE_EXIT, STATE_LOCK, STATE_OFFLINE),
            MOD,
            "Unexpected",
            new_state,
        )
        self._miner(acc).state = new_state

    # -- rewards --------------------------------------------------------

    def on_unbalanced(self, amount: Balance) -> None:
        """Era sminer-pool deposit (reference: lib.rs:875-887): mints into
        the reward pot and grows CurrencyReward."""
        self.state.balances.mint(REWARD_POT, amount)
        self.currency_reward += amount
        self.state.deposit_event(MOD, "Deposit", balance=amount)

    def calculate_miner_reward(
        self,
        miner: AccountId,
        total_reward: Balance,
        total_idle_space: int,
        total_service_space: int,
        miner_idle_space: int,
        miner_service_space: int,
    ) -> None:
        """Mint one reward order for a passed audit round
        (reference: lib.rs:664-722): proportional power share, 20% issued now,
        80% split over 180 tranches; every pre-existing unexhausted order
        releases one tranche; the order list is a 180-deep ring."""
        total_power = self.calculate_power(total_idle_space, total_service_space)
        miner_power = self.calculate_power(miner_idle_space, miner_service_space)
        prop = Perbill.from_rational(miner_power, total_power)
        this_round_reward = prop.mul_floor(total_reward)
        each_share = EACH_SHARE_MUTI.mul_floor(this_round_reward) // RELEASE_NUMBER
        issued = ISSUE_MUTI.mul_floor(this_round_reward)

        reward_info = self.reward_map.get(miner)
        ensure(reward_info is not None, MOD, "Unexpected", miner)
        ensure(self.currency_reward >= this_round_reward, MOD, "Overflow")

        for order in reward_info.order_list:
            if order.award_count == RELEASE_NUMBER:
                continue
            reward_info.currently_available_reward += order.each_share
            order.award_count += 1
        if len(reward_info.order_list) == RELEASE_NUMBER:
            reward_info.order_list.pop(0)
        reward_info.currently_available_reward += issued + each_share
        reward_info.total_reward += this_round_reward
        reward_info.order_list.append(
            RewardOrder(order_reward=this_round_reward, each_share=each_share)
        )
        self.currency_reward -= this_round_reward

    # -- punishments ----------------------------------------------------

    def deposit_punish(self, miner_acc: AccountId, punish_amount: Balance) -> None:
        """Move reserved collateral into the reward pot; freeze if the miner
        falls under its collateral limit (reference: lib.rs:724-758)."""
        miner = self._miner(miner_acc)
        if miner.collaterals > punish_amount:
            taken = punish_amount
        else:
            taken = miner.collaterals
            miner.debt += punish_amount - taken
        self.state.balances.unreserve(miner_acc, taken)
        self.state.balances.transfer(miner_acc, REWARD_POT, taken)
        self.currency_reward += taken
        miner.collaterals -= taken

        limit = self.check_collateral_limit(
            self.calculate_power(miner.idle_space, miner.service_space)
        )
        if miner.collaterals < limit:
            miner.state = STATE_FROZEN
        self.state.deposit_event(
            MOD, "Punish", acc=miner_acc, amount=punish_amount, taken=taken
        )

    def idle_punish(
        self, miner: AccountId, idle_space: int, service_space: int
    ) -> None:
        limit = self.check_collateral_limit(
            self.calculate_power(idle_space, service_space)
        )
        self.deposit_punish(miner, IDLE_PUNI_MUTI.mul_floor(limit))

    def service_punish(
        self, miner: AccountId, idle_space: int, service_space: int
    ) -> None:
        limit = self.check_collateral_limit(
            self.calculate_power(idle_space, service_space)
        )
        self.deposit_punish(miner, SERVICE_PUNI_MUTI.mul_floor(limit))

    def clear_punish(
        self, miner: AccountId, level: int, idle_space: int, service_space: int
    ) -> None:
        """Escalating no-show punishment 30%/60%/100% (reference:
        lib.rs:782-796)."""
        limit = self.check_collateral_limit(
            self.calculate_power(idle_space, service_space)
        )
        if level == 1:
            amount = Perbill.from_percent(30).mul_floor(limit)
        elif level == 2:
            amount = Perbill.from_percent(60).mul_floor(limit)
        elif level == 3:
            amount = limit
        else:
            raise DispatchError(MOD, "Unexpected", f"level={level}")
        self.deposit_punish(miner, amount)

    # -- exit -----------------------------------------------------------

    def _sweep_unissued_reward(self, acc: AccountId) -> None:
        reward_info = self.reward_map.get(acc)
        if reward_info is not None:
            self.currency_reward += (
                reward_info.total_reward - reward_info.reward_issued
            )

    def execute_exit(self, acc: AccountId) -> None:
        """reference: lib.rs:843-865 — unissued rewards return to the pool,
        the miner leaves AllMiner and parks in state 'exit'."""
        self._sweep_unissued_reward(acc)
        self.all_miner = [a for a in self.all_miner if a != acc]
        self.reward_map.pop(acc, None)
        self._miner(acc).state = STATE_EXIT

    def force_miner_exit(self, acc: AccountId) -> None:
        """reference: lib.rs:818-840 — same sweep, state 'offline'."""
        self._sweep_unissued_reward(acc)
        self.all_miner = [a for a in self.all_miner if a != acc]
        self.reward_map.pop(acc, None)
        self._miner(acc).state = STATE_OFFLINE

    def withdraw(self, acc: AccountId) -> None:
        """reference: lib.rs:866-872 — unreserve remaining collateral and
        delete the miner."""
        miner = self._miner(acc)
        self.state.balances.unreserve(acc, miner.collaterals)
        del self.miner_items[acc]
