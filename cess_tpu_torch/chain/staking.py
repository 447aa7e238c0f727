"""CESS-customized staking economics: era reward pools + scheduler slashing.

The reference forks pallet-staking wholesale (c-pallets/staking, 14.7k LoC);
what CESS actually changed — and what this module re-designs — is:

 * fixed first-year reward pools split validator/sminer (238.5M / 477M
   token), decaying ×0.841 per year for 30 years, divided evenly across the
   eras of a year (reference: c-pallets/staking/src/pallet/impls.rs:432-475,
   runtime/src/lib.rs:586-589);
 * the sminer share is minted into the sminer reward pot via OnUnbalanced
   (reference: c-pallets/sminer/src/lib.rs:875-887);
 * `slash_scheduler`: a misbehaving TEE's stash loses 5% of
   MinValidatorBond (reference: c-pallets/staking/src/slashing.rs:693-706).

NPoS election, nominations and bags-list are host-framework consensus
machinery out of scope for the storage protocol; the bonded (stash →
controller) registry and validator set are kept, since tee-worker
registration and the audit quorum depend on them.
"""

from __future__ import annotations

from dataclasses import dataclass

from .state import ChainState
from .types import AccountId, Balance, Perbill, TOKEN, ensure

MOD = "staking"

TREASURY_POT = "pot/treasury"

# reference: runtime/src/lib.rs:586-589
FIRST_YEAR_VALIDATOR_REWARDS = 238_500_000 * TOKEN
FIRST_YEAR_SMINER_REWARDS = 477_000_000 * TOKEN
REWARD_DECREASE_RATIO = Perbill(841_000_000)  # from_perthousand(841)
REWARD_DECREASE_YEARS = 30


# Unbonded funds stay locked for this many eras before withdrawal (the
# stock pallet-staking BondingDuration the fork keeps).
BONDING_DURATION_ERAS = 28

# Reward/backing records older than this are pruned at era end (the
# stock HistoryDepth role): unclaimed payouts expire, state stays bounded.
HISTORY_DEPTH_ERAS = 84

# Election weight cap per candidate, as a multiple of MinValidatorBond
# (the MaxExposure role): one whale's backing cannot dominate the
# credit-weighted score beyond this.  Election-only — payouts still
# distribute over the REAL backing.
MAX_BACKING_BONDS = 256


@dataclass
class UnlockChunk:
    value: Balance
    era: int  # first era the chunk can be withdrawn in


@dataclass
class Ledger:
    stash: AccountId
    controller: AccountId
    bonded: Balance
    unlocking: list = None  # list[UnlockChunk]

    def __post_init__(self):
        if self.unlocking is None:
            self.unlocking = []


class StakingPallet:
    def __init__(
        self,
        state: ChainState,
        sminer,
        eras_per_year: int = 1460,
        min_validator_bond: Balance = 5_000 * TOKEN,
    ) -> None:
        self.state = state
        self.sminer = sminer
        self.eras_per_year = eras_per_year
        self.min_validator_bond = min_validator_bond
        self.max_candidate_backing = MAX_BACKING_BONDS * min_validator_bond
        self.bonded: dict[AccountId, AccountId] = {}  # stash -> controller
        self.ledger: dict[AccountId, Ledger] = {}  # stash -> ledger
        self.validators: list[AccountId] = []  # ACTIVE set (stash accounts)
        self.candidates: list[AccountId] = []  # validator candidacies
        self.nominations: dict[AccountId, list[AccountId]] = {}
        # stash → first era it may validate again (offences chill; the
        # election and `validate` both skip stashes still inside it)
        self.chilled_until: dict[AccountId, int] = {}
        self.active_era: int = 0
        self.eras_validator_reward: dict[int, Balance] = {}
        self.era_backing: dict[int, dict[AccountId, dict[AccountId, Balance]]] = {}
        self.payout_claimed: set[tuple[int, AccountId]] = set()

    # -- bonding ---------------------------------------------------------

    def bond(self, stash: AccountId, controller: AccountId, value: Balance) -> None:
        ensure(stash not in self.bonded, MOD, "AlreadyBonded")
        self.state.balances.reserve(stash, value)
        self.bonded[stash] = controller
        self.ledger[stash] = Ledger(stash, controller, value)
        self.state.deposit_event(MOD, "Bonded", stash=stash, amount=value)

    def bonded_controller(self, stash: AccountId) -> AccountId | None:
        return self.bonded.get(stash)

    def bond_extra(self, stash: AccountId, value: Balance) -> None:
        ledger = self.ledger.get(stash)
        ensure(ledger is not None, MOD, "NotStash")
        self.state.balances.reserve(stash, value)
        ledger.bonded += value
        self.state.deposit_event(MOD, "Bonded", stash=stash, amount=value)

    def unbond(self, stash: AccountId, value: Balance) -> None:
        """Schedule `value` for unlock BONDING_DURATION eras out (stock
        pallet-staking unbond shape the fork keeps)."""
        ledger = self.ledger.get(stash)
        ensure(ledger is not None, MOD, "NotStash")
        ensure(0 < value <= ledger.bonded, MOD, "InsufficientBond")
        ledger.bonded -= value
        ledger.unlocking.append(
            UnlockChunk(value, self.active_era + BONDING_DURATION_ERAS)
        )
        if (
            stash in self.candidates
            and ledger.bonded < self.min_validator_bond
        ):
            self.chill(stash)
        self.state.deposit_event(MOD, "Unbonded", stash=stash, amount=value)

    def withdraw_unbonded(self, stash: AccountId) -> Balance:
        """Release every chunk whose era has arrived; returns the amount.
        A fully-empty ledger is reaped (stash can re-bond afresh)."""
        ledger = self.ledger.get(stash)
        ensure(ledger is not None, MOD, "NotStash")
        due = [c for c in ledger.unlocking if c.era <= self.active_era]
        ledger.unlocking = [
            c for c in ledger.unlocking if c.era > self.active_era
        ]
        amount = sum(c.value for c in due)
        if amount:
            self.state.balances.unreserve(stash, amount)
            self.state.deposit_event(
                MOD, "Withdrawn", stash=stash, amount=amount
            )
        if ledger.bonded == 0 and not ledger.unlocking:
            del self.ledger[stash]
            del self.bonded[stash]
            self.nominations.pop(stash, None)
            if stash in self.candidates:
                self.candidates.remove(stash)
            if stash in self.validators:
                self.validators.remove(stash)
        return amount

    # -- intentions -------------------------------------------------------

    def validate(self, stash: AccountId) -> None:
        """Declare validator candidacy (stock `validate`).  A stash
        still inside an offences chill must sit the chill out before
        re-declaring."""
        ledger = self.ledger.get(stash)
        ensure(ledger is not None, MOD, "NotStash")
        ensure(
            ledger.bonded >= self.min_validator_bond, MOD, "InsufficientBond"
        )
        ensure(not self.is_chilled(stash), MOD, "Chilled")
        if stash not in self.candidates:
            self.candidates.append(stash)
            self.state.deposit_event(MOD, "ValidatorPrefsSet", stash=stash)

    def nominate(self, stash: AccountId, targets: list[AccountId]) -> None:
        ensure(stash in self.ledger, MOD, "NotStash")
        ensure(targets, MOD, "EmptyTargets")
        ensure(
            all(t in self.candidates for t in targets), MOD, "BadTarget"
        )
        self.nominations[stash] = list(dict.fromkeys(targets))
        self.state.deposit_event(
            MOD, "Nominated", stash=stash,
            targets=tuple(self.nominations[stash]),
        )

    def chill(self, stash: AccountId) -> None:
        if stash in self.candidates:
            self.candidates.remove(stash)
            self.state.deposit_event(MOD, "Chilled", stash=stash)
        self.nominations.pop(stash, None)

    def is_chilled(self, stash: AccountId) -> bool:
        return self.active_era < self.chilled_until.get(stash, 0)

    def force_chill(self, stash: AccountId, until_era: int) -> None:
        """Offences-driven chill: drop the candidacy AND refuse
        re-candidacy until `until_era` (the DisableStrategy role —
        chill() alone lets the offender `validate` right back in)."""
        self.chill(stash)
        self.chilled_until[stash] = max(
            self.chilled_until.get(stash, 0), until_era
        )
        self.state.deposit_event(
            MOD, "Chilled", stash=stash, until_era=until_era
        )

    def add_validator(self, stash: AccountId) -> None:
        """Directly seat a validator (genesis/authority injection).  Does
        NOT register candidacy: a directly-seated authority stays put
        until real candidacies exist and an election replaces the set."""
        ensure(stash in self.bonded, MOD, "NotStash")
        if stash not in self.validators:
            self.validators.append(stash)

    # -- election ---------------------------------------------------------

    def backing_of(self, stash: AccountId) -> dict[AccountId, Balance]:
        """who-backs-whom for one candidate: own bond + nominations."""
        out: dict[AccountId, Balance] = {}
        ledger = self.ledger.get(stash)
        if ledger is not None and ledger.bonded:
            out[stash] = ledger.bonded
        for nom, targets in self.nominations.items():
            if stash in targets:
                nl = self.ledger.get(nom)
                if nl is not None and nl.bonded:
                    out[nom] = out.get(nom, 0) + nl.bonded // len(targets)
        return out

    def _all_backings(self) -> dict[AccountId, dict[AccountId, Balance]]:
        """who-backs-whom for EVERY candidate in one pass: O(candidates
        + nominations) instead of backing_of's O(candidates ×
        nominations) — the part of the election that must stay cheap at
        thousands of candidates."""
        out: dict[AccountId, dict[AccountId, Balance]] = {}
        for stash in self.candidates:
            backing: dict[AccountId, Balance] = {}
            ledger = self.ledger.get(stash)
            if ledger is not None and ledger.bonded:
                backing[stash] = ledger.bonded
            out[stash] = backing
        for nom, targets in self.nominations.items():
            nl = self.ledger.get(nom)
            if nl is None or not nl.bonded:
                continue
            share = nl.bonded // len(targets)
            if not share:
                continue
            for target in targets:
                backing = out.get(target)
                if backing is not None:
                    backing[nom] = backing.get(nom, 0) + share
        return out

    def elect(
        self, max_validators: int, credits: dict[AccountId, int] | None = None,
        full_credit: int = 1000,
    ) -> list[AccountId]:
        """Credit-weighted validator selection — the RRSC/ValidatorCredits
        role (reference: the forked consensus consumes
        scheduler-credit's ValidatorCredits impl,
        c-pallets/scheduler-credit/src/lib.rs:242-251): each candidate's
        total backing — CAPPED at max_candidate_backing so one whale
        cannot own the set — is scaled by (full + credit)/full, so TEE
        service reputation tilts the election.  Deterministic: ties
        break on the account id.

        Bags-shaped (the bags-list role of the reference's election
        provider): candidates are bucketed into exponential score bags
        (bag b holds scores in [2^(b-1), 2^b), so every member of a
        higher bag outranks every member of a lower one) and only the
        bags actually needed to fill the set are sorted — placement is
        O(candidates), sorting is bounded by the consumed bags, and the
        result is bit-identical to a full global sort.  Chilled stashes
        (offences) are skipped outright."""
        credits = credits or {}
        backings = self._all_backings()
        bags: dict[int, list[tuple[int, AccountId]]] = {}
        for stash in self.candidates:
            if self.is_chilled(stash):
                continue
            ledger = self.ledger.get(stash)
            if ledger is None or ledger.bonded < self.min_validator_bond:
                continue
            backing = min(
                sum(backings[stash].values()), self.max_candidate_backing
            )
            weight = full_credit + credits.get(stash, 0)
            score = backing * weight // full_credit
            bags.setdefault(score.bit_length(), []).append((score, stash))
        elected: list[AccountId] = []
        for bag in sorted(bags, reverse=True):
            if len(elected) >= max_validators:
                break
            for score, stash in sorted(
                bags[bag], key=lambda t: (-t[0], t[1])
            ):
                elected.append(stash)
                if len(elected) >= max_validators:
                    break
        if not elected:
            # Never seat an empty authority set: a chain whose every
            # candidate is chilled or under-bonded keeps its previous
            # validators (liveness over rotation).  They still earn:
            # record their live backing for this era so payout_stakers
            # can distribute the era pool to the set that actually
            # validated it.
            self.era_backing[self.active_era] = {
                s: self.backing_of(s) for s in self.validators
            }
            return list(self.validators)
        self.validators = elected
        self.era_backing[self.active_era] = {s: backings[s] for s in elected}
        return elected

    # -- payout -----------------------------------------------------------

    def payout_stakers(self, era: int, stash: AccountId) -> Balance:
        """Pay one validator's era share, split pro-rata over its backers
        (stock payout_stakers shape, commission 0).  The era pool divides
        across the elected set by backing weight."""
        ensure((era, stash) not in self.payout_claimed, MOD, "AlreadyClaimed")
        pool = self.eras_validator_reward.get(era)
        ensure(pool is not None, MOD, "InvalidEraToReward")
        backing = self.era_backing.get(era, {})
        ensure(stash in backing, MOD, "NotElected")
        total_all = sum(sum(b.values()) for b in backing.values())
        mine = backing[stash]
        total_mine = sum(mine.values())
        if total_all == 0 or total_mine == 0:
            return 0
        share = pool * total_mine // total_all
        paid = 0
        for backer, amount in sorted(mine.items()):
            cut = share * amount // total_mine
            if cut:
                self.state.balances.mint(backer, cut)
                paid += cut
        self.payout_claimed.add((era, stash))
        self.state.deposit_event(
            MOD, "Rewarded", stash=stash, era=era, amount=paid
        )
        return paid

    # -- era economics ----------------------------------------------------

    def rewards_in_era(self, active_era_index: int) -> tuple[Balance, Balance]:
        """(validator_payout, sminer_payout) for one era (reference:
        impls.rs:454-475): yearly pools decay ×0.841 for ≤30 years, then
        flatten; each era gets 1/eras_per_year of the year's pool."""
        year_num = min(active_era_index // self.eras_per_year, REWARD_DECREASE_YEARS)
        validator_rewards = FIRST_YEAR_VALIDATOR_REWARDS
        sminer_rewards = FIRST_YEAR_SMINER_REWARDS
        for _ in range(year_num):
            validator_rewards = REWARD_DECREASE_RATIO.mul_floor(validator_rewards)
            sminer_rewards = REWARD_DECREASE_RATIO.mul_floor(sminer_rewards)
        return (
            validator_rewards // self.eras_per_year,
            sminer_rewards // self.eras_per_year,
        )

    def end_era(self) -> None:
        """reference: impls.rs:432-451 — record the validator pool and mint
        the sminer pool into the sminer reward pot."""
        validator_payout, sminer_payout = self.rewards_in_era(self.active_era)
        self.state.deposit_event(
            MOD,
            "EraPaid",
            era_index=self.active_era,
            validator_payout=validator_payout,
            remainder=sminer_payout,
        )
        self.eras_validator_reward[self.active_era] = validator_payout
        self.sminer.on_unbalanced(sminer_payout)
        self.active_era += 1
        # HistoryDepth pruning: expire stale reward/backing/claim records
        horizon = self.active_era - HISTORY_DEPTH_ERAS
        if horizon >= 0:
            self.eras_validator_reward.pop(horizon, None)
            self.era_backing.pop(horizon, None)
            self.payout_claimed = {
                (era, s) for era, s in self.payout_claimed if era > horizon
            }

    # -- slashing ----------------------------------------------------------

    def slash_scheduler(self, stash: AccountId) -> None:
        """5% of MinValidatorBond off the TEE's stash, to treasury
        (reference: slashing.rs:693-706)."""
        amount = Perbill.from_percent(5).mul_floor(self.min_validator_bond)
        ledger = self.ledger.get(stash)
        if ledger is None:
            return
        taken = min(ledger.bonded, amount)
        ledger.bonded -= taken
        self.state.balances.unreserve(stash, taken)
        self.state.balances.transfer(stash, TREASURY_POT, taken)
        self.state.deposit_event(MOD, "Slashed", staker=stash, amount=taken)

    def slash_offender(self, stash: AccountId, percent: int) -> Balance:
        """Offence slash: `percent`% of the offender's CURRENT bonded
        stake moves from its reserve straight to the treasury pot (the
        offences → staking slashing route, reference:
        slashing.rs + runtime/src/lib.rs:1509).  Unlocking chunks are
        not chased (scope-cut register, docs/offences.md).  Returns
        the amount actually taken."""
        ledger = self.ledger.get(stash)
        if ledger is None:
            return 0
        amount = ledger.bonded * max(0, min(100, percent)) // 100
        taken = self.state.balances.slash_reserved(
            stash, TREASURY_POT, amount
        )
        ledger.bonded -= min(ledger.bonded, taken)
        self.state.deposit_event(MOD, "Slashed", staker=stash, amount=taken)
        return taken
