"""Transaction fee market: static per-call weights, a per-block weight
limit, and the 20/80 treasury/author fee split.

Role match: the reference prices every dispatchable with benchmarked
weights (`c-pallets/*/src/weights.rs`) and routes collected fees through
`DealWithFees` — 20% to the treasury pot, 80% to the block author
(reference: runtime/src/impls.rs:9-28, runtime/src/lib.rs:429-441).
Here the weights are a hand-assigned static table (the scope cut is
registered in docs/fees.md): relative cost ORDER matches the reference's
benchmarks (storage-heavy file-bank/audit calls dwarf flag flips like
`oss.authorize`), absolute values are picoseconds-free units chosen so
~100 cheap calls or ~2 heavy ones fill a block.

Determinism contract: fees are charged inside block application (the
node's shared authoring/import path), so every replica debits identical
amounts and the split lands in the state hash.  The per-block
accumulator `block_fees` carries intra-block state between charge() and
distribute() and is always zero at snapshot time — both callers
distribute before hashing.
"""

from __future__ import annotations

from .staking import TREASURY_POT
from .state import ChainState
from .types import Balance, Perbill, ensure

MOD = "fees"

# Escrow pot fees sit in between charge (per extrinsic) and distribute
# (at block commit) — a pot account like the treasury's, never a
# balance sink (distribute always empties it into author + treasury).
FEE_POT = "pot/fees"

# Treasury's cut of every block's fees; the author keeps the rest
# (reference runtime/src/impls.rs:9-28: 20% treasury / 80% author).
TREASURY_CUT = Perbill.from_percent(20)

# ---------------------------------------------------------------- weights
#
# Static weight per (module, call) — the */weights.rs role.  Units are
# abstract "weight points": the default block limit (RuntimeConfig
# .block_weight_limit = 100_000) holds ~2000 `oss.authorize` or ~40
# `audit.submit_verify_result`.  Every entry in the node's
# EXTRINSIC_DISPATCH table MUST have a weight here —
# tests/test_fees.py enforces completeness in both directions.
WEIGHTS: dict[tuple[str, str], int] = {
    # sminer (reference c-pallets/sminer/src/weights.rs)
    ("sminer", "regnstk"): 250,
    ("sminer", "increase_collateral"): 80,
    ("sminer", "update_beneficiary"): 60,
    ("sminer", "update_peer_id"): 60,
    ("sminer", "receive_reward"): 180,
    ("sminer", "faucet_top_up"): 70,
    ("sminer", "faucet"): 70,
    ("sminer", "withdraw"): 120,
    # storage-handler
    ("storage_handler", "buy_space"): 150,
    ("storage_handler", "expansion_space"): 130,
    ("storage_handler", "renewal_space"): 130,
    # oss: flag flips — the cheapest calls on the chain
    ("oss", "authorize"): 50,
    ("oss", "cancel_authorize"): 45,
    ("oss", "register"): 70,
    ("oss", "update"): 55,
    ("oss", "destroy"): 55,
    # cacher
    ("cacher", "logout"): 45,
    # staking
    ("staking", "bond"): 140,
    ("staking", "bond_extra"): 90,
    ("staking", "unbond"): 110,
    ("staking", "withdraw_unbonded"): 110,
    ("staking", "validate"): 100,
    ("staking", "nominate"): 100,
    ("staking", "chill"): 60,
    # tee-worker: register re-verifies an RSA attestation chain
    ("tee_worker", "exit"): 90,
    ("tee_worker", "register"): 800,
    # file-bank: storage-heavy, the reference's priciest user calls
    ("file_bank", "transfer_report"): 300,
    ("file_bank", "replace_file_report"): 250,
    ("file_bank", "delete_file"): 200,
    ("file_bank", "create_bucket"): 80,
    ("file_bank", "delete_bucket"): 90,
    ("file_bank", "generate_restoral_order"): 150,
    ("file_bank", "claim_restoral_order"): 120,
    ("file_bank", "restoral_order_complete"): 160,
    ("file_bank", "miner_exit_prep"): 140,
    ("file_bank", "upload_declaration"): 400,
    ("file_bank", "upload_filler"): 350,
    # audit: proof blobs + quorum bookkeeping
    ("audit", "submit_proof"): 500,
    ("audit", "submit_verify_result"): 450,
    ("audit", "save_challenge_info"): 600,
    # offences
    ("offences", "heartbeat"): 60,
    ("offences", "report_offence"): 900,
    # evm (reference runtime/src/lib.rs:1322-1344 gas→weight mapping)
    ("evm", "deposit"): 80,
    ("evm", "withdraw"): 90,
    ("evm", "transact_call"): 1500,
    ("evm", "transact_create"): 2500,
}

# A block author can include a call outside the dispatch table (it fails
# with a deterministic receipt) — the overweight check must still price
# it identically on every replica, so unknown calls get a fixed default.
DEFAULT_WEIGHT = 500

# Operational (Pays::No + operational DispatchClass role): consensus
# plumbing the chain itself submits — heartbeats, offence evidence, and
# the audit OCW's challenge votes.  Free of charge and priority-boosted
# so a fee-market flood can never starve liveness machinery.
OPERATIONAL: frozenset[tuple[str, str]] = frozenset({
    ("offences", "heartbeat"),
    ("offences", "report_offence"),
    ("audit", "save_challenge_info"),
})

# Priority boost for operational extrinsics: above any achievable
# fee-per-weight (Substrate's operational class gets 3/4 of the u64
# priority space for the same reason).
OPERATIONAL_BOOST = 1 << 62


def weight_of(module: str, call: str) -> int:
    return WEIGHTS.get((module, call), DEFAULT_WEIGHT)


def is_operational(module: str, call: str) -> bool:
    return (module, call) in OPERATIONAL


def priority(fee: Balance, tip: Balance, weight: int,
             operational: bool = False) -> int:
    """Pool ordering key: fee-per-weight scaled ×1000 so sub-unit
    differences still rank (integer math only — priority feeds pool
    ordering, never consensus state)."""
    p = ((fee + tip) * 1000) // max(1, weight)
    return p + OPERATIONAL_BOOST if operational else p


class FeesPallet:
    """Fee charging + per-block split accounting (pallet-transaction-
    payment + DealWithFees collapsed into one pallet)."""

    def __init__(self, state: ChainState, base_fee: Balance,
                 fee_per_weight: Balance, block_weight_limit: int) -> None:
        self.state = state
        self.base_fee = base_fee
        self.fee_per_weight = fee_per_weight
        self.block_weight_limit = block_weight_limit
        # Escrowed fees of the block being built (zero at snapshot).
        self.block_fees: Balance = 0
        # Lifetime counters — consensus state, replica-identical.
        self.total_fees: Balance = 0
        self.paid_author: dict[str, Balance] = {}
        self.paid_treasury: Balance = 0

    # ------------------------------------------------------------ pricing

    def fee_of(self, module: str, call: str) -> Balance:
        """base + weight·per-weight (pallet-transaction-payment's
        length+weight fee with the length term folded into base)."""
        if is_operational(module, call):
            return 0
        return self.base_fee + weight_of(module, call) * self.fee_per_weight

    def can_pay(self, who: str, module: str, call: str,
                tip: Balance = 0) -> bool:
        return self.state.balances.free(who) >= self.fee_of(
            module, call) + tip

    # ------------------------------------------------------------ charging

    def charge(self, who: str, module: str, call: str,
               tip: Balance = 0) -> Balance:
        """Debit the fee (+ tip) into the block escrow pot.  Raises
        DispatchError (via ensure) when the signer can't pay — callers
        turn that into a deterministic failed receipt.  Returns the
        amount charged."""
        ensure(tip >= 0, MOD, "NegativeTip")
        fee = self.fee_of(module, call)
        total = fee + tip
        if total == 0:
            return 0
        self.state.balances.transfer(who, FEE_POT, total)
        self.block_fees += total
        self.total_fees += total
        self.state.deposit_event(
            MOD, "TransactionFeePaid", who=who, actual_fee=fee, tip=tip)
        return total

    def distribute(self, author: str) -> tuple[Balance, Balance]:
        """Split the block's escrowed fees 20/80 treasury/author at
        block commit (the DealWithFees route).  Floor division gives
        the treasury its exact 20% floor and the author the remainder,
        so the split is bit-identical on every replica.  Returns
        (treasury_amount, author_amount)."""
        total = self.block_fees
        if total == 0:
            return 0, 0
        self.block_fees = 0
        to_treasury = TREASURY_CUT.mul_floor(total)
        to_author = total - to_treasury
        self.state.balances.transfer(FEE_POT, TREASURY_POT, to_treasury)
        self.state.balances.transfer(FEE_POT, author, to_author)
        self.paid_treasury += to_treasury
        self.paid_author[author] = (
            self.paid_author.get(author, 0) + to_author)
        self.state.deposit_event(
            MOD, "FeesDistributed", author=author,
            to_author=to_author, to_treasury=to_treasury)
        return to_treasury, to_author
