"""Chain specifications: JSON genesis documents → RuntimeConfig + keys.

Role match: the reference's chain_spec presets and raw JSON specs
(reference: node/src/chain_spec.rs:84-318, node/ccg/*.json, selected by
node/src/command.rs:55-67).  A spec carries the genesis knobs
(RuntimeConfig fields), endowed accounts with their BLS public keys
(extrinsic signatures are BLS here — the reference uses sr25519; the
signing seam is identical), the validator set, and — dev/local only —
the deterministic seed that lets tooling derive the matching secret
keys and the fixture attestation authority."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any

from ..chain.runtime import RuntimeConfig
from ..chain.types import TOKEN
from ..ops import bls12_381 as bls

# RuntimeConfig fields a spec may override (chain_spec.rs's
# parameter_types role).
_GENESIS_KNOBS = (
    "one_day_block", "one_hour_block", "frozen_days", "space_unit_price",
    "era_duration_blocks", "eras_per_year", "credit_period_blocks",
    "audit_lock_time", "podr2_chunk_count", "sessions_per_era",
    "genesis_candidates", "base_fee", "fee_per_weight",
    "block_weight_limit",
)


def dev_sk(name: str, chain: str = "dev") -> int:
    """Deterministic dev secret key for an account name (the Alice/Bob
    role of chain_spec.rs's `authority_keys_from_seed`)."""
    return bls.keygen(f"cess-{chain}-{name}".encode())


@lru_cache(maxsize=4)
def dev_ias_authority(chain: str = "dev"):
    """Deterministic fixture attestation root for dev/local chains
    (genesis pins it; clients fabricate reports under it) — the
    NodeSim._sim_authority role at the service layer."""
    import random

    from ..proof import ias

    return ias.fixture_authority(
        random.Random(f"cess-{chain}-ias-root".encode()), bits=1024
    )


@dataclass
class ChainSpec:
    name: str
    chain_id: str
    block_time_ms: int = 6000  # reference: 6 s blocks (runtime lib.rs:234)
    # Finality vote cadence in blocks (the GRANDPA session-period role):
    # validators vote for the canonical block at every multiple of this;
    # 0 disables the voter (node/sync.py).
    finality_period: int = 8
    genesis: dict[str, Any] = field(default_factory=dict)
    # account → {"balance": int, "pub": hex BLS public key}
    accounts: dict[str, dict[str, Any]] = field(default_factory=dict)
    validators: list[str] = field(default_factory=list)
    genesis_randomness: str = "00" * 32
    dev_seed: bool = False  # dev/local: keys derivable from names

    # ------------------------------------------------------------ codec

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "id": self.chain_id,
                "blockTimeMs": self.block_time_ms,
                "finalityPeriod": self.finality_period,
                "genesis": self.genesis,
                "accounts": self.accounts,
                "validators": self.validators,
                "genesisRandomness": self.genesis_randomness,
                "devSeed": self.dev_seed,
            },
            indent=2,
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "ChainSpec":
        d = json.loads(text)
        unknown = set(d.get("genesis", {})) - set(_GENESIS_KNOBS)
        if unknown:
            raise ValueError(f"unknown genesis knobs: {sorted(unknown)}")
        return cls(
            name=d["name"],
            chain_id=d["id"],
            block_time_ms=d.get("blockTimeMs", 6000),
            finality_period=d.get("finalityPeriod", 8),
            genesis=d.get("genesis", {}),
            accounts=d.get("accounts", {}),
            validators=d.get("validators", []),
            genesis_randomness=d.get("genesisRandomness", "00" * 32),
            dev_seed=d.get("devSeed", False),
        )

    # ------------------------------------------------------------ build

    def runtime_config(self, ias_roots=None) -> RuntimeConfig:
        cfg = RuntimeConfig(
            genesis_randomness=bytes.fromhex(self.genesis_randomness),
            endowed={
                acc: int(info.get("balance", 0))
                for acc, info in self.accounts.items()
            },
            ias_roots=ias_roots,
            genesis_validators=list(self.validators),
        )
        for k, v in self.genesis.items():
            setattr(cfg, k, v)
        return cfg

    def genesis_hash(self) -> str:
        """blake2b over the spec document — block #1's parent and the
        domain separator every consensus payload binds.  NodeService
        adopts this as `self.genesis`; a light client needs nothing
        else chain-side to start verifying (light/client.py)."""
        import hashlib

        return hashlib.blake2b(
            self.to_json().encode(), digest_size=32
        ).hexdigest()

    def validator_keys(self) -> dict[str, bytes]:
        """validator name → BLS public key — the initial trusted keyset
        a light client anchors on (public_keys restricted to the
        authority set)."""
        keys = self.public_keys()
        return {v: keys[v] for v in self.validators if v in keys}

    def public_keys(self) -> dict[str, bytes]:
        """account → BLS public key (the extrinsic-signature registry)."""
        out = {}
        for acc, info in self.accounts.items():
            if "pub" in info:
                out[acc] = bytes.fromhex(info["pub"])
            elif self.dev_seed:
                out[acc] = bytes.fromhex(
                    bls.sk_to_pk(dev_sk(acc, self.chain_id)).hex()
                )
        return out


def _spec(chain_id: str, name: str, accounts: list[str],
          validators: list[str], block_time_ms: int) -> ChainSpec:
    spec = ChainSpec(
        name=name, chain_id=chain_id, block_time_ms=block_time_ms,
        validators=validators, dev_seed=True,
    )
    for acc in accounts:
        spec.accounts[acc] = {
            "balance": 1_000_000 * TOKEN,
            "pub": bls.sk_to_pk(dev_sk(acc, chain_id)).hex(),
        }
    return spec


def dev_spec() -> ChainSpec:
    """Single-validator fast-block dev chain (chain_spec.rs dev role)."""
    return _spec(
        "dev", "CESS-TPU Development",
        accounts=["alice", "bob", "charlie", "miner-0", "miner-1",
                  "tee-stash", "tee-ctrl"],
        validators=["alice"],
        block_time_ms=100,
    )


def local_spec() -> ChainSpec:
    """Multi-validator local testnet (chain_spec.rs local role)."""
    return _spec(
        "local", "CESS-TPU Local Testnet",
        accounts=["alice", "bob", "charlie", "dave", "eve",
                  "miner-0", "miner-1", "miner-2", "tee-stash", "tee-ctrl"],
        validators=["alice", "bob", "charlie"],
        block_time_ms=1000,
    )


PRESETS = {"dev": dev_spec, "local": local_spec}


def load_spec(chain: str) -> ChainSpec:
    """Preset name or path to a JSON spec file (command.rs:55-67)."""
    if chain in PRESETS:
        return PRESETS[chain]()
    with open(chain) as fh:
        return ChainSpec.from_json(fh.read())
