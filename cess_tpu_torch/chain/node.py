"""Multi-role node simulator: the integration harness (SURVEY.md §7 L4).

Replaces the reference's mock-runtime test style (reference:
c-pallets/audit/src/mock.rs:36-58 wires ~15 real pallets and fakes
randomness so multi-role behavior runs in one process) with a deterministic
block-loop simulation in which every role is an actor against one Runtime:

  user       — RS-encodes content into segments (ops/rs.py, TPU kernel),
               declares uploads, owns buckets;
  miner      — stores fragments + fillers, reports transfers, answers audit
               challenges with real PoDR2 proofs (ProofBackend.prove_batch);
  TEE worker — holds the PoDR2 secret, tags fragments during the deal's
               Calculate stage (reference rate assumption:
               c-pallets/file-bank/src/constants.rs:4) and tags fillers,
               verifies proof batches (ProofBackend.verify_batch), signs
               verdicts with its BLS node key;
  validator  — commits challenges through the 2/3 quorum.

Off-chain channels (miner→TEE proof delivery, TEE→miner tag delivery) are
in-process queues; on-chain the audit pallet carries only σ plus a binding
commitment, matching the reference's ≤ SigmaMax blobs
(c-pallets/audit/src/types.rs:36-40).

A copy of `cess_tpu/chain/node.py` bound to the port.  NodeSim runs on
the card: `backend="torch"` (TorchBackend, kernels K1–K4) by default, and
`device` (None = the card, raising without one; "cpu" = the plain tensor
twins) reaches the proof backend, the RS segment code of every upload
and recovery, and the runtime's IAS registration.  `backend="cpu"` is
the host reference, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field

import numpy as np

from ..device import resolve_device
from ..ops import bls12_381 as bls
from ..ops import podr2
from ..ops.podr2 import Challenge, Podr2Params, Podr2Proof
from ..ops.rs import RSStream, segment_code
from ..proof import ProofBackend, get_backend, ias
from ..proof.backend import ProveRequest
from ..utils.hashing import Hash64
from .file_bank import FillerInfo, SegmentList, UserBrief
from .runtime import Runtime, RuntimeConfig
from .tee_worker import SgxAttestationReport
from .types import TOKEN


@dataclass
class StoredFragment:
    name: bytes
    data: bytes
    tags: list[bytes] | None = None  # None until the TEE tags it


@dataclass
class MinerStore:
    fragments: dict[Hash64, StoredFragment] = field(default_factory=dict)
    fillers: dict[Hash64, StoredFragment] = field(default_factory=dict)


from functools import lru_cache


@lru_cache(maxsize=1)
def _sim_authority():
    """Deterministic fixture root, generated once per process (the RSA
    prime search is ~0.1 s and the output is seed-fixed)."""
    # cesslint: allow[det-random] fixed-seed fixture RNG — every replica
    # derives the identical IAS root from b"sim-ias-root"
    return ias.fixture_authority(random.Random(b"sim-ias-root"), bits=1024)


@lru_cache(maxsize=8)
def _sim_report(podr2_pbk: bytes):
    """Deterministic attestation triple for a worker key, cached — every
    NodeSim with the same key reproduces the identical report."""
    _, root_priv = _sim_authority()
    report_json = (
        b'{"isvEnclaveQuoteStatus":"OK","podr2_pbk":"'
        + podr2_pbk.hex().encode()
        + b'"}'
    )
    return ias.fixture_report(
        root_priv,
        report_json,
        # cesslint: allow[det-random] fixed-seed fixture RNG keyed on the
        # worker pubkey — deterministic across replicas by construction
        random.Random(b"sim-tee-report" + podr2_pbk),
        bits=1024,
    )


class NodeSim:
    def __init__(
        self,
        n_miners: int = 5,
        n_validators: int = 3,
        backend: str | ProofBackend = "torch",
        params: Podr2Params = Podr2Params(n=8, s=4),
        config: RuntimeConfig | None = None,
        device=None,
    ) -> None:
        self.params = params
        self.device = resolve_device(device)
        if isinstance(backend, ProofBackend):
            self.backend = backend
        elif backend == "torch":
            self.backend = get_backend(backend, device=self.device)
        else:
            self.backend = get_backend(backend)
        self.miners = [f"miner-{i}" for i in range(n_miners)]
        self.validators = [f"validator-{i}" for i in range(n_validators)]
        self.users: list[str] = []

        cfg = config or RuntimeConfig(
            podr2_chunk_count=params.n,
            endowed={
                "tee-stash": 1_000_000 * TOKEN,
                "tee-ctrl": 1_000 * TOKEN,
                **{m: 1_000_000 * TOKEN for m in self.miners},
            },
        )
        cfg.podr2_chunk_count = params.n
        # Attestation genesis: a fixture authority plays the Intel IAS
        # root's role (reference pins the real root DER at
        # primitives/enclave-verify/src/lib.rs:46-93); registration goes
        # through the full X.509 + RSA verification path.  The fixture
        # root is appended to any caller-pinned store so the sim's own
        # TEE can still register under it.
        self.ias_root_der, self.ias_root_priv = _sim_authority()
        fixture_store = ias.RootStore.from_der([self.ias_root_der])
        if cfg.ias_roots is None:
            cfg.ias_roots = fixture_store
        else:
            cfg.ias_roots = ias.RootStore(
                tuple(cfg.ias_roots.roots) + fixture_store.roots
            )
        self.rt = Runtime(cfg, device=self.device)
        self.rt.run_blocks(1)

        # TEE worker: PoDR2 keypair is the network key; node key is a BLS
        # key whose signatures the audit pallet verifies (the seam the
        # reference leaves open at audit/src/lib.rs:484).
        self.tee_acc = "tee-ctrl"
        self.tee_sk, self.tee_pk = podr2.keygen(b"sim-tee")
        self.tee_node_sk = bls.keygen(b"sim-tee-node")
        node_key = bls.sk_to_pk(self.tee_node_sk)
        self.rt.staking.bond("tee-stash", self.tee_acc, 100_000 * TOKEN)
        self.rt.tee_worker.register(
            self.tee_acc, "tee-stash", node_key, b"tee-peer", self.tee_pk,
            self.make_attestation(self.tee_pk),
        )
        self.rt.audit.result_verifier = lambda nk, msg, sig: bls.verify(
            nk, msg, sig
        )

        self.rt.audit.initialize_keys(self.validators)

        self.store: dict[str, MinerStore] = {}
        for m in self.miners:
            self.rt.sminer.regnstk(m, f"{m}-ben", m.encode(), 8_000 * TOKEN)
            self.store[m] = MinerStore()

        # Off-chain mail: TEE inbox of (miner, idle items, service items).
        self.tee_inbox: list[tuple] = []
        self._rs = segment_code(device=self.device)

    # ------------------------------------------------------------ helpers

    def make_attestation(self, podr2_pbk: bytes) -> SgxAttestationReport:
        """Fabricate an attestation report signed under the sim's pinned
        authority (the reference's own tests round-trip fixtures the same
        way, enclave-verify/src/lib.rs:242-255).  The report body binds
        the worker's PoDR2 public key (checked at registration —
        proof/ias.report_binds_key)."""
        sign, cert_b64, report = _sim_report(podr2_pbk)
        return SgxAttestationReport(
            report_json_raw=report, sign=sign, cert_der=cert_b64
        )

    @property
    def segment_bytes(self) -> int:
        """A sim 'segment' is 2 data fragments (the RS(2,1) geometry of the
        reference: 16 MiB segment = 2×8 MiB data + 1×8 MiB parity)."""
        return 2 * self.params.fragment_bytes

    def add_user(self, name: str, gib: int = 1, tokens: int = 10**6) -> None:
        self.rt.state.balances.mint(name, tokens * TOKEN)
        self.rt.storage_handler.buy_space(name, gib)
        self.users.append(name)

    # ------------------------------------------------------------ fillers

    def miner_add_fillers(self, miner: str, count: int) -> None:
        """Miner requests `count` TEE-tagged fillers and reports them
        on-chain (reference: file-bank/src/lib.rs:804-842, ≤10 per call)."""
        fillers = []
        for _ in range(count):
            seq = len(self.store[miner].fillers)
            fh = Hash64.of(f"filler/{miner}/{seq}".encode())
            data = podr2.filler_data(fh.raw(), self.params)
            tags = podr2.tag_fragment(
                self.tee_sk, fh.ascii_bytes(), data, self.params
            )
            self.store[miner].fillers[fh] = StoredFragment(
                name=fh.ascii_bytes(), data=data, tags=tags
            )
            fillers.append(
                FillerInfo(
                    block_num=self.rt.state.block_number,
                    miner_address=miner,
                    filler_hash=fh,
                )
            )
        for start in range(0, len(fillers), 10):
            self.rt.file_bank.upload_filler(
                miner, self.tee_acc, fillers[start : start + 10]
            )

    # ------------------------------------------------------------ upload

    def user_upload(self, user: str, file_name: str, content: bytes):
        """Full upload pipeline: RS-encode → declare → deliver fragments →
        transfer reports → TEE tag calculation → file Active."""
        seg_bytes = self.segment_bytes
        frag_bytes = self.params.fragment_bytes
        content_padded = content.ljust(
            ((len(content) + seg_bytes - 1) // seg_bytes) * seg_bytes or seg_bytes,
            b"\x00",
        )
        deal_info: list[SegmentList] = []
        fragment_payload: dict[Hash64, bytes] = {}
        # All segments RS-encode as ONE streamed batch (fixed-slab
        # dispatches; multi-segment files stop paying a device round
        # trip per segment).
        segments = np.frombuffer(content_padded, dtype=np.uint8).reshape(
            -1, 2, frag_bytes
        )
        parities = RSStream(self._rs).run_batch(segments)
        for shards, parity in zip(segments, parities):
            all_shards = [shards[0], shards[1], parity[0]]
            frag_hashes = []
            for shard in all_shards:
                payload = shard.tobytes()
                fh = Hash64.of(payload)
                fragment_payload[fh] = payload
                frag_hashes.append(fh)
            deal_info.append(
                SegmentList(
                    hash=Hash64.of(shards.tobytes()), fragment_list=frag_hashes
                )
            )
        file_hash = Hash64.of(b"file:" + content_padded)
        brief = UserBrief(user=user, file_name=file_name, bucket_name=f"{user}-bkt")
        self.rt.file_bank.upload_declaration(
            user, file_hash, deal_info, brief, len(content)
        )

        # Miners fetch their assigned fragments and report.
        deal = self.rt.file_bank.deal_map[file_hash]
        for mt in deal.assigned_miner:
            for fh in mt.fragment_list:
                self.store[mt.miner].fragments[fh] = StoredFragment(
                    name=fh.ascii_bytes(), data=fragment_payload[fh]
                )
        for mt in list(deal.assigned_miner):
            self.rt.file_bank.transfer_report(mt.miner, [file_hash])

        # Calculate stage: the TEE tags every stored fragment.
        for m in self.miners:
            for frag in self.store[m].fragments.values():
                if frag.tags is None:
                    frag.tags = podr2.tag_fragment(
                        self.tee_sk, frag.name, frag.data, self.params
                    )
        # Let the scheduled calculate_end fire.
        guard = 0
        while file_hash in self.rt.file_bank.deal_map:
            self.rt.next_block()
            guard += 1
            assert guard < 10_000, "calculate_end never fired"
        return file_hash

    def rt_encode(self, shards: np.ndarray):
        return self._rs.encode(shards)

    def recover_file(
        self, file_hash: Hash64, lost: dict[int, int] | None = None
    ) -> bytes:
        """Rebuild a file's plaintext from any k-of-(k+m) stored fragments
        per segment (reference seam: the restoral-order market,
        c-pallets/file-bank/src/lib.rs:936-1125).  `lost` optionally maps
        segment index → fragment index to treat as unavailable on top of
        the on-chain `avail` flags, so different segments recover from
        DIFFERENT survivor sets — the grouped per-pattern rs.RSStream
        path, one batched matmul per distinct erasure mask."""
        f = self.rt.file_bank.file.get(file_hash)
        if f is None:
            raise KeyError(f"unknown file {file_hash}")
        frag_bytes = self.params.fragment_bytes
        k = self._rs.k
        patterns: list[list[int]] = []
        survivors = np.empty(
            (len(f.segment_list), k, frag_bytes), dtype=np.uint8
        )
        for i, seg in enumerate(f.segment_list):
            present: list[int] = []
            for j, frag in enumerate(seg.fragment_list):
                if not frag.avail or (lost is not None and lost.get(i) == j):
                    continue
                stored = self.store[frag.miner].fragments.get(frag.hash)
                if stored is None:
                    continue
                survivors[i, len(present)] = np.frombuffer(
                    stored.data, dtype=np.uint8
                )
                present.append(j)
                if len(present) == k:
                    break
            if len(present) < k:
                raise ValueError(
                    f"segment {i}: only {len(present)} of {k} "
                    "fragments available"
                )
            patterns.append(present)
        data = RSStream(self._rs, present=patterns).run_batch(survivors)
        return data.tobytes()[: f.file_size]

    # ------------------------------------------------------------ audit

    def run_audit_round(self) -> dict[str, tuple[bool, bool]]:
        """One full audit round; returns {miner: (idle_ok, service_ok)}."""
        rt = self.rt
        info = rt.audit.generation_challenge(rt.state.block_number)
        for v in self.validators:
            rt.audit.save_challenge_info(info, v, signature=None)
        assert rt.audit.challenge_snap_shot is not None
        challenge = Challenge.from_net_snapshot(info.net_snap_shot)

        # Challenged miners build proofs over everything they store.
        for snap in list(info.miner_snapshot_list):
            miner = snap.miner
            store = self.store[miner]
            idle = sorted(store.fillers.values(), key=lambda f: f.name)
            service = sorted(store.fragments.values(), key=lambda f: f.name)
            idle_items = self._prove_set(idle, challenge)
            service_items = self._prove_set(service, challenge)
            idle_blob = self._blob(idle_items)
            service_blob = self._blob(service_items)
            rt.audit.submit_proof(miner, idle_blob, service_blob)
            self.tee_inbox.append(
                (miner, idle_blob, service_blob, idle_items, service_items)
            )

        # TEE drains its missions, batch-verifying via the ProofBackend.
        results: dict[str, tuple[bool, bool]] = {}
        seed = rt.state.randomness
        for miner, idle_blob, service_blob, idle_items, service_items in (
            self.tee_inbox
        ):
            tee = next(
                (t for t, lst in rt.audit.unverify_proof.items()
                 if any(p.snap_shot.miner == miner for p in lst)),
                None,
            )
            if tee is None:
                continue
            mission = next(
                p for p in rt.audit.unverify_proof[tee]
                if p.snap_shot.miner == miner
            )
            # Commitment binding: on-chain blob must match delivered proofs.
            idle_ok = mission.idle_prove == self._blob(idle_items)
            service_ok = mission.service_prove == self._blob(service_items)
            idle_ok = idle_ok and all(
                self.backend.verify_batch(
                    self.tee_pk, idle_items, seed, self.params
                )
            )
            service_ok = service_ok and all(
                self.backend.verify_batch(
                    self.tee_pk, service_items, seed, self.params
                )
            )
            sig = bls.sign(
                self.tee_node_sk,
                rt.audit.result_message(miner, idle_ok, service_ok),
            )
            rt.audit.submit_verify_result(tee, miner, idle_ok, service_ok, sig)
            results[miner] = (idle_ok, service_ok)
        self.tee_inbox.clear()
        return results

    def _prove_set(self, frags: list[StoredFragment], challenge: Challenge):
        if not frags:
            return []
        req = ProveRequest(
            names=[f.name for f in frags],
            tags=[f.tags for f in frags],
            data=[f.data for f in frags],
            challenge=challenge,
            params=self.params,
        )
        proofs = self.backend.prove_batch(req)
        return [
            (f.name, challenge, p) for f, p in zip(frags, proofs)
        ]

    @staticmethod
    def _blob(items) -> bytes:
        """≤ SigmaMax on-chain blob: digest binding every (name, proof)."""
        h = hashlib.sha256()
        for name, _, proof in items:
            h.update(name)
            h.update(proof.commitment())
        return h.digest()
