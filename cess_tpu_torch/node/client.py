"""Role clients: miner / TEE / user processes speaking RPC to a node.

Process-separation match: the reference network runs miners and TEE
workers as external binaries that interact with the chain purely through
extrinsics and queries (SURVEY §0 — the RS/PoDR2 tooling lives outside
the node).  These clients reproduce that boundary over the JSON-RPC
surface: each owns its BLS key, tracks its nonce via `author_nonce`,
signs extrinsics locally, and watches chain state through the view
methods — they never touch the Runtime in-process."""

from __future__ import annotations

import hashlib
import json
import socket
import time

from ..ops import bls12_381 as bls
from .chain_spec import dev_sk
from .rpc import RpcError
from .service import Extrinsic


def proof_commitment(items) -> bytes:
    """≤ SigmaMax on-chain blob binding every (name, proof) of an
    offchain-delivered proof set (the NodeSim._blob convention): the
    chain carries the digest, the TEE checks the delivered proofs hash
    to it before verifying."""
    h = hashlib.sha256()
    for name, _, proof in items:
        h.update(name)
        h.update(proof.commitment())
    return h.digest()


def challenge_from_snapshot(snap: dict):
    """RPC `audit_challengeSnapshot` view → ops/podr2.Challenge (the
    index/coefficient pairs miners prove against)."""
    from ..ops.podr2 import Challenge

    net = snap["net_snap_shot"]
    return Challenge(
        indices=tuple(int(i) for i in net["random_index_list"]),
        randoms=tuple(bytes.fromhex(r["hex"]) for r in net["random_list"]),
    )


class RpcClient:
    """Persistent newline-JSON connection to a node."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9944,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._file = self._sock.makefile("rwb")
        self._id = 0

    def call(self, method: str, *params):
        self._id += 1
        self._file.write(
            json.dumps(
                {"jsonrpc": "2.0", "id": self._id, "method": method,
                 "params": list(params)},
                separators=(",", ":"),
            ).encode() + b"\n"
        )
        self._file.flush()
        line = self._file.readline()
        if not line:
            raise ConnectionError("rpc connection closed")
        resp = json.loads(line)
        if "error" in resp:
            raise RpcError(resp["error"]["code"], resp["error"]["message"])
        return resp["result"]

    def close(self) -> None:
        self._file.close()
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SigningClient(RpcClient):
    """RpcClient plus an account identity: signs and submits extrinsics,
    fetching the genesis binding and nonce from the node."""

    def __init__(self, account: str, sk: int | None = None,
                 chain_id: str = "dev", **kw):
        super().__init__(**kw)
        self.account = account
        self.chain_id = chain_id
        self.sk = sk if sk is not None else dev_sk(account, chain_id)
        # the node's genesis hash binds signatures to this chain
        self.genesis = self.call("system_chainGenesis")

    def submit(self, module: str, call: str, *args, tip: int = 0) -> str:
        nonce = self.call("author_nonce", self.account)
        ext = Extrinsic(
            signer=self.account, module=module, call=call,
            args=list(args), nonce=nonce, tip=tip,
        ).sign(self.sk, self.genesis)
        return self.call("author_submitExtrinsic", ext.to_json())

    def estimate_fee(self, module: str, call: str, tip: int = 0) -> dict:
        return self.call("fees_estimate", module, call, tip)

    def wait_blocks(self, n: int = 1, timeout: float = 30.0) -> None:
        start = self.call("chain_getHeader")["number"]
        t0 = time.monotonic()
        while self.call("chain_getHeader")["number"] < start + n:
            if time.monotonic() - t0 > timeout:
                raise TimeoutError("block production stalled")
            time.sleep(0.02)

    def free_balance(self) -> int:
        return self.call("balances_free", self.account)


class MinerClient(SigningClient):
    """Storage-miner role (reference: the external miner binary).  The
    audit-round methods make the client a self-contained protocol actor:
    it keeps its stored fillers/fragments locally (miner disks are not
    chain state) and answers live challenges it observes over RPC."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # name bytes → (tags, data): this miner's offchain store
        self.idle_store: dict[bytes, tuple[list, bytes]] = {}
        self.service_store: dict[bytes, tuple[list, bytes]] = {}

    def register(self, beneficiary: str, peer_id: bytes, stake: int) -> str:
        return self.submit(
            "sminer", "regnstk", beneficiary, {"hex": peer_id.hex()}, stake
        )

    def upload_fillers(self, tee: str, filler_hashes: list[str]) -> str:
        return self.submit("file_bank", "upload_filler", tee, filler_hashes)

    def create_fillers(self, tee: "TeeClient", count: int, params) -> str:
        """Generate TEE-tagged filler fragments, keep them in the local
        store, and report them on-chain (file-bank upload_filler — this
        is what gives the miner auditable idle space)."""
        from ..ops import podr2
        from ..utils.hashing import Hash64

        hashes = []
        for _ in range(count):
            seq = len(self.idle_store)
            fh = Hash64.of(f"filler/{self.account}/{seq}".encode())
            data = podr2.filler_data(fh.raw(), params)
            name = fh.ascii_bytes()
            tags = tee.tag_fragment(name, data, params)
            self.idle_store[name] = (tags, data)
            hashes.append(str(fh))
        return self.upload_fillers(tee.account, hashes)

    def submit_proof(self, idle_prove: bytes, service_prove: bytes) -> str:
        return self.submit(
            "audit", "submit_proof",
            {"hex": idle_prove.hex()}, {"hex": service_prove.hex()},
        )

    def _prove_store(self, store, challenge, backend, params):
        from ..proof.backend import ProveRequest

        if not store:
            return []
        names = sorted(store)
        req = ProveRequest(
            names=names,
            tags=[store[n][0] for n in names],
            data=[store[n][1] for n in names],
            challenge=challenge,
            params=params,
        )
        proofs = backend.prove_batch(req)
        return [(n, challenge, p) for n, p in zip(names, proofs)]

    def answer_challenge(self, backend, params):
        """If the current on-chain challenge names this miner, prove
        everything stored and submit the binding commitments (audit
        submit_proof).  Returns (idle_items, service_items) for offchain
        delivery to the verifying TEE, else None."""
        snap = self.call("audit_challengeSnapshot")
        if snap is None:
            return None
        if not any(
            s["miner"] == self.account for s in snap["miner_snapshot_list"]
        ):
            return None
        challenge = challenge_from_snapshot(snap)
        idle_items = self._prove_store(
            self.idle_store, challenge, backend, params)
        service_items = self._prove_store(
            self.service_store, challenge, backend, params)
        self.submit_proof(
            proof_commitment(idle_items), proof_commitment(service_items)
        )
        return idle_items, service_items

    def info(self) -> dict:
        return self.call("sminer_minerInfo", self.account)


class TeeClient(SigningClient):
    """TEE-worker role (reference: the external SGX worker).  Holds the
    PoDR2 tagging secret and its BLS node key client-side — the enclave
    boundary: the chain only ever sees public keys and signed verdicts."""

    def __init__(self, *a, podr2_seed: bytes = b"", **kw):
        super().__init__(*a, **kw)
        from ..ops import podr2

        seed = podr2_seed or f"tee:{self.account}".encode()
        self.podr2_sk, self.podr2_pk = podr2.keygen(seed)
        self.node_sk = bls.keygen(b"node:" + seed)
        self.node_key = bls.sk_to_pk(self.node_sk)

    def register(self, stash: str, node_key: bytes | None = None,
                 peer: bytes = b"tee-peer", podr2_pbk: bytes | None = None,
                 attestation: dict | None = None) -> str:
        if node_key is None:
            node_key = self.node_key
        if podr2_pbk is None:
            podr2_pbk = self.podr2_pk
        if attestation is None:
            attestation = make_dev_attestation(podr2_pbk, self.chain_id)
        return self.submit(
            "tee_worker", "register", stash,
            {"hex": node_key.hex()}, {"hex": peer.hex()},
            {"hex": podr2_pbk.hex()}, attestation,
        )

    def tag_fragment(self, name: bytes, data: bytes, params) -> list:
        """Calculate-stage tagging (the enclave's PoDR2 signing role)."""
        from ..ops import podr2

        return podr2.tag_fragment(self.podr2_sk, name, data, params)

    def submit_verdict(self, miner: str, idle_ok: bool, service_ok: bool,
                       signature: bytes = b"") -> str:
        return self.submit(
            "audit", "submit_verify_result", miner, idle_ok, service_ok,
            {"hex": signature.hex()},
        )

    def verify_missions(self, backend, params, delivered: dict,
                        seed: bytes = b"live-audit") -> dict:
        """Drain this TEE's verify missions (audit_unverifyProof view):
        check each miner's offchain-delivered proofs against the on-chain
        commitment, batch-verify through the ProofBackend, and submit the
        node-key-signed verdict.  Returns {miner: (idle_ok, service_ok)}."""
        from ..chain.audit import AuditPallet

        results = {}
        for mission in self.call("audit_unverifyProof", self.account):
            miner = mission["snap_shot"]["miner"]
            if miner not in delivered:
                continue
            idle_items, service_items = delivered[miner]
            idle_ok = (
                bytes.fromhex(mission["idle_prove"]["hex"])
                == proof_commitment(idle_items)
            )
            service_ok = (
                bytes.fromhex(mission["service_prove"]["hex"])
                == proof_commitment(service_items)
            )
            idle_ok = idle_ok and all(
                backend.verify_batch(self.podr2_pk, idle_items, seed, params)
            )
            service_ok = service_ok and all(
                backend.verify_batch(
                    self.podr2_pk, service_items, seed, params)
            )
            sig = bls.sign(
                self.node_sk,
                AuditPallet.result_message(miner, idle_ok, service_ok),
            )
            self.submit_verdict(miner, idle_ok, service_ok, sig)
            results[miner] = (idle_ok, service_ok)
        return results


class UserClient(SigningClient):
    """End-user role: space purchase + file lifecycle."""

    def buy_space(self, gib: int) -> str:
        return self.submit("storage_handler", "buy_space", gib)

    def create_bucket(self, name: str) -> str:
        return self.submit("file_bank", "create_bucket", self.account, name)

    def declare_upload(self, file_hash: str, segments: list[dict],
                       file_name: str, bucket: str, size: int) -> str:
        return self.submit(
            "file_bank", "upload_declaration", file_hash, segments,
            {"user": self.account, "fileName": file_name, "bucket": bucket},
            size,
        )


def make_dev_attestation(podr2_pbk: bytes, chain_id: str = "dev") -> dict:
    """Fabricate an attestation dict under the dev chain's pinned fixture
    authority (chain_spec.dev_ias_authority) — what a real TEE obtains
    from Intel IAS, here minted locally for dev/local chains only."""
    import random

    from ..proof import ias
    from .chain_spec import dev_ias_authority

    _, root_priv = dev_ias_authority(chain_id)
    report_json = (
        b'{"isvEnclaveQuoteStatus":"OK","podr2_pbk":"'
        + podr2_pbk.hex().encode()
        + b'"}'
    )
    sign, cert_b64, report = ias.fixture_report(
        root_priv, report_json,
        random.Random(b"dev-tee-report" + podr2_pbk), bits=1024,
    )
    return {
        "report": report.hex(), "sign": sign.hex(), "cert": cert_b64.hex(),
    }
