"""TEE worker (scheduler) registry with attestation at the gate.

Re-design of the reference tee-worker pallet (reference:
c-pallets/tee-worker/src/{lib,types}.rs): registration requires (a) the
sender to be the controller bonded to the claimed stash and (b) a valid
attestation report.  The first registered worker's PoDR2 public key becomes
the network-wide `TeePodr2Pk` every proof is verified against.

The attestation check is a pluggable verifier: the reference verifies Intel
IAS reports (X.509 chain to a pinned Intel root + RSA-PKCS1-SHA256 report
signature, reference: primitives/enclave-verify/src/lib.rs:135-219); this
port's equivalent lives in cess_tpu_torch.proof.ias (hosted X.509/DER parsing
+ batched RSA verify on the card), injected here so unit tests can
use a stub verifier.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .state import ChainState
from .types import AccountId, ensure

MOD = "tee_worker"


@dataclass
class SgxAttestationReport:
    """reference: tee-worker/src/types.rs:14-19"""

    report_json_raw: bytes
    sign: bytes
    cert_der: bytes


@dataclass
class TeeWorkerInfo:
    """reference: tee-worker/src/types.rs:6-12"""

    controller_account: AccountId
    peer_id: bytes
    node_key: bytes
    stash_account: AccountId


class TeeWorkerPallet:
    def __init__(
        self,
        state: ChainState,
        staking,
        credit_counter,
        cert_verifier: Callable[[bytes, bytes, bytes, bytes], bool] | None = None,
    ) -> None:
        self.state = state
        self.staking = staking
        self.credit_counter = credit_counter
        # verify(sign, cert_der, report_json, podr2_pbk) -> bool; the last
        # argument lets the verifier check the report BINDS the submitted
        # key (replay of someone else's valid attestation must fail).
        self.cert_verifier = cert_verifier
        self.tee_worker_map: dict[AccountId, TeeWorkerInfo] = {}
        self.tee_podr2_pk: bytes | None = None
        self.mr_enclave_whitelist: list[bytes] = []

    # ---------------------------------------------------------------- calls

    def register(
        self,
        sender: AccountId,
        stash_account: AccountId,
        node_key: bytes,
        peer_id: bytes,
        podr2_pbk: bytes,
        sgx_attestation_report: SgxAttestationReport,
    ) -> None:
        """reference: tee-worker/src/lib.rs:136-175"""
        controller = self.staking.bonded_controller(stash_account)
        ensure(controller is not None, MOD, "NotBond")
        ensure(controller == sender, MOD, "NotController")
        ensure(sender not in self.tee_worker_map, MOD, "AlreadyRegistration")
        if self.cert_verifier is not None:
            ensure(
                self.cert_verifier(
                    sgx_attestation_report.sign,
                    sgx_attestation_report.cert_der,
                    sgx_attestation_report.report_json_raw,
                    podr2_pbk,
                ),
                MOD,
                "VerifyCertFailed",
            )
        if len(self.tee_worker_map) == 0:
            self.tee_podr2_pk = podr2_pbk
        self.tee_worker_map[sender] = TeeWorkerInfo(
            controller_account=sender,
            peer_id=peer_id,
            node_key=node_key,
            stash_account=stash_account,
        )
        self.state.deposit_event(
            MOD, "RegistrationTeeWorker", acc=sender, peer_id=peer_id
        )

    def update_whitelist(self, mr_enclave: bytes) -> None:
        """Root call (reference: lib.rs:205-216)."""
        self.mr_enclave_whitelist.append(mr_enclave)

    def exit(self, sender: AccountId) -> None:
        """reference: lib.rs:219-233"""
        self.tee_worker_map.pop(sender, None)
        if len(self.tee_worker_map) == 0:
            self.tee_podr2_pk = None
        self.state.deposit_event(MOD, "Exit", acc=sender)

    # -- ScheduleFind trait (reference: lib.rs:273-307) -------------------

    def contains_scheduler(self, acc: AccountId) -> bool:
        return acc in self.tee_worker_map

    def punish_scheduler(self, acc: AccountId) -> None:
        worker = self.tee_worker_map.get(acc)
        ensure(worker is not None, MOD, "NonTeeWorker")
        self.staking.slash_scheduler(worker.stash_account)
        self.credit_counter.record_punishment(worker.stash_account)

    def get_first_controller(self) -> AccountId:
        for acc in self.tee_worker_map:
            return acc
        ensure(False, MOD, "NonTeeWorker")

    def get_controller_list(self) -> list[AccountId]:
        return list(self.tee_worker_map)
