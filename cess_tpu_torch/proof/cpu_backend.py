"""CPU reference ProofBackend — the bit-exactness anchor.

Pure host Python over ops/podr2.py + ops/bls12_381.py.  Mirrors the role of
the reference's in-TEE Rust verifier (capability surface: reference
primitives/enclave-verify/src/lib.rs:230-235 verify_bls and the audit seam
at c-pallets/audit/src/lib.rs:484).
"""

from __future__ import annotations

from ..ops import podr2
from ..ops.podr2 import BatchItem, Podr2Params, Podr2Proof
from .backend import ProofBackend, ProveRequest, VerifyItem


class CpuBackend(ProofBackend):
    name = "cpu"

    def verify_batch(
        self,
        pk: bytes,
        items: list[VerifyItem],
        seed: bytes,
        params: Podr2Params,
    ) -> list[bool]:
        def batch_check(pk_, subset, seed_, params_):
            return podr2.batch_verify(
                pk_,
                [BatchItem(n, c, p) for n, c, p in subset],
                seed_,
                s=params_.s,
            )

        def single_check(pk_, item, params_):
            name, challenge, proof = item
            return podr2.verify(pk_, name, challenge, proof, s=params_.s)

        return self._verdicts_by_bisection(
            pk, items, seed, params, batch_check, single_check
        )

    def prove_batch(self, request: ProveRequest) -> list[Podr2Proof]:
        return [
            podr2.prove(tags, data, request.challenge, request.params)
            for tags, data in zip(request.tags, request.data)
        ]
