"""Protocol state machines (SURVEY.md §7 L3-L4), the port's copy.

Deterministic, replayable re-designs of the reference pallets
(reference: c-pallets/*): every module is a plain-Python state machine
operating on a shared ChainState — no Substrate, no wasm — with the
cryptographic hot paths delegated to the port's ProofBackend seam
(cess_tpu_torch.proof) so batch work runs on the card.

Copies of `cess_tpu/chain/` bound to the port.  Three places reach
device or crypto code of the port: `node.py` (PoDR2, the RS stream, the
proof backend and IAS, on the `device` NodeSim is given), `runtime.py`
(IAS registration on the Runtime's `device`) and `offences.py` (host
BLS).  State hashes and checkpoint blobs equal the JAX package's.
"""
