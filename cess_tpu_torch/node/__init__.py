"""Node service layer (L5/L6): chain-spec genesis, signed-extrinsic
dispatch, block production, block sync + BLS-aggregate finality,
JSON-RPC over TCP, role clients, CLI.

Re-design of the reference node (reference: node/src/{service,rpc,cli,
command,chain_spec}.rs): the consensus-networking stack (libp2p,
GRANDPA gossip) is re-expressed over the newline-JSON-RPC wire —
signed extrinsics into a gossiped pool, wall-clock slot production
under provable BLS-VRF slot claims (consensus/: primary claims
below a stake threshold, secondary fallback, outputs accumulated into
epoch randomness), author-signed blocks announced and
deterministically re-executed at import (sync.py) with header ranges
batch-verified in one weighted pairing during catch-up, 2/3
BLS-aggregate justifications finalizing the chain, checkpoint
warp-sync for rejoining nodes, and separate role processes speaking
RPC — while the data-plane heavy lifting stays on the GPU backends
(proof/).

The port's copy of `cess_tpu/node/`: every module is bound to the port's
own chain, consensus, ops and proof packages.  Two places reach the card:
`NodeService(device=…)` hands its device to the Runtime, whose TEE
registration checks the IAS report's RSA signature there, and the role
clients' `answer_challenge` / `verify_missions` run the ProofBackend they
are given (TorchBackend: kernels K1–K4).  Block, vote and justification
wire forms, chain specs and store files equal the JAX package's."""

from .chain_spec import ChainSpec, dev_spec, local_spec
from .client import MinerClient, RpcClient, TeeClient, UserClient
from .faults import ChaosProfile, FaultInjector
from .metrics import (
    REGISTRY, Counter, Gauge, Histogram, LabeledCounter, Registry,
)
from .rpc import RpcServer
from .service import Extrinsic, NodeService, TxPool
from .sync import (
    Block,
    BlockImportError,
    Justification,
    SyncGap,
    SyncManager,
    Vote,
)

__all__ = [
    "ChainSpec", "dev_spec", "local_spec",
    "ChaosProfile", "FaultInjector",
    "RpcClient", "MinerClient", "TeeClient", "UserClient",
    "REGISTRY", "Counter", "Gauge", "Histogram", "LabeledCounter",
    "Registry",
    "RpcServer", "Extrinsic", "NodeService", "TxPool",
    "Block", "BlockImportError", "Justification", "SyncGap",
    "SyncManager", "Vote",
]
