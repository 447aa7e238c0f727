"""The read plane: stateless light clients + horizontally scalable
read replicas.

The validator loop serves consensus; this package serves READERS.  A
`LightClient` (light/client.py) holds only the genesis hash and an
initial validator keyset, and verifies everything else it learns —
finality justifications, era-boundary validator-set handoffs, and
storage reads — against proofs pulled over RPC.  A `ReplicaService`
(light/replica.py) is the keyless follower those clients talk to: it
batch-verifies justifications in one weighted pairing, maintains the
FINALIZED state commitment from per-block deltas, and serves read
proofs — replica count, not validator count, is the scaling knob for
the "millions of users" scenario.

The port's copy of `cess_tpu/light/`, bound to the port's node and chain.
"""

from .client import LightClient, LightClientError, StaleAnchorError
from .replica import FinalizedView, ReplicaService

__all__ = [
    "FinalizedView",
    "LightClient",
    "LightClientError",
    "ReplicaService",
    "StaleAnchorError",
]
