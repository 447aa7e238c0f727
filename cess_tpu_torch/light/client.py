"""Stateless finality-verifying light client.

A `LightClient` trusts exactly two things: the genesis hash and an
initial validator BLS keyset (both derivable from the chain spec —
ChainSpec.genesis_hash / validator_keys).  Everything else is verified,
never believed:

 * **Finality.**  It pulls the latest justification over
   `chain_getJustification`, fetches the covered HEADER over
   `light_syncHeaders`, recomputes the block hash from the header
   bytes (sync.header_hash — the body rides as its extRoot
   commitment), and checks the 2/3 BLS aggregate against its tracked
   keyset (sync.verify_justification).  Only then does the header's
   state root become an anchor.

 * **Validator-set handoffs.**  At every new anchor the NEXT tracked
   set is read out of the just-justified state itself: one
   `state_getProofBatch` round trip proves `staking:validators` and
   `session:keys` against the anchored root, and a validator that is
   neither in the proven session-key registry nor already tracked
   refuses the handoff — the set evolves with zero trust extension.

 * **Reads.**  `read`/`read_batch` prove N keys in one round trip and
   check every wire against the client's OWN anchored root
   (checkpoint.verify_read_batch) — the server's claimed root is never
   trusted.  A replica whose finalized view moved past the anchor
   answers the typed -32014; the client re-anchors once and retries.

The client keeps no chain state: no blocks, no trie, no database —
(genesis, anchor, keyset) is the whole client, which is what lets a
replica fleet serve arbitrarily many of them (light/replica.py).
"""

from __future__ import annotations

from ..chain import checkpoint, smt
from ..node.rpc import RpcError, rpc_call
from ..node.sync import Justification, header_hash, verify_justification

# Root-mismatch RPC code (state_getProofBatch): the replica's finalized
# view advanced past the pinned anchor — re-anchor and retry.
ROOT_MISMATCH = -32014


class LightClientError(Exception):
    """A proof, header, or justification failed verification — or the
    server could not serve one.  Nothing is adopted on this path."""


class StaleAnchorError(LightClientError):
    """The server finalized PAST the anchor being adopted mid-handshake
    (typed -32014 on the handoff read) — a liveness race, not an
    attack: re-syncing lands on the newer justification."""


class LightClient:
    """See module docstring.  `keys` maps validator name → BLS public
    key bytes; the tracked set after N handoffs may differ from it."""

    def __init__(
        self,
        genesis: str,
        keys: dict[str, bytes],
        host: str = "127.0.0.1",
        port: int = 9944,
        timeout: float = 10.0,
    ) -> None:
        if not keys:
            raise ValueError("light client needs an initial keyset")
        self.genesis = genesis
        self.keys = dict(keys)
        self.host = host
        self.port = port
        self.timeout = timeout
        # The justified anchor: {"number", "hash", "root"} — the ONE
        # commitment reads verify against.  None until the first sync.
        self.anchor: dict | None = None
        # telemetry counters (the load generator sums these)
        self.justifications_verified = 0
        self.handoffs = 0

    @classmethod
    def from_spec(cls, spec, host: str = "127.0.0.1", port: int = 9944,
                  timeout: float = 10.0) -> "LightClient":
        return cls(spec.genesis_hash(), spec.validator_keys(),
                   host=host, port=port, timeout=timeout)

    # ------------------------------------------------------------ wire

    def _call(self, method: str, *params):
        return rpc_call(self.host, self.port, method, list(params),
                        timeout=self.timeout)

    # ------------------------------------------------------ finality

    def sync(self, _retried: bool = False) -> dict:
        """Advance the anchor to the server's latest justification and
        return it.  Raises LightClientError when the server serves
        nothing newer, a forged/stale justification, or a handoff that
        does not prove out.  Retries ONCE when the server finalizes
        past the anchor mid-handshake (StaleAnchorError — a race on a
        live chain, not a refusal)."""
        try:
            wire = self._call("chain_getJustification", None)
            just = Justification.from_json(wire)
        except (RpcError, OSError) as e:
            raise LightClientError(f"no justification served: {e}")
        except (KeyError, TypeError, ValueError) as e:
            raise LightClientError(f"malformed justification: {e!r}")
        if self.anchor is not None:
            if (just.number == self.anchor["number"]
                    and just.block_hash == self.anchor["hash"]):
                return self.anchor  # already anchored there
            if just.number <= self.anchor["number"]:
                # a server must never serve finality that rewinds the
                # client — same height with a different hash would be
                # conflicting 2/3 quorums (accountable-safety violation)
                raise LightClientError(
                    f"server finality at #{just.number} is behind or "
                    f"conflicts with anchor #{self.anchor['number']}")
        try:
            self._adopt(just)
        except StaleAnchorError:
            if _retried:
                raise
            return self.sync(_retried=True)
        return self.anchor

    def _adopt(self, just: Justification) -> None:
        hdrs = self._call("light_syncHeaders", just.number, 1)
        if not isinstance(hdrs, list) or not hdrs:
            raise LightClientError(
                f"no header served for justified #{just.number}")
        hdr = hdrs[0].get("header") if isinstance(hdrs[0], dict) else None
        try:
            got_hash = header_hash(self.genesis, hdr)
            number = int(hdr["number"])
            root = str(hdr["stateHash"])
        except (KeyError, TypeError, ValueError) as e:
            raise LightClientError(f"malformed header: {e!r}")
        if number != just.number or got_hash != just.block_hash:
            raise LightClientError(
                "served header does not hash to the justified block")
        if not verify_justification(
            just, self.genesis, list(self.keys), self.keys
        ):
            raise LightClientError(
                "justification refused: forged aggregate, sub-quorum, "
                "or signers outside the tracked set")
        self.justifications_verified += 1
        # era handoff BEFORE adopting: a root whose validator set we
        # cannot prove is not an anchor
        self._handoff(root)
        self.anchor = {
            "number": just.number, "hash": just.block_hash, "root": root,
        }

    def _handoff(self, root: str) -> None:
        """Refresh the tracked keyset from the just-justified state:
        `staking:validators` names the set, `session:keys` proves each
        member's registered key.  A member with neither a proven
        session key nor an already-tracked key refuses the WHOLE
        handoff — adopting an unprovable key would extend trust."""
        reads = [("staking", "validators", None), ("session", "keys", None)]
        try:
            (ok_v, validators), (ok_k, skeys) = self._proven_reads(
                root, reads)
        except RpcError as e:
            # -32014 here means the server finalized past this anchor
            # between serving the justification and the handoff read —
            # refuse the adoption; sync() retries onto the newer one
            if e.code == ROOT_MISMATCH:
                raise StaleAnchorError(f"anchor superseded mid-sync: {e}")
            raise LightClientError(f"handoff reads refused: {e}")
        if not ok_v or not isinstance(validators, list) or not validators:
            raise LightClientError(
                "validator set unreadable at the justified root")
        if not ok_k or not isinstance(skeys, dict):
            skeys = {}
        new: dict[str, bytes] = {}
        for name in validators:
            name = str(name)
            key = skeys.get(name)
            if not isinstance(key, bytes):
                key = self.keys.get(name)
            if not isinstance(key, bytes):
                raise LightClientError(
                    f"handoff refused: validator {name!r} has no "
                    "provable session key and is not tracked")
            new[name] = key
        if new != self.keys:
            self.handoffs += 1
            self.keys = new

    # --------------------------------------------------------- reads

    def read(self, pallet: str, attr: str, key=None) -> tuple[bool, object]:
        """One verified read at the anchored root: (present, value)."""
        return self.read_batch([(pallet, attr, key)])[0]

    def read_batch(
        self, reads: list[tuple], _retried: bool = False
    ) -> list[tuple[bool, object]]:
        """N verified reads in ONE RPC round trip, every proof checked
        against the client's own justified anchor root.  Re-anchors
        once on the typed root-mismatch refusal (the replica finalized
        past our anchor), then retries."""
        norm = [
            (r[0], r[1], r[2] if len(r) == 3 else None)
            for r in (tuple(r) for r in reads)
        ]
        if self.anchor is None:
            self.sync()
        try:
            return self._proven_reads(self.anchor["root"], norm)
        except RpcError as e:
            if e.code == ROOT_MISMATCH and not _retried:
                self.sync()
                return self.read_batch(norm, _retried=True)
            raise LightClientError(f"batch refused: {e}")

    def _proven_reads(
        self, root: str, reads: list[tuple[str, str, object]]
    ) -> list[tuple[bool, object]]:
        got = self._call(
            "state_getProofBatch",
            [[p, a, k] for p, a, k in reads], root,
        )
        proofs = got.get("proofs") if isinstance(got, dict) else None
        if not isinstance(proofs, list) or len(proofs) != len(reads):
            raise LightClientError("malformed proof batch reply")
        try:
            return checkpoint.verify_read_batch(
                root, reads, [p["proof"] for p in proofs]
            )
        except smt.ProofError as e:
            raise LightClientError(
                f"proof does not commit to the justified root: {e}")
        except (KeyError, TypeError, ValueError) as e:
            raise LightClientError(f"malformed proof wire: {e!r}")
