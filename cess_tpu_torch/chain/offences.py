"""Offences pallet: portable misbehavior evidence → deferred slashing.

Role match: the reference wires `pallet_im_online` + `pallet_offences`
+ `pallet_session::historical` into its runtime (reference:
runtime/src/lib.rs:1509-1527) so that

 * a validator proven to have EQUIVOCATED (two signatures over
   conflicting consensus payloads at one height/slot) loses bonded
   stake and is chilled — GRANDPA's accountable-safety contract
   (Stewart & Kokoris-Kogias 2020: equivocation evidence must feed an
   on-chain slashing pipeline, PAPERS.md);
 * a validator that stays SILENT for a whole session (no signed
   im-online heartbeat) is chilled out of the next election and its
   scheduler credit punished — the offline-stake tolerance Ouroboros
   Praos requires of stake-weighted leader election (David et al.
   2018, PAPERS.md).

This pallet owns both capabilities for the framework's deterministic
runtime:

  evidence     `OffenceReport` is a PORTABLE, independently
               re-verifiable proof: two (payload, signature) pairs
               over conflicting consensus payloads, re-checked by
               `verify_report` on EVERY replica before anything is
               queued — one honest observer convicts everywhere, and
               a forged or replayed report is a deterministic no-op.
  registry     reports are deduplicated by (kind, offender, session):
               at most one conviction per offender per kind per
               session, no matter how many honest reporters race.
  heartbeats   `heartbeat` is a signed per-session extrinsic submitted
               by each authority's offchain worker (node/service.py);
               the end-of-session sweep (`session_sweep`, registered
               as a session observer) reports every authority that
               never checked in.  A session with ZERO heartbeats is
               skipped — header-less sims and single-node dev chains
               never run the OCW and must not chill their whole set.
  deferral     convictions queue in `pending` and apply at the ERA
               boundary (`apply_pending`, called by session.py just
               before the election) in sorted order, so every replica
               applies the same slashes in the same block — and the
               election that follows already sees the chills.

Severity schedule (docs/offences.md):

  equivocation    slash `5% · 2^strikes` of the offender's bonded
                  stake (capped at 100%; `strikes` counts the
                  offender's prior equivocation convictions) into the
                  treasury pot, plus a 2-era chill.
  unresponsive    no slash; 1-era chill + one scheduler-credit
                  punishment (the im-online "chill only" mode the
                  reference runs with, lib.rs:1509).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from .session import HISTORY_DEPTH_SESSIONS
from .state import ChainState
from .types import AccountId, ensure

MOD = "offences"

KIND_VOTE_EQUIV = "equivocation.vote"
KIND_BLOCK_EQUIV = "equivocation.block"
KIND_UNRESPONSIVE = "unresponsive"
EVIDENCE_KINDS = (KIND_VOTE_EQUIV, KIND_BLOCK_EQUIV)

# Base equivocation slash, doubled per prior conviction of the same
# offender (5 → 10 → 20 → … → 100%).
EQUIVOCATION_SLASH_PERCENT = 5
# Eras the offender sits out of the election after conviction (the
# first era it may `validate` again is active_era + 1 + chill_eras).
CHILL_ERAS_EQUIVOCATION = 2
CHILL_ERAS_UNRESPONSIVE = 1
# Evidence older than this many sessions is refused, and applied
# records older than it are pruned.  Derived from the session pallet's
# historical depth (single source of truth) minus one: at session
# index i the pallet has already pruned set i-DEPTH, so the oldest
# session whose membership is still provable is i-(DEPTH-1).
REPORT_HISTORY_SESSIONS = HISTORY_DEPTH_SESSIONS - 1
# Evidence may also name a slightly FUTURE height (a double-vote for an
# upcoming finality boundary is proven the moment both signatures
# exist); membership for future sessions is checked against the live
# set.  Bounded so nonsense heights stay refusable.
FUTURE_SESSION_SLACK = 2


# ------------------------------------------------------------ evidence


@dataclass
class OffenceReport:
    """A portable offence proof: two (payload_hex, sig_hex) pairs over
    conflicting consensus payloads, both signed by `offender`.  The
    payloads are the exact canonical-JSON bytes the node layer signs
    (node/sync.py finality_payload / Block.signing_payload), so any
    replica can re-verify the report with nothing but the offender's
    registered BLS key — the report is the proof."""

    kind: str
    offender: AccountId
    session: int
    evidence: list = field(default_factory=list)  # [[payload_hex, sig_hex], …]

    def key(self) -> tuple:
        return (self.kind, self.offender, self.session)

    def digest(self) -> str:
        h = hashlib.blake2b(digest_size=16)
        for pair in sorted(tuple(p) for p in self.evidence):
            for part in pair:
                h.update(str(part).encode() + b"\x00")
        return h.hexdigest()

    def to_json(self) -> dict:
        return {
            "kind": self.kind, "offender": self.offender,
            "session": self.session,
            "evidence": [list(p) for p in self.evidence],
        }

    @classmethod
    def from_json(cls, d: dict) -> "OffenceReport":
        return cls(
            kind=str(d["kind"]), offender=str(d["offender"]),
            session=int(d["session"]),
            evidence=[[str(p), str(s)] for p, s in d["evidence"]],
        )


def _decode_evidence(report: OffenceReport):
    """evidence → [(payload bytes, sig bytes, parsed payload list), …]
    or None when anything is malformed."""
    if len(report.evidence) != 2:
        return None
    out = []
    for pair in report.evidence:
        if len(pair) != 2:
            return None
        try:
            payload = bytes.fromhex(pair[0])
            sig = bytes.fromhex(pair[1])
            parsed = json.loads(payload)
        except (ValueError, TypeError):
            return None
        if not isinstance(parsed, list):
            return None
        out.append((payload, sig, parsed))
    return out


def evidence_height(report: OffenceReport) -> int | None:
    """The chain height both payloads name (index 2 of the finality AND
    block signing payloads) — the anchor that pins the report to a
    session deterministically on every replica."""
    decoded = _decode_evidence(report)
    if decoded is None:
        return None
    n = decoded[0][2][2] if len(decoded[0][2]) > 2 else None
    return n if isinstance(n, int) else None


def verify_report(report: OffenceReport, genesis: str, key_lookup) -> bool:
    """Full independent re-verification — the gate every replica runs
    before an offence enters the registry:

      * exactly two DISTINCT payloads, both on OUR chain (genesis
        prefix) and of the kind claimed;
      * vote equivocation: two finality payloads for the SAME height
        and DIFFERENT block hashes;
      * block equivocation: two header payloads for the SAME slot,
        both naming the offender as author;
      * both signatures verify under the offender's registered key.

    Anything else — forged signatures, stolen payload pairs, evidence
    for another chain, same-payload "conflicts" — returns False, so an
    unverifiable report is a no-op on every replica (the acceptance
    regression in tests/test_offences.py)."""
    from ..ops import bls12_381 as bls

    if report.kind not in EVIDENCE_KINDS:
        return False
    pk = key_lookup(report.offender)
    if pk is None:
        return False
    decoded = _decode_evidence(report)
    if decoded is None:
        return False
    (p1, s1, j1), (p2, s2, j2) = decoded
    if p1 == p2:
        return False
    if report.kind == KIND_VOTE_EQUIV:
        # node/sync.py finality_payload: [genesis, "finality", n, hash]
        for j in (j1, j2):
            if len(j) != 4 or j[0] != genesis or j[1] != "finality":
                return False
            if not isinstance(j[2], int):
                return False
        if j1[2] != j2[2] or j1[3] == j2[3]:
            return False
    else:
        # node/sync.py Block.signing_payload: [genesis, "block", n,
        # slot, parent, author, ext_root, state, vrf_out, vrf_proof]
        for j in (j1, j2):
            if len(j) != 10 or j[0] != genesis or j[1] != "block":
                return False
            if not isinstance(j[2], int) or not isinstance(j[3], int):
                return False
            if j[5] != report.offender:
                return False
        if j1[3] != j2[3]:
            return False  # different slots: not an equivocation
    return bls.verify(pk, p1, s1) and bls.verify(pk, p2, s2)


# ------------------------------------------------------------ registry


@dataclass
class OffenceRecord:
    """One registry entry: the conviction bookkeeping that travels in
    the state (checkpoint blob v4)."""

    kind: str
    offender: AccountId
    session: int
    digest: str
    reporter: AccountId
    applied: bool = False


class OffencesPallet:
    def __init__(self, state: ChainState, staking, scheduler_credit) -> None:
        self.state = state
        self.staking = staking
        self.scheduler_credit = scheduler_credit
        # Wired by the Runtime after SessionPallet exists (mutual refs).
        self.session = None
        # Injected by the node layer: report → bool, closing over the
        # node's genesis hash and key registry.  Wiring, never state —
        # a runtime without one REFUSES every evidence report.
        self.evidence_verifier = None
        # (kind, offender, session) → OffenceRecord — the dedup + audit
        # trail; `pending` queues keys for the era-boundary application.
        self.reports: dict[tuple, OffenceRecord] = {}
        self.pending: list = []
        # session index → authorities that heartbeat that session
        self.heartbeats: dict[int, set] = {}
        # offender → prior equivocation convictions (escalation input)
        self.strikes: dict[AccountId, int] = {}

    def known(self, key: tuple) -> bool:
        return tuple(key) in self.reports

    # ------------------------------------------------------ heartbeats

    def heartbeat(self, sender: AccountId, session_index) -> None:
        """Signed im-online heartbeat (reference: im-online
        lib.rs:342-359): one per authority per session, only for the
        CURRENT session — the nonce gate already blocks replays, this
        gate blocks hoarding heartbeats for future sessions."""
        ensure(self.session is not None, MOD, "NoSession")
        ensure(isinstance(session_index, int), MOD, "BadSessionIndex")
        ensure(
            sender in self.staking.validators, MOD, "NotAnAuthority"
        )
        ensure(
            session_index == self.session.session_index, MOD,
            "StaleHeartbeat",
        )
        beats = self.heartbeats.setdefault(session_index, set())
        ensure(sender not in beats, MOD, "DuplicateHeartbeat")
        beats.add(sender)
        self.state.deposit_event(
            MOD, "Heartbeat", who=sender, session=session_index
        )

    def session_sweep(self, ending_index: int, ending_validators) -> None:
        """End-of-session liveness sweep (session observer): every
        active authority with no heartbeat for the ended session is
        reported unresponsive — but ONLY when at least HALF the ending
        set did heartbeat.  A mostly-silent session means the NETWORK
        (or this fork) was degraded, not the validators: chilling on
        such evidence collapses the authority set to whoever's
        heartbeats happened to land and turns a transient partition
        into a permanent one.  The zero-heartbeat case also covers
        runtimes that never run the heartbeat OCW (header-less sims,
        single-node dev): they must not chill their own set."""
        beats = self.heartbeats.get(ending_index, set())
        present = sum(1 for v in ending_validators if v in beats)
        if present and 2 * present >= len(ending_validators):
            for v in ending_validators:
                if v not in beats:
                    self.report_unresponsive(v, ending_index)
        for s in [s for s in self.heartbeats if s <= ending_index]:
            del self.heartbeats[s]

    # ------------------------------------------------------ reporting

    def report_unresponsive(self, offender: AccountId, session: int) -> None:
        """Internal intake for the sweep: derived purely from on-chain
        heartbeat state, so every replica reports identically.  Not
        reachable through an extrinsic — silence cannot be forged."""
        key = (KIND_UNRESPONSIVE, offender, session)
        if key in self.reports:
            return
        digest = hashlib.blake2b(
            b"offences/silent" + offender.encode()
            + session.to_bytes(8, "little"),
            digest_size=16,
        ).hexdigest()
        self._enqueue(OffenceRecord(
            kind=KIND_UNRESPONSIVE, offender=offender, session=session,
            digest=digest, reporter="",
        ))

    def report_offence(self, sender: AccountId, report_json: dict) -> None:
        """Extrinsic intake for evidence-backed offences (the
        offences::report role).  Every check is deterministic on-chain
        state plus the independent evidence re-verification, so a
        forged, mis-sessioned, unslashable, or duplicate report fails
        with the SAME receipt on every replica."""
        try:
            report = OffenceReport.from_json(report_json)
        except (KeyError, TypeError, ValueError):
            ensure(False, MOD, "MalformedReport")
        ensure(report.kind in EVIDENCE_KINDS, MOD, "UnknownOffenceKind")
        ensure(self.session is not None, MOD, "NoSession")
        ensure(
            self.evidence_verifier is not None
            and self.evidence_verifier(report),
            MOD, "UnverifiableEvidence",
        )
        height = evidence_height(report)
        ensure(height is not None, MOD, "MalformedReport")
        ensure(
            report.session == self.session.session_of_block(height),
            MOD, "WrongSession",
        )
        current = self.session.session_index
        ensure(
            report.session - current <= FUTURE_SESSION_SLACK
            and current - report.session <= REPORT_HISTORY_SESSIONS,
            MOD, "SessionOutOfRange",
        )
        # membership: historical set for past sessions, the LIVE set
        # for the current/near-future ones (a double-vote for an
        # upcoming boundary is proven before its session starts)
        members = self.session.validators_at(min(report.session, current))
        ensure(
            members is not None and report.offender in members,
            MOD, "NotAValidatorThen",
        )
        ensure(report.offender in self.staking.ledger, MOD, "NothingToSlash")
        ensure(report.key() not in self.reports, MOD, "DuplicateOffence")
        self._enqueue(OffenceRecord(
            kind=report.kind, offender=report.offender,
            session=report.session, digest=report.digest(),
            reporter=sender,
        ))

    def _enqueue(self, rec: OffenceRecord) -> None:
        key = (rec.kind, rec.offender, rec.session)
        self.reports[key] = rec
        self.pending.append(key)
        self.state.deposit_event(
            MOD, "OffenceReported", kind=rec.kind, offender=rec.offender,
            session=rec.session, digest=rec.digest,
        )

    # ------------------------------------------------------ application

    def apply_pending(self) -> int:
        """Era-boundary conviction pass (called by session.py BEFORE
        staking.end_era and the election, so the election that follows
        already excludes the chilled).  Sorted key order makes the
        application sequence — and therefore every balance — identical
        on every replica regardless of report arrival order.  Returns
        the number of offences applied."""
        applied = 0
        for key in sorted(set(tuple(k) for k in self.pending)):
            rec = self.reports.get(key)
            if rec is None or rec.applied:
                continue
            if rec.kind in EVIDENCE_KINDS:
                strikes = self.strikes.get(rec.offender, 0)
                percent = min(100, EQUIVOCATION_SLASH_PERCENT << strikes)
                self.strikes[rec.offender] = strikes + 1
                slashed = self.staking.slash_offender(rec.offender, percent)
                self.staking.force_chill(
                    rec.offender,
                    self.staking.active_era + 1 + CHILL_ERAS_EQUIVOCATION,
                )
                self.state.deposit_event(
                    MOD, "OffenderSlashed", offender=rec.offender,
                    kind=rec.kind, amount=slashed, percent=percent,
                )
            else:
                self.staking.force_chill(
                    rec.offender,
                    self.staking.active_era + 1 + CHILL_ERAS_UNRESPONSIVE,
                )
                controller = self.staking.bonded.get(
                    rec.offender, rec.offender
                )
                self.scheduler_credit.record_punishment(controller)
                self.state.deposit_event(
                    MOD, "OffenderChilled", offender=rec.offender,
                    session=rec.session,
                )
            rec.applied = True
            applied += 1
        self.pending = []
        # Applied records past the evidence-acceptance horizon can
        # never be re-reported (SessionOutOfRange) — prune them so the
        # registry stays bounded on long chains.  Records AT the
        # horizon must survive: report_offence still accepts that
        # session, so pruning it would let a stored old report convict
        # the same offender twice.
        if self.session is not None:
            horizon = self.session.session_index - REPORT_HISTORY_SESSIONS
            if horizon > 0:
                self.reports = {
                    k: r for k, r in self.reports.items()
                    if not r.applied or r.session >= horizon
                }
        return applied
