"""End-to-end span tracing: where did block #N spend its time?

The reference node threads a telemetry worker through every subsystem
(reference: node/src/service.rs:151,185,309,376,529) and its tracing
spans answer per-stage timing questions.  This is that seam for the
framework: lightweight span trees — (trace id, span id, parent id,
name, tags, wall-clock) — collected into a bounded ring buffer per
node and served over RPC (`system_traces`) and the CLI (`trace`).

The load-bearing property is **cross-node stitching**: a trace id is
minted once, at extrinsic intake or block authorship, and travels with
the block through the gossip announce envelope and the catch-up RPC
responses (node/sync.py).  The importing node adopts the author's
trace id, so one block's life — author → gossip → import (sig batch,
re-execution, fork choice) → finality vote → justification — is a
SINGLE trace whose spans live on different nodes; the fleet reporter
(tools/telemetry_report.py) merges the per-node rings by trace id.

Trace ids ride OUTSIDE the signed block payload (they are telemetry,
not consensus): a peer that strips or garbles one costs observability,
never validity — the importer just mints a fresh id.

Overhead contract: starting+finishing a span is two perf_counter calls
plus one deque append under a lock — single-digit microseconds,
measured by the overhead guard in tests/test_telemetry.py so always-on
instrumentation stays invisible next to the ~0.4 s pairings it wraps.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field

# Finished spans kept per node.  At soak cadence (~10 spans/block,
# sub-second blocks) this covers the last several minutes — enough for
# the reporter to stitch recent blocks without unbounded memory.
TRACE_RING_SPANS = 4096


def mint_trace_id() -> str:
    """16-hex-char random trace id (os.urandom — uniqueness across
    nodes matters, determinism does not: trace ids are telemetry)."""
    return os.urandom(8).hex()


def valid_trace_id(value) -> bool:
    """Shape check for PEER-SUPPLIED trace ids (announce/catch-up
    envelopes): exactly the 16-hex mint format.  The field is
    unauthenticated, so anything else — oversized strings a hostile
    peer wants stored and re-served, non-hex garbage — is discarded
    and the importer mints its own id."""
    return (
        isinstance(value, str)
        and len(value) == 16
        and all(c in "0123456789abcdef" for c in value)
    )


@dataclass
class Span:
    """One timed operation.  `start` is wall-clock epoch seconds (so
    spans from different nodes order on a shared axis); `duration` is
    perf_counter-measured elapsed seconds."""

    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    node: str
    start: float
    duration: float = 0.0
    tags: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "node": self.node,
            "start": self.start,
            "durationMs": round(self.duration * 1000.0, 3),
            "tags": dict(self.tags),
        }

    @classmethod
    def from_json(cls, d: dict) -> "Span":
        return cls(
            trace_id=str(d["traceId"]), span_id=str(d["spanId"]),
            parent_id=d.get("parentId"), name=str(d["name"]),
            node=str(d.get("node", "")), start=float(d["start"]),
            duration=float(d.get("durationMs", 0.0)) / 1000.0,
            tags=dict(d.get("tags", {})),
        )


class Tracer:
    """Per-node span collector.  Thread-safe; nesting is tracked with a
    per-thread span stack so `with tracer.span(...)` inside another
    span becomes its child automatically (the RPC handler threads, the
    authoring loop, and the gossip workers each get their own stack)."""

    def __init__(self, node: str = "", max_spans: int = TRACE_RING_SPANS):
        self.node = node
        self._lock = threading.Lock()
        self._ring: deque[Span] = deque(maxlen=max_spans)
        self._tls = threading.local()
        self._counter = 0

    # ------------------------------------------------------ recording

    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _next_span_id(self) -> str:
        with self._lock:
            self._counter += 1
            return f"{self.node or 'n'}-{self._counter:x}"

    @contextmanager
    def span(self, name: str, trace: str | None = None,
             tags: dict | None = None):
        """Open a span; on exit it is timed and recorded.  `trace` pins
        the trace id (a propagated one from a peer envelope); otherwise
        the enclosing span's id is inherited, and a root span with no
        context mints a fresh trace."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(
            trace_id=trace or (parent.trace_id if parent else None)
            or mint_trace_id(),
            span_id=self._next_span_id(),
            parent_id=parent.span_id if parent else None,
            name=name,
            node=self.node,
            start=time.time(),
            tags=dict(tags) if tags else {},
        )
        t0 = time.perf_counter()
        stack.append(s)
        try:
            yield s
        finally:
            s.duration = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                self._ring.append(s)

    def event(self, name: str, trace: str | None = None,
              tags: dict | None = None, duration: float = 0.0) -> Span:
        """Record a point span (no enter/exit pair): accepted votes,
        finalizations — things that happen rather than take time."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        s = Span(
            trace_id=trace or (parent.trace_id if parent else None)
            or mint_trace_id(),
            span_id=self._next_span_id(),
            parent_id=parent.span_id if parent else None,
            name=name,
            node=self.node,
            start=time.time(),
            duration=duration,
            tags=dict(tags) if tags else {},
        )
        with self._lock:
            self._ring.append(s)
        return s

    def current_trace(self) -> str | None:
        """Trace id of the innermost open span on this thread."""
        stack = self._stack()
        return stack[-1].trace_id if stack else None

    # ------------------------------------------------------ queries

    def spans(self, trace_id: str | None = None,
              limit: int = TRACE_RING_SPANS) -> list[Span]:
        with self._lock:
            snap = list(self._ring)
        if trace_id is not None:
            snap = [s for s in snap if s.trace_id == trace_id]
        return snap[-limit:]

    def traces(self, limit: int = 32) -> list[dict]:
        """Most-recent trace summaries: id, root name, span count,
        earliest start, total recorded duration."""
        with self._lock:
            snap = list(self._ring)
        by_trace: dict[str, list[Span]] = {}
        for s in snap:
            by_trace.setdefault(s.trace_id, []).append(s)
        out = []
        for tid, spans in by_trace.items():
            roots = [s for s in spans if s.parent_id is None]
            root = min(roots or spans, key=lambda s: s.start)
            out.append({
                "traceId": tid,
                "root": root.name,
                "tags": dict(root.tags),
                "spans": len(spans),
                "start": min(s.start for s in spans),
                "durationMs": round(
                    sum(s.duration for s in spans) * 1000.0, 3),
            })
        out.sort(key=lambda t: t["start"])
        return out[-limit:]


def render_trace(spans: list[Span | dict]) -> str:
    """ASCII span tree for one stitched trace (the CLI `trace` view).
    Accepts Span objects or their JSON dicts — the CLI feeds it
    `system_traces` responses merged from several nodes."""
    objs = [s if isinstance(s, Span) else Span.from_json(s) for s in spans]
    if not objs:
        return "(no spans)"
    objs.sort(key=lambda s: s.start)
    by_id = {s.span_id: s for s in objs}
    children: dict[str | None, list[Span]] = {}
    for s in objs:
        parent = s.parent_id if s.parent_id in by_id else None
        children.setdefault(parent, []).append(s)
    t0 = min(s.start for s in objs)
    lines = [f"trace {objs[0].trace_id}"]

    def walk(parent: str | None, depth: int) -> None:
        for s in children.get(parent, []):
            tags = " ".join(f"{k}={v}" for k, v in sorted(s.tags.items()))
            lines.append(
                f"  {'  ' * depth}+{(s.start - t0) * 1000.0:8.1f}ms "
                f"{s.name:<24} {s.duration * 1000.0:9.2f}ms "
                f"[{s.node}]" + (f" {tags}" if tags else "")
            )
            walk(s.span_id, depth + 1)

    walk(None, 0)
    return "\n".join(lines)
