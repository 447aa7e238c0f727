"""Fleet telemetry reporter of the PyTorch port: scrape N nodes, emit one report.

The port's counterpart of tools/telemetry_report.py, bound to
`cess_tpu_torch.node.metrics` and `cess_tpu_torch.node.rpc`, with the
same report keys and markdown.  It polls `system_health` over a window
for rate and lag series, then scrapes `system_metrics` (Prometheus text,
parsed by node/metrics.parse_exposition) and `system_traces` once at the
end, and renders a single JSON + markdown artifact:

  * blocks/s and extrinsics/s over the window (fleet-level),
  * finality lag p50/p95 (per node, sampled),
  * block import stage histograms (sig batch / re-execution /
    snapshot) per node,
  * gossip drop totals per node (partition visibility),
  * per-proof verify ms + per-stage breakdown from the proof data
    plane's always-on histograms (the port's process-wide
    `proof/torch_backend.py::proof_stage_registry`), merged from the
    nodes and any local in-process registries (a TEE that verifies in
    the caller's process keeps its per-proof histograms there),
  * stitched-trace inventory (how many block traces span >1 node).

Host code only: the nodes may be the port's or the JAX package's (the
RPC and exposition forms are the same).  Used two ways: as a CLI —

    python tools/torch_telemetry_report.py --nodes 127.0.0.1:9944,... \
        --duration 30 --out-json report.json --out-md report.md

— and as a library by chip_smoke.py's phase 8-node, which samples its
network of validators and a replica.  Imports neither jax nor cess_tpu.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cess_tpu_torch.node import metrics as m  # noqa: E402
from cess_tpu_torch.node.rpc import RpcError, rpc_call  # noqa: E402


def percentile(series: list[float], q: float) -> float:
    """Nearest-rank percentile over a sample series (0 when empty)."""
    if not series:
        return 0.0
    ordered = sorted(series)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def histogram_summary(fam: m.MetricFamily) -> dict:
    """{count, mean_ms, p50_ms, p95_ms} estimated from exposition
    buckets (upper-bound attribution, the standard Prometheus
    histogram_quantile shape)."""
    h = fam.histogram()
    count = h["count"]
    if not count:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0}

    finite = [le for le, _ in h["buckets"] if le != float("inf")]
    top = finite[-1] * 1000.0 if finite else 0.0

    def est(q: float) -> float:
        rank = q * count
        for le, cumulative in h["buckets"]:
            if cumulative >= rank:
                # rank in the +Inf bucket clamps to the largest finite
                # bound (the prometheus histogram_quantile convention)
                # — NOT zero, which would under-report exactly when
                # latencies are worst
                return top if le == float("inf") else le * 1000.0
        return top

    return {
        "count": int(count),
        "mean_ms": round(h["sum"] / count * 1000.0, 3),
        "p50_ms": est(0.50),
        "p95_ms": est(0.95),
    }


class FleetCollector:
    """Samples a fleet over a window, then builds the report."""

    IMPORT_STAGES = ("sig_batch", "execute", "snapshot")
    PROOF_STAGES = ("host_prep", "u_fold", "sigma_fold",
                    "chunk_program", "dispatch_wait", "pairing")

    def __init__(self, nodes: list[tuple[str, int]], timeout: float = 5.0):
        self.nodes = list(nodes)
        self.timeout = timeout
        self.t_start = time.time()
        self.samples: dict[str, list[dict]] = {
            self._label(n): [] for n in self.nodes
        }
        # extrinsic counters are cumulative from node start: snapshot
        # them at collector construction so the report's extrinsics/s
        # is a WINDOW delta, not lifetime-total / window
        self._ext_base: dict[str, float] = {}
        for node in self.nodes:
            try:
                fams = m.parse_exposition(
                    self._call(node, "system_metrics"))
                self._ext_base[self._label(node)] = fams.get(
                    "cess_extrinsics_applied", m.MetricFamily("")
                ).value()
            except (OSError, RpcError, ValueError):
                pass

    @staticmethod
    def _label(node: tuple[str, int]) -> str:
        return f"{node[0]}:{node[1]}"

    def _call(self, node, method, params=None):
        return rpc_call(node[0], node[1], method, params or [],
                        timeout=self.timeout)

    def sample(self) -> None:
        """One cheap poll per node: health + head/finality numbers.
        Unreachable nodes are skipped (mid-restart under chaos)."""
        now = time.time()
        for node in self.nodes:
            try:
                health = self._call(node, "system_health")
            except (OSError, RpcError, ValueError):
                continue
            self.samples[self._label(node)].append(
                {"t": now, "health": health}
            )

    # ------------------------------------------------------ report

    def _scrape_full(self, node) -> dict:
        out: dict = {}
        for key, method in (("metrics", "system_metrics"),
                            ("traces", "system_traces")):
            try:
                out[key] = self._call(node, method)
            except (OSError, RpcError, ValueError):
                out[key] = None
        if out.get("metrics"):
            # a node killed mid-response hands back truncated
            # exposition text; a parse blow-up here must cost this
            # node its scrape, never the whole fleet report
            try:
                out["families"] = m.parse_exposition(out["metrics"])
            except Exception:
                out["metrics"] = None
        # node down at report time (crashed mid-window and not yet —
        # or never — restarted): flag it so report() can mark the
        # entry instead of silently rendering zeros
        out["unreachable"] = (out.get("metrics") is None
                              and out.get("traces") is None)
        return out

    def report(self, extra_registries: tuple = (),
               elapsed_s: float | None = None) -> dict:
        """Build the report dict.  `extra_registries` are in-process
        metrics registries (node/metrics.Registry) merged in as the
        pseudo-node "local" — the soak's proof verification runs in
        the test process, so its per-proof histograms live there."""
        elapsed = elapsed_s or max(1e-9, time.time() - self.t_start)
        per_node: dict[str, dict] = {}
        lag_all: list[float] = []
        first_best: list[float] = []
        last_best: list[float] = []
        ext_rate_total = 0.0
        scrapes = {
            self._label(node): self._scrape_full(node)
            for node in self.nodes
        }

        for node in self.nodes:
            label = self._label(node)
            series = self.samples[label]
            lags = [s["health"].get("finalityLag", 0) for s in series]
            bests = [s["health"].get("bestBlock", 0) for s in series]
            lag_all.extend(lags)
            if bests:
                first_best.append(bests[0])
                last_best.append(bests[-1])
            scrape = scrapes[label]
            fams = scrape.get("families") or {}
            entry: dict = {
                "unreachable": bool(scrape.get("unreachable")),
                "samples": len(series),
                "bestBlock": bests[-1] if bests else None,
                "finalityLag": {
                    "last": lags[-1] if lags else None,
                    "p50": percentile(lags, 0.50),
                    "p95": percentile(lags, 0.95),
                },
                "gossipDropped": (
                    series[-1]["health"].get("gossipDropped", {})
                    if series else {}
                ),
                "peersSeen": (
                    series[-1]["health"].get("peersSeen", {})
                    if series else {}
                ),
            }
            if fams:
                entry["blocksProduced"] = fams.get(
                    "cess_blocks_produced", m.MetricFamily("")).value()
                entry["blocksImported"] = fams.get(
                    "cess_blocks_imported", m.MetricFamily("")).value()
                entry["extrinsicsApplied"] = fams.get(
                    "cess_extrinsics_applied", m.MetricFamily("")).value()
                # clamp at zero: a crash-restarted node's counter
                # resets below its construction-time baseline (its
                # post-restart work is undercounted rather than
                # driving the fleet rate negative)
                ext_rate_total += max(
                    0.0,
                    entry["extrinsicsApplied"]
                    - self._ext_base.get(label, 0.0),
                )
                entry["importStages"] = {
                    stage: histogram_summary(fams[name])
                    for stage in self.IMPORT_STAGES
                    if (name := f"cess_import_{stage}_seconds") in fams
                }
                # tx-pool families (fee market, node/service.py): the
                # rejection counter is labelled by reason — keep both
                # the per-reason breakdown and the total
                rej = fams.get("cess_pool_rejections", m.MetricFamily(
                    "cess_pool_rejections"))
                entry["pool"] = {
                    "size": fams.get(
                        "cess_pool_size", m.MetricFamily("")).value(),
                    "bytes": fams.get(
                        "cess_pool_bytes", m.MetricFamily("")).value(),
                    "evictions": fams.get(
                        "cess_pool_evictions", m.MetricFamily("")).value(),
                    "rejections": rej.total(),
                    "rejectionsByReason": {
                        labels.get("reason", "?"): v
                        for sname, labels, v in rej.samples
                        if sname == rej.name
                    },
                    "feeTotal": fams.get(
                        "cess_pool_fee_total", m.MetricFamily("")).value(),
                }
                # read-plane families (light/replica.py): present only
                # on read replicas — reads served, proof build latency,
                # and the justification-batch amortisation (verified
                # per weighted pairing; >1 means batching is paying)
                if "cess_replica_reads_total" in fams:
                    verified = fams.get(
                        "cess_light_justifications_verified",
                        m.MetricFamily("")).value()
                    pairings = fams.get(
                        "cess_light_batch_pairings",
                        m.MetricFamily("")).value()
                    entry["readPlane"] = {
                        "reads": fams["cess_replica_reads_total"].value(),
                        "proofLatency": (
                            histogram_summary(
                                fams["cess_replica_proof_seconds"])
                            if "cess_replica_proof_seconds" in fams
                            else None),
                        "justificationsVerified": verified,
                        "batchPairings": pairings,
                        "justsPerPairing": round(
                            verified / pairings, 2) if pairings else 0.0,
                    }
            per_node[label] = entry

        # fleet rates: the chain advances as one, so blocks/s is the
        # best head's progress over the window, not a per-node sum
        blocks_delta = (
            max(last_best) - max(first_best)
            if first_best and last_best else 0.0
        )

        # stitched traces: block traces whose spans live on >1 node.
        # Defensive .get()s: a trace summary from a node that died
        # mid-serialisation may be missing keys — drop the record,
        # keep the report.
        trace_nodes: dict[str, set] = {}
        for label, scrape in scrapes.items():
            summary = scrape.get("traces") or {}
            traces = summary.get("traces", []) if isinstance(
                summary, dict) else []
            for t in traces:
                if not isinstance(t, dict):
                    continue
                # import.batch: the pipelined gossip drain wraps a
                # block's import spans, so on importers the block's
                # trace roots at the batch span, not block.import
                if t.get("root") in ("block.author", "block.import",
                                     "import.batch") \
                        and t.get("traceId"):
                    trace_nodes.setdefault(t["traceId"], set()).add(label)
        stitched = sum(1 for nodes in trace_nodes.values()
                       if len(nodes) > 1)

        # proof data plane: merge node expositions + local registries.
        # The proof-stage registry is PROCESS-wide (every node in one
        # process serves the same one via system_metrics, and a caller
        # may pass it again through extra_registries), so sources are
        # deduped by their proof-family fingerprint before summing —
        # otherwise co-hosted nodes multi-count the same checks.
        proof: dict = {}
        proof_sources = []
        seen_fp = set()
        for fams in (
            [scrape.get("families") or {} for scrape in scrapes.values()]
            + [m.parse_exposition(reg.render())
               for reg in extra_registries]
        ):
            fp = tuple(
                (name, round(fams[name].value(), 9))
                for name in ("cess_proofs_verified",
                             "cess_proof_checks",
                             "cess_proof_verify_seconds_total")
                if name in fams
            )
            if fp and fp in seen_fp:
                continue
            seen_fp.add(fp)
            proof_sources.append(fams)
        total_proofs = sum(
            f.get("cess_proofs_verified", m.MetricFamily("")).value()
            for f in proof_sources
        )
        total_seconds = sum(
            f.get("cess_proof_verify_seconds_total",
                  m.MetricFamily("")).value()
            for f in proof_sources
        )
        if total_proofs:
            proof["proofs"] = int(total_proofs)
            proof["per_proof_ms"] = round(
                total_seconds / total_proofs * 1000.0, 3)
            proof["stages"] = {}
            for stage in self.PROOF_STAGES:
                name = f"cess_proof_stage_{stage}_seconds"
                fams_with = [f[name] for f in proof_sources if name in f]
                if not fams_with:
                    continue
                count = sum(f.histogram()["count"] for f in fams_with)
                total = sum(f.histogram()["sum"] for f in fams_with)
                proof["stages"][stage] = {
                    "count": int(count),
                    "total_s": round(total, 4),
                    "mean_ms": round(
                        total / count * 1000.0, 3) if count else 0.0,
                }

        # fee-market pressure: how much intake the pools turned away
        # vs how much work the chain actually applied — the spam-drop
        # rate a flood soak watches alongside paid-traffic inclusion
        rejections_total = sum(
            e.get("pool", {}).get("rejections", 0.0)
            for e in per_node.values()
        )
        applied_total = sum(
            e.get("extrinsicsApplied", 0.0) for e in per_node.values()
        )
        return {
            "generated_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "window_s": round(elapsed, 2),
            "nodes": len(self.nodes),
            "unreachable_nodes": sum(
                1 for e in per_node.values() if e.get("unreachable")),
            "fleet": {
                "blocks_per_s": round(blocks_delta / elapsed, 4),
                "extrinsics_per_s": round(ext_rate_total / elapsed, 4),
                "finality_lag_p50": percentile(lag_all, 0.50),
                "finality_lag_p95": percentile(lag_all, 0.95),
                "stitched_traces": stitched,
                "gossip_drops_total": sum(
                    sum(e["gossipDropped"].values())
                    for e in per_node.values()
                ),
                "pool_rejections_total": rejections_total,
                "pool_evictions_total": sum(
                    e.get("pool", {}).get("evictions", 0.0)
                    for e in per_node.values()
                ),
                "spam_drop_rate": round(
                    rejections_total
                    / max(1.0, rejections_total + applied_total), 4),
                "replica_reads_total": sum(
                    e.get("readPlane", {}).get("reads", 0.0)
                    for e in per_node.values()
                ),
                "replicas": sum(
                    1 for e in per_node.values() if "readPlane" in e
                ),
            },
            "per_node": per_node,
            "proof": proof,
        }


def to_markdown(report: dict) -> str:
    """Human-readable rendering of a report dict."""
    fleet = report["fleet"]
    lines = [
        "# Fleet telemetry report",
        "",
        f"Generated {report['generated_at']} over a "
        f"{report['window_s']} s window across {report['nodes']} nodes"
        + (f" ({report['unreachable_nodes']} unreachable at scrape "
           "time; fleet totals cover survivors only)"
           if report.get("unreachable_nodes") else "")
        + ".",
        "",
        "## Throughput",
        "",
        "| metric | value |",
        "|---|---|",
        f"| blocks/s | {fleet['blocks_per_s']} |",
        f"| extrinsics/s | {fleet['extrinsics_per_s']} |",
        f"| finality lag p50 (blocks) | {fleet['finality_lag_p50']} |",
        f"| finality lag p95 (blocks) | {fleet['finality_lag_p95']} |",
        f"| gossip drops (total) | {fleet['gossip_drops_total']} |",
        f"| cross-node stitched traces | {fleet['stitched_traces']} |",
        "",
        "## Tx pool",
        "",
        "| metric | value |",
        "|---|---|",
        f"| intake rejections (total) "
        f"| {fleet.get('pool_rejections_total', 0)} |",
        f"| evictions (total) | {fleet.get('pool_evictions_total', 0)} |",
        f"| spam drop rate | {fleet.get('spam_drop_rate', 0)} |",
        "",
        "## Per node",
        "",
    ]
    for label, entry in report["per_node"].items():
        lines += [
            f"### {label}"
            + (" — UNREACHABLE" if entry.get("unreachable") else ""),
            "",
            f"- best block {entry.get('bestBlock')}, finality lag "
            f"p50/p95 {entry['finalityLag']['p50']}/"
            f"{entry['finalityLag']['p95']} "
            f"({entry['samples']} samples)",
            f"- produced {entry.get('blocksProduced', 0)}, imported "
            f"{entry.get('blocksImported', 0)}, extrinsics applied "
            f"{entry.get('extrinsicsApplied', 0)}",
        ]
        drops = entry.get("gossipDropped") or {}
        if drops:
            lines.append(f"- gossip drops: {json.dumps(drops)}")
        pool = entry.get("pool") or {}
        if pool:
            lines.append(
                f"- pool: {int(pool['size'])} txs / "
                f"{int(pool['bytes'])} B, "
                f"{int(pool['evictions'])} evictions, "
                f"{int(pool['rejections'])} rejections "
                f"{json.dumps(pool.get('rejectionsByReason', {}))}, "
                f"fees charged {int(pool['feeTotal'])}")
        stages = entry.get("importStages") or {}
        if stages:
            lines += ["", "| import stage | n | mean ms | p50 ms | p95 ms |",
                      "|---|---|---|---|---|"]
            for stage, s in stages.items():
                lines.append(
                    f"| {stage} | {s['count']} | {s['mean_ms']} "
                    f"| {s['p50_ms']} | {s['p95_ms']} |"
                )
        lines.append("")
    replicas = {
        label: entry["readPlane"]
        for label, entry in report["per_node"].items()
        if entry.get("readPlane")
    }
    if replicas:
        lines += [
            "## Read plane",
            "",
            f"{report['fleet'].get('replicas', 0)} replica(s) served "
            f"{int(report['fleet'].get('replica_reads_total', 0))} "
            "verified read proofs.",
            "",
            "| replica | reads | proof p50 ms | proof p95 ms "
            "| justs verified | pairings | justs/pairing |",
            "|---|---|---|---|---|---|---|",
        ]
        for label, rp in replicas.items():
            lat = rp.get("proofLatency") or {}
            lines.append(
                f"| {label} | {int(rp['reads'])} "
                f"| {lat.get('p50_ms', 0)} | {lat.get('p95_ms', 0)} "
                f"| {int(rp['justificationsVerified'])} "
                f"| {int(rp['batchPairings'])} "
                f"| {rp['justsPerPairing']} |"
            )
        lines.append("")
    proof = report.get("proof") or {}
    if proof:
        lines += [
            "## Proof data plane",
            "",
            f"{proof['proofs']} proofs verified, "
            f"{proof['per_proof_ms']} ms/proof (wall-clock over "
            "combined checks).",
            "",
            "| stage | checks | total s | mean ms |",
            "|---|---|---|---|",
        ]
        for stage, s in proof.get("stages", {}).items():
            lines.append(
                f"| {stage} | {s['count']} | {s['total_s']} "
                f"| {s['mean_ms']} |"
            )
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", required=True,
                    help="comma-separated host:port RPC endpoints")
    ap.add_argument("--duration", type=float, default=15.0,
                    help="sampling window seconds")
    ap.add_argument("--poll", type=float, default=1.0)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--out-md", default=None)
    args = ap.parse_args(argv)

    nodes = []
    for part in filter(None, (p.strip() for p in args.nodes.split(","))):
        host, _, port = part.rpartition(":")
        nodes.append((host or "127.0.0.1", int(port)))
    collector = FleetCollector(nodes)
    deadline = time.time() + args.duration
    while time.time() < deadline:
        collector.sample()
        time.sleep(args.poll)
    collector.sample()
    report = collector.report()
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(text + "\n")
    if args.out_md:
        with open(args.out_md, "w") as fh:
            fh.write(to_markdown(report) + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
