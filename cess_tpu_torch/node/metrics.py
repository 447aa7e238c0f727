"""Prometheus-style metrics registry (SURVEY §5 tracing/observability).

The reference threads a prometheus registry through its service
(reference: node/src/service.rs:151,185,309,376,529 — pool, import
queue, RPC and telemetry all report into it).  This is the equivalent
seam: counters/gauges/histograms registered here are rendered in the
text exposition format by the RPC server's `system_metrics` method and
the CLI's `metrics` command.  `parse_exposition` is the matching
reader — the fleet telemetry reporter (tools/telemetry_report.py)
round-trips `Registry.render()` through it, and the round-trip is a
test fixture (tests/test_telemetry.py).

Concurrency contract: every read path (samples, render, totals)
snapshots under the same per-metric lock the write path takes — RPC
threads scrape while the authoring loop increments, and a torn read
(e.g. a histogram bucket bumped but `_count` not yet) would render an
exposition no consistent execution ever produced.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right


def escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def unescape_label_value(value: str) -> str:
    out = []
    it = iter(value)
    for ch in it:
        if ch != "\\":
            out.append(ch)
            continue
        nxt = next(it, "")
        out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
    return "".join(out)


class _Metric:
    def __init__(self, name: str, help_: str, registry: "Registry | None"):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        (registry if registry is not None else REGISTRY).register(self)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def samples(self):
        with self._lock:
            return [(self.name, "", self.value)]


class LabeledCounter(_Metric):
    """Counter with one label dimension (the prometheus labelled-series
    shape, e.g. per-peer gossip drops): each distinct label value is
    its own monotone series, rendered as `name{label="value"} n`."""

    kind = "counter"

    def __init__(self, name, help_="", label="peer", registry=None):
        super().__init__(name, help_, registry)
        self.label = label
        self.values: dict[str, float] = {}

    def inc(self, label_value: str, amount: float = 1.0) -> None:
        with self._lock:
            self.values[label_value] = (
                self.values.get(label_value, 0.0) + amount
            )

    def get(self, label_value: str) -> float:
        with self._lock:
            return self.values.get(label_value, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self.values.values())

    def counts(self) -> dict[str, float]:
        with self._lock:
            return dict(self.values)

    def samples(self):
        with self._lock:
            return [
                (self.name, f'{self.label}="{escape_label_value(v)}"', n)
                for v, n in sorted(self.values.items())
            ]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_="", registry=None):
        super().__init__(name, help_, registry)
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def samples(self):
        with self._lock:
            return [(self.name, "", self.value)]


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
    )

    def __init__(self, name, help_="", buckets=None, registry=None):
        super().__init__(name, help_, registry)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.counts[bisect_right(self.buckets, value)] += 1
            self.total += value
            self.n += 1

    def time(self):
        """Context manager observing elapsed seconds."""
        metric = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metric.observe(time.perf_counter() - self.t0)
                return False

        return _Timer()

    def samples(self):
        # snapshot the three correlated fields under the lock: a bucket
        # bumped by a concurrent observe() with `n` not yet advanced
        # would render `+Inf` < a finite bucket — a state no execution
        # ever passed through
        with self._lock:
            counts = list(self.counts)
            total, n = self.total, self.n
        out = []
        acc = 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out.append((self.name + "_bucket", f'le="{b}"', acc))
        out.append((self.name + "_bucket", 'le="+Inf"', n))
        out.append((self.name + "_sum", "", total))
        out.append((self.name + "_count", "", n))
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition format.  The metric list is
        snapshotted under the registry lock (register() mutates the
        dict while RPC scrape threads iterate), and each metric's
        samples() snapshots under its own lock."""
        lines = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m.samples():
                label_s = "{" + labels + "}" if labels else ""
                v = int(value) if float(value).is_integer() else value
                lines.append(f"{name}{label_s} {v}")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def scoped_registry() -> Registry:
    """Fresh registry for tests / multiple in-process services."""
    return Registry()


def render_merged(*registries: Registry) -> str:
    """Concatenated exposition of several registries (the node's RPC
    merges its per-service registry with the process-wide proof-stage
    registry, proof/torch_backend.py)."""
    return "".join(r.render() for r in registries)


# ---------------------------------------------------------- exposition io


class MetricFamily:
    """Parsed exposition family: name, kind, help, and samples as
    (suffixed_name, labels_dict, value) triples."""

    def __init__(self, name: str, kind: str = "untyped", help_: str = ""):
        self.name = name
        self.kind = kind
        self.help = help_
        self.samples: list[tuple[str, dict[str, str], float]] = []

    def value(self, default: float = 0.0) -> float:
        """The single unlabelled sample (counters/gauges)."""
        for sname, labels, v in self.samples:
            if sname == self.name and not labels:
                return v
        return default

    def total(self) -> float:
        """Sum over every sample of the base name (labelled counters)."""
        return sum(v for sname, _, v in self.samples if sname == self.name)

    def histogram(self) -> dict:
        """{buckets: [(le, cumulative)], sum, count} for histogram kind."""
        buckets, total, count = [], 0.0, 0.0
        for sname, labels, v in self.samples:
            if sname == self.name + "_bucket":
                le = labels.get("le", "+Inf")
                buckets.append(
                    (float("inf") if le == "+Inf" else float(le), v)
                )
            elif sname == self.name + "_sum":
                total = v
            elif sname == self.name + "_count":
                count = v
        buckets.sort(key=lambda b: b[0])
        return {"buckets": buckets, "sum": total, "count": count}


def _parse_labels(raw: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    i = 0
    while i < len(raw):
        eq = raw.index("=", i)
        key = raw[i:eq].strip().strip(",")
        assert raw[eq + 1] == '"', f"unquoted label value in {raw!r}"
        j = eq + 2
        buf = []
        while raw[j] != '"':
            if raw[j] == "\\":
                buf.append(raw[j:j + 2])
                j += 2
            else:
                buf.append(raw[j])
                j += 1
        labels[key] = unescape_label_value("".join(buf))
        i = j + 1
    return labels


def parse_exposition(text: str) -> dict[str, MetricFamily]:
    """Parse the Prometheus text format `Registry.render()` emits back
    into metric families — the scrape side of the telemetry reporter.
    Histogram `_bucket`/`_sum`/`_count` samples group under their base
    family name."""
    families: dict[str, MetricFamily] = {}

    def family_of(sample_name: str) -> MetricFamily:
        base = sample_name
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                cand = sample_name[: -len(suffix)]
                if cand in families and families[cand].kind == "histogram":
                    base = cand
                    break
        if base not in families:
            families[base] = MetricFamily(base)
        return families[base]

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            families.setdefault(name, MetricFamily(name)).help = help_
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            fam = families.setdefault(name, MetricFamily(name))
            fam.kind = kind.strip()
            continue
        if line.startswith("#"):
            continue
        if "{" in line:
            name = line[: line.index("{")]
            raw = line[line.index("{") + 1: line.rindex("}")]
            value = float(line[line.rindex("}") + 1:].strip())
            labels = _parse_labels(raw)
        else:
            name, _, v = line.rpartition(" ")
            labels, value = {}, float(v)
        family_of(name).samples.append((name, labels, value))
    return families
