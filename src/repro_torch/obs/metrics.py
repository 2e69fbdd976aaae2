"""Process-local metrics registry: labeled counters, gauges, histograms
(own copy of the reference's ``obs/metrics.py``, pure Python: the same
calls give the same Prometheus text and the same snapshot).

Prometheus-flavored, dependency-free, and cheap: metrics are plain dicts
keyed by sorted ``(label, value)`` tuples, updated from host-side python
(scheduler ticks, compression spans, kernel launch wrappers — never from
inside a captured CUDA graph; the drift monitor keeps its counts on the
device and reads them back once, :mod:`repro_torch.obs.drift`).  Serving
is single-threaded per process (the same assumption
:mod:`repro_torch.calib.capture` documents for its module-level stack),
so no locking.

Histograms use exponential buckets (Prometheus ``le`` convention:
``observe(v)`` lands in the first bucket with ``v <= upper_bound``, with
a ``+Inf`` overflow bucket) — the right shape for latencies spanning
orders of magnitude.  :meth:`Histogram.percentile` reports the upper
bound of the bucket containing the rank, i.e. a quantile upper estimate
with bucket-width resolution.

:meth:`MetricsRegistry.render_prometheus` emits the text exposition
format; :meth:`MetricsRegistry.snapshot` a JSON-ready dict (the event
log's footer payload); :meth:`MetricsRegistry.summary` a short
human-readable digest for end-of-run logs.
"""
from __future__ import annotations

import bisect
import math


def exponential_buckets(start: float, factor: float, count: int
                        ) -> tuple[float, ...]:
    """``count`` upper bounds ``start * factor**i`` (the ``+Inf`` overflow
    bucket is implicit)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exponential_buckets needs start > 0, factor > 1, count >= 1 "
            f"(got start={start}, factor={factor}, count={count})")
    return tuple(start * factor ** i for i in range(count))


# 100us .. ~105s in x2 steps — covers TTFT through whole-run latencies.
LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 21)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonically increasing labeled counter."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.data: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{amount}")
        key = _label_key(labels)
        self.data[key] = self.data.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self.data.get(_label_key(labels), 0.0)

    def total(self) -> float:
        return sum(self.data.values())

    def render(self) -> list[str]:
        return [f"{self.name}{_fmt_labels(k)} {_num(v)}"
                for k, v in sorted(self.data.items())]

    def snapshot(self):
        return {_fmt_labels(k) or "": v for k, v in sorted(self.data.items())}


class Gauge(Counter):
    """Labeled gauge: last value set wins."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.data[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self.data[key] = self.data.get(key, 0.0) + amount


class Histogram:
    """Labeled histogram over fixed exponential buckets."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: tuple[float, ...] | None = None):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets) if buckets else LATENCY_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted")
        # label key -> {"counts": [len(buckets)+1 ints], "sum": float}
        self.data: dict[tuple, dict] = {}

    def _series(self, labels: dict) -> dict:
        key = _label_key(labels)
        s = self.data.get(key)
        if s is None:
            s = self.data.setdefault(
                key, {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0})
        return s

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        if math.isnan(value):
            return
        s = self._series(labels)
        s["counts"][bisect.bisect_left(self.buckets, value)] += 1
        s["sum"] += value

    def count(self, **labels) -> int:
        s = self.data.get(_label_key(labels))
        return sum(s["counts"]) if s else 0

    def sum(self, **labels) -> float:
        s = self.data.get(_label_key(labels))
        return s["sum"] if s else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Upper-bound estimate of the ``q``-quantile: the upper edge of
        the bucket holding the nearest-rank observation (``inf`` when it
        landed in the overflow bucket, 0.0 with no observations)."""
        s = self.data.get(_label_key(labels))
        if not s:
            return 0.0
        total = sum(s["counts"])
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(q * total))
        cum = 0
        for i, c in enumerate(s["counts"]):
            cum += c
            if cum >= rank:
                return self.buckets[i] if i < len(self.buckets) else math.inf
        return math.inf

    def render(self) -> list[str]:
        out = []
        for key, s in sorted(self.data.items()):
            cum = 0
            for ub, c in zip(self.buckets, s["counts"]):
                cum += c
                lk = key + (("le", _num(ub)),)
                out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            cum += s["counts"][-1]
            lk = key + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} {_num(s['sum'])}")
            out.append(f"{self.name}_count{_fmt_labels(key)} {cum}")
        return out

    def snapshot(self):
        return {_fmt_labels(k) or "": {
            "count": sum(s["counts"]), "sum": round(s["sum"], 6),
            "p50": _jsonable_num(self.percentile(0.50, **dict(k))),
            "p95": _jsonable_num(self.percentile(0.95, **dict(k))),
        } for k, s in sorted(self.data.items())}


def _num(v: float) -> str:
    # the Prometheus text format's spellings for what no int can hold;
    # the reference's ``int(v)`` raises on them (ROADMAP queue C)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _jsonable_num(v: float):
    return None if math.isinf(v) else v


class MetricsRegistry:
    """Get-or-create registry of named metrics, in registration order."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics.setdefault(name, cls(name, help, **kw))
        elif not isinstance(m, cls) or type(m) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def render_prometheus(self) -> str:
        lines = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def summary(self) -> str:
        parts = []
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                n = sum(sum(s["counts"]) for s in m.data.values())
                if n:
                    parts.append(f"{name}: n={n} "
                                 f"p50<={_num(m.percentile(0.5))} "
                                 f"p95<={_num(m.percentile(0.95))}")
            else:
                parts.append(f"{name}={_num(m.total())}")
        return "; ".join(parts)
