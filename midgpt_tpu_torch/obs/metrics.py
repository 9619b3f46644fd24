"""Counters / gauges / histograms with a Prometheus-text-format dump (the
port's own copy of midgpt_tpu/obs/metrics.py, same output).

Every instrument lives in a `MetricsRegistry` whose `snapshot()` is the
stats() payload shared by the engine and the supervisor, and whose
`to_prometheus()` emits the text exposition format a scrape endpoint would
serve. Histograms keep a bounded reservoir (`deque(maxlen=...)`) plus exact
count/sum, so percentiles (nearest rank) stay cheap and memory stays flat
however many rounds a long-lived server sees.
"""

from __future__ import annotations

import math
import re
import typing as tp
from collections import deque

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset."""
    return _NAME_RE.sub("_", name)


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Bounded-reservoir histogram: exact n/sum/max, percentile estimates
    from the most recent `maxlen` observations (recency bias is the POINT
    for serving latencies — a p95 from an hour ago is not operable)."""

    __slots__ = ("name", "help", "n", "total", "max", "_tail")

    def __init__(self, name: str, help: str = "", maxlen: int = 4096):
        self.name = name
        self.help = help
        self.n = 0
        self.total = 0.0
        self.max = 0.0
        self._tail: tp.Deque[float] = deque(maxlen=maxlen)

    def observe(self, value: float) -> None:
        v = float(value)
        self.n += 1
        self.total += v
        if v > self.max:
            self.max = v
        self._tail.append(v)

    def _quantile(self, sorted_tail: tp.List[float], q: float) -> float:
        # nearest-rank on the sorted reservoir; exact for n <= maxlen
        if not sorted_tail:
            return 0.0
        idx = min(len(sorted_tail) - 1, max(0, math.ceil(q * len(sorted_tail)) - 1))
        return sorted_tail[idx]

    def summary(self) -> tp.Dict[str, float]:
        tail = sorted(self._tail)
        return {
            "n": self.n,
            "mean": round(self.total / self.n, 6) if self.n else 0.0,
            "p50": round(self._quantile(tail, 0.50), 6),
            "p95": round(self._quantile(tail, 0.95), 6),
            "max": round(self.max, 6),
        }


class MetricsRegistry:
    """Create-or-get instruments by name; snapshot/export the lot."""

    def __init__(self):
        self._counters: tp.Dict[str, Counter] = {}
        self._gauges: tp.Dict[str, Gauge] = {}
        self._histograms: tp.Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "", maxlen: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, help, maxlen)
        return h

    def snapshot(self) -> tp.Dict[str, tp.Any]:
        """The unified stats() payload: plain dicts, JSON-serializable."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {
                n: h.summary() for n, h in sorted(self._histograms.items())
            },
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition format. Histograms export as summary
        quantiles (not cumulative buckets): the reservoir gives percentile
        estimates directly and bucket bounds would be a lie."""
        lines: tp.List[str] = []
        for n, c in sorted(self._counters.items()):
            pn = _prom_name(n)
            if c.help:
                lines.append(f"# HELP {pn} {c.help}")
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {c.value:g}")
        for n, g in sorted(self._gauges.items()):
            pn = _prom_name(n)
            if g.help:
                lines.append(f"# HELP {pn} {g.help}")
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {g.value:g}")
        for n, h in sorted(self._histograms.items()):
            pn = _prom_name(n)
            if h.help:
                lines.append(f"# HELP {pn} {h.help}")
            lines.append(f"# TYPE {pn} summary")
            s = h.summary()
            lines.append(f'{pn}{{quantile="0.5"}} {s["p50"]:g}')
            lines.append(f'{pn}{{quantile="0.95"}} {s["p95"]:g}')
            lines.append(f"{pn}_sum {h.total:g}")
            lines.append(f"{pn}_count {h.n:g}")
        return "\n".join(lines) + "\n"
