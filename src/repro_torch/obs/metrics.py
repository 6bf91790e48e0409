"""Process-wide metrics registry: counters, gauges, percentile histograms.

The serving/streaming instrumentation hooks feed one
:class:`MetricsRegistry` (``repro_torch.obs.metrics()``): queue depth, bucket
pad-waste, per-graph admission->emit latency, decode occupancy, stream
block sizes, plan-cache hits per backend.  The registry is deliberately
tiny — plain Python numbers behind one lock, no label cardinality
machinery; a labelled series is just a dotted name
(``service.latency_us.fig9``).  :func:`repro_torch.obs.report.build_report`
renders a snapshot into the post-run serving report.

Like the tracer, none of this is touched while observability is off:
hot-path call sites guard with ``if obs.ENABLED:``.  Explicit
always-on counters may use the registry directly — an increment is one
dict lookup and an integer add.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry", "percentile"]


def percentile(sorted_values: List[float], p: float) -> float:
    """Nearest-rank percentile of an ascending-sorted list (``p`` in
    [0, 1]); the same definition the report and its tests share."""
    if not sorted_values:
        return 0.0
    rank = max(1, math.ceil(p * len(sorted_values)))
    return float(sorted_values[rank - 1])


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins sample (queue depth, occupancy share)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution with nearest-rank percentiles.

    Stores raw samples up to ``max_samples`` (default 1 << 16), then
    keeps every k-th sample (doubling ``k`` on each overflow) so
    long-running services stay bounded while count/sum/min/max remain
    exact.
    """

    __slots__ = ("samples", "count", "total", "min", "max",
                 "max_samples", "_stride", "_skip")

    def __init__(self, max_samples: int = 1 << 16):
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.max_samples = max_samples
        self._stride = 1
        self._skip = 0

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._skip += 1
        if self._skip >= self._stride:
            self._skip = 0
            self.samples.append(v)
            if len(self.samples) >= self.max_samples:
                self.samples = self.samples[::2]
                self._stride *= 2

    def percentile(self, p: float) -> float:
        return percentile(sorted(self.samples), p)

    def summary(self) -> dict:
        s = sorted(self.samples)
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": percentile(s, 0.50),
            "p95": percentile(s, 0.95),
            "p99": percentile(s, 0.99),
        }


class MetricsRegistry:
    """Named counters / gauges / histograms behind one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, factory):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.setdefault(name, factory())
        return m

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def snapshot(self) -> dict:
        """Plain-data view of every metric (JSON-serializable)."""
        with self._lock:
            return {
                "counters": {k: c.value
                             for k, c in sorted(self._counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(self._gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(self._histograms.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_REGISTRY: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry()
    return _REGISTRY


def reset_registry() -> MetricsRegistry:
    """Fresh process registry (tests / bench isolation)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY
