"""Process-local metrics: counters, gauges, log-bucketed histograms.

One `MetricsRegistry` per `QueryServer` replaces the ad-hoc latency
deques + `np.percentile` bookkeeping: histograms bucket observations
geometrically (default base 2^(1/8), ~9% resolution per bucket) in O(1)
memory regardless of stream length, keeping exact count/sum/min/max and
estimated percentiles (geometric bucket midpoint, clamped to the exact
observed [min, max]).

`snapshot()` has a PINNED flat schema — the unit of compatibility for
`QueryServer.telemetry()["metrics"]`:

    {"counters":   {name: int},
     "gauges":     {name: float},
     "histograms": {name: {"count", "sum", "min", "max",
                           "p50", "p90", "p99"}}}

A schema test asserts the key set, so extend it deliberately.

Stdlib-only: importable from ``repro_torch.core`` without a cycle.
"""
from __future__ import annotations

import math

HISTOGRAM_BASE = 2.0 ** 0.125       # ~9% bucket resolution
HISTOGRAM_FIELDS = ("count", "sum", "min", "max", "p50", "p90", "p99")


class Counter:
    """Monotonic int counter."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed histogram of non-negative observations.

    Bucket k holds values in [base^k, base^(k+1)); values <= 0 land in a
    dedicated zero bucket (latencies and row counts are never negative,
    but a degenerate 0 must not blow up the log)."""
    __slots__ = ("base", "_log_base", "buckets", "zeros", "count", "sum",
                 "min", "max")

    def __init__(self, base: float = HISTOGRAM_BASE):
        self.base = float(base)
        self._log_base = math.log(self.base)
        self.buckets: dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zeros += 1
            return
        k = math.floor(math.log(v) / self._log_base)
        self.buckets[k] = self.buckets.get(k, 0) + 1

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile: cumulative walk over the buckets,
        geometric midpoint of the landing bucket, clamped to the exact
        observed range.  0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(self.count * q / 100.0))
        if rank <= self.zeros:
            return max(0.0, self.min)
        cum = self.zeros
        for k in sorted(self.buckets):
            cum += self.buckets[k]
            if cum >= rank:
                mid = self.base ** (k + 0.5)
                return min(max(mid, self.min), self.max)
        return self.max

    def snapshot(self) -> dict:
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": float(self.sum),
            "min": 0.0 if empty else float(self.min),
            "max": 0.0 if empty else float(self.max),
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Create-on-first-use registry.  Names are flat strings; a name is
    permanently bound to its first-used type (asking for a counter named
    like an existing histogram raises)."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _check_free(self, name: str, own: dict) -> None:
        for d in (self._counters, self._gauges, self._histograms):
            if d is not own and name in d:
                raise ValueError(
                    f"metric {name!r} already registered as another type")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._check_free(name, self._counters)
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._check_free(name, self._gauges)
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  base: float = HISTOGRAM_BASE) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._check_free(name, self._histograms)
            h = self._histograms[name] = Histogram(base=base)
        return h

    def snapshot(self) -> dict:
        """JSON-serializable snapshot with the pinned schema (see module
        docstring)."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._histograms.items())},
        }
