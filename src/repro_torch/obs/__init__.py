"""Observability: per-query tracing, a metrics registry, and EXPLAIN.

  * `trace`   — `Tracer` with nestable spans and a ring buffer of
                completed traces, exportable as Chrome-trace JSON;
                `NULL_TRACER` is the ~zero-cost disabled variant the
                engine carries by default.
  * `metrics` — `MetricsRegistry` of counters / gauges / log-bucketed
                histograms with a pinned snapshot schema (feeds
                `QueryServer.telemetry()["metrics"]`).
  * `explain` — `render_explain(pq)`: the learned plan of one
                PreparedQuery as deterministic text (D-trees, §4.3
                check decision with its τ comparisons, join order with
                estimated vs. observed cardinalities, connection-edge
                order and strategies).

This package sits BELOW ``repro_torch.core`` in the import order (``core``
imports ``obs``, never the reverse at module scope), so everything here
is stdlib-only or lazily bound.
"""
from .trace import (NULL_SPAN, NULL_TRACER, NullTracer, Span, Trace,
                    Tracer)
from .metrics import (HISTOGRAM_BASE, HISTOGRAM_FIELDS, Counter, Gauge,
                      Histogram, MetricsRegistry)
from .explain import render_explain

__all__ = [
    "Tracer", "NullTracer", "Span", "Trace", "NULL_TRACER", "NULL_SPAN",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "HISTOGRAM_BASE", "HISTOGRAM_FIELDS",
    "render_explain",
]
