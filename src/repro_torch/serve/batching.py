"""Shape-batched execution: bucket a stream of admitted queries by
(template fingerprint, pow2 capacity class) and execute each bucket once
through shared padded shapes.

Two effects compound:

  * queries with the SAME fingerprint against an immutable dataset are
    the same computation — one execution serves the whole bucket (result
    fan-out; per-future column remapping handles renumbered clients);
  * buckets are drained in capacity-class order, so executions whose
    padded table shapes coincide run consecutively and reuse the same
    allocation sizes across adjacent buckets instead of thrashing
    between a large and a small shape regime per query.

The batcher is policy only — it owns no engine state.  The server hands
it opaque items plus their (fingerprint, capacity class) and an
`execute(item) -> result` callback for one representative per bucket.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BatchTelemetry:
    queries: int = 0            # items admitted
    executions: int = 0         # engine executions actually run
    buckets: int = 0            # distinct (fingerprint, class) buckets
    dedup_saved: int = 0        # executions avoided by result fan-out
    flushes: int = 0
    shed: int = 0               # items shed by a flush-time stop signal

    def snapshot(self) -> dict:
        return dict(vars(self))


class ShapeBatcher:
    """Admit items, then `flush(execute)` them bucket-at-a-time.

    Items sharing a bucket key get the result of ONE execution of the
    bucket's first (representative) item; buckets run in ascending
    (capacity class, fingerprint) order."""

    def __init__(self, metrics=None):
        # optional obs.metrics.MetricsRegistry: per-bucket size histogram
        # (how much dedup/shape-sharing each flush actually found)
        self.telemetry = BatchTelemetry()
        self.metrics = metrics
        self._pending: list[tuple[str, int, object]] = []

    def __len__(self) -> int:
        return len(self._pending)

    def add(self, item, fingerprint: str, cap_class: int) -> None:
        self._pending.append((fingerprint, int(cap_class), item))
        self.telemetry.queries += 1

    def flush(self, execute,
              should_stop=None) -> list[tuple[object, object]]:
        """Run all pending items; returns [(item, result), ...] in bucket
        order.  `execute(item)` is called once per bucket.

        `should_stop`, when given, is consulted before each bucket: it
        returns None to continue or an Exception instance to shed the
        remaining buckets — every not-yet-executed item is paired with
        that exception instead of a result (the server resolves each
        affected future with it), so an exhausted per-flush wall budget
        sheds the tail of the flush instead of hanging it."""
        pending, self._pending = self._pending, []
        if not pending:
            return []
        self.telemetry.flushes += 1
        buckets: dict[tuple[int, str], list[object]] = {}
        for fingerprint, cap_class, item in pending:
            buckets.setdefault((cap_class, fingerprint), []).append(item)
        out = []
        stopped: Exception | None = None
        for key in sorted(buckets):
            items = buckets[key]
            self.telemetry.buckets += 1
            if self.metrics is not None:
                self.metrics.histogram("batch_bucket_size").observe(
                    len(items))
            if stopped is None and should_stop is not None:
                stopped = should_stop()
            if stopped is not None:
                self.telemetry.shed += len(items)
                for item in items:
                    out.append((item, stopped))
                continue
            self.telemetry.executions += 1
            self.telemetry.dedup_saved += len(items) - 1
            result = execute(items[0])
            for item in items:
                out.append((item, result))
        return out
