"""Per-query tracing: nestable spans, a trace ring buffer, Chrome export.

A *trace* is everything that happened to one submitted query, identified
by a server-assigned trace id.  Because shape batching interleaves
queries (prepare runs per future, execution runs per bucket), a trace is
a sequence of root *segments* — ``submit``, ``prepare``, then either
``execute`` (the bucket representative) or ``fanout`` (a deduped bucket
member pointing at the representative's trace) — each holding a nested
span tree.  Within a segment, ``tracer.span(...)`` nests under an
implicit current-span stack (serving is single-threaded and
synchronous), which is how governor and engine spans land inside the
right query's ``execute`` segment without any id threading through the
join stack.

Cost discipline: the hot path must pay ~zero when tracing is off.
``NULL_TRACER`` (a `NullTracer`) returns one shared `_NullSpan` whose
``set``/``__enter__``/``__exit__`` are empty-body methods — no
allocation, no clock read, no dict update.  Callers that compute span
attrs guard on ``span.live`` so attr construction is skipped too.

Clocks are monotonic (`time.perf_counter`); wall-clock never appears in
span timing.  ``export_chrome(path)`` writes the Chrome trace event
format (one ``ph: "X"`` complete event per span, pid 1, one tid per
trace) loadable in chrome://tracing or Perfetto.

Stdlib-only: imported by ``repro_torch.core`` without creating an import cycle.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque


class _NullSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""
    __slots__ = ()
    live = False

    def set(self, **attrs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation inside a trace.  Root spans (segments) have
    parent None; nested spans record their parent for structure checks.
    Use as a context manager; an exception propagating through stamps
    ``error`` with the exception type name and never swallows it."""
    __slots__ = ("name", "parent", "start", "end", "attrs", "error",
                 "_trace", "_tracer")
    live = True

    def __init__(self, tracer: "Tracer", name: str, trace: "Trace",
                 parent: "Span | None", attrs: dict):
        self._tracer = tracer
        self._trace = trace
        self.name = name
        self.parent = parent
        self.attrs = attrs
        self.error: str | None = None
        self.end: float | None = None
        self.start = time.perf_counter()

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def trace_id(self) -> str:
        return self._trace.trace_id

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.error = exc_type.__name__
        self.end = time.perf_counter()
        stack = self._tracer._stack
        if stack and stack[-1] is self:
            stack.pop()
        else:                           # tolerate a skipped inner exit
            try:
                stack.remove(self)
            except ValueError:
                pass
        return False


class Trace:
    """All spans of one query, across its segments."""
    __slots__ = ("trace_id", "attrs", "spans", "created", "finished_at")

    def __init__(self, trace_id: str, attrs: dict):
        self.trace_id = trace_id
        self.attrs = attrs
        self.spans: list[Span] = []
        self.created = time.perf_counter()
        self.finished_at: float | None = None

    @property
    def wall_s(self) -> float:
        end = self.finished_at
        if end is None:
            end = max((s.end for s in self.spans
                       if s.end is not None), default=self.created)
        return end - self.created

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent is None]


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:                                # numpy scalars
        if hasattr(v, "item"):
            return v.item()
    except Exception:                   # noqa: BLE001
        pass
    return str(v)


class Tracer:
    """Collects traces.  `start()` mints a trace id; `segment(name, id)`
    opens a root span in that trace and makes it current; `span(name)`
    nests under the current stack top (a no-op span when no segment is
    open, so bare `Engine.execute` calls stay traceable-but-silent);
    `finish(id)` moves the trace to the `finished` ring buffer."""
    enabled = True

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 4096):
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._ids = itertools.count(1)
        self._active: dict[str, Trace] = {}
        self._stack: list[Span] = []
        self.finished: deque[Trace] = deque(maxlen=int(max_traces))
        self.dropped_spans = 0          # over the per-trace span bound

    # -------------------------------------------------------------- #
    def start(self, **attrs) -> str:
        trace_id = f"t{next(self._ids):06d}"
        self._active[trace_id] = Trace(trace_id, attrs)
        return trace_id

    def segment(self, name: str, trace_id: str | None, **attrs):
        if trace_id is None:
            return NULL_SPAN
        trace = self._active.get(trace_id)
        if trace is None:               # already finished (or foreign id)
            return NULL_SPAN
        return self._open(name, trace, None, attrs)

    def span(self, name: str, **attrs):
        if not self._stack:
            return NULL_SPAN
        parent = self._stack[-1]
        return self._open(name, parent._trace, parent, attrs)

    def _open(self, name, trace, parent, attrs):
        if len(trace.spans) >= self.max_spans_per_trace:
            self.dropped_spans += 1
            return NULL_SPAN
        span = Span(self, name, trace, parent, attrs)
        trace.spans.append(span)
        self._stack.append(span)
        return span

    def finish(self, trace_id: str | None) -> Trace | None:
        if trace_id is None:
            return None
        trace = self._active.pop(trace_id, None)
        if trace is not None:
            trace.finished_at = time.perf_counter()
            self.finished.append(trace)
        return trace

    def current_trace_id(self) -> str | None:
        """Trace id of the innermost open span, or None outside any
        segment — lets error constructors name the trace that explains
        them without threading ids through call stacks."""
        return self._stack[-1].trace_id if self._stack else None

    def get(self, trace_id: str) -> Trace | None:
        """Look up a trace by id (active first, then the ring buffer)."""
        trace = self._active.get(trace_id)
        if trace is not None:
            return trace
        for tr in self.finished:
            if tr.trace_id == trace_id:
                return tr
        return None

    # -------------------------------------------------------------- #
    def to_chrome(self, include_active: bool = True) -> dict:
        """Chrome trace event format: one complete ("X") event per span,
        timestamps/durations in microseconds relative to the earliest
        span, pid 1, one tid per trace (named by a metadata event)."""
        traces = list(self.finished)
        if include_active:
            traces += list(self._active.values())
        events = []
        starts = [s.start for tr in traces for s in tr.spans]
        t0 = min(starts) if starts else 0.0
        for tid, tr in enumerate(traces, start=1):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": 1, "tid": tid,
                           "args": {"name": f"query {tr.trace_id}"}})
            for s in tr.spans:
                end = s.end if s.end is not None else s.start
                args = {"trace_id": tr.trace_id}
                for k, v in s.attrs.items():
                    args[k] = _jsonable(v)
                if s.error is not None:
                    args["error"] = s.error
                events.append({
                    "name": s.name, "ph": "X",
                    "ts": (s.start - t0) * 1e6,
                    "dur": max(end - s.start, 0.0) * 1e6,
                    "pid": 1, "tid": tid, "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path, include_active: bool = True) -> dict:
        """Write `to_chrome()` as JSON.  Returns a small manifest."""
        doc = self.to_chrome(include_active=include_active)
        with open(path, "w") as f:
            json.dump(doc, f)
        n_traces = len(self.finished) + (len(self._active)
                                         if include_active else 0)
        return {"path": str(path), "traces": n_traces,
                "events": len(doc["traceEvents"])}


class NullTracer:
    """Disabled tracing: same surface as `Tracer`, ~zero cost.  All span
    constructors return the shared `NULL_SPAN`; ids are never minted, so
    downstream `trace_id is None` checks short-circuit too."""
    enabled = False
    dropped_spans = 0
    finished: deque = deque()

    def start(self, **attrs):
        return None

    def segment(self, name, trace_id, **attrs):
        return NULL_SPAN

    def span(self, name, **attrs):
        return NULL_SPAN

    def finish(self, trace_id):
        return None

    def current_trace_id(self):
        return None

    def get(self, trace_id):
        return None

    def to_chrome(self, include_active: bool = True) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def export_chrome(self, path, include_active: bool = True) -> dict:
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return {"path": str(path), "traces": 0, "events": 0}


NULL_TRACER = NullTracer()
