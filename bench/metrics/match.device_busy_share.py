"""Share of the joins' time the card was busy: the union of the device's
op intervals (torch.profiler) inside the window's ``component`` spans
(D-tree matching and the joins of one query component) over the spans'
summed length.  Low: the joins wait on the host.  Needs the program's
Tracer (``ctx.tracer``, ``bench/spans.py``)."""
from bench.spans import Busy, seconds, window_spans


def read(ctx):
    comps = window_spans(ctx, "component")
    if not comps:
        return None
    busy = Busy(ctx.probe.events)
    total = sum(e - s for s, e in map(seconds, comps))
    inside = sum(busy.within(*seconds(c)) for c in comps)
    return inside / total if total > 0 else None
