"""Mean milliseconds of the answer's copy to the host (the program's
``copy_out`` spans) per execution in the window (``execute`` segments).
Needs the program's Tracer (``ctx.tracer``, ``bench/spans.py``)."""
from bench.spans import window_spans


def read(ctx):
    segs, outs = window_spans(ctx, "execute"), window_spans(ctx, "copy_out")
    if not segs or outs is None:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in outs) / len(segs)
