"""Milliseconds the host waited in the engine's reads of the device per
execution in the window: the ``sync_wait_ns`` of the window's ``execute``
segments over their number (the answer's own copy left out).  Needs the
program's Tracer (``ctx.tracer``, ``bench/spans.py``)."""
from bench.spans import per_execution


def read(ctx):
    return per_execution(
        ctx, lambda segs: 1e-6 * sum(s.attrs.get("sync_wait_ns", 0)
                                          for s in segs))
