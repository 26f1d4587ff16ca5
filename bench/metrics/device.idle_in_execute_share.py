"""Share of the traced window the card sat idle while the engine ran:
idle time (outside the union of the device's op intervals, torch.profiler)
inside the window's ``execute`` segments, over the window.
``device.idle_share`` less this is idle time outside the engine.  Needs
the program's Tracer (``ctx.tracer``, ``bench/spans.py``)."""
from bench.spans import Busy, seconds, window_spans


def read(ctx):
    segs = window_spans(ctx, "execute")
    if not segs or ctx.probe.window_s <= 0:
        return None
    busy = Busy(ctx.probe.events)
    idle = sum((e - s) - busy.within(s, e) for s, e in map(seconds, segs))
    return idle / ctx.probe.window_s
