"""Reads of the device the engine made per execution in the window: the
``host_syncs`` of the window's ``execute`` segments (each a copy to the
host that waits for the card, the answer's own copy left out) over their
number.  Needs the program's Tracer (``ctx.tracer``, ``bench/spans.py``)."""
from bench.spans import per_execution


def read(ctx):
    return per_execution(
        ctx, lambda segs: sum(s.attrs.get("host_syncs", 0)
                                   for s in segs))
