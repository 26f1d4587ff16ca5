"""Percent of the merge_probe kernel's roofline over the window: the least
time its calls' work needs (``bench/roofline/merge_probe.py``) over its device
time (torch.profiler)."""


def read(ctx):
    return ctx.probe.roofline("merge_probe")
