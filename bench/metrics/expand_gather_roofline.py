"""Percent of the expand_gather kernel's roofline over the window: the least
time its calls' work needs (``bench/roofline/expand_gather.py``) over its device
time (torch.profiler)."""


def read(ctx):
    return ctx.probe.roofline("expand_gather")
