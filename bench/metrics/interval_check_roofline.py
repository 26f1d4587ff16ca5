"""Percent of the interval_check kernel's roofline over the window: the least
time its calls' work needs (``bench/roofline/interval_check.py``) over its device
time (torch.profiler)."""


def read(ctx):
    return ctx.probe.roofline("interval_check")
