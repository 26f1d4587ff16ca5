"""1 minus the union of the device's kernel, copy and set intervals over
the traced window (torch.profiler)."""


def read(ctx):
    p = ctx.probe
    return 1.0 - p.busy_s / p.window_s if p.window_s > 0 else None
