"""Share of the window's executions whose §4.3 decision ran the signature
check (``QueryStats.used_check``); in a cell of fresh templates every
execution is a planned request."""


def read(ctx):
    n = ctx.tel["batch"].get("executions", 0)
    s = ctx.tel["stats_rollup"].get("used_check")
    return s / n if n and s is not None else None
