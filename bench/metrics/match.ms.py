"""Mean milliseconds of D-tree matching and the joins
(``QueryStats.match_time``) per execution in the window."""


def read(ctx):
    n = ctx.tel["batch"].get("executions", 0)
    s = ctx.tel["stats_rollup"].get("match_time")
    return 1e3 * s / n if n and s is not None else None
