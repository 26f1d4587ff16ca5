"""Mean milliseconds of the engine's prepare (intervals, D-tree
decomposition, the §4.3 decision) per request planned in the window:
``QueryStats.prepare_time`` summed over executions over plan-cache misses.
Host time: device work a stage queued may be charged to a later one."""


def read(ctx):
    misses = ctx.tel["plan_cache"].get("misses", 0)
    s = ctx.tel["stats_rollup"].get("prepare_time")
    return 1e3 * s / misses if misses and s is not None else None
