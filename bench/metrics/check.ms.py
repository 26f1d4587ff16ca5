"""Mean milliseconds of the signature check (``QueryStats.check_time``)
per execution in the window, over executions that used it or not."""


def read(ctx):
    n = ctx.tel["batch"].get("executions", 0)
    s = ctx.tel["stats_rollup"].get("check_time")
    return 1e3 * s / n if n and s is not None else None
