"""Engine executions the shape batcher ran per query it admitted in the
window (``telemetry()["batch"]``): below 1 where one execution answered
several requests of one template."""


def read(ctx):
    b = ctx.tel["batch"]
    return b["executions"] / b["queries"] if b.get("queries") else None
