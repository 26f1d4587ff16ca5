"""Times the signature check made the host wait on the device (a read, or
an upload that blocks) per query node it checked, in the window: syncs /
nodes of ``telemetry()["check"]``; silent where the program has no such
count or the check did not run."""


def read(ctx):
    c = ctx.tel.get("check") or {}
    n = c.get("nodes")
    return c["syncs"] / n if n and "syncs" in c else None
