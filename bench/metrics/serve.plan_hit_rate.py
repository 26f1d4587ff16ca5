"""Plan-cache hits over lookups in the window (``telemetry()["plan_cache"]``)."""


def read(ctx):
    p = ctx.tel["plan_cache"]
    total = p.get("hits", 0) + p.get("misses", 0)
    return p["hits"] / total if total else None
