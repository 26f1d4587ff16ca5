"""Stored NI ids in the checked segments' rows per candidate entering the
signature check, in the window: ids_read / candidates of
``telemetry()["check"]``; silent where the program has no such counts or
the check did not run."""


def read(ctx):
    c = ctx.tel.get("check") or {}
    n = c.get("candidates")
    return c["ids_read"] / n if n else None
