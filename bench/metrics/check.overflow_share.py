"""Share of the candidates entering the signature check that passed with
an overflowed NI row in a checked segment, so untested there, in the
window: overflow_passed / candidates of ``telemetry()["check"]``; silent
where the program has no such counts or the check did not run."""


def read(ctx):
    c = ctx.tel.get("check") or {}
    n = c.get("candidates")
    return c["overflow_passed"] / n if n else None
