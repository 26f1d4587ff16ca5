"""Share of the candidates entering the signature check that it pruned
in the window: 1 - passed / candidates of ``telemetry()["check"]``
(``CheckCounts``); silent where the program has no such counts or the
check did not run."""


def read(ctx):
    c = ctx.tel.get("check") or {}
    n = c.get("candidates")
    return 1.0 - c["passed"] / n if n else None
