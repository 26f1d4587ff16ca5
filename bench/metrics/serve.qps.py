"""Requests answered in the window over its seconds, by the host clock: the
end-to-end ``qps`` of a cell whose runs swing too widely for a bound on it
(PERF.md, section 2)."""


def read(ctx):
    return ctx.values["qps"]
