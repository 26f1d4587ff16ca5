"""Median latency of the window's requests, in ms, by the host clock: the
end-to-end ``p50_ms`` of a cell whose runs swing too widely for a bound on
it (PERF.md, section 2)."""


def read(ctx):
    return ctx.values["p50_ms"]
