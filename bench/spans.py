"""The program's spans beside the device trace: the span metrics' shared
reading, and a traced run of a cell with the program's Tracer on.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--tracer 0|1] [--sync-sites N] [--alternate N]

A span reader (``bench/metrics/<name>.py``) reads ``ctx.tracer``, the
program's ``repro_torch.obs.Tracer`` that held every trace of warm-up and
window, beside ``ctx.probe``.  Spans carry Unix-epoch nanoseconds, the
base of the profiler's events, so a span and the device work inside it
compare directly.  A reader keeps the spans inside the probe's window and
gives nothing where there is no tracer, or where the tracer dropped spans
or traces.

The command runs one cell as ``bench/run.py --trace 1`` does (set-up,
warm-up, the closed loop under the probe), with the program's Tracer on
(``--tracer 1``) or off, and prints one JSON line: the host-clock
``qps``, ``p50_ms``, ``p95_ms``; the span metrics; the device's idle
share; how many of the window's device-to-host copies start inside an
``execute`` segment or a ``copy_out`` span, against the reads the spans
count; and the longest idle gaps, each with the innermost span open
across it and the time the garbage collector ran in it.  It checks no
answer.  ``--sync-sites N`` instead runs the
stream's first N requests under ``torch.cuda.set_sync_debug_mode("warn")``
and prints each line of the program that made the host wait for the card,
with its count.  ``--alternate N`` measures the Tracer's cost on one warm
server: 2N windows of ``--seconds``, the Tracer off and on in turns.
"""
from __future__ import annotations

import bisect
import gc
import time

# -- the span metrics' shared reading ---------------------------------- #


def window_ns(probe) -> tuple[int, int]:
    """The probe's window on the spans' clock: its start, a
    ``perf_counter`` reading, moved to the Unix-epoch base by the offset
    of the two clocks now."""
    offset = time.time_ns() - time.perf_counter_ns()
    lo = int(probe.t0 * 1e9) + offset
    return lo, lo + int(probe.window_s * 1e9)


def window_spans(ctx, name: str) -> list | None:
    """Every span called ``name`` that lies inside the probe's window;
    None without a tracer, or where it dropped a span or a trace."""
    tracer = getattr(ctx, "tracer", None)
    if tracer is None or tracer.dropped_spans > 0:
        return None
    finished = tracer.finished
    if finished.maxlen is not None and len(finished) >= finished.maxlen:
        return None                 # the ring may have dropped traces
    lo, hi = window_ns(ctx.probe)
    return [s for tr in finished for s in tr.spans
            if s.name == name and s.end_ns is not None
            and lo <= s.start_ns and s.end_ns <= hi]


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint pieces."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Busy:
    """The union of the device's op intervals (the probe's events, in
    epoch seconds), for the busy time inside any interval."""

    def __init__(self, events):
        pieces = union((s, e) for _, s, e in events)
        self.starts = [s for s, _ in pieces]
        self.ends = [e for _, e in pieces]
        self.acc = [0.0]
        for s, e in pieces:
            self.acc.append(self.acc[-1] + e - s)

    def within(self, lo: float, hi: float) -> float:
        """Busy seconds inside [lo, hi]."""
        if hi <= lo:
            return 0.0
        i = bisect.bisect_right(self.ends, lo)
        j = bisect.bisect_left(self.starts, hi)
        if i >= j:
            return 0.0
        busy = self.acc[j] - self.acc[i]
        busy -= max(0.0, lo - self.starts[i])
        busy -= max(0.0, self.ends[j - 1] - hi)
        return busy


def seconds(span) -> tuple[float, float]:
    """A span's interval in epoch seconds, the probe's events' unit."""
    return span.start_ns * 1e-9, span.end_ns * 1e-9


def per_execution(ctx, total) -> float | None:
    """``total(segments)`` of the window's ``execute`` segments over their
    number."""
    segs = window_spans(ctx, "execute")
    if not segs:
        return None
    return total(segs) / len(segs)


# -- a traced run with the Tracer on ----------------------------------- #
SPAN_METRICS = ("copy_out.ms", "engine.host_syncs_per_execution",
                "engine.sync_wait_ms", "match.device_busy_share",
                "device.idle_in_execute_share")


def span_path(span) -> str:
    names = []
    while span is not None:
        names.append(span.name)
        span = span.parent
    return "/".join(reversed(names))


class GcPauses:
    """The collections of Python's garbage collector while it is on
    (``gc.callbacks``), as (start, end) epoch seconds: a pause of the
    host that no span names."""

    def __init__(self):
        self.pauses, self._t = [], None

    def __call__(self, phase, info):
        now = time.time_ns() * 1e-9
        if phase == "start":
            self._t = now
        elif self._t is not None:
            self.pauses.append((self._t, now))

    def within(self, lo: float, hi: float) -> float:
        """Seconds of collection inside [lo, hi]."""
        return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in self.pauses)


def gaps_with_spans(probe, tracer, gc_pauses, n: int = 10) -> list:
    """The ``n`` longest idle gaps of the device in the window, each with
    its length in seconds, the innermost span open across the whole gap
    (``outside the program`` where none is) and the seconds of it the
    garbage collector ran (``gc_pauses``)."""
    lo, hi = (x * 1e-9 for x in window_ns(probe))
    pieces = union((s, e) for _, s, e in probe.events)
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(pieces, pieces[1:])
            if lo <= a[1] and b[0] <= hi]
    gaps.sort(reverse=True)
    spans = [s for tr in tracer.finished for s in tr.spans
             if s.end_ns is not None]
    out = []
    for length, g0, g1 in gaps[:n]:
        best = None
        for s in spans:
            s0, s1 = seconds(s)
            if s0 <= g0 and g1 <= s1 and (best is None
                                          or s0 >= seconds(best)[0]):
                best = s
        out.append([length, span_path(best) if best is not None
                    else "outside the program", gc_pauses.within(g0, g1)])
    return out


def copies_in_spans(probe, tracer) -> dict:
    """The window's device-to-host copies against the spans: how many
    start inside an ``execute`` segment or a ``copy_out`` span, and the
    reads the spans count (``host_syncs`` and ``copy_out`` spans)."""
    lo, hi = (x * 1e-9 for x in window_ns(probe))
    copies = sorted(s for n, s, _ in probe.events
                    if ("Memcpy DtoH" in n or "Memcpy_DtoH" in n)
                    and lo <= s <= hi)
    segs = [s for tr in tracer.finished for s in tr.spans
            if s.name in ("execute", "copy_out") and s.end_ns is not None
            and lo <= s.start_ns * 1e-9 and s.end_ns * 1e-9 <= hi]
    inside = union(seconds(s) for s in segs)
    starts = [a for a, _ in inside]
    n_in = 0
    for c in copies:
        k = bisect.bisect_right(starts, c) - 1
        n_in += k >= 0 and c <= inside[k][1]
    execs = [s for s in segs if s.name == "execute"]
    outs = [s for s in segs if s.name == "copy_out"]
    syncs = sum(s.attrs.get("host_syncs", 0) for s in execs)
    return {"dtoh_copies": len(copies), "dtoh_inside": n_in,
            "host_syncs": syncs, "copy_outs": len(outs),
            "copy_outs_nonempty": sum(s.attrs.get("rows", 0) > 0
                                      for s in outs)}


def run_traced(root, name: str, seed: int, secs: float, tracer_on: bool,
               device: str = "cuda", cell=None) -> dict:
    """One traced run of cell ``name`` (the probe on) with the program's
    Tracer on or off; returns the result line's object."""
    from types import SimpleNamespace

    from bench import harness as H
    from bench.trace import Probe
    cell = cell or H.load_cell(root, name)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    g, srv = H.build(cell.config, device, {})
    traffic = H.make_traffic(g, cell.mix, seed, secs)
    pg = srv.dataset.graph
    queries = [H.to_query(pg, r.template) for r in traffic.stream]
    tracer = None
    if tracer_on:
        from repro_torch.obs import Tracer
        tracer = Tracer(max_traces=len(queries) + len(traffic.warmup) + 16)
        # what QueryServer(..., tracer=tracer) sets
        srv.tracer = srv.engine.tracer = tracer
    H.warm_up(srv, [H.to_query(pg, w) for w in traffic.warmup])
    sync = H._sync(device)
    sync()
    probe = Probe(H.BENCH / "roofline", device)
    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    probe.start()
    tel0 = srv.telemetry()
    loop = H.closed_loop(srv, queries, int(cell.mix["clients"]), secs,
                         lambda i, res: None)
    sync()
    tel1 = srv.telemetry()
    probe.stop()
    gc.callbacks.remove(gc_pauses)
    lat_ms = [x * 1e3 for x in loop["latency_s"]]
    values = {"qps": (loop["attempted"] - loop["failed"]) / loop["window_s"],
              "p50_ms": H.percentile(lat_ms, 50),
              "p95_ms": H.percentile(lat_ms, 95)}
    ctx = SimpleNamespace(tel=H._delta(tel0, tel1), window_s=loop["window_s"],
                          probe=probe, values=values, tracer=tracer)
    metrics = {m: H.load_reader(m)(ctx)
               for m in SPAN_METRICS + ("device.idle_share",)}
    out = {"workload": name, "seed": seed, "tracer": tracer_on,
           "failed": loop["failed"], "attempted": loop["attempted"],
           **values, "metrics": metrics, "window_s": loop["window_s"],
           "busy_s": probe.busy_s}
    if tracer is not None:
        out["copies"] = copies_in_spans(probe, tracer)
        out["idle_gaps"] = gaps_with_spans(probe, tracer, gc_pauses)
    lo, hi = (x * 1e-9 for x in window_ns(probe))
    out["gc_s"] = gc_pauses.within(lo, hi)
    return out


def sync_sites(root, name: str, seed: int, n: int, device: str = "cuda",
               cell=None) -> dict:
    """Lines of the program where the host waited for the card while the
    first ``n`` requests of the cell's stream ran, with their counts."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    from bench import harness as H
    cell = cell or H.load_cell(root, name)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    g, srv = H.build(cell.config, device, {})
    traffic = H.make_traffic(g, cell.mix, seed, 1.0)
    pg = srv.dataset.graph
    H.warm_up(srv, [H.to_query(pg, w) for w in traffic.warmup])
    queries = [H.to_query(pg, r.template) for r in traffic.stream[:n]]
    sites: Counter = Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        # a read through obs.trace.to_host is named by its caller
        callers = [f for f in frames if "obs/trace.py" not in f.filename]
        if callers:
            f = callers[-1]
            how = "to_host " if frames[-1] is not f else ""
            sites[f"{how}{f.filename.split('src/')[-1]}:{f.lineno} "
                  f"{f.line}"] += 1

    warnings.showwarning = note
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
        clients = int(cell.mix["clients"])
        for i in range(0, len(queries), clients):
            for f in srv.submit_many(queries[i:i + clients], wait=True):
                f.result()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return {"workload": name, "requests": len(queries),
            "sites": sites.most_common()}


def alternate(root, name: str, seed: int, secs: float, n: int,
              device: str = "cuda", cell=None) -> dict:
    """The Tracer's cost on one warm server: 2n windows of ``secs``
    seconds, the Tracer off and on in turns (off, on, on, off, ...), each
    window taking the stream's next requests; the host-clock ``qps`` of
    each, and the median over pairs of on / off."""
    import statistics

    from bench import harness as H
    from repro_torch.obs import NULL_TRACER, Tracer
    cell = cell or H.load_cell(root, name)
    if device == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    g, srv = H.build(cell.config, device, {})
    traffic = H.make_traffic(g, cell.mix, seed, secs * 2 * n)
    pg = srv.dataset.graph
    queries = [H.to_query(pg, r.template) for r in traffic.stream]
    tracer = Tracer(max_traces=len(queries) + 16)
    H.warm_up(srv, [H.to_query(pg, w) for w in traffic.warmup])
    sync = H._sync(device)
    sync()
    clients, i, qps = int(cell.mix["clients"]), 0, {False: [], True: []}
    for k in range(2 * n):
        on = k % 4 in (1, 2)
        srv.tracer = srv.engine.tracer = tracer if on else NULL_TRACER
        loop = H.closed_loop(srv, queries[i:], clients, secs,
                             lambda j, res: None)
        sync()
        i += loop["attempted"]
        qps[on].append((loop["attempted"] - loop["failed"])
                       / loop["window_s"])
    ratios = [a / b for a, b in zip(qps[True], qps[False])]
    return {"workload": name, "seed": seed, "seconds": secs,
            "qps_off": qps[False], "qps_on": qps[True],
            "on_over_off_median": statistics.median(ratios),
            "dropped_spans": tracer.dropped_spans}


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sync-sites", type=int, default=0, metavar="N")
    ap.add_argument("--alternate", type=int, default=0, metavar="N")
    args = ap.parse_args(argv)
    if args.alternate:
        out = alternate(root, args.workload, args.seed, args.seconds,
                        args.alternate)
    elif args.sync_sites:
        out = sync_sites(root, args.workload, args.seed, args.sync_sites)
    else:
        out = run_traced(root, args.workload, args.seed, args.seconds,
                         bool(args.tracer))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
