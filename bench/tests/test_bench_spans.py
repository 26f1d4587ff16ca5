"""The span metrics: each reader on a hand-built window of the program's
spans and device events, their silence where the program's Tracer is
absent or lost spans, and a traced run with the Tracer on at a size a
test holds."""
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import spans
from bench.harness import load_reader
from repro_torch.obs import Tracer

ROOT = Path(__file__).resolve().parent.parent.parent
MS = 10**6


def window(tracer, base_ns, t0, events):
    """A ctx whose probe opened its 1 s window at ``base_ns`` (epoch) =
    ``t0`` (perf_counter); events are (name, start ms, end ms) in it."""
    probe = SimpleNamespace(
        t0=t0, window_s=1.0,
        events=[(n, (base_ns + s * MS) * 1e-9, (base_ns + e * MS) * 1e-9)
                for n, s, e in events])
    return SimpleNamespace(tel={}, window_s=1.0, probe=probe, values={},
                           tracer=tracer)


def execution(tr, base_ns, at, comp, out, syncs, wait_ms):
    """One traced execution: an execute segment over ``at`` (ms after
    ``base_ns``) holding a component span and a copy_out span."""
    tid = tr.start()
    with tr.segment("execute", tid) as seg:
        with tr.span("component") as c:
            pass
        with tr.span("copy_out") as o:
            pass
    seg.set(host_syncs=syncs, sync_wait_ns=wait_ms * MS)
    for sp, (s, e) in ((seg, at), (c, comp), (o, out)):
        sp.start_ns, sp.end_ns = base_ns + s * MS, base_ns + e * MS
    tr.finish(tid)


@pytest.fixture
def ctx():
    base_ns, t0 = time.time_ns(), time.perf_counter()
    tr = Tracer()
    execution(tr, base_ns, (100, 300), (120, 220), (250, 260), 3, 2)
    execution(tr, base_ns, (500, 600), (510, 560), (580, 600), 5, 4)
    # after the window: left out
    execution(tr, base_ns, (1500, 1600), (1510, 1560), (1580, 1600), 7, 9)
    return window(tr, base_ns, t0,
                  [("k1", 150, 170), ("k2", 200, 240), ("k3", 520, 530),
                   ("Memcpy DtoH", 525, 540), ("k4", 700, 800)])


WANT = {"copy_out.ms": (10 + 20) / 2,
        "engine.host_syncs_per_execution": (3 + 5) / 2,
        "engine.sync_wait_ms": (2 + 4) / 2,
        # busy 20 + 20 of [120, 220], 20 of [510, 560]
        "match.device_busy_share": 60 / 150,
        # idle 200 - 60 in [100, 300], 100 - 20 in [500, 600], of 1000
        "device.idle_in_execute_share": 220 / 1000}


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_reader_on_a_hand_built_window(ctx, name):
    assert load_reader(name)(ctx) == pytest.approx(WANT[name], abs=1e-4)


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_reader_is_silent_without_the_tracer_or_with_lost_spans(ctx, name):
    read = load_reader(name)
    no_tracer = SimpleNamespace(**{k: v for k, v in vars(ctx).items()
                                   if k != "tracer"})
    assert read(no_tracer) is None
    ctx.tracer.dropped_spans = 1
    assert read(ctx) is None
    ctx.tracer.dropped_spans = 0
    full = Tracer(max_traces=len(ctx.tracer.finished))
    full.finished.extend(ctx.tracer.finished)
    ctx.tracer = full
    assert read(ctx) is None


def test_busy_time_inside_an_interval():
    busy = spans.Busy([("a", 1.0, 2.0), ("b", 1.5, 3.0), ("c", 5.0, 6.0)])
    assert busy.within(0.0, 10.0) == pytest.approx(3.0)
    assert busy.within(2.5, 5.5) == pytest.approx(1.0)
    assert busy.within(1.2, 1.4) == pytest.approx(0.2)
    assert busy.within(3.0, 5.0) == 0.0


def test_copies_and_gaps_are_put_in_their_spans(ctx):
    got = spans.copies_in_spans(ctx.probe, ctx.tracer)
    assert got == {"dtoh_copies": 1, "dtoh_inside": 1, "host_syncs": 8,
                   "copy_outs": 2, "copy_outs_nonempty": 0}
    pauses = spans.GcPauses()
    lo = ctx.probe.events[0][1]             # the first op's start
    pauses.pauses = [(lo + 0.10, lo + 0.13)]    # inside the 280 ms gap
    gaps = spans.gaps_with_spans(ctx.probe, ctx.tracer, pauses, n=3)
    assert [path for _, path, _ in gaps] == ["outside the program",
                                             "outside the program",
                                             "execute/component"]
    assert [g for g, _, _ in gaps] == pytest.approx([0.28, 0.16, 0.03],
                                                    abs=1e-6)
    assert [gc for _, _, gc in gaps] == pytest.approx([0.03, 0, 0],
                                                      abs=1e-6)


@pytest.mark.parametrize("name", ["lubm1.replay", "lubm1.fresh"])
def test_traced_run_with_the_tracer_reports_the_span_metrics(tiny_cell,
                                                             name):
    cell = tiny_cell(name)
    on = spans.run_traced(ROOT, name, 2**31 + 17, 1.0, True, device="cpu",
                          cell=cell)
    assert on["failed"] == 0 and on["attempted"] > 0
    m = on["metrics"]
    assert all(m[k] is not None for k in spans.SPAN_METRICS), m
    assert 0 < m["match.device_busy_share"] <= 1
    assert 0 <= m["device.idle_in_execute_share"] \
        <= m["device.idle_share"] + 1e-9
    assert m["engine.host_syncs_per_execution"] > 0
    assert on["copies"]["copy_outs"] > 0 and len(on["idle_gaps"]) > 0
    off = spans.run_traced(ROOT, name, 2**31 + 17, 1.0, False,
                           device="cpu", cell=cell)
    assert all(off["metrics"][k] is None for k in spans.SPAN_METRICS)


def test_alternating_windows_measure_the_tracers_cost(tiny_cell):
    cell = tiny_cell("lubm1.replay")
    out = spans.alternate(ROOT, "lubm1.replay", 2**31 + 17, 0.3, 2,
                          device="cpu", cell=cell)
    assert len(out["qps_off"]) == len(out["qps_on"]) == 2
    assert min(out["qps_off"] + out["qps_on"]) > 0
    assert out["on_over_off_median"] > 0 and out["dropped_spans"] == 0
