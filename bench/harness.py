"""One run of one cell: set-up, the measured window, the check, the result.

The cell, its configuration and its traffic mix come from files found by
name: ``BENCHMARK.json`` names the cell's configuration file and traffic
mix, ``bench/mixes/<traffic>.json`` holds the mix, and each per-layer
metric is read by ``bench/metrics/<name>.py``.  The program under test is
``repro_torch.serve.QueryServer`` over ``repro_torch.core.Dataset``; the
harness drives it through ``submit`` and ``flush`` and reads its
telemetry, its ``QueryStats`` and, in a traced run, the shapes of its
kernel calls.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .gen import triples
from .gen.traffic import make_traffic
from .reference.compare import judge
from .reference.graph import Graph

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class SetupError(RuntimeError):
    """The run cannot measure what the cell asks (no card, no program,
    an exhausted stream); it prints no result."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    mix and metrics."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SetupError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def here(metric):
        return name in metric.get("workloads", [name])

    return SimpleNamespace(
        name=name, chips=int(w["chips"]),
        config=load_json(root / cfg["file"]),
        mix=load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if here(m)],
        per_layer=[m for m in spec["per_layer"] if here(m)])


def load_reader(name: str):
    """``read(ctx)`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (inclusive quantiles)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


# ---------------------------------------------------------------------- #
def bench_graph(config: dict) -> Graph:
    """The benchmark's own index of the configuration's triples."""
    tr = triples(config)
    return Graph(tr.subs, tr.preds, tr.objs, tr.literals)


def build(config: dict, device: str, marks: dict):
    """The configuration's triples, the benchmark's own index of them, and
    the program's Dataset and QueryServer over them.  ``marks`` gets the
    seconds each step took."""
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.graph import RDFGraph
    from repro_torch.serve import QueryServer
    t = time.perf_counter()

    def mark(step):
        nonlocal t
        now = time.perf_counter()
        marks[step] = now - t
        t = now

    tr = triples(config)
    mark("triples")
    g = Graph(tr.subs, tr.preds, tr.objs, tr.literals)
    mark("bench_index")
    pg = RDFGraph.from_triples(
        zip(tr.subs.tolist(), tr.preds.tolist(), tr.objs.tolist()),
        literal_objects=tr.literals)
    mark("program_graph")
    ds = Dataset.build(pg, config["variant"])
    mark("dataset_build")
    srv = QueryServer(ds, config["variant"], device=device)
    srv.engine.cfg.max_rows = int(config["max_rows"])
    mark("server")
    return g, srv


def to_query(pg, t):
    """The program's QueryTemplate of a benchmark template."""
    from repro_torch.core.query import QueryEdge, QueryTemplate
    return QueryTemplate(keywords=list(t.keywords),
                         edges=[QueryEdge(a, b, pg.predicate_id(p))
                                for a, b, p in t.edges])


def warm_up(srv, queries) -> None:
    """Run each query once, as the window would: a failure fails set-up."""
    futs = srv.submit_many(queries, wait=True)
    for f in futs:
        f.result()


def closed_loop(srv, queries, clients: int, seconds: float, keep) -> dict:
    """Each of ``clients`` clients keeps one request outstanding: a step
    submits every client's next request, flushes, and hands each its
    result.  Steps start until ``seconds`` have passed; the window ends
    when the last step's flush returns.  ``keep(i, result)`` sees every
    answered request."""
    lat, failed, errors, steps, ends = [], 0, [], [], []
    i, n = 0, len(queries)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    t_end = t0
    while time.perf_counter() < deadline:
        if i + clients > n:
            raise SetupError(f"the stream's {n} requests ran out after "
                             f"{t_end - t0:.1f} s; make per_second larger")
        subs = []
        for q in queries[i:i + clients]:
            subs.append((time.perf_counter(), srv.submit(q)))
        t_flush = time.perf_counter()
        srv.flush()
        t_end = time.perf_counter()
        steps.append((t_end - t_flush, i))
        ends.append(t_end - t0)
        for k, (ts, f) in enumerate(subs):
            lat.append(t_end - ts)
            try:
                res = f.result()
            except Exception as e:          # noqa: BLE001 - counted, shown
                failed += 1
                if len(errors) < 5:
                    errors.append(f"request {i + k}: {type(e).__name__}: "
                                  f"{e}")
                continue
            keep(i + k, res)
        i += clients
    return {"t0": t0, "window_s": t_end - t0, "attempted": i,
            "failed": failed, "errors": errors, "latency_s": lat,
            "steps": steps, "ends": ends}


class Reservoir:
    """A sample of ``k`` answered requests drawn from the seed (algorithm
    R): each answered request is in it with the same chance."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1

    def __call__(self, i: int, res) -> None:
        """Offer answered request ``i``: its result, kept by reference
        (no copy inside the window)."""
        self.offer((i, res))


def _delta(a: dict, b: dict) -> dict:
    """b - a over the numbers of two telemetry snapshots, nested."""
    out = {}
    for k, v in b.items():
        if isinstance(v, dict) and isinstance(a.get(k), dict):
            out[k] = _delta(a[k], v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                and isinstance(a.get(k), (int, float)):
            out[k] = v - a[k]
    return out


# ---------------------------------------------------------------------- #
def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             cell=None) -> dict:
    """One run: returns the result line's object (``checks`` last).
    ``device="cpu"`` is for tests of the harness; the command line never
    passes it."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or load_cell(root, name)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            raise SetupError(f"cell {name} needs {cell.chips} CUDA "
                             "device(s); none or too few found")
        from repro_torch.kernels import _build
        _build.build_all()
        torch.cuda.reset_peak_memory_stats()
    cfg, mix = cell.config, cell.mix
    marks = {"start": time.perf_counter() - t_start}
    g, srv = build(cfg, device, marks)
    t = time.perf_counter()
    traffic = make_traffic(g, mix, seed, seconds)
    pg = srv.dataset.graph
    queries = [to_query(pg, r.template) for r in traffic.stream]
    marks["traffic"] = time.perf_counter() - t
    t = time.perf_counter()
    warm_up(srv, [to_query(pg, w) for w in traffic.warmup])
    sync = _sync(device)
    sync()
    marks["warm_up"] = time.perf_counter() - t

    probe = None
    if trace:
        from .trace import Probe
        probe = Probe(BENCH / "roofline", device)
        probe.start()
    tel0 = srv.telemetry()
    sample = Reservoir(int(mix["sample"]), seed)
    setup_s = time.perf_counter() - t_start
    loop = closed_loop(srv, queries, int(mix["clients"]), seconds, sample)
    sync()
    tel1 = srv.telemetry()
    if probe is not None:
        probe.stop()
    memory_peak = _memory_peak(device)

    # the program's state goes before the reference runs
    del srv, pg, queries
    t_ref = time.perf_counter()
    verdict = judge(g, traffic.templates,
                    ((traffic.stream[i], res.rows[:, np.argsort(res.cols)],
                      bool(res.stats.truncated))
                     for i, res in sample.items),
                    int(cfg["max_rows"]))
    reference_s = time.perf_counter() - t_ref

    lat_ms = [x * 1e3 for x in loop["latency_s"]]
    answered = loop["attempted"] - loop["failed"]
    values = {"qps": answered / loop["window_s"],
              "p50_ms": percentile(lat_ms, 50),
              "p95_ms": percentile(lat_ms, 95),
              "setup_s": setup_s}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_kind(device), "count": cell.chips,
           "memory_peak_bytes": memory_peak}
    ctx_tel = _delta(tel0, tel1)
    out = {"correct": None, "attempted": loop["attempted"],
           "failed": loop["failed"]}
    if trace:
        # what a per-layer reader sees: the window's telemetry delta, the
        # probe, and the host-clock numbers of the window
        ctx = SimpleNamespace(tel=ctx_tel, window_s=loop["window_s"],
                              probe=probe, values=values)
        metrics = {}
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = probe.busy_s
        dev["window_s"] = probe.window_s
        out["breakdown"] = probe.breakdown()
    else:
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    checks = {
        "failed_requests": {"value": loop["failed"], "limit": 0},
        "mismatched_answers": {"value": verdict["mismatched"], "limit": 0},
        "answers_checked_at_least": {"value": verdict["checked"],
                                     "limit": 1},
    }
    correct = (loop["failed"] == 0 and verdict["mismatched"] == 0
               and verdict["checked"] >= 1)
    out.update(correct=correct, metrics=metrics, device=dev)
    steps = sorted(loop["steps"], reverse=True)
    slow = [[round(d, 4), sorted({traffic.stream[j].base
                                  for j in range(i, i + int(mix["clients"]))})]
            for d, i in steps[:6]]
    flush_s = [d for d, _ in loop["steps"]]
    out["notes"] = {"setup_split_s": marks,
                    "flushes": len(flush_s),
                    "flush_s_quartiles": (statistics.quantiles(flush_s, n=4)
                                          if len(flush_s) > 1 else flush_s),
                    "slowest_flushes": slow,
                    "flush_ms_by_sixth": _by_sixth(flush_s, loop["ends"]),
                    "telemetry_delta": {k: ctx_tel.get(k) for k in
                                        ("plan_cache", "batch",
                                         "stats_rollup")},
                    "reference_s": reference_s,
                    "cut_answers_checked": verdict["cut"],
                    "errors": loop["errors"], "mismatches": verdict["notes"],
                    "window_s": loop["window_s"], "seed": seed}
    out["checks"] = checks
    return out


def _by_sixth(flush_s: list, ends: list) -> list:
    """The mean flush time, in ms, of each sixth of the window (by when
    the flush ended): shows whether a slow run is slow throughout."""
    if not ends:
        return []
    span = ends[-1] / 6 or 1.0
    parts = [[] for _ in range(6)]
    for d, e in zip(flush_s, ends):
        parts[min(int(e / span), 5)].append(d)
    return [round(1e3 * statistics.fmean(p), 3) if p else None
            for p in parts]


def _sync(device: str):
    if device == "cuda":
        import torch
        return torch.cuda.synchronize
    return lambda: None


def _memory_peak(device: str) -> int:
    if device == "cuda":
        import torch
        return int(torch.cuda.max_memory_allocated())
    return 0


def _device_kind(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device
