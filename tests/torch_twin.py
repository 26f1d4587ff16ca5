"""Twin harness for the serving-tier parity tests (``test_torch_serve*.py``).

A twin test runs one scenario on both stacks — the JAX package ``repro``
(the reference) and the PyTorch port ``repro_torch`` on the CPU — with the
same graphs, seeds and request streams, and holds what each side observed
equal, exactly: result sets, the type and phase of every failed future,
cache / batching / governor / metrics counters, ``budget_checks`` and the
EXPLAIN text.  Only wall-clock readings (latencies, ``*_time`` sums, the
``prepare_time`` line of EXPLAIN, snapshot ages) are masked.

A scenario is ``fn(S, *args)`` over a :class:`Stack`; it may assert the
reference test's own claims on each side, and returns its observations.
"""
from __future__ import annotations

import dataclasses
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

import repro.core as JC
import repro.core.engine as JENG
import repro.core.graph as JGRAPH
import repro.core.matching as JMATCH
import repro.core.planner as JPLAN
import repro.core.query as JQ
import repro.data as JD
import repro.obs as JO
import repro.obs.metrics as JMET
import repro.serve as JS
import repro.serve.snapshot as JSNAP
import repro.testing as JT
import repro.testing.faults as JF
import repro_torch.core as TC
import repro_torch.core.engine as TENG
import repro_torch.core.graph as TGRAPH
import repro_torch.core.matching as TMATCH
import repro_torch.core.planner as TPLAN
import repro_torch.core.query as TQ
import repro_torch.data as TD
import repro_torch.obs as TO
import repro_torch.obs.metrics as TMET
import repro_torch.serve as TS
import repro_torch.serve.snapshot as TSNAP
import repro_torch.testing as TT
import repro_torch.testing.faults as TF


class Stack(SimpleNamespace):
    """One side of a twin: the package's modules under common names, and
    factories that pin the kernels to their plain versions (``impl="ref"``)
    and, on the port, the device to the CPU."""

    def _kw(self, kw: dict) -> dict:
        kw.setdefault("impl", "ref")
        if self.port:
            kw.setdefault("device", "cpu")
        return kw

    def cfg(self, **kw):
        return self.core.EngineConfig(**self._kw(kw))

    def engine(self, data, variant: str = "rdf_h"):
        return self.core.make_engine(data, variant, **self._kw({}))

    def server(self, data, **kw):
        if "cfg" not in kw:
            kw = self._kw(kw)
        return self.serve.QueryServer(data, **kw)

    def graph(self, **kw):
        return self.data.random_graph(**kw)

    def query(self, graph, **kw):
        return self.data.random_query(graph, **kw)

    def pool(self, graph, seed0: int, n: int = 4, size: int = 4):
        return [self.query(graph, size=size, seed=seed0 + i,
                           n_connection=i % 2, d_c=2) for i in range(n)]

    def table(self, cols, data):
        """The reference tests' ``mk_table``: int32 rows padded with -1 to
        a power-of-2 capacity, as this package's array type."""
        data = np.asarray(data, np.int32).reshape(-1, len(cols))
        rows = np.full((self.matching._pow2(len(data)), len(cols)), -1,
                       np.int32)
        rows[: len(data)] = data
        return self.matching.Table(cols=tuple(cols),
                                   rows=self.array(rows), count=len(data))


# check: the name under which each engine module calls the signature
# check, per node on the reference, per template on the port
REF = Stack(name="repro", port=False, core=JC, engine_mod=JENG,
            check="check_interval_candidates",
            graph_mod=JGRAPH, array=jnp.asarray, matching=JMATCH,
            planner=JPLAN, qmod=JQ, data=JD, obs=JO, metrics=JMET, serve=JS,
            snapshot=JSNAP, testing=JT, faults=JF)
PORT = Stack(name="repro_torch", port=True, core=TC, engine_mod=TENG,
             check="check_template",
             graph_mod=TGRAPH, array=torch.as_tensor, matching=TMATCH,
             planner=TPLAN, qmod=TQ, data=TD, obs=TO, metrics=TMET,
             serve=TS, snapshot=TSNAP, testing=TT, faults=TF)


def per_stack(fn):
    """Cache ``fn(S)`` once per stack — a module's graph and query pool,
    built on each side from the same seeds."""
    cache: dict = {}

    def get(S):
        if S.name not in cache:
            cache[S.name] = fn(S)
        return cache[S.name]
    get.__name__ = fn.__name__
    return get


def twin(scenario, *args, **kw):
    """Run ``scenario`` on the reference, then on the port; assert the two
    observations equal and return the reference's."""
    want = scenario(REF, *args, **kw)
    got = scenario(PORT, *args, **kw)
    assert got == want, (scenario.__name__, got, want)
    return want


# ------------------------- observation helpers ------------------------- #
def freeze(x):
    """`x` as plain values that compare exactly across the packages:
    arrays (numpy, JAX, torch) become (dtype, shape, nested lists);
    dataclasses, dicts, lists, tuples and sets are walked; numpy scalars
    become Python numbers."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: freeze(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif isinstance(x, jnp.ndarray):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {freeze(k): freeze(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(freeze(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(freeze(v) for v in x)
    return x


def dataset_view(ds) -> dict:
    """Everything a Dataset derives from its triples, frozen: identity
    (digest, version, cache key), delta bookkeeping, the graph's arrays
    and both CSRs, every NI entry and the stats."""
    g = ds.graph
    return freeze({
        "digest": ds.digest, "version": ds.version,
        "cache_key": ds.cache_key, "delta_info": ds.delta_info,
        "touched": ds.touched, "delta_endpoints": ds.delta_endpoints,
        "literal_forced": ds.literal_forced,
        "graph": {k: getattr(g, k) for k in (
            "labels", "node_kind", "src", "dst", "pred", "predicates",
            "pred_kind", "out_csr", "in_csr")},
        "ni": (ds.ni.d_max, ds.ni.m, ds.ni.variant, ds.ni.vc_mask,
               ds.ni.entries),
        "stats": ds.stats})


def table_view(t) -> tuple:
    """A join's output table: columns, count, truncation, order tag and
    its rows in order."""
    return (tuple(int(c) for c in t.cols), int(t.count), bool(t.truncated),
            t.sort_order, freeze(t.numpy()))


def outcome(fut):
    """What a future resolved to: the result set with its serving stamps,
    or the failure's type, phase, reason and cause."""
    try:
        res = fut.result()
    except Exception as e:               # noqa: BLE001 — any resolution
        cause = e.__cause__
        return ("error", type(e).__name__, fut._phase,
                getattr(e, "phase", None), getattr(e, "reason", None),
                None if cause is None else type(cause).__name__,
                tuple((name, type(err).__name__)
                      for name, err in getattr(e, "attempts", ())))
    return ("ok", res.result_set(), tuple(res.stats.degraded_steps),
            res.stats.budget_checks, bool(res.stats.cache_hit),
            bool(res.stats.result_cache_hit))


def outcomes(futures) -> list:
    return [outcome(f) for f in futures]


def run_stats(res) -> dict:
    """The count-valued QueryStats of one execution (no wall times)."""
    d = res.stats.to_dict()
    return {k: v for k, v in d.items() if not k.endswith("_time")}


# What the port's traces hold beyond the reference's, and the one thing a
# trace comparison drops: the span of the answer's copy to the host
# (``copy_out``, with its ``rows`` and ``bytes``), and the ``execute``
# segment's count of the engine's device reads (``host_syncs``) and the
# host time blocked in them (``sync_wait_ns``), and the ``check`` span's
# counts of what the signature check did (``CheckCounts``' fields).
PORT_ONLY_TRACE = ("copy_out", "host_syncs", "sync_wait_ns", "check_nodes",
                   "check_candidates", "check_passed",
                   "check_overflow_passed", "check_ids_read", "check_syncs")


def trace_spans(trace) -> list:
    """A finished trace's span names in order, without the port's own."""
    return [s.name for s in trace.spans if s.name not in PORT_ONLY_TRACE]


def chrome_events(doc) -> list:
    """A Chrome trace export's events without the port's own spans, and
    their args without the port's own keys."""
    out = []
    for ev in doc["traceEvents"]:
        if ev["name"] in PORT_ONLY_TRACE:
            continue
        ev = dict(ev, args={k: v for k, v in ev["args"].items()
                            if k not in PORT_ONLY_TRACE})
        out.append(ev)
    return out


def mask_explain(text: str) -> str:
    return re.sub(r"prepare_time=\S+", "prepare_time=*", text)


def telemetry_view(srv) -> dict:
    """``QueryServer.telemetry()`` without its wall-clock readings:
    latency histograms keep their counts, the rollup drops its ``*_time``
    sums, the snapshot block drops its age, and the port's own ``check``
    counts go.  Everything else — plan, result and reach caches,
    batching, calibration, governor counters, metrics counters and
    gauges — stays, to be held equal."""
    t = srv.telemetry()
    t.pop("check", None)            # the port's own
    t["latency"] = {k: t["latency"][k] for k in ("n_cold", "n_warm")}
    hist = t["metrics"]["histograms"]
    for name, h in list(hist.items()):
        hist[name] = ({"count": h["count"]} if name.endswith("_s")
                      else h)
    t["stats_rollup"] = {k: v for k, v in t["stats_rollup"].items()
                         if not k.endswith("_time")}
    if t["governor"] is not None and t["governor"]["snapshot"] is not None:
        t["governor"]["snapshot"].pop("age_s")
    return t


def permute(S, query, perm):
    """Renumber a template's nodes: original node i becomes perm[i]."""
    inv = {p: i for i, p in enumerate(perm)}
    return S.qmod.QueryTemplate(
        keywords=[query.keywords[inv[j]] for j in range(len(perm))],
        edges=[S.qmod.QueryEdge(perm[e.src], perm[e.dst], e.pred)
               for e in query.edges],
        connections=[S.qmod.ConnectionEdge(perm[c.src], perm[c.dst],
                                           c.max_dist, c.bidirectional)
                     for c in query.connections])


def forcing_cfg(S, point: str = "kernel_dispatch"):
    """The chaos suite's engine config (``tests/test_chaos.py``): every
    join through the seam under test, every connection edge through the
    reach-join."""
    join_impl = "radix" if point == "radix_probe" else "sorted"
    return S.cfg(check_policy="selective", d_check=2,
                 thresholds=S.core.Thresholds(nested_join_max=1),
                 join_impl=join_impl, fuse_joins=point == "fused_probe",
                 connection_impl="reach")
