"""Property-based twins (hypothesis) of ``tests/test_serve_properties.py``
and ``tests/test_chaos_properties.py``: any interleaved stream of repeated
and renumbered templates, and any schedule of injected faults, resolve
every future alike on the reference and on the port — the same exact
result or the same typed error — with equal plan-cache, batching and
fault-injection counts."""
import dataclasses

import numpy as np
import pytest

from torch_twin import (REF, forcing_cfg, outcomes, per_stack, permute,
                        telemetry_view, twin)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

POINTS = sorted(REF.testing.INJECTION_POINTS)
KINDS = REF.faults.FAULT_KINDS


@per_stack
def serve_fx(S):
    g = S.graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20, seed=9)
    pool = S.pool(g, 40)
    eng = S.engine(g)
    return g, pool, eng, [eng.execute(q).result_set() for q in pool]


@per_stack
def chaos_fx(S):
    g = S.graph(n_nodes=80, n_edges=220, n_preds=3, n_literals=20, seed=1)
    pool = S.pool(g, 40)
    eng = S.engine(g)
    return g, pool, [eng.execute(q).result_set() for q in pool]


@settings(max_examples=12, deadline=None)
@given(stream=st.lists(st.integers(0, 3), min_size=1, max_size=10),
       chunks=st.integers(1, 4), batching=st.booleans(),
       calibrate=st.booleans(), miscalibrated=st.booleans())
def test_interleaved_stream_identity(stream, chunks, batching, calibrate,
                                     miscalibrated):
    def scenario(S):
        g, pool, _, oracle = serve_fx(S)
        th = (S.core.Thresholds(tau_iter=0.5, tau_join=0.5, tau_sel=0.01)
              if miscalibrated else None)
        srv = S.server(g, batching=batching, calibrate=calibrate,
                       thresholds=th)
        queries = [pool[i] for i in stream]
        step = max(1, len(queries) // chunks)
        futs = []
        for s in range(0, len(queries), step):
            futs.extend(srv.submit_many(queries[s:s + step], wait=True))
        for i, f in zip(stream, futs):
            assert f.result().result_set() == oracle[i]
        assert srv.queries_served == len(stream)
        return outcomes(futs), telemetry_view(srv)
    twin(scenario)


@settings(max_examples=8, deadline=None)
@given(idx=st.integers(0, 3), seed=st.integers(0, 1000))
def test_renumbered_submission_identity(idx, seed):
    def scenario(S):
        g, pool, eng, _ = serve_fx(S)
        q = pool[idx]
        perm = np.random.default_rng(seed).permutation(q.num_nodes).tolist()
        qp = permute(S, q, perm)
        assert S.serve.template_fingerprint(qp) == \
            S.serve.template_fingerprint(q)
        srv = S.server(g)
        srv.query(q)
        res = srv.query(qp)
        assert res.result_set() == eng.execute(qp).result_set()
        assert srv.telemetry()["plan_cache"]["entries"] == 1
        return res.result_set(), res.cols, telemetry_view(srv)["plan_cache"]
    twin(scenario)


@settings(max_examples=8, deadline=None)
@given(schedule=st.lists(
    st.tuples(st.sampled_from(POINTS), st.sampled_from(KINDS),
              st.integers(min_value=1, max_value=6)),
    min_size=1, max_size=3))
def test_any_fault_schedule_same_outcomes(schedule):
    """Any schedule of injected faults on the staged forcing config: every
    future is exact or typed on each side, and the two sides resolve every
    future alike, with the same call counts at every point."""
    def scenario(S):
        g, pool, oracle = chaos_fx(S)
        cfg = dataclasses.replace(forcing_cfg(S), fuse_joins=False)
        srv = S.server(g, cfg=cfg, governor=S.serve.GovernorConfig())
        faults = [S.testing.Fault(p, k, at=at, delay_s=0.002)
                  for p, k, at in schedule]
        with S.testing.FaultInjector(*faults) as fi:
            futs = srv.submit_many(pool, wait=True)
            for i, f in enumerate(futs):
                try:
                    res = f.result()
                except S.serve.ServingError:
                    continue
                assert res.result_set() == oracle[i]
            got = outcomes(futs)
        return got, fi.calls, fi.fired
    twin(scenario)
