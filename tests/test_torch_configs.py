"""Engine configurations beyond the default, port against reference.

The whole grid of join_impl x fuse_joins x connection_impl x plan_mode
(48 configurations) on one small dataset: the port (on the CPU) must
return the reference's result sets, strategies and telemetry, cold and
warm.
"""
import itertools

import pytest

import repro.core as J
import repro.data as JD
import repro_torch.core as T
import repro_torch.data as TD

# join_impl x fuse_joins x connection_impl x plan_mode: the whole grid
CONFIGS = list(itertools.product(("auto", "sorted", "radix", "nested"),
                                 (True, False), ("auto", "reach", "cross"),
                                 ("cost", "greedy")))


@pytest.fixture(scope="module")
def datasets():
    return (J.Dataset.build(JD.dblp_like(scale=0.02, seed=1)),
            T.Dataset.build(TD.dblp_like(scale=0.02, seed=1)))


@pytest.mark.parametrize("join_impl,fuse,conn,plan", CONFIGS)
def test_engine_config_matches_reference(datasets, join_impl, fuse, conn,
                                         plan):
    dj, dt = datasets
    kw = dict(join_impl=join_impl, fuse_joins=fuse, connection_impl=conn,
              plan_mode=plan)
    ej = J.Engine(dj, J.EngineConfig(**kw))
    et = T.Engine(dt, T.EngineConfig(device="cpu", **kw))
    # one query with a connection edge: joins, then the edge
    pj = ej.prepare(JD.random_query(dj.graph, size=5, seed=101,
                                    n_connection=1))
    pt = et.prepare(TD.random_query(dt.graph, size=5, seed=101,
                                    n_connection=1))
    for _ in ("cold", "warm"):
        a, b = ej.execute_prepared(pj), et.execute_prepared(pt)
        assert b.result_set() == a.result_set()
        assert b.stats.join_strategies == a.stats.join_strategies
        assert b.stats.conn_strategies == a.stats.conn_strategies
        assert (b.stats.sorts_performed, b.stats.sorts_avoided) == \
            (a.stats.sorts_performed, a.stats.sorts_avoided)
        assert b.stats.plan_cost == pytest.approx(a.stats.plan_cost)
    assert pt.join_seq == pj.join_seq
