"""The benchmark's template sampler and traffic generator."""
import numpy as np
import pytest

from bench.gen import triples
from bench.gen.templates import canonical, random_template
from bench.gen.traffic import deck, make_traffic, zipf_ranks
from bench.reference.graph import Graph


@pytest.fixture(scope="module", params=[3, 2**32 + 7])
def graphs(request):
    """Two departments of a UBA university from two data seeds."""
    from repro_torch.core.graph import RDFGraph
    mp = pytest.MonkeyPatch()
    mp.setattr("bench.gen.uba.DEPARTMENTS", (2, 2))
    tr = triples({"generator": "uba", "universities": 1,
                  "data_seed": request.param})
    mp.undo()
    g = Graph(tr.subs, tr.preds, tr.objs, tr.literals)
    pg = RDFGraph.from_triples(
        zip(tr.subs.tolist(), tr.preds.tolist(), tr.objs.tolist()),
        literal_objects=tr.literals)
    return g, pg


def test_benchmarks_index_numbers_as_the_port_does(graphs):
    g, pg = graphs
    assert (g.labels == pg.labels).all()
    assert (g.src == pg.src).all() and (g.dst == pg.dst).all()
    assert (g.predicates == pg.predicates).all()
    assert (g.literal == (pg.node_kind == 1)).all()


@pytest.mark.parametrize("seed", [0, 1, 7, 2**33 + 5])
def test_sampler_draws_the_ports_templates(graphs, seed):
    """The same draws on the same edge order: every incident edge comes
    with the port's probability, template for template."""
    from repro_torch.data.queries import random_query
    g, pg = graphs
    for k in range(6):
        q = random_query(pg, size=6, seed=seed + k)
        t = random_template(g, 6, seed=seed + k)
        assert t.keywords == tuple(q.keywords)
        assert t.edges == tuple((e.src, e.dst, str(pg.predicates[e.pred]))
                                for e in q.edges)
        assert not q.connections


def test_canonical_ignores_names_and_nothing_else(graphs):
    g, _ = graphs
    rng = np.random.default_rng(0)
    for s in range(20):
        t = random_template(g, 6, seed=s)
        perm = list(rng.permutation(len(t.keywords)))
        assert canonical(t.renumbered(perm)) == canonical(t)
        a, b, p = t.edges[0]
        other = t._replace(edges=((b, a, p),) + t.edges[1:])
        if a != b and sorted(other.edges) != sorted(t.edges):
            assert canonical(other) != canonical(t)


def test_fresh_stream_never_repeats_a_template(graphs):
    g, _ = graphs
    mix = {"kind": "fresh", "clients": 4, "template_size": 6,
           "stream_seed": 9, "warmup": 4, "deck": 32,
           "per_second": 60, "sample": 8}
    tr = make_traffic(g, mix, seed=2**32 + 11, seconds=2)
    keys = [canonical(r.template) for r in tr.stream]
    keys += [canonical(t) for t in tr.warmup]
    assert len(tr.stream) == 128
    assert len(set(keys)) == len(keys)
    # every seed: the same templates in the same order, deck by deck,
    # named in another order
    other = make_traffic(g, mix, seed=5, seconds=2)
    assert other.templates == tr.templates
    for k in range(0, 128, 32):
        assert sorted(r.base for r in tr.stream[k:k + 32]) == \
            list(range(k, k + 32))
    assert [r.base for r in other.stream] == [r.base for r in tr.stream]
    assert [r.base for r in tr.stream] != list(range(128))
    assert [r.perm for r in other.stream] != [r.perm for r in tr.stream]


def test_replay_decks_hold_each_ranks_expected_count(graphs):
    g, _ = graphs
    mix = {"kind": "replay", "clients": 4, "template_size": 6, "pool": 8,
           "pool_seed": 3, "zipf": 1.3, "deck": 64,
           "per_second": 64, "sample": 8}
    a = make_traffic(g, mix, seed=5, seconds=2)
    b = make_traffic(g, mix, seed=5, seconds=2)
    c = make_traffic(g, mix, seed=6, seconds=2)
    assert a.stream == b.stream and a.templates == c.templates
    assert [r.base for r in a.stream] == [r.base for r in c.stream]
    assert [r.perm for r in a.stream] != [r.perm for r in c.stream]
    assert len({canonical(t) for t in a.templates}) == 8
    for r in a.stream:
        assert r.template == a.templates[r.base].renumbered(r.perm)
    want = np.bincount(deck(zipf_ranks(1.3, 8), 64), minlength=8)
    for s in (a, c):
        for k in (0, 64):
            got = np.bincount([r.base for r in s.stream[k:k + 64]],
                              minlength=8)
            assert got.tolist() == want.tolist()


def test_zipf_ranks_match_the_draws():
    """serve_queries.py's rank rule, min(zipf, n) - 1: the tail lumps on
    the last rank."""
    p = zipf_ranks(1.3, 64)
    r = np.minimum(np.random.default_rng(0).zipf(1.3, 200_000), 64) - 1
    assert np.abs(np.bincount(r, minlength=64) / 2e5 - p).max() < 0.005
    assert deck(p, 256).tolist() == sorted(deck(p, 256).tolist())
    assert len(deck(p, 256)) == 256
