"""The SP2Bench generator at a size a test holds: one data seed one data
set, Table I's attribute frequencies, eq. (1)'s documents a year, rdf:Bag
references, literals and class intervals; and the cell
``sp2b250k.fresh`` on the CPU, the port against the reference."""
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest

from bench import harness
from bench.gen import sp2b, triples
from bench.reference.graph import Graph

ROOT = Path(__file__).resolve().parent.parent.parent
TARGET = 15000            # triples: SP2Bench's 10k point and a little more
LINKS = {"rdf:type", "dc:creator", "swrc:editor", "swrc:journal",
         "dcterms:partOf", "dcterms:references", "foaf:homepage",
         "rdfs:seeAlso"}
# the mix of lubm1.fresh in the harness's tests (bench/conftest.py TINY)
TINY_FRESH = {"warmup": 4, "deck": 64, "per_second": 200, "sample": 16}


def draw(seed: int, target: int = TARGET):
    return triples({"generator": "sp2b", "data_seed": seed,
                    "triple_target": target})


@pytest.fixture(scope="module", params=[0, 2**33 + 3])
def sp2b_data(request):
    tr = draw(request.param)
    rows = list(zip(tr.subs.tolist(), tr.preds.tolist(), tr.objs.tolist()))
    kind = {s: o.split(":", 1)[1] for s, p, o in rows if p == "rdf:type"}
    year = {s: int(o) for s, p, o in rows if p == "dcterms:issued"}
    return tr, rows, kind, year


def documents(kind: dict) -> dict:
    by: dict = defaultdict(list)
    for s, k in kind.items():
        if k in sp2b.CLASSES:
            by[k].append(s)
    return by


def test_a_data_set_holds_sp2bench_terms_once_each(sp2b_data):
    tr, rows, kind, _ = sp2b_data
    assert len(set(rows)) == len(rows)
    assert TARGET <= len(rows) < TARGET + 100
    preds = set(tr.preds.tolist())
    assert {p for p in preds if not p.startswith("rdf:_")} <= \
        set(sp2b.PREDICATE.values()) | {"rdf:type", "foaf:name"}
    assert set(kind.values()) <= set(sp2b.CLASSES) | {"Person", "Bag"}


@pytest.mark.parametrize("seed", [0, 2**33 + 3])
def test_the_same_data_seed_gives_the_same_triples(seed):
    a, b = draw(seed, 4000), draw(seed, 4000)
    assert a.subs.tolist() == b.subs.tolist()
    assert a.preds.tolist() == b.preds.tolist()
    assert a.objs.tolist() == b.objs.tolist() and a.literals == b.literals
    assert draw(seed + 1, 4000).objs.tolist() != a.objs.tolist()


def test_attribute_frequencies_lie_near_table_one(sp2b_data):
    """Each class's share of documents with an attribute is within 4
    binomial standard deviations of its probability in the module."""
    _, rows, kind, _ = sp2b_data
    has = defaultdict(set)
    for s, p, _ in rows:
        has[p].add(s)
    checked = 0
    for cls, docs in documents(kind).items():
        n = len(docs)
        for attr, pred in sp2b.PREDICATE.items():
            p = sp2b.probability(cls, attr)
            k = sum(d in has[pred] for d in docs)
            sd = np.sqrt(n * p * (1 - p))
            # the first document drawn to cite has nothing to cite yet
            assert abs(k - n * p) <= 4 * sd + (attr == "cite"), \
                (cls, attr, n, k, p)
            checked += 1
    assert checked >= 5 * len(sp2b.PREDICATE)


def test_documents_a_year_follow_the_curves(sp2b_data):
    _, _, kind, year = sp2b_data
    per = Counter((kind[d], year[d]) for d in year)
    last = max(year.values())
    assert last > sp2b.START_YEAR
    for yr in range(sp2b.START_YEAR, last):
        n = {c: per[(c, yr)] for c in sp2b.CLASSES}
        for cls in sp2b.CLASSES:
            if cls in sp2b.RANDOM_COUNT:
                assert 0 <= n[cls] < sp2b.RANDOM_COUNT[cls]
                continue
            want = sp2b.documents_a_year(cls, yr)
            if cls in sp2b.CONTAINER.values() and want == 0:
                members = [m for m, b in sp2b.CONTAINER.items() if b == cls]
                want = int(any(n[m] for m in members))
            assert n[cls] == want, (cls, yr)


def test_erdoes_writes_ten_a_year(sp2b_data):
    _, rows, _, year = sp2b_data
    mine = Counter(year[s] for s, p, o in rows
                   if p == "dc:creator" and o == "persons/Paul_Erdoes")
    last = max(year.values())
    assert [mine[y] for y in range(1940, last)] == [10] * (last - 1940)
    assert not any(mine[y] for y in range(sp2b.START_YEAR, 1940))


def test_erdoes_edits_two_a_year_where_documents_have_editors(sp2b_data):
    _, rows, _, year = sp2b_data
    edited = {s for s, p, _ in rows if p == "swrc:editor"}
    mine = Counter(year[s] for s, p, o in rows
                   if p == "swrc:editor" and o == "persons/Paul_Erdoes")
    docs = Counter(year[s] for s in edited)
    last = max(year.values())
    assert [mine[y] for y in range(1940, last)] == \
        [min(2, docs[y]) for y in range(1940, last)]
    assert sum(mine.values()) > 0
    assert not any(mine[y] for y in range(sp2b.START_YEAR, 1940))


def test_each_bag_is_typed_and_numbered_without_gaps(sp2b_data):
    _, rows, kind, _ = sp2b_data
    refs = Counter(o for _, p, o in rows if p == "dcterms:references")
    items = defaultdict(list)
    for s, p, o in rows:
        if p.startswith("rdf:_"):
            items[s].append((int(p[5:]), o))
    bags = {s for s, k in kind.items() if k == "Bag"}
    assert bags and bags == set(refs) == set(items)
    assert set(refs.values()) == {1}
    for bag, its in items.items():
        assert sorted(n for n, _ in its) == list(range(1, len(its) + 1))
        assert len({o for _, o in its}) == len(its)
        assert all(kind[o] in sp2b.CLASSES for _, o in its)


def test_literals_are_exactly_the_literal_objects(sp2b_data):
    tr, rows, _, _ = sp2b_data
    objs = {o for _, p, o in rows
            if p not in LINKS and not p.startswith("rdf:_")}
    assert tr.literals == objs
    assert not tr.literals & set(tr.subs.tolist())
    assert "Paul Erdoes" in tr.literals


def test_each_class_is_one_interval_of_the_sorted_labels(sp2b_data):
    tr, _, kind, _ = sp2b_data
    g = Graph(tr.subs, tr.preds, tr.objs, tr.literals)
    rank = {lab: i for i, lab in enumerate(g.labels.tolist())}
    by = defaultdict(list)
    for s, k in kind.items():
        by[k].append(rank[s])
    assert set(by) >= {"Article", "Journal", "Person", "Bag"}
    for k, ids in by.items():
        assert max(ids) - min(ids) + 1 == len(ids), k


@pytest.fixture
def tiny_sp2b_cell():
    """``sp2b250k.fresh`` cut to ``TARGET`` triples, its mix cut as the
    harness's tests cut lubm1.fresh's."""
    cell = harness.load_cell(ROOT, "sp2b250k.fresh")
    cell.config["triple_target"] = TARGET
    cell.mix.update(TINY_FRESH)
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_the_port_answers_as_the_reference_on_sp2bench(tiny_sp2b_cell,
                                                       trace):
    out = harness.run_cell(ROOT, "sp2b250k.fresh", 2**31 + 29, 1.0,
                           bool(trace), device="cpu", cell=tiny_sp2b_cell)
    assert out["correct"] is True, out["notes"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["answers_checked_at_least"]["value"] == \
        min(out["attempted"], TINY_FRESH["sample"])
    if trace:
        m = out["metrics"]
        new = ("check.pruned_share", "check.overflow_share",
               "check.ids_per_candidate")
        assert set(new) <= set(m)
        assert 0.0 < m["check.pruned_share"]["value"] < 1.0
        assert 0.0 <= m["check.overflow_share"]["value"] \
            <= 1.0 - m["check.pruned_share"]["value"]
        assert m["check.ids_per_candidate"]["value"] > 0
        # the 4.3 decision says check on most requests
        assert m["check.used_share"]["value"] > 0.5
    else:
        assert set(out["metrics"]) == {"qps", "p50_ms", "p95_ms", "setup_s"}
