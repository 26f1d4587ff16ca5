"""The plain reference against brute-force enumeration on small random
graphs, its count and its blocks, the row-by-row judgement of cut answers,
and the comparison that decides ``correct``."""
from itertools import permutations

import numpy as np
import pytest

from bench.reference import match as match_mod
from bench.reference.compare import judge
from bench.reference.graph import Graph
from bench.reference.match import (Template, answer_blocks, match,
                                   more_than, sub_templates, valid_rows)


def random_graph(seed, n_nodes=14, n_edges=40, n_preds=3):
    rng = np.random.default_rng(seed)
    labels = [f"{'AB'[i % 2]}/{i:03d}" for i in range(n_nodes)]
    s = [labels[i] for i in rng.integers(0, n_nodes, n_edges)]
    o = [labels[i] for i in rng.integers(0, n_nodes, n_edges)]
    p = [f"p{i}" for i in rng.integers(0, n_preds, n_edges)]
    return Graph(s, p, o)


def random_template(g, seed, n=4):
    rng = np.random.default_rng(seed)
    kws = [str(rng.choice(["", "A/", "B/", "A/00", "B/01"])) for _ in range(n)]
    edges = []
    for q in range(1, n):           # a random tree, then one more edge
        edges.append((int(rng.integers(0, q)), q,
                      f"p{rng.integers(0, 3)}"))
    a, b = rng.integers(0, n, 2)
    edges.append((int(a), int(b), f"p{rng.integers(0, 4)}"))   # p3: none
    flip = rng.random(len(edges)) < 0.5
    edges = [(b, a, p) if f else (a, b, p) for (a, b, p), f in zip(edges, flip)]
    return Template(tuple(kws), tuple(edges))


def brute_force(g, t, injective=True):
    n = len(t.keywords)
    triples = set(zip(g.src.tolist(), g.dst.tolist(),
                      [str(g.predicates[p]) for p in g.pred]))
    cands = [[x for x in range(g.num_nodes)
              if str(g.labels[x]).startswith(k)] for k in t.keywords]
    out = set()

    def rec(q, assign):
        if q == n:
            if all((assign[a], assign[b], p) in triples
                   for a, b, p in t.edges):
                out.add(tuple(assign))
            return
        for x in cands[q]:
            if injective and x in assign:
                continue
            rec(q + 1, assign + [x])

    rec(0, [])
    return out


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("injective", [True, False])
def test_match_equals_brute_force(seed, injective):
    g = random_graph(seed)
    t = random_template(g, 1000 + seed)
    got = match(g, t, injective=injective)
    want = brute_force(g, t, injective)
    assert {tuple(r) for r in got.tolist()} == want
    assert len(got) == len(want)                       # distinct rows
    assert got.tolist() == sorted(got.tolist())


@pytest.mark.parametrize("seed", range(8))
def test_match_is_invariant_under_renumbering(seed):
    g = random_graph(seed)
    t = random_template(g, 2000 + seed)
    perm = list(np.random.default_rng(seed).permutation(len(t.keywords)))
    r = match(g, t.renumbered(perm))
    assert {tuple(row[perm]) for row in r} == \
        {tuple(row) for row in match(g, t)}


@pytest.mark.parametrize("seed", range(8))
def test_valid_rows_judges_each_row(seed):
    g = random_graph(seed, n_edges=60)
    t = random_template(g, 3000 + seed, n=3)
    good = match(g, t)
    assert valid_rows(g, t, good).all()
    every = np.asarray(list(permutations(range(g.num_nodes), 3)))
    ok = valid_rows(g, t, every)
    assert {tuple(r) for r in every[ok].tolist()} == \
        {tuple(r) for r in good.tolist()}
    assert not valid_rows(g, t, np.array([[0, 0, 1], [-1, 2, 3]])).any()


def test_wildcard_and_literal_prefixes():
    g = Graph(["A/1", "A/2", "A/1"], ["p", "p", "q"], ["lit a", "lit b", "A/2"],
              literals={"lit a", "lit b"})
    assert g.interval("") == (0, g.num_nodes)
    assert g.interval("lit") == (2, 4)
    assert g.interval("zzz")[0] == g.interval("zzz")[1]
    assert g.literal.tolist() == [False, False, True, True]
    t = Template(("A/", "lit"), ((0, 1, "p"),))
    assert match(g, t).tolist() == [[0, 2], [1, 3]]


@pytest.mark.parametrize("seed", range(12))
def test_blocks_count_and_limit_agree_with_brute_force(seed, monkeypatch):
    """Tiny blocks: every answer once across blocks; the count passes k
    exactly where the answer set holds more than k."""
    monkeypatch.setattr(match_mod, "BLOCK_ROWS", 3)
    g = random_graph(seed)
    t = random_template(g, 5000 + seed)
    want = brute_force(g, t)
    blocks = list(answer_blocks(g, t))
    got = [tuple(r) for b in blocks for r in b.tolist()]
    assert len(got) == len(set(got)) and set(got) == want
    for k in {0, max(len(want) - 1, 0), len(want), len(want) + 1}:
        assert more_than(g, t, k) == (len(want) > k)


class Req:
    def __init__(self, base, n):
        self.base, self.perm = base, tuple(range(n))


def verdict(g, t, rows, truncated, max_rows=1 << 20):
    return judge(g, [t], [(Req(0, len(t.keywords)), rows, truncated)],
                 max_rows)


def test_judge_holds_exact_answers_by_multiplicity():
    g = random_graph(1, n_edges=60)
    t = next(t for s in range(100)
             for t in [random_template(g, 6000 + s, n=3)]
             if len(match(g, t)) >= 4)
    want = match(g, t)
    assert verdict(g, t, want[::-1], False)["mismatched"] == 0
    assert verdict(g, t, np.concatenate([want, want]),
                   False)["mismatched"] == 1           # rows doubled
    assert verdict(g, t, want[:-1], False)["mismatched"] == 1
    assert verdict(g, t, want, True)["mismatched"] == 1   # a dishonest flag


def test_judge_holds_a_cut_answer_to_distinct_valid_rows_and_an_honest_flag():
    g = random_graph(2, n_edges=60)
    t = next(t for s in range(100)
             for t in [random_template(g, 7000 + s, n=3)]
             if len(match(g, t)) >= 6)
    want = match(g, t)
    part = want[: len(want) // 2]
    assert verdict(g, t, part, True, max_rows=len(part))["mismatched"] == 0
    # more rows than max_rows, a row twice, a row that is no answer
    assert verdict(g, t, want[:-1], True,
                   max_rows=len(part))["mismatched"] == 1
    assert verdict(g, t, np.concatenate([part, part[:1]]), True)[
        "mismatched"] == 1
    bad = part.copy()
    bad[0, 0] = (bad[0, 0] + 1) % g.num_nodes
    assert verdict(g, t, bad, True)["mismatched"] == 1
    # the same rows, unflagged, are a wrong exact answer
    assert verdict(g, t, part, False)["mismatched"] == 1


def test_sub_templates_are_the_connected_edge_sets():
    t = Template(("A/", "B/", "A/00", ""),
                 ((0, 1, "p0"), (2, 1, "p1"), (3, 2, "p0")))
    subs = list(sub_templates(t))
    # {e0}, {e1}, {e2}, {e0, e1}, {e1, e2}, {e0, e1, e2}; not {e0, e2}
    assert [len(s.edges) for s in subs] == [1, 1, 1, 2, 2, 3]
    assert subs[0] == Template(("A/", "B/"), ((0, 1, "p0"),))
    assert subs[-1] == t


def test_judge_takes_a_flag_on_a_whole_answer_where_a_part_passes_max_rows():
    """A flag on every answer is possible only where some connected part
    of the template has more than max_rows assignments."""
    g = random_graph(3, n_edges=60)
    t = next(t for s in range(100)
             for t in [random_template(g, 8000 + s, n=3)]
             if 2 <= len(match(g, t)))
    want = match(g, t)
    most = max(len(match(g, s, injective=False)) for s in sub_templates(t))
    assert verdict(g, t, want, True, max_rows=most)["mismatched"] == 1
    assert verdict(g, t, want, True, max_rows=most - 1)["mismatched"] == 0
