"""The one traffic generator: turns a mix file into a request stream.

A mix (``bench/mixes/<name>.json``) is data:

  clients        requests outstanding at once (closed loop)
  template_size  nodes of each template
  kind           "replay": a pool of ``pool`` templates drawn from
                 ``pool_seed``, asked by popularity rank min(zipf(``zipf``),
                 pool) - 1 (``examples/serve_queries.py``'s rule);
                 "fresh": every request a template never seen before in
                 the run, drawn from ``stream_seed``, with ``warmup``
                 more for set-up
  deck           requests a deck: each deck holds a fixed set of requests
                 in an order drawn from the mix's seed (replay: each
                 rank's expected count, rounded; fresh: the next
                 ``deck`` templates of the stream)
  per_second     requests made ready for each second of the window: more
                 than the fastest run can take
  sample         answered requests whose answers the reference checks

Each request names its template's nodes in an order drawn from
``--seed``, which also draws, in the harness, the answers the reference
checks.  The data, the templates and their order
are fixed by the configuration and the mix, so every seed asks the same
work: the order alone moved a run's speed by 12 % on the card (PERF.md,
PR 23), where two runs of one order agreed within 2-4 %.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..reference.graph import Graph
from ..reference.match import Template
from .templates import canonical, random_template


class Request(NamedTuple):
    base: int               # index of the template in Traffic.templates
    perm: tuple             # request node perm[q] is template node q
    template: Template      # the template as this request names it


class Traffic(NamedTuple):
    templates: list         # every distinct template the run may ask
    warmup: list            # templates run in set-up
    stream: list            # Requests, in order


def _seed(*words) -> int:
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1, np.uint64)[0])


def _distinct(g: Graph, mix: dict, n: int, seed: int, seen: set) -> list:
    """``n`` templates of the mix's shape drawn from ``seed``, each unequal
    up to renaming to every other and to ``seen`` (which grows)."""
    size = int(mix["template_size"])
    out, k = [], 0
    while len(out) < n:
        if k > 50 * n + 1000:
            raise RuntimeError(f"only {len(out)} distinct templates of "
                               f"size {size} in {k} draws")
        t = random_template(g, size, seed=_seed(seed, k))
        k += 1
        key = canonical(t)
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def zipf_ranks(alpha: float, n: int) -> np.ndarray:
    """Probability of each rank of min(zipf(alpha), n) - 1."""
    k = np.arange(1, 10**6 + 1, dtype=np.float64)
    # zeta(alpha): the partial sum and the Euler-Maclaurin tail
    top = k[-1]
    zeta = (k ** -alpha).sum() + top ** (1 - alpha) / (alpha - 1) \
        - top ** -alpha / 2
    p = k[:n - 1] ** -alpha / zeta
    return np.append(p, 1.0 - p.sum())


def deck(probs: np.ndarray, size: int) -> np.ndarray:
    """``size`` ranks, each rank as often as its expected count, rounded
    by the largest remainders."""
    exact = probs * size
    cnt = np.floor(exact).astype(np.int64)
    cnt[np.argsort(cnt - exact, kind="stable")[:size - cnt.sum()]] += 1
    return np.repeat(np.arange(len(probs)), cnt)


def make_traffic(g: Graph, mix: dict, seed: int, seconds: float) -> Traffic:
    rng = np.random.default_rng(_seed(seed, 0))
    d = int(mix["deck"])
    n_req = int(np.ceil(mix["per_second"] * seconds / d)) * d
    seen: set = set()
    if mix["kind"] == "replay":
        templates = _distinct(g, mix, int(mix["pool"]), mix["pool_seed"],
                              seen)
        warmup = list(templates)
        one = deck(zipf_ranks(mix["zipf"], len(templates)), d)
        order = np.random.default_rng(_seed(mix["pool_seed"], 1))
        bases = np.concatenate([order.permutation(one)
                                for _ in range(n_req // d)])
    elif mix["kind"] == "fresh":
        warmup = _distinct(g, mix, int(mix["warmup"]), mix["stream_seed"],
                           seen)
        templates = _distinct(g, mix, n_req, mix["stream_seed"] + 1, seen)
        order = np.random.default_rng(_seed(mix["stream_seed"], 2))
        bases = np.concatenate([k + order.permutation(d)
                                for k in range(0, n_req, d)])
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    stream = []
    for b in bases.tolist():
        t = templates[b]
        perm = tuple(rng.permutation(len(t.keywords)).tolist())
        stream.append(Request(b, perm, t.renumbered(perm)))
    return Traffic(templates, warmup, stream)
