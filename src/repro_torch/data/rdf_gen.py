"""Synthetic RDF dataset generators mimicking the paper's four workloads.

Each generator is a parameterized entity-relationship synthesizer whose
knobs target the paper's three dataset-evaluation metrics:

  coherence   <- attribute presence probability (1.0 = every instance of a
                 type carries every attribute = relational-like)
  specialty   <- target-selection distribution of relationships (zipf hubs
                 = prolific authors / busy actors -> high kurtosis)
  diversity   <- literal vocabulary size (enum pools vs open word pools)

  lubm_like : high coherence, low specialty, low diversity   (paper: LUBM)
  sp2b_like : mid coherence, low-mid specialty, mid diversity (paper: SP2B)
  dblp_like : mid-high coherence, high specialty, mid diversity (paper: DBLP)
  imdb_like : low coherence, high specialty, high diversity  (paper: IMDB)

URIs are "Type/<zero-padded id>" so a type's instances form one contiguous
IDMap interval — the paper's partial-keyword convention ("remove the long
IDs") maps to prefix lookup directly.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.graph import RDFGraph

_WORDS = np.asarray([
    "graph", "query", "index", "sparse", "neural", "learning", "database",
    "signature", "pruning", "template", "matching", "semantic", "parallel",
    "quantum", "bayesian", "optimal", "dynamic", "stream", "cloud", "secure",
    "logic", "vision", "speech", "robust", "latent", "kernel", "tensor",
    "random", "deep", "fast", "scalable", "hybrid", "adaptive", "efficient",
    "distributed", "probabilistic", "structured", "relational", "temporal",
    "spatial", "federated", "incremental", "approximate", "exact", "greedy",
    "evolutionary", "symbolic", "causal", "generative", "contrastive",
])

_FIRST = np.asarray(["wei", "jun", "anna", "ivan", "maria", "chen", "raj",
                     "sofia", "omar", "lena", "paul", "mira", "igor", "jose",
                     "akira", "nina", "tomas", "priya", "hugo", "elif"])
_LAST = np.asarray(["zhang", "kumar", "silva", "novak", "tanaka", "gruber",
                    "rossi", "olsen", "ivanov", "garcia", "kim", "chen",
                    "papas", "dubois", "moretti", "haas", "lindt", "okafor"])


_SYL = np.asarray(["ka", "ro", "mi", "ta", "lu", "ne", "si", "vo", "da",
                   "pe", "zu", "fa", "gi", "ho", "xe", "bo", "ri", "ma"])


def _word_bank(vocab_size: int) -> np.ndarray:
    """Deterministic open vocabulary: real words first, then synthetic
    syllable words ("karomi", ...) up to vocab_size."""
    if vocab_size <= len(_WORDS):
        return _WORDS[:max(2, vocab_size)]
    rng = np.random.default_rng(1234)
    extra = vocab_size - len(_WORDS)
    synth = np.asarray(["".join(rng.choice(_SYL, size=3)) for _ in range(extra)])
    return np.concatenate([_WORDS, np.unique(synth)])


def _title_pool(rng, n, vocab_size, lo=2, hi=5):
    words = _word_bank(vocab_size)
    counts = rng.integers(lo, hi + 1, n)
    return np.asarray([" ".join(rng.choice(words, size=c)) for c in counts])


def _name_pool(rng, n):
    return np.asarray([f"{rng.choice(_FIRST)} {rng.choice(_LAST)}"
                       for _ in range(n)])


def _year_pool(rng, n, lo=1980, hi=2015):
    return rng.integers(lo, hi, n).astype(str)


def _enum_pool(rng, n, k, prefix="v"):
    return np.asarray([f"{prefix}{i}" for i in rng.integers(0, k, n)])


@dataclass
class TypeSpec:
    name: str
    count: int
    # (predicate name, pool fn(rng, n), presence probability)
    attrs: list = field(default_factory=list)


@dataclass
class RelSpec:
    name: str
    src: str
    dst: str
    out_deg: tuple = ("const", 2)     # ("const", k) | ("zipf", alpha, max)
    target: tuple = ("uniform",)      # ("uniform",) | ("zipf", alpha)
    presence: float = 1.0


def _degrees(rng, n, spec):
    if spec[0] == "const":
        return np.full(n, spec[1], dtype=np.int64)
    if spec[0] == "zipf":
        _, alpha, mx = spec
        d = rng.zipf(alpha, n)
        return np.minimum(d, mx).astype(np.int64)
    raise ValueError(spec)


def _targets(rng, total, n_dst, spec):
    if spec[0] == "uniform":
        return rng.integers(0, n_dst, total)
    if spec[0] == "zipf":
        alpha = spec[1]
        ranks = rng.zipf(alpha, total)
        return np.minimum(ranks - 1, n_dst - 1)
    raise ValueError(spec)


def generate(types: list[TypeSpec], rels: list[RelSpec],
             seed: int = 0, with_types: bool = True) -> RDFGraph:
    rng = np.random.default_rng(seed)
    uris: dict[str, np.ndarray] = {}
    triples_s, triples_p, triples_o = [], [], []

    for t in types:
        uris[t.name] = np.asarray(
            [f"{t.name}/{i:08d}" for i in range(t.count)])
        if with_types:
            triples_s.append(uris[t.name])
            triples_p.append(np.full(t.count, "type"))
            triples_o.append(np.full(t.count, f"Class/{t.name}"))
        for pred, pool_fn, prob in t.attrs:
            present = rng.random(t.count) < prob
            n_present = int(present.sum())
            if n_present == 0:
                continue
            vals = pool_fn(rng, n_present)
            triples_s.append(uris[t.name][present])
            triples_p.append(np.full(n_present, pred))
            triples_o.append(vals)

    for r in rels:
        src_uris = uris[r.src]
        n_src = len(src_uris)
        present = rng.random(n_src) < r.presence
        deg = _degrees(rng, n_src, r.out_deg) * present
        total = int(deg.sum())
        if total == 0:
            continue
        s = np.repeat(src_uris, deg)
        tgt = _targets(rng, total, len(uris[r.dst]), r.target)
        o = uris[r.dst][tgt]
        triples_s.append(s)
        triples_p.append(np.full(total, r.name))
        triples_o.append(o)

    subs = np.concatenate(triples_s)
    preds = np.concatenate(triples_p)
    objs = np.concatenate(triples_o)
    # literal objects: everything that is not a generated URI / class node
    uri_set = set()
    for a in uris.values():
        uri_set.update(a.tolist())
    lit = {o for o in np.unique(objs).tolist()
           if o not in uri_set and not o.startswith("Class/")}
    return RDFGraph.from_triples(
        list(zip(subs.tolist(), preds.tolist(), objs.tolist())),
        literal_objects=lit)


# -------------------------------------------------------------------- #
# The four paper-like workloads.  `scale=1.0` ~ 60-100k triples.
# -------------------------------------------------------------------- #
def lubm_like(scale: float = 1.0, seed: int = 0) -> RDFGraph:
    s = max(1, int(1000 * scale))
    types = [
        TypeSpec("University", s // 10 + 1, attrs=[
            ("name", lambda r, n: _enum_pool(r, n, 40, "univ"), 1.0)]),
        TypeSpec("Department", s // 2 + 1, attrs=[
            ("name", lambda r, n: _enum_pool(r, n, 25, "dept"), 1.0)]),
        TypeSpec("Professor", 2 * s, attrs=[
            ("name", _name_pool, 1.0),
            ("email", lambda r, n: _enum_pool(r, n, 60, "mail"), 1.0)]),
        TypeSpec("Student", 8 * s, attrs=[
            ("name", _name_pool, 1.0)]),
        TypeSpec("Course", 3 * s, attrs=[
            ("name", lambda r, n: _enum_pool(r, n, 50, "course"), 1.0)]),
    ]
    rels = [
        RelSpec("subOrganizationOf", "Department", "University",
                ("const", 1), ("uniform",)),
        RelSpec("worksFor", "Professor", "Department",
                ("const", 1), ("uniform",)),
        RelSpec("memberOf", "Student", "Department",
                ("const", 1), ("uniform",)),
        RelSpec("takesCourse", "Student", "Course",
                ("const", 3), ("uniform",)),
        RelSpec("teacherOf", "Professor", "Course",
                ("const", 2), ("uniform",)),
        RelSpec("advisor", "Student", "Professor",
                ("const", 1), ("uniform",)),
    ]
    return generate(types, rels, seed)


def dblp_like(scale: float = 1.0, seed: int = 0) -> RDFGraph:
    s = max(1, int(1000 * scale))
    types = [
        TypeSpec("Paper", 10 * s, attrs=[
            ("title", lambda r, n: _title_pool(r, n, 400), 1.0),
            ("year", _year_pool, 0.95),
            ("pages", lambda r, n: _enum_pool(r, n, 400, "p"), 0.6),
        ]),
        TypeSpec("Author", 3 * s, attrs=[
            ("name", _name_pool, 1.0)]),
        TypeSpec("Venue", s // 5 + 2, attrs=[
            ("name", lambda r, n: _enum_pool(r, n, 80, "venue"), 1.0)]),
    ]
    rels = [
        # prolific-author hubs: zipf targets => high specialty
        RelSpec("author", "Paper", "Author", ("const", 3), ("zipf", 1.7)),
        RelSpec("venue", "Paper", "Venue", ("const", 1), ("zipf", 1.5)),
        RelSpec("cites", "Paper", "Paper", ("zipf", 2.2, 40), ("zipf", 1.9),
                presence=0.7),
    ]
    return generate(types, rels, seed)


def imdb_like(scale: float = 1.0, seed: int = 0) -> RDFGraph:
    s = max(1, int(1000 * scale))
    types = [
        TypeSpec("Movie", 6 * s, attrs=[
            ("title", lambda r, n: _title_pool(r, n, 4000, 2, 6), 1.0),
            ("year", _year_pool, 0.9),
            ("genre", lambda r, n: _enum_pool(r, n, 28, "genre"), 0.75),
            ("rating", lambda r, n: _enum_pool(r, n, 90, "r"), 0.5),
            ("language", lambda r, n: _enum_pool(r, n, 35, "lang"), 0.4),
        ]),
        TypeSpec("Actor", 4 * s, attrs=[
            ("name", _name_pool, 1.0),
            ("birthYear", _year_pool, 0.35)]),
        TypeSpec("Director", s, attrs=[
            ("name", _name_pool, 1.0)]),
    ]
    rels = [
        # busy-actor hubs, high average degree (paper: ~8 for IMDB)
        RelSpec("actedBy", "Movie", "Actor", ("const", 6), ("zipf", 1.5)),
        RelSpec("directedBy", "Movie", "Director", ("const", 1), ("zipf", 1.6)),
        RelSpec("sequelOf", "Movie", "Movie", ("const", 1), ("zipf", 2.0),
                presence=0.15),
    ]
    return generate(types, rels, seed)


def sp2b_like(scale: float = 1.0, seed: int = 0) -> RDFGraph:
    s = max(1, int(1000 * scale))
    types = [
        TypeSpec("Article", 8 * s, attrs=[
            ("title", lambda r, n: _title_pool(r, n, 30), 1.0),
            ("year", _year_pool, 0.85),
            ("abstract", lambda r, n: _title_pool(r, n, 30, 4, 8), 0.55),
        ]),
        TypeSpec("Person", 3 * s, attrs=[
            ("name", _name_pool, 1.0)]),
        TypeSpec("Journal", s // 4 + 2, attrs=[
            ("name", lambda r, n: _enum_pool(r, n, 60, "jrnl"), 1.0)]),
    ]
    rels = [
        # weaker hubs than dblp (SP2B is synthetic-DBLP: milder kurtosis)
        RelSpec("creator", "Article", "Person", ("const", 2), ("zipf", 2.6)),
        RelSpec("journal", "Article", "Journal", ("const", 1), ("uniform",)),
        RelSpec("references", "Article", "Article", ("zipf", 2.6, 20),
                ("zipf", 2.6), presence=0.5),
    ]
    return generate(types, rels, seed)


def random_graph(n_nodes: int = 200, n_edges: int = 500, n_preds: int = 4,
                 n_literals: int = 50, seed: int = 0) -> RDFGraph:
    """Small arbitrary graph for property tests (no structure guarantees)."""
    rng = np.random.default_rng(seed)
    res = [f"R/{i:04d}" for i in range(n_nodes)]
    lits = [f"lit {i:03d}" for i in range(n_literals)]
    triples = []
    for _ in range(n_edges):
        s = res[rng.integers(0, n_nodes)]
        p = f"p{rng.integers(0, n_preds)}"
        if rng.random() < 0.3:
            o = lits[rng.integers(0, n_literals)]
        else:
            o = res[rng.integers(0, n_nodes)]
        triples.append((s, p, o))
    return RDFGraph.from_triples(triples, literal_objects=set(lits))


DATASETS = {
    "lubm": lubm_like,
    "sp2b": sp2b_like,
    "dblp": dblp_like,
    "imdb": imdb_like,
}
