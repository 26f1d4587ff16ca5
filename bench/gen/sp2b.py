"""SP2Bench's bibliography, drawn by the rules of its data generator.

SP2Bench (Schmidt, Hornung, Lausen and Pinkel, "SP^2Bench: A SPARQL
Performance Benchmark", ICDE 2009, arXiv:0806.4627) generates DBLP-like
data by the distributions its §III fitted to DBLP.  This module draws a
document set by those rules, year by year from ``START_YEAR``, and stops
once ``triple_target`` triples are written, after the document that
reached it (the paper's triple-count mode).

Constants and where they come from (§III; "eq." numbers the paper's
formulas in the order §III gives them):

  documents per year (eq. 1, Fig. 2): logistic curves
      f(yr) = a / (1 + b exp(-c (yr - y0)))
      Journal        a 740.43    b 426.28   c 0.12  y0 1950
      Article        a 58519.12  b 876.80   c 0.12  y0 1950
      Book           a 52.97     b 40316    c 0.29  y0 1950
      Incollection   a 3577.31   b 196.49   c 0.09  y0 1980
      Proceedings and Inproceedings: the same form, constants under
      ``assumed`` (``LOGISTIC``).
      PhDThesis, MastersThesis, WWW: a count drawn uniformly from
      [0, 20), [0, 10), [0, 10) each year (§III: "random").
  attributes (Table I): each attribute of a document appears with its
      class's probability:
                 Article  Inproc.  Proc.   Book    WWW
      author     0.9895   0.9970   0.0001  0.8937  0.9973
      cite       0.0048   0.0104   0.0001  0.0079  0.0000
      editor     0.0000   0.0000   0.7992  0.1040  0.0004
      isbn       0.0000   0.0000   0.8592  0.9294  0.0000
      journal    0.9994   0.0000   0.0004  0.0000  0.0000
      month      0.0065   0.0000   0.0001  0.0008  0.0000
      pages      0.9261   0.9489   0.0000  0.0000  0.0000
      title      1.0000   1.0000   1.0000  1.0000  1.0000
      The other classes and attributes: ``ASSUMED_P`` (``assumed``).
  authors per document (eq. 2): a Gaussian, rounded, at least 1, with
      mu(yr)    = 2.05 / (1 + 17.59 exp(-0.11 (yr - 1975))) + 1.05
      sigma(yr) = 1.00 / (1 + 6.46 exp(-0.10 (yr - 1975))) + 0.50
  publications per author in a year (eq. 3): a power law x^-k(yr), with
      k(yr) = -0.60 / (1 + 216223 exp(-0.20 (yr - 1950))) + 3.08
  Paul Erdős: a fixed author with 10 publications and 2 editor
      activities a year from 1940 to 1996 (§III).
  outgoing citations (eq. 4): a Gaussian with mu 16.82, sigma 10.07,
      rounded, at least 1, for each document whose ``cite`` attribute is
      drawn; incoming citations are skewed by a power law (§III; its
      exponent under ``assumed``).  A citing document gets
      ``dcterms:references`` to a blank node of type ``rdf:Bag`` holding
      ``rdf:_1 .. rdf:_n`` to the cited documents.

DBLP's attributes become SP2Bench's predicates (``PREDICATE``).  URIs are
SP2Bench's without its ``http://localhost/`` host:
``publications/articles/Journal1/1940/Article1``,
``publications/journals/Journal1/1940``, ``publications/inprocs/
Proceeding1/1954/Inproceeding1``, ``persons/<First>_<Last>``, so the
instances of a class form one interval of the sorted labels.  Classes
and predicates are SP2Bench's prefixed names (``bench:Article``,
``foaf:Person``, ``rdf:Bag``).

The draws are NumPy's from the configuration's ``data_seed``, not
SP2Bench's C++ generator, so the data has SP2Bench's distributions and
not its exact triples.  Everything the paper leaves open is a constant
below, named in the configuration's ``assumed``.
"""
from __future__ import annotations

import math

import numpy as np

from . import Triples

START_YEAR = 1936
# eq. (1): (a, b, c, y0); Proceedings and Inproceedings assumed
LOGISTIC = {"Journal": (740.43, 426.28, 0.12, 1950),
            "Article": (58519.12, 876.80, 0.12, 1950),
            "Proceedings": (3300.0, 34000.0, 0.20, 1950),
            "Inproceedings": (110000.0, 34000.0, 0.20, 1950),
            "Book": (52.97, 40316.0, 0.29, 1950),
            "Incollection": (3577.31, 196.49, 0.09, 1980)}
RANDOM_COUNT = {"PhDThesis": 20, "MastersThesis": 10, "WWW": 10}
# a class's word in SP2Bench's URIs and titles, where it is not its name
WORD = {"Proceedings": "Proceeding", "Inproceedings": "Inproceeding"}
# the order in which a year's documents are written: what a document
# refers to (its journal, proceedings or book) comes before it
CLASSES = ("Journal", "Article", "Proceedings", "Inproceedings", "Book",
           "Incollection", "PhDThesis", "MastersThesis", "WWW")
CONTAINER = {"Article": "Journal", "Inproceedings": "Proceedings",
             "Incollection": "Book"}
PATH = {"Journal": "journals", "Article": "articles", "Proceedings": "procs",
        "Inproceedings": "inprocs", "Book": "books",
        "Incollection": "incolls", "PhDThesis": "phdtheses",
        "MastersThesis": "masters", "WWW": "wwws"}
PREDICATE = {"author": "dc:creator", "editor": "swrc:editor",
             "title": "dc:title", "year": "dcterms:issued",
             "journal": "swrc:journal", "crossref": "dcterms:partOf",
             "booktitle": "bench:booktitle", "pages": "swrc:pages",
             "volume": "swrc:volume", "number": "swrc:number",
             "month": "swrc:month", "isbn": "swrc:isbn",
             "series": "swrc:series", "publisher": "dc:publisher",
             "note": "swrc:note", "address": "swrc:address",
             "chapter": "swrc:chapter", "cdrom": "bench:cdrom",
             "url": "foaf:homepage", "ee": "rdfs:seeAlso",
             "abstract": "bench:abstract", "cite": "dcterms:references"}
TABLE_I_CLASSES = ("Article", "Inproceedings", "Proceedings", "Book", "WWW")
TABLE_I = {"author": (0.9895, 0.9970, 0.0001, 0.8937, 0.9973),
           "cite": (0.0048, 0.0104, 0.0001, 0.0079, 0.0000),
           "editor": (0.0000, 0.0000, 0.7992, 0.1040, 0.0004),
           "isbn": (0.0000, 0.0000, 0.8592, 0.9294, 0.0000),
           "journal": (0.9994, 0.0000, 0.0004, 0.0000, 0.0000),
           "month": (0.0065, 0.0000, 0.0001, 0.0008, 0.0000),
           "pages": (0.9261, 0.9489, 0.0000, 0.0000, 0.0000),
           "title": (1.0000, 1.0000, 1.0000, 1.0000, 1.0000)}
# assumed: Table I's attributes for the classes it leaves out, and the
# attributes it leaves out; a class not named has probability 0
ASSUMED_P = {
    "author": {"Incollection": 0.99, "PhDThesis": 1.0, "MastersThesis": 1.0},
    "cite": {"Incollection": 0.01},
    "editor": {"Incollection": 0.0},
    "title": {"Journal": 1.0, "Incollection": 1.0, "PhDThesis": 1.0,
              "MastersThesis": 1.0},
    "year": {c: 1.0 for c in CLASSES},
    "crossref": {"Inproceedings": 0.9, "Incollection": 0.9},
    "booktitle": {"Proceedings": 0.9, "Inproceedings": 1.0,
                  "Incollection": 1.0},
    "pages": {"Incollection": 0.9},
    "volume": {"Article": 0.9, "Proceedings": 0.3, "Book": 0.1},
    "number": {"Article": 0.8},
    "isbn": {"Incollection": 0.1},
    "series": {"Proceedings": 0.6, "Book": 0.5},
    "publisher": {"Proceedings": 0.9, "Book": 0.95, "PhDThesis": 0.5},
    "note": {"Article": 0.01, "Proceedings": 0.01, "Book": 0.05,
             "PhDThesis": 0.1, "WWW": 0.1},
    "address": {"Proceedings": 0.01},
    "chapter": {"Incollection": 0.05},
    "cdrom": {"Article": 0.01, "Inproceedings": 0.1},
    "url": {"Article": 0.9, "Inproceedings": 0.9, "Proceedings": 0.9,
            "Book": 0.5, "Incollection": 0.9, "PhDThesis": 0.5,
            "MastersThesis": 0.5, "WWW": 1.0},
    "ee": {"Article": 0.6, "Inproceedings": 0.6, "Proceedings": 0.3,
           "Incollection": 0.5, "WWW": 0.1},
    "abstract": {"Article": 0.01, "Inproceedings": 0.01},
}
ATTRIBUTES = tuple(PREDICATE)
# eq. (2), eq. (3), eq. (4), Erdős (§III)
AUTHORS_MU = (2.05, 17.59, 0.11, 1975, 1.05)
AUTHORS_SIGMA = (1.00, 6.46, 0.10, 1975, 0.50)
AUTHOR_EXPONENT = (-0.60, 216223.0, 0.20, 1950, 3.08)
CITE_MU, CITE_SIGMA = 16.82, 10.07
# name, publications and editor activities a year, from, to
ERDOES = ("Paul", "Erdoes", 10, 2, 1940, 1996)
# assumed
EDITORS_MU, EDITORS_SIGMA = 2.0, 1.0      # editors of a document
RETURNING = 0.5             # a year's authors who published before
CITED_PARETO = 1.5          # shape of the weights of incoming citations
TITLE_WORDS = (4, 10)
ABSTRACT_WORDS = (40, 120)
VOCABULARY = 3000
FIRST_NAMES, LAST_NAMES = 400, 1200
PAGES = (1, 400)
MONTHS = ("January", "February", "March", "April", "May", "June", "July",
          "August", "September", "October", "November", "December")


def probability(cls: str, attr: str) -> float:
    """The chance that a document of ``cls`` has ``attr``: Table I where it
    says, else ``ASSUMED_P``."""
    if attr in TABLE_I and cls in TABLE_I_CLASSES:
        return TABLE_I[attr][TABLE_I_CLASSES.index(cls)]
    return ASSUMED_P.get(attr, {}).get(cls, 0.0)


def _logistic(params, yr: int) -> float:
    a, b, c, y0 = params[:4]
    return a / (1.0 + b * math.exp(-c * (yr - y0)))


def documents_a_year(cls: str, yr: int) -> int:
    """eq. (1), rounded; the random classes are drawn, not given here."""
    return int(round(_logistic(LOGISTIC[cls], yr)))


def authors_mu_sigma(yr: int) -> tuple[float, float]:
    """eq. (2)."""
    return (_logistic(AUTHORS_MU, yr) + AUTHORS_MU[4],
            _logistic(AUTHORS_SIGMA, yr) + AUTHORS_SIGMA[4])


def author_exponent(yr: int) -> float:
    """eq. (3)'s exponent."""
    return _logistic(AUTHOR_EXPONENT, yr) + AUTHOR_EXPONENT[4]


def _words(n: int, rng) -> list:
    """``n`` distinct made-up words of two to three syllables."""
    cons, vows = "bcdfghklmnprstvz", "aeiou"
    out: list = []
    seen: set = set()
    while len(out) < n:
        k = int(rng.integers(2, 4))
        w = "".join(cons[int(rng.integers(0, len(cons)))]
                    + vows[int(rng.integers(0, len(vows)))]
                    for _ in range(k))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def generate(config: dict) -> Triples:
    """SP2Bench's data to ``triple_target`` triples from ``data_seed``."""
    return _Writer(config).run()


class _Writer:
    def __init__(self, config: dict):
        self.rng = np.random.default_rng(int(config["data_seed"]))
        self.target = int(config["triple_target"])
        rng = self.rng
        self.vocab = _words(VOCABULARY, rng)
        names = _words(FIRST_NAMES + LAST_NAMES, rng)
        self.first = [w.capitalize() for w in names[:FIRST_NAMES]]
        self.last = [w.capitalize() for w in names[FIRST_NAMES:]]
        self.publishers = [f"{w.capitalize()} Press"
                           for w in _words(30, rng)]
        self.cities = [w.capitalize() for w in _words(40, rng)]
        self.series = [f"Lecture Notes in {w.capitalize()}"
                       for w in _words(20, rng)]
        self.out: list = []
        self.literals: set = set()
        # persons' URIs and publications so far; Erdős is person 0
        self.persons = [f"persons/{ERDOES[0]}_{ERDOES[1]}"]
        self.pubs = [0]
        self.written: set = set()        # persons whose triples are out
        self.taken: set = set()          # (first, last) indices used
        self.docs: list = []             # documents that may be cited
        self.doc_weight: list = []
        self.bags = 0

    # ------------------------------------------------------------------ #
    def literal(self, s: str, p: str, value: str) -> None:
        self.out.append((s, p, value))
        self.literals.add(value)

    def text(self, lo_hi) -> str:
        n = int(self.rng.integers(lo_hi[0], lo_hi[1] + 1))
        return " ".join(self.vocab[i] for i in
                        self.rng.integers(0, len(self.vocab), n))

    def new_person(self) -> int:
        while True:
            f = int(self.rng.integers(0, len(self.first)))
            la = int(self.rng.integers(0, len(self.last)))
            if (f, la) not in self.taken:
                break
        self.taken.add((f, la))
        self.persons.append(f"persons/{self.first[f]}_{self.last[la]}")
        self.pubs.append(0)
        return len(self.persons) - 1

    def person(self, i: int) -> str:
        uri = self.persons[i]
        if i not in self.written:
            self.written.add(i)
            first, last = uri.split("/", 1)[1].split("_", 1)
            self.out.append((uri, "rdf:type", "foaf:Person"))
            self.literal(uri, "foaf:name", f"{first} {last}")
        return uri

    # ------------------------------------------------------------------ #
    def run(self) -> Triples:
        yr = START_YEAR
        while self.year_of_documents(yr):
            yr += 1
        subs, preds, objs = (np.asarray(c) for c in zip(*self.out))
        return Triples(subs, preds, objs, set(self.literals))

    def counts(self, yr: int) -> dict:
        n = {}
        for cls in CLASSES:
            if cls in RANDOM_COUNT:
                n[cls] = int(self.rng.integers(0, RANDOM_COUNT[cls]))
            else:
                n[cls] = documents_a_year(cls, yr)
        # a year with members has one container at least
        for member, box in CONTAINER.items():
            if n[member] and not n[box]:
                n[box] = 1
        return n

    def year_of_documents(self, yr: int) -> bool:
        """Plan and write one year's documents; False once the target is
        reached."""
        rng = self.rng
        n = self.counts(yr)
        plan = []                  # (cls, index in class, attrs present)
        for cls in CLASSES:
            p = np.array([probability(cls, a) for a in ATTRIBUTES])
            has = rng.random((n[cls], len(ATTRIBUTES))) < p
            plan += [(cls, i, has[i]) for i in range(n[cls])]
        a_author = ATTRIBUTES.index("author")
        a_editor = ATTRIBUTES.index("editor")
        mu, sigma = authors_mu_sigma(yr)
        n_auth = [max(1, int(round(rng.normal(mu, sigma))))
                  if has[a_author] else 0 for _, _, has in plan]
        authors = self.assign_authors(yr, n_auth)
        n_ed = [max(1, int(round(rng.normal(EDITORS_MU, EDITORS_SIGMA))))
                if has[a_editor] else 0 for _, _, has in plan]
        editors = self.assign_editors(yr, n_ed)
        boxes: dict = {c: [] for c in CONTAINER.values()}
        for k, (cls, i, has) in enumerate(plan):
            self.document(yr, cls, i, has, authors[k], editors[k], boxes)
            if len(self.out) >= self.target:
                return False
        return True

    def assign_authors(self, yr: int, n_auth: list) -> list:
        """Each document's author indices: the year's author slots filled
        by distinct persons whose counts follow eq. (3)."""
        rng = self.rng
        slots = np.repeat(np.arange(len(n_auth)), n_auth)
        out: list = [[] for _ in n_auth]
        if not len(slots):
            return out
        # publications per author this year: P(x) ~ x^-k, x at most the
        # documents that have authors
        top = int(np.count_nonzero(n_auth))
        p = np.arange(1, top + 1, dtype=np.float64) ** -author_exponent(yr)
        counts = np.zeros(0, dtype=np.int64)
        while counts.sum() < len(slots):
            counts = np.append(counts, rng.choice(top, size=len(slots),
                                                  p=p / p.sum()) + 1)
        # the draws that fill the slots, the last one cut to fit
        m = int(np.searchsorted(np.cumsum(counts), len(slots))) + 1
        counts = counts[:m]
        counts[-1] -= counts.sum() - len(slots)
        # returning authors by their publications so far, the rest new
        # (Erdős, person 0, keeps his fixed count: never drawn)
        old = np.flatnonzero(np.asarray(self.pubs[1:]) > 0) + 1
        n_old = min(int(rng.binomial(m, RETURNING)), len(old))
        who: list = []
        if n_old:
            w = np.asarray(self.pubs, dtype=np.float64)[old]
            who += old[rng.choice(len(old), size=n_old, replace=False,
                                  p=w / w.sum())].tolist()
        who += [self.new_person() for _ in range(m - n_old)]
        people = np.repeat(np.asarray(who)[rng.permutation(m)], counts)
        rng.shuffle(people)
        # a person drawn twice for one document is kept once
        for d, a in zip(slots.tolist(), people.tolist()):
            if a not in out[d]:
                out[d].append(a)
        if ERDOES[4] <= yr <= ERDOES[5]:
            with_authors = [d for d, k in enumerate(n_auth) if k]
            k = min(ERDOES[2], len(with_authors))
            for d in rng.choice(with_authors, size=k, replace=False):
                out[int(d)].append(0)
        return out

    def assign_editors(self, yr: int, n_ed: list) -> list:
        """Editors among persons who have published, by their count of
        publications (new persons while nobody has); distinct on a
        document.  Erdős, never drawn, edits his fixed count of the
        year's documents that have editors."""
        out: list = [[] for _ in n_ed]
        total = sum(n_ed)
        if not total:
            return out
        w = np.asarray(self.pubs, dtype=np.float64)
        w[0] = 0.0
        if not w.sum():
            picks = [self.new_person() for _ in range(total)]
        else:
            picks = self.rng.choice(len(w), size=total,
                                    p=w / w.sum()).tolist()
        j = 0
        for d, k in enumerate(n_ed):
            out[d] = list(dict.fromkeys(picks[j:j + k]))
            j += k
        if ERDOES[4] <= yr <= ERDOES[5]:
            with_editors = [d for d, k in enumerate(n_ed) if k]
            k = min(ERDOES[3], len(with_editors))
            for d in self.rng.choice(with_editors, size=k, replace=False):
                out[int(d)].append(0)
        return out

    def document(self, yr: int, cls: str, i: int, has, authors: list,
                 editors: list, boxes: dict) -> None:
        rng = self.rng
        a = dict(zip(ATTRIBUTES, has.tolist()))
        word = WORD.get(cls, cls)
        if cls in boxes:
            uri = f"publications/{PATH[cls]}/{word}{i + 1}/{yr}"
            title = f"{word} {i + 1} ({yr})"
            boxes[cls].append((uri, title))
        elif cls in CONTAINER:
            box = boxes[CONTAINER[cls]]
            b = int(rng.integers(0, len(box)))
            box_uri, box_title = box[b]
            # the container's URI past its class path, then this one's
            uri = (f"publications/{PATH[cls]}/"
                   f"{box_uri.split('/', 2)[2]}/{word}{i + 1}")
            title = self.text(TITLE_WORDS)
        else:
            uri = f"publications/{PATH[cls]}/{yr}/{word}{i + 1}"
            title = self.text(TITLE_WORDS)
        out = self.out
        out.append((uri, "rdf:type", f"bench:{cls}"))
        if a["title"]:
            self.literal(uri, "dc:title", title)
        if a["year"]:
            self.literal(uri, "dcterms:issued", str(yr))
        for p in authors:
            out.append((uri, "dc:creator", self.person(p)))
            self.pubs[p] += 1
        for p in editors:
            out.append((uri, "swrc:editor", self.person(p)))
        if a["journal"] and cls == "Article":
            out.append((uri, "swrc:journal", box_uri))
        elif a["journal"] and boxes["Journal"]:
            j = int(rng.integers(0, len(boxes["Journal"])))
            out.append((uri, "swrc:journal", boxes["Journal"][j][0]))
        if a["crossref"] and cls in ("Inproceedings", "Incollection"):
            out.append((uri, "dcterms:partOf", box_uri))
        if a["booktitle"]:
            self.literal(uri, "bench:booktitle",
                         box_title if cls in ("Inproceedings",
                                              "Incollection") else title)
        if a["pages"]:
            lo = int(rng.integers(PAGES[0], PAGES[1]))
            self.literal(uri, "swrc:pages",
                         f"{lo}-{lo + int(rng.integers(1, 30))}")
        if a["volume"]:
            self.literal(uri, "swrc:volume", str(int(rng.integers(1, 50))))
        if a["number"]:
            self.literal(uri, "swrc:number", str(int(rng.integers(1, 13))))
        if a["month"]:
            self.literal(uri, "swrc:month",
                         MONTHS[int(rng.integers(0, 12))])
        if a["isbn"]:
            self.literal(uri, "swrc:isbn",
                         f"ISBN-{int(rng.integers(0, 10**10)):010d}")
        if a["series"]:
            self.literal(uri, "swrc:series",
                         self.series[int(rng.integers(0, len(self.series)))])
        if a["publisher"]:
            self.literal(uri, "dc:publisher", self.publishers[
                int(rng.integers(0, len(self.publishers)))])
        if a["note"]:
            self.literal(uri, "swrc:note", self.text((2, 6)))
        if a["address"]:
            self.literal(uri, "swrc:address",
                         self.cities[int(rng.integers(0, len(self.cities)))])
        if a["chapter"]:
            self.literal(uri, "swrc:chapter", str(int(rng.integers(1, 21))))
        if a["cdrom"]:
            self.literal(uri, "bench:cdrom",
                         f"{PATH[cls].upper()}/{yr}/{i + 1}.pdf")
        if a["url"]:
            out.append((uri, "foaf:homepage",
                        f"http://www.{self.vocab[i % len(self.vocab)]}.tld/"
                        f"{uri.split('/', 1)[1]}"))
        if a["ee"]:
            out.append((uri, "rdfs:seeAlso",
                        f"http://ee.{self.vocab[i % len(self.vocab)]}.tld/"
                        f"{uri.split('/', 1)[1]}"))
        if a["abstract"]:
            self.literal(uri, "bench:abstract", self.text(ABSTRACT_WORDS))
        if a["cite"] and self.docs:
            self.references(uri)
        if cls != "Journal":
            self.docs.append(uri)
            self.doc_weight.append(float(rng.pareto(CITED_PARETO) + 1.0))

    def references(self, uri: str) -> None:
        """A bag of cited documents: eq. (4)'s count, chosen among the
        documents written before by their power-law weights."""
        rng = self.rng
        k = max(1, int(round(rng.normal(CITE_MU, CITE_SIGMA))))
        k = min(k, len(self.docs))
        w = np.asarray(self.doc_weight)
        cited = rng.choice(len(self.docs), size=k, replace=False,
                           p=w / w.sum())
        self.bags += 1
        bag = f"_:references{self.bags}"
        self.out += [(uri, "dcterms:references", bag),
                     (bag, "rdf:type", "rdf:Bag")]
        self.out += [(bag, f"rdf:_{j + 1}", self.docs[int(c)])
                     for j, c in enumerate(cited)]

