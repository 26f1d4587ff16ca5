"""The UBA generator: LUBM's counts, ratios and properties, one data seed
one data set, and a set of triples."""
from collections import Counter, defaultdict

import pytest

from bench.gen import triples, uba

CLASSES = {"University", "Department", "FullProfessor", "AssociateProfessor",
           "AssistantProfessor", "Lecturer", "UndergraduateStudent",
           "GraduateStudent", "Course", "GraduateCourse", "ResearchGroup",
           "Publication", "TeachingAssistant", "ResearchAssistant"}
PROPERTIES = {"type", "name", "emailAddress", "telephone", "worksFor",
              "memberOf", "subOrganizationOf", "undergraduateDegreeFrom",
              "mastersDegreeFrom", "doctoralDegreeFrom", "researchInterest",
              "teacherOf", "takesCourse", "advisor", "headOf",
              "publicationAuthor", "teachingAssistantOf"}


@pytest.fixture(scope="module", params=[0, 2**33 + 3])
def lubm(request):
    mp = pytest.MonkeyPatch()
    mp.setattr(uba, "DEPARTMENTS", (3, 3))
    tr = triples({"generator": "uba", "universities": 2,
                  "data_seed": request.param})
    again = triples({"generator": "uba", "universities": 2,
                     "data_seed": request.param})
    mp.undo()
    return tr, again


def test_a_seed_gives_one_set_of_triples(lubm):
    tr, again = lubm
    rows = list(zip(tr.subs.tolist(), tr.preds.tolist(), tr.objs.tolist()))
    assert rows == list(zip(again.subs.tolist(), again.preds.tolist(),
                            again.objs.tolist()))
    assert len(set(rows)) == len(rows)
    assert set(tr.preds.tolist()) == PROPERTIES
    types = {o.split("/", 1)[1] for p, o in zip(tr.preds, tr.objs)
             if p == "type"}
    assert types == CLASSES


def test_counts_and_ratios_lie_in_ubas_ranges(lubm):
    tr, _ = lubm
    kind = {s: o.split("/", 1)[1] for s, p, o in zip(tr.subs, tr.preds,
                                                    tr.objs)
            if p == "type" and o.split("/", 1)[1] not in
            ("TeachingAssistant", "ResearchAssistant")}
    dept_of = {}
    for s, p, o in zip(tr.subs, tr.preds, tr.objs):
        if p in ("worksFor", "memberOf"):
            dept_of[s] = o
    per = defaultdict(Counter)
    for s, d in dept_of.items():
        per[d][kind[s]] += 1
    assert len(per) == 6 == Counter(kind.values())["Department"]
    for c in per.values():
        fac = sum(c[k] for k, _, _ in uba.FACULTY)
        for k, (lo, hi), _ in uba.FACULTY:
            assert lo <= c[k] <= hi
        assert c["UndergraduateStudent"] % fac == 0
        assert 8 <= c["UndergraduateStudent"] // fac <= 14
        assert c["GraduateStudent"] % fac == 0
        assert 3 <= c["GraduateStudent"] // fac <= 4
    taken = Counter(s for s, p in zip(tr.subs, tr.preds)
                    if p == "takesCourse")
    for s, k in kind.items():
        if k == "UndergraduateStudent":
            assert 2 <= taken[s] <= 4
        elif k == "GraduateStudent":
            assert 1 <= taken[s] <= 3
    heads = [s for s, p in zip(tr.subs, tr.preds) if p == "headOf"]
    assert len(heads) == 6 and all(kind[h] == "FullProfessor"
                                   for h in heads)


def test_literals_are_the_objects_no_uri_names(lubm):
    tr, _ = lubm
    assert "xxx-xxx-xxxx" in tr.literals
    assert "FullProfessor0" in tr.literals
    assert not any(o.startswith(("Class/", "University/"))
                   for o in tr.literals)
    assert not tr.literals & set(tr.subs.tolist())
