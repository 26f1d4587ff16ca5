"""LUBM's university data, drawn by the rules of its generator (UBA).

The Lehigh University Benchmark (Guo, Pan and Heflin, J. Web Semantics
3(2-3), 2005, §3.2 and the UBA's documented ranges) describes a
university by the univ-bench ontology.  LUBM(N, s) is N universities
from seed s; each university draws its own count of every part from the
ranges below, uniformly:

  departments a university               15-25
  full / associate / assistant professors 7-10 / 10-14 / 8-11
  lecturers                               5-7
  undergraduate students                  8-14 per faculty member
  graduate students                       3-4 per faculty member
  undergraduate / graduate courses        1-2 / 1-2 per faculty member
  research groups                         10-20
  publications                            full 15-20, associate 10-18,
                                          assistant 5-10, lecturer 0-5,
                                          graduate student 0-5 (co-author)
  courses taken                           undergraduate 2-4, graduate 1-3
  teaching assistants                     one per 4-5 undergraduate courses
  research assistants                     one per 3-4 graduate students
  undergraduates with an advisor          1 in 5; every graduate has one

Every faculty member holds three degrees (undergraduate, masters,
doctoral) from universities drawn out of 1,000, as does every graduate
student's undergraduate degree; a professor has one research interest;
the first full professor heads the department.  Names, e-mail addresses
and the telephone are UBA's literals ("FullProfessor3",
"FullProfessor3@Department12.University0.edu", "xxx-xxx-xxxx").

URIs are "<Class>/<university>.<department>.<index>", so the instances of
a class form one contiguous interval of the sorted labels.  The draws are
NumPy's from the configuration's seed, not UBA's Java generator, so the
data has UBA's counts, ratios and properties and not its exact triples.
"""
from __future__ import annotations

import numpy as np

from . import Triples

DEPARTMENTS = (15, 25)
FACULTY = (("FullProfessor", (7, 10), (15, 20)),
           ("AssociateProfessor", (10, 14), (10, 18)),
           ("AssistantProfessor", (8, 11), (5, 10)),
           ("Lecturer", (5, 7), (0, 5)))       # (class, count, publications)
UNDERGRADUATES_A_FACULTY = (8, 14)
GRADUATES_A_FACULTY = (3, 4)
COURSES_A_FACULTY = (1, 2)
GRADUATE_COURSES_A_FACULTY = (1, 2)
RESEARCH_GROUPS = (10, 20)
UNDERGRADUATE_COURSES_TAKEN = (2, 4)
GRADUATE_COURSES_TAKEN = (1, 3)
GRADUATE_PUBLICATIONS = (0, 5)
COURSES_A_TA = (4, 5)
GRADUATES_AN_RA = (3, 4)
UNDERGRADUATES_AN_ADVISOR = 5
DEGREE_UNIVERSITIES = 1000
RESEARCH_AREAS = 30
TELEPHONE = "xxx-xxx-xxxx"


def generate(config: dict) -> Triples:
    """LUBM(``universities``) from ``data_seed``."""
    rng = np.random.default_rng(int(config["data_seed"]))
    out: list = []
    for u in range(int(config["universities"])):
        _university(rng, u, out)
    subs, preds, objs = (np.asarray(c) for c in zip(*out))
    uris = set(subs.tolist())
    lit = {o for o in set(objs.tolist())
           if o not in uris and not o.startswith(("Class/", "University/"))}
    return Triples(subs, preds, objs, lit)


def _between(rng, lo_hi) -> int:
    return int(rng.integers(lo_hi[0], lo_hi[1] + 1))


def _pick(rng, pool, lo_hi) -> list:
    """A count drawn from ``lo_hi`` of distinct members of ``pool``."""
    k = min(_between(rng, lo_hi), len(pool))
    return [pool[i] for i in rng.choice(len(pool), size=k, replace=False)]


def _university(rng, u: int, out: list) -> None:
    univ = f"University/{u:04d}"
    out += [(univ, "type", "Class/University"),
            (univ, "name", f"University{u}")]
    for d in range(_between(rng, DEPARTMENTS)):
        _department(rng, u, d, univ, out)


def _degree(rng) -> str:
    return f"University/{int(rng.integers(0, DEGREE_UNIVERSITIES)):04d}"


def _department(rng, u: int, d: int, univ: str, out: list) -> None:
    where = f"{u:04d}.{d:02d}"
    dept = f"Department/{where}"
    mail = f"Department{d}.University{u}.edu"
    out += [(dept, "type", "Class/Department"),
            (dept, "name", f"Department{d}"),
            (dept, "subOrganizationOf", univ)]

    def member(cls, i, pred):
        """A person of the department: class, name, e-mail, telephone and
        ``pred`` (worksFor or memberOf)."""
        uri = f"{cls}/{where}.{i:03d}"
        out.extend([(uri, "type", f"Class/{cls}"), (uri, "name", f"{cls}{i}"),
                    (uri, "emailAddress", f"{cls}{i}@{mail}"),
                    (uri, "telephone", TELEPHONE), (uri, pred, dept)])
        return uri

    faculty, professors, publications = [], [], []
    courses, grad_courses = [], []
    for cls, count, pubs in FACULTY:
        for i in range(_between(rng, count)):
            f = member(cls, i, "worksFor")
            faculty.append(f)
            out += [(f, "undergraduateDegreeFrom", _degree(rng)),
                    (f, "mastersDegreeFrom", _degree(rng)),
                    (f, "doctoralDegreeFrom", _degree(rng))]
            if cls != "Lecturer":
                professors.append(f)
                out.append((f, "researchInterest",
                            f"Research{int(rng.integers(0, RESEARCH_AREAS))}"))
            if cls == "FullProfessor" and i == 0:
                out.append((f, "headOf", dept))
            for kind, n, pool in (("Course", COURSES_A_FACULTY, courses),
                                  ("GraduateCourse",
                                   GRADUATE_COURSES_A_FACULTY, grad_courses)):
                for _ in range(_between(rng, n)):
                    c = f"{kind}/{where}.{len(pool):03d}"
                    out += [(c, "type", f"Class/{kind}"),
                            (c, "name", f"{kind}{len(pool)}"),
                            (f, "teacherOf", c)]
                    pool.append(c)
            for p in range(_between(rng, pubs)):
                pub = f"Publication/{where}.{cls}{i:03d}.{p:02d}"
                out += [(pub, "type", "Class/Publication"),
                        (pub, "name", f"Publication{p}"),
                        (pub, "publicationAuthor", f)]
                if cls != "Lecturer":
                    publications.append(pub)
    for k in range(_between(rng, RESEARCH_GROUPS)):
        g = f"ResearchGroup/{where}.{k:03d}"
        out += [(g, "type", "Class/ResearchGroup"),
                (g, "subOrganizationOf", dept)]

    n_fac = len(faculty)
    for i in range(n_fac * _between(rng, UNDERGRADUATES_A_FACULTY)):
        s = member("UndergraduateStudent", i, "memberOf")
        out += [(s, "takesCourse", c)
                for c in _pick(rng, courses, UNDERGRADUATE_COURSES_TAKEN)]
        if int(rng.integers(0, UNDERGRADUATES_AN_ADVISOR)) == 0:
            out.append((s, "advisor",
                        professors[int(rng.integers(0, len(professors)))]))
    grads = []
    for i in range(n_fac * _between(rng, GRADUATES_A_FACULTY)):
        s = member("GraduateStudent", i, "memberOf")
        grads.append(s)
        out += [(s, "undergraduateDegreeFrom", _degree(rng)),
                (s, "advisor",
                 professors[int(rng.integers(0, len(professors)))])]
        out += [(s, "takesCourse", c)
                for c in _pick(rng, grad_courses, GRADUATE_COURSES_TAKEN)]
        out += [(p, "publicationAuthor", s)
                for p in _pick(rng, publications, GRADUATE_PUBLICATIONS)]
    n_ta = len(courses) // _between(rng, COURSES_A_TA)
    tas = rng.choice(len(grads), size=min(n_ta, len(grads)), replace=False)
    for s, c in zip(tas.tolist(), rng.choice(len(courses), size=len(tas),
                                              replace=False).tolist()):
        out += [(grads[s], "type", "Class/TeachingAssistant"),
                (grads[s], "teachingAssistantOf", courses[c])]
    n_ra = len(grads) // _between(rng, GRADUATES_AN_RA)
    for s in rng.choice(len(grads), size=n_ra, replace=False).tolist():
        out.append((grads[s], "type", "Class/ResearchAssistant"))
