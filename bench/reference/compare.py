"""The comparison that decides ``correct``.

The data is a set of triples, so every answer holds each assignment at
most once.  Each sampled request is judged by what it says:

  * every answer must hold distinct rows, at most ``max_rows`` of them;
  * an answer the server did not flag as cut must equal the reference's
    answer set exactly, so a check that pruned a match, a join or filter
    that lost or invented a row, a stale replayed plan or a fan-out that
    handed a renumbered client the wrong columns all show;
  * an answer flagged as cut must hold only answers of the template
    (judged row by row), and the flag must be possible: the reference,
    counting block by block, must find more answers than were served, or
    some connected part of the template (its edges' nodes with their
    keywords) must have more than ``max_rows`` assignments, injective or
    not.  The server flags an answer when a join on its way passes
    ``max_rows`` rows before the injectivity filter, and such a join can
    lose no answer; it cannot pass ``max_rows`` where no part does.

A request that ended in an error is counted apart, as failed.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph
from .match import (Template, TooLarge, answer_blocks, match, more_than,
                    row_order, sub_templates, valid_rows)


def _distinct(rows: np.ndarray, num_nodes: int) -> np.ndarray:
    """The distinct rows, in lexicographic order."""
    rows = np.asarray(rows, np.int64)
    if not len(rows) or not rows.shape[1]:
        return rows[:1]
    rows = rows[row_order(rows, num_nodes)]
    new = np.ones(len(rows), dtype=bool)
    new[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[new]


def judge(g: Graph, templates: list, samples, max_rows: int) -> dict:
    """samples: an iterable of (request, rows [R, n] in the request's
    node order, truncated).  Returns {"checked", "mismatched", "cut",
    "notes"}."""
    answers: dict = {}
    verdicts: dict = {}       # the same rows of one template judged once
    checked = mismatched = cut = 0
    notes = []
    for req, rows, truncated in samples:
        checked += 1
        t: Template = templates[req.base]
        got = np.asarray(rows, np.int64).reshape(len(rows), len(req.perm))
        got = np.ascontiguousarray(got[:, list(req.perm)])
        cut += truncated
        key = (req.base, truncated, got.shape, hash(got.tobytes()))
        if key not in verdicts:
            verdicts[key] = _judge_one(g, t, got, truncated, max_rows,
                                       answers, req.base)
        ok, why = verdicts[key]
        if not ok:
            mismatched += 1
            if len(notes) < 5:
                notes.append(f"template {req.base}: {why}")
    return {"checked": checked, "mismatched": mismatched, "cut": cut,
            "notes": notes}


def _judge_one(g, t, got, truncated, max_rows, answers, base):
    mine = _distinct(got, g.num_nodes)
    if len(mine) != len(got):
        return False, f"{len(got) - len(mine)} of {len(got)} rows repeated"
    if len(got) > max_rows:
        return False, f"{len(got)} rows, over max_rows {max_rows}"
    if truncated:
        bad = int((~valid_rows(g, t, got)).sum())
        if bad:
            return False, f"cut answer: {bad} of {len(got)} rows not answers"
        if more_than(g, t, len(got)) or any(
                more_than(g, s, max_rows, injective=False)
                for s in sub_templates(t)):
            return True, ""
        return False, (f"flagged as cut, but {len(got)} rows are every "
                       "answer and no part of the template passes "
                       f"{max_rows} rows")
    if base not in answers:
        try:
            answers[base] = match(g, t)
        except TooLarge as e:
            answers[base] = e
    want = answers[base]
    if isinstance(want, TooLarge):
        return False, f"not flagged as cut, and the reference has {want}"
    return (np.array_equal(mine, want),
            f"{len(mine)} rows served, reference {len(want)}")


def control_rows(g: Graph, t: Template, max_rows: int):
    """The control in the program's place: the reference without
    injectivity (homomorphisms, one guarantee of the configuration
    broken), cut at ``max_rows`` and flagged when it is."""
    out, total = [], 0
    for rows in answer_blocks(g, t, injective=False):
        out.append(rows)
        total += len(rows)
        if total > max_rows:
            break
    if not out:
        return np.zeros((0, len(t.keywords)), np.int64), False
    rows = np.concatenate(out)
    if total <= max_rows:
        rows = rows[row_order(rows, g.num_nodes)]
    return rows[:max_rows], total > max_rows
