"""Join parity of the PyTorch port against the JAX package, row for row.

The same tables (made from a numpy seed) go through ``repro.core.matching``
and ``repro_torch.core.matching``; the outputs must agree on every row of
the padded capacity, the count, the truncation flag, the sort-order tag,
the sorts performed/avoided, the recorded strategy and the overflow/resume
contract.  Exact equality: all data is int32.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.matching as jm
import repro_torch.core.matching as tm
from repro.core.planner import CapEstimate as JCap
from repro_torch.core.planner import CapEstimate as TCap
from repro.data import DATASETS as JDATA
from repro_torch.data import DATASETS as TDATA


def mk(cols, data, sort_order=None):
    """The same table in both packages."""
    data = np.asarray(data, np.int32).reshape(-1, len(cols))
    cap = jm._pow2(len(data))
    rows = np.full((cap, len(cols)), -1, np.int32)
    rows[: len(data)] = data
    cols = tuple(int(c) for c in cols)
    return (jm.Table(cols=cols, rows=jnp.asarray(rows), count=len(data),
                     sort_order=sort_order),
            tm.Table(cols=cols, rows=torch.as_tensor(rows), count=len(data),
                     sort_order=sort_order))


def same(jt, tt):
    assert tt.cols == jt.cols
    assert tt.count == jt.count
    assert tt.truncated == jt.truncated
    assert tt.sort_order == jt.sort_order
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))


def rand_pair(seed, na=60, nb=60, ncols_a=2, ncols_b=2, vmax=5):
    rng = np.random.default_rng(seed)
    a_cols = tuple(rng.choice(5, ncols_a, replace=False))
    b_cols = tuple(rng.choice(5, ncols_b, replace=False))
    return (mk(a_cols, rng.integers(0, vmax, (na, ncols_a))),
            mk(b_cols, rng.integers(0, vmax, (nb, ncols_b))))


def both(fn_name, ja, jb, ta, tb, **kw):
    jtel, ttel = jm.JoinTelemetry(), tm.JoinTelemetry()
    jout = getattr(jm, fn_name)(ja, jb, telemetry=jtel, **kw)
    tout = getattr(tm, fn_name)(ta, tb, telemetry=ttel, **kw)
    same(jout, tout)
    assert (ttel.sorts_performed, ttel.sorts_avoided) == \
        (jtel.sorts_performed, jtel.sorts_avoided)
    return jout, tout


# ------------------------- strategies, row for row --------------------- #
@pytest.mark.parametrize("impl,fuse", [("sorted", True), ("sorted", False),
                                       ("radix", True), ("nested", True)])
@pytest.mark.parametrize("seed", range(4))
def test_join_strategies_row_for_row(impl, fuse, seed):
    (ja, ta), (jb, tb) = rand_pair(seed, ncols_a=(seed % 3) + 1, ncols_b=2,
                                   na=50 + 7 * seed, nb=70 - 5 * seed)
    both("join_tables", ja, jb, ta, tb, impl=impl, fuse=fuse)


@pytest.mark.parametrize("impl", ["sorted", "radix", "nested"])
def test_row_limit_truncation_row_for_row(impl):
    (ja, ta), (jb, tb) = rand_pair(3, vmax=3)
    both("join_tables", ja, jb, ta, tb, impl=impl, row_limit=37)


def test_probe_impl_ref_matches_sorted():
    (ja, ta), (jb, tb) = rand_pair(11, vmax=4)
    jout = jm.join_tables(ja, jb, impl="sorted", probe_impl="interpret")
    for probe in ("sorted", "ref", "auto"):
        same(jout, tm.join_tables(ta, tb, impl="sorted", probe_impl=probe))


def test_sorted_run_reuse_chain_matches():
    """A chain of joins on one key: the port sorts and reuses runs exactly
    where the reference does (order tags, cached runs, telemetry)."""
    rng = np.random.default_rng(5)
    ja, ta = mk((0, 1), rng.integers(0, 6, (80, 2)))
    jb, tb = mk((0, 2), rng.integers(0, 6, (70, 2)))
    jc, tc = mk((0, 3), rng.integers(0, 6, (60, 2)))
    jd, td = mk((2, 4), rng.integers(0, 6, (40, 2)))
    for fuse in (True, False):
        jtel, ttel = jm.JoinTelemetry(), tm.JoinTelemetry()
        j1 = jm.join_tables(ja, jb, impl="sorted", telemetry=jtel, fuse=fuse)
        t1 = tm.join_tables(ta, tb, impl="sorted", telemetry=ttel, fuse=fuse)
        j2 = jm.join_tables(j1, jc, impl="sorted", telemetry=jtel, fuse=fuse)
        t2 = tm.join_tables(t1, tc, impl="sorted", telemetry=ttel, fuse=fuse)
        j3 = jm.join_tables(ja, jc, impl="sorted", telemetry=jtel, fuse=fuse)
        t3 = tm.join_tables(ta, tc, impl="sorted", telemetry=ttel, fuse=fuse)
        j4 = jm.join_tables(j2, jd, impl="sorted", telemetry=jtel, fuse=fuse)
        t4 = tm.join_tables(t2, td, impl="sorted", telemetry=ttel, fuse=fuse)
        for j, t in ((j1, t1), (j2, t2), (j3, t3), (j4, t4)):
            same(j, t)
        assert (ttel.sorts_performed, ttel.sorts_avoided) == \
            (jtel.sorts_performed, jtel.sorts_avoided)
        assert ttel.sorts_avoided > 0


# ------------------------- overflow and resume ------------------------- #
@pytest.mark.parametrize("impl,fuse,resume_cls", [
    ("sorted", True, "_ProbeResume"), ("sorted", False, "_ProbeResume"),
    ("radix", True, "_RadixResume")])
def test_overflow_resume_matches(impl, fuse, resume_cls):
    rng = np.random.default_rng(19)
    ja, ta = mk((0, 1), rng.integers(0, 4, (80, 2)))
    jb, tb = mk((1, 2), rng.integers(0, 4, (80, 2)))
    with pytest.raises(jm.CapacityOverflow) as je:
        jm.join_tables(ja, jb, impl=impl, cap=32, fuse=fuse)
    with pytest.raises(tm.CapacityOverflow) as te:
        tm.join_tables(ta, tb, impl=impl, cap=32, fuse=fuse)
    assert te.value.needed == je.value.needed
    assert type(te.value.resume).__name__ == resume_cls
    jtel, ttel = jm.JoinTelemetry(), tm.JoinTelemetry()
    jout = jm.join_tables(ja, jb, impl=impl, cap=jm._pow2(je.value.needed),
                          _resume=je.value.resume, telemetry=jtel, fuse=fuse)
    tout = tm.join_tables(ta, tb, impl=impl, cap=tm._pow2(te.value.needed),
                          _resume=te.value.resume, telemetry=ttel, fuse=fuse)
    same(jout, tout)
    assert ttel.sorts_performed == jtel.sorts_performed == 0


def test_radix_skew_fallback_matches(monkeypatch):
    hot = np.zeros((5000, 2), np.int32)
    hot[:, 1] = np.arange(5000)
    ja, ta = mk((0, 1), hot)
    jb, tb = mk((0, 2), hot.copy())
    monkeypatch.setattr(jm, "RADIX_WORK_MAX", 1)
    monkeypatch.setattr(tm, "RADIX_WORK_MAX", 1)
    both("join_tables", ja, jb, ta, tb, impl="radix", row_limit=100)


def test_radix_on_a_large_probe_side_matches():
    rng = np.random.default_rng(2)
    ja, ta = mk((0, 1), rng.integers(0, 3000, (9000, 2)))
    jb, tb = mk((0, 2), rng.integers(0, 3000, (700, 2)))
    assert tm.choose_join_strategy(ta.count, tb.count) == \
        jm.choose_join_strategy(ja.count, jb.count) == "radix"
    both("join_tables", ja, jb, ta, tb)


# ----------------------------- planned join ---------------------------- #
@pytest.mark.parametrize("est", [None, 10, 700, 100000])
def test_planned_join_records_the_same(est):
    rng = np.random.default_rng(29)
    ja, ta = mk((0, 1), rng.integers(0, 6, (300, 2)))
    jb, tb = mk((1, 2), rng.integers(0, 6, (300, 2)))
    jrec, trec = [], []
    jout = jm.planned_join(ja, jb, est, record=lambda *r: jrec.append(r))
    tout = tm.planned_join(ta, tb, est, record=lambda *r: trec.append(r))
    same(jout, tout)
    assert trec == jrec
    for forced in ("radix", "nested", "sorted"):
        jrec.clear()
        trec.clear()
        jo = jm.planned_join(ja, jb, JCap(jout.count, jout.cap, forced),
                             record=lambda *r: jrec.append(r))
        to = tm.planned_join(ta, tb, TCap(tout.count, tout.cap, forced),
                             record=lambda *r: trec.append(r))
        same(jo, to)
        assert trec == jrec and trec[0][0] == forced


# ------------------------- cross / filter / dedup ---------------------- #
@pytest.mark.parametrize("na,nb,limit", [(0, 5, None), (5, 0, None),
                                         (1, 1, None), (3, 7, None),
                                         (64, 65, None), (100, 30, 999),
                                         (7, 9, 20), (1, 500, 64),
                                         (33, 33, 1)])
def test_cross_join_grid(na, nb, limit):
    rng = np.random.default_rng(na * 31 + nb)
    ja, ta = mk((0,), rng.integers(0, 50, (na, 1)), sort_order=(0,))
    jb, tb = mk((1, 2), rng.integers(0, 50, (nb, 2)))
    same(jm.cross_join(ja, jb, row_limit=limit),
         tm.cross_join(ta, tb, row_limit=limit))


def test_injective_filter_and_filter_rows():
    rng = np.random.default_rng(31)
    ja, ta = mk((0, 1, 2), rng.integers(0, 4, (90, 3)), sort_order=(1,))
    same(jm.injective_filter(ja), tm.injective_filter(ta))
    keep = rng.random(90) < 0.5
    same(jm.filter_rows(ja, keep), tm.filter_rows(ta, keep))


@pytest.mark.parametrize("cols", [(7, 1), (3,), (1, 3, 7)])
def test_dedup_project_matches(cols):
    rng = np.random.default_rng(len(cols))
    ja, ta = mk((3, 1, 7), rng.integers(0, 4, (60, 3)))
    same(jm.dedup_project(ja, cols), tm.dedup_project(ta, cols))


def test_edge_pairs_and_dtree_candidates_match():
    gj = JDATA["dblp"](scale=0.02, seed=1)
    gt = TDATA["dblp"](scale=0.02, seed=1)
    rng = np.random.default_rng(1)
    n = gj.num_nodes
    mask = rng.random(n) < 0.6
    lo, hi = 10, n - 10
    for pred in (None, 0, 2):
        for spec_j, spec_t in (
                ((jnp.int32(lo), jnp.int32(hi)), (lo, hi)),
                (jnp.asarray(mask), torch.as_tensor(mask))):
            for cols in ((0, 1), (3, 3)):
                same(jm.edge_pairs(gj, pred, spec_j, jnp.asarray(mask),
                                   cols=cols),
                     tm.edge_pairs(gt, pred, spec_t, torch.as_tensor(mask),
                                   cols=cols))
