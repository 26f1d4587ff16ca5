"""Kernel parity of the PyTorch port against the JAX package.

Every plain PyTorch kernel version of ``repro_torch.kernels`` is held
against the matching Pallas function of ``repro.kernels`` run in interpret
mode, on the shape grids of tests/test_kernels.py and
tests/test_fused_join.py.  All data is int32, so equality is exact.  The
CUDA kernels themselves run only on the card: tests/test_torch_cuda.py holds
them against these plain versions there.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.kernels.fused_join as jfused
import repro.kernels.radix_join as jrad
from repro.kernels import ops as jops
from repro.kernels.interval_count import interval_count_pallas
from repro.core import signature as jsig
from repro.core.signature import _gather_count
from repro.core.ni_index import build_ni_index
from repro.data import dblp_like, lubm_like

import repro_torch.core.matching as tm
import repro_torch.core.signature as tsig
import repro_torch.data as TD
from repro_torch.core.ni_index import build_ni_index as tbuild_ni_index
import repro_torch.kernels.fused_join as tfused
import repro_torch.kernels.radix_join as trad
from repro_torch.kernels import KernelError, ops as tops, ref as tref

import row_select_cases as rsc

A_INV = (1 << 31) - 1
B_INV = (1 << 31) - 2


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _ragged_sorted_ids(rng, c, b, hi=1000):
    ids = np.full((c, b), -1, np.int32)
    for i in range(c):
        k = rng.integers(0, b + 1)
        ids[i, :k] = np.sort(rng.integers(0, hi, k))
    return ids


def _sorted_keys(rng, n, hi=500, sentinel=None, frac_pad=0.2):
    ks = rng.integers(0, hi, n).astype(np.int32)
    if sentinel is not None and n:
        ks[: max(int(n * frac_pad), 1)] = sentinel
    return np.sort(ks)


# ----------------------------- merge probe ----------------------------- #
@pytest.mark.parametrize("na,nb", [(1, 1), (7, 130), (128, 128),
                                   (300, 77), (1000, 513), (257, 8)])
def test_merge_probe_matches_pallas(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    a = _sorted_keys(rng, na, sentinel=A_INV)
    b = _sorted_keys(rng, nb, sentinel=B_INV)
    ws, wc = jops.merge_probe(a, b, impl="interpret")
    for impl in ("auto", "sorted", "ref"):
        gs, gc = tops.merge_probe(_t(a), _t(b), impl=impl)
        assert gs.dtype == gc.dtype == torch.int32
        _eq(gs, ws)
        _eq(gc, wc)
    assert (np.asarray(wc)[a == A_INV] == 0).all()


# ---------------------------- interval count --------------------------- #
@pytest.mark.parametrize("c,b,j", [(1, 1, 1), (7, 13, 3), (64, 128, 8),
                                   (130, 70, 5), (256, 257, 16),
                                   (1000, 33, 2)])
def test_interval_count_matches_pallas(c, b, j):
    rng = np.random.default_rng(c * 7 + b * 3 + j)
    ids = _ragged_sorted_ids(rng, c, b)
    lo = rng.integers(0, 900, j).astype(np.int32)
    hi = lo + rng.integers(0, 200, j).astype(np.int32)
    want = interval_count_pallas(jnp.asarray(ids), jnp.asarray(lo),
                                 jnp.asarray(hi), interpret=True)
    for impl in ("auto", "ref"):
        _eq(tops.interval_count(_t(ids), _t(lo), _t(hi), impl=impl), want)
    # fused gather form: rows picked (and repeated) by candidate id
    cands = rng.integers(0, c, 2 * c).astype(np.int32)
    _eq(tops.interval_count(_t(ids), _t(lo), _t(hi), cands=_t(cands)),
        np.asarray(want)[cands])
    _eq(tref.interval_count_gather_ref(_t(ids), _t(cands), _t(lo), _t(hi)),
        np.asarray(want)[cands])


def test_interval_count_matches_gather_count_on_ni_rows():
    """The neighborhood check's gather + count step on real NI rows."""
    g = lubm_like(scale=0.05, seed=1)
    ni = build_ni_index(g, d_max=2)
    rng = np.random.default_rng(3)
    for k in (1, -1, 2, -2):
        ids = ni.entries[k].ids
        cands = rng.integers(0, g.num_nodes, 300).astype(np.int32)
        lo = np.sort(rng.integers(0, g.num_nodes, 8)).astype(np.int32)
        hi = (lo + rng.integers(1, g.num_nodes // 4, 8)).astype(np.int32)
        want = _gather_count(jnp.asarray(ids), jnp.asarray(cands),
                             jnp.asarray(lo), jnp.asarray(hi))
        _eq(tops.interval_count(_t(ids), _t(lo), _t(hi), cands=_t(cands)),
            want)
        # the engine's form: each row's stored length beside the ids
        e = ni.entries[k]
        lens = _t(np.minimum(e.count, e.cap))
        for impl in ("auto", "ref"):
            _eq(tops.interval_count(_t(ids), _t(lo), _t(hi), cands=_t(cands),
                                    lens=lens, impl=impl), want)


@pytest.mark.parametrize("c,b,j", [(7, 13, 3), (130, 70, 5), (256, 257, 16)])
def test_interval_count_lens_limits_rows_to_their_prefix(c, b, j):
    """With lens, entries past lens[n] do not count: the same as the
    Pallas count over rows cut to that prefix."""
    rng = np.random.default_rng(c + b + j)
    ids = _ragged_sorted_ids(rng, c, b)
    lens = rng.integers(0, b + 1, c).astype(np.int32)
    cut = ids.copy()
    cut[np.arange(b)[None, :] >= lens[:, None]] = -1
    lo = rng.integers(0, 900, j).astype(np.int32)
    hi = lo + rng.integers(0, 200, j).astype(np.int32)
    want = np.asarray(interval_count_pallas(jnp.asarray(cut), jnp.asarray(lo),
                                            jnp.asarray(hi), interpret=True))
    cands = rng.integers(0, c, 2 * c).astype(np.int32)
    for impl in ("auto", "ref"):
        _eq(tops.interval_count(_t(ids), _t(lo), _t(hi), cands=_t(cands),
                                lens=_t(lens), impl=impl), want[cands])


def test_interval_count_padding_never_counts():
    ids = np.full((4, 16), -1, np.int32)
    got = tops.interval_count(_t(ids), _t([0]), _t([10 ** 6]))
    assert (got.numpy() == 0).all()


# ------------------------------ node check ----------------------------- #
def _reqs(mod, rng, n_nodes, j, need_d1):
    """Random DirectionReqs of J intervals over d_check = 2, the first of
    them wide: need counts of 0-1 (1-2 on the wide one), at distance 1
    only where need_d1."""
    lo = np.sort(rng.integers(0, n_nodes, j))
    hi = lo + rng.integers(1, max(n_nodes // 6, 2), j)
    lo[0], hi[0] = 0, n_nodes
    need = (rng.random((2, j)) < 0.3).astype(np.int32)
    need[:, 0] += 1
    need[1] = np.maximum(need[1], need[0])
    if not need_d1:
        need[0] = 0
    return mod.DirectionReqs(lo=lo.astype(np.int64), hi=hi.astype(np.int64),
                             need=need)


# (dataset, scale, NI variant, directions, J): cap_quantile 0.9 makes rows
# overflow their cap; the vertex-cover variant sets overflow on non-cover
# nodes at |k| = 2; dblp at 0.35 has over 8,192 nodes, so the reference's
# chunk boundary falls inside the candidate range
NODE_CHECK_GRID = [("lubm", 0.05, "full", "both", 3),
                   ("lubm", 0.05, "vc", "fwd", 16),
                   ("dblp", 0.05, "vc", "both", 8),
                   ("dblp", 0.05, "full", "bwd", 1),
                   ("dblp", 0.35, "vc", "both", 16)]


@pytest.mark.parametrize("name,scale,variant,dirs,j", NODE_CHECK_GRID)
def test_node_check_matches_reference(name, scale, variant, dirs, j):
    """The port's check of one node (``check_template``: one
    ops.interval_check over the node's segments, the plain version here,
    writing its row of the pass masks) against repro's
    check_interval_candidates, on NI rows with overflow, one or two
    directions, J up to 16; the row's columns outside lo..hi stay
    false."""
    gen = {"lubm": lubm_like, "dblp": dblp_like}[name]
    g = gen(scale=scale, seed=1)
    ni_j = build_ni_index(g, d_max=2, variant=variant, cap_quantile=0.9)
    ni_t = tbuild_ni_index(TD.DATASETS[name](scale=scale, seed=1), d_max=2,
                           variant=variant, cap_quantile=0.9)
    n = g.num_nodes
    signs = {"fwd": (1,), "bwd": (-1,), "both": (1, -1)}[dirs]
    assert any(ni_t.entries[s * d].overflow.any() for s in signs
               for d in (1, 2))
    # the vertex cover's overflow bits are not derivable from the lengths
    e2 = ni_t.entries[2]
    assert ((e2.count <= e2.cap) & e2.overflow).any() == (variant == "vc")
    rng = np.random.default_rng(j + n)
    ranges = [(0, n), (n // 3, n // 3 + 257), (5, 6)]
    if scale > 0.3:
        assert n > 8192
    passed = failed = 0
    for trial in range(3):
        state = rng.bit_generator.state
        made = {}
        for mod in (jsig, tsig):
            rng.bit_generator.state = state
            made[mod] = mod.NodeReqs(
                fwd=_reqs(mod, rng, n, j, trial != 1)
                if dirs in ("fwd", "both") else None,
                bwd=_reqs(mod, rng, n, max(j // 2, 1), trial != 2)
                if dirs in ("bwd", "both") else None)
        for lo, hi in ranges:
            want = jsig.check_interval_candidates(ni_j, made[jsig], lo, hi, 2)
            (spec,), _ = tsig.check_template(ni_t, [(made[tsig], lo, hi)],
                                             2, n=n,
                                             counts=tsig.CheckCounts(),
                                             device="cpu")
            if isinstance(spec, tuple):         # the interval passes
                assert spec == (lo, hi)
                got = np.ones(hi - lo, dtype=bool)
            else:
                row = spec.numpy()
                assert not row[:lo].any() and not row[hi:].any()
                got = row[lo:hi]
            assert got.dtype == bool
            _eq(got, want)
            passed += int(want.sum())
            failed += int((~want).sum())
    assert passed and failed


# (dataset, bloom, query seeds, isolated): size-6 templates; with isolated,
# each with a seventh node of an exact keyword and no edge, a component
# of its own (``single_node_table``)
ENGINE_CHECK_GRID = [("lubm", False, range(100, 104), False),
                     ("dblp", False, range(100, 104), False),
                     ("dblp", True, range(100, 104), False),
                     ("lubm", False, range(100, 103), True)]


@pytest.mark.parametrize("name,bloom,seeds,isolated", ENGINE_CHECK_GRID)
def test_engine_check_matches_reference_node_checks(name, bloom, seeds,
                                                    isolated):
    """The port engine's cold check (one ``check_template`` a template,
    the verdict kept in device rows) against repro's per-node
    check_interval_candidates (and bloom_prefilter first, with bloom):
    the masks' host form, candidates_after and every CheckCounts field,
    on NI rows with overflow; and the result sets against the
    reference engine's."""
    from repro.core import Dataset as JDataset
    from repro.core.query import QueryTemplate as JTemplate
    from repro_torch.core import Dataset as TDataset, Engine, EngineConfig
    from repro_torch.core.query import QueryTemplate as TTemplate
    from repro.data import DATASETS as JDATA, random_query as jquery
    gj, gt = JDATA[name](scale=0.05, seed=1), TD.DATASETS[name](scale=0.05,
                                                                seed=1)
    dj = JDataset.build(gj, cap_quantile=0.9)
    dt = TDataset.build(gt, cap_quantile=0.9)
    eng = Engine(dt, EngineConfig(check_policy="always", impl="ref",
                                  device="cpu", use_bloom=bloom))
    ref = dj.engine("rdf_h")
    ref.cfg.check_policy, ref.cfg.use_bloom = "always", bloom
    d_check = min(eng.cfg.d_check, dj.ni.d_max)
    e1 = dj.ni.entries[1]
    sigs = jsig.build_bloom(e1)
    n = gt.num_nodes
    pruned = 0
    for s in seeds:
        qj = jquery(gj, size=6, seed=s, exact_nodes=0.5)
        qt = TD.random_query(gt, size=6, seed=s, exact_nodes=0.5)
        if isolated:
            kw = jquery(gj, size=2, seed=s, exact_nodes=1.0).keywords[0]
            qj = JTemplate(keywords=qj.keywords + [kw], edges=qj.edges)
            qt = TTemplate(keywords=qt.keywords + [kw], edges=qt.edges)
        pq = eng.prepare(qt)
        before = tsig.CheckCounts(**eng.check_counts.snapshot())
        res = eng.execute_prepared(pq)
        assert res.result_set() == ref.execute(qj).result_set()
        assert [len(c) for c in pq.comps].count(1) == int(isolated)
        want = tsig.CheckCounts()
        after = runs = 0
        for comp in pq.comps:
            for q in comp:
                reqs = jsig.build_requirements(qj, comp, q, d_check, pq.iv)
                lo, hi = int(pq.iv[q, 0]), int(pq.iv[q, 1])
                ok = np.ones(hi - lo, dtype=bool)
                if not reqs.empty and hi > lo:
                    runs += 1
                    if bloom:
                        ok &= jsig.bloom_prefilter(sigs, e1, reqs, lo, hi,
                                                   impl="ref")
                    if ok.any():
                        verdict = jsig.check_interval_candidates(
                            dj.ni, reqs, lo, hi, d_check)
                        ok &= verdict
                        over = np.zeros(hi - lo, dtype=bool)
                        ids = 0
                        for sign, r in ((1, reqs.fwd), (-1, reqs.bwd)):
                            if r is None or not r.need.any():
                                continue
                            last = max(d + 1 for d in range(r.need.shape[0])
                                       if r.need[d].any())
                            for d in range(1, min(d_check, last) + 1):
                                e = dj.ni.entries[sign * d]
                                over |= e.overflow[lo:hi]
                                ids += int(np.minimum(e.count[lo:hi],
                                                      e.cap).sum())
                        want.add(tsig.CheckCounts(
                            1, hi - lo, int(verdict.sum()),
                            int((verdict & over).sum()), ids))
                mask = pq.masks[1][q]
                if mask is None:                # the interval passes
                    mask = np.zeros(n, dtype=bool)
                    mask[lo:hi] = True
                full = np.zeros(n, dtype=bool)
                full[lo:hi] = ok
                _eq(mask, full)
                after += int(ok.sum())
                pruned += int((~ok).sum())
        # the counters' one read, and with bloom one read a node of
        # whether the prefilter passed any candidate
        want.syncs = int(runs > 0) + (runs if bloom else 0)
        got = eng.check_counts.snapshot()
        assert {k: got[k] - v for k, v in before.snapshot().items()} \
            == want.snapshot()
        assert res.stats.candidates_after == after
    assert pruned > 0


def test_node_check_chunks_do_not_change_the_verdict():
    """The plain node check gives one verdict whatever its chunk."""
    g = TD.DATASETS["dblp"](scale=0.05, seed=1)
    ni = tbuild_ni_index(g, d_max=2, cap_quantile=0.9)
    rng = np.random.default_rng(2)
    segs = []
    for sign in (1, -1):
        r = _reqs(tsig, rng, g.num_nodes, 5, True)
        for d in (1, 2):
            e = ni.entries[sign * d]
            segs.append(tref.CheckSegment(
                _t(e.ids), _t(np.minimum(e.count, e.cap)),
                torch.as_tensor(e.overflow), r.lo, r.hi, r.need[d - 1],
                d == 1))
    want = tops.interval_check(segs, 3, g.num_nodes)
    assert 0 < int(want.sum()) < g.num_nodes - 3
    for chunk in (1, 7, 256):
        _eq(tops.interval_check(segs, 3, g.num_nodes, chunk=chunk), want)
    with pytest.raises(ValueError):
        tops.interval_check(segs[1:], 0, 4)         # no first segment
    with pytest.raises(ValueError):                 # a segment of J = 0
        tops.interval_check([s._replace(lo=s.lo[:0], hi=s.hi[:0],
                                        need=s.need[:0]) for s in segs],
                            0, 4)
    with pytest.raises(RuntimeError):
        tops.interval_check(segs, 0, 4, impl="cuda")


# --------------------------- expand segments --------------------------- #
@pytest.mark.parametrize("n,cap", [(17, 256), (200, 1024), (1, 64),
                                   (1000, 4096)])
def test_expand_segments_matches_pallas(n, cap):
    rng = np.random.default_rng(n + cap)
    csum = np.cumsum(rng.integers(0, 9, n)).astype(np.int32)
    want = jfused.expand_segments_pallas(jnp.asarray(csum), cap,
                                         interpret=True)
    _eq(tops.expand_segments(_t(csum), cap), want)


# ----------------------------- join expand ----------------------------- #
# (n, nb, ka, kb, new_sel, zero run, limit) — widths ka + len(new_sel) of
# 1 to 8; limit None is no limit, a float a share of the match total
EXPAND_GRID = [
    (1, 1, 1, 1, (), None, None),
    (300, 200, 2, 3, (2, 0), None, 0.4),          # limit below the total
    (50, 40, 1, 2, (1,), "all", None),            # a total of 0
    (6000, 300, 2, 2, (1, 0), (500, 4500), None),  # thousands of cnt = 0
    (700, 90, 3, 1, (), (0, 600), 0.5),           # no new columns
    (257, 129, 1, 4, (3, 1, 0, 2), None, None),   # new_sel permuted
    (129, 500, 4, 5, (4, 2, 0, 3), (10, 100), 1.0),
    (999, 64, 5, 4, (2, 3, 1), None, 0.0),        # width 8, limit 0
]


def _expand_case(seed, n, nb, ka, kb, zero_run, limit):
    """Sorted-side rows, per-row match ranges inside b and the limit."""
    rng = np.random.default_rng(seed)
    a_rows = rng.integers(0, 1000, (n, ka)).astype(np.int32)
    b_rows = rng.integers(0, 1000, (nb, kb)).astype(np.int32)
    cnt = rng.integers(0, 4, n).astype(np.int32)
    if zero_run == "all":
        cnt[:] = 0
    elif zero_run is not None:
        cnt[zero_run[0]: zero_run[1]] = 0
    cnt = np.minimum(cnt, nb)
    start = (rng.random(n) * (nb - cnt + 1)).astype(np.int32)
    total = int(cnt.sum())
    lim = (1 << 31) - 1 if limit is None else int(total * limit)
    cap = max(64, 1 << max(min(total, lim) - 1, 0).bit_length())
    return a_rows, b_rows, start, cnt, lim, cap


@pytest.mark.parametrize("case", range(len(EXPAND_GRID)))
def test_expand_gather_matches_fused_expand_with_pallas_segments(case):
    """ops.expand_gather on the CPU == the reference's fused _expand, whose
    slot map runs expand_segments_pallas in interpret mode."""
    n, nb, ka, kb, new_sel, zero_run, limit = EXPAND_GRID[case]
    a_rows, b_rows, start, cnt, lim, cap = _expand_case(
        case, n, nb, ka, kb, zero_run, limit)
    want, total = jfused._expand(
        jnp.asarray(a_rows), jnp.asarray(b_rows), jnp.asarray(start),
        jnp.asarray(cnt), lim, cap, new_sel, bool(new_sel), "interpret")
    got = tops.expand_gather(_t(a_rows), _t(b_rows), _t(start), _t(cnt), lim,
                             cap, new_sel)
    assert got.dtype == torch.int32
    assert got.shape == (cap, ka + len(new_sel))
    _eq(got, want)
    rows, t_total = tfused._expand(_t(a_rows), _t(b_rows), _t(start),
                                   _t(cnt), lim, cap, new_sel, bool(new_sel))
    _eq(rows, want)
    assert int(t_total) == int(total) == int(cnt.sum())


@pytest.mark.parametrize("case", range(len(EXPAND_GRID)))
def test_expand_gather_matches_radix_scatter(case):
    """radix_scatter's expand (start = win_start + lt) through
    ops.expand_gather == the reference's radix_scatter."""
    n, nb, ka, kb, new_sel, zero_run, limit = EXPAND_GRID[case]
    a_rows, b_rows, start, cnt, lim, cap = _expand_case(
        case, n, nb, ka, kb, zero_run, limit)
    rng = np.random.default_rng(case + 100)
    lt = (rng.random(n) * (start + 1)).astype(np.int32)
    win_start = start - lt
    want = jrad.radix_scatter(
        jnp.asarray(a_rows), jnp.asarray(b_rows), jnp.asarray(lt),
        jnp.asarray(cnt), jnp.asarray(win_start), lim, cap=cap,
        new_sel=new_sel, has_new=bool(new_sel))
    _eq(trad.radix_scatter(_t(a_rows), _t(b_rows), _t(lt), _t(cnt),
                           _t(win_start), lim, cap=cap, new_sel=new_sel,
                           has_new=bool(new_sel)), want)
    _eq(tops.expand_gather(_t(a_rows), _t(b_rows), _t(start), _t(cnt), lim,
                           cap, new_sel), want)


def test_expand_gather_dispatch():
    """impl='cuda' on a CPU tensor raises; on the CPU no kernel launches;
    a given csum is used as the running counts."""
    a_rows, b_rows, start, cnt, lim, cap = _expand_case(
        7, 40, 30, 2, 2, None, None)
    with pytest.raises(RuntimeError):
        tops.expand_gather(_t(a_rows), _t(b_rows), _t(start), _t(cnt), lim,
                           cap, (1,), impl="cuda")
    before = tops.cuda_kernels()["expand_segments"].launches
    plain = tops.expand_gather(_t(a_rows), _t(b_rows), _t(start), _t(cnt),
                               lim, cap, (1,))
    given = tops.expand_gather(_t(a_rows), _t(b_rows), _t(start), _t(cnt),
                               lim, cap, (1,), csum=_t(np.cumsum(cnt)))
    assert tops.cuda_kernels()["expand_segments"].launches == before
    _eq(given, plain)


# ----------------------------- window probe ---------------------------- #
@pytest.mark.parametrize("n,lmax", [(40, 16), (1, 8), (33, 32), (300, 64),
                                    (17, 3)])
def test_window_probe_matches_pallas(n, lmax):
    rng = np.random.default_rng(n * 100 + lmax)
    a = rng.integers(0, 9, n).astype(np.int32)
    win = np.sort(rng.integers(0, 9, (n, lmax)), axis=1).astype(np.int32)
    win[:, lmax // 2:] = np.where(rng.random((n, lmax - lmax // 2)) < 0.3,
                                  B_INV, win[:, lmax // 2:])
    wl, wc = jrad.window_probe_pallas(jnp.asarray(a), jnp.asarray(win),
                                      interpret=True)
    gl, gc = tref.window_probe_ref(_t(a), _t(win))
    _eq(gl, wl)
    _eq(gc, wc)


def _bucket_np(keys, bits):
    """The reference's uint32 bucket hash, in numpy."""
    h = (keys.astype(np.uint64) * 2654435761) & 0xFFFFFFFF
    return np.where(keys >= B_INV, 1 << bits, h >> (32 - bits))


@pytest.mark.parametrize("n,lmax", [(40, 16), (1, 8), (33, 32), (300, 64),
                                    (17, 3)])
def test_span_probe_matches_pallas_window_probe(n, lmax):
    """ops.radix_probe over the bucket spans of a radix partition against
    the reference's radix_window + window_probe_pallas: lt, cnt and
    win_start, with B_INVALID build rows, A_INVALID (and B_INVALID) probe
    rows, one hot bucket whose span is exactly lmax, and other spans the
    lmax cap cuts."""
    rng = np.random.default_rng(n * 100 + lmax)
    bits = 4
    pool = np.arange(2000)
    pb = _bucket_np(pool, bits)
    hot = pool[pb == pb[7]]
    b_keys = np.concatenate([
        rng.choice(pool[pb != pb[7]], 3 * (1 << bits)),
        np.sort(rng.choice(hot[:4], lmax)),             # span == lmax
        np.full(5, B_INV)]).astype(np.int32)
    b_rows = np.stack([b_keys, np.arange(b_keys.shape[0])], 1)
    keys_p, _, edges, _ = jrad.radix_partition(
        jnp.asarray(b_keys), jnp.asarray(b_rows.astype(np.int32)), bits)
    assert int(edges[pb[7] + 1] - edges[pb[7]]) == lmax
    a = rng.choice(np.concatenate([b_keys, hot[:4], pool[:50]]), n)
    a[rng.random(n) < 0.2] = A_INV
    a[n // 2] = hot[0]
    a[-1] = A_INV if n > 2 else a[-1]
    a[0] = B_INV if n > 3 else a[0]
    a = a.astype(np.int32)
    win, ws = jrad.radix_window(jnp.asarray(a), edges, keys_p, bits, lmax)
    wl, wc = jrad.window_probe_pallas(jnp.asarray(a), win, interpret=True)
    gl, gc, gs = tops.radix_probe(_t(a), _t(np.array(keys_p)),
                                  _t(np.array(edges)), bits=bits, lmax=lmax)
    for g, w in ((gl, wl), (gc, wc), (gs, ws)):
        assert g.dtype == torch.int32
        _eq(g, w)
    assert np.asarray(wc)[np.isin(a, hot[:4])].any()


@pytest.mark.parametrize("bits", [4, 5, 11, 16])
def test_bucket_hash_matches_uint32_reference(bits):
    rng = np.random.default_rng(bits)
    keys = np.concatenate([rng.integers(0, 1 << 31 - 2, 500),
                           [0, 1, A_INV, B_INV, (1 << 31) - 3]])
    keys = keys.astype(np.int32)
    _eq(trad._bucket_of(_t(keys), bits),
        jrad._bucket_of(jnp.asarray(keys), bits))


def test_radix_partition_and_window_match_reference():
    rng = np.random.default_rng(13)
    b_keys = np.concatenate([rng.integers(0, 50, 90),
                             np.full(38, B_INV)]).astype(np.int32)
    b_rows = rng.integers(0, 99, (128, 2)).astype(np.int32)
    a_keys = np.concatenate([rng.integers(0, 60, 60),
                             np.full(4, A_INV)]).astype(np.int32)
    bits = 5
    want = jrad.radix_partition(jnp.asarray(b_keys), jnp.asarray(b_rows),
                                bits)
    got = trad.radix_partition(_t(b_keys), _t(b_rows), bits)
    for g, w in zip(got, want):
        _eq(g, w)
    lmax = 16
    w_win = jrad.radix_window(jnp.asarray(a_keys), want[2], want[0], bits,
                              lmax)
    g_win = trad.radix_window(_t(a_keys), got[2], got[0], bits, lmax)
    for g, w in zip(g_win, w_win):
        _eq(g, w)


# ------------------------- packing / dedup / compaction ---------------- #
@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_pack_keys_and_sort_sides_match_reference(ncols):
    rng = np.random.default_rng(ncols)
    a = np.full((64, 3), -1, np.int32)
    b = np.full((128, 3), -1, np.int32)
    a[:50] = rng.integers(0, 4, (50, 3))
    b[:90] = rng.integers(0, 4, (90, 3))
    sel = tuple(range(ncols))
    _eq(tfused.pack_keys(_t(a), _t(b), sel, sel)[0],
        jfused.pack_keys(jnp.asarray(a), jnp.asarray(b), sel, sel)[0])
    got = tfused._sort_sides(_t(a), _t(b), sel, sel)
    want = jfused._sort_sides(jnp.asarray(a), jnp.asarray(b), sel, sel)
    for g, w in zip(got, want):
        _eq(g, w)


def test_lexsort_distinct_matches_reference():
    rng = np.random.default_rng(23)
    rows = np.full((128, 3), -1, np.int32)
    rows[:90] = rng.integers(0, 4, (90, 3))
    got = tfused.lexsort_distinct(_t(rows), (2, 0))
    want = jfused.lexsort_distinct(jnp.asarray(rows), (2, 0))
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(tops.distinct_mask(got[0]), jops.distinct_mask(want[0]))


@pytest.mark.parametrize("size", [0, 5, 40, 100])
def test_compact_indices_is_fixed_size_nonzero(size):
    mask = np.random.default_rng(size).random(64) < 0.4
    want = jnp.nonzero(jnp.asarray(mask), size=size, fill_value=-7)[0]
    _eq(tfused.compact_indices(torch.as_tensor(mask), size, -7), want)


# ----------------------------- row selection --------------------------- #
# The engine's compositions before ops.edge_select, distinct_select and
# masked_select (core/matching.py's _pass, _edge_pairs_mask,
# _edge_pairs_gather, _injective_keep and _filter_gather), written out: the
# plain versions behind the three entries must equal them.
def _old_pass(spec, ids):
    if isinstance(spec, tuple):
        return (ids >= spec[0]) & (ids < spec[1])
    return spec[ids]


def _old_edge_mask(src, dst, pred, pred_id, pass_src, pass_dst, self_loop):
    m = _old_pass(pass_src, src) & _old_pass(pass_dst, dst)
    m = m & (pred == pred_id) if pred_id >= 0 else m
    return m & (src == dst) if self_loop else m


def _old_edge_rows(mask, src, dst, self_loop, cap):
    e = src.shape[0]
    idx = tfused.compact_indices(mask, cap, e)
    if self_loop:
        s = src[torch.clamp(idx, max=e - 1)].masked_fill(idx >= e, -1)
        return s[:, None]
    safe = torch.clamp(idx, max=e - 1)
    pad = (idx >= e)[:, None]
    return torch.stack([src[safe], dst[safe]], dim=1).masked_fill(pad, -1)


def _old_injective_keep(rows, pairs):
    keep = rows[:, 0] >= 0
    for i, j in pairs:
        keep &= rows[:, i] != rows[:, j]
    return keep


def _old_filter_gather(rows, keep, cap_out):
    cap_in = rows.shape[0]
    idx = tfused.compact_indices(keep, cap_out, cap_in)
    safe = torch.clamp(idx, max=cap_in - 1)
    return rows[safe].masked_fill((idx >= cap_in)[:, None], -1)


def _edge_case(spec):
    src, dst, pred, ms, md = rsc.edges(7)
    ps, pd = rsc.specs(spec, torch.as_tensor(ms), torch.as_tensor(md))
    return (_t(src), _t(dst), _t(pred)), ps, pd


def _caps(count):
    """The engine's capacity, one that cuts the kept rows, a larger one."""
    return (tm._pow2(count), count // 2, 4 * tm._pow2(count))


@pytest.mark.parametrize("self_loop", [False, True])
@pytest.mark.parametrize("spec", rsc.EDGE_SPECS)
@pytest.mark.parametrize("pred_id", rsc.EDGE_PREDS)
def test_edge_select_plain_matches_the_engines_composition(pred_id, spec,
                                                           self_loop):
    (src, dst, pred), ps, pd = _edge_case(spec)
    mask = _old_edge_mask(src, dst, pred, pred_id, ps, pd, self_loop)
    sel = tops.edge_select(src, dst, pred, pred_id, ps, pd,
                           self_loop=self_loop)
    count = int(mask.sum())
    assert int(sel.total) == count and 0 < count < src.shape[0]
    for cap in _caps(count):
        got = sel.rows(cap)
        assert got.dtype == torch.int32
        assert torch.equal(got, _old_edge_rows(mask, src, dst, self_loop,
                                               cap))


@pytest.mark.parametrize("self_loop", [False, True])
def test_edge_pairs_cap_below_the_count_raises(self_loop):
    edges, ps, pd = _edge_case("mask_interval")
    cols = (4, 4) if self_loop else (4, 5)
    t = tm.edge_pairs(None, 1, ps, pd, cols, edges=edges)
    assert t.count > 0 and t.rows.shape == (tm._pow2(t.count),
                                            1 if self_loop else 2)
    with pytest.raises(tm.CapacityOverflow) as ei:
        tm.edge_pairs(None, 1, ps, pd, cols, cap=t.count - 1, edges=edges)
    assert ei.value.needed == t.count
    exact = tm.edge_pairs(None, 1, ps, pd, cols, cap=t.count, edges=edges)
    assert torch.equal(exact.rows, t.rows[: t.count])


@pytest.mark.parametrize("fill", rsc.TABLE_FILLS)
@pytest.mark.parametrize("k", range(1, 9))
def test_distinct_select_plain_matches_the_engines_composition(k, fill):
    rows = _t(rsc.table(3, k, fill))
    pairs = rsc.pairs_of(rsc.query_cols(k))
    keep = _old_injective_keep(rows, pairs)
    sel = tops.distinct_select(rows, pairs)
    kept = int(keep.sum())
    assert int(sel.total) == kept
    assert kept == {"all_kept": 300, "none_kept": 0}.get(fill, kept)
    for cap in _caps(kept):
        assert torch.equal(sel.rows(cap), _old_filter_gather(rows, keep, cap))
    # the injective filter over a table of these rows: untouched when
    # every row is kept, else the kept rows at the engine's capacity
    table = tm.Table(cols=rsc.query_cols(k), rows=rows, count=300,
                     sort_order=rsc.query_cols(k)[:1])
    out = tm.injective_filter(table)
    if k < 2 or kept == 300:
        assert out is table
    else:
        assert (out.count, out.sort_order) == (kept, table.sort_order)
        assert torch.equal(out.rows, _old_filter_gather(rows, keep,
                                                        tm._pow2(kept)))


@pytest.mark.parametrize("length", ["count", "cap"])
@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_masked_select_plain_matches_the_engines_composition(k, length):
    rows = _t(rsc.table(5, k, "mixed"))
    n = 300 if length == "count" else rows.shape[0]
    keep = torch.as_tensor(np.random.default_rng(k).random(n) < 0.4)
    full = torch.cat([keep, torch.zeros(rows.shape[0] - n,
                                        dtype=torch.bool)])
    sel = tops.masked_select(rows, keep)
    assert int(sel.total) == int(keep.sum())
    for cap in _caps(int(keep.sum())):
        assert torch.equal(sel.rows(cap), _old_filter_gather(rows, full, cap))
    table = tm.Table(cols=rsc.query_cols(k), rows=rows, count=300)
    for got in (tm.filter_rows(table, keep),
                tm.filter_rows(table, keep.numpy()),
                tm.filter_rows(table, keep, kept=int(keep.sum()))):
        assert got.count == int(keep.sum())
        assert torch.equal(got.rows, _old_filter_gather(
            rows, full, tm._pow2(got.count)))


@pytest.mark.parametrize("entry", ["edge_select", "distinct_select",
                                   "masked_select"])
def test_row_select_dispatch(entry):
    """impl='cuda' on CPU tensors raises KernelError; a CPU call launches
    no kernel."""
    (src, dst, pred), ps, pd = _edge_case("mask")
    rows = _t(rsc.table(1, 3, "mixed"))
    call = {"edge_select": lambda **kw: tops.edge_select(
                src, dst, pred, 0, ps, pd, **kw),
            "distinct_select": lambda **kw: tops.distinct_select(
                rows, ((0, 1),), **kw),
            "masked_select": lambda **kw: tops.masked_select(
                rows, rows[:, 0] > 2, **kw)}[entry]
    with pytest.raises(KernelError):
        call(impl="cuda")
    kernel = tops.cuda_kernels()["row_select"]
    before = dict(kernel.entry_launches)
    sel = call()
    sel.rows(tm._pow2(int(sel.total)))
    assert kernel.entry_launches == before


# --------------------------- bitmask contains -------------------------- #
@pytest.mark.parametrize("c,w", [(1, 1), (9, 3), (64, 8), (200, 17),
                                 (513, 4)])
def test_bitmask_contains_matches_pallas(c, w):
    rng = np.random.default_rng(c * 31 + w)
    cand = rng.integers(0, 2 ** 32, (c, w), dtype=np.uint32)
    queries = (rng.integers(0, 2 ** 32, w, dtype=np.uint32),
               cand[c // 2],                           # self-containment
               cand[c // 2] & rng.integers(0, 2 ** 32, w, dtype=np.uint32),
               np.zeros(w, np.uint32))
    for q in queries:
        want = np.asarray(jops.bitmask_contains(cand, q, impl="interpret"))
        for impl in ("auto", "sorted", "ref"):
            got = tops.bitmask_contains(cand, q, impl=impl)
            assert got.dtype == torch.int32
            _eq(got, want)
    assert want.all()                       # the empty query passes all
    ok = tops.bitmask_contains(cand, cand[c // 2]).numpy()
    assert ok[c // 2] == 1


def test_bitmask_contains_reads_a_row_slice_as_its_table():
    """sigs[lo:hi] at an odd lo: the slice, not the table it views."""
    rng = np.random.default_rng(5)
    sigs = rng.integers(0, 2 ** 32, (40, 3), dtype=np.uint32)
    q = sigs[9] & sigs[20]
    want = np.asarray(jops.bitmask_contains(sigs[9:31], q, impl="interpret"))
    _eq(tops.bitmask_contains(tops.bits32(sigs)[9:31], q), want)
    assert want[0] == want[11] == 1


# ----------------------------- intersect any --------------------------- #
@pytest.mark.parametrize("p,a,b", [(1, 1, 1), (5, 7, 11), (64, 32, 64),
                                   (257, 16, 8), (100, 130, 20)])
def test_intersect_any_matches_pallas(p, a, b):
    rng = np.random.default_rng(p * 7 + a * 3 + b)
    x = np.where(rng.random((p, a)) < 0.7,
                 rng.integers(0, 50, (p, a)), -1).astype(np.int32)
    y = np.where(rng.random((p, b)) < 0.7,
                 rng.integers(0, 50, (p, b)), -1).astype(np.int32)
    x[::3] = -1                             # all-padding a-rows
    y[1::4] = -1                            # all-padding b-rows
    want = np.asarray(jops.intersect_any(x, y, impl="interpret"))
    for impl in ("auto", "sorted", "ref"):
        got = tops.intersect_any(x, y, impl=impl)
        assert got.dtype == torch.int32
        _eq(got, want)
    assert not want[::3].any()


def test_intersect_any_padding_is_never_a_hit():
    x = np.full((3, 4), -1, np.int32)
    want = np.asarray(jops.intersect_any(x, x, impl="interpret"))
    for impl in ("auto", "ref"):
        _eq(tops.intersect_any(x, x, impl=impl), want)
    assert not want.any()


def _ragged(rows):
    """The valid (>= 0) entries of each -1 padded row, in order: (ids,
    offsets [P + 1])."""
    rows = np.asarray(rows)
    valid = rows >= 0
    off = np.concatenate([[0], np.cumsum(valid.sum(axis=1))])
    return rows[valid].astype(np.int32), off.astype(np.int32)


@pytest.mark.parametrize("p,a,b", [(1, 1, 1), (5, 7, 11), (64, 32, 64),
                                   (257, 16, 8), (100, 130, 20)])
def test_intersect_any_ragged_matches_pallas(p, a, b):
    """The padded rows of the intersect_any grid go to the Pallas kernel;
    the same rows compacted to ragged form (empty where all padding, ids
    repeated within rows, one row's order reversed) to the port."""
    rng = np.random.default_rng(p * 7 + a * 3 + b)
    x = np.where(rng.random((p, a)) < 0.7,
                 rng.integers(0, 50, (p, a)), -1).astype(np.int32)
    y = np.where(rng.random((p, b)) < 0.7,
                 rng.integers(0, 50, (p, b)), -1).astype(np.int32)
    x[::3] = -1                             # all-padding a-rows
    y[1::4] = -1                            # all-padding b-rows
    x[:, -1] = np.where(x[:, 0] >= 0, x[:, 0], x[:, -1])   # repeated ids
    y[-1] = y[-1, ::-1]
    want = np.asarray(jops.intersect_any(x, y, impl="interpret"))
    xa, xo = _ragged(x)
    ya, yo = _ragged(y)
    for impl in ("auto", "ref"):
        got = tops.intersect_any_ragged(xa, xo, ya, yo, impl=impl)
        assert got.dtype == torch.int32
        _eq(got, want)
    assert not want[::3].any()


def test_intersect_any_ragged_plain_version_checks_offsets():
    ids, off = _t([1, 2, 3]), _t([0, 2, 3])
    _eq(tops.intersect_any_ragged(ids, off, _t([3, 9]), _t([0, 0, 2])),
        [0, 1])
    for bad in ([0, 3, 2], [1, 2, 3], [0, 2, 4], [0, 3]):
        with pytest.raises(ValueError):
            tops.intersect_any_ragged(ids, _t(bad), ids, off)
    with pytest.raises(ValueError):
        tops.intersect_any_ragged(ids, off, ids, off, impl="pallas")
    with pytest.raises(RuntimeError):
        tops.intersect_any_ragged(ids, off, ids, off, impl="cuda")
    # no pairs, and ids of any sign
    _eq(tops.intersect_any_ragged(_t([]), _t([0]), _t([]), _t([0])), [])
    _eq(tops.intersect_any_ragged(_t([-5]), _t([0, 1]), _t([-5, 7]),
                                  _t([0, 2])), [1])
    kernel = tops.cuda_kernels()["intersect_any"]
    assert kernel.entry_launches == {"intersect_any": 0,
                                     "intersect_any_ragged": 0}


# --------------------------- bloom signatures -------------------------- #
def test_bloom_helpers_match_reference():
    """build_bloom, bloom_query_sig and bloom_prefilter on NI rows of
    lubm_like(scale=0.05): the same uint32 signatures and masks."""
    g = lubm_like(scale=0.05, seed=1)
    ni = build_ni_index(g, d_max=2)
    e1 = ni.entries[1]
    sigs = jsig.build_bloom(e1)
    got = tsig.build_bloom(e1)
    assert got.dtype == np.uint32
    _eq(got, sigs)
    rng = np.random.default_rng(11)
    node = int(np.argmax((e1.ids >= 0).sum(axis=1)))
    nbrs = e1.ids[node][e1.ids[node] >= 0][:2].astype(np.int64)
    _eq(tsig.bloom_query_sig(nbrs), jsig.bloom_query_sig(nbrs))
    # exact keywords (width-1 intervals) at distance 1, one wide interval
    lo_iv = np.concatenate([nbrs, [0]])
    hi_iv = np.concatenate([nbrs + 1, [g.num_nodes]])
    need = np.ones((2, 3), np.int32)
    sigs_dev = tops.bits32(got)
    removed = 0
    for lo, hi in ((0, g.num_nodes), (node - 7, node + 300), (1, 2)):
        lo = max(lo, 0)
        want = jsig.bloom_prefilter(
            sigs, e1, jsig.NodeReqs(jsig.DirectionReqs(lo_iv, hi_iv, need),
                                    None), lo, hi, impl="ref")
        mask = tsig.bloom_prefilter(
            sigs_dev, e1, tsig.NodeReqs(tsig.DirectionReqs(lo_iv, hi_iv,
                                                           need), None),
            lo, hi, device="cpu")
        assert mask.dtype == torch.bool
        _eq(mask, want)
        removed += int((~mask).sum())
    assert removed > 0


# ------------------------------- dispatch ------------------------------ #
def test_dispatch_rejects_unknown_impl_and_cuda_on_cpu():
    a = _t([1, 2, 3])
    with pytest.raises(ValueError):
        tops.merge_probe(a, a, impl="pallas")
    with pytest.raises(RuntimeError):
        tops.merge_probe(a, a, impl="cuda")
    with pytest.raises(RuntimeError):
        tops.expand_segments(a, 8, impl="cuda")
    with pytest.raises(RuntimeError):
        tops.bitmask_contains(a[None, :], a, impl="cuda")
    with pytest.raises(RuntimeError):
        tops.intersect_any(a[None, :], a[None, :], impl="cuda")


def test_cpu_dispatch_launches_no_kernel():
    before = {k: v.launches for k, v in tops.cuda_kernels().items()}
    tops.merge_probe(_t([1, 2]), _t([2, 3]))
    tops.interval_count(_t([[1, 2, -1]]), _t([0]), _t([5]))
    tops.expand_segments(_t([1, 2]), 4)
    tops.radix_probe(_t([1]), _t([1, 2]), _t([0] * 16 + [2]), bits=4,
                     lmax=8)
    tops.interval_check([tref.CheckSegment(
        _t([[1, -1]]), None, torch.zeros(1, dtype=torch.bool), [0], [5],
        [1], True)], 0, 1)
    tops.bitmask_contains(_t([[1, 2]]), _t([1, 0]))
    tops.intersect_any(_t([[1, -1]]), _t([[3, 1]]))
    for sel in (tops.edge_select(_t([1, 2]), _t([2, 2]), _t([0, 0]), -1,
                                 (0, 5), (0, 5)),
                tops.distinct_select(_t([[1, 2], [3, 3]]), ((0, 1),)),
                tops.masked_select(_t([[1], [2]]), torch.tensor([1, 0]) > 0)):
        sel.rows(4)
    assert len(before) == 7
    assert {k: v.launches for k, v in tops.cuda_kernels().items()} == before
