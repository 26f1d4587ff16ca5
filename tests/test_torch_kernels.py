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
from repro.core.signature import _gather_count
from repro.core.ni_index import build_ni_index
from repro.data import lubm_like

import repro_torch.kernels.fused_join as tfused
import repro_torch.kernels.radix_join as trad
from repro_torch.kernels import ops as tops, ref as tref

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


# --------------------------- expand segments --------------------------- #
@pytest.mark.parametrize("n,cap", [(17, 256), (200, 1024), (1, 64),
                                   (1000, 4096)])
def test_expand_segments_matches_pallas(n, cap):
    rng = np.random.default_rng(n + cap)
    csum = np.cumsum(rng.integers(0, 9, n)).astype(np.int32)
    want = jfused.expand_segments_pallas(jnp.asarray(csum), cap,
                                         interpret=True)
    _eq(tops.expand_segments(_t(csum), cap), want)


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
    gl, gc = tops.radix_probe(_t(a), _t(win))
    _eq(gl, wl)
    _eq(gc, wc)


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


# ------------------------------- dispatch ------------------------------ #
def test_dispatch_rejects_unknown_impl_and_cuda_on_cpu():
    a = _t([1, 2, 3])
    with pytest.raises(ValueError):
        tops.merge_probe(a, a, impl="pallas")
    with pytest.raises(RuntimeError):
        tops.merge_probe(a, a, impl="cuda")
    with pytest.raises(RuntimeError):
        tops.expand_segments(a, 8, impl="cuda")


def test_cpu_dispatch_launches_no_kernel():
    before = {k: v.launches for k, v in tops.cuda_kernels().items()}
    tops.merge_probe(_t([1, 2]), _t([2, 3]))
    tops.interval_count(_t([[1, 2, -1]]), _t([0]), _t([5]))
    tops.expand_segments(_t([1, 2]), 4)
    tops.radix_probe(_t([1]), _t([[1, 2]]))
    assert {k: v.launches for k, v in tops.cuda_kernels().items()} == before
