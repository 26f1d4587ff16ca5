"""Parity of the port's batched connectivity check against the JAX package.

``repro_torch.core.connectivity_mask_vectorized`` (reach sets on the host,
the intersect_any kernel's plain version on the CPU here) must return the
same masks as ``repro.core.connectivity_mask_vectorized`` on the grid of
tests/test_connectivity.py: random graphs, index depths d_max 1-3 below and
above the hop split of d_c 2-5, self and repeated pairs, both directions.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.data as JD
import repro_torch.core as T
import repro_torch.data as TD


def _pair(seed, n_nodes, n_edges, d_max, cap_quantile=1.0):
    kw = dict(n_nodes=n_nodes, n_edges=n_edges, n_preds=3, seed=seed)
    gj, gt = JD.random_graph(**kw), TD.random_graph(**kw)
    return (gj, J.build_ni_index(gj, d_max=d_max, cap_quantile=cap_quantile),
            gt, T.build_ni_index(gt, d_max=d_max, cap_quantile=cap_quantile))


def _check(gj, nj, gt, nt, a, b, d_c):
    for bi in (False, True):
        want = J.connectivity_mask_vectorized(gj, nj, a, b, d_c, bi,
                                              impl="ref")
        for impl in ("auto", "ref"):
            got = T.connectivity_mask_vectorized(gt, nt, a, b, d_c, bi,
                                                 impl=impl, chunk=16,
                                                 device="cpu")
            assert got.dtype == bool
            np.testing.assert_array_equal(got, want)
        # and the port's per-pair mask agrees
        np.testing.assert_array_equal(
            T.connectivity_mask(gt, nt, a, b, d_c, bi), want)
    return want


@pytest.mark.parametrize("seed,d_max,d_c", [
    (0, 1, 2), (1, 2, 3), (2, 2, 4), (3, 3, 5), (4, 1, 3), (5, 2, 2)])
def test_vectorized_matches_reference(seed, d_max, d_c):
    rng = np.random.default_rng(seed)
    gj, nj, gt, nt = _pair(seed + 100, int(rng.integers(40, 100)),
                           int(rng.integers(120, 320)), d_max)
    p = 48
    a = rng.integers(0, gt.num_nodes, p)
    b = rng.integers(0, gt.num_nodes, p)
    b[: p // 8] = a[: p // 8]                # self pairs
    a[p // 8: p // 4] = a[0]                 # repeated sources
    want = _check(gj, nj, gt, nt, a, b, d_c)
    assert want[: p // 8].all()              # a node reaches itself


def test_vectorized_overflow_rows_fall_back_to_bfs():
    """A cut NI index (cap at the median row) overflows rows, whose
    reach sets then come from BFS."""
    gj, nj, gt, nt = _pair(21, 70, 200, 2, cap_quantile=0.5)
    assert nt.entries[-2].overflow.any()
    rng = np.random.default_rng(2)
    a = rng.integers(0, gt.num_nodes, 40)
    b = rng.integers(0, gt.num_nodes, 40)
    b[:10] = np.flatnonzero(nt.entries[-2].overflow)[0]
    _check(gj, nj, gt, nt, a, b, 4)


def test_vectorized_needs_a_device(monkeypatch):
    g = TD.random_graph(n_nodes=30, n_edges=80, n_preds=2, seed=1)
    ni = T.build_ni_index(g, d_max=2)
    a = np.arange(4)
    with pytest.raises(TypeError):
        T.connectivity_mask_vectorized(g, ni, a, a, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.connectivity_mask_vectorized(g, ni, a, a, 2, device="cuda")


@pytest.mark.parametrize("seed,d_max,cap_quantile", [
    (0, 1, 1.0), (1, 2, 1.0), (3, 3, 1.0), (21, 2, 0.5)])
def test_ragged_reach_rows_equal_reach_sets(seed, d_max, cap_quantile):
    """ragged_reach, at every hop count up to d_max + 1 and both signs,
    holds reach_sets' row as a set wherever that row did not overflow,
    and overflows (with an empty row) where the NI index did."""
    rng = np.random.default_rng(seed)
    gj, nj, gt, nt = _pair(seed + 100, int(rng.integers(40, 100)),
                           int(rng.integers(120, 320)), d_max, cap_quantile)
    nodes = rng.integers(0, gt.num_nodes, 64)
    nodes[:4] = nodes[0]                     # repeated nodes
    for hops in range(d_max + 2):
        for sign in (+1, -1):
            ids, off, of = T.ragged_reach(nt, nodes, hops, sign)
            want, want_of = J.reach_sets(nj, nodes, hops, sign)
            assert ids.dtype == np.int32 and off.shape == (len(nodes) + 1,)
            np.testing.assert_array_equal(of, want_of)
            for i in range(len(nodes)):
                row = ids[off[i]:off[i + 1]]
                if of[i]:
                    assert row.size == 0
                    continue
                assert set(row.tolist()) == set(
                    want[i][want[i] >= 0].tolist())
                if hops <= d_max:        # the NI rows are disjoint
                    assert row[0] == nodes[i]
                    assert len(np.unique(row[1:])) == row.size - 1
    if cap_quantile < 1.0:
        assert of.any()
