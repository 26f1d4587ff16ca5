"""The CUDA kernels of repro_torch against their plain PyTorch versions, on
the card.  Needs an NVIDIA GPU and nvcc; every test carries the ``cuda``
marker and skips where CUDA is absent.  Imports nothing of JAX, so it runs
on a machine with only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.kernels import ops, ref

A_INV = (1 << 31) - 1
B_INV = (1 << 31) - 2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _on(dev, x):
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _sorted_keys(rng, n, hi, sentinel):
    ks = rng.integers(0, hi, n).astype(np.int32)
    ks[: max(n // 5, 1)] = sentinel
    return np.sort(ks)


@pytest.mark.parametrize("na,nb", [(1, 1), (7, 130), (5000, 7000),
                                   (1 << 16, 300)])
def test_merge_probe_kernel(dev, na, nb):
    rng = np.random.default_rng(na + nb)
    a = _on(dev, _sorted_keys(rng, na, 500, A_INV))
    b = _on(dev, _sorted_keys(rng, nb, 500, B_INV))
    for g, w in zip(ops.merge_probe(a, b), ref.merge_probe_sorted(a, b)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,cap", [(1, 64), (3000, 1 << 14), (17, 256)])
def test_expand_segments_kernel(dev, n, cap):
    rng = np.random.default_rng(n)
    csum = _on(dev, np.cumsum(rng.integers(0, 9, n)))
    assert torch.equal(ops.expand_segments(csum, cap),
                       ref.expand_segments_ref(csum, cap))


@pytest.mark.parametrize("lmax", [1, 3, 8, 16, 33, 64])
def test_window_probe_kernel(dev, lmax):
    rng = np.random.default_rng(lmax)
    keys = _on(dev, rng.integers(0, 9, 999))
    win = np.sort(rng.integers(0, 9, (999, lmax)), axis=1)
    win[:, lmax // 2:][rng.random((999, lmax - lmax // 2)) < 0.3] = B_INV
    win = _on(dev, win)
    for g, w in zip(ops.radix_probe(keys, win),
                    ref.window_probe_ref(keys, win)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("c,b,j", [(1, 1, 1), (500, 300, 18), (64, 4096, 8)])
def test_interval_count_kernel(dev, c, b, j):
    rng = np.random.default_rng(c + b + j)
    ids = np.full((c, b), -1, np.int32)
    for i in range(c):
        k = rng.integers(0, b + 1)
        ids[i, :k] = np.sort(rng.integers(0, 1000, k))
    ids = _on(dev, ids)
    cands = _on(dev, rng.integers(0, c, 777))
    lo = _on(dev, rng.integers(0, 900, j))
    hi = lo + _on(dev, rng.integers(0, 200, j))
    assert torch.equal(ops.interval_count(ids, lo, hi, cands=cands),
                       ref.interval_count_gather_ref(ids, cands, lo, hi))
    # with each row's stored length (the engine's form), and with lengths
    # that cut rows short
    full = (ids >= 0).sum(dim=1, dtype=torch.int32)
    for lens in (full, _on(dev, rng.integers(0, b + 1, c))):
        assert torch.equal(
            ops.interval_count(ids, lo, hi, cands=cands, lens=lens),
            ref.interval_count_gather_ref(ids, cands, lo, hi, lens))
    torch.cuda.synchronize()


@pytest.mark.parametrize("c,w", [(1, 1), (999, 3), (5000, 8), (300, 17),
                                 (513, 4)])
def test_bitmask_contains_kernel(dev, c, w):
    rng = np.random.default_rng(c + w)
    sigs = rng.integers(0, 2 ** 32, (c + 5, w), dtype=np.uint32)
    table = ops.bits32(sigs).to(dev)
    for q in (rng.integers(0, 2 ** 32, w, dtype=np.uint32),
              sigs[c // 2] & sigs[(c // 3) + 1], sigs[c // 2]):
        q = ops.bits32(q).to(dev)
        # the whole table, and row slices sigs[lo:hi] at even and odd lo
        for lo in (0, 1, 3):
            cand = table[lo:lo + c]
            got = ops.bitmask_contains(cand, q)
            assert torch.equal(got, ref.bitmask_contains_ref(cand, q))
    torch.cuda.synchronize()


@pytest.mark.parametrize("p,a,b", [(1, 1, 1), (77, 130, 20), (1024, 25, 4096),
                                   (300, 64, 65), (64, 200, 7)])
def test_intersect_any_kernel(dev, p, a, b):
    rng = np.random.default_rng(p + a + b)
    x = np.where(rng.random((p, a)) < 0.3,
                 rng.integers(0, 5000, (p, a)), -1)
    y = np.where(rng.random((p, b)) < 0.3,
                 rng.integers(0, 5000, (p, b)), -1)
    x[::5] = -1                             # all-padding rows
    y[2::7] = -1
    x, y = _on(dev, x), _on(dev, y)
    got = ops.intersect_any(x, y)
    assert torch.equal(got, ref.intersect_any_sorted(x, y))
    if p * a * b <= 1 << 22:
        assert torch.equal(got, ref.intersect_any_ref(x, y))
    torch.cuda.synchronize()


def test_cuda_engine_matches_cpu_engine(dev):
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    ec, eg = dt.engine("rdf_h", device="cpu"), dt.engine("rdf_h")
    kernels = ops.cuda_kernels()
    for k in kernels.values():
        k.launches = 0
    for s in range(100, 106):
        q = TD.random_query(dt.graph, size=6, seed=s,
                            n_connection=int(s >= 104))
        assert eg.execute(q).result_set() == ec.execute(q).result_set()
    assert kernels["merge_probe"].launches > 0
    assert kernels["interval_count"].launches > 0


def test_cuda_bloom_engine_matches_cpu_engine(dev):
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    cfg = dict(check_policy="always", use_bloom=True)
    ec = T.Engine(dt, T.EngineConfig(device="cpu", **cfg))
    eg = T.Engine(dt, T.EngineConfig(**cfg))
    kernel = ops.cuda_kernels()["bitmask_contains"]
    kernel.launches = 0
    for s in range(100, 106):
        q = TD.random_query(dt.graph, size=6, seed=s, exact_nodes=0.5)
        a, b = eg.execute(q), ec.execute(q)
        assert a.result_set() == b.result_set()
        assert a.stats.candidates_after == b.stats.candidates_after
    assert kernel.launches > 0


def test_cuda_connectivity_vectorized_matches_host_mask(dev):
    g = TD.random_graph(n_nodes=90, n_edges=300, n_preds=3, seed=7)
    ni = T.build_ni_index(g, d_max=2)
    rng = np.random.default_rng(7)
    a = rng.integers(0, g.num_nodes, 700)
    b = rng.integers(0, g.num_nodes, 700)
    kernel = ops.cuda_kernels()["intersect_any"]
    kernel.launches = 0
    for bi in (False, True):
        got = T.connectivity_mask_vectorized(g, ni, a, b, 4, bi, chunk=256,
                                             device="cuda")
        np.testing.assert_array_equal(
            got, T.connectivity_mask(g, ni, a, b, 4, bi))
    assert kernel.launches == 9             # 3 chunks, then 3 each way
