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
