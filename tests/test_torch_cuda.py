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
from repro_torch.kernels import radix_join as krad
from repro_torch.kernels.merge_probe import merge_probe_cuda
from repro_torch.kernels.sorted_intersect import intersect_any_ragged_cuda

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


# merged items a block of the merge-path kernels: merge_probe's tile is
# 384, 640, 896 or 1408 by na + nb (below 2^18, 2^20, 2^21, or more),
# expand_gather's 1408.  merge_probe runs its bisection kernel below 2^13
# merged items; each case holds the engine's launch and both kernels of
# merge_probe.cu, forced.


def _probe_equal(a, b):
    want = ref.merge_probe_sorted(a, b)
    for method in ("engine", "path", "bisect"):
        got = ops.merge_probe(a, b) if method == "engine" else \
            merge_probe_cuda(a, b, method)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), method
    torch.cuda.synchronize()


@pytest.mark.parametrize("na,nb", [
    (1, 1), (1, 384), (383, 1), (385, 383), (1023, 1025), (2047, 2049),
    (4095, 4097), (3 * 1408, 5 * 1408 + 7),
    (1 << 17, (1 << 17) - 1), (1 << 17, (1 << 17) + 1),   # tile 384 | 640
    ((1 << 19) + 1, (1 << 19) - 2), (1 << 19, 1 << 19),   # 640 | 896
    ((1 << 20) - 1, 1 << 20), (1 << 20, 1 << 20),         # 896 | 1408
    (1, 1 << 20), (1 << 20, 3)])
def test_merge_probe_kernel_tile_edges(dev, na, nb):
    """The merge-path kernel at sizes around its tile, na << nb and
    na >> nb, with short duplicate runs that tile edges cut."""
    rng = np.random.default_rng(na * 7 + nb)
    hi = max(8, (na + nb) // 3)
    _probe_equal(_on(dev, np.sort(rng.integers(0, hi, na))),
                 _on(dev, np.sort(rng.integers(0, hi, nb))))


@pytest.mark.parametrize("side", ["a", "b", "both"])
def test_merge_probe_kernel_long_equal_runs(dev, side):
    """Runs of 10^5 equal keys on either side cross many tiles: cnt must
    stay exact (the run end past a tile is galloped for, not scanned)."""
    rng = np.random.default_rng(len(side))
    run = 100_000
    a = rng.integers(0, 5000, 30_000)
    b = rng.integers(0, 5000, 30_000)
    if side in ("a", "both"):
        a = np.concatenate([a, np.full(run, 2500)])
    if side in ("b", "both"):
        b = np.concatenate([b, np.full(run, 2500)])
    _probe_equal(_on(dev, np.sort(a)), _on(dev, np.sort(b)))
    # one key on one side against a run on the other, at a tile's edge
    _probe_equal(_on(dev, [2500]), _on(dev, np.full(run, 2500)))
    _probe_equal(_on(dev, np.full(run, 7)), _on(dev, [3, 7, 7, 9]))


def test_merge_probe_kernel_empty_and_sentinel_sides(dev):
    rng = np.random.default_rng(3)
    keys = _on(dev, np.sort(rng.integers(0, 100, 3000)))
    empty = _on(dev, np.zeros(0))
    _probe_equal(keys, empty)
    _probe_equal(empty, keys)
    a_inv = _on(dev, np.full(2000, A_INV))
    b_inv = _on(dev, np.full(5000, B_INV))
    _probe_equal(a_inv, b_inv)                     # all sentinels
    _probe_equal(a_inv, keys)
    _probe_equal(keys, b_inv)
    start, cnt = ops.merge_probe(a_inv, b_inv)
    assert bool((start == 5000).all()) and not bool(cnt.any())


# (n, nb, ka, kb, new_sel, zero run, limit share, cap or None)
EXPAND_GRID = [
    (1, 1, 1, 1, (), None, None, None),
    (300, 200, 2, 3, (2, 0), None, 0.4, None),
    (50, 40, 1, 2, (1,), "all", None, None),
    (6000, 300, 2, 2, (1, 0), (500, 4500), None, None),
    (700, 90, 3, 1, (), (0, 600), 0.5, None),
    (257, 129, 1, 4, (3, 1, 0, 2), None, None, None),
    (999, 64, 5, 4, (2, 3, 1), None, 0.0, None),
    (1 << 20, 1 << 20, 2, 3, (2, 0), None, None, 1 << 20),
    (1 << 19, 5000, 3, 2, (1,), (1000, 400_000), 0.6, 1 << 20),
    (3, 1 << 20, 1, 2, (1, 0), None, None, 1 << 20),  # a few long ranges
]


@pytest.mark.parametrize("case", range(len(EXPAND_GRID)))
def test_expand_gather_kernel(dev, case):
    """One launch of the merge-path expand == ref.expand_gather_ref, cap up
    to 2^20, limits below the total, long runs of cnt = 0, no new
    columns, permuted new columns and widths 1 to 8."""
    n, nb, ka, kb, new_sel, zero_run, limit, cap = EXPAND_GRID[case]
    rng = np.random.default_rng(case)
    a_rows = _on(dev, rng.integers(0, 1 << 30, (n, ka)))
    b_rows = _on(dev, rng.integers(0, 1 << 30, (nb, kb)))
    cnt = (rng.integers(1, nb // 3, n) if nb > 1000 * n
           else rng.integers(0, 3, n))
    if zero_run == "all":
        cnt[:] = 0
    elif zero_run is not None:
        cnt[zero_run[0]: zero_run[1]] = 0
    cnt = np.minimum(cnt, nb)
    start = (rng.random(n) * (nb - cnt + 1)).astype(np.int64)
    total = int(cnt.sum())
    lim = (1 << 31) - 1 if limit is None else int(total * limit)
    if cap is None:
        cap = max(64, 1 << max(min(total, lim) - 1, 0).bit_length())
    start, cnt = _on(dev, start), _on(dev, cnt)
    counter = ops.cuda_kernels()["expand_segments"]
    before = counter.launches
    got = ops.expand_gather(a_rows, b_rows, start, cnt, lim, cap, new_sel)
    assert counter.launches == before + 1
    want = ref.expand_gather_ref(a_rows, b_rows, start, cnt, lim, cap,
                                 new_sel)
    assert got.shape == want.shape == (cap, ka + len(new_sel))
    assert torch.equal(got, want)
    torch.cuda.synchronize()


def test_expand_gather_kernel_reads_total_on_the_card(dev):
    """A given csum is the running count: slots past its last entry (the
    total) or past the limit are -1, as in the plain version."""
    a_rows = _on(dev, np.arange(8)[:, None])
    b_rows = _on(dev, np.arange(100, 120)[:, None])
    cnt = _on(dev, [0, 3, 0, 0, 2, 5, 0, 1])
    start = _on(dev, [0, 2, 0, 0, 9, 11, 0, 19])
    for lim in (0, 4, 11, 100):
        got = ops.expand_gather(a_rows, b_rows, start, cnt, lim, 16, (0,))
        want = ref.expand_gather_ref(a_rows, b_rows, start, cnt, lim, 16,
                                     (0,))
        assert torch.equal(got, want)
        assert int((got[:, 0] >= 0).sum()) == min(11, lim)


def _span_probe_equal(a, keys_p, edges, bits, lmax):
    got = ops.radix_probe(a, keys_p, edges, bits=bits, lmax=lmax)
    want = krad.radix_probe_ref(a, keys_p, edges, bits, lmax)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
    return got


@pytest.mark.parametrize("lmax", [1, 3, 8, 16, 33, 64])
def test_window_probe_kernel(dev, lmax):
    """The span kernel against its plain version (radix_window +
    window_probe_ref) over a real radix partition: spans the lmax cap
    cuts or not, a hot key whose span is bisected, invalid rows on both
    sides."""
    rng = np.random.default_rng(lmax)
    b = rng.integers(0, 3000, 5000)
    b[:300] = B_INV
    b[300:340] = 1234                       # a span of 40+ keys
    b = _on(dev, b)
    bits = 9
    keys_p, _, edges, _ = krad.radix_partition(b, b[:, None], bits)
    a = rng.integers(0, 3500, 999)
    a[::7] = A_INV
    a[1], a[2] = B_INV, 1234
    assert int((edges[1:] - edges[:-1]).max()) > 16
    _span_probe_equal(_on(dev, a), keys_p, edges, bits, lmax)


def test_window_probe_kernel_empty_and_invalid_sides(dev):
    """An empty build side, all-invalid probe rows, no probe rows."""
    bits = 4
    a = _on(dev, np.random.default_rng(0).integers(0, 99, 300))
    empty = _on(dev, np.zeros(0))
    zeros = _on(dev, np.zeros((1 << bits) + 1))
    for lmax in (8, 16):
        _span_probe_equal(a, empty, zeros, bits, lmax)
    b = _on(dev, np.arange(200) % 50)
    keys_p, _, edges, _ = krad.radix_partition(b, b[:, None], bits)
    lt, cnt, _ = _span_probe_equal(_on(dev, np.full(257, A_INV)), keys_p,
                                   edges, bits, 16)
    assert (cnt == 0).all() and (lt == 16).all()
    assert _span_probe_equal(empty, keys_p, edges, bits, 16)[0].numel() == 0


def _ni_entry(rng, n, cap, lengths):
    """ids [n, cap] ascending rows of the given stored lengths, -1 padded,
    with their lengths and 5 % overflow bits."""
    ids = np.full((n, cap), -1, np.int32)
    for r, k in enumerate(lengths):
        ids[r, :k] = np.sort(rng.integers(0, 5000, k))
    over = rng.random(n) < 0.05
    return ids, np.asarray(lengths, np.int32), over


@pytest.mark.parametrize("j", [1, 8, 17, 40])
def test_interval_check_kernel(dev, j):
    """The one-launch node check against its plain version: stored
    prefixes of 0, 1, 31, 32, 33 and 4,096 ids beside short rows, J up to
    40 (two rounds of 32), overflow rows, a segment without lengths, and
    candidate ranges that are not a multiple of the block."""
    rng = np.random.default_rng(j)
    n = 3001
    special = [0, 1, 31, 32, 33, 4096]
    long_len = [special[i % 6] if i % 5 == 0 else int(rng.geometric(0.25))
                for i in range(n)]
    entries = [_ni_entry(rng, n, 8, np.minimum(rng.geometric(0.3, n), 8)),
               _ni_entry(rng, n, 4096, long_len),
               _ni_entry(rng, n, 40, np.minimum(rng.geometric(0.1, n), 40))]
    dev_entries = [(_on(dev, i), _on(dev, ln), torch.as_tensor(o, device=dev))
                   for i, ln, o in entries]

    def direction(k, pairs):
        lo = np.sort(rng.integers(0, 5000, k))
        hi = lo + rng.integers(0, 2500, k)
        segs = []
        for d, (e, lens_on) in enumerate(pairs):
            ids, lens, over = dev_entries[e]
            need = rng.integers(0, 3, k) * (rng.random(k) < 0.4)
            segs.append(ref.CheckSegment(
                ids, lens if lens_on else None, over, lo, hi,
                None if d == 0 and k % 2 else need, d == 0))
        return segs

    segs = direction(j, [(0, True), (1, True)]) + \
        direction(max(j // 2, 1), [(2, True), (1, False)])
    kernel = ops.cuda_kernels()["interval_count"]
    for lo, hi in ((0, n), (5, n - 3), (17, 18), (40, 40 + 8 * 37 + 3)):
        before = kernel.launches
        got = ops.interval_check(segs, lo, hi)
        assert kernel.launches == before + 1
        want = ref.interval_check_ref(segs, lo, hi)
        assert got.dtype == torch.bool and torch.equal(got, want)
    torch.cuda.synchronize()


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


def _ragged_pairs(rng, la, lb, hit_share=0.5):
    """Rows of random ids of lengths la[p], lb[p]; in about hit_share of
    the pairs with both rows nonempty, one a-id is planted in b."""
    a = [rng.integers(0, 1 << 20, n) for n in la]
    b = [rng.integers(1 << 20, 1 << 21, n) for n in lb]
    for x, y in zip(a, b):
        if len(x) and len(y) and rng.random() < hit_share:
            y[rng.integers(0, len(y))] = x[rng.integers(0, len(x))]
    return a, b


def _ragged_on(dev, rows, shift):
    """(ids, offsets [P + 1]) on dev; the ids tensor starts `shift` ids
    into its allocation, so its 16-byte alignment varies."""
    lens = [len(r) for r in rows]
    flat = np.concatenate([np.zeros(shift, np.int64), *rows]).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return _on(dev, flat)[shift:], _on(dev, off)


# row lengths (a, b) of each case; the path's: forward rows of 1-25 ids,
# backward rows mostly short with a tail of hubs up to 8,193 ids
_RAGGED_CASES = {
    "one_pair": ([1], [8193]),
    "one_pair_swapped": ([8193], [3]),
    "empty_rows": ([0, 5, 0, 25, 3, 0], [7, 0, 0, 8193, 1, 600]),
    "hubs_8193": ([25] * 40 + [1] * 9, [8193] * 49),
    # around the tier limits of csrc/intersect_any.cu: staged 32, streamed
    # 64 (group) and 1,024 (warp), the block's 1,024-id stage tiles
    "tiers": ([1, 32, 5, 32, 33, 32, 32, 1000, 1025, 3000],
              [64, 65, 63, 1024, 40, 1025, 4097, 1200, 5000, 3000]),
}


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("case", [*_RAGGED_CASES, "path_1024"])
def test_intersect_any_ragged_kernel(dev, case, shift):
    rng = np.random.default_rng(len(case) + shift)
    if case == "path_1024":
        la = rng.integers(1, 26, 1024)
        lb = np.where(rng.random(1024) < 0.9, rng.integers(0, 65, 1024),
                      rng.choice([513, 2048, 4096, 4097, 8193], 1024))
    else:
        la, lb = _RAGGED_CASES[case]
    a, b = _ragged_pairs(rng, la, lb)
    # an id repeated within a row, and a hit at a b-row's last id
    if len(a[-1]) > 1:
        a[-1][1] = a[-1][0]
    if len(b[0]) and len(a[0]):
        b[0][-1] = a[0][-1]
    args = (*_ragged_on(dev, a, shift), *_ragged_on(dev, b, 3 - shift))
    got = ops.intersect_any_ragged(*args)
    want = ref.intersect_any_ragged_ref(*args)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < len(la) or len(la) == 1
    torch.cuda.synchronize()


def test_intersect_any_ragged_binding_raises(dev):
    ids, off = _on(dev, [1, 2, 3]), _on(dev, [0, 1, 3])
    with pytest.raises(ValueError):               # P differs
        ops.intersect_any_ragged(ids, _on(dev, [0, 3]), ids, off)
    with pytest.raises(ValueError):               # no P + 1 entry
        ops.intersect_any_ragged(ids, off[:0], ids, off[:0])
    with pytest.raises(ValueError):               # 2-D offsets
        ops.intersect_any_ragged(ids, off[None], ids, off[None])
    with pytest.raises(ValueError):               # offsets on the CPU
        ops.intersect_any_ragged(ids, off.cpu(), ids, off)
    with pytest.raises(TypeError):
        intersect_any_ragged_cuda(ids, off.long(), ids, off)
    with pytest.raises(ValueError):
        intersect_any_ragged_cuda(ids, off, ids[::2], off)
    with pytest.raises(RuntimeError):
        ops.intersect_any_ragged(ids.cpu(), off.cpu(), ids.cpu(), off.cpu(),
                                 impl="cuda")
    # offsets outside the ids are clipped on the card, never read past
    got = ops.intersect_any_ragged(ids, _on(dev, [-4, 1, 99]), ids, off)
    assert got.tolist() == [1, 1]
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


def test_cuda_server_matches_cpu_server(dev, tmp_path):
    """The serving tier on the card: cold, warm, and restored from a
    snapshot, against the same server on the CPU."""
    from repro_torch.serve import QueryServer
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    pool = [TD.random_query(dt.graph, size=6, seed=s,
                            n_connection=int(s >= 104))
            for s in range(100, 106)]
    cpu = QueryServer(dt, calibrate=False, device="cpu")
    gpu = QueryServer(dt, calibrate=False)
    assert gpu.engine.device.type == "cuda"
    kernels = ops.cuda_kernels()
    want = [f.result().result_set()
            for f in cpu.submit_many(pool, wait=True)]
    for run in ("cold", "warm"):
        before = kernels["interval_count"].launches
        got = [f.result() for f in gpu.submit_many(pool, wait=True)]
        assert [r.result_set() for r in got] == want
        assert all(r.stats.cache_hit == (run == "warm") for r in got)
        if run == "warm":
            assert kernels["interval_count"].launches == before
    gpu.save_snapshot(tmp_path / "gpu.snap")
    restored = QueryServer(dt, calibrate=False)
    restored.restore_snapshot(tmp_path / "gpu.snap")
    before = kernels["interval_count"].launches
    got = [f.result() for f in restored.submit_many(pool, wait=True)]
    assert [r.result_set() for r in got] == want
    assert all(r.stats.cache_hit for r in got)
    assert kernels["interval_count"].launches == before
    assert restored.telemetry()["plan_cache"]["misses"] == 0


def test_cuda_governed_server_raises_on_kernel_failure(dev, monkeypatch):
    """Every kernel's launch reports a CUDA error: a governed server on the
    card fails each query with the KernelError (phase 'execute') — no
    retry, and no degraded rung answering with the plain versions."""
    from repro_torch.kernels import KernelError
    from repro_torch.serve import GovernorConfig, QueryError, QueryServer
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    pool = [TD.random_query(dt.graph, size=6, seed=s,
                            n_connection=int(s >= 104))
            for s in range(100, 106)]
    srv = QueryServer(dt, calibrate=False, governor=GovernorConfig())
    for kernel in ops.cuda_kernels().values():
        for symbol in kernel.entries:
            kernel._bind(symbol)                # built and bound as usual
            monkeypatch.setitem(kernel._fns, symbol, lambda *a: 1)
    for f in srv.submit_many(pool, wait=True):
        with pytest.raises(QueryError) as ei:
            f.result()
        assert ei.value.phase == "execute"
        assert isinstance(ei.value.__cause__, KernelError)
    tel = srv.governor.snapshot()
    assert tel["ladder_entries"] == tel["transient_retries"] == 0
    assert tel["degraded_queries"] == 0


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


def test_cuda_connectivity_vectorized_launches_ragged_entry(dev):
    """One intersect_any_ragged launch a chunk, none of the padded entry,
    at hops within d_max and beyond it (d_max = 1, d_c = 4)."""
    g = TD.random_graph(n_nodes=90, n_edges=300, n_preds=3, seed=8)
    kernel = ops.cuda_kernels()["intersect_any"]
    rng = np.random.default_rng(8)
    a = rng.integers(0, g.num_nodes, 300)
    b = rng.integers(0, g.num_nodes, 300)
    for d_max in (1, 2):
        ni = T.build_ni_index(g, d_max=d_max, cap_quantile=0.7)
        kernel.reset()
        timings = {}
        got = T.connectivity_mask_vectorized(g, ni, a, b, 4, True, chunk=128,
                                             device="cuda", timings=timings)
        np.testing.assert_array_equal(
            got, T.connectivity_mask(g, ni, a, b, 4, True))
        assert kernel.entry_launches == {"intersect_any": 0,
                                         "intersect_any_ragged": 6}
        assert timings["fallback_pairs"] > 0
        assert set(timings) == {"gather", "upload", "kernel", "fallback",
                                "fallback_pairs"}
