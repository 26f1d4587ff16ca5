"""The CUDA kernels of repro_torch against their plain PyTorch versions, on
the card, and the LM scaffold (repro_torch.models) on the card against the
CPU.  Needs an NVIDIA GPU and nvcc; every test carries the ``cuda``
marker and skips where CUDA is absent.  Imports nothing of JAX, so it runs
on a machine with only PyTorch:

    python -m pytest -q tests/test_torch_cuda.py
"""
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.data as TD
from repro_torch.kernels import ops, ref
from repro_torch.kernels import radix_join as krad
from repro_torch.kernels.merge_probe import merge_probe_cuda
from repro_torch.kernels.sorted_intersect import intersect_any_ragged_cuda

import row_select_cases as rsc

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


@pytest.mark.parametrize("j", [1, 8, 40])
def test_interval_check_writes_rows_in_place_and_counts(dev, j):
    """The launch's in-place verdict and its device counters against the
    verdict of the plain version and the host's counts (passes, and passes
    with an overflowed row in any segment): four nodes writing rows of one
    shared [Q, N] buffer, their words in one packed upload, over random
    segments with overflowed rows, an empty range and a range that ends
    at row N; columns outside lo..hi stay false."""
    from repro_torch.kernels.interval_count import check_words
    rng = np.random.default_rng(100 + j)
    n = 3001
    entries = [_ni_entry(rng, n, 8, np.minimum(rng.geometric(0.3, n), 8)),
               _ni_entry(rng, n, 64, np.minimum(rng.geometric(0.05, n), 64)),
               _ni_entry(rng, n, 40, np.minimum(rng.geometric(0.1, n), 40))]
    dev_entries = [(_on(dev, i), _on(dev, ln), torch.as_tensor(o, device=dev))
                   for i, ln, o in entries]

    def node(k):
        segs = []
        for sign_j, picks in ((k, (0, 1)), (max(k // 2, 1), (2,))):
            lo = np.sort(rng.integers(0, 5000, sign_j))
            hi = lo + rng.integers(0, 2500, sign_j)
            for d, e in enumerate(picks):
                ids, lens, over = dev_entries[e]
                need = rng.integers(0, 3, sign_j) * (rng.random(sign_j) < 0.4)
                segs.append(ref.CheckSegment(ids, lens, over, lo, hi, need,
                                             d == 0))
        return segs

    ranges = [(0, n), (5, n), (17, 17), (40, 40 + 8 * 37 + 3)]
    nodes = [node(j) for _ in ranges]
    words = [check_words(segs) for segs in nodes]
    data = ops.upload(np.concatenate(words), dev)
    rows = torch.zeros((len(nodes), n), dtype=torch.bool, device=dev)
    tally = torch.zeros((len(nodes), 2), dtype=torch.int32, device=dev)
    kernel = ops.cuda_kernels()["interval_count"]
    at = 0
    for q, (segs, (lo, hi)) in enumerate(zip(nodes, ranges)):
        before = kernel.launches
        got = ops.interval_check(segs, lo, hi, out=rows[q], tally=tally[q],
                                 data=data, data_at=at)
        assert kernel.launches == before + (hi > lo)
        assert got.numel() == hi - lo
        assert hi == lo or got.data_ptr() == rows[q].data_ptr() + lo
        at += len(words[q])
    overflowed = 0
    for q, (segs, (lo, hi)) in enumerate(zip(nodes, ranges)):
        want = ref.interval_check_ref(segs, lo, hi)
        over = torch.zeros(hi - lo, dtype=torch.bool, device=dev)
        for seg in segs:
            over |= seg.overflow[lo:hi]
        assert torch.equal(rows[q, lo:hi], want)
        assert not rows[q, :lo].any() and not rows[q, hi:].any()
        host = [int(want.sum()), int((want & over).sum())]
        assert tally[q].tolist() == host
        overflowed += host[1]
        # the plain version's counters agree on the card's tensors too
        t = torch.zeros(2, dtype=torch.int32, device=dev)
        ref.interval_check_ref(segs, lo, hi, tally=t)
        assert t.tolist() == host
    assert overflowed > 0 and 0 < int(tally[:, 0].sum()) < 2 * n


def test_cuda_cold_check_waits_once_and_matches_cpu(dev, monkeypatch):
    """The engine's cold check on the card makes one interval_check_cuda
    call a checked node and makes the host wait once (the counters'
    read; torch's sync debug mode sees no other), with the CPU engine's
    masks and counts."""
    import warnings
    from repro_torch.core.signature import CheckCounts
    dt = T.Dataset.build(TD.DATASETS["dblp"](scale=0.05, seed=1),
                         cap_quantile=0.9)
    eg = T.Engine(dt, T.EngineConfig(check_policy="always"))
    ec = T.Engine(dt, T.EngineConfig(check_policy="always", device="cpu",
                                     impl="ref"))
    eg.execute(TD.random_query(dt.graph, size=6, seed=99))  # NI uploaded
    calls = []
    real = ops.interval_check_cuda
    monkeypatch.setattr(ops, "interval_check_cuda",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    checked = 0
    for s in range(100, 106):
        q = TD.random_query(dt.graph, size=6, seed=s)
        pg, pc = eg.prepare(q), ec.prepare(q)
        cg, cc = CheckCounts(), CheckCounts()
        calls.clear()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                masks, host, after = eg._candidate_masks(pg, cg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [w for w in caught if "synchroniz" in str(w.message)]
        assert len(waits) == cg.syncs == int(cg.nodes > 0)
        assert len(calls) == cg.nodes
        _, host_c, after_c = ec._candidate_masks(pc, cc)
        assert cg == cc and after == after_c
        for node in masks:
            a, b = host[node], host_c[node]
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        checked += cg.nodes
    assert checked > 0


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


# ----------------------------- row selection --------------------------- #
def _caps(count):
    """The engine's capacity, one that cuts the kept rows, a larger one."""
    return (T.matching._pow2(count), count // 2,
            4 * T.matching._pow2(count))


def _selection_equal(got, want, caps=None):
    assert int(got.total) == int(want.total)
    count = int(want.total)
    for cap in caps or _caps(count):
        g, w = got.rows(cap), want.rows(cap)
        assert g.dtype == torch.int32 and g.is_cuda
        assert torch.equal(g.cpu(), w), cap
    torch.cuda.synchronize()
    return count


def _spec_on(dev, spec):
    return spec if isinstance(spec, tuple) else spec.to(dev)


def _edge_selections(dev, src, dst, pred, pred_id, ps, pd, self_loop):
    cpu = [torch.as_tensor(np.asarray(a, np.int32)) for a in (src, dst,
                                                              pred)]
    want = ops.edge_select(*cpu, pred_id, ps, pd, self_loop=self_loop)
    got = ops.edge_select(*(t.to(dev) for t in cpu), pred_id,
                          _spec_on(dev, ps), _spec_on(dev, pd),
                          self_loop=self_loop)
    return got, want


@pytest.mark.parametrize("self_loop", [False, True])
@pytest.mark.parametrize("spec", rsc.EDGE_SPECS)
@pytest.mark.parametrize("pred_id", rsc.EDGE_PREDS)
def test_row_select_kernel_edges(dev, pred_id, spec, self_loop):
    src, dst, pred, ms, md = rsc.edges(7)
    ps, pd = rsc.specs(spec, torch.as_tensor(ms), torch.as_tensor(md))
    count = _selection_equal(*_edge_selections(dev, src, dst, pred, pred_id,
                                               ps, pd, self_loop))
    assert 0 < count < len(src)


def test_row_select_kernel_lubm1_edges(dev, monkeypatch):
    """The benchmark's LUBM(1,0) edge arrays, 162,657 edges, by each
    predicate and by any, through masks and intervals."""
    import json
    from pathlib import Path
    from repro_torch.core.graph import RDFGraph
    root = Path(__file__).resolve().parent.parent
    monkeypatch.syspath_prepend(str(root))
    from bench.gen import triples
    tr = triples(json.loads((root / "bench/configs/lubm1.json").read_text()))
    g = RDFGraph.from_triples(
        zip(tr.subs.tolist(), tr.preds.tolist(), tr.objs.tolist()),
        literal_objects=tr.literals)
    assert g.num_edges == 162_657
    rng = np.random.default_rng(5)
    n = g.num_nodes
    ms = torch.as_tensor(rng.random(n) < 0.3)
    md = torch.as_tensor(rng.random(n) < 0.6)
    specs = [((0, n), (0, n)), ((n // 4, n // 2), (0, 3 * n // 4)),
             (ms, md), (ms, (n // 8, n))]
    for pred_id in (-1, *range(int(g.pred.max()) + 1)):
        for ps, pd in specs:
            for loop in (False, True):
                _selection_equal(*_edge_selections(
                    dev, g.src, g.dst, g.pred, pred_id, ps, pd, loop))


def _distinct_selections(dev, rows, pairs):
    rows = torch.as_tensor(rows)
    return (ops.distinct_select(rows.to(dev), pairs),
            ops.distinct_select(rows, pairs))


@pytest.mark.parametrize("fill", rsc.TABLE_FILLS)
@pytest.mark.parametrize("k", [*range(1, 9), 9, 13])
def test_row_select_kernel_distinct(dev, k, fill):
    rows = rsc.table(3, k, fill)
    _selection_equal(*_distinct_selections(
        dev, rows, rsc.pairs_of(rsc.query_cols(k))))
    # a row slice that starts off 16-byte alignment takes narrower loads
    _selection_equal(*_distinct_selections(
        dev, rows[1:], rsc.pairs_of(rsc.query_cols(k))))


def test_row_select_kernel_distinct_2_20_rows(dev):
    """A 2^20 x 6 table, the size at which the engine cuts a join."""
    rng = np.random.default_rng(20)
    cols = (1, 2, 3, 4, 5, 1)
    rows = rng.integers(0, 40, (1 << 20, 6)).astype(np.int32)
    rows[:, 5] = rows[:, 0]
    rows[rng.random(1 << 20) < 0.01] = -1
    count = _selection_equal(*_distinct_selections(dev, rows,
                                                   rsc.pairs_of(cols)))
    assert 0 < count < 1 << 20


@pytest.mark.parametrize("length", ["count", "cap"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 8, 70])
def test_row_select_kernel_masked(dev, k, length):
    rows = torch.as_tensor(rsc.table(5, k, "mixed"))
    n = 300 if length == "count" else rows.shape[0]
    keep = torch.as_tensor(np.random.default_rng(k).random(n) < 0.4)
    _selection_equal(ops.masked_select(rows.to(dev), keep.to(dev)),
                     ops.masked_select(rows, keep))


def test_row_select_call_launches_two_kernels_and_reads_once(dev):
    """edge_pairs, the injective filter, filter_rows and dedup_project on
    the card: at most two launches of the row_select kernel, one counted
    host read and at most 6 dispatched torch ops a call."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.obs import Tracer
    m = T.matching

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    src, dst, pred, ms, md = rsc.edges(9, e=20_000)
    edges = tuple(torch.as_tensor(a).to(dev) for a in (src, dst, pred))
    rows = torch.as_tensor(rsc.table(2, 6, "mixed")).to(dev)
    t6 = m.Table(cols=rsc.query_cols(6), rows=rows, count=300)
    keep = torch.as_tensor(np.random.default_rng(1).random(512) < 0.5,
                           device=dev) & (rows[:, 0] >= 0)
    mask_s = torch.as_tensor(ms).to(dev)
    calls = {
        "edge_pairs": lambda: m.edge_pairs(
            None, 1, mask_s, (0, 200), (4, 5), edges=edges),
        "edge_pairs_loop": lambda: m.edge_pairs(
            None, -1, (0, 300), (0, 300), (4, 4), edges=edges),
        "injective_filter": lambda: m.injective_filter(t6),
        "filter_rows": lambda: m.filter_rows(t6, keep),
        "dedup_project": lambda: m.dedup_project(t6, (11, 13)),
    }
    kernel = ops.cuda_kernels()["row_select"]
    tr = Tracer()
    for name, call in calls.items():
        call()                                  # built and bound
        torch.cuda.synchronize()
        tid = tr.start()
        before = kernel.launches
        # dedup_project's own lexsort dispatches ops beside the selection
        counted = Ops() if name != "dedup_project" else nullcontext()
        with tr.segment("execute", tid) as seg, counted:
            out = call()
        torch.cuda.synchronize()
        assert out.count > 0, name
        assert 1 <= kernel.launches - before <= 2, name
        assert seg.attrs.get("host_syncs") == 1, name
        assert len(Ops.seen) <= 6, (name, Ops.seen)
        Ops.seen = []
        tr.finish(tid)


def test_cuda_engine_rows_match_cpu_engine(dev, monkeypatch):
    """Engine.execute on the card gives the CPU's MatchResult rows, in
    order, for size-6 templates; its warm executions select rows only
    through the row_select kernel: no plain selection runs, and
    compact_indices is called only by _sort_sides and the nested join."""
    from repro_torch.kernels import fused_join, row_select
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    ec, eg = dt.engine("rdf_h", device="cpu"), dt.engine("rdf_h")
    queries = [TD.random_query(dt.graph, size=6, seed=s) for s in
               range(200, 208)]
    want = [ec.execute(q) for q in queries]
    pqs = [eg.prepare(q) for q in queries]
    for pq, w in zip(pqs, want):                  # cold
        r = eg.execute_prepared(pq)
        assert r.cols == w.cols and np.array_equal(r.rows, w.rows)
    callers = set()
    real = fused_join.compact_indices

    def spy(*a, **kw):
        callers.add(sys._getframe(1).f_code.co_name)
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a plain row selection ran on the card")

    for mod in (fused_join, T.matching, row_select):
        monkeypatch.setattr(mod, "compact_indices", spy)
    for name in ("edge_select_ref", "distinct_select_ref",
                 "masked_select_ref"):
        monkeypatch.setattr(row_select, name, refuse)
    kernel = ops.cuda_kernels()["row_select"]
    kernel.reset()
    for pq, w in zip(pqs, want):                  # warm
        r = eg.execute_prepared(pq)
        assert r.cols == w.cols and np.array_equal(r.rows, w.rows)
    assert kernel.entry_launches["edge_count"] > 0
    assert kernel.entry_launches["edge_compact"] > 0
    assert kernel.entry_launches["row_count"] > 0
    assert callers <= {"_sort_sides", "_join_gather"}, callers


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


def test_cuda_shard_check_matches_cpu_with_a_group_of_one(dev, tmp_path):
    """core.distributed over NCCL in a world of one: the mask and the
    gathered candidates equal the CPU run's (no group), and the card's
    shard_check launches the interval_count entry."""
    import torch.distributed as dist
    from repro_torch.core.distributed import gather_candidates, shard_check
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    e = dt.ni.entries[-1]
    n = dt.graph.num_nodes
    lo = np.asarray([0, n // 3, n // 2], np.int32)
    hi = np.asarray([n // 4, n // 2, n], np.int32)
    need = np.asarray([1, 0, 1], np.int32)
    want = shard_check(e.ids, lo, hi, need, e.overflow, device="cpu")
    want_c = gather_candidates(want, 300, device="cpu")
    kernel = ops.cuda_kernels()["interval_count"]
    kernel.reset()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        got = shard_check(e.ids, lo, hi, need, e.overflow)
        got_c = gather_candidates(got, 300)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_c, want_c)
    assert kernel.entry_launches["interval_count"] == 1
    assert 0 < want.sum() < len(want)


def test_cuda_delta_carries_only_fresh_device_tensors(dev):
    """apply_delta on a small card server: after an incremental delta and
    a no-op delta, every device tensor the server carried equals a fresh
    upload from the new dataset, and every result equals a fresh card
    engine's."""
    from repro_torch.examples.serve_queries import delta_triples
    from repro_torch.serve import QueryServer
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    cpu = dt.engine("rdf_h", device="cpu")
    # templates whose result is complete (a truncated one keeps rows in
    # its plan's order)
    pool = [q for q in (TD.random_query(dt.graph, size=6, seed=s,
                                        n_connection=int(s >= 104))
                        for s in range(100, 108))
            if not cpu.execute(q).stats.truncated]
    assert len(pool) >= 4
    srv = QueryServer(dt, calibrate=False)
    for f in srv.submit_many(pool, wait=True):
        f.result()
    ins, dels = delta_triples(dt.graph, 0)
    carried_any = False
    for inserts, deletes in ((ins, dels), ([], [("no/such",) * 3])):
        info = srv.apply_delta(inserts, deletes)
        assert info["mode"] == "incremental"
        carried = list(srv.engine._dev_cache)
        got = [f.result() for f in srv.submit_many(pool, wait=True)]
        for key in carried:
            kept, fresh = srv.engine._dev_cache[key], srv.engine.upload(key)
            kept = kept if isinstance(kept, tuple) else (kept,)
            fresh = fresh if isinstance(fresh, tuple) else (fresh,)
            assert all(torch.equal(a, b) for a, b in zip(kept, fresh))
        carried_any |= bool(carried)
        eng = srv.dataset.engine("rdf_h")
        for q, r in zip(pool, got):
            w = eng.execute(q)
            assert not r.stats.truncated and not w.stats.truncated
            assert r.result_set() == w.result_set()
    assert carried_any


def test_cuda_governed_fault_counters_match_cpu(dev):
    """A persistent join_expand fault on a governed server: each template
    walks the ladder past the first retry to an exact answer on the card,
    with the governor counters and fault calls of the CPU port's run."""
    from repro_torch.serve import GovernorConfig, QueryServer
    from repro_torch.testing import Fault, FaultInjector
    dt = T.Dataset.build(TD.DATASETS["lubm"](scale=0.3, seed=1))
    pool = [TD.random_query(dt.graph, size=6, seed=s) for s in (101, 105)]
    want = [dt.engine("rdf_h", device="cpu").execute(q).result_set()
            for q in pool]

    def run(device):
        cfg = T.EngineConfig(check_policy="selective", d_check=2,
                             thresholds=T.Thresholds(nested_join_max=1),
                             join_impl="sorted", fuse_joins=False,
                             connection_impl="reach", device=device)
        srv = QueryServer(dt, cfg=cfg, calibrate=False,
                          governor=GovernorConfig(retry_backoff_s=0.001))
        for f in srv.submit_many(pool, wait=True):
            f.result()
        with FaultInjector(Fault("join_expand", "raise", every=1)) as fi:
            res = [f.result() for f in srv.submit_many(pool, wait=True)]
        gov = srv.governor.snapshot()
        return ([r.result_set() for r in res],
                [tuple(r.stats.degraded_steps) for r in res],
                dict(fi.calls), len(fi.fired),
                {k: gov[k] for k in ("degraded_queries", "degraded_by_rung",
                                     "exhausted", "transient_retries",
                                     "ladder_entries")})
    card, cpu = run("cuda"), run("cpu")
    assert card == cpu
    assert card[0] == want
    assert all("force_simple_impls" in s for s in card[1])


# ---------------------------------------------------------------------- #
# LM scaffold (repro_torch.models): the card against the port on the CPU
# ---------------------------------------------------------------------- #
@pytest.fixture
def no_tf32(dev):
    """fp32 products in full fp32 on the card, as on the CPU."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _lm_close(got, want, what, rel=1e-4):
    """got, want: nested dicts of numpy arrays (convert.cache_to_numpy)."""
    from repro_torch.models.param import tree_leaves
    g = dict(tree_leaves(got))
    for path, a in tree_leaves(want):
        assert g[path].shape == a.shape, (what, path)
        if a.size:
            err = float(np.max(np.abs(g[path] - a)))
            assert err <= rel * max(1.0, float(np.max(np.abs(a)))), \
                (what, path, err)


LM_NAMES = ["granite-moe-1b-a400m", "hubert-xlarge", "hymba-1.5b",
            "llama4-maverick-400b-a17b", "minitron-8b", "paligemma-3b",
            "qwen2-0.5b", "rwkv6-7b", "stablelm-1.6b", "starcoder2-15b"]


def _lm_card_and_cpu_runs(cfg):
    """Prefill 2 x 40 and two decode steps of cfg with the same weights on
    the CPU and on the card: {"cpu": [...], "cuda": [...]}, one snapshot
    (logits and cache, convert.cache_to_numpy) per call."""
    from repro_torch.configs import InputShape
    from repro_torch.models import api, convert
    cpu = api.init_model(cfg, 0, device="cpu")
    card = convert.params_from_reference(cfg, convert.cache_to_numpy(cpu))
    batch = api.concrete_batch(cfg, InputShape("t", 40, 2, "prefill"), seed=2)
    cl = api.decode_cache_len(cfg, InputShape("d", 48, 2, "decode"))
    runs = {}
    for where, params in (("cpu", cpu), ("cuda", card)):
        logits, cache = api.make_prefill_fn(cfg, cache_len=cl)(params, batch)
        assert logits.device.type == where
        # decode writes the attention caches in place: snapshot each step
        out = [convert.cache_to_numpy({"logits": logits, "cache": cache})]
        if cfg.decoder:
            decode = api.make_decode_fn(cfg)
            for t in (5, 9):
                tok = torch.full((2,), t, dtype=torch.int32,
                                 device=logits.device)
                logits, cache = decode(params, cache, tok)
                out.append(convert.cache_to_numpy({"logits": logits,
                                                   "cache": cache}))
        runs[where] = out
    return runs


@pytest.mark.parametrize("name", LM_NAMES)
def test_cuda_lm_prefill_decode_match_cpu(no_tf32, name):
    """Prefill and two decode steps of every config at reduced_config, in
    fp32 with TF32 off: logits and every cache leaf on the card against the
    same weights on the CPU, max|Δ| <= 1e-4·max(1, max|ref|)."""
    from repro_torch.configs import ARCHS, reduced_config
    runs = _lm_card_and_cpu_runs(reduced_config(ARCHS[name]))
    for i, (c, g) in enumerate(zip(runs["cpu"], runs["cuda"])):
        _lm_close(g, c, f"step {i}")


@pytest.mark.parametrize("name", LM_NAMES)
def test_cuda_lm_bf16_prefill_decode_match_cpu(no_tf32, name, monkeypatch):
    """The same in bf16 (fp32 master weights; MoE at capacity_factor 16):
    the card's products with an fp32 result run on bf16 operands
    (nn_ops.matmul_f32, out_dtype=float32), the CPU's on operands widened
    to fp32.  Logits and every cache leaf within the reference's bf16
    criterion, 2e-2·max(1, max|ref|): the two stacks round to bf16 after
    sums taken in different orders.

    A router choice is discontinuous: where two experts' bf16
    probabilities (nearly) tie, the card's rounding may pick the other
    one (granite at reduced_config: a layer-1 k 0.051 off).  So an MoE
    config runs on the card with the experts the CPU chose, call by call,
    gated by the card's own probabilities; and every token whose experts
    the card itself would have chosen otherwise must be a near tie on the
    CPU: its k-th and (k+1)-th probabilities no further apart than twice
    the token's largest card-to-CPU probability difference."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import moe
    cfg = reduced_config(ARCHS[name], dtype="bfloat16")
    calls = {"cpu": [], "cuda": []}
    if cfg.num_experts:
        cfg = reduced_config(ARCHS[name], dtype="bfloat16",
                             capacity_factor=16.0)
        real = moe.route

        def route(cfg_, p, xt):
            probs, gate, eid = real(cfg_, p, xt)
            if not xt.is_cuda:
                calls["cpu"].append((probs, eid))
                return probs, gate, eid
            calls["cuda"].append((probs.cpu(), eid.cpu()))
            eid = calls["cpu"][len(calls["cuda"]) - 1][1].to(xt.device)
            gate = torch.gather(probs, 1, eid)
            gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            return probs, gate, eid
        monkeypatch.setattr(moe, "route", route)
    runs = _lm_card_and_cpu_runs(cfg)
    for i, (c, g) in enumerate(zip(runs["cpu"], runs["cuda"])):
        _lm_close(g, c, f"step {i}", rel=2e-2)
    assert len(calls["cpu"]) == len(calls["cuda"])
    k = cfg.experts_per_token
    for (pc, ec), (pg, eg) in zip(calls["cpu"], calls["cuda"]):
        assert float((pc - pg).abs().max()) <= 2e-2
        other = (ec.sort(-1).values != eg.sort(-1).values).any(-1)
        top = pc.sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        near = (pc - pg).abs().max(-1).values
        assert bool((gap[other] <= 2 * near[other]).all())


@pytest.mark.parametrize("shape_a,shape_b", [
    ((96, 64), (64, 130)), ((16, 7 * 64, 64), (16, 64, 1024)),
    ((16, 7 * 64, 1024), (16, 1024, 64)), ((16, 7, 64), (16, 64, 2176))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_matmul_f32_matches_widened_operands(no_tf32, shape_a, shape_b,
                                                   dtype):
    """nn_ops.matmul_f32 on the card (half operands, out_dtype=float32)
    against the product of the operands widened to fp32 (exact for half
    types), on the card and on the CPU: an fp32 result within
    1e-5·max(1, max|ref|), the distance of two fp32 summation orders (a
    result rounded to the operands' dtype is ~4e-3 off)."""
    from repro_torch.models import nn_ops
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(shape_a, generator=gen).to(dtype)
    b = torch.randn(shape_b, generator=gen).to(dtype)
    got = nn_ops.matmul_f32(a.cuda(), b.cuda())
    assert got.dtype == torch.float32 and got.is_cuda
    for want in (torch.matmul(a.cuda().float(), b.cuda().float()).cpu(),
                 nn_ops.matmul_f32(a, b)):
        assert want.dtype == torch.float32
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), err


def test_cuda_lm_weights_default_to_the_card(dev):
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import api, convert
    from repro_torch.models.param import tree_leaves
    cfg = reduced_config(ARCHS["qwen2-0.5b"])
    params = api.init_model(cfg)
    assert all(t.is_cuda for _, t in tree_leaves(params))
    tree = convert.cache_to_numpy(params)
    carried = convert.params_from_reference(cfg, tree)
    for path, t in tree_leaves(carried):
        assert t.is_cuda and np.array_equal(t.cpu().numpy(),
                                            dict(tree_leaves(tree))[path])


# ---------------------------------------------------------------------- #
# LM scaffold training (repro_torch.models, optim) on the card
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape_a,shape_b", [
    ((96, 64), (64, 130)), ((16, 7 * 64, 64), (16, 64, 1024)),
    ((16, 7 * 64, 1024), (16, 1024, 64)), ((2 * 16, 128), (128, 3000))])
def test_cuda_matmul_f32_backward_matches_widened_autograd(no_tf32, shape_a,
                                                           shape_b):
    """nn_ops.matmul_f32's backward on the card (bf16 operands, an fp32
    cotangent) at the products of flash_attention (QK over a KV chunk of
    1,024, PV) and of the loss head (x @ un.t()), against autograd of the
    product of the operands widened to fp32: bf16 gradients within one
    bf16 ulp of max|ref| (2^-8·max|ref|: the two fp32 sums may round
    apart), and equal to the CPU's gradients of the same widened product
    within the same bound."""
    from repro_torch.models import nn_ops
    gen = torch.Generator().manual_seed(6)
    a = torch.randn(shape_a, generator=gen).to(torch.bfloat16)
    b = torch.randn(shape_b, generator=gen).to(torch.bfloat16)
    gy = torch.randn(torch.matmul(a.float(), b.float()).shape,
                     generator=gen)
    ac, bc = a.cuda().requires_grad_(), b.cuda().requires_grad_()
    y = nn_ops.matmul_f32(ac, bc)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    got = torch.autograd.grad(y, (ac, bc), gy.cuda())
    want_card = torch.autograd.grad(torch.matmul(ac.float(), bc.float()),
                                    (ac, bc), gy.cuda())
    acpu, bcpu = a.clone().requires_grad_(), b.clone().requires_grad_()
    want_cpu = torch.autograd.grad(nn_ops.matmul_f32(acpu, bcpu),
                                   (acpu, bcpu), gy)
    for g, wc, wh in zip(got, want_card, want_cpu):
        assert g.dtype == torch.bfloat16 and g.is_cuda
        for w in (wc.cpu(), wh):
            scale = float(w.float().abs().max())
            err = float((g.cpu().float() - w.float()).abs().max())
            assert err <= 2.0 ** -8 * scale, (err, scale)


def _train_step_card_and_cpu(cfg, grad_dtype):
    """One make_train_step (microbatch 2, at step 2 of a warm-up of 2) and
    the loss's gradients as the step takes them (with grad_dtype
    "bfloat16" wrt the copies in the activation dtype, else through the
    cast of the masters), on the card and on the CPU with the same
    weights: {"cpu": (metrics, grads), "cuda": (metrics, grads)}."""
    from repro_torch.configs import InputShape
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import api, convert
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_from_leaves, tree_leaves
    cpu = api.init_model(cfg, 0, device="cpu")
    card = convert.params_from_reference(cfg, convert.cache_to_numpy(cpu))
    batch = api.concrete_batch(cfg, InputShape("t", 64, 2, "train"), seed=1)
    tcfg = TrainConfig(microbatch=2, total_steps=10, warmup=2,
                       grad_dtype=grad_dtype)
    out = {}
    for where, params in (("cpu", cpu), ("cuda", card)):
        if grad_dtype == "bfloat16":
            wrt = {p: x.detach().to(tf.cfg_dtype(cfg)).requires_grad_()
                   for p, x in tree_leaves(params)}
            loss, _ = tf.loss_fn(cfg, tree_from_leaves(wrt), batch)
        else:
            wrt = {p: x.detach().requires_grad_()
                   for p, x in tree_leaves(params)}
            loss, _ = api.make_loss_fn(cfg)(tree_from_leaves(wrt), batch)
        grads = dict(zip(wrt, torch.autograd.grad(loss, list(wrt.values()))))
        _, _, metrics = api.make_train_step(cfg, tcfg)(
            params, adamw_init(params), batch, 2)
        assert metrics["loss"].device == params["final_norm"].device
        out[where] = ({k: float(v) for k, v in metrics.items()},
                      {p: g.cpu() for p, g in grads.items()})
    return out


@pytest.mark.parametrize("name", LM_NAMES)
def test_cuda_lm_train_step_matches_cpu(no_tf32, name):
    """An fp32 train step of every config at reduced_config (TF32 off), on
    the card against the CPU with the same weights: loss and metrics
    within 1e-5 relative, grad_norm within 1e-4, lr equal, and every
    gradient of the loss within 1e-4·max|cpu leaf|."""
    from repro_torch.configs import ARCHS, reduced_config
    runs = _train_step_card_and_cpu(reduced_config(ARCHS[name]), "float32")
    (mc, gc), (mg, gg) = runs["cpu"], runs["cuda"]
    assert set(mc) == set(mg) and mg["lr"] == mc["lr"]
    for k, v in mc.items():
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert abs(mg[k] - v) <= rel * max(abs(v), 1.0), (k, mg[k], v)
    for path, w in gc.items():
        err = float((gg[path] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (path, err)


@pytest.mark.parametrize("grad_dtype", ["bfloat16", "float32"])
def test_cuda_lm_bf16_train_step_is_finite(dev, grad_dtype):
    """qwen2 at reduced_config in bf16 over fp32 masters on the card: the
    loss, grad_norm and every gradient finite, gradients in bf16 under
    grad_dtype "bfloat16" (matmul_f32's backward on the card), and the
    loss and grad_norm within 2e-2 and 5e-2 of the CPU's (bf16 rounding
    in different orders)."""
    from repro_torch.configs import ARCHS, reduced_config
    cfg = reduced_config(ARCHS["qwen2-0.5b"], dtype="bfloat16")
    runs = _train_step_card_and_cpu(cfg, grad_dtype)
    (mc, _), (mg, gg) = runs["cpu"], runs["cuda"]
    for k in ("loss", "grad_norm"):
        assert np.isfinite(mg[k])
    assert abs(mg["loss"] - mc["loss"]) <= 2e-2 * abs(mc["loss"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 5e-2 * mc["grad_norm"]
    want = torch.bfloat16 if grad_dtype == "bfloat16" else torch.float32
    for path, g in gg.items():
        assert g.dtype == want and bool(torch.isfinite(g).all()), path


def test_cuda_checkpoint_restore_defaults_to_the_card(dev, tmp_path):
    """Checkpointer.restore without device= puts every leaf on the card,
    bit for bit as saved (fp32, bf16 and int32 leaves), so a resume that
    leaves device= out trains there."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device=dev).manual_seed(0)
    t = {"params": {"w": torch.randn(5, 6, generator=gen, device=dev),
                    "h": torch.randn(7, generator=gen, device=dev).to(
                        torch.bfloat16)},
         "opt": {"step": torch.tensor(3, dtype=torch.int32, device=dev)}}
    ck = Checkpointer(tmp_path)
    ck.save(2, t)
    ck.wait()
    out, _ = ck.restore(template=t)
    want = dict(tree_leaves(t))
    for path, x in tree_leaves(out):
        w = want[path]
        assert x.device.type == "cuda" and x.dtype == w.dtype, path
        views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        if x.dtype in views:
            x, w = x.view(views[x.dtype]), w.view(views[w.dtype])
        assert torch.equal(x, w), path
