"""The kernels' byte and operation counts, and the trace's arithmetic."""
from pathlib import Path

import pytest
import torch

from bench.trace import load_roofline, union_seconds

ROOF = Path(__file__).resolve().parent.parent / "roofline"


def counts(name, *args):
    c = load_roofline(ROOF / f"{name}.py").cost(*args)
    return c() if callable(c) else c


@pytest.mark.parametrize("na,nb", [(1, 1), (5, 3), (4096, 77)])
def test_merge_probe_counts_shapes_only(na, nb):
    g = torch.Generator().manual_seed(na)
    a = torch.randint(0, 9, (na,), generator=g, dtype=torch.int32)
    b = torch.randint(0, 9, (nb,), generator=g, dtype=torch.int32)
    # keys read once, start and count written once, int32; one compare
    # a merged key
    assert counts("merge_probe", a, b) == (4 * (na + nb) + 8 * na, na + nb)
    assert counts("merge_probe", a.sort().values, b * 7) == \
        counts("merge_probe", a, b)


def test_merge_probe_hand_count():
    a, b = torch.arange(3, dtype=torch.int32), torch.arange(5,
                                                             dtype=torch.int32)
    assert counts("merge_probe", a, b) == (4 * 3 + 4 * 5 + 2 * 4 * 3, 8)


@pytest.mark.parametrize("n,ka,nb,kb,cap,sel", [(2, 1, 3, 2, 4, (1,)),
                                                (100, 3, 50, 4, 256, (0, 2)),
                                                (7, 5, 9, 1, 8, ())])
def test_expand_gather_counts_shapes_only(n, ka, nb, kb, cap, sel):
    a = torch.zeros((n, ka), dtype=torch.int32)
    b = torch.ones((nb, kb), dtype=torch.int32)
    start = torch.zeros(n, dtype=torch.int32)
    csum = torch.arange(n, dtype=torch.int32)
    want = (4 * (2 * n + cap * (ka + len(sel))), 0)
    assert counts("expand_gather", a, b, start, csum, 10, cap, sel) == want
    assert counts("expand_gather", a + 5, b * 3, start + 1, csum * 2, 3,
                  cap, sel) == want


def test_expand_gather_hand_count():
    # 2 a-rows of 3 columns, output 4 slots of 3 + 1 columns: csum and
    # start 2 x 4 bytes each, output 16 x 4 bytes
    a = torch.zeros((2, 3), dtype=torch.int32)
    b = torch.zeros((5, 2), dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    assert counts("expand_gather", a, b, z, z, 4, 4, [1]) == \
        (16 + 64, 0)


def segment(ids, lens, j, first=True):
    from repro_torch.kernels.ref import CheckSegment
    n = ids.shape[0]
    return CheckSegment(ids=ids, lens=lens,
                        overflow=torch.zeros(n, dtype=torch.bool),
                        lo=[0] * j, hi=[1] * j, need=[1] * j, first=first)


def test_interval_check_counts_stored_ids():
    ids = torch.full((6, 4), -1, dtype=torch.int32)
    lens = torch.tensor([0, 1, 2, 3, 4, 1], dtype=torch.int32)
    segs = [segment(ids, lens, 2), segment(ids, None, 3, first=False)]
    # candidates 1..4: 1 + 2 + 3 + 4 = 10 stored ids in the first segment,
    # 4 whole rows of 4 in the second; 5 bytes a candidate a segment for
    # the length and the overflow bit; 1 verdict byte a candidate
    nbytes = 4 + (4 * 10 + 20) + (4 * 16 + 20)
    assert counts("interval_check", segs, 1, 5) == \
        (nbytes, 2 * 2 * 10 + 2 * 3 * 16)
    # the stored ids, not their values, count
    segs2 = [segment(ids * 0 + 7, lens, 2), segment(ids + 3, None, 3,
                                                    first=False)]
    assert counts("interval_check", segs2, 1, 5) == \
        counts("interval_check", segs, 1, 5)


def test_union_of_device_spans_and_its_gaps():
    busy, gaps = union_seconds([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0),
                                (3.5, 3.6), (6.0, 6.5)])
    assert busy == pytest.approx(3.5)
    assert gaps == [(pytest.approx(1.0), 1, 2), (pytest.approx(2.0), 2, 4)]
    assert union_seconds([]) == (0.0, [])
