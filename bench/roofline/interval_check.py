"""Bytes of one node's neighborhood check (``interval_check_cuda``) over
candidates lo..hi-1: in each segment, every candidate's stored ids read
once (its whole row of ``cap`` where the segment has no lengths), its
length (4 bytes) and overflow bit (1 byte); one verdict byte a candidate
written.  Two compares per stored id and interval.  The stored lengths are
summed once the window has closed, so the sums add no device work to it."""

MODULE = "repro_torch.kernels.ops"
ATTR = "interval_check_cuda"
KERNELS = ("interval_check_kernel",)


def cost(segments, lo, hi, *args, **kwargs):
    n = int(hi) - int(lo)
    segs = [(s.ids, s.lens, len(s.lo)) for s in segments]

    def later():
        nbytes, ops = n, 0
        for ids, lens, j in segs:
            stored = n * int(ids.shape[1]) if lens is None \
                else int(lens[lo:hi].sum())
            nbytes += 4 * stored + 5 * n
            ops += 2 * j * stored
        return nbytes, ops

    return later
