"""Bytes of one join expand (``expand_gather_cuda``): the running counts
csum [n] and the starts [n] read once, the [cap, ka + nsel] int32 output
written once.  The a-rows and b-rows that the slots copy are left out:
which of them a call reads depends on the counts, not on the shapes, so
the count is the least the call needs and the share a lower bound."""

MODULE = "repro_torch.kernels.fused_join"
ATTR = "expand_gather_cuda"
KERNELS = ("expand_gather_kernel",)


def cost(a_rows, b_rows, start, csum, limit, cap, new_sel, *args, **kwargs):
    n, ka = int(a_rows.shape[0]), int(a_rows.shape[1])
    return 4 * (2 * n + int(cap) * (ka + len(new_sel))), 0
