"""Bytes of one sort-merge probe (``merge_probe_cuda``): sorted keys
a [na] and b [nb] read once, each a-key's start and count [na] written
once, int32.  One compare for each merged key."""

MODULE = "repro_torch.kernels.ops"
ATTR = "merge_probe_cuda"
KERNELS = ("merge_probe_kernel", "merge_probe_bisect_kernel")


def cost(a_keys, b_keys, *args, **kwargs):
    na, nb = int(a_keys.shape[0]), int(b_keys.shape[0])
    return 4 * (na + nb + 2 * na), na + nb
