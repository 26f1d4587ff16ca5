"""Inputs of the row-selection tests, as NumPy arrays from a seed: the grid
that tests/test_torch_kernels.py runs through the plain versions on the
CPU and tests/test_torch_cuda.py through the kernel on the card.  Imports
nothing of JAX."""
import numpy as np

N_NODES = 300
EDGE_PREDS = (-1, 0, 3)
EDGE_SPECS = ("interval", "mask", "mask_interval")
TABLE_FILLS = ("mixed", "all_kept", "none_kept")


def edges(seed: int, e: int = 5000, n_nodes: int = N_NODES,
          n_preds: int = 4):
    """(src, dst, pred, mask_s, mask_d): random edges, 5 % of them
    self-loops, and two endpoint masks over the nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    loop = rng.random(e) < 0.05
    dst[loop] = src[loop]
    pred = rng.integers(0, n_preds, e).astype(np.int32)
    return src, dst, pred, rng.random(n_nodes) < 0.5, \
        rng.random(n_nodes) < 0.7


def specs(kind: str, mask_s, mask_d, n_nodes: int = N_NODES):
    """The two endpoint specs: masks, (lo, hi) intervals, or one each."""
    iv_s, iv_d = (20, n_nodes - 40), (0, n_nodes // 2)
    return {"interval": (iv_s, iv_d), "mask": (mask_s, mask_d),
            "mask_interval": (mask_s, iv_d)}[kind]


def query_cols(k: int) -> tuple:
    """k column labels, the last repeating the first from k = 3 (a query
    node held twice, as a join on it leaves it)."""
    cols = list(range(10, 10 + k))
    if k >= 3:
        cols[-1] = cols[0]
    return tuple(cols)


def pairs_of(cols) -> tuple:
    """The column pairs of distinct query nodes (the injective filter's)."""
    k = len(cols)
    return tuple((i, j) for i in range(k) for j in range(i + 1, k)
                 if cols[i] != cols[j])


def table(seed: int, k: int, fill: str, n: int = 300, cap: int = 512,
          vmax: int = 6) -> np.ndarray:
    """rows [cap, k] int32 of n valid rows, -1 padding after them and in
    a few rows among them, a repeated query node's columns equal.  fill:
    'mixed' (values below vmax, so some rows repeat a value across
    nodes), 'all_kept' (distinct values a row) or 'none_kept' (columns 0
    and 1 equal; no valid row at k = 1)."""
    rng = np.random.default_rng(seed * 16 + k)
    cols = query_cols(k)
    rows = np.full((cap, k), -1, np.int32)
    if fill == "all_kept":
        vals = np.stack([rng.permutation(50)[:k] for _ in range(n)])
    else:
        vals = rng.integers(0, vmax, (n, k))
    for j in range(k):
        vals[:, j] = vals[:, cols.index(cols[j])]
    if fill == "none_kept":
        if k == 1:
            n = 0
        else:
            vals[:, 1] = vals[:, 0]
    rows[:n] = vals[:n]
    if fill == "mixed":
        rows[rng.choice(n, n // 10, replace=False)] = -1
    return rows
