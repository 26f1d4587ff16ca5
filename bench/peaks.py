"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM3 bandwidth, and the float32 rate outside the tensor
cores, which the benchmark takes as the rate of the kernels' integer
compares.  A card set below 700 W reaches less; the harness reports the
share against these numbers and PERF.md gives the card's limit beside it."""

PEAKS = {
    "bytes_per_s": 3.35e12,
    "ops_per_s": 67e12,
}
