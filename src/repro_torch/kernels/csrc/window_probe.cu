// Bucket-window probe of the radix hash join, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/radix_join.py::window_probe_pallas (TPU).
// For probe keys a[0..n) and the [n, lmax] int32 window matrix win (row i
// holds the key-sorted bucket of a[i], B_INVALID past the bucket end):
//     lt[i]  = #{k : win[i, k] <  a[i]}   (offset of the match run)
//     cnt[i] = #{k : win[i, k] == a[i]}   (length of the match run)
//
// Design: a group of G lanes per probe row, G the power of two >= lmax
// capped at 32 (G = 16 at the main path's lmax = 16, two rows per warp).
// Lane l compares win[i, l], win[i, l + G], ... with a[i], so neighbouring
// lanes read neighbouring words and each row is one coalesced read; the
// group then sums its counts with xor shuffles.  Every lane of a warp
// reaches the shuffles (rows past n count nothing), so the full mask is
// valid.  The TPU kernel reduced an (8, lmax) block on the VPU; the
// reduction over the row is the same, the blocking is not.
//
// Bound on the H100: memory.  The function reads a and the window once
// and writes lt and cnt once, 4 * (n * lmax + 3 * n) bytes; the compares
// are one integer operation per loaded word.
#include <cuda_runtime.h>

namespace {

__global__ void window_probe_kernel(const int* __restrict__ a,
                                    const int* __restrict__ win, int n,
                                    int lmax, int group,
                                    int* __restrict__ lt,
                                    int* __restrict__ cnt) {
  long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = gtid / group;
  int lane = (int)(gtid % group);
  int l = 0, c = 0;
  if (row < n) {
    int key = a[row];
    const int* w = win + row * (long long)lmax;
    for (int k = lane; k < lmax; k += group) {
      int v = __ldg(w + k);
      l += v < key;
      c += v == key;
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (row < n && lane == 0) {
    lt[row] = l;
    cnt[row] = c;
  }
}

}  // namespace

extern "C" int window_probe(const int* a, const int* win, int n, int lmax,
                            int group, int* lt, int* cnt, void* stream) {
  if (n > 0) {
    const int threads = 256;           // a multiple of 32: whole warps
    long long total = (long long)n * group;
    long long blocks = (total + threads - 1) / threads;
    window_probe_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(a, win, n, lmax, group,
                                                  lt, cnt);
  }
  return (int)cudaGetLastError();
}
