// Segment index of every output slot of the fused join expand, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_join.py::expand_segments_pallas (TPU).
// For a nondecreasing int32 csum[0..n) (the running match counts of the
// sorted a-rows) and every output slot t in [0, cap):
//     seg[t] = #{i : csum[i] <= t}       (upper bound of t in csum)
// i.e. the sorted a-row whose match range holds slot t.
//
// Design: one thread per output slot, one upper-bound binary search.  The
// TPU kernel accumulated block counts over a sequential grid dimension;
// here every slot is independent.  Neighbouring threads search for
// neighbouring t and walk the same path through csum, so the search is
// served from L1/L2.  The row gather of the expand stays in PyTorch.
//
// Bound on the H100: memory.  The function reads csum once and writes seg
// once, 4 * (n + cap) bytes.
#include <cuda_runtime.h>

namespace {

__global__ void expand_segments_kernel(const int* __restrict__ csum, int n,
                                       int cap, int* __restrict__ seg) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= cap) return;
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(csum + mid) <= t) lo = mid + 1; else hi = mid;
  }
  seg[t] = lo;
}

}  // namespace

extern "C" int expand_segments(const int* csum, int n, int cap, int* seg,
                               void* stream) {
  if (cap > 0) {
    const int threads = 256;
    const int blocks = (cap + threads - 1) / threads;
    expand_segments_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        csum, n, cap, seg);
  }
  return (int)cudaGetLastError();
}
