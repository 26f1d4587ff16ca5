// Merge probe of the sort-merge join, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_probe.py::merge_probe_pallas (TPU).
// For ascending int32 keys a[0..na) and b[0..nb):
//     start[i] = #{j : b[j] <  a[i]}     (lower bound of a[i] in b)
//     cnt[i]   = #{j : b[j] == a[i]}     (upper bound - lower bound)
//
// Design: one thread per a-key, two binary searches in b.  The TPU kernel
// walked b in 128-wide blocks and carried the counts across its sequential
// grid; Hopper's blocks run in parallel, so each thread searches on its
// own instead.  Because a is sorted, the threads of a warp search for
// neighbouring keys and share the top levels of their search paths, which
// then hit L1/L2.  The ragged edge is masked (i < na), so, unlike the TPU
// kernel, there is no INT32_MAX padding and no count correction: an
// A_INVALID (2^31-1) a-row finds no equal b-key because b's invalid rows
// carry B_INVALID (2^31-2).
//
// Bound on the H100: memory.  The function must read a and b once and
// write start and cnt once, 4 * (3 * na + nb) bytes; the searches add
// log2(nb) dependent loads per key, most of them served from L2.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int lower_bound(const int* __restrict__ b,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* __restrict__ b,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_probe_kernel(const int* __restrict__ a, int na,
                                   const int* __restrict__ b, int nb,
                                   int* __restrict__ start,
                                   int* __restrict__ cnt) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= na) return;
  int key = a[i];
  int s = lower_bound(b, 0, nb, key);
  int e = upper_bound(b, s, nb, key);
  start[i] = s;
  cnt[i] = e - s;
}

}  // namespace

extern "C" int merge_probe(const int* a, int na, const int* b, int nb,
                           int* start, int* cnt, void* stream) {
  if (na > 0) {
    const int threads = 256;
    const int blocks = (na + threads - 1) / threads;
    merge_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        a, na, b, nb, start, cnt);
  }
  return (int)cudaGetLastError();
}
