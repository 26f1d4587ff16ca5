// Shared pieces of the merge-path kernels (merge_probe.cu and the
// expand_gather entry of expand_segments.cu), for Hopper (sm_90a).
//
// Merge path: the merge of two sorted sequences is cut into equal runs of
// the merged order.  A block owns NT * VT merged items; it finds where its
// diagonals cut the two inputs by a search inside the same launch (no
// partition kernel), loads its slice of each input into shared memory with
// 16-byte loads, and each thread then merges VT items serially against
// shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mp {

constexpr int NT = 128;             // threads a block; the kernels
                                    // merge an odd number of items a
                                    // thread (fewer bank conflicts)
constexpr unsigned FULL = 0xffffffffu;

// Smallest q in [lo, hi) with pred(q) true, or hi when there is none, for
// a predicate that is false and then true over [lo, hi).  Every lane of
// the warp calls it with the same lo and hi; each round tests 32 points at
// once, so a range of 2^20 costs 4 rounds of dependent loads, not 20.
template <class Pred>
__device__ __forceinline__ long long warp_first_true(long long lo,
                                                     long long hi,
                                                     Pred pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) / 32;
    long long q = lo + (lane + 1) * step - 1;
    if (q > hi - 1) q = hi - 1;
    const unsigned m = __ballot_sync(FULL, pred(q));
    if (m == 0) return hi;          // lane 31 tested hi - 1
    const int f = __ffs(m) - 1;
    // lane f - 1 (if any) was false and is not clamped, lane f is true
    const long long nhi = lo + (f + 1) * step - 1;
    lo = lo + f * step;
    hi = nhi < hi - 1 ? nhi : hi - 1;
  }
  const long long q = lo + lane;
  const unsigned m = __ballot_sync(FULL, q < hi && pred(q));
  return m ? lo + __ffs(m) - 1 : hi;
}

// The same search started from a guess of the answer: one round tests
// guess - 2^15 .. guess - 1 and guess .. guess + 2^15 - 1 at doubling
// distances, and the search goes on inside the bracket where pred turns
// true.  A guess within 32 of the answer costs 2 rounds of loads, and
// they fall on few cache lines; a guess off by more than 2^15 costs one
// round more than warp_first_true.
template <class Pred>
__device__ __forceinline__ long long warp_first_true_near(long long guess,
                                                          long long lo,
                                                          long long hi,
                                                          Pred pred) {
  if (hi - lo <= 32) return warp_first_true(lo, hi, pred);
  const int lane = threadIdx.x & 31;
  long long q = lane < 16 ? guess - (1LL << (15 - lane))
                          : guess + (1LL << (lane - 16)) - 1;
  q = q < lo ? lo : (q > hi - 1 ? hi - 1 : q);
  const unsigned m = __ballot_sync(FULL, pred(q));
  // first true lane f: the answer is in (q_{f-1}, q_f]; none: (q_31, hi]
  const int f = m ? __ffs(m) - 1 : 32;
  const long long q_prev = __shfl_sync(FULL, q, f == 0 ? 0 : f - 1);
  const long long q_f = __shfl_sync(FULL, q, f == 32 ? 31 : f);
  if (f == 32) return warp_first_true(q_f + 1, hi, pred);
  return warp_first_true(f == 0 ? lo : q_prev + 1, q_f, pred);
}

// The int offset of g within its 16-byte word: shared buffers that stage
// g[lo..] keep this offset, so that 16-byte words line up on both sides.
__device__ __forceinline__ int align_off(const int* g) {
  return (int)(((uintptr_t)g >> 2) & 3);
}

// s[align_off(g + lo) + k] = g[lo + k] for k in [0, n), by the whole block:
// 16-byte loads over the aligned middle, scalar loads at the two edges.
// s is 16-byte aligned and holds n + 3 ints.  Returns the offset.
__device__ __forceinline__ int load_tile(int* s, const int* __restrict__ g,
                                         long long lo, int n) {
  const int* src = g + lo;
  const int off = align_off(src);
  const int head = off ? min(4 - off, n) : 0;
  const int nvec = (n - head) >> 2;
  for (int k = threadIdx.x; k < head; k += blockDim.x)
    s[off + k] = __ldg(src + k);
  const int4* vsrc = reinterpret_cast<const int4*>(src + head);
  int4* vdst = reinterpret_cast<int4*>(s + off + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    vdst[v] = __ldg(vsrc + v);
  for (int k = head + 4 * nvec + threadIdx.x; k < n; k += blockDim.x)
    s[off + k] = __ldg(src + k);
  return off;
}

// g[lo + k] = s[off + k] for k in [0, n), by the whole block, where
// off == align_off(g + lo): 16-byte stores over the aligned middle.
__device__ __forceinline__ void store_tile(int* __restrict__ g, long long lo,
                                           const int* s, int off, int n) {
  int* dst = g + lo;
  const int head = off ? min(4 - off, n) : 0;
  const int nvec = (n - head) >> 2;
  for (int k = threadIdx.x; k < head; k += blockDim.x) dst[k] = s[off + k];
  int4* vdst = reinterpret_cast<int4*>(dst + head);
  const int4* vsrc = reinterpret_cast<const int4*>(s + off + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) vdst[v] = vsrc[v];
  for (int k = head + 4 * nvec + threadIdx.x; k < n; k += blockDim.x)
    dst[k] = s[off + k];
}

// g[row * w + col] = val(row - r0, col) for the rows r0 .. r0 + nrows - 1
// of a row-major [*, w] int32 array, by the whole block: the stretch is
// written four neighbouring values a thread, as 16-byte stores over its
// aligned middle, with one division a store.
template <class Val>
__device__ __forceinline__ void store_rows(int* __restrict__ g, long long r0,
                                           int nrows, int w, Val val) {
  int* dst = g + r0 * w;
  const int n = nrows * w;
  const int off = align_off(dst);
  const int head = off ? min(4 - off, n) : 0;
  const int nvec = (n - head) >> 2;
  for (int k = threadIdx.x; k < head; k += blockDim.x)
    dst[k] = val(k / w, k % w);
  int4* vdst = reinterpret_cast<int4*>(dst + head);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int k = head + 4 * v;
    int row = k / w, col = k - row * w;
    int x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = val(row, col);
      if (++col == w) {
        col = 0;
        ++row;
      }
    }
    vdst[v] = make_int4(x[0], x[1], x[2], x[3]);
  }
  for (int k = head + 4 * nvec + threadIdx.x; k < n; k += blockDim.x)
    dst[k] = val(k / w, k % w);
}

}  // namespace mp
