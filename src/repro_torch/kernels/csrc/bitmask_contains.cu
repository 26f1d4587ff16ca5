// Bloom signature containment of the gStore-style prefilter, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/bitmask_contains.py::bitmask_contains_pallas
// (TPU).  For candidate signatures cand [c, w] (row r at cand + r * stride,
// 32-bit words) and the query signature query [w]:
//     out[r] = 1 iff (query[k] & ~cand[r][k]) == 0 for every word k
// i.e. the query's bits are a subset of the candidate's.  The words are
// bit patterns: the reference's uint32 arrive as int32 with the same bits.
//
// Design: one thread per candidate row.  The TPU kernel padded W up to 128
// lanes and tested a [256, 128] tile at once; here a row is W = 8 words
// (32 bytes) on the engine's path, so a thread reads its row with 16-byte
// vector loads when W % 4 == 0 and the row base and stride keep 16-byte
// alignment (the launcher checks), and with a scalar loop otherwise (W = 3,
// or a slice sigs[lo:hi] that starts on an odd row of a 3-word table).  The
// query words are read once per thread, through the read-only cache, where
// the whole warp hits the same address.  The row loop leaves at the first
// word with a missing bit.
//
// Bound on the H100: memory.  The function reads each signature once and
// writes one int per row, 4 * c * w + 4 * c bytes, with one AND-NOT and one
// compare per word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool VEC>
__global__ void bitmask_contains_kernel(const unsigned* __restrict__ cand,
                                        int c, int w, long long stride,
                                        const unsigned* __restrict__ query,
                                        int* __restrict__ out) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= c) return;
  const unsigned* row = cand + r * stride;
  int ok = 1;
  if (VEC) {
    const uint4* row4 = reinterpret_cast<const uint4*>(row);
    for (int k = 0; k < w / 4; ++k) {
      uint4 v = __ldg(row4 + k);
      unsigned miss = (__ldg(query + 4 * k) & ~v.x) |
                      (__ldg(query + 4 * k + 1) & ~v.y) |
                      (__ldg(query + 4 * k + 2) & ~v.z) |
                      (__ldg(query + 4 * k + 3) & ~v.w);
      if (miss) { ok = 0; break; }
    }
  } else {
    for (int k = 0; k < w; ++k) {
      if (__ldg(query + k) & ~__ldg(row + k)) { ok = 0; break; }
    }
  }
  out[r] = ok;
}

}  // namespace

// stride: elements between consecutive rows (>= w).
extern "C" int bitmask_contains(const unsigned* cand, int c, int w,
                                long long stride, const unsigned* query,
                                int* out, void* stream) {
  if (c > 0) {
    const int threads = 256;
    const int blocks = (c + threads - 1) / threads;
    const bool vec = w % 4 == 0 && stride % 4 == 0 &&
                     ((uintptr_t)cand & 15) == 0;
    if (vec)
      bitmask_contains_kernel<true><<<blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
          cand, c, w, stride, query, out);
    else
      bitmask_contains_kernel<false><<<blocks, threads, 0,
                                       (cudaStream_t)stream>>>(
          cand, c, w, stride, query, out);
  }
  return (int)cudaGetLastError();
}
