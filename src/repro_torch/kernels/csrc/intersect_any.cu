// Batched id-list intersection test of the connectivity check (paper
// Alg. 3), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sorted_intersect.py::intersect_any_pallas
// (TPU).  For pairs p < np, a [np, na] and b [np, nb] (int32, -1 padded,
// rows in any order):
//     out[p] = 1 iff some a[p][i] >= 0 equals some b[p][j]
//
// Design: one warp per pair.  The TPU kernel compared every b entry with
// the whole a block (an O(A*B) compare cube on the vector unit).  Here the
// warp stages the a-row in shared memory a tile of TILE_A entries at a
// time, keeping only its valid entries (a ballot compacts them: the reach
// rows hold about 3 valid ids in 25), so an all-padding a-row never reads
// its b-row at all.  The lanes then stride over the b-row, 16 bytes a lane
// when nb % 4 == 0 and the base is aligned (4 bytes a lane otherwise),
// skip b < 0 so padding never hits, and compare each entry with the
// staged ids.  After each stride the warp votes (__any_sync) and leaves on
// the first hit.  Rows need no order: nothing is searched.
//
// Bound on the H100: memory at the path's shape (na = 25, nb = 4096): the
// function reads both rows once and writes one int per pair,
// 4 * np * (na + nb) + 4 * np bytes, against np * na * nb compares.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;        // pairs per block
constexpr int TILE_A = 64;      // a entries staged per pass over b
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool in_tile(const int* t, int n, int v) {
  bool h = false;
  for (int i = 0; i < n; ++i) h |= t[i] == v;   // broadcast reads
  return v >= 0 && h;
}

template <bool VEC>
__global__ void intersect_any_kernel(const int* __restrict__ a, int na,
                                     const int* __restrict__ b, int nb,
                                     int np, int* __restrict__ out) {
  __shared__ int tiles[WARPS][TILE_A];
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (pair >= np) return;              // uniform across the warp
  const int* arow = a + pair * na;
  const int* brow = b + pair * nb;
  int* t = tiles[threadIdx.x >> 5];
  const unsigned below = (1u << lane) - 1;
  bool hit = false;
  for (int base = 0; base < na && !hit; base += TILE_A) {
    const int end = min(base + TILE_A, na);
    int n = 0;
    for (int k = base; k < end; k += 32) {
      int v = k + lane < end ? __ldg(arow + k + lane) : -1;
      unsigned m = __ballot_sync(FULL, v >= 0);
      if (v >= 0) t[n + __popc(m & below)] = v;
      n += __popc(m);
    }
    __syncwarp();
    if (n > 0) {
      if (VEC) {
        const int4* b4 = reinterpret_cast<const int4*>(brow);
        for (int j = 0; j < nb / 4; j += 32) {
          bool h = false;
          if (j + lane < nb / 4) {
            int4 v = __ldg(b4 + j + lane);
            h = in_tile(t, n, v.x) | in_tile(t, n, v.y) |
                in_tile(t, n, v.z) | in_tile(t, n, v.w);
          }
          if (__any_sync(FULL, h)) { hit = true; break; }
        }
      } else {
        for (int j = 0; j < nb; j += 32) {
          bool h = j + lane < nb && in_tile(t, n, __ldg(brow + j + lane));
          if (__any_sync(FULL, h)) { hit = true; break; }
        }
      }
    }
    __syncwarp();                      // the next tile overwrites t
  }
  if (lane == 0) out[pair] = hit ? 1 : 0;
}

}  // namespace

extern "C" int intersect_any(const int* a, int na, const int* b, int nb,
                             int np, int* out, void* stream) {
  if (np > 0) {
    const int blocks = (np + WARPS - 1) / WARPS;
    const bool vec = nb % 4 == 0 && ((uintptr_t)b & 15) == 0;
    if (vec)
      intersect_any_kernel<true><<<blocks, WARPS * 32, 0,
                                   (cudaStream_t)stream>>>(a, na, b, nb, np,
                                                           out);
    else
      intersect_any_kernel<false><<<blocks, WARPS * 32, 0,
                                    (cudaStream_t)stream>>>(a, na, b, nb, np,
                                                            out);
  }
  return (int)cudaGetLastError();
}
