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

// ---------------------------------------------------------------------- //
// Entry intersect_any_ragged: the same test over ragged rows of valid ids.
//
// For pairs p < np, pair p's rows are a[a_off[p] : a_off[p+1]] and
// b[b_off[p] : b_off[p+1]] (int32 ids, no padding, any order, duplicates
// allowed):
//     out[p] = 1 iff the two rows share an id
// Offsets are clipped to the id arrays (na, nb), so malformed offsets read
// nothing out of bounds; the binding checks their shapes.
//
// Design.  On the connectivity check's path (core/connectivity.py), the
// forward rows hold 1-25 ids and the backward rows 0 to about 8,193, most
// of them under 32, with a long tail from hubs: the work per pair varies
// a thousandfold, and the padded entry's warp per pair read 16 KB of
// mostly padding for each.  A pair stages its shorter row (the test is
// symmetric) in shared memory and streams the longer, comparing each
// streamed id with every staged id (shared-memory broadcasts), in one of
// three tiers that the block picks from the offsets in the same launch:
//   group  staged <= 32 ids, streamed <= 64: 8 lanes load both rows in
//          one round (4 and 8 ids a lane, at a stride of 8: coalesced at
//          any alignment), so such a pair costs two dependent loads, its
//          offsets and then its ids; the block's 32 pairs run side by side
//   warp   staged <= 32, streamed <= 1,024: one warp, 512 ids a pass; the
//          block's 8 warps take such pairs in turn
//   block  the rest: 256 threads, 4,096 ids a pass, the staged row in
//          tiles of 1,024
// so a hub's row neither holds 8 lanes for many passes nor leaves 24 lanes
// idle beside a 3-id row, and a pair with an empty row reads nothing of
// the other.  In the warp and block tiers a lane loads 4 x 16 bytes a
// pass (the at most 6 ids before the row's first 16-byte boundary and
// after its last are scalar loads in the first pass), and the tier votes
// at the end of the pass and leaves on the first hit.  Group stages are
// padded to 33 words, so the four groups of a warp read four banks.
//
// What sets its time: latency, not bytes.  A block lasts as long as its
// slowest pair's chain of dependent loads (offsets, staged row, then one
// round a pass), and at 1,024 pairs (the chunk of the connectivity path)
// the launch is one short wave, as long as its longest row's chain.  The
// group tier's one round of loads and the tier limits were chosen on the
// path's rows; a bit filter of the staged row in place of the compares, a
// per-block queue of pairs for the groups, a larger group limit and
// narrower warp passes were each slower there.
//
// Bound on the H100: memory.  The function reads both sides' offsets, the
// shorter row of each pair whole and the longer up to its first id found
// in the shorter (nothing of a pair with an empty row), and writes one int
// per pair:
//   4 * (a ids read + b ids read up to the first hit) + 4 * 2(P+1) + 4P
// bytes over 3.35 TB/s, "a" the shorter row and "b" the longer.

namespace {

constexpr int R_THREADS = 256;
constexpr int GROUP = 8;                        // lanes of the group tier
constexpr int R_PAIRS = R_THREADS / GROUP;      // pairs a block
constexpr int R_WARPS = R_THREADS / 32;
constexpr int STAGE = 32;                       // staged ids, group and warp
constexpr int GROUP_MAX = 64;                   // streamed ids, group tier
constexpr int WARP_MAX = 1024;                  // streamed ids, warp tier
constexpr int BLOCK_STAGE = 1024;               // staged ids a tile, block
constexpr int UNROLL = 4;                       // 16-byte loads a lane a pass

struct RaggedPair {
  const int* s;     // the staged row: the shorter
  int ns;
  const int* l;     // the streamed row
  int nl;
};

__device__ __forceinline__ RaggedPair ragged_pair(
    long long p, const int* __restrict__ a, int na,
    const int* __restrict__ a_off, const int* __restrict__ b, int nb,
    const int* __restrict__ b_off) {
  const int a0 = min(max(__ldg(a_off + p), 0), na);
  const int a1 = min(max(__ldg(a_off + p + 1), a0), na);
  const int b0 = min(max(__ldg(b_off + p), 0), nb);
  const int b1 = min(max(__ldg(b_off + p + 1), b0), nb);
  if (a1 - a0 <= b1 - b0) return {a + a0, a1 - a0, b + b0, b1 - b0};
  return {b + b0, b1 - b0, a + a0, a1 - a0};
}

// The votes of the warp and block tiers: every thread of a tier calls one
// once a pass.
struct WarpVote {
  __device__ bool operator()(bool h) const { return __any_sync(FULL, h); }
};
struct BlockVote {
  __device__ bool operator()(bool h) const { return __syncthreads_or(h); }
};

__device__ __forceinline__ bool staged_has(const int* t, int n, int v) {
  bool h = false;
  for (int i = 0; i < n; ++i) h |= t[i] == v;       // broadcast reads
  return h;
}

// Does row [n >= 1 ids] hold one of the n_t staged ids t?  Thread tid of
// the nt threads of a tier; all of them take the same number of passes.
template <class Vote>
__device__ bool stride_row(const int* t, int n_t, const int* __restrict__ row,
                           int n, int tid, int nt, Vote vote) {
  const int head = min((int)(((16 - ((uintptr_t)row & 15)) & 15) >> 2), n);
  const int body = (n - head) >> 2;                 // 16-byte words
  const int tail = head + 4 * body;
  // a slot past the row holds the row's first id: a hit on it is a real one
  const int first = __ldg(row);
  int sc = first;
  if (tid < head) sc = __ldg(row + tid);
  else if (tid - head < n - tail) sc = __ldg(row + tail + tid - head);
  bool h = staged_has(t, n_t, sc);
  const int4* row4 = reinterpret_cast<const int4*>(row + head);
  const int4 pad = make_int4(first, first, first, first);
  for (int j = 0;; j += nt * UNROLL) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = j + u * nt + tid;
      v[u] = k < body ? __ldg(row4 + k) : pad;
    }
    for (int i = 0; i < n_t; ++i) {
      const int x = t[i];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        h |= (x == v[u].x) | (x == v[u].y) | (x == v[u].z) | (x == v[u].w);
    }
    if (vote(h)) return true;
    if (j + nt * UNROLL >= body) return false;
  }
}

__global__ void __launch_bounds__(R_THREADS)
intersect_any_ragged_kernel(const int* __restrict__ a, int na,
                            const int* __restrict__ a_off,
                            const int* __restrict__ b, int nb,
                            const int* __restrict__ b_off, int np,
                            int* __restrict__ out) {
  __shared__ int group_stage[R_PAIRS][STAGE + 1];
  __shared__ int warp_stage[R_WARPS][STAGE + 1];
  __shared__ int block_stage[BLOCK_STAGE];
  __shared__ int warp_rows[R_PAIRS], block_rows[R_PAIRS];
  __shared__ int n_warp_rows, n_block_rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / GROUP, gl = tid % GROUP;
  if (tid == 0) n_warp_rows = n_block_rows = 0;
  __syncthreads();
  const long long p0 = (long long)blockIdx.x * R_PAIRS;

  // group tier; longer rows are listed for the warp and block tiers
  if (p0 + g < np) {
    const RaggedPair r = ragged_pair(p0 + g, a, na, a_off, b, nb, b_off);
    if (r.ns == 0) {
      if (gl == 0) out[p0 + g] = 0;
    } else if (r.ns <= STAGE && r.nl <= GROUP_MAX) {
      // one round of loads: the staged row and the whole streamed row
      constexpr int SL = STAGE / GROUP, LL = GROUP_MAX / GROUP;
      const unsigned mask = 0xffu << (lane & ~(GROUP - 1));
      int* t = group_stage[g];
      int sv[SL], lv[LL];
#pragma unroll
      for (int u = 0; u < SL; ++u) {
        const int k = gl + u * GROUP;
        sv[u] = k < r.ns ? __ldg(r.s + k) : 0;
      }
#pragma unroll
      for (int u = 0; u < LL; ++u) {
        const int k = gl + u * GROUP;
        lv[u] = k < r.nl ? __ldg(r.l + k) : 0;
      }
#pragma unroll
      for (int u = 0; u < SL; ++u)
        if (gl + u * GROUP < r.ns) t[gl + u * GROUP] = sv[u];
      __syncwarp(mask);
      bool h = false;
#pragma unroll
      for (int u = 0; u < LL; ++u) {
        if (u * GROUP < r.nl) {                 // uniform in the group
          const bool ok = gl + u * GROUP < r.nl;
          for (int i = 0; i < r.ns; ++i) h |= ok & (t[i] == lv[u]);
        }
      }
      const bool hit = __any_sync(mask, h);
      if (gl == 0) out[p0 + g] = hit ? 1 : 0;
    } else if (gl == 0) {
      if (r.ns <= STAGE && r.nl <= WARP_MAX)
        warp_rows[atomicAdd(&n_warp_rows, 1)] = g;
      else
        block_rows[atomicAdd(&n_block_rows, 1)] = g;
    }
  }
  __syncthreads();

  // warp tier: the block's warps take the listed rows in turn
  for (int i = warp; i < n_warp_rows; i += R_WARPS) {
    const long long q = p0 + warp_rows[i];
    const RaggedPair r = ragged_pair(q, a, na, a_off, b, nb, b_off);
    int* t = warp_stage[warp];
    if (lane < r.ns) t[lane] = __ldg(r.s + lane);
    __syncwarp();
    const bool hit = stride_row(t, r.ns, r.l, r.nl, lane, 32, WarpVote{});
    if (lane == 0) out[q] = hit ? 1 : 0;
    __syncwarp();                     // the next row overwrites t
  }

  // block tier: one row at a time, the staged row in tiles
  for (int i = 0; i < n_block_rows; ++i) {
    const long long q = p0 + block_rows[i];
    const RaggedPair r = ragged_pair(q, a, na, a_off, b, nb, b_off);
    bool hit = false;
    for (int base = 0; base < r.ns && !hit; base += BLOCK_STAGE) {
      const int n = min(BLOCK_STAGE, r.ns - base);
      __syncthreads();                // the last tile's reads are done
      for (int k = tid; k < n; k += R_THREADS)
        block_stage[k] = __ldg(r.s + base + k);
      __syncthreads();
      hit = stride_row(block_stage, n, r.l, r.nl, tid, R_THREADS,
                       BlockVote{});
    }
    if (tid == 0) out[q] = hit ? 1 : 0;
  }
}

}  // namespace

extern "C" int intersect_any_ragged(const int* a, int na, const int* a_off,
                                    const int* b, int nb, const int* b_off,
                                    int np, int* out, void* stream) {
  if (np > 0)
    intersect_any_ragged_kernel<<<(np + R_PAIRS - 1) / R_PAIRS, R_THREADS, 0,
                                  (cudaStream_t)stream>>>(
        a, na, a_off, b, nb, b_off, np, out);
  return (int)cudaGetLastError();
}
