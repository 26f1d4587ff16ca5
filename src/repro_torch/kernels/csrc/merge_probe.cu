// Merge probe of the sort-merge join, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/merge_probe.py::merge_probe_pallas (TPU).
// For ascending int32 keys a[0..na) and b[0..nb):
//     start[i] = #{j : b[j] <  a[i]}     (lower bound of a[i] in b)
//     cnt[i]   = #{j : b[j] == a[i]}     (upper bound - lower bound)
//
// Design: a merge path (merge_path.cuh) over a and b.  Each block owns
// NT * VT items of the merged order (VT by input size, see launch): warp
// 0 finds where the block's first diagonal cuts a and b and warp 1 where
// its last one does, by a 32-way search in global memory started from
// the split that equal spacing of the keys would give; the block loads
// its slices of a and b into shared memory with 16-byte loads.  Each
// thread then merges VT items of the slices twice: with an a-key before
// an equal b-key, the b-keys merged before a[i] are start[i]; with a
// b-key first, they are the upper bound of a[i], and cnt[i] is the
// difference.  Both merges read one key from shared memory a step and
// branch on nothing but the side they take.  The block writes start and
// cnt back with 16-byte stores.  a and b are read once, coalesced, where
// the TPU kernel walked b in 128-wide blocks over a sequential grid and
// the bisection kernel below runs two full binary searches of b per
// a-key.  Three tile buffers (12 bytes an item) let 12 blocks of the
// largest tile share an SM, so 2^21 merged items run in one wave.
//
// A run of equal b-keys can go on past the block's b-slice only for the
// key b[j1] just after it; warp 1 finds the end of that run once, by a
// galloping 32-way search in global memory, so a run of 10^5 equal keys
// costs a few rounds of loads, never a scan per key.  No key value is
// special: an A_INVALID (2^31-1) a-key finds no equal b-key because b's
// invalid rows carry B_INVALID (2^31-2), and gets start = nb, cnt = 0.
//
// Small probes (below BISECT_BELOW merged items in kernels/merge_probe.py,
// which chooses) run merge_probe_bisect_kernel instead: one thread per
// a-key, a lower-bound bisection of b and an upper-bound one from there.
// There the launch takes about as long as one block's chain of dependent
// steps, and a few bisection steps in L2 are shorter than the merge
// path's split searches, tile load, barriers and two in-tile merges.
// chip_smoke.py's merge_probe_shapes times both kernels in one trace at
// every probe shape of the main path.
//
// Bound on the H100: memory.  The function reads a and b once and writes
// start and cnt once, 4 * (3 * na + nb) bytes.
#include "merge_path.cuh"

namespace {

using mp::NT;

__device__ __forceinline__ int lower_bound(const int* __restrict__ b,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* __restrict__ b,
                                           int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(b + mid) <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void merge_probe_bisect_kernel(const int* __restrict__ a, int na,
                                          const int* __restrict__ b, int nb,
                                          int* __restrict__ start,
                                          int* __restrict__ cnt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= na) return;
  const int key = __ldg(a + i);
  const int s = lower_bound(b, 0, nb, key);
  start[i] = s;
  cnt[i] = upper_bound(b, s, nb, key) - s;
}

// a-keys consumed at diagonal d of the merge, an a-key first on ties
__device__ __forceinline__ long long split(const int* __restrict__ a, int na,
                                           const int* __restrict__ b, int nb,
                                           long long d) {
  const long long lo = d - nb > 0 ? d - nb : 0;
  const long long hi = d < na ? d : na;
  const long long guess = (long long)((double)d * na / ((double)na + nb));
  return mp::warp_first_true_near(guess, lo, hi, [&](long long q) {
    return __ldg(b + (d - 1 - q)) < __ldg(a + q);
  });
}

// a-items of the thread's diagonal dt of the merge of the tile's slices:
// an a-key first on ties (A_FIRST) or a b-key first
template <bool A_FIRST>
__device__ __forceinline__ int split_in_tile(const int* sa, int na_t,
                                             const int* sb, int nb_t,
                                             int dt) {
  int lo = max(0, dt - nb_t), hi = min(dt, na_t);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int bk = sb[dt - 1 - mid], ak = sa[mid];
    if (A_FIRST ? bk < ak : bk <= ak) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// First q > j with q == nb or b[q] > key, for b[j] == key: 31 lanes test
// j + 2^l at once, then a 32-way search inside the bracket they find.
__device__ long long run_end(const int* __restrict__ b, int nb, long long j,
                             int key) {
  const int lane = threadIdx.x & 31;
  const long long p = lane < 31 ? min(j + (1LL << lane), (long long)nb) : nb;
  const unsigned m =
      __ballot_sync(mp::FULL, p >= nb || __ldg(b + p) > key);
  const int f = __ffs(m) - 1;                       // lane 31 is always true
  const long long lo = f == 0 ? j + 1 : j + (1LL << (f - 1)) + 1;
  const long long hi = f < 31 ? min(j + (1LL << f), (long long)nb) : nb;
  return mp::warp_first_true(lo, hi, [&](long long q) {
    return __ldg(b + q) > key;
  });
}

// VT merged items a thread; 16 blocks of 128 threads fill an SM's
// threads, and 12 blocks of the largest tile its shared memory
template <int VT>
__global__ void __launch_bounds__(NT, VT > 7 ? 12 : 16)
merge_probe_kernel(const int* __restrict__ a, int na,
                   const int* __restrict__ b, int nb,
                   int* __restrict__ start, int* __restrict__ cnt) {
  constexpr int TILE = NT * VT;
  __shared__ __align__(16) int s_a[TILE + 4];    // a-slice, then start
  __shared__ __align__(16) int s_b[TILE + 4];    // b-slice
  __shared__ __align__(16) int s_cnt[TILE + 4];  // upper bound, then cnt
  __shared__ long long s_i0, s_i1, s_run_end;
  __shared__ int s_run_key, s_has_run;

  const long long total = (long long)na + nb;
  const long long d0 = (long long)blockIdx.x * TILE;
  const long long d1 = min(d0 + TILE, total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const long long i0 = d0 == 0 ? 0 : split(a, na, b, nb, d0);
    if (lane == 0) s_i0 = i0;
  } else if (warp == 1) {
    const long long i1 = d1 == total ? na : split(a, na, b, nb, d1);
    const long long j1 = d1 - i1;
    // the tile's a-keys equal to b[j1], if any, end it: their run of
    // equal b-keys goes on past the tile's b-slice
    int has = 0, key = 0;
    long long end = j1;
    if (j1 < nb && i1 > 0) {
      key = __ldg(b + j1);
      if (__ldg(a + i1 - 1) == key) {
        has = 1;
        end = run_end(b, nb, j1, key);
      }
    }
    if (lane == 0) {
      s_i1 = i1;
      s_has_run = has;
      s_run_key = key;
      s_run_end = end;
    }
  }
  __syncthreads();

  const long long i0 = s_i0, i1 = s_i1;
  const long long j0 = d0 - i0;
  const int na_t = (int)(i1 - i0), nb_t = (int)(d1 - i1 - j0);
  const int n_t = (int)(d1 - d0);
  const int* sa = s_a + mp::load_tile(s_a, a, i0, na_t);
  const int* sb = s_b + mp::load_tile(s_b, b, j0, nb_t);
  const int off_s = mp::align_off(start + i0);
  const int off_c = mp::align_off(cnt + i0);
  const int dt = min((int)threadIdx.x * VT, n_t);
  __syncthreads();

  // b-key first on ties: the b-keys merged before a[i] are the upper
  // bound of a[i] (or, for the key b[j1], the end of its run)
  {
    int ia = split_in_tile<false>(sa, na_t, sb, nb_t, dt), jb = dt - ia;
    int ak = ia < na_t ? sa[ia] : 0, bk = jb < nb_t ? sb[jb] : 0;
#pragma unroll
    for (int k = 0; k < VT; ++k) {
      if (dt + k < n_t) {
        if (ia < na_t && (jb >= nb_t || ak < bk)) {
          s_cnt[off_c + ia] = (jb == nb_t && s_has_run && ak == s_run_key)
                                  ? (int)s_run_end : (int)(j0 + jb);
          ++ia;
          ak = ia < na_t ? sa[ia] : 0;
        } else {
          ++jb;
          bk = jb < nb_t ? sb[jb] : 0;
        }
      }
    }
  }
  __syncthreads();

  // a-key first on ties: the b-keys merged before a[i] are start[i]
  const int ia0 = split_in_tile<true>(sa, na_t, sb, nb_t, dt);
  int lb[VT];
  {
    int ia = ia0, jb = dt - ia0;
    int ak = ia < na_t ? sa[ia] : 0, bk = jb < nb_t ? sb[jb] : 0;
#pragma unroll
    for (int k = 0; k < VT; ++k) {
      lb[k] = -1;
      if (dt + k < n_t) {
        if (ia < na_t && (jb >= nb_t || ak <= bk)) {
          lb[k] = (int)(j0 + jb);
          s_cnt[off_c + ia] -= lb[k];
          ++ia;
          ak = ia < na_t ? sa[ia] : 0;
        } else {
          ++jb;
          bk = jb < nb_t ? sb[jb] : 0;
        }
      }
    }
  }
  __syncthreads();                  // the a-slice is read no more
  int* s_start = s_a;
  {
    int ia = ia0;
#pragma unroll
    for (int k = 0; k < VT; ++k)
      if (lb[k] >= 0) s_start[off_s + ia++] = lb[k];
  }
  __syncthreads();
  mp::store_tile(start, i0, s_start, off_s, na_t);
  mp::store_tile(cnt, i0, s_cnt, off_c, na_t);
}

}  // namespace

// Tiles shrink with the input: a small probe runs more, shorter blocks
// (its time is the latency of one block), a large one fewer, longer ones
// (fewer split searches, one wave of blocks at 2^21 merged items).
template <int VT>
static void launch(const int* a, int na, const int* b, int nb, int* start,
                   int* cnt, cudaStream_t stream) {
  const long long tile = NT * VT;
  const unsigned blocks = (unsigned)(((long long)na + nb + tile - 1) / tile);
  merge_probe_kernel<VT><<<blocks, NT, 0, stream>>>(a, na, b, nb, start,
                                                     cnt);
}

// method: 1 the merge path, 2 the bisection kernel
extern "C" int merge_probe(const int* a, int na, const int* b, int nb,
                           int* start, int* cnt, int method, void* stream) {
  const long long items = (long long)na + nb;
  const cudaStream_t s = (cudaStream_t)stream;
  if (method != 1 && method != 2) return (int)cudaErrorInvalidValue;
  if (na == 0) {
  } else if (method == 2) {
    const int threads = 256;
    merge_probe_bisect_kernel<<<(na + threads - 1) / threads, threads, 0,
                                s>>>(a, na, b, nb, start, cnt);
  } else if (items >= (1LL << 21)) {
    launch<11>(a, na, b, nb, start, cnt, s);
  } else if (items >= (1LL << 20)) {
    launch<7>(a, na, b, nb, start, cnt, s);
  } else if (items >= (1LL << 18)) {
    launch<5>(a, na, b, nb, start, cnt, s);
  } else {
    launch<3>(a, na, b, nb, start, cnt, s);
  }
  return (int)cudaGetLastError();
}
