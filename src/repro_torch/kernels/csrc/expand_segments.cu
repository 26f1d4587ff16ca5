// The join expand, for Hopper (sm_90a): two entries, one launch counter.
//
// Replaces: src/repro/kernels/fused_join.py::expand_segments_pallas (TPU)
// and the row gather of src/repro/kernels/fused_join.py::_expand, which
// src/repro/core/matching.py::_merge_expand and
// src/repro/kernels/radix_join.py::radix_scatter repeat with
// jnp.searchsorted in place of the Pallas kernel.
//
// expand_segments: for a nondecreasing int32 csum[0..n) (the running match
// counts of the a-rows) and every output slot t in [0, cap):
//     seg[t] = #{i : csum[i] <= t}       (upper bound of t in csum)
// One thread per slot, one upper-bound bisection of csum.  The engine no
// longer calls it; it stays as the slot map alone, and as the first half
// of the expand that expand_gather replaced.
//
// expand_gather: the whole expand in one launch.  With E = min(csum[n-1],
// limit) read on the card (no second host sync), output slot t < E pairs
// a-row i = seg[t] with b-row start[i] + (t - (csum[i] - cnt[i])):
//     out[t] = a_rows[i] ++ b_rows[j][sel]     for t < E
//     out[t] = -1 everywhere                   for E <= t < cap
// Design: a merge path (merge_path.cuh) over the a-rows' ends csum[i] and
// the slots t, a row's end going before a slot that is not below it, so
// the rows merged before slot t are exactly seg[t].  Each block owns TILE
// items of the merged order, so a long run of rows with cnt = 0 (common
// in selective joins) costs what as many slots cost.  Warps 0 and 1 find
// where the block's first and last diagonals cut the rows, by a 32-way
// search of csum in global memory; the block loads its rows' csum and
// start into shared memory with 16-byte loads; each thread merges VT items
// and records each slot's row in shared memory; then the block writes its
// contiguous [slots, w] stretch of the row-major output, four neighbouring
// values a thread, as 16-byte stores, gathering each value from a_rows or
// b_rows.  The row base csum[i] - cnt[i] is read as csum[i-1], so cnt is
// not read.
//
// Bound on the H100: memory.  The function reads csum, cnt and start once,
// the a-rows and the b-rows' selected columns that its slots use, and
// writes the output once: 4 * (3n + used a-rows * ka + used b-rows *
// nsel + cap * w) bytes.
#include "merge_path.cuh"

namespace {

using mp::NT;
constexpr int VT = 11;              // merged items a thread
constexpr int TILE = NT * VT;       // merged items a block

constexpr int MAX_SEL = 256;        // b columns a join can add

struct Sel {
  int c[MAX_SEL];
};

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

// rows merged before diagonal d of the merge of csum with the slots.  The
// search starts from no guess: the main path's expands are skewed (most
// rows of a probe side own no slot), where a guess from even spacing
// costs rounds instead of saving them.
__device__ __forceinline__ long long split(const int* __restrict__ csum,
                                           int n, int cap, long long d) {
  const long long lo = d - cap > 0 ? d - cap : 0;
  const long long hi = d < n ? d : n;
  return mp::warp_first_true(lo, hi, [&](long long q) {
    return (long long)__ldg(csum + q) > d - 1 - q;   // row q ends after
  });                                                 // slot d - 1 - q
}

__global__ void __launch_bounds__(NT)
expand_gather_kernel(const int* __restrict__ a_rows, int n, int ka,
                     const int* __restrict__ b_rows, int nb, int kb,
                     const int* __restrict__ start,
                     const int* __restrict__ csum, int limit, int cap,
                     int nsel, Sel sel, int* __restrict__ out) {
  __shared__ __align__(16) int s_cs[TILE + 12];  // csum[i0-1 .. i1-1]
  __shared__ __align__(16) int s_st[TILE + 8];   // start[i0 .. i1]
  __shared__ int s_row[TILE];                    // each slot's row - i0
  __shared__ int s_sel[MAX_SEL];
  __shared__ long long s_i0, s_i1;
  __shared__ int s_end;

  const long long total = (long long)n + cap;
  const long long d0 = (long long)blockIdx.x * TILE;
  const long long d1 = min(d0 + TILE, total);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    const long long i0 = d0 == 0 ? 0 : split(csum, n, cap, d0);
    if (lane == 0) {
      s_i0 = i0;
      s_end = n ? min(__ldg(csum + n - 1), limit) : 0;
    }
  } else if (warp == 1) {
    const long long i1 = d1 == total ? n : split(csum, n, cap, d1);
    if (lane == 0) s_i1 = i1;
  }
  for (int k = threadIdx.x; k < nsel; k += blockDim.x) s_sel[k] = sel.c[k];
  __syncthreads();

  const long long i0 = s_i0, i1 = s_i1;
  const long long t0 = d0 - i0, t1 = d1 - i1;
  const int nr = (int)(i1 - i0), ns = (int)(t1 - t0);
  const int n_t = (int)(d1 - d0);
  // cs[r] = csum[i0 - 1 + r] (0 for row -1): row i0 + r starts at cs[r]
  // and ends at cs[r + 1]; st[r] = start[i0 + r], for rows below n
  const int* cs;
  if (i0 > 0) {
    cs = s_cs + 4 + mp::load_tile(s_cs + 4, csum, i0 - 1, nr + 1);
  } else {
    cs = s_cs + 3 + mp::load_tile(s_cs + 4, csum, 0, nr);
    if (threadIdx.x == 0) s_cs[3 + mp::align_off(csum)] = 0;
  }
  const int* st = s_st + mp::load_tile(
      s_st, start, i0, (int)(min(i1 + 1, (long long)n) - i0));
  __syncthreads();

  // this thread's diagonal inside the tile, and where it cuts the rows
  const int dt = min((int)threadIdx.x * VT, n_t);
  int lo = max(0, dt - ns), hi = min(dt, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)cs[mid + 1] > t0 + (dt - 1 - mid)) hi = mid;
    else lo = mid + 1;
  }
  int r = lo, ts = dt - lo;
  const int end = min(dt + VT, n_t);
  for (int k = dt; k < end; ++k) {
    if (r < nr && (ts >= ns || (long long)cs[r + 1] <= t0 + ts))
      ++r;                          // row r ends before slot t0 + ts
    else
      s_row[ts++] = r;              // slot t0 + ts belongs to row r
  }
  __syncthreads();

  const long long e = s_end;
  mp::store_rows(out, t0, ns, ka + nsel, [&](int slot, int col) -> int {
    const long long t = t0 + slot;
    if (t >= e) return -1;
    const int rr = s_row[slot];
    if (col < ka) return __ldg(a_rows + (i0 + rr) * ka + col);
    if (nb == 0) return -1;
    long long j = (long long)st[rr] + (t - cs[rr]);
    j = j < 0 ? 0 : (j >= nb ? nb - 1 : j);
    return __ldg(b_rows + j * kb + s_sel[col - ka]);
  });
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

// sel_host: the nsel b columns the output takes, in order (host memory)
extern "C" int expand_gather(const int* a_rows, int n, int ka,
                             const int* b_rows, int nb, int kb,
                             const int* start, const int* csum, int limit,
                             int cap, const int* sel_host, int nsel,
                             int* out, void* stream) {
  if (nsel < 0 || nsel > MAX_SEL) return (int)cudaErrorInvalidValue;
  Sel sel = {};
  for (int k = 0; k < nsel; ++k) sel.c[k] = sel_host[k];
  if (cap > 0) {
    const long long items = (long long)n + cap;
    const unsigned blocks = (unsigned)((items + TILE - 1) / TILE);
    expand_gather_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        a_rows, n, ka, b_rows, nb, kb, start, csum, limit, cap, nsel, sel,
        out);
  }
  return (int)cudaGetLastError();
}
