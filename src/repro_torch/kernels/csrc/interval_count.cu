// Interval counts of the neighborhood check (paper Alg. 1), for Hopper
// (sm_90a).  Two entry points share this source:
//
// interval_count: gather + count.
//   Replaces src/repro/kernels/interval_count.py::interval_count_pallas
//   (TPU), fused with the row gather ids[cands] that the reference engine
//   runs in jnp (src/repro/core/signature.py::_gather_count).  For the NI
//   tensor ids [N, cap] (each row: ascending node ids, then -1 padding),
//   candidates cands[0..c) and intervals [lo[j], hi[j]), j < nj:
//       out[r, j] = lb(row, hi[j]) - lb(row, lo[j]),   row = ids[cands[r]]
//   where lb is the lower bound with the -1 padding read as +infinity.
//   For hi >= lo that is #{b : lo[j] <= row[b] < hi[j]}, the count the TPU
//   kernel computed by comparing every entry of the row.  One warp per
//   candidate row, binary search over the row's stored prefix
//   [0, min(lens[n], cap)) (the whole cap without lens): lane l < 16
//   searches lo[base + l] and lane 16 + l searches hi[base + l].
//
// interval_check: the whole check of one query node in one launch.
//   Replaces the loop of src/repro/core/signature.py::
//   check_interval_candidates around _gather_count (one call for each
//   8,192-candidate chunk, direction and distance, each followed by a copy
//   to the host) with its verdict:
//       ok[t] for candidate node lo + t, t < n_cand
//   over the segments that desc describes, in the reference's order: the
//   distances 1..D of the forward direction, then of the backward one.
//   A segment is one NI entry (ids, stored lengths, overflow bits, cap)
//   and its direction's intervals lo[nj], hi[nj]; where the node's
//   requirements need counts at that distance it also carries need[nj].
//   Per direction, cum[j] sums the counts over distance and over the
//   overflow bits; a segment with need sets
//       ok &= all_j(cum[j] >= need[j]) | over.
//   Candidates are a contiguous id range, so no cands array is read, and
//   the reference's chunks (which bound its [chunk, cap] gather block)
//   are gone: the rows are read in place.  The caller points ok at column
//   lo of the node's [N] pass mask, so the verdict is written in place,
//   and gives two counters, to which the launch adds the candidates that
//   passed and those that passed with an overflowed row in any segment:
//   the check's counts, with no copy of the verdict to the host.
//
// Design of interval_check: one warp per candidate, lane j holding
// interval base + j in registers (rounds of 32 for nj > 32).  The
// segments (at most MAX_SEG) are a kernel parameter, read from the
// constant cache.  For PREFETCH segments at a time the warp issues all its
// loads at once: the first 8 words of each row (one 32-byte sector; the
// engine's rows hold 4-5 ids on average), the stored length, the
// overflow bit and the lane's interval bounds and need.  A stored prefix
// n <= 32 is then counted from registers: lane j walks the n words, each
// broadcast by one shuffle, and adds (w < hi_j) - (w < lo_j), which is
// lb(hi_j) - lb(lo_j) on an ascending row (rows of 9-32 ids load their
// other words first).  That is n shuffles a segment, where a vote per
// interval costs 4 J shuffles and votes, which issue at a quarter of the
// ALU rate.  Longer prefixes bisect, lanes 0-15 on the lower and lanes
// 16-31 on the upper bounds.  The verdict is one __all_sync per segment
// with need; a warp whose verdict is false stops.  Lane 0 of a warp
// that passes adds 1 to the pass counter, and 1 to the other counter
// where a row it read had overflowed.
//
// Bound on the H100: memory.  interval_count: each candidate row's stored
// prefix once, plus cands, lens, lo, hi and the output.  interval_check:
// each candidate's stored prefix in each segment once, its length and
// overflow bit, and one output byte per candidate (the counters' atomics,
// two a passing candidate at most, add no bytes that matter).  Neither
// comes near it: interval_count waits on its chain of dependent loads, and
// interval_check spends a warp's bookkeeping on rows of about 5 ids, so
// its time goes to instructions and load latency per candidate, not to
// bytes (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int lower_bound_row(const int* __restrict__ row,
                                               int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    int v = __ldg(row + mid);
    if (v >= 0 && v < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void interval_count_kernel(const int* __restrict__ ids, int cap,
                                      const int* __restrict__ lens,
                                      const int* __restrict__ cands, int c,
                                      const int* __restrict__ lo,
                                      const int* __restrict__ hi, int nj,
                                      int* __restrict__ out) {
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= c) return;             // uniform across the warp
  const int r = cands[warp];
  const int* row = ids + (long long)r * cap;
  const int n = lens ? min(max(__ldg(lens + r), 0), cap) : cap;
  for (int base = 0; base < nj; base += 16) {
    int j = base + (lane & 15);
    bool active = j < nj;
    int pos = 0;
    if (active) pos = lower_bound_row(row, n, lane < 16 ? lo[j] : hi[j]);
    int pos_hi = __shfl_down_sync(FULL, pos, 16);
    if (lane < 16 && active) out[warp * nj + j] = pos_hi - pos;
  }
}

// One (direction, distance) segment of a node's check.  The segments
// travel by value as a kernel parameter, so every warp reads them from
// the constant cache, shared by all warps of an SM.
constexpr int MAX_SEG = 16;
constexpr int FIRST = 1;     // the first distance of its direction
constexpr int CHECK = 2;     // need[] is checked after this segment
constexpr int PREFETCH = 4;  // segments whose loads are issued together
constexpr int HEAD = 8;      // row words loaded before the length is known

struct Segment {
  const int* ids;            // [N, cap]
  const int* lens;           // [N] stored lengths, or null: the whole cap
  const unsigned char* over; // [N] overflow bits
  int cap, flags, nj;
  int data;                  // offset in data of lo[nj], hi[nj], need[nj]
};
struct Segments {
  Segment seg[MAX_SEG];
};

// No __launch_bounds__(64, 32): capping the kernel at 32 registers for
// all 64 warp slots of an SM spilled 224 bytes and ran 2.2x slower.
__global__ void interval_check_kernel(const __grid_constant__ Segments args,
                                      int nseg, int max_nj,
                                      const int* __restrict__ data,
                                      int first, int n_cand,
                                      unsigned char* __restrict__ ok_out,
                                      int* __restrict__ tally) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_cand) return;        // uniform across the warp
  const long long node = first + warp;
  bool ok = true;
  bool any_over = false;             // an overflowed row in any segment
  for (int base = 0; ok && base < max_nj; base += 32) {
    const int j = base + lane;       // this lane's interval
    int cum = 0;
    bool over = false;
    // not unrolled: an unrolled walk over all MAX_SEG segments took 176
    // registers a thread, and occupancy, not issue, then bounded it
    for (int s0 = 0; ok && s0 < nseg; s0 += PREFETCH) {
      // issue every load of PREFETCH segments before using any
      int v[PREFETCH], len[PREFETCH], lo[PREFETCH], hi[PREFETCH],
          need[PREFETCH];
      bool o[PREFETCH];
#pragma unroll
      for (int k = 0; k < PREFETCH; ++k) {
        const Segment& g = args.seg[s0 + k];
        v[k] = -1;
        len[k] = lo[k] = hi[k] = need[k] = 0;
        o[k] = false;
        if (s0 + k < nseg && base < g.nj) {
          const int* row = g.ids + node * g.cap;
          if (lane < min(g.cap, HEAD)) v[k] = __ldg(row + lane);
          len[k] = g.lens ? __ldg(g.lens + node) : g.cap;
          o[k] = __ldg(g.over + node) != 0;
          if (j < g.nj) {
            lo[k] = __ldg(data + g.data + j);
            hi[k] = __ldg(data + g.data + g.nj + j);
            if (g.flags & CHECK) need[k] = __ldg(data + g.data + 2 * g.nj + j);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PREFETCH; ++k) {
        const Segment& g = args.seg[s0 + k];
        if (s0 + k >= nseg) break;
        if (g.flags & FIRST) {
          any_over |= over;
          cum = 0;
          over = false;
        }
        if (base >= g.nj) continue;  // no interval of this round
        const int* row = g.ids + node * g.cap;
        const int n = min(max(len[k], 0), g.cap);
        int c = 0;
        if (n <= 32) {               // uniform: one row per warp
          // lane j walks the prefix, one broadcast word at a time
          int x = v[k];
          if (n > HEAD && lane >= HEAD && lane < n) x = __ldg(row + lane);
          for (int l = 0; l < n; ++l) {
            const int w = __shfl_sync(FULL, x, l);
            c += w >= 0 ? (w < hi[k]) - (w < lo[k]) : 0;
          }
        } else {
          // bisection, 16 intervals at a time: lane i < 16 searches lo
          // and lane 16 + i searches hi of interval sub + i
          const int jn = min(32, g.nj - base);
          for (int sub = 0; sub < jn; sub += 16) {
            const int i = sub + (lane & 15);
            const int l = __shfl_sync(FULL, lo[k], i);
            const int u = __shfl_sync(FULL, hi[k], i);
            const int pos = i < jn ? lower_bound_row(row, n, lane < 16 ? l : u)
                                   : 0;
            const int cnt = __shfl_down_sync(FULL, pos, 16) - pos;
            const int got = __shfl_sync(FULL, cnt, (lane - sub) & 31);
            if (lane >= sub && lane < sub + 16) c = got;
          }
        }
        cum += c;
        over |= o[k];
        if (g.flags & CHECK) {
          ok = __all_sync(FULL, j >= g.nj || cum >= need[k]) || over;
          if (!ok) break;            // uniform: the verdict is the warp's
        }
      }
    }
    any_over |= over;
  }
  if (lane != 0) return;
  ok_out[warp] = ok;
  // a pass has read every segment in the first round (each has nj >= 1),
  // so any_over holds every segment's overflow bit
  if (ok) {
    atomicAdd(tally, 1);
    if (any_over) atomicAdd(tally + 1, 1);
  }
}

}  // namespace

// lens may be null: every row is then searched over its whole cap.
extern "C" int interval_count(const int* ids, int cap, const int* lens,
                              const int* cands, int c, const int* lo,
                              const int* hi, int nj, int* out,
                              void* stream) {
  if (c > 0 && nj > 0) {
    const int threads = 256;           // 8 candidate rows per block
    long long blocks = ((long long)c * 32 + threads - 1) / threads;
    interval_count_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(ids, cap, lens, cands, c,
                                                    lo, hi, nj, out);
  }
  return (int)cudaGetLastError();
}

// hdr: nseg segments of 8 host int64 words (ids, lens or 0, overflow,
// cap, flags, nj, offset in data of lo[nj], hi[nj], need[nj], unused);
// data: device int32; ok: n_cand bytes, candidate first + t's at ok[t];
// tally: two device int32 counters, to which the passes and the passes
// with an overflowed row in some segment are added.
extern "C" int interval_check(const long long* hdr, int nseg, int max_nj,
                              const int* data, int first, int n_cand,
                              unsigned char* ok, int* tally, void* stream) {
  if (nseg < 1 || nseg > MAX_SEG) return (int)cudaErrorInvalidValue;
  Segments args = {};
  for (int s = 0; s < nseg; ++s) {
    const long long* h = hdr + 8 * s;
    args.seg[s] = {(const int*)h[0], (const int*)h[1],
                   (const unsigned char*)h[2], (int)h[3], (int)h[4],
                   (int)h[5], (int)h[6]};
  }
  if (n_cand > 0) {
    // 2 candidates per block: a block's registers are freed only when
    // its last warp ends, and a warp with a long row ends late
    const int threads = 64;
    long long blocks = ((long long)n_cand * 32 + threads - 1) / threads;
    interval_check_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(args, nseg, max_nj, data,
                                                    first, n_cand, ok, tally);
  }
  return (int)cudaGetLastError();
}
