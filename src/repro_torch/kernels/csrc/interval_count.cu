// Gather + interval count of the neighborhood check (paper Alg. 1), for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/interval_count.py::interval_count_pallas
// (TPU), fused with the row gather ids[cands] that the reference engine
// runs in jnp (src/repro/core/signature.py::_gather_count).  For the NI
// tensor ids [N, cap] (each row: ascending node ids, then -1 padding),
// candidates cands[0..c) and intervals [lo[j], hi[j]), j < nj:
//     out[r, j] = lb(row, hi[j]) - lb(row, lo[j]),   row = ids[cands[r]]
// where lb is the lower bound with the -1 padding read as +infinity.  For
// hi >= lo that is #{b : lo[j] <= row[b] < hi[j]}, the count the TPU
// kernel computed by comparing every entry of the row.
//
// Design: one warp per candidate row, binary search over the row's valid
// prefix.  lens[n] (optional) is the number of ids stored in row n, i.e.
// min(count, cap) of the NI entry; the searches then run over
// [0, min(lens[n], cap)) instead of the whole cap, which on real NI rows
// (a few ids in a 4096-wide row) cuts the chain of dependent loads from
// log2(cap) = 12 to about log2(lens[n]).  Without lens the search covers
// the whole row.  Lane l < 16 searches lo[base + l] and lane 16 + l
// searches hi[base + l], one shuffle pairs them, and lanes < 16 write the
// counts; intervals beyond 16 take further rounds.  The gather is fused:
// the warp reads its row straight from ids, so the [c, cap] gathered
// block never exists in device memory.  A full compare-count pass would
// read the whole 16 KB row (cap = 4096) per candidate, 134 MB at
// c = 8192; the searches touch 2 * nj * log2(lens) words per row instead.
// That makes the kernel bound by the latency of its dependent loads
// rather than by bandwidth.
//
// Bound on the H100: memory, counting each row's valid prefix once
// (what a compare-count would read) plus cands, lens, lo, hi and the
// output.
#include <cuda_runtime.h>

namespace {

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
    int pos_hi = __shfl_down_sync(0xffffffffu, pos, 16);
    if (lane < 16 && active) out[warp * nj + j] = pos_hi - pos;
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
