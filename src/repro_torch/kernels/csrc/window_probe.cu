// Bucket-span probe of the radix hash join, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/radix_join.py::window_probe_pallas (TPU),
// together with the [n, lmax] bucket window that radix_window gathers for
// it.  For probe keys a[0..n), the partitioned build keys keys_p[0..nk)
// and the bucket edges edges[0..nb] (nb = 2^bits; bucket k's keys are
// keys_p[edges[k]:edges[k+1]), key-sorted), each probe row i reads
//     b = bucket of a[i]: (uint32)a[i] * 2654435761 >> (32 - bits), or nb
//         for a[i] >= B_INVALID (the sentinels)
//     s = edges[b],  e = (b >= nb) ? s : edges[b + 1],  capped at s + lmax
// and returns what window_probe_pallas returns over the window
// keys_p[s:e) followed by lmax - (e - s) B_INVALID fill words:
//     lt[i]  = #{window words <  a[i]}    (offset of the match run)
//     cnt[i] = #{window words == a[i]}    (length of the match run)
//     win_start[i] = s
//
// Design: one thread per probe row, no window.  The TPU kernel compared an
// (8, lmax) block of the gathered window on the VPU; on the card the
// window costs more than the probe (radix_window's five passes over
// [n, lmax]), and the span is already contiguous and sorted in keys_p.  A
// thread hashes its key in native uint32 arithmetic (the reference's),
// reads two edges and scans the span: at load factor ~1 a span holds about
// one key, so the chain is a -> edges -> keys_p with no shuffle reduction.
// Spans longer than LINEAR_MAX (a skewed build side) are bisected: the
// span is sorted, so lt and lt + cnt are its lower and upper bounds.
// edges (4 (nb + 1) bytes, 256 KB at bits = 16) and keys_p stay in L2.
//
// Bound on the H100: memory.  The function reads a once, the edges once,
// the keys_p words that the probes' spans cover once, and writes lt, cnt
// and win_start: 4 n + 4 (nb + 1) + 4 (covered words) + 12 n bytes.
#include <cuda_runtime.h>

namespace {

constexpr int B_INVALID = 2147483646;    // 2^31 - 2: invalid build rows
constexpr int LINEAR_MAX = 16;           // longer spans are bisected

__device__ __forceinline__ int lower_bound(const int* __restrict__ k,
                                           int lo, int hi, int key,
                                           bool upper) {
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    int v = __ldg(k + mid);
    if (v < key || (upper && v == key)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void span_probe_kernel(const int* __restrict__ a, int n,
                                  const int* __restrict__ keys_p, int nk,
                                  const int* __restrict__ edges, int bits,
                                  int lmax, int* __restrict__ lt,
                                  int* __restrict__ cnt,
                                  int* __restrict__ win_start) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int key = __ldg(a + i);
  const unsigned nb = 1u << bits;
  const unsigned b = key >= B_INVALID
      ? nb : ((unsigned)key * 2654435761u) >> (32 - bits);
  const int s = __ldg(edges + b);
  int e = b >= nb ? s : __ldg(edges + b + 1);
  // the window's cap, and the build side's end (edges never pass it)
  e = (int)min((long long)e, (long long)s + lmax);
  e = min(e, nk);
  const int len = max(e - s, 0);
  int l = 0, c = 0;
  if (len <= LINEAR_MAX) {
    for (int k = s; k < s + len; ++k) {
      int v = __ldg(keys_p + k);
      l += v < key;
      c += v == key;
    }
  } else {
    l = lower_bound(keys_p, s, e, key, false) - s;
    c = lower_bound(keys_p, s + l, e, key, true) - s - l;
  }
  // the window's B_INVALID fill past the span
  const int fill = lmax - len;
  l += key > B_INVALID ? fill : 0;
  c += key == B_INVALID ? fill : 0;
  lt[i] = l;
  cnt[i] = c;
  win_start[i] = s;
}

}  // namespace

extern "C" int window_probe(const int* a, int n, const int* keys_p, int nk,
                            const int* edges, int bits, int lmax, int* lt,
                            int* cnt, int* win_start, void* stream) {
  if (n > 0) {
    const int threads = 256;
    span_probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(a, n, keys_p, nk, edges,
                                                bits, lmax, lt, cnt,
                                                win_start);
  }
  return (int)cudaGetLastError();
}
