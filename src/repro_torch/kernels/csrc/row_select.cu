// Row selection of the joins layer, for Hopper (sm_90a): a count pass and
// an ordered-compaction pass.  Five entries, one launch counter.
//
// Replaces: no Pallas kernel.  The reference selects these rows with jnp
// ops that XLA fuses on the TPU (src/repro/core/matching.py::edge_pairs,
// ::injective_filter, ::filter_rows and ::dedup_project: a keep mask, its
// sum, jnp.nonzero(size=, fill_value=) and a gather).  As PyTorch ops the
// same selection costs the host 25-34 dispatches a call; here a call is
// one count launch, one host read of the total and one compaction launch.
//
// Count pass (edge_count, row_count, mask_count): block b owns tile b of
// rounds * NT consecutive items.  In each round a thread tests one item
// in registers, and the warp's ballot is stored as one word of a keep
// bitmap (a bit an item); the tile's kept count goes to offs[b].  The
// last block to finish (a ticket counter) turns offs into exclusive
// offsets and writes the total.
//   edge_count: pred[e] == pred_id (any predicate when pred_id < 0), each
//     endpoint in its [N] byte mask or, without one, in [lo, hi), and
//     src[e] == dst[e] for a query self-loop.
//   row_count:  rows[r][0] >= 0 and rows[r][i] != rows[r][j] for every
//     column pair the caller marks (columns of distinct query nodes).  A
//     row of k <= 8 columns is read once into registers, with loads of at
//     most 16 bytes.
//   mask_count: keep[r] != 0 for r < n (a device mask of the caller).
// Compaction pass (edge_compact, row_compact): block b reads its tile's
// offset and bitmap words.  A kept item's output row is the offset, plus
// the kept items of the tile's earlier rounds and of the earlier warps of
// its round (__popc of their words), plus its rank in its warp (__popc of
// its word under its lane).  Kept items land in input order, so a sort
// order of the input holds in the output: (src, dst), or src alone for a
// self-loop, from the edge arrays; whole rows from a table.  Output rows
// from min(total, cap) to cap are -1; kept items past cap are cut.
//
// Tiles follow the row width, inside the kernel: 2048 edges, and 2048,
// 1024 or 512 rows for k <= 2, k <= 4 and wider rows (8-16 KB of rows).
//
// Scratch (int32, the caller's): [0] the total, [1] the ticket, then the
// bitmap, W = ceil(n / 32) words, then one offset a tile.
//
// Bound on the H100: memory.  The count pass reads each item once (12
// bytes an edge and its endpoints' mask bytes, 4k bytes a row, 1 byte a
// mask entry) and writes n / 8 bitmap bytes; the compaction pass reads the
// bitmap and the kept items and writes cap output rows.  At the engine's
// sizes (10^5 to 10^6 items) that is microseconds: what the design saves
// is the host's dispatch of the op chains.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int EDGE_ROUNDS = 8;          // an edge tile: 2048 edges
constexpr int MAX_K = 64;               // columns of a row_count row

// rounds of NT rows in a tile of rows k columns wide
inline int row_rounds(int k) { return k <= 2 ? 8 : (k <= 4 ? 4 : 2); }

__host__ __device__ inline long long words_of(long long n) {
  return (n + 31) >> 5;
}

inline int tiles_of(long long n, int rounds) {
  const long long tile = (long long)rounds * NT;
  const long long t = (n + tile - 1) / tile;
  return t > 0 ? (int)t : 1;
}

// the exclusive scan of the tile counts offs[0, ntiles), in place, by the
// last block of the count pass; the total goes to scratch[0]
__device__ void scan_offsets(int* offs, int ntiles, int* scratch) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < ntiles; c0 += NT) {
    const int i = c0 + threadIdx.x;
    const int v = i < ntiles ? __ldcg(offs + i) : 0;
    int x = v;                          // inclusive scan in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int before = s_carry;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    if (i < ntiles) offs[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == NT - 1) s_carry = before + x;
    __syncthreads();
  }
  if (threadIdx.x == 0) scratch[0] = s_carry;
}

template <class Pred>
__global__ void __launch_bounds__(NT)
count_kernel(Pred pred, long long n, int rounds, int* scratch) {
  __shared__ int s_cnt[WARPS];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long words = words_of(n);
  unsigned* bits = reinterpret_cast<unsigned*>(scratch + 2);
  int* offs = scratch + 2 + words;
  const long long base = (long long)blockIdx.x * rounds * NT;
  int kept = 0;                         // the warp's, in every lane
  for (int r = 0; r < rounds; ++r) {
    const long long i0 = base + (long long)r * NT;
    if (i0 >= n) break;                 // the same in the whole block
    const long long i = i0 + threadIdx.x;
    const unsigned word = __ballot_sync(FULL, i < n && pred(i));
    const long long w = (i0 >> 5) + warp;
    if (lane == 0 && w < words) bits[w] = word;
    kept += __popc(word);
  }
  if (lane == 0) s_cnt[warp] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int w = 0; w < WARPS; ++w) c += s_cnt[w];
    offs[blockIdx.x] = c;
    __threadfence();                    // the count before the ticket
    const unsigned t =
        atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), 1u);
    s_last = t == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    scan_offsets(offs, gridDim.x, scratch);
  }
}

__device__ __forceinline__ bool passes(const unsigned char* mask,
                                       long long lo, long long hi, int id) {
  return mask ? __ldg(mask + id) != 0 : (id >= lo && id < hi);
}

struct EdgePred {
  const int* src;
  const int* dst;
  const int* pred;
  int pred_id;
  int self_loop;
  const unsigned char* mask_s;
  const unsigned char* mask_d;
  long long lo_s, hi_s, lo_d, hi_d;
  __device__ __forceinline__ bool operator()(long long e) const {
    if (pred_id >= 0 && __ldg(pred + e) != pred_id) return false;
    const int s = __ldg(src + e), d = __ldg(dst + e);
    if (self_loop && s != d) return false;
    return passes(mask_s, lo_s, hi_s, s) && passes(mask_d, lo_d, hi_d, d);
  }
};

// bit j of m[i]: columns i < j must hold different values
struct Pairs {
  unsigned long long m[MAX_K];
};

// a row of K columns into registers, VEC ints a load
template <int K, int VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ p,
                                         int (&v)[K]) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p) + j);
      v[4 * j] = x.x; v[4 * j + 1] = x.y; v[4 * j + 2] = x.z;
      v[4 * j + 3] = x.w;
    }
  } else if constexpr (VEC == 2) {
#pragma unroll
    for (int j = 0; j < K / 2; ++j) {
      const int2 x = __ldg(reinterpret_cast<const int2*>(p) + j);
      v[2 * j] = x.x; v[2 * j + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = __ldg(p + j);
  }
}

template <int K, int VEC>
struct RowPred {
  const int* rows;
  Pairs pairs;
  __device__ __forceinline__ bool operator()(long long r) const {
    int v[K];
    load_row<K, VEC>(rows + r * K, v);
    bool ok = v[0] >= 0;                // padding rows never survive
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = i + 1; j < K; ++j)
        if ((pairs.m[i] >> j) & 1ull) ok &= v[i] != v[j];
    return ok;
  }
};

// rows wider than 8 columns: read column by column
struct WideRowPred {
  const int* rows;
  int k;
  Pairs pairs;
  __device__ __forceinline__ bool operator()(long long r) const {
    const int* row = rows + r * k;
    if (__ldg(row) < 0) return false;
    for (int i = 0; i < k; ++i) {
      const int vi = __ldg(row + i);
      for (unsigned long long m = pairs.m[i]; m; m &= m - 1)
        if (vi == __ldg(row + __ffsll((long long)m) - 1)) return false;
    }
    return true;
  }
};

struct MaskPred {
  const unsigned char* keep;
  __device__ __forceinline__ bool operator()(long long r) const {
    return __ldg(keep + r) != 0;
  }
};

struct EdgeEmit {
  const int* src;
  const int* dst;
  int width;                            // 2: (src, dst); 1: src
  __device__ __forceinline__ void operator()(long long e, long long p,
                                             int* __restrict__ out) const {
    if (width == 2)
      reinterpret_cast<int2*>(out)[p] = make_int2(__ldg(src + e),
                                                  __ldg(dst + e));
    else
      out[p] = __ldg(src + e);
  }
};

template <int VEC>
struct RowEmit {
  const int* rows;
  int k;
  __device__ __forceinline__ void operator()(long long r, long long p,
                                             int* __restrict__ out) const {
    const int* s = rows + r * k;
    int* d = out + p * k;
    if constexpr (VEC == 4) {
      for (int j = 0; j < k / 4; ++j)
        reinterpret_cast<int4*>(d)[j] =
            __ldg(reinterpret_cast<const int4*>(s) + j);
    } else if constexpr (VEC == 2) {
      for (int j = 0; j < k / 2; ++j)
        reinterpret_cast<int2*>(d)[j] =
            __ldg(reinterpret_cast<const int2*>(s) + j);
    } else {
      for (int j = 0; j < k; ++j) d[j] = __ldg(s + j);
    }
  }
};

// blocks below ntiles compact their tile; every block then writes its
// share of the -1 rows from min(total, cap) to cap
template <class Emit>
__global__ void __launch_bounds__(NT)
compact_kernel(Emit emit, long long n, int rounds, int ntiles,
               const int* __restrict__ scratch, long long cap, int width,
               int* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long words = words_of(n);
  const unsigned* bits = reinterpret_cast<const unsigned*>(scratch + 2);
  if (blockIdx.x < ntiles) {
    const long long base = (long long)blockIdx.x * rounds * NT;
    long long pos = __ldg(scratch + 2 + words + blockIdx.x);
    const unsigned below = (1u << lane) - 1u;
    for (int r = 0; r < rounds; ++r) {
      const long long i0 = base + (long long)r * NT;
      if (i0 >= n || pos >= cap) break;   // the same in the whole block
      const long long w0 = i0 >> 5;
      int before = 0, round_kept = 0;
      unsigned word = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned x = w0 + w < words ? __ldg(bits + w0 + w) : 0u;
        const int c = __popc(x);
        if (w < warp) before += c;
        if (w == warp) word = x;
        round_kept += c;
      }
      if ((word >> lane) & 1u) {
        const long long p = pos + before + __popc(word & below);
        if (p < cap) emit(i0 + threadIdx.x, p, out);
      }
      pos += round_kept;
    }
  }
  const long long total = __ldg(scratch);
  const long long lo = (total < cap ? total : cap) * width;
  const long long hi = cap * width;
  const long long step = (long long)gridDim.x * NT;
  for (long long t = lo + (long long)blockIdx.x * NT + threadIdx.x; t < hi;
       t += step)
    out[t] = -1;
}

template <class Pred>
int launch_count(const Pred& pred, long long n, int rounds, int* scratch,
                 cudaStream_t st) {
  const cudaError_t rc = cudaMemsetAsync(scratch + 1, 0, sizeof(int), st);
  if (rc != cudaSuccess) return (int)rc;
  count_kernel<Pred><<<tiles_of(n, rounds), NT, 0, st>>>(pred, n, rounds,
                                                         scratch);
  return (int)cudaGetLastError();
}

template <class Emit>
int launch_compact(const Emit& emit, long long n, int rounds,
                   const int* scratch, long long cap, int width, int* out,
                   cudaStream_t st) {
  const int ntiles = tiles_of(n, rounds);
  // enough blocks for the -1 rows too, at 8 values a thread
  long long pad = (cap * width + NT * 8 - 1) / (NT * 8);
  if (pad > 4096) pad = 4096;
  const int blocks = ntiles > pad ? ntiles : (int)pad;
  if (cap > 0)
    compact_kernel<Emit><<<blocks, NT, 0, st>>>(emit, n, rounds, ntiles,
                                                scratch, cap, width, out);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

template <int K>
int row_count_k(const int* rows, long long n, const Pairs& pairs,
                int* scratch, cudaStream_t st) {
  const int rounds = row_rounds(K);
  if constexpr (K % 4 == 0) {
    if (aligned(rows, 16))
      return launch_count(RowPred<K, 4>{rows, pairs}, n, rounds, scratch,
                          st);
  }
  if constexpr (K % 2 == 0) {
    if (aligned(rows, 8))
      return launch_count(RowPred<K, 2>{rows, pairs}, n, rounds, scratch,
                          st);
  }
  return launch_count(RowPred<K, 1>{rows, pairs}, n, rounds, scratch, st);
}

}  // namespace

// Count passes.  scratch: int32 [2 + ceil(n / 32) + tiles], the caller's;
// the pass zeroes the ticket itself.  A null mask takes the interval.
extern "C" int edge_count(const int* src, const int* dst, const int* pred,
                          long long n, int pred_id, int self_loop,
                          const unsigned char* mask_s, long long lo_s,
                          long long hi_s, const unsigned char* mask_d,
                          long long lo_d, long long hi_d, int* scratch,
                          void* stream) {
  const EdgePred p{src, dst, pred, pred_id, self_loop, mask_s, mask_d,
                   lo_s, hi_s, lo_d, hi_d};
  return launch_count(p, n, EDGE_ROUNDS, scratch, (cudaStream_t)stream);
}

// masks_host: k words in host memory, bit j of word i set where columns
// i < j must differ
extern "C" int row_count(const int* rows, long long n, int k,
                         const unsigned long long* masks_host, int* scratch,
                         void* stream) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  Pairs pairs = {};
  for (int i = 0; i < k; ++i) pairs.m[i] = masks_host[i];
  const cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
    case 1: return row_count_k<1>(rows, n, pairs, scratch, st);
    case 2: return row_count_k<2>(rows, n, pairs, scratch, st);
    case 3: return row_count_k<3>(rows, n, pairs, scratch, st);
    case 4: return row_count_k<4>(rows, n, pairs, scratch, st);
    case 5: return row_count_k<5>(rows, n, pairs, scratch, st);
    case 6: return row_count_k<6>(rows, n, pairs, scratch, st);
    case 7: return row_count_k<7>(rows, n, pairs, scratch, st);
    case 8: return row_count_k<8>(rows, n, pairs, scratch, st);
    default:
      return launch_count(WideRowPred{rows, k, pairs}, n, row_rounds(k),
                          scratch, st);
  }
}

// keep: n bytes; k, the width of the rows row_compact will copy, sets the
// tile
extern "C" int mask_count(const unsigned char* keep, long long n, int k,
                          int* scratch, void* stream) {
  return launch_count(MaskPred{keep}, n, row_rounds(k), scratch,
                      (cudaStream_t)stream);
}

// Compaction passes, after the count pass on the same scratch.  out:
// [cap, width] int32.
extern "C" int edge_compact(const int* src, const int* dst, long long n,
                            int width, const int* scratch, long long cap,
                            int* out, void* stream) {
  if (width != 1 && width != 2) return (int)cudaErrorInvalidValue;
  return launch_compact(EdgeEmit{src, dst, width}, n, EDGE_ROUNDS, scratch,
                        cap, width, out, (cudaStream_t)stream);
}

extern "C" int row_compact(const int* rows, long long n, int k,
                           const int* scratch, long long cap, int* out,
                           void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rounds = row_rounds(k);
  if (k % 4 == 0 && aligned(rows, 16) && aligned(out, 16))
    return launch_compact(RowEmit<4>{rows, k}, n, rounds, scratch, cap, k,
                          out, st);
  if (k % 2 == 0 && aligned(rows, 8) && aligned(out, 8))
    return launch_compact(RowEmit<2>{rows, k}, n, rounds, scratch, cap, k,
                          out, st);
  return launch_compact(RowEmit<1>{rows, k}, n, rounds, scratch, cap, k,
                        out, st);
}
