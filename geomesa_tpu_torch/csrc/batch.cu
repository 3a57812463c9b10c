// Micro-batched multi-query scan kernels for Hopper (sm_90a).
//
// Replaces the XLA programs of the reference package's batched scan
// (geomesa_tpu/scan/zscan.py), which serve QueryBatcher ->
// InMemoryDataStore.query_batched -> zscan.batch_hit_rows:
//   - _batch_mask_cand (with _mask_body and _cand_body, vmapped over the
//     batch) and _batch_count  -> scan_batch_bits_kernel
//   - _batch_nonzero                                   -> compact_bits_kernel
//
// scan_batch_bits_kernel: Qg queries of a batch over rows < n, in one
// pass. Per row and query, the predicate of csrc/scan.cu (OR over K
// boxes of the two-float box test, AND an OR over B inclusive (day, ms)
// intervals) and the boundary-candidate test of _cand_body (the row's
// xhi equals a box's xmin_hi or xmax_hi, or its yhi equals ymin_hi or
// ymax_hi). Both are pure compares of stored f32/i32 words, so the
// result is bit-identical to the reference. Build WITHOUT
// --use_fast_math or -ftz=true (subnormal words must compare as
// numbers). Design:
//   - a row's six words are loaded once, for all Qg queries (XLA's vmap
//     re-reads the columns per query);
//   - the Qg queries' tables, boxes (Qg, K, 8) f32 and times (Qg, B, 4)
//     i32, are staged in shared memory. Unused box slots hold NaN in
//     every bound, so neither test matches any row, and unused interval
//     slots impossible bounds (INT32_MAX/INT32_MIN); there are no
//     validity masks. A time-free query carries the reference's
//     catch-all interval;
//   - a warp covers 32 consecutive rows, one per lane; __ballot_sync
//     turns the lanes' verdicts into one 32-bit word per query for the
//     hit bitmap and one for the candidate bitmap. Lane q keeps query
//     q's two words, so a warp stores the words of all its queries with
//     two store instructions (Qg <= 32 per launch);
//   - a block covers kRowsPerBlock = 2048 consecutive rows (64 words)
//     and writes one popcount per query and kind: partials, not atomics
//     to device memory, so the counts and the compaction's offsets are
//     deterministic.
//   Outputs: bits uint32 [2, Qp, words], words = ceil(cap / 32), bit j of
//   word w is row 32w + j, rows >= n zero; partials int32 [2, Qp, nb],
//   nb = ceil(words / 64). Kind 0 is hits, kind 1 candidates.
//   Bound (chip_smoke.bound_ms): bytes = 24 B per row < n read + 2 Qp/8
//   B per row of capacity written (+ the partials); operations about
//   n Qp (13 K + 7 B + 8 K) for the box test, the interval test and the
//   candidate test. With the smoke run's batch (Qp 32, K 4, B 2) the
//   operations bound it. Later work: 16-byte vector loads, fewer
//   compares per query, staging the words in shared memory for
//   coalesced stores.
//
// compact_bits_kernel: each query's ascending row ids from the bitmaps,
// in one flat int32 buffer per kind, query after query. The offsets are
// the exclusive prefix of the partials over (Qp, nb) per kind (the
// wrapper's torch.cumsum). A warp takes 32 (kind, query, block) pairs at
// a time, reads their 32 partials with one load and skips the empty
// ones; for each non-empty pair it reads the block's 64 words (two per
// lane), scans their popcounts across the warp and writes the set bits'
// rows from the pair's offset. Bound: bytes = partials and offsets read
// + the words of non-empty blocks + 4 B per id written (what this data
// needs: an empty block is never read).
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 8;
constexpr int kRowsPerBlock = kThreads * kIters;    // 2048
constexpr int kWordsPerBlock = kRowsPerBlock / 32;  // 64: two per lane
constexpr int kMaxGroup = 32;                       // queries per launch
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

struct Cols {
  const float* xhi;
  const float* xlo;
  const float* yhi;
  const float* ylo;
  const int32_t* tday;
  const int32_t* tms;
};

__device__ __forceinline__ bool ge2(float hi, float lo, float bhi, float blo) {
  return (hi > bhi) | ((hi == bhi) & (lo >= blo));
}

__device__ __forceinline__ bool le2(float hi, float lo, float bhi, float blo) {
  return (hi < bhi) | ((hi == bhi) & (lo <= blo));
}

// One row against one query's tables: its hit and its candidate verdict.
__device__ __forceinline__ void row_query(float xh, float xl, float yh,
                                          float yl, int32_t td, int32_t tm,
                                          const float* bx, int k,
                                          const int32_t* tx, int b,
                                          bool& hit, bool& cand) {
  bool s = false, c = false;
  for (int j = 0; j < k; ++j) {
    const float* q = bx + 8 * j;
    s |= ge2(xh, xl, q[0], q[1]) & le2(xh, xl, q[2], q[3]) &
         ge2(yh, yl, q[4], q[5]) & le2(yh, yl, q[6], q[7]);
    c |= (xh == q[0]) | (xh == q[2]) | (yh == q[4]) | (yh == q[6]);
  }
  bool t = false;
  for (int j = 0; j < b; ++j) {
    const int32_t* q = tx + 4 * j;
    const bool after = (td > q[0]) | ((td == q[0]) & (tm >= q[1]));
    const bool before = (td < q[2]) | ((td == q[2]) & (tm <= q[3]));
    t |= after & before;
  }
  hit = s & t;
  cand = c;
}

// bits and partials point at the group's first query; a kind's block
// follows the other at kind_bits / kind_parts elements.
__global__ void __launch_bounds__(kThreads)
    scan_batch_bits_kernel(Cols c, int64_t n, int64_t words,
                           const float* boxes, const int32_t* times, int qg,
                           int k, int b, uint32_t* __restrict__ bits,
                           int64_t kind_bits, int32_t* __restrict__ partials,
                           int64_t kind_parts, int64_t nb) {
  extern __shared__ float smem[];
  float* s_boxes = smem;
  int32_t* s_times = reinterpret_cast<int32_t*>(smem + qg * k * 8);
  int32_t* s_cnt = s_times + qg * b * 4;  // [2][kMaxGroup]
  for (int j = threadIdx.x; j < qg * k * 8; j += blockDim.x)
    s_boxes[j] = boxes[j];
  for (int j = threadIdx.x; j < qg * b * 4; j += blockDim.x)
    s_times[j] = times[j];
  if (threadIdx.x < 2 * kMaxGroup) s_cnt[threadIdx.x] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t blk = blockIdx.x;
  int32_t cnt_hit = 0, cnt_cand = 0;
  for (int it = 0; it < kIters; ++it) {
    const int64_t w = blk * kWordsPerBlock + it * kWarps + warp;
    if (w >= words) break;  // uniform across the warp
    const int64_t i = w * 32 + lane;
    const bool live = i < n;
    float xh = 0.f, xl = 0.f, yh = 0.f, yl = 0.f;
    int32_t td = 0, tm = 0;
    if (live) {
      xh = c.xhi[i];
      xl = c.xlo[i];
      yh = c.yhi[i];
      yl = c.ylo[i];
      td = c.tday[i];
      tm = c.tms[i];
    }
    uint32_t my_hit = 0, my_cand = 0;
    for (int q = 0; q < qg; ++q) {
      bool hit = false, cand = false;
      if (live)
        row_query(xh, xl, yh, yl, td, tm, s_boxes + q * k * 8, k,
                  s_times + q * b * 4, b, hit, cand);
      const uint32_t wh = __ballot_sync(kFull, hit);
      const uint32_t wc = __ballot_sync(kFull, cand);
      if (lane == q) {
        my_hit = wh;
        my_cand = wc;
      }
    }
    if (lane < qg) {
      bits[lane * words + w] = my_hit;
      bits[kind_bits + lane * words + w] = my_cand;
      cnt_hit += __popc(my_hit);
      cnt_cand += __popc(my_cand);
    }
  }
  // integer sums: exact in any order
  if (lane < qg) {
    atomicAdd(&s_cnt[lane], cnt_hit);
    atomicAdd(&s_cnt[kMaxGroup + lane], cnt_cand);
  }
  __syncthreads();
  if (threadIdx.x < qg) {
    partials[threadIdx.x * nb + blk] = s_cnt[threadIdx.x];
    partials[kind_parts + threadIdx.x * nb + blk] = s_cnt[kMaxGroup + threadIdx.x];
  }
}

// Pairs p = (kind * qp + q) * nb + j, the flat index of partials and
// offsets; block j of query q covers words j*64 .. j*64+63 of its row.
__global__ void __launch_bounds__(kThreads)
    compact_bits_kernel(const uint32_t* __restrict__ bits,
                        const int32_t* __restrict__ partials,
                        const int64_t* __restrict__ offsets, int64_t pairs,
                        int qp, int64_t nb, int64_t words,
                        int32_t* __restrict__ out_hit,
                        int32_t* __restrict__ out_cand) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t per_kind = static_cast<int64_t>(qp) * nb;
  for (int64_t p0 = warp * 32; p0 < pairs; p0 += warps * 32) {
    const int64_t p = p0 + lane;
    const int32_t cnt = p < pairs ? partials[p] : 0;
    uint32_t todo = __ballot_sync(kFull, cnt != 0);
    while (todo) {  // uniform across the warp
      const int64_t pp = p0 + (__ffs(todo) - 1);
      todo &= todo - 1;
      const int64_t kind = pp / per_kind;
      const int64_t rest = pp - kind * per_kind;
      const int64_t q = rest / nb;
      const int64_t w0 = (rest - q * nb) * kWordsPerBlock + 2 * lane;
      const uint32_t* row = bits + (kind * qp + q) * words;
      const uint32_t a = w0 < words ? row[w0] : 0u;
      const uint32_t a1 = w0 + 1 < words ? row[w0 + 1] : 0u;
      const int mine = __popc(a) + __popc(a1);
      int incl = mine;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int32_t* out = kind ? out_cand : out_hit;
      int64_t at = offsets[pp] + (incl - mine);
      const int64_t r0 = w0 * 32;
      for (uint32_t m = a; m; m &= m - 1)
        out[at++] = static_cast<int32_t>(r0 + __ffs(m) - 1);
      for (uint32_t m = a1; m; m &= m - 1)
        out[at++] = static_cast<int32_t>(r0 + 32 + __ffs(m) - 1);
    }
  }
}

}  // namespace

extern "C" {

int geomesa_batch_rows_per_block() { return kRowsPerBlock; }

int geomesa_batch_max_group() { return kMaxGroup; }

// Bitmaps and partials of queries q0 .. q0+qg-1 (the pointers are at q0):
// bits[kind][q][w] for w < words, partials[kind][q][j] for j < nb =
// ceil(words / 64); a query's row is `words` (bits) or `nb` (partials)
// elements long, a kind `kind_bits` or `kind_parts`. boxes (qg, k, 8) and
// times (qg, b, 4), contiguous. Requires 1 <= qg <= 32, words > 0 and the
// tables + 256 B within the default 48 KB of dynamic shared memory.
int geomesa_scan_batch_bits(const float* xhi, const float* xlo,
                            const float* yhi, const float* ylo,
                            const int32_t* tday, const int32_t* tms,
                            int64_t n, int64_t words, const float* boxes,
                            const int32_t* times, int qg, int k, int b,
                            uint32_t* bits, int64_t kind_bits,
                            int32_t* partials, int64_t kind_parts,
                            void* stream) {
  const int64_t nb = (words + kWordsPerBlock - 1) / kWordsPerBlock;
  if (qg < 1 || qg > kMaxGroup || k < 1 || b < 1 || nb < 1 || nb > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(qg) * k * 8 * sizeof(float) +
                      static_cast<size_t>(qg) * b * 4 * sizeof(int32_t) +
                      2 * kMaxGroup * sizeof(int32_t);
  Cols c{xhi, xlo, yhi, ylo, tday, tms};
  scan_batch_bits_kernel<<<static_cast<int>(nb), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      c, n, words, boxes, times, qg, k, b, bits, kind_bits, partials,
      kind_parts, nb);
  return static_cast<int>(cudaGetLastError());
}

// Ids of every query of both kinds: out_hit / out_cand hold the rows of
// query 0, then query 1, ..., each ascending, from offsets[(kind * qp +
// q) * nb + j] (int64, the exclusive prefix of partials within a kind).
// Requires qp * nb > 0.
int geomesa_compact_bits(const uint32_t* bits, const int32_t* partials,
                         const int64_t* offsets, int qp, int64_t nb,
                         int64_t words, int32_t* out_hit, int32_t* out_cand,
                         void* stream) {
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  const int64_t chunks = (pairs + 31) / 32;
  int64_t blocks = (chunks + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  compact_bits_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      bits, partials, offsets, pairs, qp, nb, words, out_hit, out_cand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
