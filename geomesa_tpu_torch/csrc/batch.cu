// Micro-batched multi-query scan kernels for Hopper (sm_90a).
//
// Replaces the XLA programs of the reference package's batched scan
// (geomesa_tpu/scan/zscan.py), which serve QueryBatcher ->
// InMemoryDataStore.query_batched -> zscan.batch_hit_rows:
//   - _batch_mask_cand (with _mask_body and _cand_body, vmapped over the
//     batch) and _batch_count  -> scan_batch_bits_kernel
//   - _batch_nonzero           -> compact_prefix_kernel + compact_bits_kernel
// They have no Pallas source, so no TPU block structure carries over.
//
// scan_batch_bits_kernel: Qg queries of a batch over rows < n, in one
// pass. Per row and query, the predicate of csrc/scan.cu (OR over the
// query's boxes of the two-float box test, AND an OR over its inclusive
// (day, ms) intervals) and the boundary-candidate test of _cand_body (the
// row's xhi equals a box's xmin_hi or xmax_hi, or its yhi equals ymin_hi
// or ymax_hi). Both are pure compares of stored f32/i32 words, so the
// result is bit-identical to the reference. Build WITHOUT
// --use_fast_math or -ftz=true (subnormal words must compare as
// numbers).
//   Bound (chip_smoke.bound_ms): bytes = 24 B per row < n read + 2 Qp/8
//   B per row of capacity written (+ the partials); operations 21 per
//   (row, own box) and 7 per (row, own interval). With the smoke run's
//   batches the operations bound it: the kernel is instruction-bound, so
//   the design cuts instructions per (row, box):
//   - each query's own slots only: the (Qg, 2) counts table (boxes,
//     intervals; zscan.stack_queries) bounds the loops, so the padded
//     slots of a batch cost nothing (they still hold NaN / impossible
//     bounds, so a loop over every slot gives the same bits);
//   - eight consecutive rows per thread, loaded as 16-byte vectors: each
//     table word read from shared memory and each loop step serves eight
//     rows;
//   - the box test in two steps. Where a row's hi words equal none of a
//     box's four hi bounds, the two-float test is the strict compare of
//     the hi words alone: four compares per (row, box), beside the four
//     equality compares that the candidate bitmap needs anyway. Only a
//     thread with a candidate row (hi on a bound's hi cell: about four
//     rows per bound at 100M uniform rows) runs the full two-float test,
//     loading the lo columns then; the others never read them;
//   - the interval test as two signed 64-bit compares of (day, ms ^
//     0x80000000) keys, whose order is the lexicographic (day, ms) order
//     of signed words on every input; a thread whose rows hit no box
//     skips its intervals;
//   - no warp-collective operation per row: a thread writes its byte of
//     each query's hit and candidate words into shared memory (2 Qg x 64
//     words for the block's 2048 rows), and the block then stores each
//     query's run of 64 words with 16-byte stores, four threads per run,
//     so every sector is written whole; the per-block popcounts
//     (partials, not atomics, so counts and ids are deterministic) come
//     from the staged words;
//   - blocks past n are no work: they store zero words and zero partials
//     without loading a row;
//   - a grid of as many blocks as fit on the card at once, each walking
//     the 2048-row blocks with a stride, so each stages the tables once.
//   SASS (cuobjdump -sass, ptxas -v: 107 registers, no spills): the box
//   loop is 93 instructions per box for a thread's 8 rows, 11.6 per (row,
//   own box): 64 FSETP, 16 SEL and 8 LOP3 that pack the verdicts into
//   bits, one 16-byte shared load of the hi bounds and 4 of loop; the
//   interval loop (unrolled by 4) 5.8 per (row, own interval). With about
//   5 more per (row, query) of per-query work, the kernel issues some 720
//   instructions per row for the smoke run's 32 queries, nearly all
//   compares, selects and logic at 64 lanes per clock per SM: 720 x 1e8
//   rows / (132 SMs x 64 x 1.98 GHz) = 4.3 ms, as measured. That issue
//   rate, not the memory, bounds it (PERF.md).
//   Outputs: bits uint32 [2, Qp, words], words = ceil(cap / 32), bit j of
//   word w is row 32w + j, rows >= n zero; partials int32 [2, Qp, nb],
//   nb = ceil(words / 64). Kind 0 is hits, kind 1 candidates.
//
// compact_prefix_kernel: for each (kind, query) row of partials, the
// exclusive prefix of its nb partials as int32 offsets within the query
// (a query's ids are < cap < 2^31) and the row's total as int64. One
// block per row; 16 partials per thread, a warp scan and a block scan.
// Bound: bytes (partials read, offsets and totals written). A third of
// it at 32 queries and 100M rows: the 64 blocks leave half the SMs idle
// and each walks its row's tiles one after another, load, scan, store;
// the same partials as 256 rows take 0.74x the time (PERF.md).
//
// compact_bits_kernel: each query's ascending row ids from the bitmaps,
// in one flat int32 buffer per kind, query after query. A query's int64
// base within its kind is the prefix of the totals (the sum over queries
// can pass 2^31), which a warp sums from the totals on the device when
// it meets the query (one load a lane and five shuffles up to 32
// queries). A warp takes 32 (kind, query, block) pairs at a time, strided
// over the grid so that dense queries spread over every warp, reads
// their 32 partials with one load and skips the empty ones; for each
// non-empty pair it reads the block's 64 words (two per lane), scans
// their popcounts across the warp, and each lane writes its set bits'
// rows from its place in the block's run. Four other designs measured
// slower or no faster (PERF.md): a loop over the non-zero words, uniform
// across the warp, in which lane l wrote bit l's row at base +
// popc(word & lanemask_lt) (1.7x slower at 100M rows: a serial chain of
// shuffles per word); staging each block's ids in shared memory to store
// 32 consecutive ids at a time (no faster than the lanes' own stores);
// issuing the next non-empty pair's loads before the current pair's
// stores (no faster); and one contiguous range of pairs per warp (3.3x
// slower: a dense query's pairs fell to a few warps). Where the time
// goes (kernel_ab.py's probe of this walk, 100M rows): the loads alone
// half, forming the ids a fifth, storing them the rest. Ids ascend
// within each query with no atomics in device memory. Bound: bytes =
// partials read + the offset and words of each non-empty block + 4 B
// per id written (an empty block's words and offset are never read).
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;  // 2048
constexpr int kWordsPerBlock = kRowsPerBlock / 32;        // 64
constexpr int kMaxGroup = 32;                             // queries per launch
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kMaxBlocks = 132 * 16;
constexpr int kPrefixThreads = 1024;
constexpr int kPrefixPerThread = 16;
constexpr int kPrefixTile = kPrefixThreads * kPrefixPerThread;
constexpr unsigned kFull = 0xffffffffu;

struct Cols {
  const float* xhi;
  const float* xlo;
  const float* yhi;
  const float* ylo;
  const int32_t* tday;
  const int32_t* tms;
};

// Shared memory of one launch: the staged words [2][qg][64] u32, the
// boxes' hi bounds [qg][k] float4, the boxes [qg][k][8] f32, the interval
// keys [qg][b][2] i64 and the counts [qg] int2. Every part is a multiple
// of 16 bytes but the last.
constexpr size_t batch_smem(int qg, int k, int b) {
  return static_cast<size_t>(qg) *
         (2 * kWordsPerBlock * 4 + k * 4 * 4 + k * 8 * 4 + b * 2 * 8 + 2 * 4);
}

__device__ __forceinline__ bool ge2(float hi, float lo, float bhi, float blo) {
  return (hi > bhi) | ((hi == bhi) & (lo >= blo));
}

__device__ __forceinline__ bool le2(float hi, float lo, float bhi, float blo) {
  return (hi < bhi) | ((hi == bhi) & (lo <= blo));
}

// (day, ms) as one signed 64-bit key: day in the high word, ms with its
// sign bit flipped in the low word, so the unsigned low word orders as
// the signed ms and the key orders as the pair.
__device__ __forceinline__ long long time_key(int32_t day, int32_t ms) {
  const unsigned long long hi = static_cast<uint32_t>(day);
  return static_cast<long long>(
      (hi << 32) | (static_cast<uint32_t>(ms) ^ 0x80000000u));
}

// Rows i .. i+7 of a column: two 16-byte loads when all are below n,
// else element loads with zeros from n on.
__device__ __forceinline__ void load8(const float* __restrict__ col,
                                      int64_t i, int64_t n, float (&v)[8]) {
  if (i + kRowsPerThread <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(col + i));
    const float4 b = __ldg(reinterpret_cast<const float4*>(col + i) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      v[r] = i + r < n ? __ldg(col + i + r) : 0.f;
  }
}

__device__ __forceinline__ void load8(const int32_t* __restrict__ col,
                                      int64_t i, int64_t n, int32_t (&v)[8]) {
  if (i + kRowsPerThread <= n) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(col + i));
    const int4 b = __ldg(reinterpret_cast<const int4*>(col + i) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      v[r] = i + r < n ? __ldg(col + i + r) : 0;
  }
}

// Eight rows against one query: bit r of hit / cand is row r's verdict.
// hi: the query's boxes as (xmin_hi, xmax_hi, ymin_hi, ymax_hi), nbox of
// them; bx: the same boxes' full 8 floats (16-byte aligned); iv: its
// interval keys (lo, hi), niv of them.
__device__ __forceinline__ void rows_query(
    const Cols& c, int64_t i, int64_t n, const float (&xh)[8],
    const float (&yh)[8], const long long (&key)[8], const float4* hi,
    const float* bx, int nbox, const long long* iv, int niv, uint32_t& hit,
    uint32_t& cand) {
  uint32_t s = 0, on = 0;
  for (int j = 0; j < nbox; ++j) {
    const float4 h = hi[j];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      // strict on the hi words: the two-float test wherever no hi word
      // equals a bound's hi word
      if ((xh[r] > h.x) & (xh[r] < h.y) & (yh[r] > h.z) & (yh[r] < h.w))
        s |= 1u << r;
      if ((xh[r] == h.x) | (xh[r] == h.y) | (yh[r] == h.z) | (yh[r] == h.w))
        on |= 1u << r;
    }
  }
  if (on) {
    // a row on a bound's hi cell, where the lo words decide: the full
    // two-float test for the thread's rows
    float xl[kRowsPerThread], yl[kRowsPerThread];
    load8(c.xlo, i, n, xl);
    load8(c.ylo, i, n, yl);
    s = 0;
    for (int j = 0; j < nbox; ++j) {
      const float4 bxl = *reinterpret_cast<const float4*>(bx + 8 * j);
      const float4 byl = *reinterpret_cast<const float4*>(bx + 8 * j + 4);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        if (ge2(xh[r], xl[r], bxl.x, bxl.y) & le2(xh[r], xl[r], bxl.z, bxl.w) &
            ge2(yh[r], yl[r], byl.x, byl.y) & le2(yh[r], yl[r], byl.z, byl.w))
          s |= 1u << r;
    }
  }
  uint32_t t = 0;
  if (s) {
    for (int j = 0; j < niv; ++j) {
      const long long lo = iv[2 * j], up = iv[2 * j + 1];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        if ((key[r] >= lo) & (key[r] <= up)) t |= 1u << r;
    }
  }
  hit = s & t;
  cand = on;
}

// bits and partials point at the group's first query; a kind's block
// follows the other at kind_bits / kind_parts elements. vec: the bitmap
// rows are 16-byte aligned (words % 4 == 0).
__global__ void __launch_bounds__(kThreads)
    scan_batch_bits_kernel(Cols c, int64_t n, int64_t words, int64_t nb,
                           const float* __restrict__ boxes,
                           const int32_t* __restrict__ times,
                           const int32_t* __restrict__ counts, int qg, int k,
                           int b, uint32_t* __restrict__ bits,
                           int64_t kind_bits, int32_t* __restrict__ partials,
                           int64_t kind_parts, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  float4* s_hi = reinterpret_cast<float4*>(s_words + 2 * qg * kWordsPerBlock);
  float* s_boxes = reinterpret_cast<float*>(s_hi + qg * k);
  long long* s_iv = reinterpret_cast<long long*>(s_boxes + qg * k * 8);
  int2* s_cnt = reinterpret_cast<int2*>(s_iv + qg * b * 2);
  for (int j = threadIdx.x; j < qg * k * 8; j += kThreads)
    s_boxes[j] = boxes[j];
  for (int j = threadIdx.x; j < qg * k; j += kThreads)
    s_hi[j] = make_float4(boxes[8 * j], boxes[8 * j + 2], boxes[8 * j + 4],
                          boxes[8 * j + 6]);
  for (int j = threadIdx.x; j < qg * b; j += kThreads) {
    s_iv[2 * j] = time_key(times[4 * j], times[4 * j + 1]);
    s_iv[2 * j + 1] = time_key(times[4 * j + 2], times[4 * j + 3]);
  }
  for (int j = threadIdx.x; j < qg; j += kThreads)
    s_cnt[j] = make_int2(min(max(counts[2 * j], 0), k),
                         min(max(counts[2 * j + 1], 0), b));
  __syncthreads();

  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_words);
  const int t = threadIdx.x;
  const int run = t >> 2, part = t & 3;  // store phase: 4 threads per run
  const int64_t live_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  for (int64_t blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    const bool live = blk < live_blocks;  // uniform across the block
    if (live) {
      // byte t of each staged run: rows 8t .. 8t+7 of the block
      const int64_t i = blk * kRowsPerBlock + t * kRowsPerThread;
      if (i < n) {
        float xh[kRowsPerThread], yh[kRowsPerThread];
        int32_t td[kRowsPerThread], tm[kRowsPerThread];
        load8(c.xhi, i, n, xh);
        load8(c.yhi, i, n, yh);
        load8(c.tday, i, n, td);
        load8(c.tms, i, n, tm);
        long long key[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) key[r] = time_key(td[r], tm[r]);
        const float4* q_hi = s_hi;
        const float* q_box = s_boxes;
        const long long* q_iv = s_iv;
        uint8_t* out = s_bytes + t;
        for (int q = 0; q < qg; ++q) {
          const int2 cnt = s_cnt[q];
          uint32_t hit, cand;
          rows_query(c, i, n, xh, yh, key, q_hi, q_box, cnt.x, q_iv, cnt.y,
                     hit, cand);
          out[0] = static_cast<uint8_t>(hit);
          out[qg * kWordsPerBlock * 4] = static_cast<uint8_t>(cand);
          q_hi += k;
          q_box += 8 * k;
          q_iv += 2 * b;
          out += kWordsPerBlock * 4;
        }
        if (n - i < kRowsPerThread) {  // the thread that holds row n - 1
          const uint8_t mask = static_cast<uint8_t>((1u << (n - i)) - 1u);
          for (int q = 0; q < 2 * qg; ++q) s_bytes[q * kWordsPerBlock * 4 + t] &= mask;
        }
      } else {
        for (int q = 0; q < 2 * qg; ++q) s_bytes[q * kWordsPerBlock * 4 + t] = 0;
      }
      __syncthreads();
    }
    // each (kind, query) run of 64 words: 16 vectors, thread `part` of
    // the run's four takes vectors part, part + 4, ..., so one store
    // instruction writes 64 contiguous bytes of each run
    int pop = 0;
    int kind = 0, q = 0;
    if (run < 2 * qg) {
      kind = run >= qg;
      q = run - kind * qg;
      const uint4* src = reinterpret_cast<const uint4*>(s_words) +
                         run * (kWordsPerBlock / 4);
      uint32_t* dst = bits + kind * kind_bits + q * words + blk * kWordsPerBlock;
      const int64_t room = words - blk * kWordsPerBlock;
#pragma unroll
      for (int v = part; v < kWordsPerBlock / 4; v += 4) {
        const uint4 w = live ? src[v] : make_uint4(0u, 0u, 0u, 0u);
        pop += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
        if (vec) {
          if (4 * v < room) *reinterpret_cast<uint4*>(dst + 4 * v) = w;
        } else {
          const uint32_t e[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * v + j < room) dst[4 * v + j] = e[j];
        }
      }
    }
    pop += __shfl_xor_sync(kFull, pop, 1);
    pop += __shfl_xor_sync(kFull, pop, 2);
    if (run < 2 * qg && part == 0)
      partials[kind * kind_parts + q * nb + blk] = pop;
    __syncthreads();  // the staged words are rewritten by the next block
  }
}

// One block per (kind, query) row of partials (nb each).
__global__ void __launch_bounds__(kPrefixThreads)
    compact_prefix_kernel(const int32_t* __restrict__ partials, int64_t nb,
                          int32_t* __restrict__ offsets,
                          int64_t* __restrict__ totals) {
  __shared__ int32_t s_warp[kPrefixThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* in = partials + blockIdx.x * nb;
  int32_t* out = offsets + blockIdx.x * nb;
  const bool vec = nb % 4 == 0;  // rows 16-byte aligned
  int32_t carry = 0;
  for (int64_t base = 0; base < nb; base += kPrefixTile) {
    const int64_t j0 = base + threadIdx.x * kPrefixPerThread;
    int32_t v[kPrefixPerThread];
    if (vec && j0 + kPrefixPerThread <= nb) {
#pragma unroll
      for (int e = 0; e < kPrefixPerThread / 4; ++e) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(in + j0) + e);
        v[4 * e] = a.x; v[4 * e + 1] = a.y; v[4 * e + 2] = a.z; v[4 * e + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPrefixPerThread; ++e)
        v[e] = j0 + e < nb ? __ldg(in + j0 + e) : 0;
    }
    int32_t sum = 0;
#pragma unroll
    for (int e = 0; e < kPrefixPerThread; ++e) {
      const int32_t x = v[e];
      v[e] = sum;
      sum += x;
    }
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = s_warp[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, w, off);
        if (lane >= off) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int32_t before = carry + (warp ? s_warp[warp - 1] : 0) + incl - sum;
    if (vec && j0 + kPrefixPerThread <= nb) {
#pragma unroll
      for (int e = 0; e < kPrefixPerThread / 4; ++e)
        reinterpret_cast<int4*>(out + j0)[e] =
            make_int4(v[4 * e] + before, v[4 * e + 1] + before,
                      v[4 * e + 2] + before, v[4 * e + 3] + before);
    } else {
#pragma unroll
      for (int e = 0; e < kPrefixPerThread; ++e)
        if (j0 + e < nb) out[j0 + e] = v[e] + before;
    }
    carry += s_warp[31];
    __syncthreads();  // s_warp is rewritten by the next tile
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The sum of totals[row0 .. row0 + q - 1], over the warp.
__device__ __forceinline__ long long warp_sum(const int64_t* __restrict__ totals,
                                              int64_t row0, int64_t q,
                                              int lane) {
  long long s = 0;
  for (int64_t j = lane; j < q; j += 32) s += totals[row0 + j];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

// Pairs p = (kind * qp + q) * nb + j, the flat index of partials and
// offsets; block j of query q covers words j*64 .. j*64+63 of its row.
__global__ void __launch_bounds__(kThreads)
    compact_bits_kernel(const uint32_t* __restrict__ bits,
                        const int32_t* __restrict__ partials,
                        const int32_t* __restrict__ offsets,
                        const int64_t* __restrict__ totals, int qp,
                        int64_t nb, int64_t words,
                        int32_t* __restrict__ out_hit,
                        int32_t* __restrict__ out_cand) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  int64_t row = -1;     // the (kind * qp + q) whose base the warp holds
  long long base = 0;   // its first id's index in its kind's buffer
  for (int64_t p0 = warp * 32; p0 < pairs; p0 += warps * 32) {
    const int64_t p = p0 + lane;
    const int32_t cnt = p < pairs ? partials[p] : 0;
    uint32_t todo = __ballot_sync(kFull, cnt != 0);
    const int64_t r0 = p0 / nb;  // the row of the chunk's first pair
    while (todo) {  // uniform across the warp
      const int64_t pp = p0 + (__ffs(todo) - 1);
      todo &= todo - 1;
      int64_t r = r0, j = pp - r0 * nb;
      while (j >= nb) {  // one step at most unless nb < 32
        ++r;
        j -= nb;
      }
      const int kind = r >= qp;
      if (r != row) {
        row = r;
        base = warp_sum(totals, kind * static_cast<int64_t>(qp),
                        r - kind * qp, lane);
      }
      // lane l: words 2l and 2l + 1 of the block
      const int64_t w0 = j * kWordsPerBlock + 2 * lane;
      const uint32_t* src = bits + r * words;
      const uint32_t a0 = w0 < words ? src[w0] : 0u;
      const uint32_t a1 = w0 + 1 < words ? src[w0 + 1] : 0u;
      const int mine = __popc(a0) + __popc(a1);
      int incl = mine;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      // each lane's ids in row order, from its place in the block's run
      int32_t* out = (kind ? out_cand : out_hit) + base + offsets[pp];
      int k = incl - mine;
      const int32_t r0w = static_cast<int32_t>(w0 * 32);
      for (uint32_t m = a0; m; m &= m - 1) out[k++] = r0w + __ffs(m) - 1;
      for (uint32_t m = a1; m; m &= m - 1) out[k++] = r0w + 32 + __ffs(m) - 1;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

}  // namespace

extern "C" {

int geomesa_batch_rows_per_block() { return kRowsPerBlock; }

int geomesa_batch_max_group() { return kMaxGroup; }

long long geomesa_batch_smem_bytes(int qg, int k, int b) {
  return static_cast<long long>(batch_smem(qg, k, b));
}

// Bitmaps and partials of queries q0 .. q0+qg-1 (the pointers are at q0):
// bits[kind][q][w] for w < words, partials[kind][q][j] for j < nb =
// ceil(words / 64); a query's row is `words` (bits) or `nb` (partials)
// elements long, a kind `kind_bits` or `kind_parts`. boxes (qg, k, 8),
// times (qg, b, 4) and counts (qg, 2), contiguous; columns 16-byte
// aligned. Requires 1 <= qg <= 32, words > 0 and batch_smem(qg, k, b)
// within 48 KB.
int geomesa_scan_batch_bits(const float* xhi, const float* xlo,
                            const float* yhi, const float* ylo,
                            const int32_t* tday, const int32_t* tms,
                            int64_t n, int64_t words, const float* boxes,
                            const int32_t* times, const int32_t* counts,
                            int qg, int k, int b, uint32_t* bits,
                            int64_t kind_bits, int32_t* partials,
                            int64_t kind_parts, void* stream) {
  const int64_t nb = (words + kWordsPerBlock - 1) / kWordsPerBlock;
  const size_t smem = batch_smem(qg, k, b);
  if (counts == nullptr || qg < 1 || qg > kMaxGroup || k < 1 || b < 1 ||
      nb < 1 || nb > INT_MAX || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_batch_bits_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fit = static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = nb < fit || fit < 1 ? nb : fit;
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(bits) % 16 == 0 &&
                   kind_bits % 4 == 0;
  Cols c{xhi, xlo, yhi, ylo, tday, tms};
  scan_batch_bits_kernel<<<static_cast<int>(grid), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      c, n, words, nb, boxes, times, counts, qg, k, b, bits, kind_bits,
      partials, kind_parts, vec);
  return static_cast<int>(cudaGetLastError());
}

// offsets[r][j] = partials[r][0] + ... + partials[r][j-1] (int32) and
// totals[r] = the row's sum (int64), for the rows r < `rows` of nb
// partials each. Requires rows >= 1 and nb >= 1.
int geomesa_compact_prefix(const int32_t* partials, int rows, int64_t nb,
                           int32_t* offsets, int64_t* totals, void* stream) {
  if (rows < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  compact_prefix_kernel<<<rows, kPrefixThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partials, nb, offsets, totals);
  return static_cast<int>(cudaGetLastError());
}

// Ids of every query of both kinds: out_hit / out_cand hold the rows of
// query 0, then query 1, ..., each ascending; block j of query q of a
// kind starts at the sum of the kind's totals of queries < q plus
// offsets[(kind * qp + q) * nb + j] (compact_prefix's outputs). Requires
// qp * nb > 0.
int geomesa_compact_bits(const uint32_t* bits, const int32_t* partials,
                         const int32_t* offsets, const int64_t* totals,
                         int qp, int64_t nb, int64_t words, int32_t* out_hit,
                         int32_t* out_cand, void* stream) {
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  const int64_t chunks = (pairs + 31) / 32;
  int64_t blocks = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  compact_bits_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      bits, partials, offsets, totals, qp, nb, words, out_hit, out_cand);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
