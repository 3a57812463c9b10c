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
// (a query's ids are < cap < 2^31) and the row's total as int64. Bound:
// bytes (partials read, offsets and totals written). One pass over
// fixed tiles of kPrefixTile = 4096 partials (256 threads, four 16-byte
// vectors a thread, striped so that each warp's load or store covers 512
// contiguous bytes; the warp scans its 512 partials as four chunks of
// 128), the grid rows x tiles-per-row, so every SM holds several tiles
// and their loads are in flight together (1,024 blocks at 32 queries and
// 100M rows). Within a row the tiles chain by a decoupled look-back:
// each tile sums its partials, publishes its aggregate in a 64-bit
// status word, and warp 0 walks back over the row's earlier tiles 32 at
// a time until it meets a published inclusive prefix; the tile then
// publishes its own inclusive prefix and stores its offsets, and the
// row's last tile writes the total. A tile
// takes its index from a ticket counter, so it only ever waits on tiles
// that were scheduled before it. The status words and the counter live
// in a scratch buffer that the wrapper keeps per device and stream,
// zeroed once when it is made: each launch carries an epoch that its
// status words hold beside their flag (a word of another epoch reads as
// not yet published), and the ticket base that the earlier launches on
// the buffer used up, so no launch needs a memset. Measured against it
// (kernel_ab.py --prefix-only, NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// the first design, one 1,024-thread block per row walking its row's
// tiles in turn (64 blocks at 32 queries: half the SMs idle), 0.029 ms at
// 100M rows against 0.016; a cooperative launch with one grid-wide
// barrier between the tiles' sums and their stores, 0.023 ms (and it
// needs every tile resident); and these tiles with each thread's 16
// partials contiguous (its four vectors side by side), 0.032 ms: each
// of the warp's loads and stores then spans 2 KB in 16-byte pieces.
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
constexpr int kPrefixThreads = 256;
constexpr int kPrefixVecs = 4;  // 16-byte vectors a thread
constexpr int kPrefixTile = kPrefixThreads * kPrefixVecs * 4;  // 4096
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

// A look-back status word: the high word holds (epoch << 1) | inclusive,
// the low word the value (an aggregate, or an inclusive prefix within the
// row). A zeroed word belongs to no launch (epochs start at 1).
__device__ __forceinline__ unsigned long long status_word(uint32_t epoch,
                                                          bool inclusive,
                                                          int32_t value) {
  return (static_cast<unsigned long long>((epoch << 1) | (inclusive ? 1u : 0u))
          << 32) |
         static_cast<uint32_t>(value);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The sum of the row's tiles before tile j, by warp 0 of tile j > 0:
// lane l reads the status of tile j - 1 - l (- 32 per step), the warp
// waits until all 32 are published in this epoch, adds the aggregates up
// to and including the nearest inclusive prefix, and stops there. Tile 0
// of a row publishes its inclusive prefix without waiting, so the walk
// ends at the latest there.
__device__ int32_t look_back(const unsigned long long* status, int j,
                             uint32_t epoch, int lane) {
  int32_t prefix = 0;
  for (int k = j - 1;; k -= 32) {
    const int p = k - lane;
    unsigned long long s;
    bool ready;
    do {
      s = p >= 0 ? load_status(status + p) : status_word(epoch, true, 0);
      ready = static_cast<uint32_t>(s >> 33) == epoch;
    } while (!__all_sync(kFull, ready));
    const uint32_t incl = __ballot_sync(kFull, (s >> 32) & 1u);
    const int first = incl ? __ffs(incl) - 1 : 31;
    int32_t v = lane <= first ? static_cast<int32_t>(static_cast<uint32_t>(s)) : 0;
#pragma unroll
    for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    prefix += v;
    if (incl) return prefix;
  }
}

// One block per tile of kPrefixTile partials; tiles_per_row tiles per
// (kind, query) row of nb partials. scratch[0] is the ticket counter,
// scratch[1 + t] tile t's status word; base is the counter's value when
// this launch began, epoch this launch's. vec_rows: every row of
// partials and offsets is 16-byte aligned.
__global__ void __launch_bounds__(kPrefixThreads)
    compact_prefix_kernel(const int32_t* __restrict__ partials, int64_t nb,
                          int tiles_per_row, int32_t* __restrict__ offsets,
                          int64_t* __restrict__ totals,
                          unsigned long long* __restrict__ scratch,
                          unsigned long long base, uint32_t epoch,
                          bool vec_rows) {
  __shared__ int32_t s_warp[kPrefixThreads / 32];
  __shared__ int s_tile;
  __shared__ int32_t s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = static_cast<int>(atomicAdd(scratch, 1ull) - base);
  __syncthreads();
  const int tile = s_tile;
  const int row = tile / tiles_per_row, j = tile - row * tiles_per_row;
  const int32_t* in = partials + static_cast<int64_t>(row) * nb;
  int32_t* out = offsets + static_cast<int64_t>(row) * nb;
  // warp w's 512 partials of the tile in four chunks of 128: chunk e is
  // one 16-byte vector a lane, lane l at its chunk's 4 * l
  const int64_t w0 = static_cast<int64_t>(j) * kPrefixTile + warp * 512 + lane * 4;
  int32_t v[kPrefixVecs][4];
#pragma unroll
  for (int e = 0; e < kPrefixVecs; ++e) {
    const int64_t i = w0 + e * 128;
    if (vec_rows && i + 4 <= nb) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(in + i));
      v[e][0] = a.x; v[e][1] = a.y; v[e][2] = a.z; v[e][3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[e][k] = i + k < nb ? __ldg(in + i + k) : 0;
    }
  }
  // exclusive prefix of each value within the warp's 512
  int32_t chunk = 0;
#pragma unroll
  for (int e = 0; e < kPrefixVecs; ++e) {
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t x = v[e][k];
      v[e][k] = sum;
      sum += x;
    }
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int32_t lead = chunk + incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[e][k] += lead;
    chunk += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_warp[warp] = chunk;
  __syncthreads();
  int32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < kPrefixThreads / 32; ++w) {
    const int32_t s = s_warp[w];
    before += w < warp ? s : 0;
    agg += s;
  }
  if (warp == 0) {
    unsigned long long* status = scratch + 1 + static_cast<int64_t>(row) * tiles_per_row;
    int32_t prefix = 0;
    if (j == 0) {
      if (lane == 0) store_status(status, status_word(epoch, true, agg));
    } else {
      if (lane == 0) store_status(status + j, status_word(epoch, false, agg));
      prefix = look_back(status, j, epoch, lane);
      if (lane == 0)
        store_status(status + j, status_word(epoch, true, prefix + agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int32_t prefix = s_prefix;
  const int32_t first = prefix + before;
#pragma unroll
  for (int e = 0; e < kPrefixVecs; ++e) {
    const int64_t i = w0 + e * 128;
    if (vec_rows && i + 4 <= nb) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(v[e][0] + first, v[e][1] + first, v[e][2] + first,
                    v[e][3] + first);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < nb) out[i + k] = v[e][k] + first;
    }
  }
  if (threadIdx.x == 0 && j == tiles_per_row - 1) totals[row] = prefix + agg;
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

int geomesa_prefix_tile() { return kPrefixTile; }

// offsets[r][j] = partials[r][0] + ... + partials[r][j-1] (int32) and
// totals[r] = the row's sum (int64), for the rows r < `rows` of nb
// partials each. scratch: 1 + rows * ceil(nb / kPrefixTile) words of a
// buffer that was zeroed when made and is used by one stream; base: the
// tickets that earlier launches on it took (their tile counts summed);
// epoch: 1 + the number of earlier launches on it, below 2^31. Requires
// rows >= 1 and nb >= 1.
int geomesa_compact_prefix(const int32_t* partials, int rows, int64_t nb,
                           int32_t* offsets, int64_t* totals,
                           unsigned long long* scratch,
                           unsigned long long base, unsigned int epoch,
                           void* stream) {
  if (rows < 1 || nb < 1 || scratch == nullptr || epoch == 0 ||
      epoch >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_row = (nb + kPrefixTile - 1) / kPrefixTile;
  const int64_t tiles = per_row * rows;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_rows = nb % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(partials) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(offsets) % 16 == 0;
  compact_prefix_kernel<<<static_cast<int>(tiles), kPrefixThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      partials, nb, static_cast<int>(per_row), offsets, totals, scratch, base,
      epoch, vec_rows);
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
