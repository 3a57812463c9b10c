// Standing-filter kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/scan/standing.py:_standing_mask
// (:130, a vmap over the filter axis of the rectangle predicate): the
// device half of the continuous-query matcher, which holds every ingest
// batch against the whole registered filter population. For each filter
// slot f < F and each chunk row r < chunk, bit (f, r) is set when all of
// these hold:
//   alive[f] and r < n_valid;
//   box_any[f], or one of f's box_valid boxes holds the row under the
//     lexicographic two-float >= / <= of zscan._ge_two_float and
//     _le_two_float (xhi, xlo) against (xmin_hi, xmin_lo) .. (xmax_hi,
//     xmax_lo), and the same on y;
//   the row's (day, ms) lies in times[f] (inclusive, lexicographic);
//   each attribute a is attr_any[f, a], or its two-float value lies in
//     attrs[f, a] = (lo_hi, lo_lo, hi_hi, hi_lo).
// Every step is a compare of stored f32 or i32 words, so the bits equal
// the plain PyTorch version (kernels.standing_bits_plain) bit for bit; a
// NaN coordinate or attribute fails every constrained compare, as in XLA.
// Build WITHOUT --use_fast_math or -ftz=true (subnormal words must
// compare as numbers).
//
// Output layout: the bitmaps of the batched scan (csrc/batch.cu), so that
// compact_prefix and compact_bits turn them into filter-major,
// row-ascending ids with per-filter counts (the order the JAX
// _flat_nonzero yields): bits uint32 [2, F, words], words = ceil(chunk /
// 32), bit j of word w is row 32w + j; partials int32 [2, F, nb], nb =
// ceil(words / 64), the popcount of each 2,048-row block. The kernel
// writes kind 0 only; the caller keeps kind 1 zero.
//
// Design. A block takes a 2,048-row tile of the chunk (one partial) and
// 128 filter slots, 16 per warp; it stages the tile's six row columns in
// shared memory (48 KB), and each warp works its slots over them. Lane l
// holds the rows 32j + l of the tile (j < 64) as bits of two registers:
// it first sets the rows that pass the row bound and the time interval,
// clears those that fail an attribute bound (attributes are read
// attribute-major from device memory, 32 consecutive rows a load), and
// then, unless the slot is box_any, keeps those inside one of its boxes,
// the box's eight bounds loaded once for the warp and held in registers
// over the lane's 64 rows. A warp whose lanes hold no row past the time
// and attribute tests skips the boxes. A ballot of bit j over the lanes is
// word j of the tile, which lane j keeps, so each warp stores 32
// consecutive words at once, and a warp sum of their popcounts is the
// partial. Dead slots (tombstoned, or never) store zero words without
// testing a row. A tile's second half is skipped where the chunk ends in
// its first half (a 1,024-row chunk costs half a tile).
//   Bound (chip_smoke.py's standing_bound_ms): operations. Per (live
// slot, row < n_valid): 6 for the time test, 4 per constrained attribute
// (two-float compares of the hi words with an equality fall-through),
// and per valid box 4 two-float compares of 3 operations each and 3 to
// combine them (15); each row word read once and each bit written once
// make the bytes, which are an order of magnitude less. With config 15's
// K = 1 and one attribute that is about 25 operations a (slot, row), the
// figure PERF.md uses for J3 at 33.5 T/s. A filter-side spatial grid,
// testing only the slots whose box covers a row's cell, is owed work
// (ROADMAP.md).
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 2048;                    // one partial
constexpr int kTileWords = kTileRows / 32;         // 64
constexpr int kSlotsPerBlock = 128;
constexpr int kSmem = 6 * kTileRows * 4;           // 48 KB
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const float* xhi;
  const float* xlo;
  const float* yhi;
  const float* ylo;
  const int32_t* tday;
  const int32_t* tms;
  const float* avhi;   // [a][astride], attribute-major
  const float* avlo;
  int64_t astride;
  int a;
  int64_t chunk;
  int64_t n_valid;
};

struct Tables {
  const float4* boxes;       // [f][k][2] float4: x bounds, y bounds
  const uint8_t* box_valid;  // [f][k]
  const uint8_t* box_any;    // [f]
  const int4* times;         // [f]
  const float4* attrs;       // [f][a]
  const uint8_t* attr_any;   // [f][a]
  const uint8_t* alive;      // [f]
  int f;
  int k;
};

__device__ __forceinline__ bool ge2(float h, float l, float bh, float bl) {
  return (h > bh) | ((h == bh) & (l >= bl));
}

__device__ __forceinline__ bool le2(float h, float l, float bh, float bl) {
  return (h < bh) | ((h == bh) & (l <= bl));
}

// The lane's verdicts for the 32 rows 32 * (32 * half + j) + lane of the
// tile, as bit j of the result.
template <int kHalf>
__device__ __forceinline__ uint32_t time_bits(const int32_t* sday,
                                              const int32_t* sms, int nloc,
                                              int lane, int4 t) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = 32 * (32 * kHalf + j) + lane;
    const int d = sday[r], ms = sms[r];
    const bool after = (d > t.x) | ((d == t.x) & (ms >= t.y));
    const bool before = (d < t.z) | ((d == t.z) & (ms <= t.w));
    m |= static_cast<uint32_t>((r < nloc) & after & before) << j;
  }
  return m;
}

template <int kHalf>
__device__ __forceinline__ uint32_t attr_bits(uint32_t m, const float* vh,
                                              const float* vl, int lane,
                                              float4 b) {
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    if (m >> j & 1u) {
      const int r = 32 * (32 * kHalf + j) + lane;
      const float h = vh[r], l = vl[r];
      if (!(ge2(h, l, b.x, b.y) & le2(h, l, b.z, b.w)))
        m &= ~(1u << j);
    }
  }
  return m;
}

template <int kHalf>
__device__ __forceinline__ uint32_t box_bits(const float* sxh,
                                             const float* sxl,
                                             const float* syh,
                                             const float* syl, int lane,
                                             float4 bx, float4 by) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = 32 * (32 * kHalf + j) + lane;
    const float xh = sxh[r], xl = sxl[r], yh = syh[r], yl = syl[r];
    const bool in = ge2(xh, xl, bx.x, bx.y) & le2(xh, xl, bx.z, bx.w) &
                    ge2(yh, yl, by.x, by.y) & le2(yh, yl, by.z, by.w);
    m |= static_cast<uint32_t>(in) << j;
  }
  return m;
}

// Word j of a half tile is the ballot of bit j over the lanes; lane j
// keeps it.
__device__ __forceinline__ uint32_t ballot_words(uint32_t m, int lane) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t b = __ballot_sync(kFull, (m >> j) & 1u);
    if (lane == j) w = b;
  }
  return w;
}

__global__ void __launch_bounds__(kThreads)
    standing_bits_kernel(Rows rows, Tables tab, int64_t words, int64_t nb,
                         uint32_t* bits, int32_t* partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sxh = reinterpret_cast<float*>(smem);
  float* sxl = sxh + kTileRows;
  float* syh = sxl + kTileRows;
  float* syl = syh + kTileRows;
  int32_t* sday = reinterpret_cast<int32_t*>(syl + kTileRows);
  int32_t* sms = sday + kTileRows;

  const int64_t tile = blockIdx.y;
  const int64_t base = tile * kTileRows;
  const int64_t left = rows.chunk - base;
  const int tile_rows = static_cast<int>(left < kTileRows ? left : kTileRows);
  const int64_t valid_left = rows.n_valid - base;
  const int nloc = static_cast<int>(
      valid_left < 0 ? 0 : (valid_left < kTileRows ? valid_left : kTileRows));

  for (int r = threadIdx.x; r < kTileRows; r += kThreads) {
    const bool in = r < tile_rows;
    const int64_t g = base + r;
    sxh[r] = in ? rows.xhi[g] : 0.0f;
    sxl[r] = in ? rows.xlo[g] : 0.0f;
    syh[r] = in ? rows.yhi[g] : 0.0f;
    syl[r] = in ? rows.ylo[g] : 0.0f;
    sday[r] = in ? rows.tday[g] : 0;
    sms[r] = in ? rows.tms[g] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool two_halves = tile_rows > kTileRows / 2;
  const int64_t word0 = tile * kTileWords;
  const int slot_end =
      min(tab.f, static_cast<int>(blockIdx.x) * kSlotsPerBlock + kSlotsPerBlock);

  for (int f = blockIdx.x * kSlotsPerBlock + warp; f < slot_end; f += kWarps) {
    uint32_t m0 = 0, m1 = 0;
    if (tab.alive[f] && nloc > 0) {
      const int4 t = tab.times[f];
      m0 = time_bits<0>(sday, sms, nloc, lane, t);
      if (two_halves) m1 = time_bits<1>(sday, sms, nloc, lane, t);
      for (int a = 0; a < rows.a; ++a) {
        if (tab.attr_any[static_cast<int64_t>(f) * rows.a + a]) continue;
        const float4 b = tab.attrs[static_cast<int64_t>(f) * rows.a + a];
        const float* vh = rows.avhi + a * rows.astride + base;
        const float* vl = rows.avlo + a * rows.astride + base;
        m0 = attr_bits<0>(m0, vh, vl, lane, b);
        if (two_halves) m1 = attr_bits<1>(m1, vh, vl, lane, b);
      }
      if (!tab.box_any[f] && __any_sync(kFull, (m0 | m1) != 0u)) {
        uint32_t s0 = 0, s1 = 0;
        const int64_t fk = static_cast<int64_t>(f) * tab.k;
        for (int k = 0; k < tab.k; ++k) {
          if (!tab.box_valid[fk + k]) continue;
          const float4 bx = tab.boxes[(fk + k) * 2];
          const float4 by = tab.boxes[(fk + k) * 2 + 1];
          s0 |= box_bits<0>(sxh, sxl, syh, syl, lane, bx, by);
          if (two_halves) s1 |= box_bits<1>(sxh, sxl, syh, syl, lane, bx, by);
        }
        m0 &= s0;
        m1 &= s1;
      }
    }
    const uint32_t w0 = ballot_words(m0, lane);
    const uint32_t w1 = two_halves ? ballot_words(m1, lane) : 0u;
    uint32_t* out = bits + static_cast<int64_t>(f) * words + word0;
    if (word0 + lane < words) out[lane] = w0;
    if (word0 + 32 + lane < words) out[32 + lane] = w1;
    const int count = __reduce_add_sync(kFull, __popc(w0) + __popc(w1));
    if (lane == 0) partials[static_cast<int64_t>(f) * nb + tile] = count;
  }
}

}  // namespace

extern "C" {

int geomesa_standing_tile_rows() { return kTileRows; }

// Kind 0 of bits [2, f, words] and partials [2, f, nb] for one chunk of
// `chunk` rows, rows >= n_valid zero. avhi/avlo are [a][astride] views
// (a may be 0, then they are not read). boxes, times and attrs must be
// 16-byte aligned. Requires chunk >= 1, 0 <= n_valid <= chunk, f >= 1,
// k >= 1 and at most 65,535 tiles.
int geomesa_standing_bits(const float* xhi, const float* xlo,
                          const float* yhi, const float* ylo,
                          const int32_t* tday, const int32_t* tms,
                          const float* avhi, const float* avlo,
                          int64_t astride, int a, int64_t chunk,
                          int64_t n_valid, const float* boxes,
                          const uint8_t* box_valid, const uint8_t* box_any,
                          const int32_t* times, const float* attrs,
                          const uint8_t* attr_any, const uint8_t* alive,
                          int f, int k, uint32_t* bits, int32_t* partials,
                          void* stream) {
  const int64_t words = (chunk + 31) / 32;
  const int64_t nb = (words + kTileWords - 1) / kTileWords;
  if (chunk < 1 || n_valid < 0 || n_valid > chunk || f < 1 || k < 1 ||
      a < 0 || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Rows rows{xhi, xlo, yhi, ylo, tday, tms, avhi, avlo, astride, a, chunk,
            n_valid};
  Tables tab{reinterpret_cast<const float4*>(boxes), box_valid, box_any,
             reinterpret_cast<const int4*>(times),
             reinterpret_cast<const float4*>(attrs), attr_any, alive, f, k};
  const dim3 grid(static_cast<unsigned>((f + kSlotsPerBlock - 1) /
                                        kSlotsPerBlock),
                  static_cast<unsigned>(nb));
  standing_bits_kernel<<<grid, kThreads, kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, tab, words, nb, bits, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
