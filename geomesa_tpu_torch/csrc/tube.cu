// Tube kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/analytics/tube.py:_tube_kernel
// (:85, driven by tube_select_mask :104): the device half of tube select
// (TubeSelectProcess), whose tube is K (box, time interval) pairs built
// from a track on the host (TubeBuilder). Per row of the point columns:
//   match = OR over i of (box_i holds (x, y)) AND (interval_i holds t)
// the pairs' AND ORed, not the scan's cross product of boxes and
// intervals. The box test is the scan's lexicographic two-float compare,
// both edges inclusive: (xhi, xlo) >= (xmin_hi, xmin_lo) and <= (xmax_hi,
// xmax_lo), the same on y. The time test is the same compare on (day,
// ms), made on one int64 key, day * 2^32 + (ms + 2^31), whose order is
// exactly the lexicographic (day, ms) order for any int32 words. Every
// step compares stored f32 words or exact integer keys, with no
// arithmetic on the floats, so the mask equals the plain PyTorch version
// (kernels.tube_mask_plain) bit for bit; a NaN coordinate compares false
// in both. Build WITHOUT --use_fast_math or -ftz=true (a flushed
// subnormal lo word would compare as 0).
//
// The pairs. The pairs that can hold key t are, once sorted by their
// interval's lo key with the running max of the hi keys (pm), those at or
// before the last lo <= t, back to the first whose pm >= t: exact for any
// table, unsorted, overlapping or inverted (empty) intervals included.
// The wrapper takes the stable argsort of the lo keys (torch.argsort);
// the first launch, one block, writes each pair as a 64-byte record [pm,
// hi, lo, 0, box] in that order (kernels.tube_pairs is its plain
// version). The wrapper counts both launches.
//
// Design. Nearly every (row, pair) is rejected by its time test, and most
// rows by their time alone, so the mask kernel splits a row's work in two
// and gives each half whole warps:
//   - A persistent grid (blocks by the occupancy query; 2 an SM while the
//     staged pairs leave room, else 1), 512 threads a block, walks tiles
//     of 2,048 rows. A thread's 4 consecutive rows' time words are two
//     16-byte loads (word by word where tday or tms is not 16-byte
//     aligned, as a view may not be), started a tile ahead into registers
//     (no shared ring: the 32 KB it would take keep two blocks an SM for
//     1,000 pairs).
//   - Each block stages the first 2,048 pairs once, in dynamic shared
//     memory, split for the walk: a 32-bit coarse rank of pm and of hi
//     (8 B; monotone, so only equal ranks read the exact keys), the box's
//     hi words (16 B; they decide the box test unless a row's hi word
//     equals one, then the lo words, 16 B), the exact {pm, hi} and lo.
//     Pairs past the 2,048 are read from their records through __ldg (one
//     cache line a record): a table is never staged twice.
//   - The block builds a time-bucket index there: 2^b buckets (b from K,
//     at most 12, given by the wrapper: kernels.tube_bucket_bits) over the spread of the keys, day * 86,400,000 + ms
//     clamped to the day (a monotone map: buckets over the raw keys would
//     leave most of each 2^32-wide day empty and put a day's 24 hourly
//     pairs in one bucket), of width 2^shift, the least shift that fits
//     [lo_min, pm_max]; per bucket the first pair whose lo falls in it and
//     one bit for "some interval with lo <= hi reaches this bucket" (a
//     difference array and a block scan). Every block builds it: torch ops
//     in the wrapper would need the span on the host, a wait.
//   - Time pass: a row outside [lo_min, pm_max] or in a bucket no interval
//     reaches is rejected; the tile's verdict bytes are stored as 0 (one
//     4-byte store a thread), and the candidates' time keys and rows are
//     appended to a list in shared memory in row order (a __ballot_sync
//     and __popc a row, warp totals through shared memory, one barrier a
//     tile). The list spans tiles: it is worked once it might not hold
//     another tile, and at the block's end, so a sparse tube's few
//     candidates a tile do not each pay a round trip to device memory.
//   - Candidate pass: thread i takes list entries i, i + 512, ... four at
//     a time and starts their coordinate loads together; where the list
//     holds under one candidate in 8 rows (most of a column's 32-byte
//     sectors then hold one at most), xhi alone, and xlo, yhi, ylo only
//     once xhi lies within a pair's [xmin_hi, xmax_hi]. Then each reads
//     its bucket's two index entries, binary searches the pairs between
//     them for the last lo <= t (none to a few steps), and walks back
//     while pm >= t, testing hi >= t and the box, out at the first match;
//     a match stores the row's byte (ordered after the tile's 0 by the
//     barriers). Every active lane works on a real candidate; lanes differ
//     only in their walks. Rows past n are neither read nor written.
//
// Bound: the bytes this call's rows need, 8 B of time words a row, 16 B
// of coordinates a row whose time some pair's interval holds, 1 B
// written (chip_smoke.py counts them from the rows and the tables); the
// operations that count take far less. The time pass alone runs within
// 13-15 % of a probe that only streams the time words (kernel_ab.py,
// about 90 % of 3.35 TB/s). What holds the rest, on the H100: the
// candidates' coordinates are random 32-byte sector reads (a sparse
// tube: xhi-first cuts them to one sector a candidate), and where nearly
// every row is a candidate, the walk's shared-memory reads, whose
// addresses differ from lane to lane (bank conflicts), and the walks'
// unequal lengths within a warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long ll;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                    // consecutive rows a thread
constexpr int kTileBits = 11;
constexpr int kTile = 1 << kTileBits;       // rows a tile: kThreads * kRows
constexpr int kStageCap = 2048;             // pairs staged in shared memory
constexpr int kMaxBucketBits = 12;          // at most 4,096 buckets
constexpr int kPer = ((1 << kMaxBucketBits) + kThreads) / kThreads;
constexpr int kRec = 8;                     // int64 words of a pair's record
constexpr unsigned kReached = 0x80000000u;  // an index entry's bit
// dynamic shared memory of a block, two blocks an SM or one
constexpr int kTwoBlockBytes = 110 * 1024;
constexpr int kOneBlockBytes = 224 * 1024;
constexpr int kMaxList = 12288;             // candidates a list holds
static_assert(kTile == kThreads * kRows, "a tile is 4 rows a thread");

__device__ __forceinline__ bool ge2(float hi, float lo, float bhi,
                                    float blo) {
  return (hi > bhi) | ((hi == bhi) & (lo >= blo));
}

__device__ __forceinline__ bool le2(float hi, float lo, float bhi,
                                    float blo) {
  return (hi < bhi) | ((hi == bhi) & (lo <= blo));
}

__device__ __forceinline__ ll time_key(int day, int ms) {
  return static_cast<ll>(day) * 4294967296LL +
         (static_cast<ll>(ms) + 2147483648LL);
}

// A monotone map of a key onto about epoch millis, day * 86,400,000 +
// ms clamped to a day: two keys share a spread only within one day, where
// their ms are equal or clamp to the same end, so the buckets below
// spread over the days' millis and not over the key's 2^32-wide days,
// most of whose keys no (day, ms) of a real millis takes. |result| < 2^58.
__device__ __forceinline__ ll spread(int day, int ms) {
  const int c = ms < 0 ? 0 : ms > 86399999 ? 86399999 : ms;
  return static_cast<ll>(day) * 86400000LL + c;
}

__device__ __forceinline__ ll spread_key(ll key) {
  return spread(static_cast<int>(key >> 32),
                static_cast<int>((key & 0xffffffffLL) - 2147483648LL));
}

// this thread's 4 rows of a tile's time words, as two 16-byte loads that
// do not stay in L1 where both columns are 16-byte aligned (vec), else word
// by word (rows past n read as 0 and are never used)
__device__ __forceinline__ void load_words(const int* tday, const int* tms,
                                           int64_t tile, int64_t n, bool vec,
                                           int4& d, int4& m) {
  const int64_t row = tile * kTile + kRows * threadIdx.x;
  if (vec && row + kRows <= n) {
    d = __ldcs(reinterpret_cast<const int4*>(tday + row));
    m = __ldcs(reinterpret_cast<const int4*>(tms + row));
  } else {
    int w[2 * kRows] = {};
    for (int r = 0; r < kRows && row + r < n; ++r) {
      w[r] = tday[row + r];
      w[kRows + r] = tms[row + r];
    }
    d = int4{w[0], w[1], w[2], w[3]};
    m = int4{w[4], w[5], w[6], w[7]};
  }
}

// A key's coarse rank, (spread - base) >> shift clamped at 0, in 32 bits
// for every key up to pm_max: monotone, so a smaller rank is a smaller
// key, and only equal ranks need the keys themselves.
struct Coarse {
  ll base;
  int shift;
  __device__ __forceinline__ unsigned of(ll key) const {
    const ll d = (spread_key(key) - base) >> shift;
    return d > 0 ? static_cast<unsigned>(d) : 0u;
  }
};

// The pairs: the first `staged` in shared memory, the rest read from their
// 64-byte records [pm, hi, lo, 0, box (8 f32)] in global memory, so one
// record's words share a cache line. Staged, a pair is split for the
// walk: {coarse pm, coarse hi} (8 B), the box's hi words {xmin, xmax,
// ymin, ymax} (16 B), which decide the box test unless a row's hi word
// equals one, then its lo words, the exact {pm, hi} and lo. kAll: every
// pair is staged (k <= kStageCap), and no read goes to global: the walk's
// reads skip the i < staged test. It pays on a dense tube: 2.146-2.156 ms
// for the kernel alone against 2.314-2.333 for one body for every K
// (kernel_ab.py --tube-only, 1,000 pairs, 100M rows, NVIDIA H100 80GB HBM3
// at 700 W); sparse and year-long within 1 %.
template <bool kAll>
struct Pairs {
  const float4* s_bh;
  const float4* s_bl;
  const longlong2* s_ph;
  const uint2* s_c;
  const ll* s_lo;
  const ll* g;
  int staged;
  __device__ __forceinline__ bool near(int i) const {
    return kAll || i < staged;
  }
  __device__ __forceinline__ ll lo(int i) const {
    if (near(i)) return s_lo[i];
    return __ldg(g + kRec * i + 2);
  }
  __device__ __forceinline__ ll hi(int i) const {
    if (near(i)) return s_ph[i].y;
    return __ldg(g + kRec * i + 1);
  }
};

// The time buckets: a key whose spread is s >= base (the least lo's)
// lies in bucket (s - base) >> shift, clamped to nb. The map from keys to
// buckets is monotone, which is all the index needs.
struct Buckets {
  ll base;
  int shift;
  int nb;
  __device__ __forceinline__ int of_spread(ll s) const {
    const ll b = (s - base) >> shift;
    return b < nb ? static_cast<int>(b) : nb;
  }
  __device__ __forceinline__ int of(ll key) const {
    return of_spread(spread_key(key));
  }
};

// exclusive sum over the block of v; every thread must call it
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += o;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
  }
  __syncthreads();
  const int out = s_warp[warp] + incl - v;
  __syncthreads();  // s_warp may be reused
  return out;
}

// Entry j of the index (j = 0..nb): the number of pairs whose lo lies in
// a bucket before j, ORed with kReached where some interval with lo <= hi
// reaches bucket j (j < nb).
template <bool kAll>
__device__ void build_index(const Pairs<kAll>& p, int k, const Buckets& bk,
                            unsigned* s_index, int* s_warp) {
  const int nb = bk.nb;
  for (int j = threadIdx.x; j <= nb; j += kThreads) s_index[j] = 0u;
  __syncthreads();
  int* diff = reinterpret_cast<int*>(s_index);
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const ll lo = p.lo(i), hi = p.hi(i);
    if (lo <= hi) {  // lo_min <= lo <= hi <= pm_max: both buckets < nb
      atomicAdd(diff + bk.of(lo), 1);
      atomicAdd(diff + bk.of(hi) + 1, -1);
    }
  }
  __syncthreads();
  // the running sum of the differences: how many intervals reach bucket j
  const int per = (nb + kThreads) / kThreads;  // entries 0..nb, <= kPer
  const int j0 = threadIdx.x * per;
  int reach[kPer];
  int sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = j0 + e;
    if (e < per && j <= nb) sum += diff[j];
    reach[e] = sum;
  }
  const int before = block_exclusive_sum(sum, s_warp);  // diff read by all
  // the first pair of each bucket: pair i is the first of buckets
  // (bucket(lo[i-1]), bucket(lo[i])], and k of those after the last's
  for (int i = threadIdx.x; i <= k; i += kThreads) {
    const int from = i == 0 ? 0 : bk.of(p.lo(i - 1)) + 1;
    const int to = i == k ? nb : bk.of(p.lo(i));
    for (int j = from; j <= to; ++j) s_index[j] = static_cast<unsigned>(i);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = j0 + e;
    if (e < per && j < nb && before + reach[e] > 0) s_index[j] |= kReached;
  }
  __syncthreads();
}

// The candidate pass over the list's first `count` entries: entry e is
// the row of offset e & (kTile - 1) in the block's tile e >> kTileBits,
// with its time key. Each thread takes up to kRows entries at a time and
// starts their first coordinate loads together; a match writes the row's
// byte. kLazy (a list of under one candidate in 8 rows, so most of a
// column's 32-byte sectors hold one candidate at most): xhi alone first,
// and xlo, yhi, ylo only once xhi lies within a pair's [xmin_hi,
// xmax_hi], which the two-float test needs; else all four at once.
template <bool kAll, bool kLazy>
__device__ __forceinline__ void work_list(
    int count, const ll* s_key, const unsigned* s_row, const Pairs<kAll>& p,
    const Buckets& bk, const Coarse& co, const unsigned* s_index, const float* xhi,
    const float* xlo, const float* yhi, const float* ylo,
    unsigned char* out) {
  for (int base = 0; base < count; base += kRows * kThreads) {
    int64_t row[kRows];
    float xh[kRows], xl[kRows], yh[kRows], yl[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int slot = base + threadIdx.x + q * kThreads;
      row[q] = -1;
      if (slot < count) {
        const unsigned e = s_row[slot];
        row[q] = (blockIdx.x + static_cast<int64_t>(e >> kTileBits) *
                                   gridDim.x) * kTile + (e & (kTile - 1));
        xh[q] = __ldg(xhi + row[q]);
        if (!kLazy) {
          xl[q] = __ldg(xlo + row[q]);
          yh[q] = __ldg(yhi + row[q]);
          yl[q] = __ldg(ylo + row[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      if (row[q] < 0) continue;
      const ll t = s_key[base + threadIdx.x + q * kThreads];
      const int j = bk.of(t);
      // the pairs of bucket j: lo <= t before a, lo > t from b
      int a = static_cast<int>(s_index[j] & ~kReached);
      int b = static_cast<int>(s_index[j + 1] & ~kReached);
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (p.lo(mid) <= t) a = mid + 1; else b = mid;
      }
      bool have = !kLazy;
      const unsigned ct = co.of(t);
      // back from the last lo <= t while the running max of hi reaches t
      for (int i = a - 1; i >= 0; --i) {
        if (p.near(i)) {
          const uint2 c = p.s_c[i];
          if (c.x < ct || (c.x == ct && p.s_ph[i].x < t)) break;
          if (c.y < ct || (c.y == ct && p.s_ph[i].y < t)) continue;
          const float4 h = p.s_bh[i];
          if (kLazy) {
            if (xh[q] < h.x || xh[q] > h.y) continue;  // NaN goes on
            if (!have) {
              xl[q] = __ldg(xlo + row[q]);
              yh[q] = __ldg(yhi + row[q]);
              yl[q] = __ldg(ylo + row[q]);
              have = true;
            }
          }
          // the hi words decide, unless one equals the row's (NaN: out)
          if (!(xh[q] >= h.x && xh[q] <= h.y && yh[q] >= h.z &&
                yh[q] <= h.w))
            continue;
          bool in = xh[q] > h.x && xh[q] < h.y && yh[q] > h.z && yh[q] < h.w;
          if (!in) {
            const float4 l = p.s_bl[i];
            in = ge2(xh[q], xl[q], h.x, l.x) & le2(xh[q], xl[q], h.y, l.y) &
                 ge2(yh[q], yl[q], h.z, l.z) & le2(yh[q], yl[q], h.w, l.w);
          }
          if (in) {
            out[row[q]] = 1;
            break;
          }
          continue;
        }
        const ll* r = p.g + kRec * i;
        const longlong2 ph = __ldg(reinterpret_cast<const longlong2*>(r));
        if (ph.x < t) break;
        if (ph.y < t) continue;
        const float4 bx = __ldg(reinterpret_cast<const float4*>(r + 4));
        if (kLazy) {
          if (xh[q] < bx.x || xh[q] > bx.z) continue;  // NaN goes on
          if (!have) {
            xl[q] = __ldg(xlo + row[q]);
            yh[q] = __ldg(yhi + row[q]);
            yl[q] = __ldg(ylo + row[q]);
            have = true;
          }
        }
        const float4 by = __ldg(reinterpret_cast<const float4*>(r + 4) + 1);
        if (ge2(xh[q], xl[q], bx.x, bx.y) & le2(xh[q], xl[q], bx.z, bx.w) &
            ge2(yh[q], yl[q], by.x, by.y) & le2(yh[q], yl[q], by.z, by.w)) {
          out[row[q]] = 1;
          break;
        }
      }
    }
  }
}

template <bool kAll>
__global__ void __launch_bounds__(kThreads, 2)
tube_mask_kernel(const float* __restrict__ xhi, const float* __restrict__ xlo,
                 const float* __restrict__ yhi, const float* __restrict__ ylo,
                 const int* __restrict__ tday, const int* __restrict__ tms,
                 int64_t n, bool vec, const ll* __restrict__ pairs, int k,
                 int bucket_bits, int list_cap,
                 unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wtot[2][kWarps];
  __shared__ int s_warp[kWarps];
  const int staged = k < kStageCap ? k : kStageCap;
  const int nb = 1 << bucket_bits;
  float4* s_bh = reinterpret_cast<float4*>(smem);
  float4* s_bl = s_bh + staged;
  longlong2* s_ph = reinterpret_cast<longlong2*>(s_bl + staged);
  uint2* s_c = reinterpret_cast<uint2*>(s_ph + staged);
  ll* s_lo = reinterpret_cast<ll*>(s_c + staged);
  unsigned* s_index = reinterpret_cast<unsigned*>(s_lo + staged);
  ll* s_key = reinterpret_cast<ll*>(s_index + ((nb + 2) & ~1));
  unsigned* s_row = reinterpret_cast<unsigned*>(s_key + list_cap);

  const int64_t ntiles = (n + kTile - 1) / kTile;
  // the first tile's words are in flight while the pairs are staged
  int4 nd = {0, 0, 0, 0}, nm = {0, 0, 0, 0};
  if (blockIdx.x < ntiles) load_words(tday, tms, blockIdx.x, n, vec, nd, nm);
  const ll lo_min = __ldg(pairs + 2), top = __ldg(pairs + kRec * (k - 1));
  // every interval is empty when the largest hi is below the least lo
  const bool any = top >= lo_min;
  // the buckets: the least shift that puts every spread up to pm_max's
  // below nb; the coarse ranks: the least that fits them in 32 bits
  Buckets bk{spread_key(lo_min), 0, nb};
  Coarse co{bk.base, 0};
  if (any) {
    const ll span = spread_key(top) - bk.base;
    const int width = span ? 64 - __clzll(span) : 0;
    bk.shift = width > bucket_bits ? width - bucket_bits : 0;
    co.shift = width > 32 ? width - 32 : 0;
  }
  for (int i = threadIdx.x; i < staged; i += kThreads) {
    const ll* r = pairs + kRec * i;
    const longlong2 ph = *reinterpret_cast<const longlong2*>(r);
    const float4 bx = reinterpret_cast<const float4*>(r + 4)[0];
    const float4 by = reinterpret_cast<const float4*>(r + 4)[1];
    s_ph[i] = ph;
    s_c[i] = uint2{co.of(ph.x), co.of(ph.y)};
    s_lo[i] = r[2];
    s_bh[i] = float4{bx.x, bx.z, by.x, by.z};
    s_bl[i] = float4{bx.y, bx.w, by.y, by.w};
  }
  __syncthreads();
  const Pairs<kAll> p{s_bh, s_bl, s_ph, s_c, s_lo, pairs, staged};
  build_index(p, k, bk, s_index, s_warp);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_before = (1u << lane) - 1u;
  int count = 0;  // the list's entries, the same in every thread
  int spanned = 0;  // rows of the tiles the list's entries come from
  unsigned seq = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles;
       tile += gridDim.x, ++seq) {
    const int4 d4 = nd, m4 = nm;
    const int64_t next = tile + gridDim.x;
    if (next < ntiles) load_words(tday, tms, next, n, vec, nd, nm);
    // time pass: this thread's 4 rows
    const int days[kRows] = {d4.x, d4.y, d4.z, d4.w};
    const int mss[kRows] = {m4.x, m4.y, m4.z, m4.w};
    const int64_t row0 = tile * kTile + kRows * threadIdx.x;
    ll key[kRows];
    unsigned cand = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      key[r] = time_key(days[r], mss[r]);
      if (row0 + r < n && any && key[r] >= lo_min && key[r] <= top &&
          (s_index[bk.of_spread(spread(days[r], mss[r]))] & kReached))
        cand |= 1u << r;
    }
    // every verdict 0 for now; the candidate pass writes the matches
    if (row0 + kRows <= n) {
      *reinterpret_cast<unsigned*>(out + row0) = 0u;
    } else {
      for (int r = 0; r < kRows && row0 + r < n; ++r) out[row0 + r] = 0;
    }
    // pack the candidates after the list's entries, in row order
    int before = 0, total = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned b = __ballot_sync(0xffffffffu, (cand >> r) & 1u);
      before += __popc(b & lanes_before);
      total += __popc(b);
    }
    const int par = seq & 1u;
    if (lane == 0) s_wtot[par][warp] = total;
    __syncthreads();
    int at = count + before, tile_total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int v = s_wtot[par][w];
      at += w < warp ? v : 0;
      tile_total += v;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if ((cand >> r) & 1u) {
        s_key[at] = key[r];
        s_row[at] = (seq << kTileBits) | (kRows * threadIdx.x + r);
        ++at;
      }
    count += tile_total;
    spanned += kTile;
    // work the list once it might not hold another tile, and at the end
    if (count > list_cap - kTile || tile + gridDim.x >= ntiles) {
      if (count) {
        __syncthreads();
        if (count * 8 < spanned)
          work_list<kAll, true>(count, s_key, s_row, p, bk, co, s_index, xhi,
                                xlo, yhi, ylo, out);
        else
          work_list<kAll, false>(count, s_key, s_row, p, bk, co, s_index, xhi,
                                 xlo, yhi, ylo, out);
      }
      count = 0;  // the list's next writes come after the next barrier
      spanned = 0;
    }
  }
}

// The pairs' records in their sorted order, one block: position p takes
// pair order[p] (the wrapper's stable argsort of the lo keys), its lo and
// hi keys, its box, and the running max of hi over positions 0..p.
constexpr int kPrepThreads = 1024;

__global__ void __launch_bounds__(kPrepThreads)
tube_records_kernel(const int4* __restrict__ times,
                    const float4* __restrict__ boxes,
                    const ll* __restrict__ order, int k,
                    ll* __restrict__ rec) {
  __shared__ ll s_max[kPrepThreads / 32];
  constexpr ll kLeast = -9223372036854775807LL - 1;
  const int per = (k + kPrepThreads - 1) / kPrepThreads;
  const int p0 = threadIdx.x * per;
  const int p1 = p0 + per < k ? p0 + per : k;
  ll run = kLeast;
  for (int q = p0; q < p1; ++q) {
    const ll i = order[q];
    const int4 t = times[i];
    const ll hi = time_key(t.z, t.w);
    run = hi > run ? hi : run;
    ll* r = rec + kRec * q;
    r[1] = hi;
    r[2] = time_key(t.x, t.y);
    r[3] = 0;
    reinterpret_cast<float4*>(r + 4)[0] = boxes[2 * i];
    reinterpret_cast<float4*>(r + 4)[1] = boxes[2 * i + 1];
  }
  // the largest hi of the threads before this one
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ll incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const ll o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d && o > incl) incl = o;
  }
  if (lane == 31) s_max[warp] = incl;
  __syncthreads();
  ll before = kLeast;
  for (int w = 0; w < warp; ++w) before = s_max[w] > before ? s_max[w] : before;
  ll m = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0 || m < before) m = before;
  for (int q = p0; q < p1; ++q) {
    ll* r = rec + kRec * q;
    m = r[1] > m ? r[1] : m;
    r[0] = m;
  }
}

// the shared memory of the staged pairs and the index
int smem_base(int staged, int nb) {
  return staged * 64 + ((nb + 2) & ~1) * 4;
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

// The launch for K pairs and 2^bits buckets: plan[0] pairs staged, [1]
// the list's capacity, [2] dynamic shared memory bytes, [3] blocks an SM.
// The list takes what two blocks an SM leave, while it holds at least a
// tile and a half; else the block takes the SM. The last plan is kept (a
// tube's calls repeat their K), so a repeated call makes no occupancy
// query.
template <bool kAll>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      tube_mask_kernel<kAll>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOneBlockBytes);
  return err;
}

cudaError_t plan_for(int k, int bits, int* plan) {
  const bool all = k <= kStageCap;
  const cudaError_t in = all ? opt_in<true>() : opt_in<false>();
  if (in != cudaSuccess) return in;
  thread_local int last_k = 0, last_bits = 0, last[4];
  if (k == last_k && bits == last_bits) {
    for (int i = 0; i < 4; ++i) plan[i] = last[i];
    return cudaSuccess;
  }
  const int staged = all ? k : kStageCap;
  const int base = smem_base(staged, 1 << bits);
  int cap = (kTwoBlockBytes - base) / 12;
  if (cap < kTile + kTile / 2) cap = (kOneBlockBytes - base) / 12;
  cap = (cap < kMaxList ? cap : kMaxList) & ~3;
  const int smem = base + cap * 12;
  int per_sm = 0;
  const cudaError_t err =
      all ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, tube_mask_kernel<true>, kThreads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, tube_mask_kernel<false>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan[0] = staged;
  plan[1] = cap;
  plan[2] = smem;
  plan[3] = per_sm;
  for (int i = 0; i < 4; ++i) last[i] = plan[i];
  last_k = k;
  last_bits = bits;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out[i] for the n rows (bool) against k >= 1 pairs in 2^bucket_bits time
// buckets (1 <= bucket_bits <= kMaxBucketBits; kernels.tube_bucket_bits):
// times (k, 4) int32 and boxes (k, 8) f32 as given, order int64[k] the
// stable argsort of their lo keys, rec int64 (k, 8) the records' room, all
// 16-byte aligned; out 4-byte aligned; tday and tms are read as 16-byte
// vectors where both are 16-byte aligned, else word by word. Two
// launches: the records (kernels.tube_pairs' tables as [pm, hi, lo, 0,
// box]), then the mask. Requires n > 0.
int geomesa_tube_mask(const float* xhi, const float* xlo, const float* yhi,
                      const float* ylo, const int32_t* tday,
                      const int32_t* tms, int64_t n, const int32_t* times,
                      const float* boxes, const int64_t* order, int64_t* rec,
                      int k, int bucket_bits, bool* out, void* stream) {
  const int sms = sm_count();
  if (n < 1 || k < 1 || sms < 1 || bucket_bits < 1 ||
      bucket_bits > kMaxBucketBits)
    return static_cast<int>(cudaErrorInvalidValue);
  int plan[4];
  const cudaError_t err = plan_for(k, bucket_bits, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tube_records_kernel<<<1, kPrepThreads, 0, s>>>(
      reinterpret_cast<const int4*>(times),
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const ll*>(order), k, reinterpret_cast<ll*>(rec));
  const cudaError_t prep = cudaGetLastError();
  if (prep != cudaSuccess) return static_cast<int>(prep);
  const bool vec = ((reinterpret_cast<uintptr_t>(tday) |
                     reinterpret_cast<uintptr_t>(tms)) & 15) == 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = static_cast<int64_t>(sms) * plan[3];
  const int blocks = static_cast<int>(tiles < cap ? tiles : cap);
  const ll* r = reinterpret_cast<const ll*>(rec);
  unsigned char* o = reinterpret_cast<unsigned char*>(out);
  if (k <= kStageCap)
    tube_mask_kernel<true><<<blocks, kThreads, plan[2], s>>>(
        xhi, xlo, yhi, ylo, tday, tms, n, vec, r, k, bucket_bits, plan[1], o);
  else
    tube_mask_kernel<false><<<blocks, kThreads, plan[2], s>>>(
        xhi, xlo, yhi, ylo, tday, tms, n, vec, r, k, bucket_bits, plan[1], o);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's constants: 0 the pairs staged in shared memory, 1 rows a
// tile, 2 the most bucket bits.
int geomesa_tube_constant(int which) {
  if (which == 0) return kStageCap;
  if (which == 1) return kTile;
  if (which == 2) return kMaxBucketBits;
  return -1;
}

}  // extern "C"
