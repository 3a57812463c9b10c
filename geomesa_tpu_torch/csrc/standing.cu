// Standing-filter kernels for Hopper (sm_90a): a slot grid and
// filter-major (slot, row) pairs.
//
// Replace the XLA programs geomesa_tpu/scan/standing.py:_standing_mask
// (:130, a vmap over the filter axis of the rectangle predicate),
// _mask_total (:165) and _flat_nonzero (:170): the device half of the
// continuous-query matcher, which holds every ingest batch against the
// whole registered filter population and hands the host each slot's
// candidate rows, slot-major and row-ascending. Slot f matches row r when
// all of these hold:
//   alive[f] and r < n_valid;
//   box_any[f], or one of f's box_valid boxes holds the row under the
//     lexicographic two-float >= / <= of zscan._ge_two_float and
//     _le_two_float (xhi, xlo) against (xmin_hi, xmin_lo) .. (xmax_hi,
//     xmax_lo), and the same on y;
//   the row's (day, ms) lies in times[f] (inclusive, lexicographic);
//   each attribute a is attr_any[f, a], or its two-float value lies in
//     attrs[f, a] = (lo_hi, lo_lo, hi_hi, hi_lo).
// Every step is a compare of stored f32 or i32 words, so the pairs equal
// the plain PyTorch version (kernels.standing_*_plain) pair for pair; a
// NaN coordinate or attribute fails every constrained compare, as in XLA.
// Build WITHOUT --use_fast_math or -ftz=true (subnormal words must
// compare as numbers).
//
// Design. The all-pairs kernel this replaces tested every live slot
// against every row (1e11 pairs for a 1M-row batch at 100k geofences, of
// which 12M match) and wrote a bitmap a chunk that a compaction then
// walked. Here a slot grid on the card sends each row to the few slots
// whose boxes reach its cell:
//   grid_count_kernel (a thread a slot) gives each slot a mode: nowhere
//     (dead, never, or no box it could pass), grid (listed once in each
//     cell one of its boxes reaches; a cell an earlier box of the slot
//     already reached is skipped, so a (slot, row) pair is tested and
//     written once) or everywhere (box_any, or boxes reaching more than
//     kMaxSlotCells cells); it counts each cell's slots and lists the
//     everywhere slots. scan_kernel (one block) turns the counts into
//     each cell's start, and grid_fill_kernel writes the cell lists.
//   match_kernel<false> (a launch a chunk) counts each slot's hits: a
//     warp a row works the slots of the row's cell, a lane a slot; a warp
//     an everywhere slot streams the chunk's rows 32 at a time. Counts
//     accumulate over the chunks on the card; scan_kernel gives each
//     slot's segment of the pairs (its one total is the dispatch's sync).
//   match_kernel<true> (a launch a chunk) writes each hit row into its
//     slot's segment: a grid lane at an atomic cursor, an everywhere warp
//     by ballots in row order, so an everywhere segment comes out
//     ascending (the chunks run in stream order).
//   sort_kernel (a block a slot) orders each grid segment ascending, out
//     of place: a bitonic sort in shared memory up to kSortTile ids, a
//     bitmap of the ids' range in windows of kSortTile words beyond.
//
// Why the grid never drops a pair. A cell is (floor(x_hi + 180),
// floor(y_hi + 90)) of the f32 hi words, each clamped to the grid, so a
// coordinate outside +/-180, +/-90 falls into an edge cell. f32 addition
// and floor are monotone, so cell(a) <= cell(b) whenever a <= b. The
// two-float xmin <= x implies xmin_hi <= x_hi (the lo words decide only
// on equal hi words), so a row inside a box lies in a cell between the
// cells of the box's hi bounds, and the box lists its slot there. A box
// with a NaN hi bound holds no row and reaches no cell; a row with a NaN
// hi coordinate passes no box and belongs to no cell (only the
// everywhere slots see it). The grid may let through pairs that fail,
// which the full test then drops.
//
// Resolution: 1-degree cells, 360 x 180. Config 15's geofences are 1-5
// degrees wide, so a box reaches about 16 cells and a row about 25 slots
// at 100k filters, against about 12 matches; finer cells shrink that
// little (the box's own area dominates) for several times the entries.
// kMaxSlotCells = 1,024 (a box about 32 degrees wide) bounds the grid
// to 4 KiB a slot; a wider slot is tested against every row instead.
//
// Bound (chip_smoke.py's standing_bounds): per chunk, the bytes of the
// rows (24 B, 8 B an attribute), the cell bounds they read (8 B), the
// grid lists they read (4 B a candidate) and the hits counted or
// written (4 B), or the operations of the candidate pairs tested (15 a
// valid box, 6 a bounded interval, 4 a bounded attribute); the larger.
// The all-pairs yardstick of the kernel this replaces is printed beside.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGridX = 360;
constexpr int kGridY = 180;
constexpr int kCells = kGridX * kGridY;
constexpr int kMaxSlotCells = 1024;
constexpr int kScanThreads = 1024;
constexpr int kScanPerThread = 8;   // two int4 of the tile
constexpr int kSortThreads = 128;
constexpr int kSortTile = 4096;                    // ids, or bitmap words
constexpr unsigned kFull = 0xffffffffu;

enum : uint8_t { kNowhere = 0, kGrid = 1, kEverywhere = 2 };

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

struct Grid {
  const uint8_t* mode;        // [f]
  const int32_t* cell_start;  // [kCells + 1]
  const int32_t* cell_slots;  // [entries]
  const int32_t* every;       // [n_every]
  int n_every;
};

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

__device__ __forceinline__ bool ge2(float h, float l, float bh, float bl) {
  return (h > bh) | ((h == bh) & (l >= bl));
}

__device__ __forceinline__ bool le2(float h, float l, float bh, float bl) {
  return (h < bh) | ((h == bh) & (l <= bl));
}

// The grid's one cell function, on a hi word that is not NaN.
__device__ __forceinline__ int cell_of(float h, float origin, int size) {
  const float v = floorf(__fadd_rn(h, origin));
  return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(size - 1)));
}

struct Range {
  int x0, x1, y0, y1;
  __device__ int cells() const { return (x1 - x0 + 1) * (y1 - y0 + 1); }
  __device__ bool holds(int cx, int cy) const {
    return cx >= x0 && cx <= x1 && cy >= y0 && cy <= y1;
  }
};

// Box k of slot f's cells; false when the box holds no row (invalid, a
// NaN hi bound, or hi bounds inverted past a cell).
__device__ bool box_range(const Tables& tab, int64_t fk, int k, Range& r) {
  if (!tab.box_valid[fk + k]) return false;
  const float4 bx = tab.boxes[(fk + k) * 2];
  const float4 by = tab.boxes[(fk + k) * 2 + 1];
  if (is_nan(bx.x) || is_nan(bx.z) || is_nan(by.x) || is_nan(by.z))
    return false;
  r.x0 = cell_of(bx.x, 180.0f, kGridX);
  r.x1 = cell_of(bx.z, 180.0f, kGridX);
  r.y0 = cell_of(by.x, 90.0f, kGridY);
  r.y1 = cell_of(by.z, 90.0f, kGridY);
  return r.x0 <= r.x1 && r.y0 <= r.y1;
}

// Whether an earlier box (< k) of the slot reaches cell (cx, cy).
__device__ bool reached_before(const Tables& tab, int64_t fk, int k, int cx,
                               int cy) {
  for (int j = 0; j < k; ++j) {
    Range r;
    if (box_range(tab, fk, j, r) && r.holds(cx, cy)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    grid_count_kernel(Tables tab, uint8_t* mode, int32_t* cell_count,
                      int32_t* every, unsigned long long* sizes) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= tab.f) return;
  const int64_t fk = static_cast<int64_t>(f) * tab.k;
  uint8_t m = kNowhere;
  if (tab.alive[f]) {
    if (tab.box_any[f]) {
      m = kEverywhere;
    } else {
      int cells = 0;
      for (int k = 0; k < tab.k; ++k) {
        Range r;
        if (box_range(tab, fk, k, r)) cells += r.cells();
      }
      m = cells > kMaxSlotCells ? kEverywhere : (cells ? kGrid : kNowhere);
    }
  }
  mode[f] = m;
  if (m == kEverywhere) {
    every[atomicAdd(&sizes[1], 1ull)] = f;
  } else if (m == kGrid) {
    for (int k = 0; k < tab.k; ++k) {
      Range r;
      if (!box_range(tab, fk, k, r)) continue;
      for (int cy = r.y0; cy <= r.y1; ++cy)
        for (int cx = r.x0; cx <= r.x1; ++cx)
          if (!reached_before(tab, fk, k, cx, cy))
            atomicAdd(&cell_count[cy * kGridX + cx], 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    grid_fill_kernel(Tables tab, const uint8_t* mode, int32_t* cursor,
                     int32_t* cell_slots) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= tab.f || mode[f] != kGrid) return;
  const int64_t fk = static_cast<int64_t>(f) * tab.k;
  for (int k = 0; k < tab.k; ++k) {
    Range r;
    if (!box_range(tab, fk, k, r)) continue;
    for (int cy = r.y0; cy <= r.y1; ++cy)
      for (int cx = r.x0; cx <= r.x1; ++cx)
        if (!reached_before(tab, fk, k, cx, cy))
          cell_slots[atomicAdd(&cursor[cy * kGridX + cx], 1)] = f;
  }
}

// Exclusive prefix of in[0..n) into starts[0..n], starts[n] the total
// (int32 words: the caller checks the int64 total first), the same into
// cursor when it is given; *total the int64 sum. One block, over tiles
// of kScanThreads * kScanPerThread words staged in shared memory: loaded
// and stored coalesced, a thread scans its run of the tile (two 16-byte
// words), the block scans the runs' sums; the next tile's loads are
// issued before this tile's scan, so their latency overlaps it.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int32_t* in, int64_t n, int32_t* starts,
                int32_t* cursor, unsigned long long* total) {
  constexpr int kTile = kScanThreads * kScanPerThread;
  constexpr int kNw = kScanThreads / 32;
  __shared__ __align__(16) int32_t tile[kTile];
  __shared__ long long warp_sums[kNw];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int4* runs = reinterpret_cast<int4*>(tile) + 2 * t;
  int32_t w[kScanPerThread];
#pragma unroll
  for (int j = 0; j < kScanPerThread; ++j) {
    const int64_t i = static_cast<int64_t>(j) * kScanThreads + t;
    w[j] = i < n ? in[i] : 0;
  }
  long long carry = 0;
  for (int64_t base = 0; base < n; base += kTile) {
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) tile[j * kScanThreads + t] = w[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const int64_t i = base + kTile + static_cast<int64_t>(j) * kScanThreads
                        + t;
      w[j] = i < n ? in[i] : 0;
    }
    const int4 a = runs[0], b = runs[1];
    const long long mine = static_cast<long long>(a.x) + a.y + a.z + a.w +
                           b.x + b.y + b.z + b.w;
    long long x = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long s = lane < kNw ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, s, d);
        if (lane >= d) s += y;
      }
      if (lane < kNw) warp_sums[lane] = s;
    }
    __syncthreads();
    long long run = carry + x - mine + (warp ? warp_sums[warp - 1] : 0);
    int4 pa, pb;
    pa.x = static_cast<int32_t>(run); run += a.x;
    pa.y = static_cast<int32_t>(run); run += a.y;
    pa.z = static_cast<int32_t>(run); run += a.z;
    pa.w = static_cast<int32_t>(run); run += a.w;
    pb.x = static_cast<int32_t>(run); run += b.x;
    pb.y = static_cast<int32_t>(run); run += b.y;
    pb.z = static_cast<int32_t>(run); run += b.z;
    pb.w = static_cast<int32_t>(run);
    runs[0] = pa;
    runs[1] = pb;
    carry += warp_sums[kNw - 1];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kScanPerThread; ++j) {
      const int64_t i = base + static_cast<int64_t>(j) * kScanThreads + t;
      if (i < n) {
        const int32_t v = tile[j * kScanThreads + t];
        starts[i] = v;
        if (cursor) cursor[i] = v;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    starts[n] = static_cast<int32_t>(carry);
    *total = static_cast<unsigned long long>(carry);
  }
}

struct Row {
  float xh, xl, yh, yl;
  int32_t day, ms;
  int64_t r;
};

__device__ __forceinline__ Row load_row(const Rows& rows, int64_t r) {
  return Row{rows.xhi[r], rows.xlo[r], rows.yhi[r], rows.ylo[r],
             rows.tday[r], rows.tms[r], r};
}

// The full test of slot s on a row: time, attributes, then its boxes.
__device__ bool holds(const Tables& tab, const Rows& rows, int s,
                      const Row& w) {
  if (!tab.alive[s]) return false;
  const int4 t = tab.times[s];
  if (!((w.day > t.x) | ((w.day == t.x) & (w.ms >= t.y)))) return false;
  if (!((w.day < t.z) | ((w.day == t.z) & (w.ms <= t.w)))) return false;
  const int64_t sa = static_cast<int64_t>(s) * rows.a;
  for (int a = 0; a < rows.a; ++a) {
    if (tab.attr_any[sa + a]) continue;
    const float4 b = tab.attrs[sa + a];
    const float h = rows.avhi[a * rows.astride + w.r];
    const float l = rows.avlo[a * rows.astride + w.r];
    if (!(ge2(h, l, b.x, b.y) & le2(h, l, b.z, b.w))) return false;
  }
  if (tab.box_any[s]) return true;
  const int64_t fk = static_cast<int64_t>(s) * tab.k;
  for (int k = 0; k < tab.k; ++k) {
    if (!tab.box_valid[fk + k]) continue;
    const float4 bx = tab.boxes[(fk + k) * 2];
    const float4 by = tab.boxes[(fk + k) * 2 + 1];
    if (ge2(w.xh, w.xl, bx.x, bx.y) & le2(w.xh, w.xl, bx.z, bx.w) &
        ge2(w.yh, w.yl, by.x, by.y) & le2(w.yh, w.yl, by.z, by.w))
      return true;
  }
  return false;
}

// Blocks [0, row_blocks): a warp a row over its cell's slots. The rest: a
// warp an everywhere slot over the chunk's rows. kWrite false adds each
// slot's hits to counts; true writes row0 + r at the slot's cursor.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    match_kernel(Rows rows, Tables tab, Grid grid, int32_t* counts,
                 int32_t* cursor, int32_t* out, int32_t row0,
                 int row_blocks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
    if (r >= rows.n_valid) return;
    const Row w = load_row(rows, r);
    if (is_nan(w.xh) || is_nan(w.yh)) return;
    const int c = cell_of(w.yh, 90.0f, kGridY) * kGridX +
                  cell_of(w.xh, 180.0f, kGridX);
    const int end = grid.cell_start[c + 1];
    for (int i = grid.cell_start[c] + lane; i < end; i += 32) {
      const int s = grid.cell_slots[i];
      if (!holds(tab, rows, s, w)) continue;
      if (kWrite)
        out[atomicAdd(&cursor[s], 1)] = row0 + static_cast<int32_t>(r);
      else
        atomicAdd(&counts[s], 1);
    }
    return;
  }
  const int e = (static_cast<int>(blockIdx.x) - row_blocks) * kWarps + warp;
  if (e >= grid.n_every) return;
  const int s = grid.every[e];
  int32_t at = kWrite ? cursor[s] : 0;
  for (int64_t base = 0; base < rows.n_valid; base += 32) {
    const int64_t r = base + lane;
    const bool hit = r < rows.n_valid && holds(tab, rows, s, load_row(rows, r));
    const uint32_t b = __ballot_sync(kFull, hit);
    if (kWrite && hit)
      out[at + __popc(b & ((1u << lane) - 1u))] =
          row0 + static_cast<int32_t>(r);
    at += __popc(b);
  }
  if (lane == 0) {
    if (kWrite)
      cursor[s] = at;
    else
      counts[s] += at;
  }
}

// Exclusive prefix of v over the block's kSortThreads threads; *sum the
// block's total. Ends with a barrier.
__device__ int block_prefix(int v, int* sum, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kNw = kSortThreads / 32;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int j = 0; j < kNw; ++j) {
    before += j < warp ? scratch[j] : 0;
    all += scratch[j];
  }
  *sum = all;
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kSortThreads)
    sort_kernel(const int32_t* in, int32_t* out, const int32_t* starts,
                const int32_t* counts, const uint8_t* mode) {
  __shared__ uint32_t buf[kSortTile];
  __shared__ int scratch[kSortThreads / 32];
  __shared__ int lo_hi[2];
  const int s = blockIdx.x;
  const int len = counts[s];
  if (len == 0) return;
  const int32_t* src = in + starts[s];
  int32_t* dst = out + starts[s];
  if (mode[s] == kEverywhere || len == 1) {   // ascending as written
    for (int i = threadIdx.x; i < len; i += kSortThreads) dst[i] = src[i];
    return;
  }
  if (len <= kSortTile) {
    int p = 2;
    while (p < len) p <<= 1;
    int32_t* keys = reinterpret_cast<int32_t*>(buf);
    for (int i = threadIdx.x; i < p; i += kSortThreads)
      keys[i] = i < len ? src[i] : INT32_MAX;
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p; i += kSortThreads) {
          const int x = i ^ j;
          if (x > i) {
            const int32_t a = keys[i], b = keys[x];
            if ((a > b) == ((i & k) == 0)) {
              keys[i] = b;
              keys[x] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < len; i += kSortThreads) dst[i] = keys[i];
    return;
  }
  // A long segment: its ids are distinct, so a bitmap of their range, a
  // window of kSortTile words at a time, reads them out ascending.
  int lo = INT32_MAX, hi = INT32_MIN;
  for (int i = threadIdx.x; i < len; i += kSortThreads) {
    lo = min(lo, src[i]);
    hi = max(hi, src[i]);
  }
  if (threadIdx.x == 0) {
    lo_hi[0] = INT32_MAX;
    lo_hi[1] = INT32_MIN;
  }
  __syncthreads();
  atomicMin(&lo_hi[0], lo);
  atomicMax(&lo_hi[1], hi);
  __syncthreads();
  constexpr int64_t kWindow = static_cast<int64_t>(kSortTile) * 32;
  constexpr int kWordsPerThread = kSortTile / kSortThreads;
  int written = 0;
  for (int64_t w0 = lo_hi[0]; w0 <= lo_hi[1]; w0 += kWindow) {
    for (int i = threadIdx.x; i < kSortTile; i += kSortThreads) buf[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kSortThreads) {
      const int64_t d = src[i] - w0;
      if (d >= 0 && d < kWindow)
        atomicOr(&buf[d >> 5], 1u << static_cast<int>(d & 31));
    }
    __syncthreads();
    const int word0 = threadIdx.x * kWordsPerThread;
    int mine = 0;
    for (int j = 0; j < kWordsPerThread; ++j) mine += __popc(buf[word0 + j]);
    int total;
    int at = written + block_prefix(mine, &total, scratch);
    for (int j = 0; j < kWordsPerThread; ++j) {
      uint32_t bits = buf[word0 + j];
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        dst[at++] = static_cast<int32_t>(w0 + 32 * (word0 + j) + b);
      }
    }
    written += total;
    __syncthreads();
  }
}

Tables tables_of(const float* boxes, const uint8_t* box_valid,
                 const uint8_t* box_any, const int32_t* times,
                 const float* attrs, const uint8_t* attr_any,
                 const uint8_t* alive, int f, int k) {
  return Tables{reinterpret_cast<const float4*>(boxes), box_valid, box_any,
                reinterpret_cast<const int4*>(times),
                reinterpret_cast<const float4*>(attrs), attr_any, alive, f,
                k};
}

}  // namespace

extern "C" {

// 0: grid columns, 1: grid rows, 2: the most cells a grid slot reaches,
// 3: the sort's shared-memory tile.
int geomesa_standing_constant(int which) {
  switch (which) {
    case 0: return kGridX;
    case 1: return kGridY;
    case 2: return kMaxSlotCells;
    case 3: return kSortTile;
    default: return -1;
  }
}

// The grid's first two launches: each slot's mode, each cell's count
// (cell_count zeroed by the caller), the everywhere slots listed in
// every[0..sizes[1]) (sizes zeroed by the caller), then cell_start
// [kCells + 1], cursor [kCells] and sizes[0], the entries.
int geomesa_standing_grid_count(const float* boxes, const uint8_t* box_valid,
                                const uint8_t* box_any, const int32_t* times,
                                const float* attrs, const uint8_t* attr_any,
                                const uint8_t* alive, int f, int k,
                                uint8_t* mode, int32_t* cell_count,
                                int32_t* every, int32_t* cell_start,
                                int32_t* cursor, unsigned long long* sizes,
                                void* stream) {
  if (f < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  grid_count_kernel<<<(f + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      tables_of(boxes, box_valid, box_any, times, attrs, attr_any, alive, f,
                k),
      mode, cell_count, every, sizes);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  scan_kernel<<<1, kScanThreads, 0, st>>>(cell_count, kCells, cell_start,
                                          cursor, sizes);
  return static_cast<int>(cudaGetLastError());
}

// The grid's third launch: each grid slot written into its cells' lists
// at cursor (from geomesa_standing_grid_count).
int geomesa_standing_grid_fill(const float* boxes, const uint8_t* box_valid,
                               const uint8_t* box_any, const int32_t* times,
                               const float* attrs, const uint8_t* attr_any,
                               const uint8_t* alive, int f, int k,
                               const uint8_t* mode, int32_t* cursor,
                               int32_t* cell_slots, void* stream) {
  if (f < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  grid_fill_kernel<<<(f + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      tables_of(boxes, box_valid, box_any, times, attrs, attr_any, alive, f,
                k),
      mode, cursor, cell_slots);
  return static_cast<int>(cudaGetLastError());
}

// One chunk's hits: write 0 adds each slot's count to counts; write 1
// puts row0 + r at cursor[slot] (advancing it) in out. avhi/avlo are
// [a][astride] views (a may be 0, then they are not read); boxes, times
// and attrs must be 16-byte aligned. Requires 0 <= n_valid and
// row0 + n_valid < 2^31.
int geomesa_standing_match(int write, const float* xhi, const float* xlo,
                           const float* yhi, const float* ylo,
                           const int32_t* tday, const int32_t* tms,
                           const float* avhi, const float* avlo,
                           int64_t astride, int a, int64_t n_valid,
                           const float* boxes, const uint8_t* box_valid,
                           const uint8_t* box_any, const int32_t* times,
                           const float* attrs, const uint8_t* attr_any,
                           const uint8_t* alive, int f, int k,
                           const uint8_t* mode, const int32_t* cell_start,
                           const int32_t* cell_slots, const int32_t* every,
                           int n_every, int32_t* counts, int32_t* cursor,
                           int32_t* out, int32_t row0, void* stream) {
  if (n_valid < 0 || f < 1 || k < 1 || a < 0 || n_every < 0 ||
      static_cast<int64_t>(row0) + n_valid > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_blocks = (n_valid + kWarps - 1) / kWarps;
  const int64_t blocks = row_blocks + (n_every + kWarps - 1) / kWarps;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Rows rows{xhi, xlo, yhi, ylo, tday, tms, avhi, avlo, astride, a, n_valid};
  const Tables tab = tables_of(boxes, box_valid, box_any, times, attrs,
                               attr_any, alive, f, k);
  const Grid grid{mode, cell_start, cell_slots, every, n_every};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (write)
    match_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        rows, tab, grid, counts, cursor, out, row0,
        static_cast<int>(row_blocks));
  else
    match_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        rows, tab, grid, counts, cursor, out, row0,
        static_cast<int>(row_blocks));
  return static_cast<int>(cudaGetLastError());
}

// Each slot's segment: starts [f + 1] and cursor [f] from counts [f],
// *total the int64 sum.
int geomesa_standing_offsets(const int32_t* counts, int f, int32_t* starts,
                             int32_t* cursor, unsigned long long* total,
                             void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, f, starts, cursor, total);
  return static_cast<int>(cudaGetLastError());
}

// Each slot's segment of in, ascending, into out (everywhere segments
// copied as written).
int geomesa_standing_sort(const int32_t* in, int32_t* out,
                          const int32_t* starts, const int32_t* counts,
                          const uint8_t* mode, int f, void* stream) {
  if (f < 1) return static_cast<int>(cudaErrorInvalidValue);
  sort_kernel<<<f, kSortThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, starts, counts, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
