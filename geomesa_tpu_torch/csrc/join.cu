// Spatial-join and KNN kernels for Hopper (sm_90a).
//
// Replace the XLA programs of the reference package's analytics joins
// (geomesa_tpu/analytics/join.py), which serve dwithin_join,
// contains_join, knn_batched / knn and the processes above them:
//
// The x-sorted table and its tiles. J1, J2 and J3 walk the rows sorted
// by x (xs, ys: the rows' f32 coordinates in x order, padded rows at x =
// +inf, y = NaN, so no test passes them), cut into tiles of kTile
// columns aligned to 0. Each query or polygon has a slab [lo, lo +
// width) of the table that holds every row it can match; the wrapper
// lists, per tile, the objects whose slab meets it (tile_off, tile_obj:
// a CSR built on the device by torch ops, objects ascending within a
// tile; perm: each entry's index in object-major order). A block takes
// one tile and up to kGroup (J2: kSlabGroup) of its listed objects: it
// copies the tile's xs and ys into shared memory once (cp.async, 16
// bytes a copy), and every listed object is tested from there. So a
// column is read from device memory once for all the slabs that cover
// it. Several blocks reside on each SM (40 KB of shared memory each at
// most), so one block's copy overlaps another's tests.
//
// dwithin_counts_kernel   <- _dwithin_counts_all (:60, body
//   _dwithin_matrices :48). Per query q and row i < nrows, in f32 with
//   every step rounded to nearest,
//     d2 = (px[i] - qx[q])^2 + (py[i] - qy[q])^2
//     definite[q] += d2 <= r2_lo;  band[q] += !(d2 <= r2_lo) && d2 <= r2_hi
//   Design: a block tests EVERY column of its tile against each of its
//   listed queries, with no slab mask. The tiles partition the table,
//   so a query's counts over the tiles it visits equal its all-pairs
//   counts whenever every row that passes lies in a visited tile, which
//   J1's own slab half-width w guarantees for every f32 input: a pair
//   passes only if fl(fl(dx*dx) + fl(dy*dy)) <= r2 (r2 the larger of
//   r2_hi and r2_lo), so fl(dx*dx) <= r2, dx*dx <= r2 (1 + 2^-24) (or
//   below the least subnormal), and the exact |px - qx| <= D =
//   sqrt(r2) (1 + 2^-22) + 1e-20. A slab edge fl(qx -+ w) decides
//   something only where it falls among the finite rows, in [-M, M]
//   (M the table's largest finite |x|; beyond, rounding is monotone and
//   keeps or drops every finite row alike), and there it rounds by at
//   most 2^-24 M; so w = (D + 2^-23 M)(1 + 2^-22), rounded up to f32,
//   holds every row within D of qx. A non-finite qx passes nothing
//   (d2 is inf or NaN), so its slab is empty; an infinite w makes every
//   slab the whole table, so every tile lists every query. The
//   queries sit in registers, kDwQpt a thread: P query slots (a power
//   of two, P * kDwQpt >= the listed queries) by kThreads / P column
//   stripes, so with few queries the threads split the tile's columns
//   and with 256 slots each thread walks the whole tile (a broadcast
//   read serves the warp). Counts add up in shared memory, then one
//   atomicAdd per (tile, query). Bound: the larger of 8 B a column of
//   the slabs' union and 7 f32 operations a slab column (d2's five, two
//   compares).
//
// slab_count_kernel,      <- _slab_cand_mask (:123) with
// slab_write_kernel          _slab_cand_count (:137) and _slab_cand_flat
//   (:148) in radius mode; _contains_cand_mask (:473) with
//   _contains_cand_count (:493) and _contains_cand_flat (:501) in box
//   mode. Over each query's x-slab [lo, lo + width) of the x-sorted
//   table, a column matches where
//     radius mode: (xs - qx)^2 + (ys - qy)^2 <= r2_hi
//     box mode:    xs >= fl(xmin - eps) && xs <= fl(xmax + eps) &&
//                  ys >= fl(ymin - eps) && ys <= fl(ymax + eps)
//   and the output is jnp.flatnonzero of the reference's (query,
//   column) grid, query-major and column-ascending, mapped to row ids
//   (order[lo + col]) beside the query's index. Bound: 8 B a column of
//   the slabs' union (+ 8 B a match written). A block per (query,
//   2,048 slab columns) would read a column of overlapping slabs once
//   per query, twice (a counts pass, then a write pass at offsets
//   prefixed on the host between them). Design: the tile lists of J1
//   and J3 over the query slabs; the counts pass (slab_count_kernel)
//   copies its tile into shared memory, holds its columns in registers,
//   eight a thread, and for each listed entry (up to kSlabGroup a
//   block) each warp ballots its 32-column words inside
//   the entry's span into a bitmap (256 B an entry, one bit a slab
//   column: an eighth of the reference's (k, smax) bool grid) and a
//   count, both at the entry's object-major index (the lists' perm).
//   torch.cumsum of the counts in that order gives every entry's offset
//   on the card (one copy to the host: the total, which sizes the
//   output). The write pass (slab_write_kernel) reads no table column:
//   a warp per entry with matches walks its bitmap's non-empty words in
//   order and stores order[col] at ballot ranks.
//
// contains_counts_kernel  <- _contains_counts_all (:420) with _pip_body
//   (:389). Per polygon: the columns of its slab inside its
//   EDGE_EPS-widened f32 box (each bound rounded as the reference's), and
//   for those the f32 crossing number and the squared distance to the
//   nearest edge, in the operation order of _pip_body (and of
//   csrc/geom.cu):
//     cond = (y0 > y) != (y1 > y);  dy = y1 == y0 ? 1e-30 : y1 - y0
//     cross = cond && x < x0 + ((y - y0) * (x1 - x0)) / dy
//     t = clamp(((x - x0)*ex + (y - y0)*ey) / (len2 == 0 ? 1 : len2), 0, 1)
//     d2 = (x - (x0 + t*ex))^2 + (y - (y0 + t*ey))^2
//     band = min over edges of d2 < eps2;  inside = parity of cross
//   Design: a block holds its tile's columns, eight a thread, in
//   registers, and tests them against each listed polygon's box (the
//   polygons' boxes and column spans staged in shared memory 256 at a
//   time), only the columns inside that polygon's slab (the reference's
//   cols < width). A warp appends its in-box (column, polygon) pairs to
//   its own list in shared memory, placed by a ballot: no atomic and
//   no barrier a polygon. Once a warp's list holds 32 pairs, or the
//   polygons are done, each lane takes one pair through the polygon's
//   edges, read as the edges A = (x0, y0, x1, y1) and their terms B =
//   (ex, ey, len2 guarded, dy guarded), computed once per call by
//   edge_terms_kernel.
//   Definite (in box, inside, not band) and band counts add up per
//   polygon in shared memory, then one atomicAdd per (tile, polygon),
//   and the (tile, polygon) band count goes to cband, the rows pass's
//   offsets. Bound: the larger of the bytes (8 B a column of the slabs'
//   union, 16 B an edge) and the operations (4 a slab column for the
//   box test, about 23 a (column in the box, edge) pair).
//
// contains_rows_kernel    <- _contains_counts_all's band rows (:443) and
//   _contains_band_rows (:454). One block per (tile, polygon) entry with
//   band rows: the columns of the tile inside the slab, in column order,
//   through the box test and the edges; the band rows written from the
//   entry's offset (the band rows of the polygon's earlier tiles, the
//   wrapper's segmented prefix of cband), the first cap of each polygon
//   kept: the reference's jnp.flatnonzero(..., size=cap).
//
// knn_sample_kernel,      <- _knn_kernel (:635). Per query, the kpad
// knn_select_kernel         smallest keys (d2, row) in lexicographic
//   order, where d2 is the f32 (px - qx)^2 + (py - qy)^2 rounded at every
//   step, +inf for rows >= nrows, every NaN one NaN ranked above +inf;
//   ties go to the lower row id. That is lax.top_k's order on -d2 (and
//   its two-stage form at :651-664). The key is one 64-bit word, d2's
//   bits (monotone for d2 >= 0) above the row id. Bound: 8 B a row read
//   once; at 32 queries 6 f32 operations a (row, query) pair (d2's five,
//   a compare). One query a block would read every row and build its
//   key once per query, and a block that begins from an empty bound
//   appends nearly every row of its first tiles. Design,
//   three launches with no copy to the host (sized on the host from the
//   occupancy, geomesa_knn_plan):
//   - a sample pass (knn_sample_kernel) over a 32nd of the tiles,
//     spread over the table: for each query, each warp's least d2 over
//     32 rows counts in a histogram (2,048 bins by the key's high bits,
//     a query's in device memory). Those are distinct rows, so the top
//     of the bin where the counts reach kpad bounds the table's kpad-th
//     key: any kpad rows' keys do.
//   - the rows pass (knn_select_kernel in rows mode): a block takes a
//     chunk of rows and a group of G <= 8 queries held in registers and
//     starts from the sample's bound. A row is loaded once (16-byte
//     loads, four rows a thread; the next tile's loads in flight, the
//     rows four tiles on brought into L2) and tested against each query
//     by the box of half-width knn_width(bound) around it (two
//     subtractions and two compares; every row whose key can pass lies
//     inside), so a key is built and compared only for a row in the box
//     (a tie or a NaN takes the full key). A passing key is appended to
//     the query's buffer (device memory, L2-resident; one shared
//     atomic). Each tile ends in one barrier (__syncthreads_or) that
//     says whether an append filled a buffer past cut = 1.25 kpad keys;
//     only then (rare once the bound is seeded) the warp of each query
//     cuts its buffer (warp_cut: a radix select from the keys' highest
//     differing bit, four bits a round, lane-private counters) and
//     lowers the bound, which a word a query in device memory shares
//     with every block (atomicMax of its complement). After tiles 4, 16
//     and 64 each block also adds its new keys to a second histogram
//     and takes that bound, so the blocks' best keys tighten each
//     other's bound. Each block leaves its keys at or below the bound,
//     at most cut a query, in a survivor buffer (a counter a query).
//   - a final pass (knn_select_kernel in keys mode), a block a query,
//     streams the survivors through the same buffer and cuts, sorts
//     them (bitonic) and writes the first kpad.
//
// Rounding: every f32 step is __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, in the reference's order, so nvcc contracts no multiply and
// add into an FMA and every verdict and key equals the plain PyTorch
// version's (scan/kernels.py) bit for bit. Build WITHOUT
// --use_fast_math or -ftz=true.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for arguments it refuses,
// and never synchronises.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads of every join block
constexpr int kTile = 2048;      // columns of the x-sorted table a tile
constexpr int kPer = kTile / kThreads;  // a tile's columns a thread
constexpr int kDwQpt = 4;        // dwithin queries a thread
constexpr int kGroup = kThreads * kDwQpt;  // listed objects a block takes
constexpr int kWarpPairs = 32 * kPer + 32;  // a warp's contains pairs
constexpr int kSlabGroup = kThreads;  // list entries a slab block takes
constexpr int kWords = kTile / 32;    // bitmap words of a slab entry
constexpr int kKnTile = 1024;    // knn rows or keys a tile (four a thread)
constexpr int kKnAhead = 4;      // knn tiles brought into L2 ahead
constexpr int kCutWords = 16 * 33;  // a warp's cut counters
constexpr int kKnMaxKpad = 8192; // largest knn window
constexpr int kKnMaxGroup = 8;   // queries of a knn rows block
constexpr int kKnChunks = 1024;  // rows blocks a group at most
constexpr int kSampleTiles = 4;  // tiles a sample block takes
// the histograms of published keys: bins by d2's sign, exponent and top
// three mantissa bits (the key's bits 63..52), 8 KB a query
constexpr int kHistBins = 2048;
constexpr int kHistShift = 52;
// the rows pass publishes its new keys after these tiles
constexpr int kRefresh0 = 3, kRefresh1 = 15, kRefresh2 = 63;
// the largest knn buffer: a power of two at least cut = 1.25 kMaxKpad
// (the final sort's), 16,384 keys (128 KB)
constexpr int kKnMaxBuf = 16384;

constexpr uint64_t kKeyMax = ~0ull;

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

// exclusive prefix of v over the block's kThreads threads (Hillis-Steele
// in shared memory s of 2 * kThreads ints); every thread must call it
__device__ int block_exclusive(int v, int* s) {
  int pin = 0;
  s[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    int t = s[pin * kThreads + threadIdx.x];
    if (static_cast<int>(threadIdx.x) >= off)
      t += s[pin * kThreads + threadIdx.x - off];
    s[(1 - pin) * kThreads + threadIdx.x] = t;
    pin = 1 - pin;
    __syncthreads();
  }
  const int incl = s[pin * kThreads + threadIdx.x];
  __syncthreads();  // s is free again
  return incl - v;
}

__device__ __forceinline__ float sq_dist(float x, float y, float qx, float qy) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// -- the tiles: async copies (cp.async, sm_80 and up) ------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// a hint to bring the line holding p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// -- end of the async copies --------------------------------------------------

// columns [t0, t0 + n) of xs and ys (n <= kTile) into sx and sy, 16 bytes
// a copy where both tables are 16-byte aligned (the same in every
// thread); ends in a barrier
__device__ void load_tile(const float* xs, const float* ys, int64_t t0,
                          int n, float* sx, float* sy) {
  const float* gx = xs + t0;
  const float* gy = ys + t0;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(gx) | reinterpret_cast<uintptr_t>(gy)) &
       15) == 0) {
    head = n & ~3;
    for (int i = 4 * threadIdx.x; i < head; i += 4 * kThreads) {
      cp_async16(sx + i, gx + i);
      cp_async16(sy + i, gy + i);
    }
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) {
    cp_async4(sx + i, gx + i);
    cp_async4(sy + i, gy + i);
  }
  cp_async_wait_all();
  __syncthreads();
}

// the block's slice of tile blockIdx.x's list: entries [b, b + m) of
// tile_obj, and the tile's first column t0 and columns n; m == 0 when
// the tile lists fewer than blockIdx.y * group + 1 objects
struct TileWork {
  int b, m, n;
  int64_t t0;
};

__device__ __forceinline__ TileWork tile_work(const int32_t* tile_off,
                                              int64_t ncols,
                                              int group = kGroup) {
  TileWork w;
  const int64_t tile = blockIdx.x;
  w.b = tile_off[tile] + static_cast<int>(blockIdx.y) * group;
  const int e = tile_off[tile + 1];
  w.m = e - w.b < 0 ? 0 : (e - w.b < group ? e - w.b : group);
  w.t0 = tile * kTile;
  w.n = static_cast<int>(ncols - w.t0 < kTile ? ncols - w.t0 : kTile);
  return w;
}

// -- J1: dwithin counts -----------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dwithin_counts_kernel(const float* __restrict__ xs,
                          const float* __restrict__ ys, int64_t ncols,
                          const int32_t* __restrict__ tile_off,
                          const int32_t* __restrict__ tile_obj,
                          const float* __restrict__ qx,
                          const float* __restrict__ qy, float r2_hi,
                          float r2_lo, int32_t* __restrict__ definite,
                          int32_t* __restrict__ band) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ int s_d[kGroup], s_b[kGroup];
  const TileWork w = tile_work(tile_off, ncols);
  if (w.m == 0) return;  // the same in every thread
  for (int i = threadIdx.x; i < w.m; i += kThreads) s_d[i] = s_b[i] = 0;
  // P query slots by kThreads / P column stripes: slot j of this thread
  // is listed query slot + j * P; a slot past the list holds a NaN
  // query, whose compares never pass
  int P = 1;
  while (P * kDwQpt < w.m && P < kThreads) P <<= 1;
  const int stride = kThreads / P;
  const int slot = threadIdx.x & (P - 1);
  float ax[kDwQpt], ay[kDwQpt];
  int cd[kDwQpt], cb[kDwQpt];
#pragma unroll
  for (int j = 0; j < kDwQpt; ++j) {
    const int idx = slot + j * P;
    const int q = idx < w.m ? tile_obj[w.b + idx] : -1;
    ax[j] = q >= 0 ? qx[q] : __int_as_float(0x7fc00000);
    ay[j] = q >= 0 ? qy[q] : __int_as_float(0x7fc00000);
    cd[j] = cb[j] = 0;
  }
  load_tile(xs, ys, w.t0, w.n, sx, sy);
  for (int i = threadIdx.x / P; i < w.n; i += stride) {
    const float x = sx[i];
    const float y = sy[i];
#pragma unroll
    for (int j = 0; j < kDwQpt; ++j) {
      const float d2 = sq_dist(x, y, ax[j], ay[j]);
      const bool d = d2 <= r2_lo;
      cd[j] += d;
      cb[j] += !d & (d2 <= r2_hi);
    }
  }
#pragma unroll
  for (int j = 0; j < kDwQpt; ++j) {
    const int idx = slot + j * P;
    if (idx < w.m) {
      if (cd[j]) atomicAdd(&s_d[idx], cd[j]);
      if (cb[j]) atomicAdd(&s_b[idx], cb[j]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w.m; i += kThreads) {
    const int q = tile_obj[w.b + i];
    if (s_d[i]) atomicAdd(definite + q, s_d[i]);
    if (s_b[i]) atomicAdd(band + q, s_b[i]);
  }
}

// a point in a box [x: xmin, y: ymin, z: xmax, w: ymax] (a NaN fails)
__device__ __forceinline__ bool in_box(const float4& g, float x, float y) {
  return x >= g.x && x <= g.z && y >= g.y && y <= g.w;
}

// -- J2: slab candidate pairs -----------------------------------------------

// the counts pass: each list entry's matching columns of its tile, as a
// bitmap (bit c % 32 of word c / 32 for tile column c, the words of the
// entry's slab span written) and their count, both at the entry's
// object-major index
template <bool kBox>
__global__ void __launch_bounds__(kThreads)
    slab_count_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys, int64_t ncols,
                      const int32_t* __restrict__ tile_off,
                      const int32_t* __restrict__ tile_obj,
                      const int64_t* __restrict__ perm,
                      const int32_t* __restrict__ los,
                      const int32_t* __restrict__ widths,
                      const float* __restrict__ qa, float r2_hi, float eps,
                      int32_t* __restrict__ counts,
                      uint32_t* __restrict__ bits) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ float4 s_q[kSlabGroup];   // the point, or the widened box
  __shared__ int2 s_span[kSlabGroup];  // the slab's columns in the tile
  __shared__ int64_t s_at[kSlabGroup]; // the object-major index
  __shared__ int s_cnt[kSlabGroup];
  const TileWork w = tile_work(tile_off, ncols, kSlabGroup);
  if (w.m == 0) return;  // the same in every thread
  if (static_cast<int>(threadIdx.x) < w.m) {  // overlaps the tile's copy
    const int s = threadIdx.x;
    const int q = tile_obj[w.b + s];
    const int64_t lo = los[q] - w.t0;
    const int64_t hi = lo + widths[q];
    s_span[s] = make_int2(lo > 0 ? static_cast<int>(lo) : 0,
                          hi < w.n ? static_cast<int>(hi) : w.n);
    s_q[s] = kBox ? make_float4(__fsub_rn(qa[4 * q], eps),
                                __fsub_rn(qa[4 * q + 1], eps),
                                __fadd_rn(qa[4 * q + 2], eps),
                                __fadd_rn(qa[4 * q + 3], eps))
                  : make_float4(qa[2 * q], qa[2 * q + 1], 0.f, 0.f);
    s_at[s] = perm[w.b + s];
    s_cnt[s] = 0;
  }
  load_tile(xs, ys, w.t0, w.n, sx, sy);  // ends in a barrier
  // the tile's columns, eight a thread (a NaN past the table fails
  // every test)
  const float nan = __int_as_float(0x7fc00000);
  float x[kPer], y[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int col = r * kThreads + threadIdx.x;
    x[r] = col < w.n ? sx[col] : nan;
    y[r] = col < w.n ? sy[col] : nan;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  for (int s = 0; s < w.m; ++s) {
    const int2 c = s_span[s];
    const float4 a = s_q[s];
    uint32_t* out = bits + s_at[s] * kWords;
    int found = 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int c0 = r * kThreads + warp * 32;  // word c0 / 32 of the tile
      if (c0 + 32 <= c.x || c0 >= c.y) continue;  // the same in the warp
      const int col = c0 + lane;
      const bool hit = col >= c.x && col < c.y &&
                       (kBox ? in_box(a, x[r], y[r])
                             : sq_dist(x[r], y[r], a.x, a.y) <= r2_hi);
      const unsigned word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) out[c0 / 32] = word;
      found += __popc(word);
    }
    if (lane == 0 && found) atomicAdd(&s_cnt[s], found);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < w.m)
    counts[s_at[threadIdx.x]] = s_cnt[threadIdx.x];
}

// the write pass: a warp per list entry with matches, from the entry's
// offset (the matches of the objects before its own and of its own
// earlier tiles: incl, the inclusive prefix of counts in object-major
// order, less its own count), its bitmap's non-empty words in column
// order, each as one ballot-ranked store of order[col] and the query
__global__ void __launch_bounds__(kThreads)
    slab_write_kernel(const int32_t* __restrict__ order, int64_t ncols,
                      const int32_t* __restrict__ tile_off,
                      const int32_t* __restrict__ tile_obj,
                      const int64_t* __restrict__ perm,
                      const int32_t* __restrict__ los,
                      const int32_t* __restrict__ widths,
                      const int32_t* __restrict__ counts,
                      const int64_t* __restrict__ incl,
                      const uint32_t* __restrict__ bits,
                      int32_t* __restrict__ rows_out,
                      int32_t* __restrict__ qi_out) {
  const TileWork w = tile_work(tile_off, ncols, kSlabGroup);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int32_t* ord = order + w.t0;
  for (int s = threadIdx.x / 32; s < w.m; s += kThreads / 32) {
    const int64_t at = perm[w.b + s];
    const int c = counts[at];
    if (c == 0) continue;  // the same in the warp
    const int q = tile_obj[w.b + s];
    const int64_t lo = los[q] - w.t0;
    const int64_t hi = lo + widths[q];
    const int wlo = (lo > 0 ? static_cast<int>(lo) : 0) / 32;
    const int whi = ((hi < w.n ? static_cast<int>(hi) : w.n) - 1) / 32;
    const uint32_t* b = bits + at * kWords;
    const uint32_t w0 = wlo + lane <= whi ? b[wlo + lane] : 0u;
    const uint32_t w1 = wlo + 32 + lane <= whi ? b[wlo + 32 + lane] : 0u;
    uint64_t nz = __ballot_sync(0xffffffffu, w0 != 0u) |
                  static_cast<uint64_t>(__ballot_sync(0xffffffffu,
                                                      w1 != 0u)) << 32;
    int64_t base = incl[at] - c;
    while (nz) {  // the same in the warp
      const int k = __ffsll(static_cast<long long>(nz)) - 1;
      nz &= nz - 1;
      const uint32_t word = __shfl_sync(0xffffffffu, k < 32 ? w0 : w1,
                                        k & 31);
      if ((word >> lane) & 1u) {
        const int64_t pos = base + __popc(word & below);
        rows_out[pos] = ord[(wlo + k) * 32 + lane];
        qi_out[pos] = q;
      }
      base += __popc(word);
    }
  }
}

// -- J3: contains counts and band rows ---------------------------------------

// the terms B = (ex, ey, len2 guarded, dy guarded) of the valid edges
// (the first ecount[p] of polygon p's ne), in the reference's rounding
__global__ void __launch_bounds__(kThreads)
    edge_terms_kernel(const float4* __restrict__ edges,
                      const int32_t* __restrict__ ecount, int ne, int64_t n,
                      float4* __restrict__ terms) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || static_cast<int>(i % ne) >= ecount[i / ne]) return;
  const float4 g = edges[i];
  const float ex = __fsub_rn(g.z, g.x);
  const float ey = __fsub_rn(g.w, g.y);
  const float len2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
  terms[i] = make_float4(ex, ey, len2 == 0.f ? 1.f : len2,
                         g.w == g.y ? 1e-30f : ey);
}

// one point against te edges (A, B): the crossing parity and the least
// squared distance (a NaN stays, as the reference's minimum keeps it)
__device__ __forceinline__ void pip_edges(float x, float y,
                                          const float4* __restrict__ A,
                                          const float4* __restrict__ B,
                                          int te, bool* parity, float* m) {
  for (int j = 0; j < te; ++j) {
    const float4 a = A[j];
    const float4 c = B[j];
    const float ry = __fsub_rn(y, a.y);
    if ((a.y > y) != (a.w > y)) {
      const float xint = __fadd_rn(a.x, __fdiv_rn(__fmul_rn(ry, c.x), c.w));
      *parity ^= x < xint;
    }
    float t = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, a.x), c.x),
                                  __fmul_rn(ry, c.y)),
                        c.z);
    t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);  // NaN passes, as jnp.clip
    const float dx = __fsub_rn(x, __fadd_rn(a.x, __fmul_rn(t, c.x)));
    const float dy = __fsub_rn(y, __fadd_rn(a.y, __fmul_rn(t, c.y)));
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    *m = (d2 < *m || d2 != d2) ? d2 : *m;
  }
}

// polygon p's box widened by eps, each bound rounded as the reference's
__device__ __forceinline__ float4 widened_box(const float4* boxes, int p,
                                              float eps) {
  const float4 g = boxes[p];
  return make_float4(__fsub_rn(g.x, eps), __fsub_rn(g.y, eps),
                     __fadd_rn(g.z, eps), __fadd_rn(g.w, eps));
}

// polygons [s0, s0 + kThreads) of the block's list, one a thread, into
// shared memory: the slab's columns [c0, c1) within the tile and the
// widened box
__device__ __forceinline__ void stage_polys(
    const TileWork& w, int s0, const int32_t* __restrict__ tile_obj,
    const int32_t* __restrict__ los, const int32_t* __restrict__ widths,
    const float4* __restrict__ boxes, float eps, int2* span, float4* box) {
  const int s = s0 + threadIdx.x;
  if (s < w.m) {
    const int p = tile_obj[w.b + s];
    const int64_t lo = los[p] - w.t0;
    const int64_t hi = lo + widths[p];
    span[threadIdx.x] = make_int2(lo > 0 ? static_cast<int>(lo) : 0,
                                  hi < w.n ? static_cast<int>(hi) : w.n);
    box[threadIdx.x] = widened_box(boxes, p, eps);
  }
}

// the warp's n held pairs (column << 10 | slot in the list) through
// their polygons' edges, one a lane, into the shared counts
__device__ __forceinline__ void flush_pairs(
    const int* pairs, int n, const TileWork& w, const float* sx,
    const float* sy, const int32_t* __restrict__ tile_obj,
    const float4* __restrict__ edges, const float4* __restrict__ terms,
    const int32_t* __restrict__ ecount, int ne, float eps2, int* s_d,
    int* s_b) {
  __syncwarp();  // the lanes' appends are visible
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const int v = pairs[i];
    const int col = v >> 10;
    const int k = v & (kGroup - 1);
    const int q = tile_obj[w.b + k];
    const int64_t e0 = static_cast<int64_t>(q) * ne;
    bool parity = false;
    float m = __int_as_float(0x7f800000);
    pip_edges(sx[col], sy[col], edges + e0, terms + e0, ecount[q], &parity,
              &m);
    if (m < eps2)
      atomicAdd(&s_b[k], 1);
    else if (parity)
      atomicAdd(&s_d[k], 1);
  }
  __syncwarp();  // every pair is read before the list refills
}

__global__ void __launch_bounds__(kThreads, 4)
    contains_counts_kernel(const float* __restrict__ xs,
                           const float* __restrict__ ys, int64_t ncols,
                           const int32_t* __restrict__ tile_off,
                           const int32_t* __restrict__ tile_obj,
                           const int32_t* __restrict__ los,
                           const int32_t* __restrict__ widths,
                           const float4* __restrict__ boxes,
                           const float4* __restrict__ edges,
                           const float4* __restrict__ terms,
                           const int32_t* __restrict__ ecount, int ne,
                           float eps, float eps2, int32_t* __restrict__ dc,
                           int32_t* __restrict__ bc,
                           int32_t* __restrict__ cband) {
  __shared__ __align__(16) float sx[kTile];
  __shared__ __align__(16) float sy[kTile];
  __shared__ int s_pair[kThreads / 32][kWarpPairs];  // a list a warp
  __shared__ int s_d[kGroup], s_b[kGroup];
  __shared__ int2 s_span[kThreads];  // the staged polygons' columns
  __shared__ float4 s_box[kThreads]; // and widened boxes
  const TileWork w = tile_work(tile_off, ncols);
  if (w.m == 0) return;  // the same in every thread
  for (int i = threadIdx.x; i < w.m; i += kThreads) s_d[i] = s_b[i] = 0;
  // the first polygons' loads overlap the tile's copy
  stage_polys(w, 0, tile_obj, los, widths, boxes, eps, s_span, s_box);
  load_tile(xs, ys, w.t0, w.n, sx, sy);
  const float nan = __int_as_float(0x7fc00000);
  float x[kPer], y[kPer];  // a NaN past the tile fails every box
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int col = r * kThreads + threadIdx.x;
    x[r] = col < w.n ? sx[col] : nan;
    y[r] = col < w.n ? sy[col] : nan;
  }
  const unsigned below = (1u << (threadIdx.x & 31)) - 1;
  int* pairs = s_pair[threadIdx.x / 32];
  int held = 0;  // the warp's pairs, under 32 before each polygon
  for (int s = 0; s < w.m; ++s) {
    if (s > 0 && s % kThreads == 0) {  // the same in every thread
      __syncthreads();  // every staged entry is read
      stage_polys(w, s, tile_obj, los, widths, boxes, eps, s_span, s_box);
      __syncthreads();
    }
    const int2 c = s_span[s % kThreads];
    const float4 g = s_box[s % kThreads];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int col = r * kThreads + threadIdx.x;
      const bool hit = col >= c.x && col < c.y && in_box(g, x[r], y[r]);
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (hit) pairs[held + __popc(mask & below)] = (col << 10) | s;
      held += __popc(mask);
    }
    if (held >= 32) {  // the same in the warp
      flush_pairs(pairs, held, w, sx, sy, tile_obj, edges, terms, ecount, ne,
                  eps2, s_d, s_b);
      held = 0;
    }
  }
  flush_pairs(pairs, held, w, sx, sy, tile_obj, edges, terms, ecount, ne,
              eps2, s_d, s_b);
  __syncthreads();
  for (int i = threadIdx.x; i < w.m; i += kThreads) {
    const int p = tile_obj[w.b + i];
    if (s_d[i]) atomicAdd(dc + p, s_d[i]);
    if (s_b[i]) atomicAdd(bc + p, s_b[i]);
    cband[w.b + i] = s_b[i];
  }
}

// item: (tile, polygon, slot, offset)
__global__ void __launch_bounds__(kThreads)
    contains_rows_kernel(const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const int32_t* __restrict__ order, int64_t ncols,
                         const int32_t* __restrict__ los,
                         const int32_t* __restrict__ widths,
                         const int4* __restrict__ item,
                         const float4* __restrict__ boxes,
                         const float4* __restrict__ edges,
                         const float4* __restrict__ terms,
                         const int32_t* __restrict__ ecount, int ne,
                         float eps, float eps2, int cap_rows,
                         int32_t* __restrict__ rows_out) {
  __shared__ int s_scan[2 * kThreads];
  const int4 it = item[blockIdx.x];
  const int p = it.y;
  const int64_t t0 = static_cast<int64_t>(it.x) * kTile;
  const int64_t lo = los[p];
  int64_t c1 = lo + widths[p];
  c1 = c1 < t0 + kTile ? c1 : t0 + kTile;
  c1 = c1 < ncols ? c1 : ncols;
  const float4 g = widened_box(boxes, p, eps);
  const float4* A = edges + static_cast<int64_t>(p) * ne;
  const float4* B = terms + static_cast<int64_t>(p) * ne;
  const int ec = ecount[p];
  int32_t* out = rows_out + static_cast<int64_t>(it.z) * cap_rows;
  int found = it.w;
  for (int64_t s0 = lo > t0 ? lo : t0; s0 < c1 && found < cap_rows;
       s0 += kThreads) {
    const int64_t col = s0 + threadIdx.x;
    bool band = false;
    if (col < c1) {
      const float x = xs[col];
      const float y = ys[col];
      if (in_box(g, x, y)) {
        bool parity = false;
        float m = __int_as_float(0x7f800000);
        pip_edges(x, y, A, B, ec, &parity, &m);
        band = m < eps2;
      }
    }
    const int step = __syncthreads_count(band);  // the same in every thread
    if (step) {
      const int rank = block_exclusive(band, s_scan);
      if (band && found + rank < cap_rows) out[found + rank] = order[col];
      found += step;
    }
  }
}

// -- J4: knn selection -------------------------------------------------------

__device__ __forceinline__ uint64_t knn_key(float d2, int64_t row) {
  const uint32_t bits = d2 != d2 ? 0x7fc00000u : __float_as_uint(d2);
  return (static_cast<uint64_t>(bits) << 32) | static_cast<uint32_t>(row);
}

// ascending bitonic sort of the s keys of buf (s a power of two): each
// thread takes compare-exchange pairs (i, i + j), i with bit j clear
__device__ void bitonic_sort(uint64_t* buf, int s) {
  for (int k = 2; k <= s; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < s / 2; t += kThreads) {
        const int i = 2 * t - (t & (j - 1));
        const uint64_t a = buf[i], b = buf[i + j];
        if ((a > b) == ((i & k) == 0)) {
          buf[i] = b;
          buf[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint64_t warp_min(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// One warp cuts a buffer of n > kpad distinct keys: it finds a bound t
// with kpad <= #{keys <= t} <= cut, keeps those keys at the head (in any
// order) and returns t (*kept: their count). A radix select from the
// highest bit where the keys differ down, four bits a round: each lane
// counts its keys' digits in its own column of the warp's 16 x 33
// counters (no atomics, no conflicts between lanes of one digit), then
// lane b sums bin b. It stops at the first round whose bin holding the
// kpad-th key leaves at most cut keys at or below its top; at the last
// round the bin is the kpad-th key itself.
__device__ uint64_t warp_cut(uint64_t* buf, int n, int kpad, int cut,
                             int* hist, int* kept, int* pub) {
  const int lane = threadIdx.x & 31;
  uint64_t lo = kKeyMax, hi = 0;
  for (int i = lane; i < n; i += 32) {
    const uint64_t k = buf[i];
    lo = k < lo ? k : lo;
    hi = k > hi ? k : hi;
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  int top = 63 - __clzll(static_cast<long long>(lo ^ hi));
  uint64_t fixed = top == 63 ? 0ull : ~0ull << (top + 1);  // settled bits
  uint64_t prefix = lo & fixed;
  int need = kpad, below = 0;
  uint64_t t;
  int* own = hist + lane;  // this lane's column: bin b at own[b * 33]
  while (true) {
    const int low = top > 3 ? top - 3 : 0;
    const uint32_t dmask = (1u << (top - low + 1)) - 1;
#pragma unroll
    for (int b = 0; b < 16; ++b) own[b * 33] = 0;
    for (int i0 = 0; i0 < n; i0 += 4 * 32) {  // four keys a lane a step
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * 32 + lane;
        const uint64_t k = i < n ? buf[i] : 0ull;
        if (i < n && (k & fixed) == prefix)
          ++own[static_cast<int>((k >> low) & dmask) * 33];
      }
    }
    __syncwarp();
    int cnt = 0;  // lane b < 16: bin b's keys
    if (lane < 16) {
#pragma unroll 8
      for (int l = 0; l < 32; ++l) cnt += hist[lane * 33 + l];
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int src = __ffs(__ballot_sync(0xffffffffu, lane < 16 &&
                                                         incl - cnt < need &&
                                                         need <= incl)) - 1;
    const int before = __shfl_sync(0xffffffffu, incl - cnt, src);
    const int count = __shfl_sync(0xffffffffu, cnt, src);
    __syncwarp();  // every lane has read the counters
    prefix |= static_cast<uint64_t>(src) << low;
    fixed |= static_cast<uint64_t>(dmask) << low;
    if (below + before + count <= cut || low == 0) {
      t = prefix | ~fixed;
      break;
    }
    need -= before;
    below += before;
    top = low - 1;
  }
  // keys <= t to the head, in order, so the first *pub (the keys
  // published before) stay first; *pub becomes the kept ones' count
  const unsigned lt = (1u << lane) - 1;
  int head = 0, old = 0;
  for (int i0 = 0; i0 < n; i0 += 4 * 32) {
    uint64_t k[4];
    bool keep[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * 32 + lane;
      k[u] = i < n ? buf[i] : kKeyMax;
      keep[u] = i < n && k[u] <= t;
    }
    __syncwarp();  // the step's keys are read before any is written
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(0xffffffffu, keep[u]);
      if (keep[u]) buf[head + __popc(m & lt)] = k[u];
      head += __popc(m);
      old += __popc(__ballot_sync(0xffffffffu,
                                  keep[u] && i0 + u * 32 + lane < *pub));
    }
    __syncwarp();
  }
  *kept = head;
  *pub = old;
  return t;
}

// the histogram bin of a key (kHistBins by the high bits of d2) and the
// largest key of bin b
__device__ __forceinline__ int knn_bin(uint64_t key) {
  return static_cast<int>(key >> kHistShift);
}

__device__ __forceinline__ uint64_t bin_top(int b) {
  return (static_cast<uint64_t>(b + 1) << kHistShift) - 1;
}

// One warp: the top of the bin of h (kHistBins counts of distinct rows'
// keys) where the count from bin 0 reaches kpad: at least kpad rows'
// keys lie at or below it, so the kpad-th key of the table does. The
// largest key where the counts do not reach kpad. Counts read while
// others add are smaller, so the bound only loosens.
__device__ uint64_t hist_bound(const int32_t* h, int kpad) {
  constexpr int kLane = kHistBins / 32;  // bins a lane sums
  const int lane = threadIdx.x & 31;
  const int4* v = reinterpret_cast<const int4*>(h + lane * kLane);
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kLane / 4; ++u) {
    const int4 a = __ldcg(v + u);
    sum += a.x + a.y + a.z + a.w;
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  const unsigned at = __ballot_sync(0xffffffffu,
                                    incl - sum < kpad && kpad <= incl);
  if (at == 0) return kKeyMax;  // the same in the warp
  const int src = __ffs(at) - 1;
  int bin = 0;
  if (lane == src) {
    int acc = incl - sum;
    for (int b = 0; b < kLane; ++b) {
      acc += __ldcg(h + src * kLane + b);
      if (acc >= kpad) {
        bin = src * kLane + b;
        break;
      }
    }
  }
  return bin_top(__shfl_sync(0xffffffffu, bin, src));
}

// one warp adds the keys buf[a .. b) to the histogram h
__device__ __forceinline__ void publish(const uint64_t* buf, int a, int b,
                                        int32_t* h) {
  for (int i = a + (threadIdx.x & 31); i < b; i += 32)
    atomicAdd(h + knn_bin(buf[i]), 1);
}

// the half-width of the box around a query that holds every row whose
// key can be at or below t: such a row's d2 = fl(fl(dx^2) + fl(dy^2)) is
// at most tf (the float of t's high word), so fl(dx^2) <= tf, dx^2 <=
// tf (1 + 2^-24) (or dx^2 underflows, |dx| < 2^-75), and |dx| <=
// sqrt(tf) (1 + 2^-25); each step rounds up. A NaN tf (the empty bound)
// gives a NaN width, which no compare fails.
__device__ __forceinline__ float knn_width(uint64_t t) {
  const float tf = __uint_as_float(static_cast<uint32_t>(t >> 32));
  return __fadd_ru(__fmul_ru(__fsqrt_ru(tf), 1.0000003f), 0x1p-60f);
}

// the shared bound of query q: ~tinv[q] (tinv zeroed by the caller, so
// the empty bound reads as the largest key), lowered by atomicMax
__device__ __forceinline__ uint64_t shared_bound(const uint64_t* tinv, int q) {
  return ~*reinterpret_cast<const volatile uint64_t*>(tinv + q);
}

// The sample pass: block (chunk c, group g) takes the kSampleTiles
// whole tiles (c * kSampleTiles + k) * tstride of kKnTile rows below len
// and queries
// g * G .. g * G + G - 1 (below nq). For each query, each warp and each
// of a thread's four rows, the least f32 d2 over the warp's 32 rows
// (rows >= nrows at +inf, a NaN only where all are) counts in hist1's
// bin of that row's key: distinct rows, so the bin where the counts
// reach kpad bounds the table's kpad-th key.
template <int G>
__global__ void __launch_bounds__(kThreads)
    knn_sample_kernel(const float* __restrict__ px,
                      const float* __restrict__ py, int64_t nrows,
                      const float* __restrict__ qx,
                      const float* __restrict__ qy, int nq, int ngroups,
                      int64_t len, int64_t tstride,
                      int32_t* __restrict__ hist1) {
  const int group = static_cast<int>(blockIdx.x % ngroups);
  const int64_t c = blockIdx.x / ngroups;
  const int q0 = group * G;
  const int live = nq - q0 < G ? nq - q0 : G;  // the same in every thread
  float ax[G], ay[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    ax[j] = j < live ? qx[q0 + j] : 0.f;
    ay[j] = j < live ? qy[q0 + j] : 0.f;
  }
  const bool vec = ((reinterpret_cast<uintptr_t>(px) |
                     reinterpret_cast<uintptr_t>(py)) & 15) == 0;
  // every tile's rows loaded first, so their loads overlap
  float xs[kSampleTiles][4], ys[kSampleTiles][4];
#pragma unroll
  for (int k = 0; k < kSampleTiles; ++k) {
    const int64_t t0 = (c * kSampleTiles + k) * tstride * kKnTile;
    const int64_t r = t0 + 4 * threadIdx.x;
    if (t0 + kKnTile > len) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[k][i] = ys[k][i] = 0.f;
    } else if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(px + r);
      const float4 b = *reinterpret_cast<const float4*>(py + r);
      xs[k][0] = a.x; xs[k][1] = a.y; xs[k][2] = a.z; xs[k][3] = a.w;
      ys[k][0] = b.x; ys[k][1] = b.y; ys[k][2] = b.z; ys[k][3] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xs[k][i] = px[r + i];
        ys[k][i] = py[r + i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSampleTiles; ++k) {
    const int64_t t0 = (c * kSampleTiles + k) * tstride * kKnTile;
    if (t0 + kKnTile > len) break;  // the same in every thread
    const int64_t r = t0 + 4 * threadIdx.x;
    const float* x = xs[k];
    const float* y = ys[k];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j >= live) break;  // the same in every thread
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float d = r + i < nrows ? sq_dist(x[i], y[i], ax[j], ay[j])
                                : __int_as_float(0x7f800000);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          d = fminf(d, __shfl_xor_sync(0xffffffffu, d, o));
        if ((threadIdx.x & 31) == 0)
          atomicAdd(hist1 + (q0 + j) * kHistBins +
                        (d != d ? kHistBins - 1
                                : static_cast<int>(__float_as_uint(d) >>
                                                   (kHistShift - 32))),
                    1);
      }
    }
  }
}

// Rows mode (kKeys false): block (chunk c, group g) takes the ktiles
// tiles (c * ktiles + k) * tstride of kKnTile rows, k < ktiles (tstride 1:
// a contiguous chunk; the sample pass spreads its tiles over the table),
// below len, and queries g * G .. g * G + G - 1 (those below nq); rows
// >= nrows rank as +inf. Keys mode (G 1): block (chunk c, query q) takes
// keys [c * ktiles * kKnTile, ...) of kin + q * in_stride, below
// nin[q]. Each query keeps a buffer of sbuf keys in shared memory and a
// bound t (its own cuts, the shared bound tinv and, in the rows pass,
// the histograms); a key passes if key <= t (in rows mode first by the
// box of half-width knn_width(t) around the query, so a key is built
// only for a row that may pass) and is appended. A buffer holds at most
// cut keys before a tile, so a tile's keys fit. At a tile's barrier
// (__syncthreads_or), where an append filled a buffer past cut keys (or
// the rows pass is after tiles kRefresh0-2), a phase up to one more
// barrier follows in which the warp of each query cuts its buffer and
// lowers t
// (and, at those tiles, adds its new keys to hist2 and takes that
// bound); otherwise the warp of each query just lowers t to the shared
// bound. The rows pass (mode kEmit) starts from the bound of hist1 (the
// sample pass's keys). At the end each query cuts to at most cut keys;
// then by mode: kEmit appends the keys <= t to kout + q * out_stride at
// nout[q] (atomicAdd); kFinal (keys mode, the last pass) sorts them and
// writes the first kpad.
constexpr int kEmit = 0, kFinal = 1;

template <int G, bool kKeys>
__global__ void __launch_bounds__(kThreads)
    knn_select_kernel(const float* __restrict__ px,
                      const float* __restrict__ py, int64_t nrows,
                      const float* __restrict__ qx,
                      const float* __restrict__ qy, int nq, int ngroups,
                      const uint64_t* __restrict__ kin,
                      const int32_t* __restrict__ nin, int64_t in_stride,
                      int64_t len, int ktiles, int64_t tstride, int kpad,
                      int cut, int sbuf, int mode, uint64_t* __restrict__ gbuf,
                      uint64_t* __restrict__ tinv,
                      int32_t* __restrict__ hist1, int32_t* __restrict__ hist2,
                      uint64_t* __restrict__ kout,
                      int32_t* __restrict__ nout, int64_t out_stride,
                      float* __restrict__ d2_out,
                      int64_t* __restrict__ idx_out) {
  constexpr int kPer4 = kKnTile / kThreads;  // entries a thread a tile
  // the buffers: rows mode in device memory (gbuf, G * sbuf keys a
  // block: they take few keys once the bound is seeded, so shared memory
  // holds only the cuts' counters and more blocks fit an SM), keys mode
  // in shared memory before the counters
  extern __shared__ __align__(16) unsigned char knn_smem[];
  uint64_t* buf = kKeys ? reinterpret_cast<uint64_t*>(knn_smem)
                        : gbuf + static_cast<int64_t>(blockIdx.x) * G * sbuf;
  int* cuts = reinterpret_cast<int*>(knn_smem) +
              (kKeys ? 2 * static_cast<int64_t>(sbuf) : 0);
  __shared__ uint64_t s_thr[G];
  __shared__ float s_tf[G], s_w[G];
  __shared__ int s_fill[G];
  const int group = static_cast<int>(blockIdx.x % ngroups);
  const int64_t c = blockIdx.x / ngroups;
  const int q0 = kKeys ? group : group * G;
  const int live = nq - q0 < G ? nq - q0 : G;  // the same in every thread
  // the tiles: the first row (key) of tile k is tile0 + k * tstep, below
  // limit
  const int64_t tile0 = c * ktiles * tstride * kKnTile;
  const int64_t tstep = tstride * kKnTile;
  const int64_t limit = kKeys ? static_cast<int64_t>(nin[q0]) : len;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const bool seeded = !kKeys && mode == kEmit;
  int pub = 0;  // warp j: the keys of query j's buffer published
  if (warp < live) {
    uint64_t t = shared_bound(tinv, q0 + warp);
    if (seeded) {
      const uint64_t u = hist_bound(hist1 + (q0 + warp) * kHistBins, kpad);
      t = u < t ? u : t;
    }
    if (lane == 0) {
      s_thr[warp] = t;
      s_tf[warp] = __uint_as_float(static_cast<uint32_t>(t >> 32));
      s_w[warp] = knn_width(t);
      s_fill[warp] = 0;
    }
  } else if (warp < G && lane == 0) {
    s_thr[warp] = 0;
    s_fill[warp] = 0;
  }
  float ax[G], ay[G], tf[G], w[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    ax[j] = !kKeys && j < live ? qx[q0 + j] : 0.f;
    ay[j] = !kKeys && j < live ? qy[q0 + j] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < G; ++j) {
    tf[j] = s_tf[j];
    w[j] = s_w[j];
  }
  uint64_t thr0 = s_thr[0];  // keys mode: the bound in a register
  const uint64_t* kq = kKeys ? kin + q0 * in_stride : nullptr;
  const bool vec = !kKeys && ((reinterpret_cast<uintptr_t>(px) |
                               reinterpret_cast<uintptr_t>(py)) & 15) == 0;
  // entries of the tile at t0: rows t0 + 4 * tid + i (rows mode: one
  // 16-byte load of x and one of y where the tile is whole), keys t0 +
  // i * kThreads + tid (keys mode); the next tile's loads are issued
  // before this one is tested, and the rows kKnAhead tiles on are
  // brought into L2
  auto load = [&](int64_t t0, float* lx, float* ly, uint64_t* lk) {
    if (kKeys) {
#pragma unroll
      for (int i = 0; i < kPer4; ++i) {
        const int64_t e = t0 + i * kThreads + threadIdx.x;
        lk[i] = e < limit ? kq[e] : kKeyMax;
      }
    } else {
      const int64_t r = t0 + 4 * threadIdx.x;
      if (vec && t0 + kKnTile <= limit) {
        const float4 a = *reinterpret_cast<const float4*>(px + r);
        const float4 b = *reinterpret_cast<const float4*>(py + r);
        lx[0] = a.x; lx[1] = a.y; lx[2] = a.z; lx[3] = a.w;
        ly[0] = b.x; ly[1] = b.y; ly[2] = b.z; ly[3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < kPer4; ++i) {
          lx[i] = r + i < limit ? px[r + i] : 0.f;
          ly[i] = r + i < limit ? py[r + i] : 0.f;
        }
      }
    }
  };
  float cx[kPer4], cy[kPer4], nx[kPer4], ny[kPer4];
  uint64_t ck[kPer4], nk[kPer4];
  if (ktiles > 0 && tile0 < limit) load(tile0, cx, cy, ck);
  for (int k = 0; k < ktiles; ++k) {
    const int64_t t0 = tile0 + k * tstep;
    if (t0 >= limit) break;  // the same in every thread
    const int64_t end = t0 + kKnTile < limit ? t0 + kKnTile : limit;
    if (k + 1 < ktiles && t0 + tstep < limit) load(t0 + tstep, nx, ny, nk);
    if (!kKeys && k + kKnAhead < ktiles) {
      const int64_t ra = t0 + kKnAhead * tstep + 4 * threadIdx.x;
      if (ra < limit) {
        prefetch_l2(px + ra);
        prefetch_l2(py + ra);
      }
    }
    // the shared bound, read early for the refresh after the tile
    uint64_t tg = kKeyMax;
    if (warp < live && lane == 0) tg = shared_bound(tinv, q0 + warp);
    // the test, and the passing keys appended: the buffers hold at most
    // cut keys before a tile, so a tile's kKnTile fit
    const int64_t r = t0 + 4 * threadIdx.x;
    bool over = false;  // an append of this thread filled past cut
    if (kKeys) {
#pragma unroll
      for (int i = 0; i < kPer4; ++i) {
        if (t0 + i * kThreads + threadIdx.x < end && ck[i] <= thr0) {
          const int slot = atomicAdd(&s_fill[0], 1);
          buf[slot] = ck[i];
          over |= slot >= cut;
        }
      }
    } else {
      // rows mode: inside the query's box of half-width w[j] (a superset
      // of the rows whose key is at or below the bound), then the key
      auto test = [&](auto whole) {
        constexpr bool kWhole = decltype(whole)::value;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (j >= live) break;  // the same in every thread
          bool p[kPer4];
          bool any = false;
#pragma unroll
          for (int i = 0; i < kPer4; ++i) {
            const float dx = __fsub_rn(cx[i], ax[j]);
            const float dy = __fsub_rn(cy[i], ay[j]);
            p[i] = !(fabsf(dx) > w[j]) & !(fabsf(dy) > w[j]);
            if (!kWhole)
              p[i] = r + i < end && (r + i < nrows
                                         ? p[i]
                                         : !(__int_as_float(0x7f800000) >
                                             tf[j]));
            any |= p[i];
          }
          if (any) {
            const uint64_t t = s_thr[j];
#pragma unroll
            for (int i = 0; i < kPer4; ++i) {
              const float d = kWhole || r + i < nrows
                                  ? sq_dist(cx[i], cy[i], ax[j], ay[j])
                                  : __int_as_float(0x7f800000);
              const uint64_t key = knn_key(d, r + i);
              if (p[i] && key <= t) {
                const int slot = atomicAdd(&s_fill[j], 1);
                buf[static_cast<int64_t>(j) * sbuf + slot] = key;
                over |= slot >= cut;
              }
            }
          }
        }
      };
      if (end == t0 + kKnTile && end <= nrows)  // the same in every thread
        test(std::true_type{});
      else
        test(std::false_type{});
    }
    // the tile's keys are in the buffers; a cut is due where a buffer
    // holds more than cut keys (the append at slot cut saw it), a
    // refresh of the rows pass's histogram after tiles kRefresh
    const bool refresh =
        seeded && (k == kRefresh0 || k == kRefresh1 || k == kRefresh2);
    const bool slow = __syncthreads_or(over || refresh);
    if (warp < live) {  // the shared bound, where it is lower
      tg = __shfl_sync(0xffffffffu, tg, 0);
      if (lane == 0 && !slow && tg < s_thr[warp]) {
        s_thr[warp] = tg;  // readers of the old bound keep valid keys
        s_tf[warp] = __uint_as_float(static_cast<uint32_t>(tg >> 32));
        s_w[warp] = knn_width(tg);
      }
    }
    if (slow) {
      if (warp < live) {  // a warp a query: cut, refresh the bound
        const int j = warp;
        uint64_t* b = buf + static_cast<int64_t>(j) * sbuf;
        uint64_t t = s_thr[j];
        t = tg < t ? tg : t;
        int n = s_fill[j];
        if (n > cut) {
          const uint64_t u =
              warp_cut(b, n, kpad, cut, cuts + warp * kCutWords, &n, &pub);
          t = u < t ? u : t;
          if (lane == 0)
            atomicMax(reinterpret_cast<unsigned long long*>(tinv + q0 + j),
                      static_cast<unsigned long long>(~u));
        }
        if (refresh) {
          int32_t* h = hist2 + (q0 + j) * kHistBins;
          publish(b, pub, n, h);
          pub = n;
          __syncwarp();
          const uint64_t u = hist_bound(h, kpad);
          t = u < t ? u : t;
          if (lane == 0 && u != kKeyMax)
            atomicMax(reinterpret_cast<unsigned long long*>(tinv + q0 + j),
                      static_cast<unsigned long long>(~u));
        }
        if (lane == 0) {
          s_fill[j] = n;
          s_thr[j] = t;
          s_tf[j] = __uint_as_float(static_cast<uint32_t>(t >> 32));
          s_w[j] = knn_width(t);
        }
      }
      __syncthreads();  // the bounds and fills are set
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      tf[j] = s_tf[j];
      w[j] = s_w[j];
    }
    thr0 = s_thr[0];
#pragma unroll
    for (int i = 0; i < kPer4; ++i) {
      if (kKeys) {
        ck[i] = nk[i];
      } else {
        cx[i] = nx[i];
        cy[i] = ny[i];
      }
    }
  }
  __syncthreads();  // the last tile's keys are in the buffers
  // the last cut, then the keys <= t out
  int n = 0;
  uint64_t t = 0;
  if (warp < live) {
    const int j = warp;
    uint64_t* b = buf + static_cast<int64_t>(j) * sbuf;
    n = s_fill[j];
    t = s_thr[j];
    const uint64_t tg = shared_bound(tinv, q0 + j);
    t = tg < t ? tg : t;
    if (n > cut) {
      const uint64_t u =
          warp_cut(b, n, kpad, cut, cuts + warp * kCutWords, &n, &pub);
      t = u < t ? u : t;
      if (lane == 0)
        atomicMax(reinterpret_cast<unsigned long long*>(tinv + q0 + j),
                  static_cast<unsigned long long>(~u));
    }
    if (mode == kEmit) {
      int m = 0;
      for (int i = lane; i < n; i += 32) m += b[i] <= t;
      m = __reduce_add_sync(0xffffffffu, m);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(nout + q0 + j, m);
      base = __shfl_sync(0xffffffffu, base, 0);
      uint64_t* out = kout + (q0 + j) * out_stride;
      const unsigned lt = (1u << lane) - 1;
      for (int i0 = 0; i0 < n; i0 += 32) {
        const int i = i0 + lane;
        const bool keep = i < n && b[i] <= t;
        const unsigned mk = __ballot_sync(0xffffffffu, keep);
        if (keep) out[base + __popc(mk & lt)] = b[i];
        base += __popc(mk);
      }
    } else if (lane == 0) {
      s_fill[0] = n;
      s_thr[0] = t;
    }
  }
  if (mode != kFinal) return;  // the same in every thread
  // the final pass (keys mode, one query): the kept keys <= t, then
  // empty keys up to a power of two, sorted; the first kpad out
  __syncthreads();
  n = s_fill[0];
  t = s_thr[0];
  int head = 1;
  while (head < n || head < kpad) head <<= 1;
  for (int i = threadIdx.x; i < head; i += kThreads)
    if (i >= n || buf[i] > t) buf[i] = kKeyMax;
  __syncthreads();
  bitonic_sort(buf, head);
  for (int i = threadIdx.x; i < kpad; i += kThreads) {
    const uint64_t k = buf[i];
    d2_out[static_cast<int64_t>(q0) * kpad + i] =
        __uint_as_float(static_cast<uint32_t>(k >> 32));
    idx_out[static_cast<int64_t>(q0) * kpad + i] =
        static_cast<int64_t>(k & 0xffffffffull);
  }
}

// the dynamic shared memory of a block: (keys mode) a buffer of sbuf
// keys, and the cuts' counters
size_t knn_smem_bytes(bool keys, int sbuf) {
  return (keys ? static_cast<size_t>(sbuf) * sizeof(uint64_t) : 0) +
         static_cast<size_t>(kThreads / 32) * kCutWords * sizeof(int);
}

template <int G, bool kKeys>
cudaError_t knn_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      knn_select_kernel<G, kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(knn_smem_bytes(true, kKnMaxBuf)));
  return err;
}

template <int G>
cudaError_t knn_rows_occupancy(int sbuf, int* per_sm) {
  const cudaError_t err = knn_opt_in<G, false>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, knn_select_kernel<G, false>, kThreads,
      knn_smem_bytes(false, sbuf));
}

template <int G, bool kKeys>
cudaError_t knn_launch(int64_t blocks, int sbuf, cudaStream_t s,
                       const float* px, const float* py, int64_t nrows,
                       const float* qx, const float* qy, int nq, int ngroups,
                       const uint64_t* kin, const int32_t* nin,
                       int64_t in_stride, int64_t len, int ktiles,
                       int64_t tstride, int kpad, int cut, int mode,
                       uint64_t* gbuf, uint64_t* tinv, int32_t* hist1,
                       int32_t* hist2, uint64_t* kout, int32_t* nout,
                       int64_t out_stride, float* d2_out, int64_t* idx_out) {
  const cudaError_t err = knn_opt_in<G, kKeys>();
  if (err != cudaSuccess) return err;
  knn_select_kernel<G, kKeys><<<static_cast<unsigned>(blocks), kThreads,
                                knn_smem_bytes(kKeys, sbuf), s>>>(
      px, py, nrows, qx, qy, nq, ngroups, kin, nin, in_stride, len, ktiles,
      tstride, kpad, cut, sbuf, mode, gbuf, tinv, hist1, hist2, kout, nout,
      out_stride, d2_out, idx_out);
  return cudaGetLastError();
}

// a rows-mode launch by the plan's group size
cudaError_t knn_rows_launch(int g, int64_t blocks, int sbuf, cudaStream_t s,
                            const float* px, const float* py, int64_t nrows,
                            const float* qx, const float* qy, int nq,
                            int groups, int64_t len, int ktiles,
                            int64_t tstride, int kpad, int cut, int mode,
                            uint64_t* gbuf, uint64_t* tinv, int32_t* hist1,
                            int32_t* hist2, uint64_t* kout, int32_t* nout,
                            int64_t out_stride) {
  const auto run = [&](auto launch) {
    return launch(blocks, sbuf, s, px, py, nrows, qx, qy, nq, groups,
                  nullptr, nullptr, 0, len, ktiles, tstride, kpad, cut, mode,
                  gbuf, tinv, hist1, hist2, kout, nout, out_stride, nullptr,
                  nullptr);
  };
  return g == 8   ? run(knn_launch<8, false>)
         : g == 4 ? run(knn_launch<4, false>)
         : g == 2 ? run(knn_launch<2, false>)
                  : run(knn_launch<1, false>);
}

}  // namespace

extern "C" {


// The tile, group and window constants the wrappers must agree with:
// 0 kTile, 1 kGroup, 2 kSlabGroup, 3 kKnMaxKpad.
int geomesa_join_constant(int which) {
  switch (which) {
    case 0: return kTile;
    case 1: return kGroup;
    case 2: return kSlabGroup;
    case 3: return kKnMaxKpad;
    default: return -1;
  }
}

// The tile-major calls' common arguments: the x-sorted table (xs, ys) of
// ncols > 0 columns, cut into ceil(ncols / kTile) tiles; tile_off
// (int32, one more than the tiles) and tile_obj: the objects whose slab
// meets each tile, ascending within it; groups (1 to 65535): blocks a
// tile, ceil(the longest list / kGroup).

// definite[q], band[q] (zeroed by the caller) += the counts of every
// column of each tile that lists q against query (qx[q], qy[q]).
int geomesa_dwithin_counts(const float* xs, const float* ys, int64_t ncols,
                           const int32_t* tile_off, const int32_t* tile_obj,
                           int groups, const float* qx, const float* qy,
                           float r2_hi, float r2_lo, int32_t* definite,
                           int32_t* band, void* stream) {
  const int64_t tiles = (ncols + kTile - 1) / kTile;
  if (ncols < 1 || tiles > INT_MAX || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dwithin_counts_kernel<<<dim3(static_cast<unsigned>(tiles),
                               static_cast<unsigned>(groups)),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xs, ys, ncols, tile_off, tile_obj, qx, qy, r2_hi, r2_lo, definite,
      band);
  return static_cast<int>(cudaGetLastError());
}

// The slab pairs' counts pass over the tile-major lists (groups: blocks
// a tile, ceil(the longest list / kSlabGroup)), perm: each entry's
// object-major index. box: qa is (k, 4) [xmin ymin xmax ymax], else (k,
// 2) [qx qy]. counts[perm[e]]: entry e's matches; bits[perm[e] *
// kWords ...]: their bitmap over the tile's columns (the words of the
// slab's span).
int geomesa_slab_counts(const float* xs, const float* ys, int64_t ncols,
                        const int32_t* tile_off, const int32_t* tile_obj,
                        int groups, const int64_t* perm, const int32_t* los,
                        const int32_t* widths, int box, const float* qa,
                        float r2_hi, float eps, int32_t* counts,
                        uint32_t* bits, void* stream) {
  const int64_t tiles = (ncols + kTile - 1) / kTile;
  if (ncols < 1 || tiles > INT_MAX || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  auto s = static_cast<cudaStream_t>(stream);
  if (box)
    slab_count_kernel<true><<<grid, kThreads, 0, s>>>(
        xs, ys, ncols, tile_off, tile_obj, perm, los, widths, qa, r2_hi, eps,
        counts, bits);
  else
    slab_count_kernel<false><<<grid, kThreads, 0, s>>>(
        xs, ys, ncols, tile_off, tile_obj, perm, los, widths, qa, r2_hi, eps,
        counts, bits);
  return static_cast<int>(cudaGetLastError());
}

// The write pass over the same lists: each entry's matches, in column
// order, at incl[perm[e]] - counts[perm[e]] (incl: the inclusive prefix
// of counts, int64) of rows_out (order[col]) and qi_out (the query).
int geomesa_slab_write(const int32_t* order, int64_t ncols,
                       const int32_t* tile_off, const int32_t* tile_obj,
                       int groups, const int64_t* perm, const int32_t* los,
                       const int32_t* widths, const int32_t* counts,
                       const int64_t* incl, const uint32_t* bits,
                       int32_t* rows_out, int32_t* qi_out, void* stream) {
  const int64_t tiles = (ncols + kTile - 1) / kTile;
  if (ncols < 1 || tiles > INT_MAX || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  slab_write_kernel<<<dim3(static_cast<unsigned>(tiles),
                           static_cast<unsigned>(groups)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      order, ncols, tile_off, tile_obj, perm, los, widths, counts, incl, bits,
      rows_out, qi_out);
  return static_cast<int>(cudaGetLastError());
}

// The polygons' edge terms into terms ((kp, ne, 4) f32 scratch) for
// the contains kernels; edges (kp, ne, 4) and boxes (kp, 4), both
// 16-byte aligned, the first ecount[p] edges of polygon p valid.

// The counts pass over the tile-major lists of polygons: dc[p], bc[p]
// (zeroed by the caller) += the definite and band counts of polygon p;
// cband[e] the band count of list entry e of tile_obj.
int geomesa_contains_counts(const float* xs, const float* ys, int64_t ncols,
                            const int32_t* tile_off, const int32_t* tile_obj,
                            int groups, const int32_t* los,
                            const int32_t* widths, const float* boxes,
                            const float* edges, const int32_t* ecount, int kp,
                            int ne, float eps, float eps2, float* terms,
                            int32_t* dc, int32_t* bc, int32_t* cband,
                            void* stream) {
  const int64_t tiles = (ncols + kTile - 1) / kTile;
  if (ncols < 1 || tiles > INT_MAX || groups < 1 || groups > 65535 ||
      kp < 1 || ne < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(kp) * ne;
  edge_terms_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(edges), ecount, ne, n,
      reinterpret_cast<float4*>(terms));
  contains_counts_kernel<<<dim3(static_cast<unsigned>(tiles),
                                static_cast<unsigned>(groups)),
                           kThreads, 0, s>>>(
      xs, ys, ncols, tile_off, tile_obj, los, widths,
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(edges),
      reinterpret_cast<const float4*>(terms), ecount, ne, eps, eps2, dc, bc,
      cband);
  return static_cast<int>(cudaGetLastError());
}

// The rows pass over `items` work items (item: int32 quadruples (tile,
// polygon, slot, offset)): the band rows of the tile's columns inside
// the polygon's slab, in column order, into rows_out[slot] from the
// offset on, at most cap_rows a slot (rows_out (slots, cap_rows),
// pre-filled with -1 by the caller). The offset is the band rows of the
// polygon's earlier tiles (from the counts pass's cband). Requires
// items > 0.
int geomesa_contains_band_rows(const float* xs, const float* ys,
                               const int32_t* order, int64_t ncols,
                               const int32_t* los, const int32_t* widths,
                               const int32_t* item, int64_t items,
                               const float* boxes, const float* edges,
                               const int32_t* ecount, int kp, int ne,
                               float eps, float eps2, float* terms,
                               int cap_rows, int32_t* rows_out,
                               void* stream) {
  if (items < 1 || items > INT_MAX || cap_rows < 1 || kp < 1 || ne < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(kp) * ne;
  edge_terms_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(edges), ecount, ne, n,
      reinterpret_cast<float4*>(terms));
  contains_rows_kernel<<<static_cast<unsigned>(items), kThreads, 0, s>>>(
      xs, ys, order, ncols, los, widths, reinterpret_cast<const int4*>(item),
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(edges),
      reinterpret_cast<const float4*>(terms), ecount, ne, eps, eps2,
      cap_rows, rows_out);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a knn call over len rows (0 < kpad <= len, kKnMaxKpad at
// most) and nq queries, into plan[0..10): 0 G (queries a block), 1
// groups (ceil(nq / G)), 2 chunks and 3 chunk (rows a rows block, a
// multiple of kKnTile), 4 cut (keys a block keeps at most), 5 sbuf (a
// buffer's keys), 6 stride (survivor slots a query: chunks * cut), 7
// samples (sample blocks a group, kSampleTiles tiles each) and 8
// sample_stride (in tiles), 9 launches. G: the least power of two up to
// kKnMaxGroup at or above nq; chunks:
// the blocks the card holds at once over the groups, at most kKnChunks,
// each of at least 4 kKnTile rows; the sample: about a 32nd of the
// tiles, spread over the table. Returns 0, or an error where the
// occupancy cannot be read.
int geomesa_knn_plan(int64_t len, int nq, int kpad, int64_t* plan) {
  if (len < 1 || nq < 1 || kpad < 1 || kpad > kKnMaxKpad || kpad > len)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cut = kpad + kpad / 4;
  int p2 = 1;
  while (p2 < cut) p2 <<= 1;
  const int sbuf = cut + kKnTile > p2 ? cut + kKnTile : p2;
  int g = kKnMaxGroup;
  while (g > 1 && g / 2 >= nq) g /= 2;
  const int groups = (nq + g - 1) / g;
  const int sms = sm_count();
  int per_sm = 0;
  cudaError_t err =
      g == 8 ? knn_rows_occupancy<8>(sbuf, &per_sm)
      : g == 4 ? knn_rows_occupancy<4>(sbuf, &per_sm)
      : g == 2 ? knn_rows_occupancy<2>(sbuf, &per_sm)
               : knn_rows_occupancy<1>(sbuf, &per_sm);
  if (err == cudaSuccess && (sms < 1 || per_sm < 1)) err = cudaErrorUnknown;
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t chunks = static_cast<int64_t>(per_sm) * sms / groups;
  chunks = chunks < 1 ? 1 : (chunks > kKnChunks ? kKnChunks : chunks);
  int64_t chunk = (len + chunks - 1) / chunks;
  chunk = (chunk + kKnTile - 1) / kKnTile * kKnTile;
  chunk = chunk > 4 * kKnTile ? chunk : 4 * kKnTile;
  chunks = (len + chunk - 1) / chunk;
  const int64_t tiles = (len + kKnTile - 1) / kKnTile;
  int64_t samples = tiles / (32 * kSampleTiles);
  samples = samples < 1 ? 1 : (samples > 4096 ? 4096 : samples);
  int64_t sstride = tiles / (samples * kSampleTiles);
  sstride = sstride < 1 ? 1 : sstride;
  plan[0] = g;
  plan[1] = groups;
  plan[2] = chunks;
  plan[3] = chunk;
  plan[4] = cut;
  plan[5] = sbuf;
  plan[6] = chunks * cut;
  plan[7] = samples;
  plan[8] = sstride;
  plan[9] = 3;
  return 0;
}

// The knn call by its plan: per query point (qx[q], qy[q]), q < nq, the
// kpad smallest keys (d2, row) over rows 0 .. len - 1 of (px, py), rows
// >= nrows at +inf, ascending, as d2_out (nq, kpad) f32 and idx_out (nq,
// kpad) int64. The sample pass (groups * samples blocks) counts its
// warps' least keys in hist1; the rows pass (groups * chunks blocks)
// leaves at most cut keys a block a query in surv (nq, stride), counted
// in counts[q], its buffers in gbuf (groups * chunks * G * sbuf keys);
// the final pass (nq blocks) cuts and sorts each query's. hist1 and
// hist2 (nq x kHistBins int32 each, 16-byte aligned), tinv (nq words)
// and counts (nq) are zeroed by the caller.
int geomesa_knn_topk(const float* px, const float* py, int64_t nrows,
                     const float* qx, const float* qy, int64_t len, int nq,
                     int kpad, const int64_t* plan, int32_t* hist1,
                     int32_t* hist2, uint64_t* tinv, int32_t* counts,
                     uint64_t* gbuf, uint64_t* surv, float* d2_out,
                     int64_t* idx_out, void* stream) {
  const int g = static_cast<int>(plan[0]);
  const int groups = static_cast<int>(plan[1]);
  const int64_t chunks = plan[2], chunk = plan[3];
  const int cut = static_cast<int>(plan[4]);
  const int sbuf = static_cast<int>(plan[5]);
  const int64_t stride = plan[6], samples = plan[7], sstride = plan[8];
  if (len < 1 || nq < 1 || kpad < 1 || kpad > kKnMaxKpad || chunk < 1 ||
      chunk % kKnTile || chunk / kKnTile > INT_MAX || sbuf > kKnMaxBuf ||
      samples < 1 || sstride < 1 || groups * g < nq ||
      chunks * groups > INT_MAX || samples * groups > INT_MAX ||
      chunks * chunk < len || (g != 1 && g != 2 && g != 4 && g != 8) ||
      (reinterpret_cast<uintptr_t>(hist1) |
       reinterpret_cast<uintptr_t>(hist2)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto sample = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(samples * groups), kThreads, 0, s>>>(
        px, py, nrows, qx, qy, nq, groups, len, sstride, hist1);
    return cudaGetLastError();
  };
  cudaError_t err = g == 8   ? sample(knn_sample_kernel<8>)
                    : g == 4 ? sample(knn_sample_kernel<4>)
                    : g == 2 ? sample(knn_sample_kernel<2>)
                             : sample(knn_sample_kernel<1>);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = knn_rows_launch(g, chunks * groups, sbuf, s, px, py, nrows, qx, qy,
                        nq, groups, len, static_cast<int>(chunk / kKnTile), 1,
                        kpad, cut, kEmit, gbuf, tinv, hist1, hist2, surv,
                        counts, stride);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the final pass takes every survivor of its query in one chunk
  const int64_t ftiles = (stride + kKnTile - 1) / kKnTile;
  return static_cast<int>(knn_launch<1, true>(
      nq, sbuf, s, nullptr, nullptr, 0, nullptr, nullptr, nq, nq, surv,
      counts, stride, 0, static_cast<int>(ftiles), 1, kpad, cut, kFinal,
      nullptr, tinv, nullptr, nullptr, nullptr, nullptr, 0, d2_out,
      idx_out));
}

}  // extern "C"
