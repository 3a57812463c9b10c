// Spatial-join and KNN kernels for Hopper (sm_90a).
//
// Replace the XLA programs of the reference package's analytics joins
// (geomesa_tpu/analytics/join.py), which serve dwithin_join,
// contains_join, knn_batched / knn and the processes above them:
//
// The x-sorted table and its tiles. J1 and J3 walk the rows sorted by x
// (xs, ys: the rows' f32 coordinates in x order, padded rows at x = +inf,
// y = NaN, so no test passes them), cut into tiles of kTile columns
// aligned to 0. Each query or polygon has a slab [lo, lo + width) of the
// table that holds every row it can match; the wrapper lists, per tile,
// the objects whose slab meets it (tile_off, tile_obj: a CSR built on
// the device by torch ops, objects ascending within a tile). A block
// takes one tile and up to kGroup of its listed objects: it copies the
// tile's xs and ys into shared memory once (cp.async, 16 bytes a copy),
// and every listed object is tested from there. So a column is read
// from device memory once for all the slabs that cover it. Several
// blocks reside on each SM (40 KB of shared memory each at most), so
// one block's copy overlaps another's tests.
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
// slab_pairs_kernel       <- _slab_cand_mask (:123) with
//   _slab_cand_count (:137) and _slab_cand_flat (:148) in radius mode;
//   _contains_cand_mask (:473) with _contains_cand_count (:493) and
//   _contains_cand_flat (:501) in box mode. Over each query's x-slab
//   [lo, lo + width) of the x-sorted table (xs, ys: the rows' f32
//   coordinates in sorted order, padded rows at x = +inf, y = NaN, so no
//   test passes them), a column matches where
//     radius mode: (xs - qx)^2 + (ys - qy)^2 <= r2_hi
//     box mode:    xs >= fl(xmin - eps) && xs <= fl(xmax + eps) &&
//                  ys >= fl(ymin - eps) && ys <= fl(ymax + eps)
//   Two passes of one kernel over work items, one block each: a query's
//   chunks of kSlabChunk columns, listed as (query, chunk) pairs by the
//   host (one load a block finds its query). A count per item, then, at
//   each item's exclusive-prefix offset (computed on the host from the
//   counts), the matches in column order: order[lo + col] and the
//   query's index. So the output is jnp.flatnonzero of the
//   reference's (query, column) grid, query-major and column-ascending,
//   already mapped to row ids. It reads xs and ys contiguously and order
//   only for the rows it writes. Bound: 8 B a slab column (+ 8 B a
//   match written).
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
// knn_select_kernel       <- _knn_kernel (:635). Per query, the kpad
//   smallest keys (d2, row) in lexicographic order, where d2 is the f32
//   (px - qx)^2 + (py - qy)^2 rounded at every step, +inf for rows >=
//   nrows, every NaN one NaN ranked above +inf; ties go to the lower row
//   id. That is lax.top_k's order on -d2 (and its two-stage form at
//   :651-664). The key is one 64-bit word, d2's bits (monotone for d2 >=
//   0) above the row id. Design: a block takes one query and a chunk of
//   rows (or of an earlier stage's keys); it keeps its best kpad keys at
//   the head of a shared buffer, appends every key below the current
//   kpad-th to the rest of the buffer, and when the buffer may not take
//   another tile it finds the new kpad-th key by an 8-bit radix select
//   over the buffer (eight histogram rounds, linear in the buffer; a
//   bitonic sort of the whole buffer made the kernel about twice as
//   slow, PERF.md section 6), gathers
//   the keys below it at the head and takes it as the threshold; at the
//   end the head is sorted (bitonic). A tile is 2048 entries, eight a
//   thread, with the next tile's loads in flight while it is ranked and
//   32-bit offsets into the block's chunk. Each chunk leaves its best
//   kpad; a further stage over those keys repeats until one chunk is
//   left. The blocks of one chunk are the queries, next to each other in
//   the grid, so they share the chunk's reads through L2. Bound: 8 B a
//   row read once.
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
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads of every join block
constexpr int kTile = 2048;      // columns of the x-sorted table a tile
constexpr int kPer = kTile / kThreads;  // a tile's columns a thread
constexpr int kDwQpt = 4;        // dwithin queries a thread
constexpr int kGroup = kThreads * kDwQpt;  // listed objects a block takes
constexpr int kWarpPairs = 32 * kPer + 32;  // a warp's contains pairs
constexpr int kSlabChunk = 2048; // slab columns per work item
constexpr int kKnTile = 2048;    // knn keys per tile (eight a thread)
constexpr int kKnMaxBuf = 16384; // largest knn buffer (128 KB)

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
// the tile lists fewer than blockIdx.y * kGroup + 1 objects
struct TileWork {
  int b, m, n;
  int64_t t0;
};

__device__ __forceinline__ TileWork tile_work(const int32_t* tile_off,
                                              int64_t ncols) {
  TileWork w;
  const int64_t tile = blockIdx.x;
  w.b = tile_off[tile] + static_cast<int>(blockIdx.y) * kGroup;
  const int e = tile_off[tile + 1];
  w.m = e - w.b < 0 ? 0 : (e - w.b < kGroup ? e - w.b : kGroup);
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

// -- J2: slab candidate pairs -----------------------------------------------

template <bool kBox, bool kWrite>
__global__ void __launch_bounds__(kThreads)
    slab_pairs_kernel(const float* __restrict__ xs,
                      const float* __restrict__ ys,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ los,
                      const int32_t* __restrict__ widths,
                      const int2* __restrict__ item,
                      const float* __restrict__ qa, float r2_hi, float eps,
                      int32_t* __restrict__ counts,
                      const int64_t* __restrict__ offsets,
                      int32_t* __restrict__ rows_out,
                      int32_t* __restrict__ qi_out) {
  __shared__ int s_scan[2 * kThreads];
  const int64_t b = blockIdx.x;
  const int2 it = item[b];  // (query, chunk)
  const int q = it.x;
  const int64_t lo = los[q];
  const int64_t c0 = static_cast<int64_t>(it.y) * kSlabChunk;
  const int64_t c1 =
      c0 + kSlabChunk < widths[q] ? c0 + kSlabChunk : widths[q];
  float a0, a1, a2 = 0.f, a3 = 0.f;
  if (kBox) {  // the widened box, each bound rounded as the reference's
    a0 = __fsub_rn(qa[4 * q], eps);
    a1 = __fsub_rn(qa[4 * q + 1], eps);
    a2 = __fadd_rn(qa[4 * q + 2], eps);
    a3 = __fadd_rn(qa[4 * q + 3], eps);
  } else {
    a0 = qa[2 * q];
    a1 = qa[2 * q + 1];
  }
  int64_t base = kWrite ? offsets[b] : 0;
  int total = 0;
  for (int64_t s0 = c0; s0 < c1; s0 += kThreads) {
    const int64_t col = s0 + threadIdx.x;
    bool hit = false;
    if (col < c1) {
      const float x = xs[lo + col];
      const float y = ys[lo + col];
      hit = kBox ? (x >= a0 && x <= a2 && y >= a1 && y <= a3)
                 : sq_dist(x, y, a0, a1) <= r2_hi;
    }
    const int step = __syncthreads_count(hit);  // the same in every thread
    if (kWrite && step) {
      const int rank = block_exclusive(hit, s_scan);
      if (hit) {
        rows_out[base + rank] = order[lo + col];
        qi_out[base + rank] = q;
      }
      base += step;
    }
    total += step;
  }
  if (!kWrite && threadIdx.x == 0) counts[b] = total;
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

__device__ __forceinline__ bool in_box(const float4& g, float x, float y) {
  return x >= g.x && x <= g.z && y >= g.y && y <= g.w;
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

// the k-th smallest (1-based) of the n keys of buf, by an 8-bit radix
// select from the top digit down; every thread calls it (hist: 2 *
// kThreads ints of shared memory, sel: 2)
__device__ uint64_t block_select(const uint64_t* buf, int n, int k,
                                 int* hist, int* sel) {
  uint64_t prefix = 0;
  int need = k;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t hi_mask = shift == 56 ? 0ull : (~0ull << (shift + 8));
    hist[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint64_t key = buf[i];
      if ((key & hi_mask) == prefix)
        atomicAdd(&hist[static_cast<int>((key >> shift) & 255)], 1);
    }
    __syncthreads();
    const int own = hist[threadIdx.x];
    const int before = block_exclusive(own, hist);
    if (before < need && need <= before + own) {
      sel[0] = threadIdx.x;
      sel[1] = need - before;
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(sel[0]) << shift;
    need = sel[1];
    __syncthreads();
  }
  return prefix;
}

template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
    knn_select_kernel(const float* __restrict__ px,
                      const float* __restrict__ py, int64_t nrows,
                      const float* __restrict__ qx,
                      const float* __restrict__ qy,
                      const uint64_t* __restrict__ keys_in, int64_t len,
                      int nq, int kpad, int sbuf, int64_t chunk,
                      int64_t nchunks, uint64_t* __restrict__ keys_out) {
  constexpr int kPer = kKnTile / kThreads;  // entries a thread a tile
  extern __shared__ uint64_t buf[];
  __shared__ int s_fill, s_cnt;
  __shared__ uint64_t s_thr;
  __shared__ int s_hist[2 * kThreads], s_sel[2];
  const int q = static_cast<int>(blockIdx.x % nq);
  const int64_t c = blockIdx.x / nq;
  const int64_t begin = c * chunk;
  const int64_t end = begin + chunk < len ? begin + chunk : len;
  const int n_all = static_cast<int>(end - begin);
  const int64_t live = nrows - begin;  // rows of the chunk below nrows
  const int n_real =
      kKeys ? n_all
            : static_cast<int>(live < 0 ? 0 : (live < n_all ? live : n_all));
  const float* xb = px + begin;
  const float* yb = py + begin;
  const uint32_t rbase = static_cast<uint32_t>(begin);
  for (int i = threadIdx.x; i < sbuf; i += kThreads) buf[i] = kKeyMax;
  if (threadIdx.x == 0) {
    s_fill = 0;
    s_thr = kKeyMax;
  }
  __syncthreads();
  const float ax = kKeys ? 0.f : qx[q];
  const float ay = kKeys ? 0.f : qy[q];
  const uint64_t* kin =
      kKeys ? keys_in + static_cast<int64_t>(q) * len + begin : nullptr;
  const int room = sbuf - kpad - kKnTile;  // merge above this fill
  // entry j of the tile at t0 is t0 + j * kThreads + threadIdx.x; the
  // next tile's loads are issued before this one is ranked
  float cx[kPer], cy[kPer], nx[kPer], ny[kPer];  // rows mode
  uint64_t ck[kPer], nk[kPer];                    // keys mode
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kKeys) {
      ck[j] = i < n_all ? kin[i] : kKeyMax;
    } else {
      cx[j] = i < n_real ? xb[i] : 0.f;
      cy[j] = i < n_real ? yb[i] : 0.f;
    }
  }
  for (int t0 = 0; t0 < n_all; t0 += kKnTile) {
    const int t1 = t0 + kKnTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {  // the next tile's loads
      const int i = t1 + j * kThreads + threadIdx.x;
      if (kKeys) {
        nk[j] = i < n_all ? kin[i] : kKeyMax;
      } else {
        nx[j] = i < n_real ? xb[i] : 0.f;
        ny[j] = i < n_real ? yb[i] : 0.f;
      }
    }
    const uint64_t thr = s_thr;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = t0 + j * kThreads + threadIdx.x;
      if (i < n_all) {
        uint64_t key;
        if (kKeys) {
          key = ck[j];
        } else {
          const float d2 = i < n_real ? sq_dist(cx[j], cy[j], ax, ay)
                                      : __int_as_float(0x7f800000);
          const uint32_t bits = d2 != d2 ? 0x7fc00000u : __float_as_uint(d2);
          key = (static_cast<uint64_t>(bits) << 32) |
                (rbase + static_cast<uint32_t>(i));
        }
        if (key < thr) buf[kpad + atomicAdd(&s_fill, 1)] = key;
      }
    }
    __syncthreads();
    const int fill = s_fill;
    if (fill > room || (t1 >= n_all && fill > 0)) {  // the same everywhere
      __syncthreads();  // every thread has read s_fill
      const uint64_t kth = block_select(buf, sbuf, kpad, s_hist, s_sel);
      // keep the keys below the kpad-th at the head (any order), then the
      // kpad-th itself (or the empty key) up to kpad, the rest emptied
      if (threadIdx.x == 0) s_cnt = 0;
      __syncthreads();
      for (int r0 = 0; r0 < sbuf; r0 += kThreads) {
        const uint64_t v = buf[r0 + threadIdx.x];
        __syncthreads();  // this round's entries are read before any write
        if (v < kth) buf[atomicAdd(&s_cnt, 1)] = v;
        __syncthreads();
      }
      for (int i = s_cnt + threadIdx.x; i < sbuf; i += kThreads)
        buf[i] = i < kpad ? kth : kKeyMax;
      if (threadIdx.x == 0) {
        s_thr = kth;
        s_fill = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (kKeys) {
        ck[j] = nk[j];
      } else {
        cx[j] = nx[j];
        cy[j] = ny[j];
      }
    }
  }
  __syncthreads();
  int head = 1;  // the head and the empty keys after it, ascending
  while (head < kpad) head <<= 1;
  bitonic_sort(buf, head);
  uint64_t* out = keys_out + (static_cast<int64_t>(q) * nchunks + c) * kpad;
  for (int i = threadIdx.x; i < kpad; i += kThreads) out[i] = buf[i];
}

template <bool kKeys>
cudaError_t knn_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      knn_select_kernel<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kKnMaxBuf * static_cast<int>(sizeof(uint64_t)));
  return err;
}

}  // namespace

extern "C" {


// The chunk, tile and buffer constants the wrappers must agree with:
// 0 kSlabChunk, 1 kTile, 2 kKnTile, 3 kKnMaxBuf, 4 kGroup.
int geomesa_join_constant(int which) {
  switch (which) {
    case 0: return kSlabChunk;
    case 1: return kTile;
    case 2: return kKnTile;
    case 3: return kKnMaxBuf;
    case 4: return kGroup;
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

// One pass of the slab kernel over `items` work items (item: (query,
// chunk) int32 pairs, each query's ceil(width / kSlabChunk) chunks in
// order). box: qa is (k, 4) [xmin ymin xmax ymax], else (k, 2) [qx qy].
// write == 0: counts[item]; write == 1: the matches at offsets[item]
// into rows_out and qi_out. Requires items > 0.
int geomesa_slab_pairs(const float* xs, const float* ys, const int32_t* order,
                       const int32_t* los, const int32_t* widths,
                       const int32_t* item, int64_t items, int box,
                       const float* qa, float r2_hi, float eps, int write,
                       int32_t* counts, const int64_t* offsets,
                       int32_t* rows_out, int32_t* qi_out, void* stream) {
  if (items < 1 || items > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* it = reinterpret_cast<const int2*>(item);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(items);
  if (box && write)
    slab_pairs_kernel<true, true><<<grid, kThreads, 0, s>>>(
        xs, ys, order, los, widths, it, qa, r2_hi, eps, counts, offsets,
        rows_out, qi_out);
  else if (box)
    slab_pairs_kernel<true, false><<<grid, kThreads, 0, s>>>(
        xs, ys, order, los, widths, it, qa, r2_hi, eps, counts, offsets,
        rows_out, qi_out);
  else if (write)
    slab_pairs_kernel<false, true><<<grid, kThreads, 0, s>>>(
        xs, ys, order, los, widths, it, qa, r2_hi, eps, counts, offsets,
        rows_out, qi_out);
  else
    slab_pairs_kernel<false, false><<<grid, kThreads, 0, s>>>(
        xs, ys, order, los, widths, it, qa, r2_hi, eps, counts, offsets,
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

// The entries per block of a knn stage over len entries and nq queries:
// as many blocks as fit on the card at once (one wave), at least
// max(4 kpad, 4096) entries each (so a stage keeps at most a quarter of
// its input). Returns 0 where the occupancy cannot be read.
long long geomesa_knn_chunk(int64_t len, int nq, int kpad, int sbuf,
                            int keys) {
  const int sms = sm_count();
  int per_sm = 0;
  const size_t smem = static_cast<size_t>(sbuf) * sizeof(uint64_t);
  if (sms < 1 || nq < 1 || len < 1 ||
      (keys ? knn_opt_in<true>() : knn_opt_in<false>()) != cudaSuccess ||
      (keys ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, knn_select_kernel<true>, kThreads, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, knn_select_kernel<false>, kThreads, smem)) !=
          cudaSuccess ||
      per_sm < 1)
    return 0;
  const int64_t per_query = (static_cast<int64_t>(per_sm) * sms) / nq;
  int64_t chunk = (len + (per_query > 1 ? per_query : 1) - 1) /
                  (per_query > 1 ? per_query : 1);
  const int64_t least = 4 * static_cast<int64_t>(kpad) > 4096
                            ? 4 * static_cast<int64_t>(kpad) : 4096;
  return chunk > least ? chunk : least;
}

// One knn stage: for each query q and chunk c of `chunk` entries, the
// kpad smallest keys, ascending, into keys_out[(q * nchunks + c) * kpad].
// Rows mode (keys_in null): entries are rows 0 .. len - 1 of px, py, rows
// >= nrows at +inf. Keys mode: entries are keys_in[q * len + i]. sbuf: a
// power of two > kpad + kKnTile, at most kKnMaxBuf.
int geomesa_knn_select(const float* px, const float* py, int64_t nrows,
                       const float* qx, const float* qy,
                       const uint64_t* keys_in, int64_t len, int nq, int kpad,
                       int sbuf, int64_t chunk, uint64_t* keys_out,
                       void* stream) {
  if (len < 1 || nq < 1 || kpad < 1 || chunk < 1 ||
      sbuf <= kpad + kKnTile || sbuf > kKnMaxBuf || (sbuf & (sbuf - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nchunks = (len + chunk - 1) / chunk;
  if (nchunks * nq > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(sbuf) * sizeof(uint64_t);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nchunks * nq);
  if (keys_in != nullptr) {
    const cudaError_t err = knn_opt_in<true>();
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_select_kernel<true><<<grid, kThreads, smem, s>>>(
        px, py, nrows, qx, qy, keys_in, len, nq, kpad, sbuf, chunk, nchunks,
        keys_out);
  } else {
    const cudaError_t err = knn_opt_in<false>();
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_select_kernel<false><<<grid, kThreads, smem, s>>>(
        px, py, nrows, qx, qy, nullptr, len, nq, kpad, sbuf, chunk, nchunks,
        keys_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
