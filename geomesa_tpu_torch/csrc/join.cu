// Spatial-join and KNN kernels for Hopper (sm_90a).
//
// Replace the XLA programs of the reference package's analytics joins
// (geomesa_tpu/analytics/join.py), which serve dwithin_join,
// contains_join, knn_batched / knn and the processes above them:
//
// dwithin_counts_kernel   <- _dwithin_counts_all (:60, body
//   _dwithin_matrices :48). Per query q and row i < nrows, in f32 with
//   every step rounded to nearest,
//     d2 = (px[i] - qx[q])^2 + (py[i] - qy[q])^2
//     definite[q] += d2 <= r2_lo;  band[q] += !(d2 <= r2_lo) && d2 <= r2_hi
//   Design: each thread keeps kDwQpt queries and their two counts in
//   registers; the block stages kDwTile rows at a time in shared memory
//   and every thread walks them (a broadcast read serves the whole
//   warp); one atomicAdd per (block, query) at the end, never per pair.
//   The grid is row chunks x query groups, sized so that every SM holds
//   several blocks. Bound: about 7 f32 operations a pair (d2's five, two
//   compares) over 67 TFLOP/s; the bytes (8 B a row, read once per query
//   group) are far below it.
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
//   (:389), and _contains_band_rows (:454). Per polygon: the columns of
//   its slab inside its EDGE_EPS-widened f32 box, and for those the f32
//   crossing number and the squared distance to the nearest edge, in
//   the operation order of _pip_body (and of csrc/geom.cu):
//     cond = (y0 > y) != (y1 > y);  dy = y1 == y0 ? 1e-30 : y1 - y0
//     cross = cond && x < x0 + ((y - y0) * (x1 - x0)) / dy
//     t = clamp(((x - x0)*ex + (y - y0)*ey) / (len2 == 0 ? 1 : len2), 0, 1)
//     d2 = (x - (x0 + t*ex))^2 + (y - (y0 + t*ey))^2
//     band = min over edges of d2 < eps2;  inside = parity of cross
//   Counts mode: blocks over (polygon, chunk of kCtChunk columns) work
//   items (the host's (polygon, chunk) pairs, as in the slab kernel).
//   A block gathers its columns that pass the box test into shared
//   memory (a box holds a few percent of its slab, so without this a
//   warp would run the edge loop for one or two lanes), then its
//   threads take the gathered rows against the edges, staged in shared
//   memory in tiles (with each edge's ex, ey, len2 and dy computed
//   once); a block with no row in the box skips the edges. One
//   atomicAdd per (block, polygon) for the definite (in box, inside,
//   not band) and band counts, and the block's band count. Rows mode:
//   blocks over the items with band rows, each writing its band rows in
//   column order from its offset (the band rows of the polygon's earlier
//   chunks, prefixed on the host from the counts pass), the first cap of
//   each polygon kept: the reference's jnp.flatnonzero(..., size=cap).
//   Bound: the larger of the bytes (8 B a column of the slabs' union,
//   16 B an edge) and the operations (4 a slab column for the box test,
//   about 23 a (column in the box, edge) pair).
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

constexpr int kDwThreads = 256;  // most threads of a dwithin block
constexpr int kDwQpt = 4;        // queries per thread
constexpr int kDwTile = 2048;    // rows staged in shared memory at a time

constexpr int kThreads = 256;    // slab, contains and knn blocks
constexpr int kSlabChunk = 2048; // slab columns per work item
constexpr int kCtChunk = 2048;   // contains columns per work item
constexpr int kCtPer = kCtChunk / kThreads;
constexpr int kEdgeTile = 512;   // edges staged at a time (16 KB)
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

// -- J1: dwithin counts -----------------------------------------------------

__global__ void __launch_bounds__(kDwThreads)
    dwithin_counts_kernel(const float* __restrict__ px,
                          const float* __restrict__ py, int64_t nrows,
                          int64_t rows_per_block, const float* __restrict__ qx,
                          const float* __restrict__ qy, int k, float r2_hi,
                          float r2_lo, int32_t* __restrict__ definite,
                          int32_t* __restrict__ band) {
  __shared__ float2 s_xy[kDwTile];
  const int group = blockIdx.y * blockDim.x * kDwQpt;
  float ax[kDwQpt], ay[kDwQpt];
  int cd[kDwQpt], cb[kDwQpt];
#pragma unroll
  for (int j = 0; j < kDwQpt; ++j) {
    const int q = group + j * blockDim.x + threadIdx.x;
    // a slot past k: a NaN query, whose compares never pass
    ax[j] = q < k ? qx[q] : __int_as_float(0x7fc00000);
    ay[j] = q < k ? qy[q] : __int_as_float(0x7fc00000);
    cd[j] = cb[j] = 0;
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row1 =
      row0 + rows_per_block < nrows ? row0 + rows_per_block : nrows;
  for (int64_t t0 = row0; t0 < row1; t0 += kDwTile) {
    const int m = static_cast<int>(row1 - t0 < kDwTile ? row1 - t0 : kDwTile);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      s_xy[i] = make_float2(px[t0 + i], py[t0 + i]);
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float2 p = s_xy[i];
#pragma unroll
      for (int j = 0; j < kDwQpt; ++j) {
        const float d2 = sq_dist(p.x, p.y, ax[j], ay[j]);
        const bool d = d2 <= r2_lo;
        cd[j] += d;
        cb[j] += !d & (d2 <= r2_hi);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDwQpt; ++j) {
    const int q = group + j * blockDim.x + threadIdx.x;
    if (q < k) {
      if (cd[j]) atomicAdd(definite + q, cd[j]);
      if (cb[j]) atomicAdd(band + q, cb[j]);
    }
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

// the edge tile's terms: A = (x0, y0, x1, y1), B = (ex, ey, len2 guarded,
// dy guarded), in the reference's rounding
__device__ __forceinline__ void stage_edges(const float4* __restrict__ e,
                                            int te, float4* sA, float4* sB) {
  for (int j = threadIdx.x; j < te; j += kThreads) {
    const float4 g = e[j];
    const float ex = __fsub_rn(g.z, g.x);
    const float ey = __fsub_rn(g.w, g.y);
    const float len2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
    sA[j] = g;
    sB[j] = make_float4(ex, ey, len2 == 0.f ? 1.f : len2,
                        g.w == g.y ? 1e-30f : ey);
  }
}

// one point against te staged edges: the crossing parity and the least
// squared distance (a NaN stays, as the reference's minimum keeps it)
__device__ __forceinline__ void pip_edges(float x, float y, const float4* sA,
                                          const float4* sB, int te,
                                          bool* parity, float* m) {
  for (int j = 0; j < te; ++j) {
    const float4 a = sA[j];
    const float4 c = sB[j];
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

struct Poly {
  int64_t lo;
  int width;
  float bx0, by0, bx1, by1;  // the widened box
  const float4* edges;
  int ec;
};

__device__ __forceinline__ Poly load_poly(int p, const int32_t* los,
                                          const int32_t* widths,
                                          const float* boxes,
                                          const float* edges,
                                          const int32_t* ecount, int ne,
                                          float eps) {
  Poly g;
  g.lo = los[p];
  g.width = widths[p];
  g.bx0 = __fsub_rn(boxes[4 * p], eps);
  g.by0 = __fsub_rn(boxes[4 * p + 1], eps);
  g.bx1 = __fadd_rn(boxes[4 * p + 2], eps);
  g.by1 = __fadd_rn(boxes[4 * p + 3], eps);
  g.edges = reinterpret_cast<const float4*>(edges) +
            static_cast<int64_t>(p) * ne;
  g.ec = ecount[p];
  return g;
}

__device__ __forceinline__ bool in_box(const Poly& g, float x, float y) {
  return x >= g.bx0 && x <= g.bx1 && y >= g.by0 && y <= g.by1;
}

// R columns a thread against every edge of g, tile by tile; every thread
// of the block calls it (it synchronises)
template <int R>
__device__ void pip_block(const Poly& g, const float (&x)[R],
                          const float (&y)[R], const bool (&in)[R],
                          bool (&parity)[R], float (&m)[R], float4* sA,
                          float4* sB) {
  for (int e0 = 0; e0 < g.ec; e0 += kEdgeTile) {
    const int te = g.ec - e0 < kEdgeTile ? g.ec - e0 : kEdgeTile;
    __syncthreads();  // the previous tile is no longer read
    stage_edges(g.edges + e0, te, sA, sB);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (in[r]) pip_edges(x[r], y[r], sA, sB, te, &parity[r], &m[r]);
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    contains_counts_kernel(const float* __restrict__ xs,
                           const float* __restrict__ ys,
                           const int32_t* __restrict__ order,
                           const int32_t* __restrict__ los,
                           const int32_t* __restrict__ widths,
                           const int* __restrict__ item,
                           const float* __restrict__ boxes,
                           const float* __restrict__ edges,
                           const int32_t* __restrict__ ecount, int ne,
                           float eps, float eps2, int32_t* __restrict__ dc,
                           int32_t* __restrict__ bc,
                           int32_t* __restrict__ cband, int cap_rows,
                           int32_t* __restrict__ rows_out) {
  __shared__ float4 sA[kEdgeTile], sB[kEdgeTile];
  __shared__ int s_scan[2 * kThreads];
  const float inf = __int_as_float(0x7f800000);
  const int64_t b = blockIdx.x;
  if (!kRows) {
    // counts: item b = (polygon, chunk). The chunk's columns inside the
    // box are gathered in shared memory first, so the crossing-number
    // loop runs on full warps of in-box rows (a polygon's box holds a
    // small share of its slab's columns, one or two of a warp's 32)
    __shared__ float2 s_in[kCtChunk];
    __shared__ int s_n, s_d, s_b;
    const int p = item[2 * b];
    const Poly g = load_poly(p, los, widths, boxes, edges, ecount, ne, eps);
    const int c0 = item[2 * b + 1] * kCtChunk;
    if (threadIdx.x == 0) s_n = s_d = s_b = 0;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCtPer; ++r) {
      const int col = c0 + r * kThreads + threadIdx.x;
      if (col < g.width) {
        const float x = xs[g.lo + col];
        const float y = ys[g.lo + col];
        if (in_box(g, x, y)) s_in[atomicAdd(&s_n, 1)] = make_float2(x, y);
      }
    }
    __syncthreads();
    const int n_in = s_n;
    if (n_in > 0) {  // the same in every thread
      float x[kCtPer], y[kCtPer], m[kCtPer];
      bool in[kCtPer], parity[kCtPer];
#pragma unroll
      for (int r = 0; r < kCtPer; ++r) {
        const int j = r * kThreads + threadIdx.x;
        in[r] = j < n_in;
        const float2 v = in[r] ? s_in[j] : make_float2(0.f, 0.f);
        x[r] = v.x;
        y[r] = v.y;
        parity[r] = false;
        m[r] = inf;
      }
      pip_block<kCtPer>(g, x, y, in, parity, m, sA, sB);
      int d = 0, bnd = 0;
#pragma unroll
      for (int r = 0; r < kCtPer; ++r) {
        const bool band = in[r] && m[r] < eps2;
        d += in[r] && parity[r] && !band;
        bnd += band;
      }
      if (d) atomicAdd(&s_d, d);
      if (bnd) atomicAdd(&s_b, bnd);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      if (s_d) atomicAdd(dc + p, s_d);
      if (s_b) atomicAdd(bc + p, s_b);
      cband[b] = s_b;
    }
    return;
  }
  // rows: item b = (polygon, chunk, output slot, offset in the slot): the
  // chunk's band rows in column order, from the offset (the band rows of
  // the polygon's earlier chunks, by the counts pass), the first
  // cap_rows of the polygon kept
  const int p = item[4 * b];
  const Poly g = load_poly(p, los, widths, boxes, edges, ecount, ne, eps);
  const int c0 = item[4 * b + 1] * kCtChunk;
  int32_t* out = rows_out + static_cast<int64_t>(item[4 * b + 2]) * cap_rows;
  int found = item[4 * b + 3];
  const int c1 = c0 + kCtChunk < g.width ? c0 + kCtChunk : g.width;
  for (int s0 = c0; s0 < c1 && found < cap_rows; s0 += kThreads) {
    const int col = s0 + threadIdx.x;
    float x[1] = {0.f}, y[1] = {0.f}, m[1] = {inf};
    bool in[1] = {false}, parity[1] = {false};
    if (col < c1) {
      x[0] = xs[g.lo + col];
      y[0] = ys[g.lo + col];
      in[0] = in_box(g, x[0], y[0]);
    }
    if (__syncthreads_or(in[0])) pip_block<1>(g, x, y, in, parity, m, sA, sB);
    const bool band = in[0] && m[0] < eps2;
    const int step = __syncthreads_count(band);
    if (step) {
      const int rank = block_exclusive(band, s_scan);
      if (band && found + rank < cap_rows)
        out[found + rank] = order[g.lo + col];
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


// The chunk and buffer constants the wrappers must agree with:
// 0 kSlabChunk, 1 kCtChunk, 2 kKnTile, 3 kKnMaxBuf.
int geomesa_join_constant(int which) {
  switch (which) {
    case 0: return kSlabChunk;
    case 1: return kCtChunk;
    case 2: return kKnTile;
    case 3: return kKnMaxBuf;
    default: return -1;
  }
}

// definite[q], band[q] (zeroed by the caller) += the counts of the rows
// < nrows against the k queries. Requires nrows > 0 and k > 0.
int geomesa_dwithin_counts(const float* px, const float* py, int64_t nrows,
                           const float* qx, const float* qy, int k,
                           float r2_hi, float r2_lo, int32_t* definite,
                           int32_t* band, void* stream) {
  const int sms = sm_count();
  if (nrows < 1 || k < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = (k + kDwQpt - 1) / kDwQpt;
  threads = threads >= kDwThreads ? kDwThreads : ((threads + 31) / 32) * 32;
  const int64_t groups = (k + threads * kDwQpt - 1) / (threads * kDwQpt);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // enough row blocks that every SM holds several blocks
  const int64_t want = (static_cast<int64_t>(sms) * 8 + groups - 1) / groups;
  int64_t per = (nrows + want - 1) / want;
  per = ((per + kDwTile - 1) / kDwTile) * kDwTile;
  const int64_t bx = (nrows + per - 1) / per;
  if (bx > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dwithin_counts_kernel<<<dim3(static_cast<unsigned>(bx),
                               static_cast<unsigned>(groups)),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, nrows, per, qx, qy, k, r2_hi, r2_lo, definite, band);
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

// Counts mode over `items` (polygon, chunk) work items (item: int32
// pairs, each polygon's ceil(width / kCtChunk) chunks in order): dc[p],
// bc[p] (zeroed by the caller) += the definite and band counts;
// cband[item] the item's band count. edges (kp, ne, 4) 16-byte aligned,
// the first ecount[p] of polygon p valid. Requires items > 0.
int geomesa_contains_counts(const float* xs, const float* ys,
                            const int32_t* los, const int32_t* widths,
                            const int32_t* item, int64_t items,
                            const float* boxes, const float* edges,
                            const int32_t* ecount, int ne, float eps,
                            float eps2, int32_t* dc, int32_t* bc,
                            int32_t* cband, void* stream) {
  if (items < 1 || items > INT_MAX || ne < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  contains_counts_kernel<false><<<static_cast<unsigned>(items), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      xs, ys, nullptr, los, widths, item, boxes, edges, ecount, ne, eps, eps2,
      dc, bc, cband, 0, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Rows mode over `items` work items (item: int32 quadruples (polygon,
// chunk, slot, offset)): each chunk's band rows in column order into
// rows_out[slot] from the offset on, at most cap_rows a slot (rows_out
// (slots, cap_rows), pre-filled with -1 by the caller). The offset is the
// band rows of the polygon's earlier chunks (the counts pass's cband).
// Requires items > 0.
int geomesa_contains_band_rows(const float* xs, const float* ys,
                               const int32_t* order, const int32_t* los,
                               const int32_t* widths, const int32_t* item,
                               int64_t items, const float* boxes,
                               const float* edges, const int32_t* ecount,
                               int ne, float eps, float eps2, int cap_rows,
                               int32_t* rows_out, void* stream) {
  if (items < 1 || items > INT_MAX || cap_rows < 1 || ne < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  contains_counts_kernel<true><<<static_cast<unsigned>(items), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      xs, ys, order, los, widths, item, boxes, edges, ecount, ne, eps, eps2,
      nullptr, nullptr, nullptr, cap_rows, rows_out);
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
