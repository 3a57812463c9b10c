// Point-in-polygon kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/scan/gscan.py:_pip_kernel (:239),
// the device half of the exact-geometry residual of the in-memory store
// (geomesa_tpu/store/memory.py:_pip_residual :1760): for every point and
// every edge of a polygon's rings (shells and holes alike),
//   cond  = (y0 > py) != (y1 > py)
//   dy    = y1 == y0 ? 1e-30f : y1 - y0
//   xint  = x0 + ((py - y0) * (x1 - x0)) / dy
//   inside = parity over edges of (cond && px < xint)
// and the uncertainty band: the squared distance from the point to the
// edge at the clamped projection t,
//   ex = x1 - x0, ey = y1 - y0, len2 = ex*ex + ey*ey
//   t  = clamp(((px - x0)*ex + (py - y0)*ey) / (len2 == 0 ? 1 : len2), 0, 1)
//   d2 = (px - (x0 + t*ex))^2 + (py - (y0 + t*ey))^2
//   band = min over edges of d2 < eps2   (eps2 = f32(EDGE_EPS^2))
// The store re-evaluates band rows exactly in float64 on the host, so
// inside need only be right outside the band.
//
// Rounding: every operation is written as __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn in the order of the JAX body, so nvcc cannot
// contract a multiply and an add into an FMA, and inside and band equal
// the plain PyTorch version's (kernels.pip_mask_plain: one elementwise
// op per PyTorch kernel, no contraction) bit for bit. The clamp passes a
// NaN through and the minimum keeps a NaN, as torch.clamp and torch.min
// do. Build WITHOUT --use_fast_math or -ftz=true.
//
// Design. Each block stages a tile of kTile edges in shared memory, and
// its prologue computes each edge's own terms once, with the same _rn
// operations the plain version applies per pair: ex, ey, the guarded
// len2 and dy, and the edge's box expanded by a margin M (three float4
// records, 48 B an edge). It then indexes the tile by y: the y range of
// the edges' expanded boxes cut into kSlabs slabs, and each edge listed
// (a 2-byte edge number, in shared memory) in every slab that its
// expanded y range [loy, hiy] meets. The slab of a y is
// clamp(fl(fl(y - lo) * scale)) truncated, monotone in y, so an edge is
// listed in the slab of every y within its reach. Each thread then
// takes kPoints points (strided by the block, so loads and stores stay
// coalesced) and walks only its slab's list: a pair whose edge is not
// listed lies beyond the edge's y reach, where it changes nothing
// (proof below). On a listed edge it tests the y reach, then the span
// and the x reach; only a point inside the whole expanded box runs the
// full path above, in the same operation order. Between the two, the
// division-free verdict below stands. A point that cannot skip (NaN,
// infinite or beyond 2^60) runs the full path on every edge of the
// tile; an edge that cannot be skipped (a NaN box) is listed in every
// slab; a tile whose range is not finite or whose lists overflow
// kListCap walks every edge with the same tests.
//
// The skip, and why it changes no bit. Let u = 2^-24 (the f32 unit
// roundoff), A = max(|x0|, |y0|, |x1|, |y1|) of the edge, and
// r = fl(fl(sqrt(eps2)) * (1 + 2^-8)) >= sqrt(eps2) * (1 + 2^-9). The
// prologue sets M = fl(r + A * 2^-19) (32 ulps of A) and the box
// lox = fl(min(x0, x1) - M), hix = fl(max(x0, x1) + M), and loy, hiy
// likewise; fl(min - M) <= min - M + u(A + M), so the box reaches at
// least r(1 - 2u) + 30uA beyond the edge's own box on every side.
// 1. With t in [0, 1] the projection qx = fl(x0 + fl(t * ex)) lies
//    within 6uA of [min(x0, x1), max(x0, x1)] (ex = (x1 - x0)(1 + e),
//    two more roundings), and qy likewise. A point outside the box on
//    the x side is then more than r(1 - 2u) + 24uA >= fl_up(sqrt(eps2))
//    from qx, so |dx| = |fl(px - qx)| >= sqrt(eps2) by the monotony of
//    rounding, fl(dx * dx) >= eps2 (eps2 is an f32), and d2 >= eps2,
//    since adding fl(dyv * dyv) >= 0 cannot round below it. The y side
//    is the same. So the pair cannot move band: the least d2 is below
//    eps2 exactly when the least over the pairs in the box is.
// 2. A pair whose edge spans py (cond) has py within [ymin, ymax), so
//    beyond the y reach cond is false and the pair adds no crossing: it
//    changes neither bit. A skipped spanning pair lies outside on the x
//    side. There a = fl(py - y0) has |a| <= |dy| (rounding is
//    monotone), so xint = fl(x0 + fl(fl(a * ex) / dy)) lies within 8uA
//    of [xmin, xmax], inside the box. px < lox then means px < xint,
//    and px > hix means px > xint: the crossing is cond && px < lox,
//    with no division.
// 3. Nothing in a skipped pair may be NaN, since a NaN d2 sticks in the
//    plain minimum and clears band. The skip is therefore taken only
//    for a point with |px|, |py| <= 2^60 and an edge with A <= 2^60;
//    every product then stays below 2^124, t is a clamped finite
//    quotient, and d2 is finite. A NaN, infinite or larger point tests
//    the box with NaN and so takes the full path on every edge; a
//    larger or NaN edge gets a NaN box, which no compare passes.
// The order in which a point meets its edges does not matter: parity is
// an xor, and the minimum keeps a NaN whenever one comes. Underflow adds
// at most a few 2^-149 absolute to these bounds, inside r's 2^-9 slack
// (r >= 2^-75 for any positive f32 eps2). tests/
// test_torch_gscan.py checks the two claims on every skipped pair of
// adversarial inputs through the plain versions of the edge terms and
// the skip (kernels.pip_edge_terms_plain, kernels.pip_skip_plain).
//
// Bound: the larger of bytes and operations, each add, subtract,
// multiply, division, compare, select or xor counted as one at the
// 67 TFLOP/s f32 rate, for what these inputs need: per point its slab
// (four); per pair within the y reach the y test's two, the span test's
// three, the x reach's two and the crossing's two; per pair inside the
// expanded box the full path's 21 (t's two subtracts, two multiplies,
// add and division, the clamp's two, dx's and dy's three each, d2's
// three, the minimum's one and the span test's three), five more where
// that edge spans the point's y; per edge the prologue's 29. Bytes are
// 8 B in and 2 B out per point plus 16 B per edge, and they bound it.
// chip_smoke.py counts the pairs within each reach on the device, and
// also reports the earlier all-pairs count (21 per pair) for
// continuity. Tensor cores and TMA do not fit: the work is f32 compares
// and selects that must stay bit-exact, and the edge tile is a few KB
// that ordinary loads stage.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 8;      // points per thread
constexpr int kTile = 512;      // edges per shared-memory tile
constexpr int kSlabs = 256;     // y slabs of a tile's index (32 | kSlabs)
constexpr int kListCap = 8192;  // slab list entries (edge numbers)
constexpr float kTame = 1152921504606846976.0f;   // 2^60
constexpr float kUlps = 1.9073486328125e-06f;     // 2^-19 = 32 u

// the prologue's terms of edge g = (x0, y0, x1, y1), in the plain
// version's operation order; see the note above for the box
__device__ __forceinline__ void edge_terms(float4 g, float r, float4* a,
                                           float4* b, float4* c) {
  const float ex = __fsub_rn(g.z, g.x);
  const float ey = __fsub_rn(g.w, g.y);
  const float len2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
  const float dy = g.w == g.y ? 1e-30f : ey;
  const float big = fmaxf(fmaxf(fabsf(g.x), fabsf(g.y)),
                          fmaxf(fabsf(g.z), fabsf(g.w)));
  const bool tame = fabsf(g.x) <= kTame && fabsf(g.y) <= kTame &&
                    fabsf(g.z) <= kTame && fabsf(g.w) <= kTame;
  const float m = tame ? __fadd_rn(r, __fmul_rn(big, kUlps))
                       : __int_as_float(0x7fc00000);   // NaN: never skip
  *a = make_float4(__fsub_rn(fminf(g.y, g.w), m),
                   __fadd_rn(fmaxf(g.y, g.w), m), g.y, g.w);
  *b = make_float4(__fsub_rn(fminf(g.x, g.z), m),
                   __fadd_rn(fmaxf(g.x, g.z), m), g.x, g.z);
  *c = make_float4(ex, ey, len2 == 0.f ? 1.f : len2, dy);
}

// the slab of y: monotone in y (each step rounds monotonically), so an
// edge listed in the slabs of its loy .. hiy is in the slab of every y
// within its reach
__device__ __forceinline__ int slab_of(float y, float lo, float scale) {
  const float t = __fmul_rn(__fsub_rn(y, lo), scale);
  return static_cast<int>(fminf(fmaxf(t, 0.f), kSlabs - 1.f));
}

// the full path of one (point, edge) pair, in the plain version's
// operation order: the crossing where cond holds, and d2 into m
__device__ __forceinline__ void full_path(float x, float y, float4 a,
                                          float4 b, float4 c, bool cond,
                                          bool* cross, float* m) {
  const float x0 = b.z, y0 = a.z;
  if (cond) {
    const float xint =
        __fadd_rn(x0, __fdiv_rn(__fmul_rn(__fsub_rn(y, y0), c.x), c.w));
    *cross = x < xint;
  }
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, x0), c.x),
                                __fmul_rn(__fsub_rn(y, y0), c.y)),
                      c.z);
  t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);  // NaN passes, as torch.clamp
  const float dx = __fsub_rn(x, __fadd_rn(x0, __fmul_rn(t, c.x)));
  const float dyv = __fsub_rn(y, __fadd_rn(y0, __fmul_rn(t, c.y)));
  const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dyv, dyv));
  *m = (d2 < *m || d2 != d2) ? d2 : *m;  // a NaN stays, as torch.min
}

__global__ void __launch_bounds__(kThreads)
    pip_mask_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    int64_t n, const float4* __restrict__ edges, int64_t e,
                    float eps2, uint8_t* __restrict__ inside,
                    uint8_t* __restrict__ band) {
  // per edge: {loy, hiy, y0, y1}, {lox, hix, x0, x1}, {ex, ey, len2, dy}
  __shared__ float4 sa[kTile], sb[kTile], sc[kTile];
  __shared__ uint16_t list[kListCap];        // edge numbers, slab by slab
  __shared__ int start[kSlabs + 1], fill[kSlabs];
  __shared__ float wlo[kThreads / 32], whi[kThreads / 32];
  __shared__ float s_lo, s_scale;
  __shared__ int s_one;                      // no index: walk every edge
  const float r = __fmul_rn(__fsqrt_rn(eps2), 1.00390625f);
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kPoints) + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x[kPoints], y[kPoints], m[kPoints];
  bool parity[kPoints], tame[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int64_t i = base + k * kThreads;
    x[k] = i < n ? px[i] : 0.f;
    y[k] = i < n ? py[i] : 0.f;
    tame[k] = fabsf(x[k]) <= kTame && fabsf(y[k]) <= kTame;
    m[k] = __int_as_float(0x7f800000);  // +inf
    parity[k] = false;
  }
  for (int64_t e0 = 0; e0 < e; e0 += kTile) {
    const int te = static_cast<int>(e - e0 < kTile ? e - e0 : kTile);
    __syncthreads();  // the previous tile is no longer read
    // the edges' terms, and the y range of the tame edges' reach
    float lo = __int_as_float(0x7f800000), hi = -lo;
    for (int j = threadIdx.x; j < te; j += kThreads) {
      edge_terms(edges[e0 + j], r, &sa[j], &sb[j], &sc[j]);
      lo = fminf(lo, sa[j].x);  // fminf / fmaxf pass over a NaN box
      hi = fmaxf(hi, sa[j].y);
    }
    for (int o = 16; o; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
    for (int t = threadIdx.x; t < kSlabs; t += kThreads) fill[t] = 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        lo = fminf(lo, wlo[w]);
        hi = fmaxf(hi, whi[w]);
      }
      const float scale = __fdiv_rn(static_cast<float>(kSlabs),
                                    __fsub_rn(hi, lo));
      s_lo = lo;
      s_scale = scale;
      s_one = !(scale > 0.f && scale <= 3.0e38f);  // no finite range
    }
    __syncthreads();
    const float slo = s_lo, scale = s_scale;
    // each edge in the slabs of its y reach (a NaN box: in every slab)
    if (!s_one) {
      for (int j = threadIdx.x; j < te; j += kThreads) {
        const float4 a = sa[j];
        const bool nan = a.x != a.x;
        const int s1 = nan ? kSlabs - 1 : slab_of(a.y, slo, scale);
        for (int s = nan ? 0 : slab_of(a.x, slo, scale); s <= s1; ++s)
          atomicAdd(&fill[s], 1);
      }
    }
    __syncthreads();
    if (warp == 0 && !s_one) {  // the lists' starts: an exclusive scan
      constexpr int kPer = kSlabs / 32;
      int own = 0;
#pragma unroll
      for (int t = 0; t < kPer; ++t) own += fill[lane * kPer + t];
      int incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int sum = incl - own;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int s = lane * kPer + t;
        const int c = fill[s];
        start[s] = fill[s] = sum;
        sum += c;
      }
      if (lane == 31) {
        start[kSlabs] = sum;
        if (sum > kListCap) s_one = 1;  // too many entries: walk every edge
      }
    }
    __syncthreads();
    const bool one = s_one;
    if (!one) {
      for (int j = threadIdx.x; j < te; j += kThreads) {
        const float4 a = sa[j];
        const bool nan = a.x != a.x;
        const int s1 = nan ? kSlabs - 1 : slab_of(a.y, slo, scale);
        for (int s = nan ? 0 : slab_of(a.x, slo, scale); s <= s1; ++s)
          list[atomicAdd(&fill[s], 1)] = static_cast<uint16_t>(j);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      if (tame[k]) {
        int q = 0, q1 = te;
        if (!one) {
          const int s = slab_of(y[k], slo, scale);
          q = start[s];
          q1 = start[s + 1];
        }
        for (; q < q1; ++q) {
          const int j = one ? q : list[q];
          const float4 a = sa[j];
          // beyond the y reach the pair changes nothing: no span, d2 >= eps2
          if (y[k] < a.x || y[k] > a.y) continue;
          const float4 b = sb[j];
          const bool cond = (a.z > y[k]) != (a.w > y[k]);
          bool cross = cond && x[k] < b.x;
          if (!(x[k] < b.x || x[k] > b.y))  // inside the box: the full path
            full_path(x[k], y[k], a, b, sc[j], cond, &cross, &m[k]);
          parity[k] ^= cross;
        }
      } else {  // NaN, infinite or huge: the full path on every edge
        for (int j = 0; j < te; ++j) {
          const float4 a = sa[j];
          const bool cond = (a.z > y[k]) != (a.w > y[k]);
          bool cross = false;
          full_path(x[k], y[k], a, sb[j], sc[j], cond, &cross, &m[k]);
          parity[k] ^= cross;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int64_t i = base + k * kThreads;
    if (i < n) {
      inside[i] = parity[k];
      band[i] = m[k] < eps2;
    }
  }
}

}  // namespace

extern "C" {

// inside[i], band[i] for the n points (px[i], py[i]) against the e edges
// (e, 4) [x0 y0 x1 y1] (16-byte aligned). e may be 0 (nothing inside, no
// band). Requires n > 0.
int geomesa_pip_mask(const float* px, const float* py, int64_t n,
                     const float* edges, int64_t e, float eps2,
                     uint8_t* inside, uint8_t* band, void* stream) {
  constexpr int64_t per_block = kThreads * kPoints;
  const int64_t blocks = (n + per_block - 1) / per_block;
  if (n < 1 || e < 0 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  pip_mask_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      px, py, n, reinterpret_cast<const float4*>(edges), e, eps2, inside,
      band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
