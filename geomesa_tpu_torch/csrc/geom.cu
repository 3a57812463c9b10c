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
// Layout: one thread per point, any number of points n and edges E (no
// power-of-two padding: the XLA program padded only to avoid retracing).
// Edges (E, 4) f32 [x0 y0 x1 y1] are staged through shared memory in
// tiles of kTile edges (16 B each, one float4 load per edge), so a block
// reads each edge from device memory once, and every thread of the
// block walks the tile from shared memory (the same address across the
// warp: a broadcast). xint, with its division, is computed only where
// cond holds, which gives the same crossings.
//
// Bound: operations, each add, subtract, multiply, division, compare,
// select or xor counted as one at the 67 TFLOP/s f32 rate. The function
// needs 21 per (point, edge) where the edge does not span the point's y
// (the crossing test's two compares and xor; t's two subtracts, two
// multiplies, add and one division; the clamp's two; dx's and dy's
// three each; d2's three; the minimum's one), 5 more where it does
// (xint's multiply, division and add, px < xint and the parity flip),
// and 9 per edge once (ex, ey, len2 and the two zero guards).
// chip_smoke.py counts them for its own data (the spanning pairs by a
// sort of the points' y). Bytes are 8 B in and 2 B out per point plus
// 16 B per edge, far below. The kernel issues more than the count: it
// recomputes the per-edge terms for every pair, and each IEEE division
// is a multi-instruction sequence (PERF.md gives the SASS count).
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // edges per shared-memory tile (16 KB)

__global__ void __launch_bounds__(kThreads)
    pip_mask_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    int64_t n, const float4* __restrict__ edges, int64_t e,
                    float eps2, uint8_t* __restrict__ inside,
                    uint8_t* __restrict__ band) {
  __shared__ float4 tile[kTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float x = live ? px[i] : 0.f;
  const float y = live ? py[i] : 0.f;
  bool parity = false;
  float m = __int_as_float(0x7f800000);  // +inf
  for (int64_t e0 = 0; e0 < e; e0 += kTile) {
    const int te = static_cast<int>(e - e0 < kTile ? e - e0 : kTile);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < te; j += blockDim.x) tile[j] = edges[e0 + j];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < te; ++j) {
      const float4 g = tile[j];
      const float x0 = g.x, y0 = g.y, x1 = g.z, y1 = g.w;
      const float ex = __fsub_rn(x1, x0);
      const float ey = __fsub_rn(y1, y0);
      if ((y0 > y) != (y1 > y)) {
        const float dy = y1 == y0 ? 1e-30f : ey;
        const float xint =
            __fadd_rn(x0, __fdiv_rn(__fmul_rn(__fsub_rn(y, y0), ex), dy));
        parity ^= x < xint;
      }
      const float len2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      float t = __fdiv_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, x0), ex),
                                    __fmul_rn(__fsub_rn(y, y0), ey)),
                          len2 == 0.f ? 1.f : len2);
      t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);  // NaN passes, as torch.clamp
      const float dx = __fsub_rn(x, __fadd_rn(x0, __fmul_rn(t, ex)));
      const float dyv = __fsub_rn(y, __fadd_rn(y0, __fmul_rn(t, ey)));
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dyv, dyv));
      m = (d2 < m || d2 != d2) ? d2 : m;  // a NaN stays, as torch.min
    }
  }
  if (live) {
    inside[i] = parity;
    band[i] = m < eps2;
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
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (n < 1 || e < 0 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  pip_mask_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      px, py, n, reinterpret_cast<const float4*>(edges), e, eps2, inside,
      band);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
