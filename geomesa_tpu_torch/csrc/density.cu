// Density grid kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/scan/aggregations.py:28
// _density_kernel (jitted; the device half of GeoMesa's DensityScan, the
// heatmap a WMS layer asks for on every tile). Per point i with mask[i]:
//   col = clip(int32((x[i] - xmin) * sx), 0, width - 1)
//   row = clip(int32((y[i] - ymin) * sy), 0, height - 1)
//   grid[row * width + col] += w[i]            (w = 1 when unweighted)
// The reference adds where(mask, w, 0) for every row; a masked row adds
// +0.0 to a cell that starts at +0.0 and so changes nothing, and is
// skipped here. The binning is two rounded f32 operations (__fsub_rn,
// __fmul_rn: no contraction into an fma), then a truncation toward zero
// that saturates and reads NaN as 0 (__float2int_rz, as XLA converts
// f32 to s32), then the clip. x and y are the caller's f32 coordinates,
// rounded to nearest from f64 (never the scan data's two-float columns,
// whose hi word is rounded toward -inf); xmin, ymin, sx and sy are f32
// values the host computed in f64.
//
// Accumulation: one atomicAdd (red.global.add.f32: the result is unused)
// per unmasked row into a zeroed grid. The f32 sums depend on the order
// of the adds, which changes from run to run: a cell whose weights are
// integers with a total below 2^24 is exact in any order; otherwise a
// cell is within 2 * n_cell * 2^-24 * sum |w| of the reference's
// sequential sum.
//
// Bound: device-memory bytes, 13 B a row weighted (x, y, w f32 and the
// mask byte; 9 B unweighted) plus 4 B a cell for the grid's zeroing and
// its copy out; the grid is small next to the rows and stays in L2 (50
// MB) for any grid under about 12M cells, so the atomics resolve there.
// Design: a grid-stride loop, four rows a thread, read as one 16-byte
// vector of x, of y and of w and one 4-byte word of the mask; a group of
// four masked rows is skipped before its coordinates are read. Rows
// past the last whole group of four go to the first threads of block 0.
// Many rows in one cell serialize their atomics at one L2 address
// (chip_smoke.py times that case); a shared-memory grid per block only
// fits grids of a few thousand cells and is left out.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;              // rows per thread and step
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

struct Bins {
  float xmin, ymin, sx, sy;
  int width, height;
};

__device__ __forceinline__ void add_row(float x, float y, float w,
                                        const Bins& b, float* grid) {
  int c = __float2int_rz(__fmul_rn(__fsub_rn(x, b.xmin), b.sx));
  int r = __float2int_rz(__fmul_rn(__fsub_rn(y, b.ymin), b.sy));
  c = min(max(c, 0), b.width - 1);
  r = min(max(r, 0), b.height - 1);
  atomicAdd(grid + static_cast<int64_t>(r) * b.width + c, w);
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
density_grid_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w,
                    const uint8_t* __restrict__ mask, int64_t n, Bins b,
                    float* __restrict__ grid) {
  const int64_t groups = n / kRows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const uint32_t* m4 = reinterpret_cast<const uint32_t*>(mask);
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const uint32_t m = __ldg(m4 + g);
    if (m == 0) continue;
    const float4 xv = __ldg(x4 + g);
    const float4 yv = __ldg(y4 + g);
    float4 wv = make_float4(1.f, 1.f, 1.f, 1.f);
    if (kWeighted) wv = __ldg(w4 + g);
    if (m & 0xffu) add_row(xv.x, yv.x, wv.x, b, grid);
    if (m & 0xff00u) add_row(xv.y, yv.y, wv.y, b, grid);
    if (m & 0xff0000u) add_row(xv.z, yv.z, wv.z, b, grid);
    if (m & 0xff000000u) add_row(xv.w, yv.w, wv.w, b, grid);
  }
  if (blockIdx.x == 0) {
    const int64_t i = groups * kRows + threadIdx.x;
    if (i < n && mask[i]) add_row(x[i], y[i], kWeighted ? w[i] : 1.f, b, grid);
  }
}

}  // namespace

extern "C" {

// grid (height, width) f32, zeroed by the caller, += the weights w (null:
// 1) of the n > 0 points (x, y) with mask set. x, y and w 16-byte aligned,
// mask 4-byte aligned; width, height >= 1 and width * height < 2^31.
int geomesa_density_grid(const float* x, const float* y, const float* w,
                         const uint8_t* mask, int64_t n, float xmin,
                         float ymin, float sx, float sy, int width,
                         int height, float* grid, void* stream) {
  if (n < 1 || width < 1 || height < 1 ||
      static_cast<int64_t>(width) * height > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = n / kRows;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const Bins b{xmin, ymin, sx, sy, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    density_grid_kernel<true><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        x, y, w, mask, n, b, grid);
  else
    density_grid_kernel<false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        x, y, w, mask, n, b, grid);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
