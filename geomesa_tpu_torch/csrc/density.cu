// Density grid kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/scan/aggregations.py:28
// _density_kernel (jitted; the device half of GeoMesa's DensityScan, the
// heatmap a WMS layer asks for on every tile). Per counted row i:
//   col = clip(int32((x[i] - xmin) * sx), 0, width - 1)
//   row = clip(int32((y[i] - ymin) * sy), 0, height - 1)
//   grid[row * width + col] += w[i]            (w = 1 when unweighted)
// The reference adds where(mask, w, 0) for every row; a row that does
// not count adds +0.0 to a cell that starts at +0.0 and so changes
// nothing, and is skipped here. The binning is two rounded f32
// operations (__fsub_rn, __fmul_rn: no contraction into an fma), then a
// truncation toward zero that saturates and reads NaN as 0
// (__float2int_rz, as XLA converts f32 to s32), then the clip. x and y
// are f32 rounded to nearest from f64 (never the scan data's two-float
// columns, whose hi word is rounded toward -inf); xmin, ymin, sx and sy
// are f32 values the host computed in f64.
//
// One __global__ template, two loaders:
//   - ArrayRows: the caller's arrays x, y, w (f32) and mask (bool) of n
//     rows (aggregations.density_grid, the reference's signature);
//   - IdRows: the query result's ascending row ids (int32) into the
//     store's device-resident columns (scan/residual.py DeviceColumns):
//     the point's (x f32, y f32, valid), and the weight's slot: a
//     Float/Double column's hi word (f32 rounded to nearest, the
//     reference's cast), an Integer/Long column's (hi, lo) words rebuilt
//     into the int64 and rounded to f64 and then to f32 (__ll2double_rn,
//     __double2float_rn: numpy's where(valid, v, 0.0).astype(float32)
//     goes through f64, which differs from one rounding above 2^53), or
//     a Boolean's byte as 1 or 0. A row counts when its point is valid
//     and, weighted, its weight is valid. Only the ids cross from the
//     host.
//
// Accumulation, two paths:
//   - global: one red.global.add.f32 per warp and cell. The warp groups
//     its rows by cell (__match_any_sync); a group's leader sums its
//     peers' weights in lane order and adds once (every row in one cell:
//     one add a warp, 0.42 ms for 7.30M rows where one add a row took
//     12.8). The grid stays in L2 for any grid under about 12M cells;
//     the reds resolve there.
//   - block: each 1,024-thread block keeps its own copy of the whole
//     grid in shared memory, zeroed first, takes the same warp-grouped
//     adds (red.shared), then adds each non-zero cell of its copy to the
//     grid. As many blocks as fit on the card (2 an SM), so the zeroing
//     and the flush cost blocks x cells.
// plan() takes the block path for grids of up to kBlockCells cells with
// at least kBlockRowsPerCell rows per cell (counting at least
// kBlockMinCells cells), else the global path. The constants come from
// kernel_ab.py's sweep of both paths forced (PERF.md, NVIDIA H100 80GB
// HBM3, 700 W): at 7.30M rows the block path took 0.088-0.147 ms from 1
// to 32,768 cells against 0.150-0.634 on the global path; at 1M rows it
// led up to 16,384 cells and trailed by up to 0.0015 ms at 32,768; at
// 100k rows it led at 1 and 1,024 cells and trailed from 4,096. A third path lost at every
// shape and went: a cluster of 8 blocks splitting the grid over their
// SMs' shared memory, a row's add sent to the block that holds its cell
// (cluster.map_shared_rank), 0.21 ms at the zoom-0 world (256x256, 7.30M
// rows) against 0.13 on the global path (kernel_ab.py's sweep on the tree
// that still had it). Scratch builds found no gain at the world shape in
// more rows a step (4 or 8 against 2), 1,024-thread blocks on the global
// path, streaming loads, or an L2 evict-last hint on the reds. The
// f32 sums depend on the order of the adds: a cell whose weights are
// integers with a total below 2^24 is exact in any order; otherwise a
// cell is within 2 * n_cell * 2^-24 * sum |w| of the reference's
// sequential sum.
//
// Bound: device-memory bytes, per row the loader's reads (ArrayRows: x,
// y, w f32 and the mask byte; IdRows: the 4 B id, x and y, the weight's
// 4 B (8 B for an int64) and the validity bytes), plus 4 B a cell for the
// grid's zeroing and its copy out; beside it the rate of the global reds
// (kernel_ab.py's probe: 7.30M random adds into an 8 MB grid take 0.087
// ms on their own, and at one address 12.8 ms), which bounds the global
// path where the cells of a warp differ: at the world call (7.30M rows
// into 2048x1024 cells, Long weights) the reds alone take 0.087 of the
// kernel's 0.132 ms, and the rows' gathers, which pass through the same
// L2, do not hide under them. Each warp takes 2 x 32 consecutive rows
// per step, all loads first.
//
// C interface (bound with ctypes): each entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // global path
constexpr int kPrivThreads = 1024;     // block path
constexpr int kSteps = 2;              // warp-wide steps of 32 rows per loop
constexpr int kMaxBlocks = 132 * 16;
constexpr int kBlockCells = 32768;     // block path: at most 128 KB a copy
constexpr int64_t kBlockRowsPerCell = 32;
constexpr int64_t kBlockMinCells = 2048;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kGlobal = 0, kBlock = 1 };
enum Weight { kUnit = 0, kF32 = 1, kI64 = 2, kBool = 3 };

struct Bins {
  float xmin, ymin, sx, sy;
  int width, height;
};

__device__ __forceinline__ int cell_of(float x, float y, const Bins& b) {
  int c = __float2int_rz(__fmul_rn(__fsub_rn(x, b.xmin), b.sx));
  int r = __float2int_rz(__fmul_rn(__fsub_rn(y, b.ymin), b.sy));
  c = min(max(c, 0), b.width - 1);
  r = min(max(r, 0), b.height - 1);
  return r * b.width + c;
}

template <int W>
struct ArrayRows {
  const float* x;
  const float* y;
  const float* w;
  const uint8_t* mask;
  int64_t n;

  __device__ __forceinline__ bool load(int64_t k, float& px, float& py,
                                       float& pw) const {
    px = __ldg(x + k);
    py = __ldg(y + k);
    if constexpr (W == kUnit) pw = 1.f; else pw = __ldg(w + k);
    return __ldg(mask + k) != 0;
  }
};

template <int W>
struct IdRows {
  const int32_t* ids;
  const float* px;
  const float* py;
  const uint8_t* pvalid;
  const void* wa;          // f32 hi words, int32 hi words or bool bytes
  const int32_t* wlo;      // the int64's low words (unsigned bits)
  const uint8_t* wvalid;
  int64_t n;

  __device__ __forceinline__ bool load(int64_t k, float& x, float& y,
                                       float& w) const {
    const int64_t i = __ldg(ids + k);
    x = __ldg(px + i);
    y = __ldg(py + i);
    bool ok = __ldg(pvalid + i) != 0;
    if constexpr (W == kUnit) {
      w = 1.f;
    } else {
      ok &= __ldg(wvalid + i) != 0;
      if constexpr (W == kF32) {
        w = __ldg(static_cast<const float*>(wa) + i);
      } else if constexpr (W == kBool) {
        w = __ldg(static_cast<const uint8_t*>(wa) + i) ? 1.f : 0.f;
      } else {
        const uint32_t hi = static_cast<uint32_t>(
            __ldg(static_cast<const int32_t*>(wa) + i));
        const uint32_t lo = static_cast<uint32_t>(__ldg(wlo + i));
        const long long v = static_cast<long long>(
            (static_cast<unsigned long long>(hi) << 32) | lo);
        w = __double2float_rn(__ll2double_rn(v));
      }
    }
    return ok;
  }
};

template <int kMode>
__device__ __forceinline__ void add_cell(int cell, float v, float* grid,
                                         float* part) {
  if constexpr (kMode == kGlobal) atomicAdd(grid + cell, v);
  else atomicAdd(part + cell, v);
}

// One add per cell of the warp's rows (cell < 0: the row does not
// count): the rows of a cell sum in lane order at their lowest lane.
template <int kMode>
__device__ __forceinline__ void warp_add(int cell, float w, float* lanes,
                                         int lane, float* grid, float* part) {
  const unsigned peers = __match_any_sync(kFull, cell);
  if (cell < 0) return;
  const int leader = __ffs(peers) - 1;
  float s = w;
  if (peers != (1u << lane)) {
    lanes[lane] = w;
    __syncwarp(peers);
    if (lane == leader) {
      s = lanes[leader];
      for (unsigned m = peers & (peers - 1); m; m &= m - 1)
        s += lanes[__ffs(m) - 1];
    }
    __syncwarp(peers);
  }
  if (lane == leader) add_cell<kMode>(cell, s, grid, part);
}

// grid: the (height, width) f32 grid, zeroed by the caller; cells =
// width * height. The block path's copy of it is dynamic shared memory.
template <class L, int kMode>
__global__ void __launch_bounds__(kPrivThreads)
    density_grid_kernel(L rows, Bins b, float* __restrict__ grid, int cells) {
  extern __shared__ float s_part[];
  __shared__ float s_lanes[kPrivThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kMode == kBlock) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) s_part[i] = 0.f;
    __syncthreads();
  }
  const int64_t n = rows.n;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t k0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     warp) * 32 * kSteps;
       k0 < n; k0 += warps * 32 * kSteps) {
    float x[kSteps], y[kSteps], w[kSteps];
    bool ok[kSteps];
#pragma unroll
    for (int r = 0; r < kSteps; ++r) {
      const int64_t k = k0 + r * 32 + lane;
      ok[r] = rows.load(k < n ? k : n - 1, x[r], y[r], w[r]) && k < n;
    }
#pragma unroll
    for (int r = 0; r < kSteps; ++r)
      warp_add<kMode>(ok[r] ? cell_of(x[r], y[r], b) : -1, w[r],
                      s_lanes[warp], lane, grid, s_part);
  }
  if constexpr (kMode == kBlock) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const float v = s_part[i];
      if (v != 0.f) atomicAdd(grid + i, v);
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

struct Plan {
  int mode;
  int blocks;
  long long flush;  // global adds of the block path's flush (0: global)
};

// The block path's shared-memory opt-in, once per loader.
template <class L>
cudaError_t opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      density_grid_kernel<L, kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockCells * 4);
  return err;
}

// The path for n rows into `cells` cells: `force` a mode (0 global, 1
// block), or -1 to choose. Refuses a forced block path whose grid does
// not fit.
template <class L>
cudaError_t plan(int64_t n, int cells, int force, Plan& p) {
  const int64_t per_block = static_cast<int64_t>(kThreads / 32) * 32 * kSteps;
  int64_t blocks = (n + per_block - 1) / per_block;
  p = {kGlobal, static_cast<int>(blocks < 1 ? 1 : blocks > kMaxBlocks
                                                      ? kMaxBlocks : blocks),
       0};
  if (force == kGlobal) return cudaSuccess;
  if (force != -1 && force != kBlock) return cudaErrorInvalidValue;
  const bool fits = cells <= kBlockCells;
  if (force == kBlock && !fits) return cudaErrorInvalidValue;
  if (force == -1 && !(fits && n >= kBlockRowsPerCell *
                                        (cells > kBlockMinCells
                                             ? cells : kBlockMinCells)))
    return cudaSuccess;
  cudaError_t err = opt_in<L>();
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, density_grid_kernel<L, kBlock>, kPrivThreads,
      static_cast<size_t>(cells) * 4);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sm_count();
  p = {kBlock, grid, static_cast<long long>(grid) * cells};
  return cudaSuccess;
}

template <class L>
int run(const L& rows, const Bins& b, float* grid, int force,
        cudaStream_t s) {
  const int cells = b.width * b.height;
  Plan p;
  const cudaError_t err = plan<L>(rows.n, cells, force, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.mode == kGlobal)
    density_grid_kernel<L, kGlobal><<<p.blocks, kThreads, 0, s>>>(
        rows, b, grid, cells);
  else
    density_grid_kernel<L, kBlock><<<p.blocks, kPrivThreads,
                                     static_cast<size_t>(cells) * 4, s>>>(
        rows, b, grid, cells);
  return static_cast<int>(cudaGetLastError());
}

bool bad_grid(int64_t n, int width, int height) {
  return n < 1 || width < 1 || height < 1 ||
         static_cast<int64_t>(width) * height > INT_MAX;
}

}  // namespace

extern "C" {

// grid (height, width) f32, zeroed by the caller, += the weights w (null:
// 1) of the n > 0 points (x, y) with mask set; width, height >= 1 and
// width * height < 2^31. mode: -1 chooses the path, 0 or 1 forces one
// (global, block; for measuring them).
int geomesa_density_grid(const float* x, const float* y, const float* w,
                         const uint8_t* mask, int64_t n, float xmin,
                         float ymin, float sx, float sy, int width,
                         int height, int mode, float* grid, void* stream) {
  if (bad_grid(n, width, height))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bins b{xmin, ymin, sx, sy, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    return run(ArrayRows<kF32>{x, y, w, mask, n}, b, grid, mode, s);
  return run(ArrayRows<kUnit>{x, y, w, mask, n}, b, grid, mode, s);
}

// The same grid over the rows ids[0 .. m) of the point columns px, py
// (f32) and pvalid (bool), weighted by wkind: 0 none, 1 f32 values wa,
// 2 int64 as int32 high words wa and low words wlo, 3 bool bytes wa;
// wvalid the weight's validity (unused when wkind is 0). Every id must
// be a row of the columns.
int geomesa_density_rows(const int32_t* ids, int64_t m, const float* px,
                         const float* py, const uint8_t* pvalid, int wkind,
                         const void* wa, const int32_t* wlo,
                         const uint8_t* wvalid, float xmin, float ymin,
                         float sx, float sy, int width, int height, int mode,
                         float* grid, void* stream) {
  if (bad_grid(m, width, height) || wkind < kUnit || wkind > kBool)
    return static_cast<int>(cudaErrorInvalidValue);
  const Bins b{xmin, ymin, sx, sy, width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case kUnit:
      return run(IdRows<kUnit>{ids, px, py, pvalid, wa, wlo, wvalid, m}, b,
                 grid, mode, s);
    case kF32:
      return run(IdRows<kF32>{ids, px, py, pvalid, wa, wlo, wvalid, m}, b,
                 grid, mode, s);
    case kI64:
      return run(IdRows<kI64>{ids, px, py, pvalid, wa, wlo, wvalid, m}, b,
                 grid, mode, s);
    default:
      return run(IdRows<kBool>{ids, px, py, pvalid, wa, wlo, wvalid, m}, b,
                 grid, mode, s);
  }
}

// The path that a launch of n rows into width x height cells takes:
// out[0] the mode (0 global, 1 block), out[1] its blocks, out[2] the
// block path's flush (global adds). loader: 0/1 the array loader
// unweighted/weighted, 2 + wkind the rows loader. mode as for the
// launches.
int geomesa_density_plan(int loader, int64_t n, int width, int height,
                         int mode, long long* out) {
  if (bad_grid(n, width, height) || loader < 0 || loader > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = width * height;
  Plan p;
  cudaError_t err;
  switch (loader) {
    case 0: err = plan<ArrayRows<kUnit>>(n, cells, mode, p); break;
    case 1: err = plan<ArrayRows<kF32>>(n, cells, mode, p); break;
    case 2: err = plan<IdRows<kUnit>>(n, cells, mode, p); break;
    case 3: err = plan<IdRows<kF32>>(n, cells, mode, p); break;
    case 4: err = plan<IdRows<kI64>>(n, cells, mode, p); break;
    default: err = plan<IdRows<kBool>>(n, cells, mode, p); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.mode;
  out[1] = p.blocks;
  out[2] = p.flush;
  return 0;
}

}  // extern "C"
