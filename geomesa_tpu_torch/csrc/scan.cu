// Fused spatio-temporal scan kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of the reference package:
//   - geomesa_tpu/scan/pallas_scan.py:_mask_call  (Pallas, body _block_mask)
//   - geomesa_tpu/scan/pallas_scan.py:_count_call (Pallas, SMEM-accumulated
//     hit count)
//   - the XLA programs geomesa_tpu/scan/zscan.py:_mask_body / _scan_mask
//     (dense tier) and _gather_scan_mask (gathered tier)
//
// Predicate, per row: OR over K boxes of the lexicographic two-float
// test (hi, lo) >= (bhi, blo) and <= on x and y; unless time_any, AND an
// OR over B inclusive (day, ms) intervals. It is a pure comparison of the
// stored f32/i32 words, with no arithmetic on them, so the result is
// bit-identical to the reference. Build WITHOUT --use_fast_math or
// -ftz=true: the lo residuals can be subnormal, and a flush-to-zero
// compare would read them as 0.
//
// Query tables: boxes (K, 8) f32 [xmin_hi, xmin_lo, xmax_hi, xmax_lo,
// ymin_hi, ymin_lo, ymax_hi, ymax_lo] and times (B, 4) i32 [day_lo,
// ms_lo, day_hi, ms_hi]. Unused slots carry impossible bounds (+inf/-inf,
// INT32_MAX/INT32_MIN), so the kernels carry no validity masks. Each
// block stages both tables in shared memory.
//
// Dense tier and count (scan_mask_kernel, scan_count_kernel). Bound:
// device-memory reads of 24 B/row from six columns (four f32 + two i32),
// plus 1 B/row written for the mask (the count writes 4 B in all). The
// TPU version tiled rows into (2048, 128) blocks with pad rows; here one
// thread handles one row in a grid-stride loop with coalesced 4-byte
// loads, and a row bound (n) replaces the pad rows: rows n <= i < cap
// write 0. Making them faster (16-byte vector loads, a bitmask output,
// fusing the boundary-candidate test) is later work.
//
// Gathered tier (scan_mask_gather_kernel): the predicate at m candidate
// rows given by int32 ids, in the ids' order. The ids come from the
// z-index's permutation, so the rows are random in row space. Bound: the
// useful bytes are 4 B of id, 24 B of words (16 B without time) and 1 B
// of mask per candidate; but a random row costs at least one whole
// 32-byte sector, so the least traffic is 32 + 4 + 1 B per candidate,
// and each row is a round trip to device memory that depends on its id.
// Six columns would cost six sectors per row. The design:
//   - it reads the row-major gather table `rows` (cap, 8) int32,
//     [xhi, xlo, yhi, ylo, tday, tms, 0, 0] with the floats as their bit
//     patterns: one candidate is one 32-byte sector, read as two 16-byte
//     loads on the read-only path (ld.global.nc.v4);
//   - ids are int32, four per thread group as one coalesced 16-byte load;
//   - every row load of a thread is issued before its first compare,
//     and time_any is a template parameter, so no branch sits between
//     loads;
//   - a time query takes two threads per row: each thread of a pair reads
//     one 16-byte half of the pair's 4 rows (coordinates or time), so a
//     warp's load asks for whole 32-byte sectors, and the pair joins its
//     verdicts with one shuffle. This measured faster than one thread
//     reading both halves of 4 rows (PERF.md). Without time a row is one
//     16-byte load, one row per thread.
//   Measured (PERF.md), the kernel is bound by the device memory's rate
//   of random sector reads, not by the bytes: a 16-byte read per row
//   costs about as much as a 32-byte one, and rows that the L2 cache
//   holds are read in well under half the time. kernel_ab.py times the
//   kernel beside a read of the same rows with no predicate. TMA copies
//   tiles, not scattered rows, so it does not apply. A cp.async ring in
//   shared memory would add a hop to data that is read once, and more
//   loads in flight per thread cost registers and so resident threads;
//   both are left out.
//
// C interface (bound with ctypes): every entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

struct Cols {
  const float* xhi;
  const float* xlo;
  const float* yhi;
  const float* ylo;
  const int32_t* tday;
  const int32_t* tms;
};

__device__ __forceinline__ bool ge2(float hi, float lo, float bhi, float blo) {
  return (hi > bhi) || ((hi == bhi) && (lo >= blo));
}

__device__ __forceinline__ bool le2(float hi, float lo, float bhi, float blo) {
  return (hi < bhi) || ((hi == bhi) && (lo <= blo));
}

// Stage the query tables in shared memory; every thread of the block
// must call this before the first row_hit.
__device__ __forceinline__ void load_tables(const float* boxes, int k,
                                            const int32_t* times, int b,
                                            float* s_boxes, int32_t* s_times) {
  for (int j = threadIdx.x; j < 8 * k; j += blockDim.x) s_boxes[j] = boxes[j];
  for (int j = threadIdx.x; j < 4 * b; j += blockDim.x) s_times[j] = times[j];
  __syncthreads();
}

// OR over the K boxes of the two-float box test.
__device__ __forceinline__ bool box_hit(float xh, float xl, float yh,
                                        float yl, const float* bx, int k) {
  bool s = false;
  for (int j = 0; j < k; ++j) {
    const float* q = bx + 8 * j;
    s |= ge2(xh, xl, q[0], q[1]) && le2(xh, xl, q[2], q[3]) &&
         ge2(yh, yl, q[4], q[5]) && le2(yh, yl, q[6], q[7]);
  }
  return s;
}

// OR over the B inclusive (day, ms) intervals.
__device__ __forceinline__ bool time_hit(int32_t td, int32_t tm,
                                         const int32_t* tx, int b) {
  bool t = false;
  for (int j = 0; j < b; ++j) {
    const int32_t* q = tx + 4 * j;
    const bool after = (td > q[0]) || ((td == q[0]) && (tm >= q[1]));
    const bool before = (td < q[2]) || ((td == q[2]) && (tm <= q[3]));
    t |= after && before;
  }
  return t;
}

__device__ __forceinline__ bool row_hit(const Cols& c, int64_t i,
                                        const float* bx, int k,
                                        const int32_t* tx, int b,
                                        int time_any) {
  const float xh = c.xhi[i], xl = c.xlo[i], yh = c.yhi[i], yl = c.ylo[i];
  const bool s = box_hit(xh, xl, yh, yl, bx, k);
  if (time_any) return s;
  const int32_t td = c.tday[i], tm = c.tms[i];
  const bool t = time_hit(td, tm, tx, b);
  return s && t;
}

__global__ void scan_mask_kernel(Cols c, int64_t n, int64_t cap,
                                 const float* boxes, int k,
                                 const int32_t* times, int b, int time_any,
                                 uint8_t* out) {
  extern __shared__ float smem[];
  float* s_boxes = smem;
  int32_t* s_times = reinterpret_cast<int32_t*>(smem + 8 * k);
  load_tables(boxes, k, times, b, s_boxes, s_times);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < cap; i += stride) {
    out[i] = (i < n) && row_hit(c, i, s_boxes, k, s_times, b, time_any);
  }
}

// The 4 ids j0 .. j0+3 of one thread group: one coalesced 16-byte load
// when the group is whole; the ragged last group loads what exists and
// pads with its first id, whose row is valid (its result is not stored).
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ idx,
                                         int64_t j0, int64_t m,
                                         uint32_t (&id)[4]) {
  if (j0 + 4 <= m) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(idx + j0));
    id[0] = w.x;
    id[1] = w.y;
    id[2] = w.z;
    id[3] = w.w;
  } else {
    id[0] = __ldg(idx + j0);
    for (int r = 1; r < 4; ++r)
      id[r] = (j0 + r < m) ? static_cast<uint32_t>(__ldg(idx + j0 + r)) : id[0];
  }
}

// bits: byte r is the verdict of id j0 + r.
__device__ __forceinline__ void store_mask(uint8_t* __restrict__ out,
                                           int64_t j0, int64_t m,
                                           uint32_t bits) {
  if (j0 + 4 <= m) {
    *reinterpret_cast<uint32_t*>(out + j0) = bits;
  } else {
    for (int r = 0; r < 4 && j0 + r < m; ++r)
      out[j0 + r] = static_cast<uint8_t>((bits >> (8 * r)) & 1u);
  }
}

// One group of SPLIT threads takes 4 consecutive ids: one thread without
// time (the coordinate half of its 4 rows), a pair with time, where
// thread h loads half h of the 4 rows (h 0: coordinates, h 1: time), so
// one warp-wide load asks for whole 32-byte sectors, and the pair ANDs
// its verdicts with one shuffle.
template <bool TIME_ANY>
__global__ void __launch_bounds__(kThreads)
    scan_mask_gather_kernel(const int4* __restrict__ rows,
                            const int32_t* __restrict__ idx, int64_t m,
                            const float* boxes, int k, const int32_t* times,
                            int b, uint8_t* __restrict__ out) {
  constexpr int SPLIT = TIME_ANY ? 1 : 2;
  extern __shared__ float smem[];
  float* s_boxes = smem;
  int32_t* s_times = reinterpret_cast<int32_t*>(smem + 8 * k);
  load_tables(boxes, k, times, b, s_boxes, s_times);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t j0 = (t / SPLIT) * 4;
  const uint32_t h = SPLIT == 2 ? (threadIdx.x & 1u) : 0u;
  const bool live = j0 < m;
  if (SPLIT == 1 && !live) return;
  uint32_t bits = 0;
  if (live) {
    uint32_t id[4];
    load_ids(idx, j0, m, id);
    int4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = __ldg(rows + 2u * id[r] + h);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool hit =
          h == 0 ? box_hit(__int_as_float(a[r].x), __int_as_float(a[r].y),
                           __int_as_float(a[r].z), __int_as_float(a[r].w),
                           s_boxes, k)
                 : time_hit(a[r].x, a[r].y, s_times, b);
      bits |= static_cast<uint32_t>(hit) << (8 * r);
    }
  }
  if constexpr (SPLIT == 2) {
    // both threads of a pair share j0, so a pair is live or dead as one;
    // every lane of the warp reaches the shuffle
    bits &= __shfl_xor_sync(0xffffffffu, bits, 1);
    if (h != 0) return;
  }
  if (live) store_mask(out, j0, m, bits);
}

__global__ void scan_count_kernel(Cols c, int64_t n, const float* boxes,
                                  int k, const int32_t* times, int b,
                                  int time_any, int32_t* out) {
  extern __shared__ float smem[];
  __shared__ int32_t warp_sums[kThreads / 32];
  float* s_boxes = smem;
  int32_t* s_times = reinterpret_cast<int32_t*>(smem + 8 * k);
  load_tables(boxes, k, times, b, s_boxes, s_times);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int32_t local = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    local += row_hit(c, i, s_boxes, k, s_times, b, time_any) ? 1 : 0;
  }
  // integer sums: exact in any order
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0 && local) atomicAdd(out, local);
  }
}

int grid_for(int64_t rows) {
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

size_t smem_bytes(int k, int b) {
  return static_cast<size_t>(k) * 8 * sizeof(float) +
         static_cast<size_t>(b) * 4 * sizeof(int32_t);
}

template <bool TIME_ANY>
int launch_gather(const int32_t* rows, const int32_t* idx, int64_t m,
                  const float* boxes, int k, const int32_t* times, int b,
                  uint8_t* out, cudaStream_t stream) {
  // one thread (a pair with time) per 4 ids, no grid-stride loop: all of
  // a thread's loads are in flight at once
  const int64_t threads = (m + 3) / 4 * (TIME_ANY ? 1 : 2);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  scan_mask_gather_kernel<TIME_ANY>
      <<<static_cast<int>(blocks), kThreads, smem_bytes(k, b), stream>>>(
          reinterpret_cast<const int4*>(rows), idx, m, boxes, k, times, b,
          out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dense tier: out[i] for 0 <= i < cap; rows >= n are 0. Requires cap > 0.
int geomesa_scan_mask(const float* xhi, const float* xlo, const float* yhi,
                      const float* ylo, const int32_t* tday,
                      const int32_t* tms, int64_t n, int64_t cap,
                      const float* boxes, int k, const int32_t* times, int b,
                      int time_any, uint8_t* out, void* stream) {
  Cols c{xhi, xlo, yhi, ylo, tday, tms};
  scan_mask_kernel<<<grid_for(cap), kThreads, smem_bytes(k, b),
                     static_cast<cudaStream_t>(stream)>>>(
      c, n, cap, boxes, k, times, b, time_any, out);
  return static_cast<int>(cudaGetLastError());
}

// Gathered tier: out[j] = predicate(row idx[j]) for 0 <= j < m, read from
// the (cap, 8) int32 gather table `rows` (32-byte aligned); idx is int32
// (16-byte aligned) and every idx[j] must lie in [0, n); out is 4-byte
// aligned. Requires m > 0.
int geomesa_scan_mask_gather(const int32_t* rows, const int32_t* idx,
                             int64_t m, const float* boxes, int k,
                             const int32_t* times, int b, int time_any,
                             uint8_t* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return time_any ? launch_gather<true>(rows, idx, m, boxes, k, times, b, out, s)
                  : launch_gather<false>(rows, idx, m, boxes, k, times, b, out, s);
}

// Count: *out += number of rows i < n that match; *out must be zeroed by
// the caller. Requires n > 0.
int geomesa_scan_count(const float* xhi, const float* xlo, const float* yhi,
                       const float* ylo, const int32_t* tday,
                       const int32_t* tms, int64_t n, const float* boxes,
                       int k, const int32_t* times, int b, int time_any,
                       int32_t* out, void* stream) {
  Cols c{xhi, xlo, yhi, ylo, tday, tms};
  scan_count_kernel<<<grid_for(n), kThreads, smem_bytes(k, b),
                      static_cast<cudaStream_t>(stream)>>>(
      c, n, boxes, k, times, b, time_any, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
