// Extent tristate kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/scan/gscan.py:_tristate_body
// (:153, jitted at :183, driven by extent_tristate :186): the device half
// of the in-memory store's extent (XZ) scan
// (geomesa_tpu/store/memory.py:_device_extent_scan :1693). Per row of an
// extent schema, with its bounding box rounded OUTWARD to f32 at build
// time (gscan._round_out :55):
//   overlap = OR over the K query boxes rounded outward
//             of (bxmax >= oxmin && bxmin <= oxmax && bymax >= oymin
//                 && bymin <= oymax)
//   inside  = OR over the same boxes rounded INWARD (gscan._round_in :66)
//             of (bxmin >= ixmin && bxmax <= ixmax && bymin >= iymin
//                 && bymax <= iymax)
//   state   = inside ? IN (2) : overlap ? MAYBE (1) : OUT (0)
//   state   = valid ? state : OUT
// and, when the query has B > 0 intervals and the schema has times, OUT
// unless some inclusive (day, ms) interval holds the row's (day, ms):
//   after  = day > day_lo || (day == day_lo && ms >= ms_lo)
//   before = day < day_hi || (day == day_hi && ms <= ms_hi)
// The store checks MAYBE rows (and, for a non-rectangular query, IN rows
// too) with the exact float64 predicate on the host. An inward-rounded
// box can come out inverted (lo > hi): no row is inside it, so it never
// yields IN. The (day, ms) split of the millis is floor division on the
// host (pre-1970 rows have a negative day and a non-negative ms); the
// kernel only compares.
//
// Every step is a plain >= / <= on f32 or i32 words, with no arithmetic,
// so the states equal the plain PyTorch version (kernels.
// extent_tristate_plain) bit for bit; a NaN compares false in both. Build
// WITHOUT --use_fast_math or -ftz=true (a flushed subnormal bound would
// compare as 0).
//
// Layout: bounds (n, 4) f32 [xmin ymin xmax ymax], 16-byte aligned, one
// float4 load a row; valid one byte a row; times (n, 2) int32 [day, ms],
// 8-byte aligned, one int2 load a row (read only for a row that is still
// in after the box test and only when the query has intervals); the
// state one int8 a row. The query's tables, outer (K, 4) f32, inner (K,
// 4) f32 and intervals (B, 4) int32, hold only the real boxes and
// intervals (no padding), and each block stages them in shared memory.
// One thread a row, grid-stride over 16 blocks an SM.
//
// Bound: the bytes it must move over the device memory's rate: 16 B of
// bounds + 1 B valid + 1 B state = 18 B a row without intervals, + 8 B of
// times = 26 B a row with them (0.537 and 0.776 ms at 100M rows at 3.35
// TB/s). The compares (about 8 a box, 6 an interval) stay far below the
// card's integer rate at the K and B the store sends.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

template <bool kTime>
__global__ void __launch_bounds__(kThreads)
extent_tristate_kernel(const float4* __restrict__ bounds,
                       const uint8_t* __restrict__ valid,
                       const int2* __restrict__ times, int64_t n,
                       const float4* __restrict__ outer,
                       const float4* __restrict__ inner, int k,
                       const int4* __restrict__ intervals, int b,
                       int8_t* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* s_outer = smem;
  float4* s_inner = smem + k;
  int4* s_iv = reinterpret_cast<int4*>(smem + 2 * k);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    s_outer[i] = outer[i];
    s_inner[i] = inner[i];
  }
  if (kTime)
    for (int i = threadIdx.x; i < b; i += blockDim.x) s_iv[i] = intervals[i];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < n; row += stride) {
    int8_t state = 0;
    if (__ldg(valid + row)) {
      const float4 r = __ldg(bounds + row);  // xmin ymin xmax ymax
      bool overlap = false;
      bool inside = false;
      for (int j = 0; j < k; ++j) {
        const float4 o = s_outer[j];
        const float4 q = s_inner[j];
        overlap |= (r.z >= o.x) & (r.x <= o.z) & (r.w >= o.y) & (r.y <= o.w);
        inside |= (r.x >= q.x) & (r.z <= q.z) & (r.y >= q.y) & (r.w <= q.w);
      }
      state = inside ? 2 : (overlap ? 1 : 0);
      if (kTime && state != 0) {
        const int2 t = __ldg(times + row);  // day, ms
        bool ok = false;
        for (int j = 0; j < b; ++j) {
          const int4 v = s_iv[j];  // day_lo ms_lo day_hi ms_hi
          const bool after = (t.x > v.x) | ((t.x == v.x) & (t.y >= v.y));
          const bool before = (t.x < v.z) | ((t.x == v.z) & (t.y <= v.w));
          ok |= after & before;
        }
        if (!ok) state = 0;
      }
    }
    out[row] = state;
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

}  // namespace

extern "C" {

// out[i] in {0, 1, 2} for the n rows. times may be null (a schema with no
// date), and then b is ignored; b == 0 means no time constraint. k may be
// 0 (every row OUT). The tables take (2k + b) * 16 bytes of shared memory,
// at most 48 KB. Requires n > 0.
int geomesa_extent_tristate(const float* bounds, const uint8_t* valid,
                            const int32_t* times, int64_t n,
                            const float* outer, const float* inner, int k,
                            const int32_t* intervals, int b, int8_t* out,
                            void* stream) {
  const bool use_time = times != nullptr && b > 0;
  const size_t smem =
      (static_cast<size_t>(2 * k) + (use_time ? b : 0)) * sizeof(float4);
  const int sms = sm_count();
  if (n < 1 || k < 0 || b < 0 || sms < 1 || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      need < static_cast<int64_t>(sms) * kBlocksPerSm
          ? need
          : static_cast<int64_t>(sms) * kBlocksPerSm);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* b4 = reinterpret_cast<const float4*>(bounds);
  const auto* t2 = reinterpret_cast<const int2*>(times);
  const auto* o4 = reinterpret_cast<const float4*>(outer);
  const auto* i4 = reinterpret_cast<const float4*>(inner);
  const auto* v4 = reinterpret_cast<const int4*>(intervals);
  if (use_time)
    extent_tristate_kernel<true><<<blocks, kThreads, smem, s>>>(
        b4, valid, t2, n, o4, i4, k, v4, b, out);
  else
    extent_tristate_kernel<false><<<blocks, kThreads, smem, s>>>(
        b4, valid, t2, n, o4, i4, k, v4, 0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
