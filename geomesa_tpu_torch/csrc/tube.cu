// Tube kernel for Hopper (sm_90a).
//
// Replaces the XLA program geomesa_tpu/analytics/tube.py:_tube_kernel
// (:85, driven by tube_select_mask :104): the device half of tube select
// (TubeSelectProcess), whose tube is K (box, time interval) pairs built
// from a track on the host (TubeBuilder). Per row of the point columns:
//   match = OR over i of (box_i holds (x, y)) AND (interval_i holds t)
// the pairs' AND ORed, not the scan's cross product of boxes and
// intervals. The box test is the scan's lexicographic two-float compare,
// both edges inclusive: (xhi, xlo) >= (xmin_hi, xmin_lo) and <= (xmax_hi,
// xmax_lo), the same on y. The time test is the same compare on (day,
// ms): (day, ms) >= (day_lo, ms_lo) and <= (day_hi, ms_hi). Every step
// compares stored f32 / i32 words, with no arithmetic on the floats, so
// the mask equals the plain PyTorch version (kernels.tube_mask_plain) bit
// for bit; a NaN coordinate compares false in both. Build WITHOUT
// --use_fast_math or -ftz=true (a flushed subnormal lo word would
// compare as 0).
//
// Design. Nearly every (row, pair) is rejected by its time test: a track
// binned by the hour gives each row at most a pair or two whose interval
// holds its time. So the kernel searches instead of testing every pair:
//   - a (day, ms) pair becomes one int64 key, day * 2^32 + (ms + 2^31),
//     whose order is exactly the lexicographic (day, ms) order for any
//     int32 words (the key is computed, the words are not rounded);
//   - the wrapper (kernels.tube_pairs) sorts the pairs by their interval's
//     lo key and gives each its hi key and the running max of the hi keys
//     (pm), so the pairs whose interval can hold key t are those at or
//     before the last lo <= t, back to the first whose pm >= t: a binary
//     search and a short backward scan, exact for any table (unsorted,
//     overlapping or empty intervals included);
//   - each block stages the pairs in shared memory, 768 at a time (43 KB:
//     lo, pm, hi and the 32-byte box); a table of at most 768 pairs is
//     staged once per block, a longer one once per chunk and tile of
//     rows, with the chunk loop left as soon as every row of the tile is
//     decided (__syncthreads_and);
//   - one thread takes 4 rows, 256 threads a block, a grid-stride loop
//     over tiles of 1024 rows with 4 blocks an SM; a row's time words are
//     read first and its coordinates only when the staged pairs may hold
//     its time (some lo <= t and some hi >= t); its verdict is one byte.
// The binary search reads shared memory at addresses that differ between
// lanes (bank conflicts), about log2(K) + 1 reads a row.
//
// Bound: the bytes this call's rows need, 8 B of time words a row, 16 B
// of coordinates a row whose time some pair's interval holds, 1 B
// written (chip_smoke.py counts them from the rows and the tables); the
// operations that count, a time test a row and a box test for each pair
// whose interval holds a row, take far less. The simpler design, a
// linear walk of the staged pairs (the interval test first, out at the
// first match), is 14-28x slower on the H100 (kernel_ab.py --tube-only).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                    // rows a thread
constexpr int kTile = kThreads * kRows;     // rows a block iteration
constexpr int kChunk = 768;                 // pairs staged at once
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ bool ge2(float hi, float lo, float bhi,
                                    float blo) {
  return (hi > bhi) | ((hi == bhi) & (lo >= blo));
}

__device__ __forceinline__ bool le2(float hi, float lo, float bhi,
                                    float blo) {
  return (hi < bhi) | ((hi == bhi) & (lo <= blo));
}

__device__ __forceinline__ long long time_key(int day, int ms) {
  return static_cast<long long>(day) * 4294967296LL +
         (static_cast<long long>(ms) + 2147483648LL);
}

__global__ void __launch_bounds__(kThreads)
tube_mask_kernel(const float* __restrict__ xhi, const float* __restrict__ xlo,
                 const float* __restrict__ yhi, const float* __restrict__ ylo,
                 const int* __restrict__ tday, const int* __restrict__ tms,
                 int64_t n, const long long* __restrict__ lo_keys,
                 const long long* __restrict__ pm_keys,
                 const long long* __restrict__ hi_keys,
                 const float4* __restrict__ boxes, int k,
                 bool* __restrict__ out) {
  __shared__ long long s_lo[kChunk];
  __shared__ long long s_pm[kChunk];
  __shared__ long long s_hi[kChunk];
  __shared__ float4 s_box[2 * kChunk];  // [xmin_hi xmin_lo xmax_hi xmax_lo]
                                        // [ymin_hi ymin_lo ymax_hi ymax_lo]
  const int nchunks = (k + kChunk - 1) / kChunk;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  bool staged = false;  // the same in every thread of the block
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t base = tile * kTile + threadIdx.x;
    long long key[kRows];
    bool done[kRows];
    bool hit[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = base + static_cast<int64_t>(r) * kThreads;
      done[r] = row >= n;
      hit[r] = false;
      key[r] = done[r] ? 0 : time_key(__ldg(tday + row), __ldg(tms + row));
    }
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kChunk;
      const int m = k - c0 < kChunk ? k - c0 : kChunk;
      if (nchunks > 1 || !staged) {
        __syncthreads();  // the previous chunk's readers are done
        for (int i = threadIdx.x; i < m; i += kThreads) {
          s_lo[i] = lo_keys[c0 + i];
          s_pm[i] = pm_keys[c0 + i];
          s_hi[i] = hi_keys[c0 + i];
          s_box[2 * i] = boxes[2 * (c0 + i)];
          s_box[2 * i + 1] = boxes[2 * (c0 + i) + 1];
        }
        __syncthreads();
        staged = true;
      }
      bool all_done = true;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long t = key[r];
        if (!done[r]) {
          if (s_lo[0] > t) {
            done[r] = true;  // every later pair starts later still
          } else if (s_pm[m - 1] >= t) {
            // the pairs after the last lo <= t start too late
            int a = 0, b = m;
            while (a < b) {
              const int mid = (a + b) >> 1;
              if (s_lo[mid] <= t) a = mid + 1; else b = mid;
            }
            const int64_t row = base + static_cast<int64_t>(r) * kThreads;
            const float xh = __ldg(xhi + row), xl = __ldg(xlo + row);
            const float yh = __ldg(yhi + row), yl = __ldg(ylo + row);
            // back to the first pair whose running max of hi reaches t
            for (int i = a - 1; i >= 0 && s_pm[i] >= t; --i) {
              if (s_hi[i] < t) continue;
              const float4 bx = s_box[2 * i];
              const float4 by = s_box[2 * i + 1];
              if (ge2(xh, xl, bx.x, bx.y) & le2(xh, xl, bx.z, bx.w) &
                  ge2(yh, yl, by.x, by.y) & le2(yh, yl, by.z, by.w)) {
                hit[r] = true;
                done[r] = true;
                break;
              }
            }
          }
        }
        all_done &= done[r];
      }
      if (nchunks > 1 && __syncthreads_and(all_done)) break;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = base + static_cast<int64_t>(r) * kThreads;
      if (row < n) out[row] = hit[r];
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

}  // namespace

extern "C" {

// out[i] for the n rows (bool). The k >= 1 pairs come sorted by their lo
// key with the running max of the hi keys (kernels.tube_pairs): lo, pm and
// hi int64[k], boxes f32 (k, 8), 16-byte aligned. Requires n > 0.
int geomesa_tube_mask(const float* xhi, const float* xlo, const float* yhi,
                      const float* ylo, const int32_t* tday,
                      const int32_t* tms, int64_t n, const int64_t* lo_keys,
                      const int64_t* pm_keys, const int64_t* hi_keys,
                      const float* boxes, int k, bool* out, void* stream) {
  const int sms = sm_count();
  if (n < 1 || k < 1 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(tiles < cap ? tiles : cap);
  tube_mask_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xhi, xlo, yhi, ylo, tday, tms, n,
      reinterpret_cast<const long long*>(lo_keys),
      reinterpret_cast<const long long*>(pm_keys),
      reinterpret_cast<const long long*>(hi_keys),
      reinterpret_cast<const float4*>(boxes), k, out);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's constants: 0 the pairs staged at once, 1 rows a block
// iteration.
int geomesa_tube_constant(int which) {
  return which == 0 ? kChunk : which == 1 ? kTile : -1;
}

}  // extern "C"
