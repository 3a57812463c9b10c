#!/usr/bin/env python
"""Time the port's kernels in several checkouts by one method.

    python3 kernel_ab.py [--seed 0] [--rows 100000000]
                         [--store-rows 10000000] [--predicates-only]
                         [--density-only] [--store-only] [--prefix-only]
                         [--joins-only] [--tube-only] [--standing-only]
                         [--serving-only] TREE [TREE ...]

Each TREE is the root of a checkout of the repo (a ``git archive`` of a
commit unpacked into a git-ignored directory will do). The trees run
one after another on one card, each in a process of its own that
imports that tree's ``geomesa_tpu_torch``, so ``old new new old``
compares two versions within one call. Each process:

- builds the kernels from its tree's ``csrc/scan.cu``;
- makes chip_smoke.py's kernels-phase data (--rows rows from --seed in
  a power-of-two capacity) and its BBOX+time query;
- times ``scan_mask``, ``scan_count`` and ``scan_mask_gather`` (1M
  random row ids from --seed) by two methods: "held", as chip_smoke.py
  times (a spin kernel holds the card while the host enqueues the timed
  launch, so the events time the device alone), and "bare" (events
  around the call on an idle card, which also catch the host's
  enqueue); the gathered kernel also "cold", held with the L2 cache
  flushed before each launch;
- times the gathered kernel the same ways at the main path's shape: the
  north-star query's candidate ids from a z-index over chip_smoke.py's
  store-phase data (--store-rows rows from --seed + 1);
- where the tree has the row-major gather table (``ScanData.rows``),
  times beside it a read of the same rows with no predicate: a probe
  kernel built by this script from PROBE_SOURCE, with the gathered
  kernel's loads, no query tables, and one byte out per id;
- where the tree has the batched kernels, times them held at two
  shapes: the kernels-phase rows with chip_smoke.py's kernels-phase
  batch of 32 queries, and the store-phase rows with its batched-phase
  batch of 32 (``batched_100m``, ``batched_10m``): ``scan_batch_bits``
  (over each query's own slots where the tree's ``stack_queries``
  counts them), ``compact_bits`` through its wrapper and its
  compaction kernel alone, each batch built by the tree's own
  ``stack_queries`` and checked against the plain versions; where the
  tree has the prefix kernel, it on the batch's partials cut into 1x,
  4x and 16x as many (kind, query) rows, beside one ``torch.cumsum``,
  and a probe of the compaction built from PROBE_SOURCE, cut short
  after its loads and before its id stores;
- where the tree has the predicate kernels (``scan/gscan.py``,
  ``scan/residual.py``), times them held at chip_smoke.py's predicates
  phase's shapes (``predicates_10m``): ``pip_mask`` on the rows of its
  polygon query's envelope and DURING (the point-in-polygon candidates)
  against the 340 edges of its polygon, each tree packing the polygon
  with its own ``pack_polygon``; and the residual kernel alone (a
  pointer table built once) and through its wrapper on the phase's
  fullscan attribute filter and its dense secondary with band rows, each
  program compiled by the tree's own ``compile_program`` over its own
  ``DeviceColumns`` of the phase's store data (--store-rows rows from
  chip_smoke.py's ``predicate_data``). Every result is checked against
  the tree's plain version. A tree whose wrapper takes the program on
  the host is timed alone through its ``residual_launcher`` (the launch
  prepared once); an earlier tree's with its pointer table built once.
  Both it and the wrapper are timed held and on an idle card ("bare",
  the host's work included), and a wrapper that keeps prepared launches
  also cold (its cache cleared before each call).
  ``--predicates-only`` times these and nothing else.
- where the tree has the density kernel (``kernels.density_grid``),
  times it held at chip_smoke.py's surface phase's shapes
  (``density_10m``): the rows of its 73-day world query from the
  predicates phase's data, weighted by NumMentions on the 2048x1024
  grid, the same rows in one cell (a 1x1 grid), and the rows of its
  30-day tile unweighted on the 256x256 grid, through the array loader
  (the inputs made by the tree's own ``density_upload`` and
  ``density_scalars``, as the parent's store fed it); where the tree has
  the rows loader (``kernels.density_grid_rows``), the same shapes and
  the zoom-0 world (256x256, unweighted) and the world call weighted by
  AvgTone and unweighted, from the rows' ids into
  ``DeviceColumns`` of the phase's store data, with the path each took
  and its byte bound; a sweep of the rows loader's two paths forced
  (global, block; ``path_sweep``) over SWEEP_GRIDS and the
  world's first SWEEP_ROWS rows, beside the path the kernel chooses;
  and the atomic rates that bound the global path, from a probe of as
  many red.global.add.f32 as the world has rows, into an 8 MB grid at
  hashed cells and at one address (``atomic_rates``). Each result is
  checked against the tree's plain version (unit weights equal,
  weighted within 2 * n_cell * 2^-24 * sum |w| a cell).
  ``--density-only`` times these and nothing else.
- ``--prefix-only`` times the prefix kernel alone on the partials of
  chip_smoke.py's kernels-phase batch over --rows rows and of its
  batched-phase batch over --store-rows rows (``prefix_100m``,
  ``prefix_10m``), each checked against the plain version, beside one
  ``torch.cumsum`` of the same partials, an empty kernel on the same
  stream (the least a launch takes), and a cooperative prefix built by
  this script from PROBE_SOURCE (the same tiles, one grid-wide barrier
  between their sums and their stores instead of the look-back).
- ``--store-only`` times nothing of the above: the tree's store on
  chip_smoke.py's store phase (this checkout's ``phase_store``: the
  same 10M rows and chunked writes), then each of its queries in the
  gathered and the dense tier STORE_RUNS more times, host clock until
  the ids are on the host (``store_10m``: p50 and quartiles in ms); and
  the dense north-star query in parts (the scan kernel with the mask's
  copy to the host, the f64 patch; medians) and in a cProfile of five
  calls.
- ``--joins-only`` times the join kernels and nothing
  else, at chip_smoke.py's analytics shapes, through the tree's own
  wrappers and its own chip_smoke.py's launchers, each result checked
  against the tree's plain version: the dwithin kernel (``dwithin_10m``)
  on --store-rows rows (the store phase's seeded points in a power-of-two
  capacity) against the analytics phase's 1,000 query points at r =
  0.25 (BASELINE.md's configuration 3) and against 64 points at r = 30
  degrees (``dwithin_wide_10m``): the kernel alone (its launch on lists
  built once, where the tree's chip_smoke.py has ``_dwithin_launcher``;
  an earlier tree's wrapper is its launch) and the wrapper held and on
  an idle card (where the tree takes it, the wrapper gets the resident
  table's x-sort, as the join passes its cached sort); the contains
  kernel (``contains_100m``) on 100M seeded points (2^27 capacity)
  against chip_smoke.py's 10,032 polygons (configuration 5), tables
  built by the tree's own join module: its counts pass alone, its rows
  pass alone, and the contains_counts wrapper on an idle card; the slab
  kernels (both passes alone, by the tree's chip_smoke.py launcher, and
  the slab_pairs wrapper held and bare) in radius mode at the DWithin
  pairs call's shape (``slab_10m``: the 1,000 points, r = 0.25, slabs
  by the join's own ``_slab_setup``) and in box mode at the Contains
  pairs call's (``slab_box_100m``: chip_smoke.py's 100 polygons on the
  100M points); the knn kernel through its wrapper (its launches are
  the call), held and bare, with its launches a call, at the batcher's
  largest shape (``knn_10m_32q``: the 10M points, 32 of the analytics
  phase's batcher points, kpad 256) and at BASELINE.md's configuration
  4 (``knn_50m_8q``: 50M points in a 2^26-row buffer, bench.py's 8
  points, kpad 256); and the x-sort of both tables.
- ``--tube-only`` times the tube kernel and nothing else, on
  chip_smoke.py's kernels-phase rows (--rows rows from --seed in a
  power-of-two capacity) against this checkout's chip_smoke.py tubes
  (``tube_cases``: 720 sparse pairs, 1,000 dense ones) and a year-long
  hourly track of 8,760 pairs at 36.5 % of the rows' times
  (``year_tube``), and one pair before every row's time (``outside``:
  the time pass alone): the tree's ``tube_mask`` held (as every wrapper
  is timed, and after 30 warm-up launches behind a spin 4x as long, which
  covers the wrapper's host work) and on an idle card (its pair sort
  included), and its kernel alone (the pair tables built once), with its
  bucket bits and pairs staged where the tree has ``tube_bucket_bits``;
  held beside it the simpler design built by this script from
  PROBE_SOURCE (``tube_linear``: one row a thread, a
  row outside the table's overall time range out after its time words,
  else a linear walk of the pairs staged in shared memory in the
  table's own order, the interval test first, out at the first match;
  sparse and dense only) and the kernel's time pass alone
  (``tube_stream``: the same tiles, ring and stores, the range test
  only, at the occupancy the query gives and at 2 and 1 blocks an SM).
  The sparse and dense masks and the linear probe's are checked against
  the tree's ``tube_mask_plain``, the year-long one in the first tree
  only (tens of seconds); every tree's masks must equal the first
  tree's (sha256). With chip_smoke.py's bound and sector floor of each
  tube (``tube_needs``).
- ``--standing-only`` times nothing of the above: bench.py config 15's
  bulk dispatch (``standing_1m_100k``): 100,000 geofences of this
  checkout's chip_smoke.py mix (``geofence_ecql`` from --seed + 15)
  registered in the tree's ``StandingFilterSet`` on the card, then one
  1M-row batch (``geofence_batch`` from --seed + 16) dispatched twice
  (the first after the registrations, the second with nothing changed
  between), each dispatch's ``last_split`` (its ``match_s``: the
  standing work and the copies to the host) and wall time; every
  tree's hits (each filter's ids, in filter order) must equal the first
  tree's (sha256).
- ``--serving-only`` times nothing of the above: the tree's store and
  batched serving at its defaults (``serving_10m``), on this checkout's
  chip_smoke.py store phase (``phase_store``: 10M rows, chunked
  writes) and batched phase's 32 seeded queries: each store query
  STORE_RUNS times in the default, gathered and dense tiers (p50 and
  quartiles, host clock until the ids are on the host);
  ``query_batched`` at batch sizes 2, 8 and 32 beside the same queries
  as sequential ``query()`` calls (SERVING_RUNS passes, p50 a call);
  and SERVING_RUNS loads of 32 threads x 8 queries through a new
  ``QueryBatcher(ds)`` (queries/s, per-query p50). Every answer equals
  the float64 brute force; every tree's ids must equal the first
  tree's (sha256).

Medians of 20 launches (CUDA events; 10 for the batched kernels). Every
gathered and batched result is checked against its plain version.
Prints one JSON line per tree, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MS_DAY = 86_400_000
HOLD_CYCLES = 200_000          # ~0.1 ms of GPU spin ahead of each timed launch
L2_FLUSH_BYTES = 256 << 20     # written between cold launches (L2: 50 MB)
GATHERED_IDS = 1_000_000
QUERY = ([(-80.0, 30.0, -60.0, 45.0)], [(20 * MS_DAY, 50 * MS_DAY)])
NORTH_BOXES = [(-80, 30, -60, 45)]
NORTH_IV = [(17_020 * MS_DAY + 1, 17_050 * MS_DAY - 1)]
T0_DAY, T1_DAY = 17_000, 17_100

# The gathered kernel's loads and nothing else: two threads per 4 ids,
# thread h reads 16-byte half h of each of its 4 rows of the (cap, 8)
# int32 table; the pair folds its words to one byte per id.
PROBE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void read_rows(const int4* __restrict__ rows,
                          const int32_t* __restrict__ idx, int64_t m,
                          uint8_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t j0 = (t / 2) * 4;
  const uint32_t h = threadIdx.x & 1u;
  uint32_t bits = 0;
  if (j0 < m) {
    uint32_t id[4];
    if (j0 + 4 <= m) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(idx + j0));
      id[0] = w.x; id[1] = w.y; id[2] = w.z; id[3] = w.w;
    } else {
      for (int r = 0; r < 4; ++r) id[r] = __ldg(idx + (j0 + r < m ? j0 + r : j0));
    }
    int4 a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = __ldg(rows + 2u * id[r] + h);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      bits |= static_cast<uint32_t>((a[r].x ^ a[r].y ^ a[r].z ^ a[r].w) & 1)
              << (8 * r);
  }
  bits ^= __shfl_xor_sync(0xffffffffu, bits, 1);
  if (h == 0 && j0 < m) {
    for (int r = 0; r < 4 && j0 + r < m; ++r) out[j0 + r] = (bits >> (8 * r)) & 1u;
  }
}

extern "C" int probe_read_rows(const int32_t* rows, const int32_t* idx,
                               int64_t m, uint8_t* out, void* stream) {
  const int64_t blocks = ((m + 3) / 4 * 2 + 255) / 256;
  read_rows<<<static_cast<int>(blocks), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(rows), idx, m, out);
  return static_cast<int>(cudaGetLastError());
}

// csrc/batch.cu's compaction with its grid, its walk over the pairs and
// its loads, cut short: mode 0 stops after each non-empty pair's loads
// (its 64 words and its offset), mode 1 also sums the query bases, scans
// the popcounts and forms every id, but writes no id. Each thread writes
// one word (an XOR of what it read or formed) so nothing is dropped.
__global__ void compact_probe(const uint32_t* __restrict__ bits,
                              const int32_t* __restrict__ partials,
                              const int32_t* __restrict__ offsets,
                              const int64_t* __restrict__ totals, int qp,
                              int64_t nb, int64_t words, int mode,
                              uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t warp = gt >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  int64_t row = -1;
  long long base = 0;
  uint32_t acc = 0;
  for (int64_t p0 = warp * 32; p0 < pairs; p0 += warps * 32) {
    const int64_t p = p0 + lane;
    const int32_t cnt = p < pairs ? partials[p] : 0;
    uint32_t todo = __ballot_sync(0xffffffffu, cnt != 0);
    const int64_t r0 = p0 / nb;
    while (todo) {
      const int64_t pp = p0 + (__ffs(todo) - 1);
      todo &= todo - 1;
      int64_t r = r0, j = pp - r0 * nb;
      while (j >= nb) {
        ++r;
        j -= nb;
      }
      const int64_t w0 = j * 64 + 2 * lane;
      const uint32_t* src = bits + r * words;
      const uint32_t a0 = w0 < words ? src[w0] : 0u;
      const uint32_t a1 = w0 + 1 < words ? src[w0 + 1] : 0u;
      const int32_t off = offsets[pp];
      if (mode == 0) {
        acc ^= a0 ^ a1 ^ static_cast<uint32_t>(off);
        continue;
      }
      const int kind = r >= qp;
      if (r != row) {
        row = r;
        long long s = 0;
        for (int64_t q = lane; q < r - kind * qp; q += 32)
          s += totals[kind * static_cast<int64_t>(qp) + q];
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        base = s;
      }
      const int mine = __popc(a0) + __popc(a1);
      int incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      long long k = base + off + incl - mine;
      const int32_t r0w = static_cast<int32_t>(w0 * 32);
      for (uint32_t m = a0; m; m &= m - 1)
        acc ^= static_cast<uint32_t>(r0w + __ffs(m) - 1 + k++);
      for (uint32_t m = a1; m; m &= m - 1)
        acc ^= static_cast<uint32_t>(r0w + 32 + __ffs(m) - 1 + k++);
    }
  }
  sink[gt] = acc;
}

// An empty kernel: the least a launch costs on the stream.
__global__ void empty_kernel() {}

extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The prefix kernel's cooperative alternative (csrc/batch.cu's tiles of
// 4096 partials, 256 threads, four 16-byte vectors a thread, striped):
// every tile resident at once (a cooperative launch; at most 32
// registers, so that 8 tiles fit on an SM), each sums its partials and
// writes its aggregate, one grid-wide barrier (a counter that the host's
// target says this launch has filled), then each adds its row's earlier
// aggregates and stores its offsets; the row's last tile writes the
// total.
__global__ void __launch_bounds__(256, 8)
    prefix_coop(const int32_t* __restrict__ partials, int64_t nb,
                int per_row, int32_t* __restrict__ offsets,
                int64_t* __restrict__ totals, int32_t* __restrict__ aggs,
                unsigned int* bar, unsigned int target) {
  __shared__ int32_t s_warp[8];
  __shared__ int32_t s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int row = tile / per_row, j = tile - row * per_row;
  const int32_t* in = partials + static_cast<int64_t>(row) * nb;
  int32_t* out = offsets + static_cast<int64_t>(row) * nb;
  const int64_t w0 = static_cast<int64_t>(j) * 4096 + warp * 512 + lane * 4;
  const bool vec_rows = nb % 4 == 0;
  int32_t v[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = w0 + e * 128;
    if (vec_rows && i + 4 <= nb) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(in + i));
      v[e][0] = a.x; v[e][1] = a.y; v[e][2] = a.z; v[e][3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[e][k] = i + k < nb ? __ldg(in + i + k) : 0;
    }
  }
  int32_t chunk = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int32_t x = v[e][k];
      v[e][k] = sum;
      sum += x;
    }
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int32_t lead = chunk + incl - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[e][k] += lead;
    chunk += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = chunk;
  __syncthreads();
  int32_t before = 0, agg = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    before += w < warp ? s_warp[w] : 0;
    agg += s_warp[w];
  }
  if (threadIdx.x == 0) {
    aggs[tile] = agg;
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
  if (warp == 0) {
    int32_t p = 0;
    for (int k = lane; k < j; k += 32)
      p += __ldcg(aggs + static_cast<int64_t>(row) * per_row + k);
#pragma unroll
    for (int off = 16; off; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) s_prefix = p;
  }
  __syncthreads();
  const int32_t first = s_prefix + before;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t i = w0 + e * 128;
    if (vec_rows && i + 4 <= nb) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(v[e][0] + first, v[e][1] + first, v[e][2] + first,
                    v[e][3] + first);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < nb) out[i + k] = v[e][k] + first;
    }
  }
  if (threadIdx.x == 0 && j == per_row - 1) totals[row] = s_prefix + agg;
}

// aggs: one int32 per tile; bar: a counter zeroed once, to which each
// launch adds its tile count; target: the counter after this launch.
extern "C" int probe_prefix_coop(const int32_t* partials, int rows, int64_t nb,
                                 int32_t* offsets, int64_t* totals,
                                 int32_t* aggs, unsigned int* bar,
                                 unsigned int target, void* stream) {
  int per_row = static_cast<int>((nb + 4095) / 4096);
  const int64_t tiles = static_cast<int64_t>(per_row) * rows;
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefix_coop, 256, 0);
  if (tiles > static_cast<int64_t>(per_sm) * sms)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&partials, &nb, &per_row, &offsets, &totals, &aggs, &bar,
                  &target};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(prefix_coop), dim3(static_cast<int>(tiles)),
      dim3(256), args, 0, static_cast<cudaStream_t>(stream)));
}

// n f32 adds of 1 (red.global.add.f32) into a grid of mask + 1 cells
// (a power of two) at hashed cells, or all at cell 0 (one != 0).
__global__ void atomic_probe(float* __restrict__ grid, int64_t n, uint32_t mask,
                             int one) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = static_cast<uint32_t>(i) * 0x9E3779B1u;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    atomicAdd(grid + (one ? 0u : (h & mask)), 1.0f);
  }
}

extern "C" int probe_atomics(float* grid, int64_t n, uint32_t mask, int one,
                             void* stream) {
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  atomic_probe<<<static_cast<int>(blocks), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(grid, n, mask, one);
  return static_cast<int>(cudaGetLastError());
}

// The simple tube design: one row a thread; a row whose (day, ms) key
// lies outside [t_min, t_max] (the table's least lo, greatest hi) is out
// after its time words; else its coordinates are read and the pairs
// walked in the table's own order, staged in shared memory 768 at a time,
// the interval test first, out at the first match.
constexpr int kLinChunk = 768;

__device__ __forceinline__ bool lin_ge(float hi, float lo, float bhi,
                                      float blo) {
  return (hi > bhi) | ((hi == bhi) & (lo >= blo));
}

__device__ __forceinline__ bool lin_le(float hi, float lo, float bhi,
                                      float blo) {
  return (hi < bhi) | ((hi == bhi) & (lo <= blo));
}

__global__ void __launch_bounds__(256)
tube_linear(const float* __restrict__ xhi, const float* __restrict__ xlo,
            const float* __restrict__ yhi, const float* __restrict__ ylo,
            const int* __restrict__ tday, const int* __restrict__ tms,
            int64_t n, const int4* __restrict__ times,
            const float4* __restrict__ boxes, int k, long long t_min,
            long long t_max, bool* __restrict__ out) {
  __shared__ int4 s_t[kLinChunk];
  __shared__ float4 s_b[2 * kLinChunk];
  const int nchunks = (k + kLinChunk - 1) / kLinChunk;
  bool staged = false;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < n; base += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = base + threadIdx.x;
    bool live = row < n, hit = false;
    int d = 0, ms = 0;
    float xh = 0.f, xl = 0.f, yh = 0.f, yl = 0.f;
    if (live) {
      d = tday[row];
      ms = tms[row];
      const long long t = static_cast<long long>(d) * 4294967296LL +
                          (static_cast<long long>(ms) + 2147483648LL);
      live = t >= t_min && t <= t_max;
    }
    if (live) {
      xh = xhi[row]; xl = xlo[row]; yh = yhi[row]; yl = ylo[row];
    }
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kLinChunk;
      const int m = k - c0 < kLinChunk ? k - c0 : kLinChunk;
      if (nchunks > 1 || !staged) {
        if (!__syncthreads_or(live)) break;
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
          s_t[i] = times[c0 + i];
          s_b[2 * i] = boxes[2 * (c0 + i)];
          s_b[2 * i + 1] = boxes[2 * (c0 + i) + 1];
        }
        __syncthreads();
        staged = true;
      }
      if (live) {
        for (int i = 0; i < m; ++i) {
          const int4 iv = s_t[i];
          if (((d > iv.x) | ((d == iv.x) & (ms >= iv.y))) &
              ((d < iv.z) | ((d == iv.z) & (ms <= iv.w)))) {
            const float4 bx = s_b[2 * i], by = s_b[2 * i + 1];
            if (lin_ge(xh, xl, bx.x, bx.y) & lin_le(xh, xl, bx.z, bx.w) &
                lin_ge(yh, yl, by.x, by.y) & lin_le(yh, yl, by.z, by.w)) {
              hit = true;
              live = false;
              break;
            }
          }
        }
      }
    }
    if (row < n) out[row] = hit;
  }
}

extern "C" int probe_tube_linear(const float* xhi, const float* xlo,
                                 const float* yhi, const float* ylo,
                                 const int* tday, const int* tms, int64_t n,
                                 const int* times, const float* boxes, int k,
                                 long long t_min, long long t_max, bool* out,
                                 void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tube_linear, 256, 0);
  int64_t blocks = (n + 255) / 256;
  if (blocks > static_cast<int64_t>(sms) * per_sm)
    blocks = static_cast<int64_t>(sms) * per_sm;
  if (n < 1 || k < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tube_linear<<<static_cast<int>(blocks), 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      xhi, xlo, yhi, ylo, tday, tms, n, reinterpret_cast<const int4*>(times),
      reinterpret_cast<const float4*>(boxes), k, t_min, t_max, out);
  return static_cast<int>(cudaGetLastError());
}

// The tube kernel's time pass alone: its persistent grid, tiles of 2,048
// rows and ring of two tiles filled by cp.async, each thread's 4 rows'
// words read as two 16-byte vectors and a verdict (the range test
// t_min <= t <= t_max) stored as one 4-byte word; no index, no
// candidates, no pairs. The floor of the kernel's streaming half, at the
// occupancy the query gives or at most per_sm_cap blocks an SM.
constexpr int kStreamThreads = 512;
constexpr int kStreamTile = 4 * kStreamThreads;

__device__ __forceinline__ void stream_copy(int* stage, const int* tday,
                                            const int* tms, int64_t tile,
                                            int64_t n) {
  const int64_t row = tile * kStreamTile + 4 * threadIdx.x;
  if (row < n) {
    const int bytes = n - row >= 4 ? 16 : static_cast<int>(n - row) * 4;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(stage + 4 * threadIdx.x));
    const unsigned m = static_cast<unsigned>(
        __cvta_generic_to_shared(stage + kStreamTile + 4 * threadIdx.x));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(tday + row), "r"(bytes) : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(m),
                 "l"(tms + row), "r"(bytes) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kStreamThreads)
tube_stream(const int* __restrict__ tday, const int* __restrict__ tms,
            int64_t n, long long t_min, long long t_max,
            unsigned char* __restrict__ out) {
  __shared__ __align__(16) int ring[2 * 2 * kStreamTile];
  const int64_t ntiles = (n + kStreamTile - 1) / kStreamTile;
  for (int s = 0; s < 2; ++s) {
    const int64_t t = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
    stream_copy(ring + s * 2 * kStreamTile, tday, tms, t < ntiles ? t : ntiles,
                n);
  }
  int stage = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const int* sd = ring + stage * 2 * kStreamTile;
    const int4 d = reinterpret_cast<const int4*>(sd)[threadIdx.x];
    const int4 m = reinterpret_cast<const int4*>(sd + kStreamTile)[threadIdx.x];
    const int days[4] = {d.x, d.y, d.z, d.w};
    const int mss[4] = {m.x, m.y, m.z, m.w};
    unsigned w = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long t = static_cast<long long>(days[r]) * 4294967296LL +
                          (static_cast<long long>(mss[r]) + 2147483648LL);
      w |= static_cast<unsigned>(t >= t_min && t <= t_max) << (8 * r);
    }
    const int64_t row0 = tile * kStreamTile + 4 * threadIdx.x;
    if (row0 + 4 <= n) {
      *reinterpret_cast<unsigned*>(out + row0) = w;
    } else {
      for (int r = 0; r < 4; ++r)
        if (row0 + r < n) out[row0 + r] = static_cast<unsigned char>(w >> (8 * r));
    }
    __syncthreads();  // as the kernel's barriers a tile
    const int64_t next = tile + 2 * static_cast<int64_t>(gridDim.x);
    stream_copy(ring + stage * 2 * kStreamTile, tday, tms,
                next < ntiles ? next : ntiles, n);
    stage ^= 1;
  }
}

extern "C" int probe_tube_stream(const int* tday, const int* tms, int64_t n,
                                 long long t_min, long long t_max, bool* out,
                                 int per_sm_cap, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tube_stream,
                                                kStreamThreads, 0);
  if (per_sm_cap > 0 && per_sm > per_sm_cap) per_sm = per_sm_cap;
  int64_t blocks = (n + kStreamTile - 1) / kStreamTile;
  if (blocks > static_cast<int64_t>(sms) * per_sm)
    blocks = static_cast<int64_t>(sms) * per_sm;
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  tube_stream<<<static_cast<int>(blocks), kStreamThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      tday, tms, n, t_min, t_max, reinterpret_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_compact(const uint32_t* bits, const int32_t* partials,
                             const int32_t* offsets, const int64_t* totals,
                             int qp, int64_t nb, int64_t words, int mode,
                             uint32_t* sink, int64_t sink_len, void* stream) {
  const int64_t pairs = 2 * static_cast<int64_t>(qp) * nb;
  int64_t blocks = ((pairs + 31) / 32 + 7) / 8;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks * 256 > sink_len) return static_cast<int>(cudaErrorInvalidValue);
  compact_probe<<<static_cast<int>(blocks), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      bits, partials, offsets, totals, qp, nb, words, mode, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def build_probe():
    build = os.path.join(ROOT, "geomesa_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "kernel_ab_probe.cu")
    lib = os.path.join(build, "kernel_ab_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    p = ctypes.c_void_p
    dll.probe_read_rows.argtypes = [p, p, ctypes.c_int64, p, p]
    dll.probe_read_rows.restype = ctypes.c_int
    i64 = ctypes.c_int64
    dll.probe_compact.argtypes = [p, p, p, p, ctypes.c_int, i64, i64,
                                  ctypes.c_int, p, i64, p]
    dll.probe_compact.restype = ctypes.c_int
    dll.probe_empty.argtypes = [p]
    dll.probe_empty.restype = ctypes.c_int
    dll.probe_prefix_coop.argtypes = [p, ctypes.c_int, i64, p, p, p, p,
                                      ctypes.c_uint, p]
    dll.probe_prefix_coop.restype = ctypes.c_int
    dll.probe_atomics.argtypes = [p, i64, ctypes.c_uint32, ctypes.c_int, p]
    dll.probe_atomics.restype = ctypes.c_int
    dll.probe_tube_linear.argtypes = [p] * 6 + [i64, p, p, ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_longlong, p, p]
    dll.probe_tube_linear.restype = ctypes.c_int
    dll.probe_tube_stream.argtypes = [p, p, i64, ctypes.c_longlong,
                                      ctypes.c_longlong, p, ctypes.c_int, p]
    dll.probe_tube_stream.restype = ctypes.c_int
    return dll


def cuda_ms(fn, held: bool, flush=None, iters: int = 20,
            warmup: int = 2, hold: int = HOLD_CYCLES) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        if held:
            torch.cuda._sleep(hold)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def three_ways(fn, flush) -> dict:
    return {"cold": cuda_ms(fn, True, flush), "held": cuda_ms(fn, True),
            "bare": cuda_ms(fn, False)}


def _smoke():
    """This checkout's chip_smoke.py, for its query batches."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batched_case(kernels, data, bq, tree: str, probe) -> dict:
    """The tree's batched kernels on batch ``bq``, held: the bitmap
    kernel, the compaction through its wrapper and its kernel alone, and
    (int32 offsets) the compaction probe's two cut-short modes."""
    import torch
    b, t = bq.tables(data.device)
    extra = (bq.counts(data.device),) if hasattr(bq, "counts") else ()

    def bits_k():
        return kernels.scan_batch_bits(data.cols, data.n, b, t, *extra)
    bits, parts = bits_k()
    want = kernels.scan_batch_bits_plain(data.cols, data.n, b, t, *extra)
    if not (torch.equal(bits, want[0]) and torch.equal(parts, want[1])):
        raise SystemExit(f"{tree}: scan_batch_bits != plain")
    del want
    got = kernels.compact_bits(bits, parts)
    want = kernels.compact_bits_plain(bits, parts)
    if not (np.array_equal(got[2], want[2])
            and all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))):
        raise SystemExit(f"{tree}: compact_bits != plain")
    qp, words, nb = bits.shape[1], bits.shape[2], parts.shape[2]
    outs = [torch.empty_like(ids) for ids in got[:2]]
    lib = kernels._library()
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(kernels, "compact_prefix"):
        plan = kernels.compact_prefix(parts)
    else:   # an older wrapper: int64 offsets from torch.cumsum
        plan = kernels._compact_plan(parts)[:1]
    ptrs = [x.data_ptr() for x in plan]

    def comp_kernel():
        rc = lib.geomesa_compact_bits(
            bits.data_ptr(), parts.data_ptr(), *ptrs, qp, nb, words,
            outs[0].data_ptr(), outs[1].data_ptr(), stream)
        if rc:
            raise RuntimeError(f"compact_bits launch failed: cudaError {rc}")
    comp_kernel()
    if not all(torch.equal(o, g) for o, g in zip(outs, got[:2])):
        raise SystemExit(f"{tree}: compaction kernel alone != plain")
    out = {"queries": qp, "own_slots": bool(extra),
           "ids": int(sum(len(g) for g in got[:2])),
           "scan_batch_bits_ms": cuda_ms(bits_k, True, iters=10),
           "compact_bits_ms": cuda_ms(
               lambda: kernels.compact_bits(bits, parts), True, iters=10),
           "compact_kernel_ms": cuda_ms(comp_kernel, True, iters=10)}
    if hasattr(kernels, "compact_prefix"):
        # the prefix kernel runs one block per (kind, query) row: the
        # same partials as 1x, 4x and 16x as many shorter rows, and one
        # torch.cumsum of them
        out["compact_prefix_ms_by_rows"] = {
            str(2 * qp * m): cuda_ms(
                lambda m=m: kernels.compact_prefix(
                    parts.view(2, qp * m, nb // m)), True, iters=10)
            for m in (1, 4, 16) if nb % m == 0}
        out["cumsum_ms"] = cuda_ms(
            lambda: torch.cumsum(parts, dim=2, dtype=torch.int64), True,
            iters=10)
        sink = torch.empty(132 * 16 * 256, dtype=torch.int32,
                           device=bits.device)
        for mode, name in ((0, "probe_loads_ms"), (1, "probe_no_stores_ms")):
            def cut(mode=mode):
                rc = probe.probe_compact(
                    bits.data_ptr(), parts.data_ptr(), *ptrs, qp, nb, words,
                    mode, sink.data_ptr(), sink.numel(), stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            out[name] = cuda_ms(cut, True, iters=10)
    return out


class _Coop:
    """The cooperative prefix probe's scratch: one aggregate per tile
    and a barrier counter zeroed once, with the launches' running
    target."""

    def __init__(self, tiles: int, device):
        import torch
        self.aggs = torch.empty(tiles, dtype=torch.int32, device=device)
        self.bar = torch.zeros(1, dtype=torch.int32, device=device)
        self.target = 0


def prefix_case(kernels, parts, probe) -> dict:
    """The tree's prefix kernel on ``parts`` (int32[2, Qp, nb]), held,
    checked against the plain version, beside one torch.cumsum of the
    same partials, an empty kernel on the same stream, and this
    checkout's cooperative prefix probe (one grid-wide barrier), also
    checked."""
    import torch
    want = kernels.compact_prefix_plain(parts)
    got = kernels.compact_prefix(parts)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("compact_prefix != plain")
    stream = torch.cuda.current_stream().cuda_stream
    rows, nb = 2 * parts.shape[1], parts.shape[2]
    tiles = rows * -(-nb // 4096)
    coop = _Coop(tiles, parts.device)
    offsets = torch.empty_like(parts)
    totals = torch.empty(parts.shape[:2], dtype=torch.int64,
                         device=parts.device)

    def coop_launch():
        coop.target += tiles
        rc = probe.probe_prefix_coop(
            parts.data_ptr(), rows, nb, offsets.data_ptr(), totals.data_ptr(),
            coop.aggs.data_ptr(), coop.bar.data_ptr(), coop.target, stream)
        if rc:
            coop.target -= tiles
            raise RuntimeError(f"cooperative prefix launch failed: "
                               f"cudaError {rc}")

    def empty():
        rc = probe.probe_empty(stream)
        if rc:
            raise RuntimeError(f"empty launch failed: cudaError {rc}")
    out = {"rows": rows, "nb": nb, "partials": rows * nb, "tiles": tiles,
           "compact_prefix_ms": cuda_ms(lambda: kernels.compact_prefix(parts),
                                        True),
           "cumsum_ms": cuda_ms(lambda: torch.cumsum(
               parts, dim=2, dtype=torch.int64), True),
           "empty_kernel_ms": cuda_ms(empty, True)}
    try:
        coop_launch()
    except RuntimeError as e:   # more tiles than fit at once: no number
        out["coop_prefix_ms"] = None
        out["coop_error"] = str(e)
        return out
    if not (torch.equal(offsets, want[0]) and torch.equal(totals, want[1])):
        raise SystemExit("cooperative prefix probe != plain")
    out["coop_prefix_ms"] = cuda_ms(coop_launch, True)
    return out


def prefix_only_case(kernels, zscan, smoke, seed: int, rows: int,
                store_rows: int, probe) -> dict:
    """The prefix kernel at chip_smoke.py's shapes: the partials of the
    kernels phase's batch of 32 over --rows rows (``prefix_100m``) and of
    the batched phase's 32 over --store-rows rows (``prefix_10m``)."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for name, seed_off, n, lo, hi, specs in (
            ("prefix_100m", 0, rows, 0, 1000 * MS_DAY,
             [zscan.make_query(*q) for q in smoke.kernel_batch_specs(seed)]),
            ("prefix_10m", 1, store_rows, T0_DAY * MS_DAY, T1_DAY * MS_DAY,
             None)):
        rng = np.random.default_rng(seed + seed_off)
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        ms = rng.integers(lo, hi, n)
        data = zscan.build_scan_data(x, y, ms, dev, cap=zscan.next_pow2(n))
        del x, y, ms
        bq = (zscan.stack_queries(specs) if specs is not None
              else smoke.store_batch(smoke.store_batch_specs(seed)))
        b, t = bq.tables(dev)
        extra = (bq.counts(dev),) if hasattr(bq, "counts") else ()
        _bits, parts = kernels.scan_batch_bits(data.cols, data.n, b, t, *extra)
        del data, _bits
        torch.cuda.empty_cache()
        out[name] = prefix_case(kernels, parts, probe)
    return out


def predicate_case(smoke, seed: int, rows: int) -> dict:
    """The tree's predicate kernels at chip_smoke.py's predicates-phase
    shapes, held, each checked against the tree's plain version."""
    import torch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.geometry import parse_wkt
    from geomesa_tpu_torch.scan import gscan, kernels, residual
    dev = torch.device("cuda")
    d = smoke.predicate_data(seed, rows)
    lo, hi = smoke.PRED_DURING
    sel = (smoke._in_box(d["x"], d["y"], smoke._env(smoke.PRED_SHELL))
           & (d["ms"] > lo * MS_DAY) & (d["ms"] < hi * MS_DAY))
    px, py = (torch.from_numpy(a).to(dev)
              for a in gscan.pip_points(d["x"][sel], d["y"][sel]))
    edges = gscan.pack_polygon(parse_wkt(smoke.PRED_POLYGON), dev).edges

    def pip():
        return kernels.pip_mask(px, py, edges, gscan.EDGE_EPS2)
    got, want = pip(), kernels.pip_mask_plain(px, py, edges, gscan.EDGE_EPS2)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("pip_mask != plain")
    out = {"pip_points": int(px.shape[0]), "pip_edges": int(edges.shape[0]),
           "pip_mask_ms": cuda_ms(pip, True, iters=10)}
    batch = smoke.predicate_batch(parse_spec("gdelt", smoke.PRED_SPEC), d,
                                  np.arange(rows).astype(object))
    cols = residual.DeviceColumns(batch, dev)
    lib = kernels._library()
    stream = torch.cuda.current_stream().cuda_stream
    host_program = hasattr(kernels, "residual_launcher")
    for name, ecql in (("attributes", smoke.PRED_ATTR_FILTER),
                       ("band", smoke.PRED_BAND_FILTER)):
        prog = residual.compile_program(parse_ecql(ecql), batch, cols)
        # the program on the host (this tree's wrapper), or on the device
        # (the earlier wrapper, which uploads a pointer table per call)
        code, consts, table = (
            torch.from_numpy(a).to("cpu" if host_program else dev)
            for a in (prog.code, prog.consts, prog.table))
        slots = [cols.get(c)["slot"] for c in prog.slots]
        res = kernels.residual_mask(code, consts, table, slots, rows)
        if not torch.equal(res, kernels.residual_mask_plain(
                code, consts, table, slots, rows)):
            raise SystemExit(f"residual_mask != plain ({name})")
        if host_program:
            alone = functools.partial(kernels.residual_launcher(
                code, consts, table, slots, dev), rows, res)
        else:
            ptrs = kernels.slot_table(slots, dev)

            def alone(code=code, consts=consts, table=table, ptrs=ptrs):
                rc = lib.geomesa_residual_mask(
                    code.data_ptr(), code.shape[0], consts.data_ptr(),
                    table.data_ptr(), ptrs.data_ptr(), rows, res.data_ptr(),
                    stream)
                if rc:
                    raise RuntimeError(f"residual launch failed: "
                                       f"cudaError {rc}")

        def wrapper(code=code, consts=consts, table=table, slots=slots):
            kernels.residual_mask(code, consts, table, slots, rows)
        case = out[f"residual_{name}"] = {
            "instructions": int(code.shape[0]), "slots": len(slots),
            "kernel_ms": cuda_ms(alone, True, iters=10),
            "wrapper_ms": cuda_ms(wrapper, True, iters=10),
            "kernel_bare_ms": cuda_ms(alone, False, iters=10),
            "wrapper_bare_ms": cuda_ms(wrapper, False, iters=10)}
        cache = getattr(kernels, "_residual_launches", None)
        if cache is not None:
            # the launch prepared anew each call, as on a new filter or
            # after a flush
            case["wrapper_cold_ms"] = cuda_ms(wrapper, False, cache.clear,
                                              iters=10)
    return out


# the path sweep of the rows loader: grids (width, height) and row
# counts (the world query's first rows)
SWEEP_GRIDS = [(1, 1), (32, 32), (64, 64), (128, 64), (128, 128), (256, 128),
               (256, 256), (512, 256), (512, 512), (1024, 512)]
SWEEP_ROWS = (None, 1_000_000, 100_000)   # None: all of the world's rows


def _rows_launcher(kernels, ids, point, weight, args, mode):
    """A launch of the rows loader with the path forced (0 global, 1
    block), outside the wrapper's count; None where the path
    does not fit the grid."""
    import torch
    w, h = args[-2:]
    kind = None if weight is None else weight[0]
    code = 0 if kind is None else kernels._DENSITY_WEIGHTS[kind][0]
    try:
        kernels.density_plan(ids.shape[0], w, h, kind, mode=mode)
    except RuntimeError:
        return None
    a, b, valid = weight[1] if weight is not None else (None, None, None)
    grid = torch.zeros((h, w), dtype=torch.float32, device=ids.device)
    lib = kernels._library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        grid.zero_()
        rc = lib.geomesa_density_rows(
            ids.data_ptr(), ids.shape[0], *(t.data_ptr() for t in point),
            code, 0 if a is None else a.data_ptr(),
            b.data_ptr() if code == 2 else 0,
            0 if valid is None else valid.data_ptr(), *args[:4], w, h, mode,
            grid.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"density launch failed: cudaError {rc}")
        return grid
    return launch


def density_case(smoke, seed: int, rows: int, probe) -> dict:
    """The tree's density kernel at chip_smoke.py's surface-phase
    shapes, held, each checked against the tree's plain version: the
    array loader on the rows gathered on the host (as the parent's
    store fed it); where the tree has the rows loader, it on the same
    rows' ids into DeviceColumns of the phase's store data, the zoom-0
    world at 256x256 and the world call weighted by a Double and
    unweighted among them, and a sweep of its two paths forced
    over SWEEP_GRIDS x SWEEP_ROWS (unweighted, plus the zero fill that
    the launch includes); then the atomic-rate probes."""
    import torch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.scan import aggregations, kernels
    dev = torch.device("cuda")
    d = smoke.predicate_data(seed, rows)
    ms = d["ms"]
    world = ((ms > smoke.SURFACE_WORLD_DAYS[0] * MS_DAY)
             & (ms < smoke.SURFACE_WORLD_DAYS[1] * MS_DAY))
    tile = (smoke._in_box(d["x"], d["y"], smoke.SURFACE_TILE)
            & (ms > smoke.SURFACE_TILE_DAYS[0] * MS_DAY)
            & (ms < smoke.SURFACE_TILE_DAYS[1] * MS_DAY))
    ment = np.where(d["mentions_valid"], d["mentions"], 0)
    shapes = (("world_2048x1024_NumMentions", world, smoke.WORLD, 2048, 1024,
               "NumMentions"),
              ("world_1x1_NumMentions", world, smoke.WORLD, 1, 1,
               "NumMentions"),
              ("tile_256", tile, smoke.SURFACE_TILE, 256, 256, None),
              ("world_256x256_zoom0", world, smoke.WORLD, 256, 256, None),
              ("world_2048x1024_AvgTone", world, smoke.WORLD, 2048, 1024,
               "AvgTone"),
              ("world_2048x1024_unweighted", world, smoke.WORLD, 2048, 1024,
               None))
    out = {}
    for name, sel, bbox, w, h, attr in shapes[:3]:
        idx = np.flatnonzero(sel)
        mask = (d["mentions_valid"][idx] if attr is not None
                else np.ones(len(idx), bool))
        xt, yt, wt, mt = aggregations.density_upload(
            d["x"][idx], d["y"][idx], mask,
            None if attr is None else ment[idx], dev)
        args = (xt, yt, wt, mt, *aggregations.density_scalars(bbox, w, h),
                w, h)
        got = kernels.density_grid(*args)
        want = kernels.density_grid_plain(*args)
        diff = (got.double() - want.double()).abs().flatten()
        if wt is None:
            ok = torch.equal(got, want)
        else:
            cells = kernels.density_cells_plain(*args[:2], *args[4:])[mt]
            n_cell = torch.bincount(cells, minlength=w * h).double()
            abs_w = torch.bincount(cells, wt[mt].abs().double(),
                                   minlength=w * h)
            ok = bool((diff <= 2 * n_cell * 2.0**-24 * abs_w).all())
        if not ok:
            raise SystemExit(f"density_grid != plain ({name})")
        out[name] = {"rows": len(idx), "max_abs_err": float(diff.max()),
                     "ms": cuda_ms(lambda: kernels.density_grid(*args),
                                   True)}
    if not hasattr(kernels, "density_grid_rows"):
        return out
    from geomesa_tpu_torch.scan import residual
    batch = smoke.predicate_batch(parse_spec("gdelt", smoke.PRED_SPEC), d,
                                  np.arange(rows).astype(object))
    cols = residual.DeviceColumns(batch, dev)
    point = cols.get("geom")["slot"]
    for name, sel, bbox, w, h, attr in shapes:
        ids = torch.from_numpy(np.flatnonzero(sel).astype(np.int32)).to(dev)
        weight = None if attr is None else (cols.get(attr)["kind"],
                                            cols.get(attr)["slot"])
        args = (ids, point, weight, *aggregations.density_scalars(bbox, w, h),
                w, h)
        got = kernels.density_grid_rows(*args)
        ok, err = smoke.density_launch_ok(args, got)
        if not ok:
            raise SystemExit(f"density_grid_rows != plain ({name})")
        out.setdefault(name, {"rows": int(ids.shape[0])})
        out[name].update({
            "rows_ms": cuda_ms(lambda: kernels.density_grid_rows(*args), True),
            "rows_max_abs_err": err,
            "rows_bound_ms": smoke.bound_ms(smoke.density_bytes(args), 0)[0],
            "rows_plan": kernels.density_plan(
                ids.shape[0], w, h, None if weight is None else weight[0])})
    world_ids = torch.from_numpy(np.flatnonzero(world).astype(np.int32)).to(dev)
    sweep = []
    for n in SWEEP_ROWS:
        ids = world_ids if n is None else world_ids[:n]
        for w, h in SWEEP_GRIDS:
            args = (*aggregations.density_scalars(smoke.WORLD, w, h), w, h)
            want = kernels.density_grid_rows_plain(ids, point, None, *args)
            row = {"rows": int(ids.shape[0]), "width": w, "height": h,
                   "auto": kernels.density_plan(ids.shape[0], w, h)}
            for mode, path in enumerate(kernels.DENSITY_PATHS):
                launch = _rows_launcher(kernels, ids, point, None, args, mode)
                if launch is None:
                    row[path] = None
                    continue
                if not torch.equal(launch(), want):
                    raise SystemExit(f"density path {path} != plain at "
                                     f"{ids.shape[0]} rows, {w}x{h}")
                row[path] = cuda_ms(launch, True, iters=10)
            sweep.append(row)
    out["path_sweep"] = sweep
    # the atomic rates that bound the global path: random adds into an
    # 8 MB grid that L2 holds, and adds at one address
    n = int(world_ids.shape[0])
    grid = torch.zeros(1 << 21, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rates = {"adds": n}
    for name, one in (("random_8mb", 0), ("one_address", 1)):
        def launch(one=one):
            rc = probe.probe_atomics(grid.data_ptr(), n, (1 << 21) - 1, one,
                                     stream)
            if rc:
                raise RuntimeError(f"atomic probe failed: cudaError {rc}")
        t = cuda_ms(launch, True, iters=10)
        rates[f"{name}_ms"] = t
        rates[f"{name}_adds_per_s"] = n / (t * 1e-3)
    out["atomic_rates"] = rates
    return out


STORE_RUNS = 21


STORE_TIERS = {"default": (None, None), "gathered": ("0", "1.0"),
               "dense": ("0", "0")}


def tier_p50s(smoke, ds, tiers) -> dict:
    """Each of chip_smoke.py's store queries STORE_RUNS times in each
    tier (host clock, ids on the host): p50 and quartiles in ms."""
    from geomesa_tpu_torch.utils.properties import SystemProperty
    out = {}
    for tier in tiers:
        h, thr = STORE_TIERS[tier]
        SystemProperty("geomesa.scan.host.rows").set(h)
        SystemProperty("geomesa.scan.index.threshold").set(thr)
        for qi, (ecql, _b, _iv) in enumerate(smoke.STORE_QUERIES):
            times = []
            for _ in range(STORE_RUNS):
                t0 = time.perf_counter()
                ds.query(ecql, "ais").ids
                times.append((time.perf_counter() - t0) * 1e3)
            q1, q2, q3 = statistics.quantiles(times, n=4)
            out[f"{tier}_{qi}"] = {"p50_ms": q2, "q1_ms": q1, "q3_ms": q3}
    return out


def store_case(smoke, seed: int, rows: int) -> dict:
    """The tree's store on chip_smoke.py's store phase, each query of it
    timed STORE_RUNS times per tier (host clock, ids on the host)."""
    _, ds, _ = smoke.phase_store(seed, rows, {"max_abs_err": 0})
    out = tier_p50s(smoke, ds, ("gathered", "dense"))
    # the dense north-star query in parts: the scan kernel with the
    # mask's copy to the host, the f64 boundary patch, and a cProfile
    # of the whole query (top functions by own time)
    from geomesa_tpu_torch.scan import zscan
    st = ds._types["ais"]
    ecql, boxes, iv = smoke.STORE_QUERIES[0]
    sq = zscan.make_query(boxes, [(iv[0] + 1, iv[1] - 1)])

    def device():
        return zscan.scan_mask(st.scan_data, sq)[:st.n].cpu().numpy()

    def patch(mask):
        cand = zscan.boundary_candidates(st.host_xhi, st.host_yhi, sq)
        col = st.batch.col("geom")
        return zscan.exact_patch(mask, cand, col.x, col.y,
                                 st.batch.col("dtg").millis, sq)
    mask = device()
    parts = {"device_ms": [], "patch_ms": []}
    for _ in range(STORE_RUNS):
        t0 = time.perf_counter()
        mask = device()
        t1 = time.perf_counter()
        patch(mask)
        t2 = time.perf_counter()
        parts["device_ms"].append((t1 - t0) * 1e3)
        parts["patch_ms"].append((t2 - t1) * 1e3)
    out["dense_0_parts"] = {k: statistics.median(v) for k, v in parts.items()}
    out["dense_0_profile"] = smoke.profile_top(
        lambda: [ds.query(ecql, "ais").ids for _ in range(5)], top=10)
    return out


SERVING_RUNS = 3


def serving_case(smoke, seed: int, rows: int) -> dict:
    """The tree's store and batched serving at its defaults (see
    ``--serving-only`` in the module's head)."""
    import hashlib
    import threading
    from geomesa_tpu_torch import Query
    from geomesa_tpu_torch.scan.batcher import QueryBatcher
    _, ds, (x, y, ms, _ids) = smoke.phase_store(seed, rows,
                                                {"max_abs_err": 0})
    out = {"tiers": tier_p50s(smoke, ds, STORE_TIERS)}
    from geomesa_tpu_torch.utils.properties import SystemProperty
    SystemProperty("geomesa.scan.host.rows").set(None)
    SystemProperty("geomesa.scan.index.threshold").set(None)
    specs = smoke.store_batch_specs(seed)
    ecqls = [smoke._ecql(boxes, iv) for boxes, iv in specs]
    truth = [smoke._brute(x, y, ms, boxes, iv) for boxes, iv in specs]
    digest = hashlib.sha256()
    for e, want in zip(ecqls, truth):
        got = ds.query(e, "ais").rows
        if not np.array_equal(got, want):
            raise SystemExit(f"query() wrong for {e!r}")
        digest.update(np.asarray(got, dtype=np.int64).tobytes())
    out["ids_sha256"] = digest.hexdigest()
    sizes = {}
    for size in (2, 8, 32):
        chunks = [[Query("ais", e) for e in ecqls[i:i + size]]
                  for i in range(0, len(ecqls), size)]
        batched, seq = [], []
        for _ in range(SERVING_RUNS):
            for qs in chunks:
                t0 = time.perf_counter()
                [r.ids for r in ds.query_batched(qs)]
                batched.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                [ds.query(q).ids for q in qs]
                seq.append((time.perf_counter() - t0) * 1e3)
        sizes[size] = {"batched_p50_ms": statistics.median(batched),
                       "sequential_p50_ms": statistics.median(seq)}
    out["query_batched"] = sizes
    loads = []
    for _ in range(SERVING_RUNS):
        batcher = QueryBatcher(ds)
        lat, errors = [], []

        def caller(t):
            for j in range(smoke.BATCHER_PER_THREAD):
                i = (t * smoke.BATCHER_PER_THREAD + j) % len(ecqls)
                t0 = time.perf_counter()
                r = batcher.query(ecqls[i], "ais")
                r.ids
                lat.append((time.perf_counter() - t0) * 1e3)
                if not np.array_equal(r.rows, truth[i]):
                    errors.append(i)
        threads = [threading.Thread(target=caller, args=(t,))
                   for t in range(smoke.BATCHER_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(600.0)
        wall = time.perf_counter() - t0
        if errors or len(lat) != smoke.BATCHER_THREADS * \
                smoke.BATCHER_PER_THREAD:
            raise SystemExit(f"QueryBatcher: {len(lat)} answers, wrong "
                             f"{errors[:5]}")
        loads.append({"queries_per_s": len(lat) / wall,
                      "p50_ms": statistics.median(lat),
                      "coalesce_ratio": batcher.stats()["coalesce_ratio"]})
    out["batcher"] = loads
    return out


def _tree_smoke(tree: str):
    """The tree's own chip_smoke.py, for its launchers and polygons."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def joins_case(tree: str, seed: int, store_rows: int) -> dict:
    """The dwithin and contains kernels at chip_smoke.py's analytics
    shapes, through the tree's own wrappers and launchers, each checked
    against the tree's plain version."""
    import torch
    from geomesa_tpu_torch.analytics import join
    from geomesa_tpu_torch.geometry import parse_wkt
    from geomesa_tpu_torch.scan import kernels
    from geomesa_tpu_torch.scan.gscan import EDGE_EPS, EDGE_EPS2
    from geomesa_tpu_torch.utils.fp import f32_band
    dev = torch.device("cuda")
    smoke = _tree_smoke(tree)
    presort = hasattr(kernels, "sorted_by_x")

    def columns(x, y, cap):
        px = torch.zeros(cap, dtype=torch.float32, device=dev)
        py = torch.zeros(cap, dtype=torch.float32, device=dev)
        px[:len(x)] = torch.from_numpy(x.astype(np.float32)).to(dev)
        py[:len(y)] = torch.from_numpy(y.astype(np.float32)).to(dev)
        return px, py

    out = {}
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-180, 180, store_rows)
    y = rng.uniform(-90, 90, store_rows)
    px, py = columns(x, y, 1 << (store_rows - 1).bit_length())
    n = store_rows
    out["xsort_10m_ms"] = cuda_ms(lambda: join._sorted_by_x(px, py, n), True,
                                  iters=5)
    xsorted = join._sorted_by_x(px, py, n)[:2] if presort else None
    rq = np.random.default_rng(seed + 11)
    rw = np.random.default_rng(seed + 14)
    for name, k, radius, qrng in (("dwithin_10m", 1_000, 0.25, rq),
                                  ("dwithin_wide_10m", 64, 30.0, rw)):
        qx = torch.from_numpy(qrng.uniform(-170, 170, k)
                              .astype(np.float32)).to(dev)
        qy = torch.from_numpy(qrng.uniform(-80, 80, k)
                              .astype(np.float32)).to(dev)
        hi, lo = (float(np.float32(v)) for v in f32_band(radius, 360.0))
        args = (px, py, qx, qy, hi, lo, n) + ((xsorted,) if presort else ())
        got = kernels.dwithin_counts(*args)
        want = kernels.dwithin_counts_plain(*args[:7])
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{tree}: {name}: dwithin_counts != plain")

        def wrapper(args=args):
            kernels.dwithin_counts(*args)
        launcher = getattr(smoke, "_dwithin_launcher", None)
        alone = launcher(args)[0] if launcher is not None else wrapper
        out[name] = {"queries": k, "radius": radius,
                     "pairs": int(want[0].sum() + want[1].sum()),
                     "kernel_ms": cuda_ms(alone, True),
                     "wrapper_ms": cuda_ms(wrapper, True),
                     "wrapper_bare_ms": cuda_ms(wrapper, False)}
    # the slab kernels in radius mode at the DWithin pairs call's shape,
    # and the knn kernel at the batcher's largest (32 of its points)
    rq = np.random.default_rng(seed + 11)
    qx64 = rq.uniform(-170, 170, 1_000)
    qy64 = rq.uniform(-80, 80, 1_000)
    r2_hi = float(np.float32(f32_band(0.25, 360.0)[0]))
    slabs = join._slab_setup(join._sorted_by_x(px, py, n), qx64, 0.25, r2_hi)
    qa = torch.from_numpy(np.stack([qx64, qy64], 1).astype(np.float32))
    out["slab_10m"] = slab_case(smoke, kernels, (
        slabs.xs, slabs.ys, slabs.order, slabs.los, slabs.widths,
        qa.to(dev), r2_hi, 0.0, False))
    del slabs
    bx = torch.from_numpy(rq.uniform(-170, 170, 256)[:32].astype(np.float32))
    by = torch.from_numpy(rq.uniform(-80, 80, 256)[:32].astype(np.float32))
    out["knn_10m_32q"] = knn_case(kernels, (px, py, bx.to(dev), by.to(dev),
                                            256, n))
    del px, py, xsorted
    torch.cuda.empty_cache()

    rc = np.random.default_rng(seed + 13)
    cx = rc.uniform(-180, 180, smoke.CT_ROWS)
    cy = rc.uniform(-90, 90, smoke.CT_ROWS)
    px, py = columns(cx, cy, smoke.CT_CAP)
    n = smoke.CT_ROWS
    del cx, cy
    polys = [parse_wkt(w) for w in smoke.contains_polygons(seed)[0]]
    out["xsort_100m_ms"] = cuda_ms(lambda: join._sorted_by_x(px, py, n),
                                   True, iters=5)
    xs, ys, order = join._sorted_by_x(px, py, n)
    b64 = np.array([p.envelope.as_tuple() for p in polys], np.float64)
    _, _, los, widths = join._contains_slab_setup(xs, b64)
    kp = join._poly_pad(len(polys))
    edges, evalid, boxes = join.pack_polygon_batch(polys, pad_to=kp)
    lp, wp = np.zeros(kp, np.int32), np.zeros(kp, np.int32)
    lp[:len(polys)], wp[:len(polys)] = los, widths
    args = (xs, ys, order, torch.from_numpy(lp).to(dev),
            torch.from_numpy(wp).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(edges).to(dev),
            torch.from_numpy(evalid.sum(axis=1).astype(np.int32)).to(dev),
            float(np.float32(EDGE_EPS)), EDGE_EPS2, 256)
    got = kernels.contains_counts(*args)
    want = kernels.contains_counts_plain(*args)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"{tree}: contains_counts != plain")
    counts = smoke._contains_launcher(args)
    items, rows_run = smoke._contains_rows_launcher(args)
    out["contains_100m"] = {
        "polygons": len(polys), "slab_columns": int(wp.sum()),
        "band_rows": int(want[1].sum()), "rows_items": items,
        "counts_ms": cuda_ms(counts[0] if isinstance(counts, tuple)
                             else counts, True),
        "rows_ms": cuda_ms(rows_run, True),
        "wrapper_bare_ms": cuda_ms(lambda: kernels.contains_counts(*args),
                                   False, iters=5)}
    # the slab kernels in box mode at the Contains pairs call's shape
    # (chip_smoke.py's 100 polygons: 84 sampled rectangles, 16 stars)
    sample = np.sort(np.r_[rc.choice(smoke.CT_RECTS,
                                     smoke.CT_SAMPLE - smoke.CT_STARS,
                                     replace=False),
                           smoke.CT_RECTS + np.arange(smoke.CT_STARS)])
    sel = np.r_[sample[:smoke.CT_PAIRS - 16], smoke.CT_RECTS + np.arange(16)]
    _, _, los, widths = join._contains_slab_setup(xs, b64[sel])
    out["slab_box_100m"] = slab_case(smoke, kernels, (
        xs, ys, order, torch.from_numpy(los).to(dev),
        torch.from_numpy(widths).to(dev),
        torch.from_numpy(b64[sel].astype(np.float32)).to(dev), 0.0,
        float(np.float32(EDGE_EPS)), True))
    del px, py, xs, ys, order, args, counts, rows_run
    torch.cuda.empty_cache()
    # the knn kernel at BASELINE #4: 50M points in a 2^26-row buffer,
    # bench.py's 8 points, k = 100 (kpad 256)
    rk = np.random.default_rng(seed + 12)
    px, py = columns(rk.uniform(-180, 180, smoke.KNN_ROWS),
                     rk.uniform(-90, 90, smoke.KNN_ROWS), smoke.KNN_CAP)
    kq = torch.tensor(smoke.KNN_POINTS, dtype=torch.float32)
    out["knn_50m_8q"] = knn_case(kernels, (
        px, py, kq[:, 0].contiguous().to(dev), kq[:, 1].contiguous().to(dev),
        256, smoke.KNN_ROWS))
    return out


def slab_case(smoke, kernels, args) -> dict:
    """The slab kernels' two passes alone (the tree's chip_smoke.py
    launcher: buffers prepared once) and the slab_pairs wrapper, held
    and bare, after its result is checked against the tree's plain
    version."""
    got = kernels.slab_pairs(*args)
    want = kernels.slab_pairs_plain(*args)
    if not all(torch_equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("slab_pairs != plain")
    run = smoke._slab_launcher(args)
    run = run[0] if isinstance(run, tuple) else run

    def wrapper():
        kernels.slab_pairs(*args)
    return {"queries": int(args[3].shape[0]),
            "slab_columns": int(args[4].sum()), "pairs": int(want[0].shape[0]),
            "mode": "box" if args[-1] else "radius",
            "kernel_ms": cuda_ms(run, True),
            "wrapper_ms": cuda_ms(wrapper, True),
            "wrapper_bare_ms": cuda_ms(wrapper, False)}


def knn_case(kernels, args) -> dict:
    """The knn wrapper (its launches are the whole call) held and bare,
    with its launches a call, after its result is checked against the
    tree's plain version (d2 by its bits, every NaN equal)."""
    import torch
    before = kernels.launches["knn_topk"]
    got = kernels.knn_topk(*args)
    calls = kernels.launches["knn_topk"] - before
    want = kernels.knn_topk_plain(*args)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = (t.masked_fill(t.isnan(), float("nan")).view(torch.int32)
                    for t in (g, w))
        if not torch.equal(g, w):
            raise SystemExit("knn_topk != plain")
    del want

    def run():
        kernels.knn_topk(*args)
    return {"rows": args[5], "queries": int(args[2].shape[0]),
            "kpad": args[4], "launches": calls, "ms": cuda_ms(run, True),
            "bare_ms": cuda_ms(run, False)}


YEAR_PAIRS = 8760        # hourly bins of a year-long track
# launches ahead of a tube's long-spin timing and of the probes' timings
TUBE_WARMUP = 30
# the spin ahead of a tube's long-spin timing: past the wrapper's host
# work (its pair sort and two launches), where HOLD_CYCLES may not be
TUBE_HOLD = 4 * HOLD_CYCLES


def year_tube(smoke, seed: int):
    """The third tube: a vessel's year-long AIS-like track
    (chip_smoke.ais_track, 12 knots) binned by the hour, 8,760 pairs from
    day 300 of the rows' 1,000 days (36.5 % of their times), its
    positions wrapped into the world, boxes 0.1-0.5 degrees wide."""
    rng = np.random.default_rng(seed + 21)
    t0 = 300 * MS_DAY
    hour = smoke.HOUR_MS
    cx, cy, _ = smoke.ais_track(rng, YEAR_PAIRS, t0, hour, -60.0, 20.0)
    cx = (cx + 180.0) % 360.0 - 180.0
    cy = (cy + 90.0) % 360.0
    cy = np.where(cy > 180.0, 360.0 - cy, cy) - 90.0
    w = rng.uniform(0.1, 0.5, (YEAR_PAIRS, 2))
    boxes = np.stack([cx - w[:, 0] / 2, cy - w[:, 1] / 2, cx + w[:, 0] / 2,
                      cy + w[:, 1] / 2], axis=1)
    lo = t0 + np.arange(YEAR_PAIRS, dtype=np.int64) * hour
    return "year", boxes, np.stack([lo, lo + hour - 1], 1)


def tube_alone(kernels, cols, n: int, bx, tm):
    """The tree's tube kernel alone: its pair tables built once, then a
    launch of the library's entry as the tree's wrapper makes it (the
    lo keys' argsort and the records' room where the tree has
    ``_tube_order``, its records made by the entry's first launch; else
    the four sorted tables the earlier entry takes)."""
    import torch
    out = torch.empty(n, dtype=torch.bool, device=bx.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [c.data_ptr() for c in cols]
    k = bx.shape[0]
    lib = kernels._library()
    if hasattr(kernels, "_tube_order"):
        order = kernels._tube_order(tm)
        rec = (order, torch.empty((k, 8), dtype=torch.int64, device=bx.device))
        # the bucket bits, where the entry takes them (15 arguments)
        bits = ((kernels.tube_bucket_bits(k),)
                if len(lib.geomesa_tube_mask.argtypes) == 15 else ())
        args = (*ptrs, n, tm.data_ptr(), bx.data_ptr(), order.data_ptr(),
                rec[1].data_ptr(), k, *bits, out.data_ptr(), stream)
    else:
        lo, pm, hi, sb = kernels.tube_pairs(bx, tm)
        rec = (lo, pm, hi, sb)
        args = (*ptrs, n, lo.data_ptr(), pm.data_ptr(), hi.data_ptr(),
                sb.data_ptr(), bx.shape[0], out.data_ptr(), stream)

    def run():
        rc = lib.geomesa_tube_mask(*args)
        if rc:
            raise RuntimeError(f"tube launch failed: cudaError {rc}")
    run.keep = rec     # the tables live as long as the launch
    return run, out


def tube_case(kernels, zscan, seed: int, rows: int, probe,
              plain_check: bool) -> dict:
    """The tree's tube kernel on chip_smoke.py's kernels-phase rows
    against this checkout's chip_smoke.py tubes and the year-long one,
    beside the linear probe (sparse and dense) and the streaming probe;
    the sparse and dense masks checked against the tree's plain version,
    the year-long one where ``plain_check`` (once a call: it takes tens
    of seconds), every mask's sha256 printed for the trees to agree."""
    import hashlib
    import torch
    from geomesa_tpu_torch.analytics.tube import tube_tables
    dev = torch.device("cuda")
    smoke = _smoke()
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    data = zscan.build_scan_data(x, y, ms, dev, cap=zscan.next_pow2(rows))
    del x, y, ms
    n = data.n
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    res = torch.empty(n, dtype=torch.bool, device=dev)
    keys = (data.cols[4][:n].long() * (1 << 32) + data.cols[5][:n].long()
            + (1 << 31))
    # a tube before every row's time: the time pass alone
    outside = ("outside", np.array([[-10.0, -10.0, 10.0, 10.0]]),
               np.array([[-10 * MS_DAY, -9 * MS_DAY]]))
    for label, boxes, iv in [*smoke.tube_cases(seed), year_tube(smoke, seed),
                             outside]:
        bx, tm = (torch.from_numpy(a).to(dev) for a in tube_tables(boxes, iv))
        k = bx.shape[0]
        t = tm.cpu().numpy().astype(np.int64)
        t_min = int((t[:, 0] * (1 << 32) + t[:, 1] + (1 << 31)).min())
        t_max = int((t[:, 2] * (1 << 32) + t[:, 3] + (1 << 31)).max())

        def kern():
            return kernels.tube_mask(data.cols, n, bx, tm)

        def linear():
            rc = probe.probe_tube_linear(
                *(c.data_ptr() for c in data.cols), n, tm.data_ptr(),
                bx.data_ptr(), k, t_min, t_max, res.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"probe launch failed: cudaError {rc}")

        def streaming(cap):
            def run():
                rc = probe.probe_tube_stream(
                    data.cols[4].data_ptr(), data.cols[5].data_ptr(), n, t_min,
                    t_max, res.data_ptr(), cap, stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            return run
        got = kern()
        case = {"pairs": k, "hits": int(got.sum().item()),
                "mask_sha256": hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest()}
        if label != "year" or plain_check:
            want = kernels.tube_mask_plain(data.cols, n, bx, tm)
            if not torch.equal(got, want):
                raise SystemExit(f"{label} tube: tube_mask != plain")
            case["equal_plain"] = True
        alone, alone_out = tube_alone(kernels, data.cols, n, bx, tm)
        alone()
        if not torch.equal(alone_out, got):
            raise SystemExit(f"{label} tube: the kernel alone != tube_mask")
        if hasattr(kernels, "tube_bucket_bits"):
            case["plan"] = {"bucket_bits": kernels.tube_bucket_bits(k),
                            "staged": min(k, kernels.TUBE_STAGE)}
        held, pair_tests, sectors = smoke.tube_needs(data.cols, n, tm)
        nbytes = 9 * n + 16 * held + k * 48
        case.update({
            "rows_in_interval": held, "pair_tests_needed": pair_tests,
            "bound_ms": smoke.bound_ms(nbytes, 7 * n + 13 * pair_tests)[0],
            "sector_floor_ms": (9 * n + 4 * smoke.SECTOR_BYTES * sectors
                                + k * 48) / smoke.HBM_BYTES_PER_S * 1e3,
            "tube_mask": {"held": cuda_ms(kern, True),
                          "held_long_spin": cuda_ms(kern, True,
                                                    warmup=TUBE_WARMUP,
                                                    hold=TUBE_HOLD),
                          "bare": cuda_ms(kern, False),
                          "alone": cuda_ms(alone, True, warmup=TUBE_WARMUP,
                                           hold=TUBE_HOLD)}})
        streaming(0)()
        if not torch.equal(res, (keys >= t_min) & (keys <= t_max)):
            raise SystemExit(f"{label} tube: the streaming probe is wrong")
        case["stream_probe"] = {f"{c}_per_sm" if c else "occupancy":
                                cuda_ms(streaming(c), True,
                                        warmup=TUBE_WARMUP)
                                for c in (0, 2, 1)}
        if label in ("sparse", "dense"):   # 8,760 pairs take seconds
            linear()
            if not torch.equal(res, want):
                raise SystemExit(f"{label} tube: the linear probe != plain")
            case["linear_probe"] = {"held": cuda_ms(linear, True)}
        out[f"tube_{label}_100m"] = case
    return out


def standing_case(smoke, seed: int) -> dict:
    """config 15's bulk dispatch at 100k filters through the tree's
    StandingFilterSet.dispatch, twice; the hits' sha256."""
    import hashlib
    import torch
    from geomesa_tpu_torch.features.sft import parse_spec
    from geomesa_tpu_torch.filters import parse_ecql
    from geomesa_tpu_torch.scan.standing import StandingFilterSet
    rng = np.random.default_rng(seed + 15)
    nf = smoke.GEOFENCE_FILTERS_BIG
    sft = parse_spec("g15", smoke.GEOFENCE_SPEC)
    fset = StandingFilterSet(sft)
    t0 = time.perf_counter()
    for i in range(nf):
        fset.register(f"q{i}", parse_ecql(smoke.geofence_ecql(rng, i)))
    register_s = time.perf_counter() - t0
    batch = smoke.geofence_batch(np.random.default_rng(seed + 16), sft,
                                 smoke.GEOFENCE_BULK, "bulk")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = fset.dispatch(batch)
        torch.cuda.synchronize()
        runs.append({"dispatch_s": time.perf_counter() - t0,
                     **fset.last_split})
    h = hashlib.sha256()
    for i in range(nf):
        h.update(np.ascontiguousarray(hits[f"q{i}"], dtype=np.int64)
                 .tobytes())
        h.update(b"|")
    return {"filters": nf, "rows": batch.n, "register_s": register_s,
            "padded_cap": fset.stats()["padded_cap"],
            "hits": int(sum(len(v) for v in hits.values())),
            "match_s": [r["match_s"] for r in runs], "runs": runs,
            "mask_sha256": h.hexdigest()}


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a, b)


def worker(tree: str, seed: int, rows: int, store_rows: int,
           predicates_only: bool = False, density_only: bool = False,
           store_only: bool = False, prefix_only: bool = False,
           joins_only: bool = False, tube_only: bool = False,
           plain_check: bool = False, standing_only: bool = False,
           serving_only: bool = False) -> dict:
    sys.path.insert(0, tree)
    import torch
    from geomesa_tpu_torch.index.zkeys import ZKeyIndex, search_rows
    from geomesa_tpu_torch.scan import kernels, zscan
    if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {kernels.__file__}, not from {tree}")
    dev = torch.device("cuda")
    kernels.build_library()
    if standing_only:
        return {"tree": tree, "standing_1m_100k": standing_case(_smoke(),
                                                                seed)}
    if predicates_only:
        return {"tree": tree, "predicates_10m": predicate_case(
            _smoke(), seed, store_rows)}
    if store_only:
        return {"tree": tree, "store_10m": store_case(_smoke(), seed,
                                                      store_rows)}
    if serving_only:
        return {"tree": tree, "serving_10m": serving_case(_smoke(), seed,
                                                          store_rows)}
    if joins_only:
        return {"tree": tree, **joins_case(tree, seed, store_rows)}
    has_density = hasattr(kernels, "density_grid")
    probe = build_probe()
    if density_only:
        return {"tree": tree, "density_10m": density_case(
            _smoke(), seed, store_rows, probe) if has_density else None}
    if tube_only:
        return {"tree": tree, **tube_case(kernels, zscan, seed, rows, probe,
                                          plain_check)}
    if prefix_only:
        return {"tree": tree, **prefix_only_case(
            kernels, zscan, _smoke(), seed, rows, store_rows, probe)}
    buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def flush():
        buf.fill_(1)

    def gather_case(data, idx32):
        """The tree's gathered kernel (and the probe, where the tree has
        the row table) on these ids, checked against its plain version."""
        table = getattr(data, "rows", None)
        if table is not None:   # row table, int32 ids
            args = (table, idx32)
        else:                   # six columns, int64 ids
            args = (data.cols, idx32.long())

        def kern():
            return kernels.scan_mask_gather(*args, b, t, q.time_any)
        want = kernels.scan_mask_gather_plain(*args, b, t, q.time_any)
        if not torch.equal(kern(), want):
            raise SystemExit(f"{tree}: gathered kernel != plain")
        out = {"m": int(idx32.shape[0]), "kernel": three_ways(kern, flush)}
        if table is not None:
            res = torch.empty(idx32.shape[0], dtype=torch.uint8, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def read():
                rc = probe.probe_read_rows(table.data_ptr(), idx32.data_ptr(),
                                           idx32.shape[0], res.data_ptr(),
                                           stream)
                if rc:
                    raise RuntimeError(f"probe launch failed: cudaError {rc}")
            out["read_only"] = three_ways(read, flush)
        return out

    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, rows)
    y = rng.uniform(-90, 90, rows)
    ms = rng.integers(0, 1000 * MS_DAY, rows)
    data = zscan.build_scan_data(x, y, ms, dev, cap=zscan.next_pow2(rows))
    del x, y, ms
    n = data.n
    q = zscan.make_query(*QUERY)
    b, t = q.tables(dev)
    res = {"tree": tree, "rows": n, "cap": data.cap}
    res["scan_mask"] = {
        k: cuda_ms(lambda: kernels.scan_mask(data.cols, n, b, t, False), h)
        for k, h in (("held", True), ("bare", False))}
    res["scan_count"] = {
        k: cuda_ms(lambda: kernels.scan_count(data.cols, n, b, t, False), h)
        for k, h in (("held", True), ("bare", False))}
    idx = torch.randint(0, n, (GATHERED_IDS,), device=dev, dtype=torch.int32,
                        generator=torch.Generator(dev).manual_seed(seed))
    res["gather_1m"] = gather_case(data, idx)
    smoke = _smoke()
    batched = hasattr(kernels, "scan_batch_bits")
    if batched:
        res["batched_100m"] = batched_case(kernels, data, zscan.stack_queries(
            [zscan.make_query(*q) for q in smoke.kernel_batch_specs(seed)]),
            tree, probe)
    del data, idx
    torch.cuda.empty_cache()

    # the main path's shape: the north-star query's candidates, as the
    # gathered tier gets them (host cap 0, block cap n), in z-order
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(-180, 180, store_rows)
    y = rng.uniform(-90, 90, store_rows)
    ms = rng.integers(T0_DAY * MS_DAY, T1_DAY * MS_DAY, store_rows)
    data = zscan.build_scan_data(x, y, ms, dev,
                                 cap=zscan.next_pow2(store_rows))
    kind, cand = search_rows(ZKeyIndex(x, y, ms), "z3", NORTH_BOXES,
                             NORTH_IV, 0, store_rows)
    if kind != "candidates":
        raise SystemExit(f"the z-index gave {kind!r}, not candidates")
    q = zscan.make_query(NORTH_BOXES, NORTH_IV)
    b, t = q.tables(dev)
    idx = torch.from_numpy(np.ascontiguousarray(cand, dtype=np.int32)).to(dev)
    res["gather_main_path"] = gather_case(data, idx)
    if batched:
        res["batched_10m"] = batched_case(
            kernels, data, smoke.store_batch(smoke.store_batch_specs(seed)),
            tree, probe)
    del data, idx
    torch.cuda.empty_cache()
    if os.path.exists(os.path.join(tree, "geomesa_tpu_torch", "scan",
                                   "residual.py")):
        res["predicates_10m"] = predicate_case(smoke, seed, store_rows)
    if has_density:
        res["density_10m"] = density_case(smoke, seed, store_rows, probe)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--store-rows", type=int, default=10_000_000)
    ap.add_argument("--predicates-only", action="store_true",
                    help="time only the predicate kernels (predicates_10m)")
    ap.add_argument("--density-only", action="store_true",
                    help="time only the density kernel (density_10m)")
    ap.add_argument("--store-only", action="store_true",
                    help="time only the store's queries (store_10m)")
    ap.add_argument("--prefix-only", action="store_true",
                    help="time only the prefix kernel (prefix_100m, "
                         "prefix_10m)")
    ap.add_argument("--joins-only", action="store_true",
                    help="time only the join kernels (dwithin_10m, "
                         "dwithin_wide_10m, slab_10m, knn_10m_32q, "
                         "contains_100m, slab_box_100m, knn_50m_8q)")
    ap.add_argument("--tube-only", action="store_true",
                    help="time only the tube kernel and its probes "
                         "(tube_sparse_100m, tube_dense_100m, "
                         "tube_year_100m)")
    ap.add_argument("--standing-only", action="store_true",
                    help="time only config 15's bulk dispatch through "
                         "StandingFilterSet.dispatch (standing_1m_100k)")
    ap.add_argument("--serving-only", action="store_true",
                    help="time only the store's and the batched serving "
                         "p50s at the tree's defaults (serving_10m)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--plain-check", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.seed, args.rows,
                                args.store_rows, args.predicates_only,
                                args.density_only, args.store_only,
                                args.prefix_only, args.joins_only,
                                args.tube_only, args.plain_check,
                                args.standing_only, args.serving_only)),
              flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one tree")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    hashes = {}
    for i, tree in enumerate(args.trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(tree), "--seed", str(args.seed), "--rows",
             str(args.rows), "--store-rows", str(args.store_rows),
             *(["--predicates-only"] if args.predicates_only else []),
             *(["--density-only"] if args.density_only else []),
             *(["--store-only"] if args.store_only else []),
             *(["--prefix-only"] if args.prefix_only else []),
             *(["--joins-only"] if args.joins_only else []),
             *(["--tube-only"] if args.tube_only else []),
             *(["--standing-only"] if args.standing_only else []),
             *(["--serving-only"] if args.serving_only else []),
             *(["--plain-check"] if args.tube_only and i == 0 else [])],
            capture_output=True, text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["card"] = card
        print(json.dumps(line), flush=True)
        serving = line.get("serving_10m")
        if serving is not None and hashes.setdefault(
                "serving_10m", serving["ids_sha256"]) != serving["ids_sha256"]:
            raise SystemExit(f"{tree}: serving_10m's ids differ from the "
                             f"first tree's")
        for key, case in line.items():
            if isinstance(case, dict) and "mask_sha256" in case:
                if hashes.setdefault(key, case["mask_sha256"]) != \
                        case["mask_sha256"]:
                    raise SystemExit(f"{tree}: {key}'s mask differs from "
                                     f"the first tree's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
