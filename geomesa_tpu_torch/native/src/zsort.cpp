// Sorted-order construction for the z-key indexes.
//
// A host copy of geomesa_tpu/native/src/zsort.cpp (the native sort and
// gather of geomesa_tpu/index/zkeys.py:70-145, :596-635); here no
// environment variable sets the thread count. Plain twins: index/zkeys.py
// sort_bin_z_plain, sort_z_plain and gather_xyz_plain (np.lexsort,
// stable argsort, fancy indexing), held equal bit for bit by the tests.
//
// np.lexsort((z, bins)) at 100M rows costs two indirect O(N log N)
// argsorts; time bins are small non-negative ints, so a counting sort
// by bin (O(N), stable) followed by a per-segment sort of (z, idx)
// pairs does the same work with cache-friendly passes. Large segments
// are not std::sort'ed directly: one MSD pass buckets them by the top
// 16 bits of z (another stable counting scatter), leaving sub-runs
// that fit in cache for the final comparison sort — at 100M rows in a
// handful of time bins this is ~3x faster than per-segment std::sort.
// Tie order matches lexsort's stability throughout: pairs sort by
// (z, original index) and every scatter preserves input order.
//
// Work parallelizes over std::thread when the host has cores to spare
// (hardware_concurrency, at least 1M rows a thread; geomesa_host_threads
// says how many for n rows):
// chunked histogram+scatter with per-(thread, bin) cursors keeps the
// scatter stable, and segment sorts drain a shared atomic work queue.
// Every segment is sorted by one thread and every scatter is stable, so
// the result does not depend on the thread count or the scheduling.
//
// Exported (ctypes):
//   geomesa_sort_bin_z(bins i32[n], z i64[n], n, max_bin,
//                      perm_out i32[n], z_sorted_out i64[n],
//                      offsets_out i64[max_bin+2]) -> 0/-1
//     offsets_out[b] = start of bin b's segment (prefix sums), so the
//     caller derives per-bin boundaries without re-scanning the array
//   geomesa_sort_z(z i64[n], n, perm_out i32[n],
//                  z_sorted_out i64[n]) -> 0/-1
// Keys are z-order keys: non-negative (the radix passes read them as
// unsigned), which the caller checks.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Pair {
    int64_t z;
    int32_t idx;
};

inline bool pair_less(const Pair& a, const Pair& b) {
    return a.z != b.z ? a.z < b.z : a.idx < b.idx;
}

int nthreads(int64_t n) {
    if (n < (1 << 18)) return 1;  // not worth the thread spawn
    int t = (int)std::thread::hardware_concurrency();
    if (t < 1) t = 1;
    if (t > 64) t = 64;
    const int64_t per = (int64_t)1 << 20;  // >=1M rows per thread
    if ((int64_t)t > (n + per - 1) / per) t = (int)((n + per - 1) / per);
    return t < 1 ? 1 : t;
}

void run_parallel(int t, void (*fn)(void*, int), void* ctx) {
    if (t <= 1) {
        fn(ctx, 0);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(t - 1);
    for (int i = 1; i < t; ++i) pool.emplace_back(fn, ctx, i);
    fn(ctx, 0);
    for (auto& th : pool) th.join();
}

// Segments at or below this go straight to std::sort; larger ones use
// the LSD radix below (comparison sorts of millions of 12-byte pairs
// with a branchy comparator were ~2-4x slower than counting passes on
// single-core hosts).
constexpr int64_t KSMALL = 1 << 15;
// NBUCKETS is kept as the `hist` scratch contract with callers
constexpr int MAX_BUCKET_BITS = 16;
constexpr int64_t NBUCKETS = 1 << MAX_BUCKET_BITS;

// LSD digit width: 2^11 write streams keep the scatter's active cache
// lines (~128KB) inside L2; 16-bit digits halve the passes but thrash
// (64k streams x 64B lines = 4MB of hot write lines).
constexpr int RADIX_BITS = 11;
constexpr int64_t RADIX_B = (int64_t)1 << RADIX_BITS;
constexpr int RADIX_PASSES = (63 + RADIX_BITS - 1) / RADIX_BITS;

// Sort one contiguous segment of pairs by (z, idx): stable LSD radix.
// Input pairs arrive with idx ascending (the bin scatter is stable),
// and LSD stability preserves that on z ties — identical order to
// std::sort with pair_less. Constant digits (all rows share one
// bucket) skip their pass: z3 keys are 63 bits but a time-binned
// segment's top bits rarely span the full range. `scratch` must hold
// at least the segment; `hist` at least NBUCKETS+1 entries (only
// RADIX_PASSES * RADIX_B of it is used).
// segments above this get one MSD split (top RADIX_BITS) first so the
// work below runs over (near-)cache-resident sub-runs. Mid-size
// segments (z3's per-time-bin runs, a few M pairs) measure FASTER
// under direct LSD than under MSD + per-bucket sorts, so the split
// only engages for huge single segments (the z2 whole-table sort).
constexpr int64_t CACHE_PAIRS = 1 << 23;

void sort_segment(Pair* seg, int64_t len, Pair* scratch, int64_t* hist,
                  int depth = 0);

// One stable MSD pass on an 11-bit window (window lowers with depth so
// skewed data cannot recurse forever), then recurse into each bucket
// (whose LSD skips its now-constant upper digits).
void msd_split(Pair* seg, int64_t len, Pair* scratch, int64_t* hist,
               int depth) {
    const int shift = 63 - RADIX_BITS * (depth + 1);
    for (int64_t b = 0; b <= RADIX_B; ++b) hist[b] = 0;
    for (int64_t i = 0; i < len; ++i)
        ++hist[(((uint64_t)seg[i].z >> shift) & (RADIX_B - 1)) + 1];
    for (int64_t b = 1; b <= RADIX_B; ++b) hist[b] += hist[b - 1];
    std::vector<int64_t> bounds(hist, hist + RADIX_B + 1);
    {
        std::vector<int64_t> cursor(hist, hist + RADIX_B);
        for (int64_t i = 0; i < len; ++i)
            scratch[cursor[((uint64_t)seg[i].z >> shift)
                           & (RADIX_B - 1)]++] = seg[i];
    }
    for (int64_t b = 0; b < RADIX_B; ++b) {
        const int64_t s = bounds[b], e = bounds[b + 1];
        if (e - s > 1)
            sort_segment(scratch + s, e - s, seg + s, hist, depth + 1);
    }
    std::copy(scratch, scratch + len, seg);
}

void sort_segment(Pair* seg, int64_t len, Pair* scratch, int64_t* hist,
                  int depth) {
    if (len <= 1) return;
    if (len <= KSMALL) {
        std::sort(seg, seg + len, pair_less);
        return;
    }
    if (len > CACHE_PAIRS && 63 - RADIX_BITS * (depth + 1) >= 0) {
        msd_split(seg, len, scratch, hist, depth);
        return;
    }
    // one read pass builds every digit's histogram
    int64_t* h = hist;  // RADIX_PASSES x RADIX_B, zeroed below
    for (int64_t i = 0; i < RADIX_PASSES * RADIX_B; ++i) h[i] = 0;
    for (int64_t i = 0; i < len; ++i) {
        const uint64_t v = (uint64_t)seg[i].z;
        for (int p = 0; p < RADIX_PASSES; ++p)
            ++h[p * RADIX_B + ((v >> (p * RADIX_BITS)) & (RADIX_B - 1))];
    }
    Pair* src = seg;
    Pair* dst = scratch;
    for (int p = 0; p < RADIX_PASSES; ++p) {
        int64_t* hp = h + p * RADIX_B;
        // skip constant digits
        bool constant = false;
        for (int64_t b = 0; b < RADIX_B; ++b)
            if (hp[b] == len) { constant = true; break; }
        if (constant) continue;
        // exclusive prefix sums -> write cursors
        int64_t run = 0;
        for (int64_t b = 0; b < RADIX_B; ++b) {
            const int64_t cnt = hp[b];
            hp[b] = run;
            run += cnt;
        }
        const int shift = p * RADIX_BITS;
        for (int64_t i = 0; i < len; ++i)
            dst[hp[((uint64_t)src[i].z >> shift) & (RADIX_B - 1)]++] =
                src[i];
        std::swap(src, dst);
    }
    if (src != seg) std::copy(src, src + len, seg);
}

struct SortCtx {
    const int32_t* bins;
    const int64_t* z;
    int64_t n;
    int64_t nb;  // bin-count array length (max_bin + 2)
    int nt;
    Pair* pairs;
    int32_t* perm_out;
    int64_t* z_sorted_out;
    std::vector<std::vector<int64_t>> local_hist;  // per-thread bin counts
    std::vector<int64_t> chunk_lo, chunk_hi;
    // segment work queue (bin starts), drained atomically
    const int64_t* seg_offsets;
    int64_t nsegs;
    std::atomic<int64_t> next_seg{0};
};

void histogram_worker(void* p, int t) {
    auto* c = (SortCtx*)p;
    auto& h = c->local_hist[t];
    for (int64_t i = c->chunk_lo[t]; i < c->chunk_hi[t]; ++i) {
        const int32_t b = c->bins[i];
        if (b < 0 || b + 1 >= c->nb) {
            h[0] = -1;  // out-of-range flag, checked by caller
            return;
        }
        ++h[(size_t)b + 1];
    }
}

void scatter_worker(void* p, int t) {
    auto* c = (SortCtx*)p;
    auto& cursor = c->local_hist[t];  // repurposed: per-bin write pos
    for (int64_t i = c->chunk_lo[t]; i < c->chunk_hi[t]; ++i) {
        const int64_t pos = cursor[(size_t)c->bins[i]]++;
        c->pairs[pos].z = c->z[i];
        c->pairs[pos].idx = (int32_t)i;
    }
}

void segment_worker(void* p, int) {
    auto* c = (SortCtx*)p;
    std::vector<Pair> scratch;
    std::vector<int64_t> hist;
    for (;;) {
        const int64_t s = c->next_seg.fetch_add(1);
        if (s >= c->nsegs) break;
        const int64_t lo = c->seg_offsets[s], hi = c->seg_offsets[s + 1];
        const int64_t len = hi - lo;
        if (len <= 1) continue;
        if (len > KSMALL) {
            if ((int64_t)scratch.size() < len) scratch.resize(len);
            if (hist.empty()) hist.resize(NBUCKETS + 1);
        }
        sort_segment(c->pairs + lo, len, scratch.data(), hist.data());
    }
}

void emit_worker(void* p, int t) {
    auto* c = (SortCtx*)p;
    for (int64_t i = c->chunk_lo[t]; i < c->chunk_hi[t]; ++i) {
        c->z_sorted_out[i] = c->pairs[i].z;
        c->perm_out[i] = c->pairs[i].idx;
    }
}

}  // namespace

extern "C" int64_t geomesa_sort_bin_z(const int32_t* bins,
                                      const int64_t* z, int64_t n,
                                      int64_t max_bin, int32_t* perm_out,
                                      int64_t* z_sorted_out,
                                      int64_t* offsets_out) {
    if (n < 0 || max_bin < 0 || max_bin > (1 << 20)) return -1;
    const int64_t nb = max_bin + 2;
    const int t = nthreads(n);

    SortCtx c;
    c.bins = bins;
    c.z = z;
    c.n = n;
    c.nb = nb;
    c.nt = t;
    c.perm_out = perm_out;
    c.z_sorted_out = z_sorted_out;
    c.local_hist.assign(t, std::vector<int64_t>((size_t)nb, 0));
    c.chunk_lo.resize(t);
    c.chunk_hi.resize(t);
    const int64_t chunk = (n + t - 1) / t;
    for (int i = 0; i < t; ++i) {
        c.chunk_lo[i] = std::min<int64_t>(i * chunk, n);
        c.chunk_hi[i] = std::min<int64_t>((i + 1) * chunk, n);
    }

    run_parallel(t, histogram_worker, &c);
    for (int i = 0; i < t; ++i)
        if (c.local_hist[i][0] == -1) return -1;  // bin out of range

    // global prefix sums -> offsets_out; per-(thread, bin) cursors so
    // the parallel scatter lands rows of equal bins in chunk order
    // (== original order: stability preserved)
    for (int64_t b = 0; b < nb; ++b) offsets_out[b] = 0;
    for (int i = 0; i < t; ++i)
        for (int64_t b = 1; b < nb; ++b)
            offsets_out[b] += c.local_hist[i][(size_t)b];
    for (int64_t b = 1; b < nb; ++b) offsets_out[b] += offsets_out[b - 1];
    // cursor[t][b] = offsets[b] + sum of earlier threads' counts for b
    std::vector<int64_t> running(offsets_out, offsets_out + nb - 1);
    for (int i = 0; i < t; ++i) {
        auto& h = c.local_hist[i];
        for (int64_t b = 0; b + 1 < nb; ++b) {
            const int64_t cnt = h[(size_t)b + 1];
            h[(size_t)b] = running[(size_t)b];
            running[(size_t)b] += cnt;
        }
    }

    std::vector<Pair> pairs((size_t)n);
    c.pairs = pairs.data();
    run_parallel(t, scatter_worker, &c);

    c.seg_offsets = offsets_out;
    c.nsegs = nb - 1;
    run_parallel(t, segment_worker, &c);
    run_parallel(t, emit_worker, &c);
    return 0;
}

extern "C" int64_t geomesa_sort_z(const int64_t* z, int64_t n,
                                  int32_t* perm_out,
                                  int64_t* z_sorted_out) {
    if (n < 0) return -1;
    const int t = nthreads(n);
    std::vector<Pair> pairs((size_t)n);
    SortCtx c;
    c.z = z;
    c.n = n;
    c.nt = t;
    c.pairs = pairs.data();
    c.perm_out = perm_out;
    c.z_sorted_out = z_sorted_out;
    c.chunk_lo.resize(t);
    c.chunk_hi.resize(t);
    const int64_t chunk = (n + t - 1) / t;
    for (int i = 0; i < t; ++i) {
        c.chunk_lo[i] = std::min<int64_t>(i * chunk, n);
        c.chunk_hi[i] = std::min<int64_t>((i + 1) * chunk, n);
    }
    for (int64_t i = 0; i < n; ++i) {
        pairs[(size_t)i].z = z[i];
        pairs[(size_t)i].idx = (int32_t)i;
    }
    if (n <= KSMALL) {
        std::sort(pairs.data(), pairs.data() + n, pair_less);
    } else {
        // one MSD pass on the top RADIX_BITS splits the array into
        // segments that fit the cache; each segment then LSD-radixes
        // its remaining bits touching (near-)resident lines only. The
        // MSD scatter is stable, so segment order == input order and
        // ties stay lexsort-compatible. Sub-runs drain in parallel
        // when the host has cores.
        const int bits = RADIX_BITS;
        const int shift = 63 - bits;
        const int64_t nb = (int64_t)1 << bits;
        std::vector<int64_t> hist((size_t)nb + 1, 0);
        std::vector<Pair> scratch((size_t)n);
        for (int64_t i = 0; i < n; ++i)
            ++hist[((uint64_t)pairs[(size_t)i].z >> shift) + 1];
        for (int64_t b = 1; b <= nb; ++b) hist[b] += hist[b - 1];
        {
            std::vector<int64_t> cursor(hist.begin(), hist.end() - 1);
            for (int64_t i = 0; i < n; ++i)
                scratch[cursor[(uint64_t)pairs[(size_t)i].z >> shift]++] =
                    pairs[(size_t)i];
        }
        pairs.swap(scratch);
        c.pairs = pairs.data();
        c.seg_offsets = hist.data();
        c.nsegs = nb;
        run_parallel(t, segment_worker, &c);
    }
    c.pairs = pairs.data();
    run_parallel(t, emit_worker, &c);
    return 0;
}

// -- fused sorted-order payload gather -----------------------------------
//
// Building the sorted-order coordinate copies (x[perm], y[perm],
// ms[perm]) with numpy costs three separate single-threaded random
// gathers over the full columns; at 100M rows that is seconds of
// wall-clock on the FIRST query. One chunked multi-threaded pass reads
// perm once per row and writes all three outputs sequentially.
//   geomesa_gather_xyz(x f64[], y f64[], ms i64[] (may be null),
//                      perm i32[n], n, xo, yo, mo) -> 0
namespace {

struct GatherCtx {
    const double* x;
    const double* y;
    const int64_t* ms;
    const int32_t* perm;
    int64_t n;
    double* xo;
    double* yo;
    int64_t* mo;
    int nthreads;
};

void gather_worker(void* p, int tid) {
    GatherCtx& c = *(GatherCtx*)p;
    const int64_t chunk = (c.n + c.nthreads - 1) / c.nthreads;
    const int64_t lo = std::min<int64_t>((int64_t)tid * chunk, c.n);
    const int64_t hi = std::min<int64_t>(lo + chunk, c.n);
    if (c.ms != nullptr) {
        for (int64_t i = lo; i < hi; ++i) {
            const int32_t j = c.perm[i];
            c.xo[i] = c.x[j];
            c.yo[i] = c.y[j];
            c.mo[i] = c.ms[j];
        }
    } else {
        for (int64_t i = lo; i < hi; ++i) {
            const int32_t j = c.perm[i];
            c.xo[i] = c.x[j];
            c.yo[i] = c.y[j];
        }
    }
}

}  // namespace

extern "C" int64_t geomesa_gather_xyz(const double* x, const double* y,
                                      const int64_t* ms,
                                      const int32_t* perm, int64_t n,
                                      double* xo, double* yo,
                                      int64_t* mo) {
    if (n < 0) return -1;
    if (n == 0) return 0;
    GatherCtx c{x, y, ms, perm, n, xo, yo, mo, nthreads(n)};
    run_parallel(c.nthreads, gather_worker, &c);
    return 0;
}

// The threads the sorts and the gather use for n rows.
extern "C" int64_t geomesa_host_threads(int64_t n) {
    return n < 0 ? -1 : nthreads(n);
}
