// Fused index-build kernels: epoch-millis binning and binned z3
// encoding in ONE pass over the inputs.
//
// A host copy of geomesa_tpu/native/src/zbuild.cpp (the binned path of
// geomesa_tpu/curves/timebin.py:98-145 and the fused encode of
// geomesa_tpu/index/zkeys.py:165-216). The index build is bound by host
// passes: numpy's int64 division in to_binned() walks the column
// several times, then the z encode reads the coordinates again. These
// loops fuse clamp + bin split + normalize + interleave, so each input
// byte is read once and each output byte written once, with the
// semantics of curves/timebin.py to_binned (lenient) and curves/sfc.py
// Z3SFC.index(lenient=True) EXACTLY: their plain twins are
// timebin.to_binned_plain and index/zkeys.py encode_binned_z3_plain,
// held equal bit for bit by the tests. Built without -ffast-math.
//
// Only DAY and WEEK periods are handled natively (compile-time-constant
// divisors become multiply-shift); MONTH/YEAR calendar binning stays on
// the numpy datetime64 path.
//
// Exported (ctypes):
//   geomesa_binned(millis i64[n], n, period_code {0=day,1=week},
//                  bins_out i32[n], offs_out i64[n]) -> 0/-1
//   geomesa_encode_binned_z3(x f64[n], y f64[n], millis i64[n], n,
//                  period_code, t_max, bins_out i32[n], z_out i64[n])
//                  -> 0/-1

#include <cmath>
#include <cstdint>

namespace {

constexpr int64_t MS_DAY = 86'400'000;
constexpr int64_t MS_WEEK = 7 * MS_DAY;
constexpr int64_t MAX_BIN = 32767;  // Short.MaxValue bins (BinnedTime)

inline uint64_t split3(uint64_t v) {
    v &= 0x1FFFFFULL;
    v = (v | (v << 32)) & 0x1F00000000FFFFULL;
    v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
    v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
    v = (v | (v << 2)) & 0x1249249249249249ULL;
    return v;
}

inline uint64_t norm(double v, double lo, double hi, double normalizer,
                     uint64_t max_index) {
    if (std::isnan(v)) return 0;            // numpy cast chain -> bin 0
    if (v < lo) v = lo;                     // lenient clamp
    if (v > hi) v = hi;
    double f = std::floor((v - lo) * normalizer);
    int64_t i = (int64_t)f;
    if (i < 0) i = 0;
    return (uint64_t)i > max_index ? max_index : (uint64_t)i;
}

// Constant-divisor bin split (the compiler lowers the divisions to
// multiply-shift). Returns the clamped (bin, offset-in-bin) pair.
template <bool WEEK>
inline void bin_split(int64_t ms, int32_t* bin, int64_t* off) {
    constexpr int64_t period = WEEK ? MS_WEEK : MS_DAY;
    constexpr int64_t hi = (MAX_BIN + 1) * period - 1;  // lenient clamp
    if (ms < 0) ms = 0;
    if (ms > hi) ms = hi;
    const int64_t b = ms / period;
    *bin = (int32_t)b;
    const int64_t rem = ms - b * period;
    *off = WEEK ? rem / 1000 : rem;
}

template <bool WEEK>
void binned_loop(const int64_t* millis, int64_t n, int32_t* bins_out,
                 int64_t* offs_out) {
    for (int64_t i = 0; i < n; ++i)
        bin_split<WEEK>(millis[i], &bins_out[i], &offs_out[i]);
}

template <bool WEEK>
void encode_loop(const double* x, const double* y, const int64_t* millis,
                 int64_t n, double t_max, int32_t* bins_out,
                 int64_t* z_out) {
    const double bins = 2097152.0;  // 2^21
    const double nx = bins / 360.0;
    const double ny = bins / 180.0;
    const double nt = bins / t_max;
    const uint64_t mi = (1ULL << 21) - 1;
    for (int64_t i = 0; i < n; ++i) {
        int32_t b;
        int64_t off;
        bin_split<WEEK>(millis[i], &b, &off);
        bins_out[i] = b;
        const uint64_t xi = norm(x[i], -180.0, 180.0, nx, mi);
        const uint64_t yi = norm(y[i], -90.0, 90.0, ny, mi);
        const uint64_t ti = norm((double)off, 0.0, t_max, nt, mi);
        z_out[i] = (int64_t)(split3(xi) | (split3(yi) << 1)
                             | (split3(ti) << 2));
    }
}

}  // namespace

extern "C" int64_t geomesa_binned(const int64_t* millis, int64_t n,
                                  int32_t period_code, int32_t* bins_out,
                                  int64_t* offs_out) {
    if (n < 0) return -1;
    if (period_code == 0)
        binned_loop<false>(millis, n, bins_out, offs_out);
    else if (period_code == 1)
        binned_loop<true>(millis, n, bins_out, offs_out);
    else
        return -1;
    return 0;
}

extern "C" int64_t geomesa_encode_binned_z3(
    const double* x, const double* y, const int64_t* millis, int64_t n,
    int32_t period_code, double t_max, int32_t* bins_out,
    int64_t* z_out) {
    if (n < 0 || !(t_max > 0.0)) return -1;
    if (period_code == 0)
        encode_loop<false>(x, y, millis, n, t_max, bins_out, z_out);
    else if (period_code == 1)
        encode_loop<true>(x, y, millis, n, t_max, bins_out, z_out);
    else
        return -1;
    return 0;
}

// Calendar-binned variant (MONTH/YEAR): bin boundaries are irregular,
// so the caller passes the precomputed bin-edge epoch millis (edges
// has nbins+1 entries, edges[b] = first instant of bin b) and the
// offset divisor (1000 for month-seconds, 60000 for year-minutes).
// Rows clamp leniently into [edges[0], edges[nbins]-1] and binary
// search their bin — fused with the z3 encode in the same pass.
extern "C" int64_t geomesa_encode_binned_z3_edges(
    const double* x, const double* y, const int64_t* millis, int64_t n,
    const int64_t* edges, int64_t nbins, int64_t off_div, double t_max,
    int32_t* bins_out, int64_t* z_out) {
    if (n < 0 || nbins <= 0 || off_div <= 0 || !(t_max > 0.0)) return -1;
    const double bins_f = 2097152.0;  // 2^21
    const double nx = bins_f / 360.0;
    const double ny = bins_f / 180.0;
    const double nt = bins_f / t_max;
    const uint64_t mi = (1ULL << 21) - 1;
    const int64_t lo = edges[0];
    const int64_t hi = edges[nbins] - 1;
    int32_t prev_bin = 0;  // locality: consecutive rows share bins
    for (int64_t i = 0; i < n; ++i) {
        int64_t ms = millis[i];
        if (ms < lo) ms = lo;
        if (ms > hi) ms = hi;
        int32_t b;
        if (edges[prev_bin] <= ms && ms < edges[prev_bin + 1]) {
            b = prev_bin;
        } else {
            // upper_bound(edges, ms) - 1
            int64_t l = 0, r = nbins;
            while (l < r) {
                const int64_t m = (l + r) / 2;
                if (edges[m] <= ms) l = m + 1; else r = m;
            }
            b = (int32_t)(l - 1);
            prev_bin = b;
        }
        bins_out[i] = b;
        const int64_t off = (ms - edges[b]) / off_div;
        const uint64_t xi = norm(x[i], -180.0, 180.0, nx, mi);
        const uint64_t yi = norm(y[i], -90.0, 90.0, ny, mi);
        const uint64_t ti = norm((double)off, 0.0, t_max, nt, mi);
        z_out[i] = (int64_t)(split3(xi) | (split3(yi) << 1)
                             | (split3(ti) << 2));
    }
    return 0;
}
