// Fused z-key encoding: clamp + normalize + interleave in ONE pass.
//
// A host copy of geomesa_tpu/native/src/zencode.cpp (the lenient
// Z2SFC/Z3SFC.index of geomesa_tpu/curves/sfc.py:27-146). The numpy
// pipeline (curves/normalize.py + curves/zorder.py) walks the arrays
// about 30 times through temporaries; this loop reads x/y(/t) once and
// writes z once, with the numpy path's semantics EXACTLY (NaN -> bin 0,
// the int64->int32 cast chain):
//
//   clamp to [min, max]; floor((v - min) * bins / (max - min));
//   clamp to bins - 1; NaN -> 0; interleave (x bit 0, y bit 1, t bit 2)
//
// Its plain twin is Z2SFC/Z3SFC.index_plain (curves/sfc.py); the tests
// hold the two equal bit for bit. Built without -ffast-math.

#include <cmath>
#include <cstdint>

namespace {

inline uint64_t split2(uint64_t v) {
    v &= 0x7FFFFFFFULL;
    v = (v ^ (v << 16)) & 0x0000FFFF0000FFFFULL;
    v = (v ^ (v << 8)) & 0x00FF00FF00FF00FFULL;
    v = (v ^ (v << 4)) & 0x0F0F0F0F0F0F0F0FULL;
    v = (v ^ (v << 2)) & 0x3333333333333333ULL;
    v = (v ^ (v << 1)) & 0x5555555555555555ULL;
    return v;
}

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

}  // namespace

extern "C" void geomesa_z2_encode(const double* x, const double* y,
                                  int64_t n, int64_t* out) {
    const double nx = 2147483648.0 / 360.0;  // 2^31 bins over [-180,180]
    const double ny = 2147483648.0 / 180.0;
    const uint64_t mi = (1ULL << 31) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t xi = norm(x[i], -180.0, 180.0, nx, mi);
        const uint64_t yi = norm(y[i], -90.0, 90.0, ny, mi);
        out[i] = (int64_t)(split2(xi) | (split2(yi) << 1));
    }
}

extern "C" void geomesa_z3_encode(const double* x, const double* y,
                                  const double* t, int64_t n,
                                  double t_max, int64_t* out) {
    const double bins = 2097152.0;           // 2^21
    const double nx = bins / 360.0;
    const double ny = bins / 180.0;
    const double nt = bins / t_max;
    const uint64_t mi = (1ULL << 21) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const uint64_t xi = norm(x[i], -180.0, 180.0, nx, mi);
        const uint64_t yi = norm(y[i], -90.0, 90.0, ny, mi);
        const uint64_t ti = norm(t[i], 0.0, t_max, nt, mi);
        out[i] = (int64_t)(split3(xi) | (split3(yi) << 1)
                           | (split3(ti) << 2));
    }
}
