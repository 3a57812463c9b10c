// Z-range decomposition: the planner-time hot loop in native code.
//
// A host copy of geomesa_tpu/native/src/zrange.cpp. Mirrors the BFS of
// curves/zranges.py (zranges_plain; the analog of sfcurve's Z3.zranges
// divide-and-conquer, Z3SFC.scala:54-62) EXACTLY: the same level-by-level
// BFS, the same contained/partial emit rules, the same budget, the same
// sort + coalesce merge, so the two give the same ranges bit for bit
// (held equal by the tests).
//
// Exported C ABI (ctypes):
//   geomesa_zranges(lows, highs, dims, max_bits, max_level, max_ranges,
//                   out, out_cap) -> number of [lo,hi] rows written,
//                                    0 if empty, -1 if out_cap too small

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

inline uint64_t split2(uint64_t x) {
    x &= 0x7FFFFFFFULL;
    x = (x ^ (x << 16)) & 0x0000FFFF0000FFFFULL;
    x = (x ^ (x << 8)) & 0x00FF00FF00FF00FFULL;
    x = (x ^ (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
    x = (x ^ (x << 2)) & 0x3333333333333333ULL;
    x = (x ^ (x << 1)) & 0x5555555555555555ULL;
    return x;
}

inline uint64_t split3(uint64_t x) {
    x &= 0x1FFFFFULL;
    x = (x | (x << 32)) & 0x1F00000000FFFFULL;
    x = (x | (x << 16)) & 0x1F0000FF0000FFULL;
    x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
    x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
    x = (x | (x << 2)) & 0x1249249249249249ULL;
    return x;
}

inline uint64_t interleave(const int64_t* c, int dims) {
    if (dims == 2)
        return split2((uint64_t)c[0]) | (split2((uint64_t)c[1]) << 1);
    return split3((uint64_t)c[0]) | (split3((uint64_t)c[1]) << 1)
         | (split3((uint64_t)c[2]) << 2);
}

}  // namespace

extern "C" int64_t geomesa_zranges(
    const int64_t* lows, const int64_t* highs, int64_t dims_i,
    int64_t max_bits, int64_t max_level, int64_t max_ranges,
    int64_t* out, int64_t out_cap) {
    const int dims = (int)dims_i;
    if (dims != 2 && dims != 3) return -1;
    for (int d = 0; d < dims; ++d)
        if (highs[d] < lows[d]) return 0;

    const int nchild = 1 << dims;
    std::vector<int64_t> frontier(dims, 0);  // root cell, stride = dims
    size_t ncells = 1;
    std::vector<std::pair<int64_t, int64_t>> emitted;

    for (int64_t level = 0; level <= max_level && ncells; ++level) {
        const int64_t shift = max_bits - level;
        const int64_t side = (int64_t)1 << shift;
        // dims*shift <= 63 for (2,31)/(3,21), so the span never wraps
        const int64_t span = (int64_t)(((uint64_t)1 << (dims * shift)) - 1);

        std::vector<int64_t> partial;
        size_t npartial = 0;
        for (size_t i = 0; i < ncells; ++i) {
            const int64_t* cell = &frontier[i * dims];
            bool disjoint = false, contained = true;
            for (int d = 0; d < dims; ++d) {
                const int64_t clo = cell[d] * side;
                const int64_t chi = clo + (side - 1);
                if (chi < lows[d] || clo > highs[d]) { disjoint = true; break; }
                if (clo < lows[d] || chi > highs[d]) contained = false;
            }
            if (disjoint) continue;
            if (contained) {
                int64_t origin[3];
                for (int d = 0; d < dims; ++d) origin[d] = cell[d] * side;
                const int64_t zlo = (int64_t)interleave(origin, dims);
                emitted.emplace_back(zlo, zlo + span);
            } else {
                for (int d = 0; d < dims; ++d) partial.push_back(cell[d]);
                ++npartial;
            }
        }
        if (!npartial) break;
        const bool budget_blown =
            (int64_t)(emitted.size() + npartial * (size_t)nchild) > max_ranges;
        if (level == max_level || budget_blown) {
            for (size_t i = 0; i < npartial; ++i) {
                int64_t origin[3];
                for (int d = 0; d < dims; ++d)
                    origin[d] = partial[i * dims + d] * side;
                const int64_t zlo = (int64_t)interleave(origin, dims);
                emitted.emplace_back(zlo, zlo + span);
            }
            break;
        }
        // split partial cells; child order matches np.indices (first
        // dimension varies slowest)
        std::vector<int64_t> next;
        next.reserve(npartial * (size_t)nchild * dims);
        for (size_t i = 0; i < npartial; ++i)
            for (int j = 0; j < nchild; ++j)
                for (int d = 0; d < dims; ++d)
                    next.push_back(partial[i * dims + d] * 2
                                   + ((j >> (dims - 1 - d)) & 1));
        frontier.swap(next);
        ncells = npartial * (size_t)nchild;
    }

    if (emitted.empty()) return 0;
    std::sort(emitted.begin(), emitted.end());
    int64_t n_out = 0;
    int64_t cur_lo = emitted[0].first, cur_hi = emitted[0].second;
    for (size_t i = 1; i < emitted.size(); ++i) {
        if (emitted[i].first - cur_hi <= 1) {  // overlap or adjacency
            cur_hi = std::max(cur_hi, emitted[i].second);
        } else {
            if (n_out >= out_cap) return -1;
            out[2 * n_out] = cur_lo;
            out[2 * n_out + 1] = cur_hi;
            ++n_out;
            cur_lo = emitted[i].first;
            cur_hi = emitted[i].second;
        }
    }
    if (n_out >= out_cap) return -1;
    out[2 * n_out] = cur_lo;
    out[2 * n_out + 1] = cur_hi;
    return n_out + 1;
}
