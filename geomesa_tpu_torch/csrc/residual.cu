// Attribute residual kernel for Hopper (sm_90a).
//
// Replaces the eager device program geomesa_tpu/scan/residual.py:
// device_mask (:132), with _pair_cmp (:214), _compare (:235),
// _compare_str (:285), _vocab_gather (:313) and the AND/OR/NOT of the
// tree: the attribute predicates that the in-memory store pushes to the
// device (the fullscan "iterator", the dense secondary filter and wide
// attribute-index scans). The JAX package ran one vector pass per tree
// node; here one pass over the rows evaluates the whole tree in
// registers.
//
// The host compiler (scan/residual.compile_program) turns the filter
// into a postfix program of 16-byte instructions {op, slot, a, b}: leaves
// push one bit, AND/OR pop two and push one, NOT flips the top. It orders
// each node's children by the stack they need (Sethi-Ullman), so the
// stack never holds more than about log2(leaves) + 1 bits; the compiler
// checks that it fits the 64-bit stack register. Leaves:
//   TRUE, FALSE; VALID (a constant-true compare: the row is not null);
//   ISNULL (codes < 0 for strings, !valid otherwise);
//   PAIR_I64 / PAIR_DATE / PAIR_F64: the lexicographic compare of a
//     split column (hi, lo) with a split threshold consts[a] = (vh, vl)
//     by cmp b, AND valid. i64: hi signed, lo UNSIGNED (the low word of
//     v & 0xFFFFFFFF); date: (day, ms) both signed; f64: (f32 hi, f32
//     residual lo). A PAIR_F64 row whose key equals the threshold's key
//     (hi == vh and lo == vl, valid) sets the band bit: the split order
//     cannot decide it, and the host re-evaluates the whole filter on
//     band rows in float64;
//   BOOL: a boolean column against a literal as a truth table a (bit 0:
//     the verdict for false, bit 1 for true), AND valid;
//   STR_EQ / STR_NE code a, STR_LT / STR_GE vocab position a: integer
//     compares of the dictionary codes (-1 is null), as the vocab is
//     sorted;
//   VOCAB: a vocab-level table (IN, LIKE) at table[a .. a+b), indexed by
//     the code; a null or out-of-range code is false.
// Every threshold and table is computed on the host by the JAX package's
// own rules, so the bits equal its device_mask's (and the band rows'
// final verdicts its host patch's).
//
// Output: one byte per row, bit 0 the verdict, bit 1 the band.
//
// Bound: bytes. Each referenced column is read once per row (hi, lo 4 B
// each and valid 1 B for a split column, 4 B of codes, 1 + 1 B for a
// boolean), plus 1 B out; chip_smoke.py counts them at 3.35 TB/s. A
// column that several leaves read is fetched from device memory once
// and then hits in the L1/L2 caches. The program lives in device memory
// and every thread of a warp reads the same instruction (a broadcast,
// cached), so no length of program, IN list or nesting is refused. One
// thread per row, in a grid-stride loop with coalesced column loads.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// opcodes and compare codes: equal to scan/kernels.py's Op and Cmp, which
// the loader checks through geomesa_residual_codes
enum Op : int32_t {
  kTrue = 0, kFalse = 1, kAnd = 2, kOr = 3, kNot = 4, kValid = 5,
  kIsNull = 6, kPairI64 = 7, kPairDate = 8, kPairF64 = 9, kBool = 10,
  kStrEq = 11, kStrNe = 12, kStrLt = 13, kStrGe = 14, kVocab = 15,
};
enum Cmp : int32_t { kLt = 0, kGt = 1, kLe = 2, kGe = 3, kEq = 4, kNe = 5 };

// one column slot: three device pointers (split columns: hi, lo, valid;
// booleans: values, unused, valid; strings: codes, unused, unused)
struct Slot {
  const void* a;
  const void* b;
  const uint8_t* valid;
};

__device__ __forceinline__ bool pick(int32_t cmp, bool lt, bool gt) {
  switch (cmp) {
    case kLt: return lt;
    case kGt: return gt;
    case kLe: return !gt;
    case kGe: return !lt;
    case kEq: return !lt && !gt;
    default: return lt || gt;  // kNe
  }
}

__global__ void __launch_bounds__(kThreads)
    residual_mask_kernel(const int4* __restrict__ code, int len,
                         const int2* __restrict__ consts,
                         const uint8_t* __restrict__ table,
                         const Slot* __restrict__ slots, int64_t n,
                         uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint64_t st = 0;  // the bit stack, top in bit 0
    bool band = false;
    for (int pc = 0; pc < len; ++pc) {
      const int4 ins = __ldg(code + pc);
      bool v;
      switch (ins.x) {
        case kTrue: v = true; break;
        case kFalse: v = false; break;
        case kAnd: st = (st >> 1) & (st | ~1ull); continue;
        case kOr: st = (st >> 1) | (st & 1ull); continue;
        case kNot: st ^= 1ull; continue;
        default: {
          const Slot s = slots[ins.y];
          switch (ins.x) {
            case kValid: v = s.valid[i] != 0; break;
            case kIsNull:
              v = s.valid == nullptr
                      ? static_cast<const int32_t*>(s.a)[i] < 0
                      : s.valid[i] == 0;
              break;
            case kPairI64:
            case kPairDate: {
              const int2 t = __ldg(consts + ins.z);
              const int32_t hi = static_cast<const int32_t*>(s.a)[i];
              const int32_t lo = static_cast<const int32_t*>(s.b)[i];
              bool llt, lgt;
              if (ins.x == kPairI64) {
                llt = static_cast<uint32_t>(lo) < static_cast<uint32_t>(t.y);
                lgt = static_cast<uint32_t>(lo) > static_cast<uint32_t>(t.y);
              } else {
                llt = lo < t.y;
                lgt = lo > t.y;
              }
              const bool lt = hi < t.x || (hi == t.x && llt);
              const bool gt = hi > t.x || (hi == t.x && lgt);
              v = pick(ins.w, lt, gt) && s.valid[i] != 0;
              break;
            }
            case kPairF64: {
              const int2 t = __ldg(consts + ins.z);
              const float vh = __int_as_float(t.x), vl = __int_as_float(t.y);
              const float hi = static_cast<const float*>(s.a)[i];
              const float lo = static_cast<const float*>(s.b)[i];
              const bool ok = s.valid[i] != 0;
              const bool lt = hi < vh || (hi == vh && lo < vl);
              const bool gt = hi > vh || (hi == vh && lo > vl);
              v = pick(ins.w, lt, gt) && ok;
              band |= hi == vh && lo == vl && ok;
              break;
            }
            case kBool:
              v = ((ins.z >> (static_cast<const uint8_t*>(s.a)[i] ? 1 : 0)) &
                   1) != 0 &&
                  s.valid[i] != 0;
              break;
            case kStrEq: {
              const int32_t c = static_cast<const int32_t*>(s.a)[i];
              v = c == ins.z && c >= 0;
              break;
            }
            case kStrNe: {
              const int32_t c = static_cast<const int32_t*>(s.a)[i];
              v = c != ins.z && c >= 0;
              break;
            }
            case kStrLt: {
              const int32_t c = static_cast<const int32_t*>(s.a)[i];
              v = c < ins.z && c >= 0;
              break;
            }
            case kStrGe:
              v = static_cast<const int32_t*>(s.a)[i] >= ins.z;
              break;
            default: {  // kVocab
              const int32_t c = static_cast<const int32_t*>(s.a)[i];
              v = c >= 0 && c < ins.w && table[ins.z + c] != 0;
              break;
            }
          }
        }
      }
      st = (st << 1) | static_cast<uint64_t>(v);
    }
    out[i] = static_cast<uint8_t>((st & 1ull) | (band ? 2u : 0u));
  }
}

}  // namespace

extern "C" {

// out[i] = verdict | band << 1 for rows i < n of the program code (len
// instructions, int4 each), with thresholds consts (int2 each), the vocab
// tables and the slot table (three device pointers per slot). Requires
// n > 0 and len > 0.
int geomesa_residual_mask(const int32_t* code, int len, const int32_t* consts,
                          const uint8_t* table, const int64_t* slots,
                          int64_t n, uint8_t* out, void* stream) {
  if (n < 1 || len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  residual_mask_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(code), len,
      reinterpret_cast<const int2*>(consts), table,
      reinterpret_cast<const Slot*>(slots), n, out);
  return static_cast<int>(cudaGetLastError());
}

// The opcode and compare-code values in the order of kernels.py's
// RESIDUAL_CODES: writes at most cap of them to out and returns how many
// there are.
int geomesa_residual_codes(int32_t* out, int cap) {
  const int32_t codes[] = {kTrue,    kFalse,    kAnd,     kOr,    kNot,
                           kValid,   kIsNull,   kPairI64, kPairDate,
                           kPairF64, kBool,     kStrEq,   kStrNe, kStrLt,
                           kStrGe,   kVocab,    kLt,      kGt,    kLe,
                           kGe,      kEq,       kNe};
  const int len = static_cast<int>(sizeof(codes) / sizeof(codes[0]));
  for (int i = 0; i < len && i < cap; ++i) out[i] = codes[i];
  return len;
}

}  // extern "C"
