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
// and the wrapper check that it needs at most 64 levels. Leaves:
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
// and then hits in the L1/L2 caches.
//
// Design. Each thread takes kRows = 16 consecutive rows: a 4-byte
// column arrives as four 16-byte loads, a 1-byte column as one, and the
// 16 output bytes leave as one 16-byte store, so the bytes in flight
// per SM are several times those of a row per thread; a ragged tail is
// masked in the kernel. Each instruction is decoded once for the 16
// rows, and a leaf's verdicts form a 16-bit mask. The bit stack is one
// 16-bit mask per level: the top in a register, the levels below it in
// dynamic shared memory ([level][thread], 2 B each; the wrapper sizes it
// from the program's depth), so nothing is indexed in local memory.
// The program (instructions, thresholds, slot pointers and vocab
// tables) lives in device memory, uploaded by the wrapper in one copy
// when it first prepares the launch of a program over a set of columns
// and reused while both stay the same; every thread of a warp reads the
// same instruction, a broadcast L1 hit. So no length of program, IN
// list or nesting is refused. (Passing the program by value as a
// __grid_constant__ parameter block, with the vocab tables copied into
// shared memory, ran no faster at the predicates phase's shapes; PERF.md
// §6.) The wrapper refuses columns that are not 16-byte aligned.
//
// C interface (bound with ctypes): the entry returns cudaGetLastError()
// after its launch, and never synchronises.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // rows per thread

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

// the program in device memory
struct Program {
  const int4* code;
  const int2* consts;
  const Slot* slots;
  const uint8_t* table;
};

__device__ __forceinline__ uint32_t bit(bool b) { return b ? 1u : 0u; }

// a compare code as a truth table over (lt, gt): bit 2*lt + gt
__device__ __forceinline__ uint32_t truth(int32_t cmp) {
  switch (cmp) {
    case kLt: return 4u;
    case kGt: return 2u;
    case kLe: return 5u;
    case kGe: return 3u;
    case kEq: return 1u;
    default: return 6u;  // kNe
  }
}

// the kRows 4-byte words of a column from row0: four 16-byte loads, or
// masked scalar loads (0 past n) at the tail
__device__ __forceinline__ void load_words(const void* col, int64_t row0,
                                           bool full, int64_t n,
                                           int32_t (&v)[kRows]) {
  const int32_t* p = static_cast<const int32_t*>(col) + row0;
  if (full) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(p) + q);
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = row0 + r < n ? __ldg(p + r) : 0;
  }
}

// the kRows bytes of a 1-byte column from row0, packed four to a word:
// one 16-byte load, or masked scalar loads at the tail
__device__ __forceinline__ void load_bytes(const void* col, int64_t row0,
                                           bool full, int64_t n,
                                           uint32_t (&w)[kRows / 4]) {
  const uint8_t* p = static_cast<const uint8_t*>(col) + row0;
  if (full) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRows / 4; ++k) w[k] = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < n) w[r / 4] |= static_cast<uint32_t>(__ldg(p + r))
                                    << (8 * (r % 4));
  }
}

__device__ __forceinline__ bool byte_at(const uint32_t (&w)[kRows / 4],
                                        int r) {
  return ((w[r / 4] >> (8 * (r % 4))) & 0xffu) != 0;
}

// a leaf's verdicts over the thread's rows as a kRows-bit mask; a
// PAIR_F64 leaf adds its key-equal rows to band
__device__ __forceinline__ uint32_t leaf(int4 ins, const Slot s, int2 t,
                                         const uint8_t* tbl, int64_t row0,
                                         bool full, int64_t n,
                                         uint32_t* band) {
  uint32_t vm = 0;
  int32_t a[kRows];
  uint32_t ok[kRows / 4];
  switch (ins.x) {
    case kValid:
      load_bytes(s.valid, row0, full, n, ok);
#pragma unroll
      for (int r = 0; r < kRows; ++r) vm |= bit(byte_at(ok, r)) << r;
      break;
    case kIsNull:
      if (s.valid == nullptr) {
        load_words(s.a, row0, full, n, a);
#pragma unroll
        for (int r = 0; r < kRows; ++r) vm |= bit(a[r] < 0) << r;
      } else {
        load_bytes(s.valid, row0, full, n, ok);
#pragma unroll
        for (int r = 0; r < kRows; ++r) vm |= bit(!byte_at(ok, r)) << r;
      }
      break;
    case kPairI64:
    case kPairDate: {
      int32_t lo[kRows];
      load_words(s.a, row0, full, n, a);
      load_words(s.b, row0, full, n, lo);
      load_bytes(s.valid, row0, full, n, ok);
      const uint32_t tt = truth(ins.w);
      const bool u = ins.x == kPairI64;  // an unsigned low word
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool llt = u ? static_cast<uint32_t>(lo[r]) <
                                 static_cast<uint32_t>(t.y)
                           : lo[r] < t.y;
        const bool lgt = u ? static_cast<uint32_t>(lo[r]) >
                                 static_cast<uint32_t>(t.y)
                           : lo[r] > t.y;
        const bool lt = a[r] < t.x || (a[r] == t.x && llt);
        const bool gt = a[r] > t.x || (a[r] == t.x && lgt);
        const uint32_t v = (tt >> (2 * lt + gt)) & 1u;
        vm |= (v & bit(byte_at(ok, r))) << r;
      }
      break;
    }
    case kPairF64: {
      int32_t lo[kRows];
      load_words(s.a, row0, full, n, a);
      load_words(s.b, row0, full, n, lo);
      load_bytes(s.valid, row0, full, n, ok);
      const uint32_t tt = truth(ins.w);
      const float vh = __int_as_float(t.x), vl = __int_as_float(t.y);
      uint32_t eq = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hi = __int_as_float(a[r]), l = __int_as_float(lo[r]);
        const uint32_t good = byte_at(ok, r);
        const bool lt = hi < vh || (hi == vh && l < vl);
        const bool gt = hi > vh || (hi == vh && l > vl);
        vm |= (((tt >> (2 * lt + gt)) & 1u) & good) << r;
        eq |= (bit(hi == vh && l == vl) & good) << r;
      }
      *band |= eq;
      break;
    }
    case kBool:
      load_bytes(s.a, row0, full, n, ok);
      {
        uint32_t valid[kRows / 4];
        load_bytes(s.valid, row0, full, n, valid);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          vm |= ((static_cast<uint32_t>(ins.z) >> (byte_at(ok, r) ? 1 : 0)) &
                 bit(byte_at(valid, r)) & 1u) << r;
      }
      break;
    default: {  // the string codes
      load_words(s.a, row0, full, n, a);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int32_t c = a[r];
        bool v;
        switch (ins.x) {
          case kStrEq: v = c == ins.z && c >= 0; break;
          case kStrNe: v = c != ins.z && c >= 0; break;
          case kStrLt: v = c < ins.z && c >= 0; break;
          case kStrGe: v = c >= ins.z; break;
          default:  // kVocab
            v = c >= 0 && c < ins.w && tbl[ins.z + c] != 0;
        }
        vm |= bit(v) << r;
      }
    }
  }
  return vm;
}

__global__ void __launch_bounds__(kThreads)
    residual_mask_kernel(const Program p, int len, int64_t n,
                         uint8_t* __restrict__ out) {
  extern __shared__ uint16_t stk[];  // levels below the top: [level][thread]
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kRows;
  if (row0 >= n) return;
  const bool full = row0 + kRows <= n;
  uint32_t top = 0, band = 0;
  int h = 0;  // stack height, the same in every thread
  for (int pc = 0; pc < len; ++pc) {
    const int4 ins = __ldg(p.code + pc);
    uint32_t vm;
    switch (ins.x) {
      case kTrue: vm = (1u << kRows) - 1u; break;
      case kFalse: vm = 0; break;
      case kAnd:
      case kOr: {
        --h;
        const uint32_t below = stk[(h - 1) * kThreads + threadIdx.x];
        top = ins.x == kAnd ? top & below : top | below;
        continue;
      }
      case kNot: top ^= (1u << kRows) - 1u; continue;
      default: {
        const Slot s = p.slots[ins.y];
        const bool pair = ins.x == kPairI64 || ins.x == kPairDate ||
                          ins.x == kPairF64;
        int2 t = make_int2(0, 0);
        if (pair) t = __ldg(p.consts + ins.z);
        vm = leaf(ins, s, t, p.table, row0, full, n, &band);
      }
    }
    if (h > 0) stk[(h - 1) * kThreads + threadIdx.x] = static_cast<uint16_t>(top);
    top = vm;
    ++h;
  }
  uint32_t o[kRows / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    o[r / 4] |= (((top >> r) & 1u) | (((band >> r) & 1u) << 1)) << (8 * (r % 4));
  if (full) {
    *reinterpret_cast<int4*>(out + row0) = make_int4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < n) out[row0 + r] = (o[r / 4] >> (8 * (r % 4))) & 0xffu;
  }
}

}  // namespace

extern "C" {

// out[i] = verdict | band << 1 for rows i < n (out 16-byte aligned) of a
// program of len instructions needing a stack of depth (1..64) bits:
// code (int4 each), consts (int2 each), slots (three device pointers
// each) and table in device memory. Requires n > 0 and len > 0.
int geomesa_residual_mask(const int32_t* code, const int32_t* consts,
                          const int64_t* slots, const uint8_t* table, int len,
                          int depth, int64_t n, uint8_t* out, void* stream) {
  const int64_t groups = (n + kRows - 1) / kRows;
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (n < 1 || len < 1 || depth < 1 || depth > 64 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Program p{reinterpret_cast<const int4*>(code),
                  reinterpret_cast<const int2*>(consts),
                  reinterpret_cast<const Slot*>(slots), table};
  const size_t smem = static_cast<size_t>(depth - 1) * kThreads *
                      sizeof(uint16_t);
  residual_mask_kernel<<<static_cast<int>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      p, len, n, out);
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
