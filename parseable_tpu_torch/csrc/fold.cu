// Hand-written Hopper (sm_90a) kernels for the front half of the dense fold.
//
// K3 of the port's kernel table: before kernels A and B (groupby.cu) and
// K5-K7 (stats.cu) reduce a block, every row needs its WHERE verdict, its
// group id and its operand values. The JAX package computes them as XLA
// programs traced from the WHERE tree: parseable_tpu/query/executor_tpu.py
// :2852 fold_one (mask and ids, :2859-2907), with the predicate tracer
// PredicateCompiler (:314, _num_cmp :633) and the operand stacks of
// _kernel_stacks (:838). Here the host lowers the WHERE tree, the time
// bounds, the padding mask and the GROUP BY keys into one small packed
// PROGRAM of int32 words (parseable_tpu_torch/ops/fold_cuda.py builds it and
// documents the format, and its plain versions interpret the same words);
// the program rides the query's small aux copy, with the dictionary LUTs,
// the remaps and the IN-lists in its data section. Two kernels read it:
//
// k3_mask_ids (K3a): the WHERE verdict (u8 [N]) and the group ids (i32
//   [N]). SQL's three-valued logic as a stack machine over (value, known)
//   pairs: a leaf pushes (predicate AND valid, valid) -- or (x, 1) for
//   IS [NOT] NULL, (x, k) for a literal -- AND, OR and NOT combine pairs,
//   NOT e is (known & ~value, known). Key instructions add code * stride
//   into the row's id: a dictionary remap gather with an upper clamp only,
//   or a time bin clamp(floor((ts + shift) / bin) + k_off, 0, cap - 1) in
//   wrapping int32 arithmetic with a floor (not C's truncating) division,
//   or (KEY_CODE) the slot's own code with an upper clamp, no remap: the
//   block-local fold of a high-cardinality GROUP BY (JAX _get_local_program
//   .fold, executor_tpu.py:2473, ids at :2493-2500). KEY_WINDOW, after the
//   keys, moves the id into a groups-sharded mesh's window [lo, lo + n): the
//   verdict ANDs 0 <= id - lo < n, the id becomes clamp(id - lo, 0, n - 1)
//   (JAX fold_one's group-sharded layout, executor_tpu.py:2899-2906).
// k3_stack_operands (K3b): kernel A's row matrix [mask | valid&mask rows |
//   masked values] (f32), kernel B's value rows (f32) and validity rows
//   (u8), and the liveness rows of K5-K7, in the order of executor_cuda's
//   AccLayout.
//
// Bound: bytes. K3a reads each column its program names once (1-8 bytes a
// row, plus a validity byte where the column has nulls) and writes 5 bytes
// a row; K3b reads the mask and its columns once and writes 4 bytes per f32
// row and 1 per u8 row. The design for Hopper:
// - a thread takes a run of kRun = 16 rows, four chunks of 4 consecutive
//   rows 128 rows apart (row_of), so that each warp access of a chunk covers
//   128 consecutive rows: one 16-byte access a lane of a 4-byte column (the
//   f32 operand rows, the ids, f32 and int32 columns; two of an f64 column),
//   one 4-byte access of a byte column (codes, validity, the mask, the u8
//   rows). Every access is coalesced, and every store fills whole 32-byte
//   sectors: with 16 consecutive rows a thread, each lane's 16-byte store
//   of an f32 row half-filled a sector, and K3b ran 4x slower than the
//   one-row-a-thread kernel it replaces (182.6 against 41.8 us);
// - each instruction (in shared memory, read by every thread at once) is
//   decoded once per run, and the slot's dtype is resolved once per
//   instruction: a leaf fills 16 (value, known) bit pairs in registers. The
//   stack's top stays in registers; the entries below it sit in shared
//   memory, one column of words a thread (no bank conflicts). K3b loads the
//   mask once per run and each column once for all the operand rows that
//   read it: the host packs the rows MASK first, then by slot;
// - the launcher takes the vector variant only where N is a multiple of a
//   warp's 512 rows and every slot and output lies on a 16-byte boundary
//   (every block of the main path: block sizes are powers of two from
//   1,024, and executor_cuda._copy carves columns at 16-byte offsets); else
//   the scalar variant, one element at a time, which gives the same bits.
// Kept from the first design: no fast-math, and every comparison written
// out (x != t is true on NaN, every ordered compare false); int8 codes sign-
// extend and are masked by the LUT's power-of-two size; the f64 compares
// (CMP_F64, IN_F64) read f32 or f64 values as f64, exactly; the host checks
// the 32-deep stack and the 128-instruction and 16-column limits before any
// launch (the kernel only guards its shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kHeaderWords = 8;
constexpr int kInstrWords = 8;
constexpr int kOpWords = 4;
constexpr int kMaxInstr = 128;  // fold_cuda.MAX_INSTR
constexpr int kMaxOps = 128;    // fold_cuda.MAX_OPS
constexpr int kMaxSlots = 16;   // fold_cuda.MAX_SLOTS
constexpr int kMaxStack = 32;   // fold_cuda.MAX_STACK
constexpr int kRun = 16;        // fold_cuda.RUN: rows a thread
constexpr int kThreads = 128;
constexpr unsigned kAll = (1u << kRun) - 1u;

// opcodes (fold_cuda.py): leaves push one (value, known) pair
enum Op {
  kLut = 1, kCmpF32, kCmpI32, kInF32, kNotInF32, kIsNull, kNotNull, kConst,
  kAnd, kOr, kNot, kKeyDict, kKeyTime, kCmpF64, kInF64, kNotInF64, kKeyCode, kKeyWindow,
};
enum RowOp { kRowMask = 1, kRowLive, kRowMasked, kRowValue };
enum RowFlag { kNanAware = 1, kBoolOut = 2 };
enum Dtype { kI8 = 0, kI16 = 1, kI32 = 2, kF32 = 3, kF64 = 4 };

// The block's column table: a value array and a validity array per slot
// (nullptr: the column has no nulls).
struct Slots {
  const void* values[kMaxSlots];
  const uint8_t* valid[kMaxSlots];
  int dtype[kMaxSlots];
};

// ------------------------------------------------------------ runs of rows

// A thread's kRun rows, a warp's kTile: the thread of lane l in the warp of
// tile t holds rows t * kTile + 128 * c + 4 * l + j (chunk c, j < 4).
// Every warp access of one chunk covers 128 consecutive rows: 512 bytes of
// a 4-byte column, in one 16-byte access a lane, so that each store fills
// whole 32-byte sectors.
constexpr int kChunk = 4;
constexpr int kTile = 32 * kRun;

__device__ __forceinline__ long long row_of(long long base, int i) {
  return base + (long long)(32 * kChunk) * (i / kChunk) + (i % kChunk);
}

// The vector type of one chunk of T: 4 bytes of a byte column, 16 of an
// int32 or f32 column (two uint4 of an f64 one).
template <typename T>
struct Chunk {
  using V = typename std::conditional<
      sizeof(T) == 1, unsigned,
      typename std::conditional<sizeof(T) == 2, uint2, uint4>::type>::type;
  static constexpr int kWords = sizeof(T) * kChunk / sizeof(V);
  union U {
    V v[kWords];
    T t[kChunk];
  };
};

// The thread's kRun elements of `p` (rows from `base`, see row_of): one
// vector load a chunk in the vector variant (the launcher checked the
// alignment), else one element at a time, 0 past n.
template <typename T, bool kVec>
__device__ __forceinline__ void load_run(const T* __restrict__ p, long long base, long long n,
                                         T (&out)[kRun]) {
  if constexpr (kVec) {
    using C = Chunk<T>;
#pragma unroll
    for (int c = 0; c < kRun / kChunk; ++c) {
      const auto* q = reinterpret_cast<const typename C::V*>(p + row_of(base, c * kChunk));
      typename C::U cv;
#pragma unroll
      for (int w = 0; w < C::kWords; ++w) cv.v[w] = __ldg(q + w);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) out[c * kChunk + j] = cv.t[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const long long r = row_of(base, i);
      out[i] = r < n ? p[r] : T(0);
    }
  }
}

template <typename T, typename U, bool kVec>
__device__ __forceinline__ void load_cvt(const void* p, long long base, long long n,
                                         U (&out)[kRun]) {
  T raw[kRun];
  load_run<T, kVec>(static_cast<const T*>(p), base, n, raw);
#pragma unroll
  for (int i = 0; i < kRun; ++i) out[i] = static_cast<U>(raw[i]);
}

// A slot's run as U (int codes sign-extend; ints and f32 widen exactly to
// f64), the dtype resolved once for the run.
template <typename U, bool kVec>
__device__ __forceinline__ void load_as(const Slots& s, int slot, long long base, long long n,
                                        U (&out)[kRun]) {
  const void* p = s.values[slot];
  switch (s.dtype[slot]) {
    case kI8: load_cvt<int8_t, U, kVec>(p, base, n, out); break;
    case kI16: load_cvt<int16_t, U, kVec>(p, base, n, out); break;
    case kI32: load_cvt<int32_t, U, kVec>(p, base, n, out); break;
    case kF32: load_cvt<float, U, kVec>(p, base, n, out); break;
    default: load_cvt<double, U, kVec>(p, base, n, out); break;
  }
}

// Bit i: byte i of the run is not 0.
template <bool kVec>
__device__ __forceinline__ unsigned load_bits(const uint8_t* p, long long base, long long n) {
  uint8_t b[kRun];
  load_run<uint8_t, kVec>(p, base, n, b);
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) bits |= (unsigned)(b[i] != 0) << i;
  return bits;
}

template <bool kVec>
__device__ __forceinline__ unsigned valid_bits(const Slots& s, int slot, long long base,
                                               long long n) {
  const uint8_t* v = s.valid[slot];
  return v == nullptr ? kAll : load_bits<kVec>(v, base, n);
}

// Four bits as four 0/1 bytes.
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

template <bool kVec>
__device__ __forceinline__ void store_bits(uint8_t* __restrict__ p, long long base, long long n,
                                           unsigned bits) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < kRun / kChunk; ++c) {
      *reinterpret_cast<unsigned*>(p + row_of(base, c * kChunk)) = spread4(bits >> (c * kChunk));
    }
  } else {
    for (int i = 0; i < kRun; ++i) {
      const long long r = row_of(base, i);
      if (r < n) p[r] = (uint8_t)((bits >> i) & 1u);
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_run(T* __restrict__ p, long long base, long long n,
                                          const T (&v)[kRun]) {
  if constexpr (kVec) {
    using C = Chunk<T>;
#pragma unroll
    for (int c = 0; c < kRun / kChunk; ++c) {
      auto* q = reinterpret_cast<typename C::V*>(p + row_of(base, c * kChunk));
      typename C::U cv;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) cv.t[j] = v[c * kChunk + j];
#pragma unroll
      for (int w = 0; w < C::kWords; ++w) q[w] = cv.v[w];
    }
  } else {
    for (int i = 0; i < kRun; ++i) {
      const long long r = row_of(base, i);
      if (r < n) p[r] = v[i];
    }
  }
}

// The first row of this thread's run in the grid-stride loop's `tile`.
__device__ __forceinline__ long long run_base(long long tile) {
  return tile * kTile + kChunk * (threadIdx.x % 32);
}

// ------------------------------------------------------------ leaves

template <typename T, typename Pred>
__device__ __forceinline__ unsigned bits_of(const T (&x)[kRun], Pred pred) {
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i) bits |= (unsigned)pred(x[i]) << i;
  return bits;
}

template <typename T>
__device__ __forceinline__ unsigned compare_run(const T (&x)[kRun], T t, int op) {
  // each op written out: x <= t is not !(x > t) when x is NaN
  switch (op) {
    case 0: return bits_of(x, [t](T a) { return a == t; });
    case 1: return bits_of(x, [t](T a) { return a != t; });
    case 2: return bits_of(x, [t](T a) { return a < t; });
    case 3: return bits_of(x, [t](T a) { return a <= t; });
    case 4: return bits_of(x, [t](T a) { return a > t; });
    default: return bits_of(x, [t](T a) { return a >= t; });
  }
}

template <typename T>
__device__ __forceinline__ unsigned in_run(const T (&x)[kRun], const T* items, int count) {
  unsigned bits = 0;
  for (int j = 0; j < count; ++j) {
    const T item = items[j];
#pragma unroll
    for (int i = 0; i < kRun; ++i) bits |= (unsigned)(x[i] == item) << i;
  }
  return bits;
}

__device__ __forceinline__ int floor_div(int x, int b) {  // b > 0
  int q = x / b;
  if ((x % b) != 0 && x < 0) --q;
  return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32 wrap, as torch's int32 add
  return (int)((unsigned)a + (unsigned)b);
}

// ------------------------------------------------------------ kernels

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    k3_mask_ids_kernel(const int* __restrict__ prog, const __grid_constant__ Slots slots,
                       long long n, uint8_t* __restrict__ mask, int* __restrict__ ids) {
  __shared__ int s_ins[kMaxInstr * kInstrWords];
  // the stack's entries below its top, (value | known << 16) a word
  __shared__ unsigned s_stack[kMaxStack - 1][kThreads];
  const int n_instr = min(prog[1], kMaxInstr);
  for (int i = threadIdx.x; i < n_instr * kInstrWords; i += blockDim.x) {
    s_ins[i] = prog[kHeaderWords + i];
  }
  __syncthreads();
  const uint8_t* data = (const uint8_t*)(prog + prog[3]);
  unsigned* below = &s_stack[0][threadIdx.x];
  const long long tiles = (n + kTile - 1) / kTile;
  const long long step = (long long)gridDim.x * (blockDim.x / 32);
  for (long long tile = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; tile < tiles;
       tile += step) {
    const long long base = run_base(tile);
    unsigned top_v = 0, top_k = 0;  // the top pair, a bit a row
    int depth = 0;
    int id[kRun];  // added in wrapping unsigned arithmetic
#pragma unroll
    for (int i = 0; i < kRun; ++i) id[i] = 0;
    for (int k = 0; k < n_instr; ++k) {
      const int* in = s_ins + k * kInstrWords;
      const int op = in[0], slot = in[1];
      unsigned v, known = kAll;
      switch (op) {
        case kLut: {
          int c[kRun];
          load_as<int, kVec>(slots, slot, base, n, c);
          const uint8_t* lut = data + in[2];
          const unsigned size_mask = (unsigned)(in[3] - 1);
          v = 0;
#pragma unroll
          for (int i = 0; i < kRun; ++i) v |= (unsigned)(lut[(unsigned)c[i] & size_mask] != 0) << i;
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kCmpF32: {
          float x[kRun];
          load_as<float, kVec>(slots, slot, base, n, x);
          v = compare_run(x, __int_as_float(in[3]), in[2]);
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kCmpI32: {
          int x[kRun];
          load_as<int, kVec>(slots, slot, base, n, x);
          v = compare_run(x, in[3], in[2]);
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kCmpF64: {
          double x[kRun];
          load_as<double, kVec>(slots, slot, base, n, x);
          v = compare_run(x, __hiloint2double(in[4], in[3]), in[2]);
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kInF32:
        case kNotInF32: {
          float x[kRun];
          load_as<float, kVec>(slots, slot, base, n, x);
          v = in_run(x, (const float*)(data + in[2]), in[3]);
          if (op == kNotInF32) v ^= kAll;
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kInF64:
        case kNotInF64: {
          double x[kRun];
          load_as<double, kVec>(slots, slot, base, n, x);
          v = in_run(x, (const double*)(data + in[2]), in[3]);
          if (op == kNotInF64) v ^= kAll;
          known = valid_bits<kVec>(slots, slot, base, n);
          break;
        }
        case kIsNull: v = valid_bits<kVec>(slots, slot, base, n) ^ kAll; break;
        case kNotNull: v = valid_bits<kVec>(slots, slot, base, n); break;
        case kConst:
          known = in[3] != 0 ? kAll : 0u;
          v = in[2] != 0 ? known : 0u;
          break;
        case kAnd:
        case kOr: {
          if (depth < 2) continue;
          --depth;
          const unsigned w = below[(depth - 1) * kThreads];
          const unsigned av = w & kAll, ak = w >> 16, bv = top_v, bk = top_k;
          if (op == kAnd) {  // FALSE on either side decides
            top_v = av & bv;
            top_k = (ak & bk) | (ak & ~av) | (bk & ~bv);
          } else {  // TRUE on either side decides
            top_v = av | bv;
            top_k = (ak & bk) | av | bv;
          }
          top_k &= kAll;
          continue;
        }
        case kNot:
          top_v = top_k & ~top_v & kAll;
          continue;
        case kKeyDict: {
          if (ids == nullptr) continue;
          int c[kRun];
          load_as<int, kVec>(slots, slot, base, n, c);
          const int* remap = (const int*)(data + in[2]);
          const unsigned size_mask = (unsigned)(in[3] - 1);
          const int top = in[4] - 1;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const int r = remap[(unsigned)c[i] & size_mask];
            id[i] = (int)((unsigned)id[i] + (unsigned)(r < top ? r : top) * (unsigned)in[5]);
          }
          continue;  // keys push nothing
        }
        case kKeyCode: {
          if (ids == nullptr) continue;
          int c[kRun];
          load_as<int, kVec>(slots, slot, base, n, c);
          const int top = in[2] - 1;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            id[i] = (int)((unsigned)id[i] + (unsigned)(c[i] < top ? c[i] : top) * (unsigned)in[3]);
          }
          continue;
        }
        case kKeyTime: {
          if (ids == nullptr) continue;
          int t[kRun];
          load_as<int, kVec>(slots, slot, base, n, t);
          const int top = in[5] - 1;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            int y = wrap_add(floor_div(wrap_add(t[i], in[2]), in[3]), in[4]);
            y = y < 0 ? 0 : (y > top ? top : y);
            id[i] = (int)((unsigned)id[i] + (unsigned)y * (unsigned)in[6]);
          }
          continue;
        }
        case kKeyWindow: {
          if (ids == nullptr) continue;
          const int lo = in[2], width = in[3];
          unsigned inside = 0;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            const int local = wrap_add(id[i], -lo);
            inside |= (unsigned)(local >= 0 && local < width) << i;
            id[i] = local < 0 ? 0 : (local >= width ? width - 1 : local);
          }
          top_v &= inside;
          top_k = (top_k | ~inside) & kAll;
          continue;
        }
        default: continue;
      }
      // push (value & known, known); the old top moves below
      if (depth >= kMaxStack) continue;
      if (depth > 0) below[(depth - 1) * kThreads] = top_v | (top_k << 16);
      ++depth;
      top_v = v & known;
      top_k = known;
    }
    store_bits<kVec>(mask, base, n, top_v);
    if (ids != nullptr) store_run<int, kVec>(ids, base, n, id);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    k3_stack_operands_kernel(const int* __restrict__ prog, const __grid_constant__ Slots slots,
                             long long n, const uint8_t* __restrict__ mask,
                             float* __restrict__ frows, uint8_t* __restrict__ brows) {
  __shared__ int s_ops[kMaxOps * kOpWords];
  const int n_ops = min(prog[2], kMaxOps);
  const int* ops = prog + kHeaderWords + prog[1] * kInstrWords;
  for (int i = threadIdx.x; i < n_ops * kOpWords; i += blockDim.x) s_ops[i] = ops[i];
  __syncthreads();
  const long long tiles = (n + kTile - 1) / kTile;
  const long long step = (long long)gridDim.x * (blockDim.x / 32);
  for (long long tile = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; tile < tiles;
       tile += step) {
    const long long base = run_base(tile);
    const unsigned m = load_bits<kVec>(mask, base, n);
    // the last column read, kept for the next operand rows of its slot
    int x_slot = -1, v_slot = -1;
    float x[kRun];
    unsigned valid = kAll, not_nan = kAll;
    for (int k = 0; k < n_ops; ++k) {
      const int* o = s_ops + k * kOpWords;
      const int op = o[0], slot = o[1], flags = o[2];
      unsigned live = m;
      if (op != kRowMask) {
        if ((op == kRowMasked || op == kRowValue || (flags & kNanAware)) && slot != x_slot) {
          x_slot = slot;
          load_as<float, kVec>(slots, slot, base, n, x);
          not_nan = 0;
#pragma unroll
          for (int i = 0; i < kRun; ++i) not_nan |= (unsigned)(!isnan(x[i])) << i;
        }
        if (slot != v_slot) {
          v_slot = slot;
          valid = valid_bits<kVec>(slots, slot, base, n);
        }
        live &= valid;
        if (flags & kNanAware) live &= not_nan;
      }
      if (flags & kBoolOut) {
        store_bits<kVec>(brows + (long long)o[3] * n, base, n, live);
        continue;
      }
      float out[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        const bool on = (live >> i) & 1u;
        out[i] = op == kRowMasked ? (on ? x[i] : 0.0f) : op == kRowValue ? x[i] : (on ? 1.0f : 0.0f);
      }
      store_run<float, kVec>(frows + (long long)o[3] * n, base, n, out);
    }
  }
}

// ------------------------------------------------------------ launchers

cudaError_t make_slots(const unsigned long long* values, const unsigned long long* valid,
                       const int* dtypes, int n_slots, Slots* out) {
  if (n_slots < 0 || n_slots > kMaxSlots) return cudaErrorInvalidValue;
  for (int i = 0; i < kMaxSlots; ++i) {
    out->values[i] = i < n_slots ? (const void*)values[i] : nullptr;
    out->valid[i] = i < n_slots ? (const uint8_t*)valid[i] : nullptr;
    out->dtype[i] = i < n_slots ? dtypes[i] : kF32;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The 16-byte variant's precondition (fold_cuda.vector_ok checks the same
// before asking for it).
bool vector_fits(const Slots& s, int n_slots, long long n, const void* a, const void* b,
                 const void* c) {
  if (n % kTile != 0 || !aligned16(a) || !aligned16(b) || !aligned16(c)) return false;
  for (int i = 0; i < n_slots; ++i) {
    if (!aligned16(s.values[i]) || !aligned16(s.valid[i])) return false;
  }
  return true;
}

int grid_for(long long n) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  return clamp_grid(ceil_div(n, (long long)kTile * (kThreads / 32)), 16LL * info.sms);
}

}  // namespace

extern "C" int k3_mask_ids(const int* prog, const unsigned long long* values,
                           const unsigned long long* valid, const int* dtypes, int n_slots,
                           long long n, uint8_t* mask, int* ids, int vec, void* stream) {
  Slots slots;
  cudaError_t err = make_slots(values, valid, dtypes, n_slots, &slots);
  if (err != cudaSuccess || n <= 0) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    if (!vector_fits(slots, n_slots, n, prog, mask, ids)) return (int)cudaErrorMisalignedAddress;
    k3_mask_ids_kernel<true><<<grid_for(n), kThreads, 0, st>>>(prog, slots, n, mask, ids);
  } else {
    k3_mask_ids_kernel<false><<<grid_for(n), kThreads, 0, st>>>(prog, slots, n, mask, ids);
  }
  return (int)cudaGetLastError();
}

extern "C" int k3_stack_operands(const int* prog, const unsigned long long* values,
                                 const unsigned long long* valid, const int* dtypes, int n_slots,
                                 long long n, const uint8_t* mask, float* frows, uint8_t* brows,
                                 int vec, void* stream) {
  Slots slots;
  cudaError_t err = make_slots(values, valid, dtypes, n_slots, &slots);
  if (err != cudaSuccess || n <= 0) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    if (!vector_fits(slots, n_slots, n, mask, frows, brows)) {
      return (int)cudaErrorMisalignedAddress;
    }
    k3_stack_operands_kernel<true><<<grid_for(n), kThreads, 0, st>>>(prog, slots, n, mask,
                                                                     frows, brows);
  } else {
    k3_stack_operands_kernel<false><<<grid_for(n), kThreads, 0, st>>>(prog, slots, n, mask,
                                                                      frows, brows);
  }
  return (int)cudaGetLastError();
}
