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
// k3_mask_ids (K3a): one pass over a block. Each thread walks the program
//   for its row as a stack machine over (value, known) bit pairs, SQL's
//   three-valued logic: a leaf pushes (predicate AND valid, valid) -- or
//   (x, 1) for IS [NOT] NULL and literals -- AND, OR and NOT combine pairs,
//   NOT e is (known & ~value, known). The verdict is the value bit left on
//   the stack (u8 [N]). Key instructions add code * stride into the row's
//   group id (i32 [N]): a dictionary remap gather with an upper clamp only,
//   or a time bin clamp(floor((ts + shift) / bin) + k_off, 0, cap - 1) in
//   wrapping int32 arithmetic with a floor (not C's truncating) division.
// k3_stack_operands (K3b): one pass that writes, from the block's columns
//   and the mask, kernel A's row matrix [mask | valid&mask rows | masked
//   values] (f32), kernel B's value rows (f32) and validity rows (u8), and
//   the liveness rows of K5-K7, in the order of executor_cuda's AccLayout.
//   It replaces the torch.stack / torch.cat / torch.where / dtype copies that
//   built those matrices one launch each.
//
// Bound: bytes. K3a reads each referenced column once (1-4 bytes a row,
// plus a validity byte where the column has nulls) and writes 5 bytes a
// row; K3b reads its columns and the mask and writes 4 bytes per f32 row
// and 1 per u8 row. A row's instruction walk is uniform across a warp (every
// thread runs the same instruction), so the switch does not diverge; the
// instructions sit in shared memory, the column table in the kernel's
// parameter space (__grid_constant__), the LUTs in L1/L2. Loads are scalar:
// columns are carved by .view(dtype) out of one pinned payload, so a
// pointer is only aligned to its element size. No fast-math: x != t must be
// true on NaN and every ordered compare false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kHeaderWords = 8;
constexpr int kInstrWords = 8;
constexpr int kOpWords = 4;
constexpr int kMaxInstr = 128;  // fold_cuda.MAX_INSTR
constexpr int kMaxOps = 128;    // fold_cuda.MAX_OPS
constexpr int kMaxSlots = 16;   // fold_cuda.MAX_SLOTS
constexpr int kThreads = 256;

// opcodes (fold_cuda.py): leaves push one (value, known) pair
enum Op {
  kLut = 1, kCmpF32, kCmpI32, kInF32, kNotInF32, kIsNull, kNotNull, kConst,
  kAnd, kOr, kNot, kKeyDict, kKeyTime,
};
enum RowOp { kRowMask = 1, kRowLive, kRowMasked, kRowValue };
enum RowFlag { kNanAware = 1, kBoolOut = 2 };
enum Dtype { kI8 = 0, kI16 = 1, kI32 = 2, kF32 = 3 };

// The block's column table: a value array and a validity array per slot
// (nullptr: the column has no nulls).
struct Slots {
  const void* values[kMaxSlots];
  const uint8_t* valid[kMaxSlots];
  int dtype[kMaxSlots];
};

__device__ __forceinline__ int load_int(const Slots& s, int slot, long long i) {
  switch (s.dtype[slot]) {
    case kI8: return ((const int8_t*)s.values[slot])[i];
    case kI16: return ((const int16_t*)s.values[slot])[i];
    default: return ((const int32_t*)s.values[slot])[i];
  }
}

__device__ __forceinline__ float load_f32(const Slots& s, int slot, long long i) {
  return ((const float*)s.values[slot])[i];
}

__device__ __forceinline__ unsigned load_valid(const Slots& s, int slot, long long i) {
  const uint8_t* v = s.valid[slot];
  return v == nullptr ? 1u : (v[i] != 0);
}

template <typename T>
__device__ __forceinline__ unsigned compare(T x, T t, int op) {
  // each op written out: x <= t is not !(x > t) when x is NaN
  switch (op) {
    case 0: return x == t;
    case 1: return x != t;
    case 2: return x < t;
    case 3: return x <= t;
    case 4: return x > t;
    default: return x >= t;
  }
}

__device__ __forceinline__ int floor_div(int x, int b) {  // b > 0
  int q = x / b;
  if ((x % b) != 0 && x < 0) --q;
  return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {  // int32 wrap, as torch's int32 add
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(kThreads)
    k3_mask_ids_kernel(const int* __restrict__ prog, const __grid_constant__ Slots slots,
                       long long n, uint8_t* __restrict__ mask, int* __restrict__ ids) {
  __shared__ int s_ins[kMaxInstr * kInstrWords];
  const int n_instr = min(prog[1], kMaxInstr);
  for (int i = threadIdx.x; i < n_instr * kInstrWords; i += blockDim.x) {
    s_ins[i] = prog[kHeaderWords + i];
  }
  __syncthreads();
  const uint8_t* data = (const uint8_t*)(prog + prog[3]);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += step) {
    unsigned val = 0, kn = 0, id = 0;
    for (int k = 0; k < n_instr; ++k) {
      const int* in = s_ins + k * kInstrWords;
      const int op = in[0], slot = in[1];
      unsigned v = 0, known = 1;
      switch (op) {
        case kLut: {
          const unsigned c = (unsigned)load_int(slots, slot, row);
          known = load_valid(slots, slot, row);
          v = known & (unsigned)(data[in[2] + (c & (unsigned)(in[3] - 1))] != 0);
          break;
        }
        case kCmpF32:
          known = load_valid(slots, slot, row);
          v = known & compare(load_f32(slots, slot, row), __int_as_float(in[3]), in[2]);
          break;
        case kCmpI32:
          known = load_valid(slots, slot, row);
          v = known & compare(load_int(slots, slot, row), in[3], in[2]);
          break;
        case kInF32:
        case kNotInF32: {
          const float x = load_f32(slots, slot, row);
          const float* items = (const float*)(data + in[2]);
          unsigned hit = 0;
          for (int j = 0; j < in[3]; ++j) hit |= (x == items[j]);
          known = load_valid(slots, slot, row);
          v = known & (op == kNotInF32 ? hit ^ 1u : hit);
          break;
        }
        case kIsNull: v = load_valid(slots, slot, row) ^ 1u; break;
        case kNotNull: v = load_valid(slots, slot, row); break;
        case kConst: v = in[2] != 0; break;
        case kAnd:
        case kOr: {
          const unsigned bv = val & 1u, bk = kn & 1u;
          const unsigned av = (val >> 1) & 1u, ak = (kn >> 1) & 1u;
          val >>= 2;
          kn >>= 2;
          if (op == kAnd) {  // FALSE on either side decides
            v = av & bv;
            known = (ak & bk) | (ak & (av ^ 1u)) | (bk & (bv ^ 1u));
          } else {  // TRUE on either side decides
            v = av | bv;
            known = (ak & bk) | av | bv;
          }
          break;
        }
        case kNot: {
          const unsigned av = val & 1u, ak = kn & 1u;
          val >>= 1;
          kn >>= 1;
          v = ak & (av ^ 1u);
          known = ak;
          break;
        }
        case kKeyDict: {
          const unsigned c = (unsigned)load_int(slots, slot, row);
          const int* remap = (const int*)(data + in[2]);
          const int r = remap[c & (unsigned)(in[3] - 1)];
          const int top = in[4] - 1;
          id += (unsigned)(r < top ? r : top) * (unsigned)in[5];
          continue;  // keys push nothing
        }
        case kKeyTime: {
          const int x = wrap_add(load_int(slots, slot, row), in[2]);
          int y = wrap_add(floor_div(x, in[3]), in[4]);
          const int top = in[5] - 1;
          y = y < 0 ? 0 : (y > top ? top : y);
          id += (unsigned)y * (unsigned)in[6];
          continue;
        }
        default: continue;
      }
      val = (val << 1) | v;
      kn = (kn << 1) | known;
    }
    mask[row] = (uint8_t)(val & 1u);
    if (ids != nullptr) ids[row] = (int)id;
  }
}

__global__ void __launch_bounds__(kThreads)
    k3_stack_operands_kernel(const int* __restrict__ prog, const __grid_constant__ Slots slots,
                             long long n, const uint8_t* __restrict__ mask,
                             float* __restrict__ frows, uint8_t* __restrict__ brows) {
  __shared__ int s_ops[kMaxOps * kOpWords];
  const int n_ops = min(prog[2], kMaxOps);
  const int* ops = prog + kHeaderWords + prog[1] * kInstrWords;
  for (int i = threadIdx.x; i < n_ops * kOpWords; i += blockDim.x) s_ops[i] = ops[i];
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += step) {
    const unsigned m = mask[row] != 0;
    for (int k = 0; k < n_ops; ++k) {
      const int* o = s_ops + k * kOpWords;
      const int op = o[0], slot = o[1], flags = o[2];
      const long long at = (long long)o[3] * n + row;
      float x = 0.0f;
      unsigned live = m;
      if (op != kRowMask) {
        live &= load_valid(slots, slot, row);
        if (op != kRowLive || (flags & kNanAware)) x = load_f32(slots, slot, row);
        if (flags & kNanAware) live &= isnan(x) ? 0u : 1u;
      }
      if (flags & kBoolOut) {
        brows[at] = (uint8_t)live;
      } else if (op == kRowMasked) {
        frows[at] = live ? x : 0.0f;
      } else if (op == kRowValue) {
        frows[at] = x;
      } else {
        frows[at] = live ? 1.0f : 0.0f;
      }
    }
  }
}

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

int grid_for(long long n) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  return clamp_grid(ceil_div(n, kThreads), 16LL * info.sms);
}

}  // namespace

extern "C" int k3_mask_ids(const int* prog, const unsigned long long* values,
                           const unsigned long long* valid, const int* dtypes, int n_slots,
                           long long n, uint8_t* mask, int* ids, void* stream) {
  Slots slots;
  cudaError_t err = make_slots(values, valid, dtypes, n_slots, &slots);
  if (err != cudaSuccess || n <= 0) return (int)err;
  k3_mask_ids_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(prog, slots, n, mask,
                                                                          ids);
  return (int)cudaGetLastError();
}

extern "C" int k3_stack_operands(const int* prog, const unsigned long long* values,
                                 const unsigned long long* valid, const int* dtypes, int n_slots,
                                 long long n, const uint8_t* mask, float* frows, uint8_t* brows,
                                 void* stream) {
  Slots slots;
  cudaError_t err = make_slots(values, valid, dtypes, n_slots, &slots);
  if (err != cudaSuccess || n <= 0) return (int)err;
  k3_stack_operands_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      prog, slots, n, mask, frows, brows);
  return (int)cudaGetLastError();
}
