// Hand-written Hopper (sm_90a) kernels for the per-block group-by.
//
// One scanned block of the dense aggregate path reduces into a [rows, groups]
// partial aggregate. These two kernels compute all of it:
//
// Kernel A, additive_groupby: out[R, G] = rows[R, N] @ onehot(ids)[N, G].
//   Replaces parseable_tpu/ops/pallas_groupby.py:53 additive_groupby_pallas
//   (body _additive_kernel :33, pallas_call :63), the additive half of
//   parseable_tpu/ops/kernels.py:108 fused_groupby_block. The rows are
//   [row mask | per-aggregate validity | masked sums].
//   Bound: bytes. It must read ids and rows once, 4N(R+1) bytes, and does R*N
//   adds, far below the card's f32 rate; at N = 2^20, R = 5 that is 25 MB, or
//   7.5 us at 3.35 TB/s.
//   Design: the TPU kernel walks 2048-row tiles in order and carries the
//   [R, G] sum in VMEM from one grid step to the next. Blocks on the card run
//   in no order and share nothing, so each CTA keeps its own [R, G] f32
//   accumulator in shared memory, walks rows with a grid-stride loop, adds
//   with shared-memory atomics, and flushes its nonzero entries into the
//   output with one global atomicAdd each. When R*G*4 bytes exceed the
//   shared-memory budget (the multi-key path: path x host reaches G = 2048
//   and more), each row adds straight into global memory instead. The CTA
//   count keeps the flush small against the rows each CTA reads.
//   Numbers: counts are sums of 0/1 in f32, exact below 2^24 in any order (a
//   block holds at most 2^22 rows); sums are plain f32 adds, no TF32 or bf16.
//   Ids outside [0, G) are dropped, as the one-hot product drops them.
//
// Kernel B, minmax_groupby: per-group min of the first n_min value rows and
//   max of the rest, with the semantics of kernels.py:233-248 (segment_min /
//   segment_max): a row that is masked off or invalid contributes +F32_MAX to
//   a min and -F32_MAX to a max; a group no row reaches keeps the identity,
//   +inf for a min and -inf for a max.
//   Bound: bytes. It reads ids, K value rows, K validity rows and the mask,
//   N(4 + 5K + 1) bytes, and writes 4KG.
//   Design: f32 maps to an order-preserving int32 key, so min and max become
//   integer atomicMin / atomicMax, exact in any order. Each CTA keeps [K, G]
//   keys in shared memory and flushes them into a global key buffer, or adds
//   straight into the global buffer when K*G*4 exceeds the budget. A plain
//   read before each atomic skips the atomics that cannot change the value
//   (keys only move one way). A last pass decodes the keys to f32.
//
// Interface: plain C, called through ctypes. Every pointer is a device
// pointer; `stream` is the caller's cudaStream_t. The output buffers are
// allocated by the caller; A's output must be zeroed. Each entry returns
// cudaGetLastError() after its launches (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemCap = 200 * 1024;  // bytes of dynamic shared memory a CTA may ask for
constexpr float kF32Max = 3.4e38f;

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

DeviceInfo device_info() {
  DeviceInfo info;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return info;
}

int smem_budget(const DeviceInfo& info) {
  return info.smem_optin < kSmemCap ? info.smem_optin : kSmemCap;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// CTAs for a privatised-accumulator kernel: each CTA should read several
// times more rows than the `entries` it flushes, but the grid should still
// cover every SM while there are rows for it.
int privatised_grid(long long n, long long entries, int max_resident, int sms) {
  long long per_cta = entries * 4;
  if (per_cta < 4LL * kThreads) per_cta = 4LL * kThreads;
  long long ctas = ceil_div(n, per_cta);
  long long fill = ceil_div(n, kThreads);
  if (fill > sms) fill = sms;
  if (ctas < fill) ctas = fill;
  if (ctas > max_resident) ctas = max_resident;
  return ctas < 1 ? 1 : (int)ctas;
}

int streaming_grid(long long n, int sms) {
  long long ctas = ceil_div(n, kThreads);
  long long cap = (long long)sms * 16;
  if (ctas > cap) ctas = cap;
  return ctas < 1 ? 1 : (int)ctas;
}

// ------------------------------------------------------------------ kernel A

__global__ void additive_smem_kernel(const int* __restrict__ ids,
                                     const float* __restrict__ rows,
                                     float* __restrict__ out, int R, long long N,
                                     int G) {
  extern __shared__ float acc[];  // [R * G]
  const int rg = R * G;
  for (int j = threadIdx.x; j < rg; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int g = ids[i];
    if ((unsigned)g >= (unsigned)G) continue;
    for (int r = 0; r < R; ++r) {
      const float v = rows[(long long)r * N + i];
      if (v != 0.f) atomicAdd(&acc[r * G + g], v);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rg; j += blockDim.x) {
    const float v = acc[j];
    if (v != 0.f) atomicAdd(&out[j], v);
  }
}

__global__ void additive_global_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ rows,
                                       float* __restrict__ out, int R,
                                       long long N, int G) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int g = ids[i];
    if ((unsigned)g >= (unsigned)G) continue;
    for (int r = 0; r < R; ++r) {
      const float v = rows[(long long)r * N + i];
      if (v != 0.f) atomicAdd(&out[(long long)r * G + g], v);
    }
  }
}

// ------------------------------------------------------------------ kernel B

__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

__device__ __forceinline__ int identity_key(bool is_min) {
  return is_min ? order_key(INFINITY) : order_key(-INFINITY);
}

// fold one key into *p: min for the first n_min rows, max for the rest
__device__ __forceinline__ void fold_key(int* p, int key, bool is_min) {
  if (is_min) {
    if (key < *p) atomicMin(p, key);
  } else {
    if (key > *p) atomicMax(p, key);
  }
}

__device__ __forceinline__ int row_key(const float* __restrict__ vals,
                                       const uint8_t* __restrict__ valid,
                                       bool live, int k, long long N, long long i,
                                       bool is_min) {
  const long long at = (long long)k * N + i;
  const bool ok = live && valid[at] != 0;
  return order_key(ok ? vals[at] : (is_min ? kF32Max : -kF32Max));
}

__global__ void minmax_init_kernel(int* __restrict__ keys, int K, int n_min,
                                   int G) {
  const long long total = (long long)K * G;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (long long)gridDim.x * blockDim.x) {
    keys[j] = identity_key(j / G < n_min);
  }
}

__global__ void minmax_smem_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ vals,
                                   const uint8_t* __restrict__ valid,
                                   const uint8_t* __restrict__ mask,
                                   int* __restrict__ keys, int K, int n_min,
                                   long long N, int G) {
  extern __shared__ int local[];  // [K * G]
  const int kg = K * G;
  for (int j = threadIdx.x; j < kg; j += blockDim.x)
    local[j] = identity_key(j / G < n_min);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int g = ids[i];
    if ((unsigned)g >= (unsigned)G) continue;
    const bool live = mask[i] != 0;
    for (int k = 0; k < K; ++k) {
      const bool is_min = k < n_min;
      fold_key(&local[k * G + g], row_key(vals, valid, live, k, N, i, is_min), is_min);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kg; j += blockDim.x) {
    const bool is_min = j / G < n_min;
    const int key = local[j];
    if (key != identity_key(is_min)) fold_key(&keys[j], key, is_min);
  }
}

__global__ void minmax_global_kernel(const int* __restrict__ ids,
                                     const float* __restrict__ vals,
                                     const uint8_t* __restrict__ valid,
                                     const uint8_t* __restrict__ mask,
                                     int* __restrict__ keys, int K, int n_min,
                                     long long N, int G) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    const int g = ids[i];
    if ((unsigned)g >= (unsigned)G) continue;
    const bool live = mask[i] != 0;
    for (int k = 0; k < K; ++k) {
      const bool is_min = k < n_min;
      fold_key(&keys[(long long)k * G + g], row_key(vals, valid, live, k, N, i, is_min),
               is_min);
    }
  }
}

__global__ void minmax_decode_kernel(const int* __restrict__ keys,
                                     float* __restrict__ out, long long total) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (long long)gridDim.x * blockDim.x) {
    out[j] = key_value(keys[j]);
  }
}

}  // namespace

extern "C" int additive_groupby(const int* ids, const float* rows, float* out,
                                int R, long long N, int G, void* stream) {
  if (R <= 0 || N <= 0 || G <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const DeviceInfo info = device_info();
  const long long smem = (long long)R * G * sizeof(float);
  if (smem <= smem_budget(info)) {
    cudaError_t err = cudaFuncSetAttribute(
        additive_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, additive_smem_kernel,
                                                  kThreads, (size_t)smem);
    if (per_sm < 1) per_sm = 1;
    const int grid = privatised_grid(N, (long long)R * G, per_sm * info.sms, info.sms);
    additive_smem_kernel<<<grid, kThreads, (size_t)smem, s>>>(ids, rows, out, R, N, G);
  } else {
    additive_global_kernel<<<streaming_grid(N, info.sms), kThreads, 0, s>>>(ids, rows, out,
                                                                              R, N, G);
  }
  return (int)cudaGetLastError();
}

extern "C" int minmax_groupby(const int* ids, const float* vals, const uint8_t* valid,
                              const uint8_t* mask, int* keys, float* out, int K,
                              int n_min, long long N, int G, void* stream) {
  if (K <= 0 || G <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const DeviceInfo info = device_info();
  const long long total = (long long)K * G;
  const int flat_grid = streaming_grid(total, info.sms);
  minmax_init_kernel<<<flat_grid, kThreads, 0, s>>>(keys, K, n_min, G);
  if (N > 0) {
    const long long smem = total * sizeof(int);
    if (smem <= smem_budget(info)) {
      cudaError_t err = cudaFuncSetAttribute(
          minmax_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      int per_sm = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, minmax_smem_kernel,
                                                    kThreads, (size_t)smem);
      if (per_sm < 1) per_sm = 1;
      const int grid = privatised_grid(N, total, per_sm * info.sms, info.sms);
      minmax_smem_kernel<<<grid, kThreads, (size_t)smem, s>>>(ids, vals, valid, mask, keys,
                                                              K, n_min, N, G);
    } else {
      minmax_global_kernel<<<streaming_grid(N, info.sms), kThreads, 0, s>>>(
          ids, vals, valid, mask, keys, K, n_min, N, G);
    }
  }
  minmax_decode_kernel<<<flat_grid, kThreads, 0, s>>>(keys, out, total);
  return (int)cudaGetLastError();
}
