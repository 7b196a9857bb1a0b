// Hand-written Hopper (sm_90a) kernels for the dense fold's statistics:
// count(distinct) and approx_distinct (K5), approximate percentiles (K6) and
// stddev/var (K7). Each reads one scanned block once, computes its
// elementwise prologue (LUT gathers, log2 bins, centring) as it loads, and
// folds straight into its accumulator. Main-path blocks hold N = 2^20 rows;
// ids are the block's dense group ids in [0, G), rows outside [0, G) or with
// their mask byte 0 are dropped.
//
// K5, distinct_fold: acc[g * cap + slot(code)] = max(acc, value).
//   Replaces the segment_max of parseable_tpu/query/executor_tpu.py:2931-2953
//   (and parseable_tpu/ops/kernels.py:51 masked_distinct_bitmap). Presence
//   (count(distinct)): slot = min(lut[code], cap - 1) over the global
//   dictionary remap, value 1. HLL (approx_distinct, cap = 4096): slot =
//   min(lut_idx[code], cap - 1), value = lut_rank[code] (0 is a no-op). With
//   no LUT the code is the slot (masked_distinct_bitmap). Codes are the
//   block's int8/int16/int32 dictionary codes; a code outside [0, V) drops
//   its row.
//   Bound: bytes, N (4 + code bytes + 1) read plus the LUT and the entries
//   the rows reach; 6 B a row with int8 codes, 1.9 us per 2^20 rows at
//   3.35 TB/s.
//   Design: non-negative f32 values order as their u32 bits, so HLL ranks
//   fold with an unsigned atomicMax, and a plain read first skips the atomic
//   when the register already holds as much (most updates once the
//   registers warm up). Presence is an idempotent store of 1.0f: no atomic.
//   Up to 8,192 entries (ops/stats_cuda.py distinct_regime) each CTA keeps a
//   private copy in shared memory and flushes its nonzero entries: a minute
//   file reaches few entries, and in global memory every row would re-read
//   them from L2 (7x slower on the main path's presence inputs). Past that
//   the rows fold into the accumulator in global memory, since every CTA
//   zeroes and flushes its whole copy (a G = 8 HLL file of 32,768 registers
//   took 67 us shared, 18 us global).
//
// K6, pct_histogram: out[g * 2049 + slot(v)] += 1 over live rows whose value
//   is not NaN. Replaces parseable_tpu/query/executor_tpu.py:2954-2981. The
//   slot is computed with the JAX fold's f32 arithmetic: log2f(|v|) (built
//   without fast math), clipped to [lo, hi], (mag - lo) * scale truncated
//   toward zero and clamped to [0, 1023]; v == 0 takes slot 2048, v > 0 slot
//   1024 + bin, v < 0 slot bin (query/sketch.py DEVICE_NB layout). A
//   subnormal value counts as 0, as in the JAX fold, whose XLA programs
//   treat subnormals as zero (on the TPU and on the CPU alike).
//   Bound: bytes, N (4 + 4 + 1) read, 2.8 us per 2^20 rows.
//   Design: the main path's values pile into a few bins (a uniform latency
//   puts half of every group's rows into the ~12 bins of [256, 500)), so
//   increments are warp-aggregated when a ballot finds a crowded slot
//   (__match_any_sync, one add of the peer count by the lowest lane). Per-CTA
//   u32 histograms in shared memory where G*2049*4 bytes fit (G <= 24),
//   global f32 atomics past that.
//
// K7, centered_m2: m2[q, g] = sum over live, valid rows of (v - mean[q, g])^2.
//   Replaces parseable_tpu/query/executor_tpu.py:889 _block_m2 (the
//   segment_sum of centred squares; the Chan merge :938 stays elementwise in
//   the caller). mean is this block's per-group mean, sums / max(count, 1)
//   from kernel A's outputs, computed on the stream by the caller.
//   Bound: bytes, N (4 + 1 + 5 Q) read, 3.1 us per value row and 2^20 rows.
//   Design: kernel A's atomic regimes: a per-CTA [Q, G] f32 accumulator (with
//   the means beside it) in shared memory where it fits, global atomics past
//   it, warp-adaptive aggregation of each row's square over the lanes that
//   share a group when a ballot finds a crowded group (the main path's
//   status key puts half of the rows in one group).
//
// Interface: plain C, called through ctypes. Every pointer is a device
// pointer; `stream` is the caller's cudaStream_t; `mode` is the wrapper's
// regime choice (0 shared, 1 global). Each entry returns cudaGetLastError()
// after its launch (0 on success), or cudaErrorInvalidValue for a shape the
// regime does not fit.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 1024;           // query/sketch.py BINS
constexpr int kNB = 2 * kBins + 1;    // query/sketch.py DEVICE_NB
constexpr unsigned kOne = 0x3F800000u;  // 1.0f

enum Mode { kShared = 0, kGlobal = 1 };

// Launches `kernel` over N rows, one row a thread, with `smem` bytes of
// private accumulator: as many CTAs as the card holds at once with it, or
// 8 a SM for global atomics (smem 0).
template <typename Launch>
cudaError_t launch(const void* kernel, int smem, long long n, Launch go) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  if (smem > smem_budget(info)) return cudaErrorInvalidValue;
  long long cap = (long long)info.sms * 8;
  if (smem > 0) {
    int per_sm = 0;
    const cudaError_t err = resident_ctas(dev, kernel, kThreads, smem, &per_sm);
    if (err != cudaSuccess) return err;
    cap = (long long)per_sm * info.sms;
  }
  go(clamp_grid(ceil_div(n, kThreads), cap));
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K5

template <typename C, int MODE>
__global__ void __launch_bounds__(kThreads)
    distinct_kernel(const int* __restrict__ ids, const C* __restrict__ codes,
                    const uint8_t* __restrict__ mask, const int* __restrict__ lut_idx,
                    const int* __restrict__ lut_rank, int V, int cap, int G, long long N,
                    unsigned* __restrict__ acc) {
  extern __shared__ unsigned local[];  // kShared: [G * cap]
  const long long slots = (long long)G * cap;
  if (MODE == kShared) {
    for (long long j = threadIdx.x; j < slots; j += blockDim.x) local[j] = 0u;
    __syncthreads();
  }
  unsigned* dst = MODE == kShared ? local : acc;
  const bool hll = lut_rank != nullptr;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x) {
    if (!mask[i]) continue;
    const int g = ids[i];
    const int c = (int)codes[i];
    if ((unsigned)g >= (unsigned)G || (unsigned)c >= (unsigned)V) continue;
    int slot = lut_idx ? __ldg(lut_idx + c) : c;
    slot = slot < cap - 1 ? slot : cap - 1;
    if (slot < 0) continue;
    unsigned* p = dst + (long long)g * cap + slot;
    if (hll) {
      const int rank = __ldg(lut_rank + c);
      if (rank <= 0) continue;
      const unsigned val = __float_as_uint((float)rank);
      if (val > (MODE == kShared ? *p : __ldcg(p))) atomicMax(p, val);
    } else if ((MODE == kShared ? *p : __ldcg(p)) != kOne) {
      *p = kOne;
    }
  }
  if (MODE == kGlobal) return;
  __syncthreads();
  for (long long j = threadIdx.x; j < slots; j += blockDim.x) {
    const unsigned x = local[j];
    if (x == 0u) continue;
    if (hll) {
      if (x > __ldcg(acc + j)) atomicMax(acc + j, x);
    } else if (__ldcg(acc + j) != kOne) {
      acc[j] = kOne;
    }
  }
}

template <typename C>
cudaError_t launch_distinct(const int* ids, const C* codes, const uint8_t* mask,
                            const int* lut_idx, const int* lut_rank, int V, int cap, int G,
                            long long N, unsigned* acc, int mode, cudaStream_t s) {
  if (mode == kShared) {
    const long long smem = (long long)G * cap * 4;
    if (smem > kSmemCap) return cudaErrorInvalidValue;
    const void* fn = (const void*)distinct_kernel<C, kShared>;
    return launch(fn, (int)smem, N, [&](int grid) {
      distinct_kernel<C, kShared><<<grid, kThreads, (size_t)smem, s>>>(ids, codes, mask, lut_idx,
                                                                       lut_rank, V, cap, G, N, acc);
    });
  }
  const void* fn = (const void*)distinct_kernel<C, kGlobal>;
  return launch(fn, 0, N, [&](int grid) {
    distinct_kernel<C, kGlobal><<<grid, kThreads, 0, s>>>(ids, codes, mask, lut_idx, lut_rank, V,
                                                          cap, G, N, acc);
  });
}

// ------------------------------------------------------------------ K6

// The JAX fold's slot of a non-NaN value, in the same f32 arithmetic.
__device__ __forceinline__ int pct_slot(float x, float lo, float hi, float scale) {
  if (fabsf(x) < FLT_MIN) return 2 * kBins;  // zero or subnormal
  float mag = log2f(fabsf(x));
  mag = fminf(fmaxf(mag, lo), hi);
  int b = (int)__fmul_rn(__fsub_rn(mag, lo), scale);
  b = b < 0 ? 0 : (b > kBins - 1 ? kBins - 1 : b);
  return x > 0.f ? kBins + b : b;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    pct_hist_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                    const uint8_t* __restrict__ mask, int G, long long N, float lo, float hi,
                    float scale, float* __restrict__ out) {
  extern __shared__ unsigned hist[];  // kShared: [G * kNB] counts
  const int slots = G * kNB;
  if (MODE == kShared) {
    for (int j = threadIdx.x; j < slots; j += blockDim.x) hist[j] = 0u;
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  // warp-uniform loop: every lane takes part in the match
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < N;
       base += step) {
    const long long i = base + (threadIdx.x & 31);
    int slot = -1;
    if (i < N && mask[i]) {
      const float x = vals[i];
      const int g = ids[i];
      if (x == x && (unsigned)g < (unsigned)G) slot = g * kNB + pct_slot(x, lo, hi, scale);
    }
    unsigned n = 1;
    bool leader = true;
    if (crowded(slot)) {
      const unsigned peers = __match_any_sync(kFull, slot);
      n = __popc(peers);
      leader = (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0u;
    }
    if (slot < 0 || !leader) continue;
    if (MODE == kShared) {
      atomicAdd(hist + slot, n);
    } else {
      atomicAdd(out + slot, (float)n);
    }
  }
  if (MODE == kGlobal) return;
  __syncthreads();
  for (int j = threadIdx.x; j < slots; j += blockDim.x) {
    const unsigned c = hist[j];
    if (c) atomicAdd(out + j, (float)c);
  }
}

// ------------------------------------------------------------------ K7

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    m2_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ mask, const int* __restrict__ ids,
              const float* __restrict__ mean, int Q, int G, long long N, float* __restrict__ out) {
  extern __shared__ float sm[];  // kShared: [Q * G] sums, then [Q * G] means
  const int qg = Q * G;
  if (MODE == kShared) {
    for (int j = threadIdx.x; j < qg; j += blockDim.x) {
      sm[j] = 0.f;
      sm[qg + j] = mean[j];
    }
    __syncthreads();
  }
  float* dst = MODE == kShared ? sm : out;
  const float* mu = MODE == kShared ? sm + qg : mean;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < N;
       base += step) {
    const long long i = base + (threadIdx.x & 31);
    int g = -1;
    if (i < N && mask[i]) {
      g = ids[i];
      if ((unsigned)g >= (unsigned)G) g = -1;
    }
    const Peers peers = fold_peers(g, crowded(g));
    for (int q = 0; q < Q; ++q) {
      float d2 = 0.f;
      if (g >= 0 && valid[(long long)q * N + i]) {
        const float d = __fsub_rn(vals[(long long)q * N + i], mu[q * G + g]);
        d2 = __fmul_rn(d, d);
      }
      d2 = peer_reduce(d2, peers, [](float a, float b) { return a + b; });
      if (g >= 0 && peers.leader && d2 != 0.f) atomicAdd(dst + q * G + g, d2);
    }
  }
  if (MODE == kGlobal) return;
  __syncthreads();
  for (int j = threadIdx.x; j < qg; j += blockDim.x) {
    const float x = sm[j];
    if (x != 0.f) atomicAdd(out + j, x);
  }
}

}  // namespace

// acc: f32 [G * cap], folded in place. code_bytes: 1, 2 or 4. lut_idx null:
// the code is the slot; lut_rank null: presence (value 1).
extern "C" int distinct_fold(const int* ids, const void* codes, int code_bytes,
                             const uint8_t* mask, const int* lut_idx, const int* lut_rank, int V,
                             int cap, int G, long long N, float* acc, int mode, void* stream) {
  if (G <= 0 || cap <= 0 || N <= 0) return (int)cudaGetLastError();
  if (mode != kShared && mode != kGlobal) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned* a = reinterpret_cast<unsigned*>(acc);
  switch (code_bytes) {
    case 1:
      return (int)launch_distinct(ids, (const int8_t*)codes, mask, lut_idx, lut_rank, V, cap, G, N,
                                  a, mode, s);
    case 2:
      return (int)launch_distinct(ids, (const int16_t*)codes, mask, lut_idx, lut_rank, V, cap, G,
                                  N, a, mode, s);
    case 4:
      return (int)launch_distinct(ids, (const int32_t*)codes, mask, lut_idx, lut_rank, V, cap, G,
                                  N, a, mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out: f32 [G * 2049], added to in place.
extern "C" int pct_histogram(const float* vals, const int* ids, const uint8_t* mask, int G,
                             long long N, float lo, float hi, float scale, float* out, int mode,
                             void* stream) {
  if (G <= 0 || N <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kShared) {
    const long long smem = (long long)G * kNB * 4;
    if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
    return (int)launch((const void*)pct_hist_kernel<kShared>, (int)smem, N, [&](int grid) {
      pct_hist_kernel<kShared><<<grid, kThreads, (size_t)smem, s>>>(vals, ids, mask, G, N, lo, hi,
                                                                   scale, out);
    });
  }
  if (mode != kGlobal) return (int)cudaErrorInvalidValue;
  return (int)launch((const void*)pct_hist_kernel<kGlobal>, 0, N, [&](int grid) {
    pct_hist_kernel<kGlobal><<<grid, kThreads, 0, s>>>(vals, ids, mask, G, N, lo, hi, scale, out);
  });
}

// vals f32 [Q, N], valid u8 [Q, N], mean f32 [Q, G]; out f32 [Q, G], zeroed
// here first.
extern "C" int centered_m2(const float* vals, const uint8_t* valid, const uint8_t* mask,
                           const int* ids, const float* mean, int Q, int G, long long N,
                           float* out, int mode, void* stream) {
  if (Q <= 0 || G <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)Q * G * sizeof(float), s);
  if (err != cudaSuccess || N <= 0) return (int)err;
  if (mode == kShared) {
    const long long smem = 2LL * Q * G * 4;
    if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
    return (int)launch((const void*)m2_kernel<kShared>, (int)smem, N, [&](int grid) {
      m2_kernel<kShared><<<grid, kThreads, (size_t)smem, s>>>(vals, valid, mask, ids, mean, Q, G,
                                                             N, out);
    });
  }
  if (mode != kGlobal) return (int)cudaErrorInvalidValue;
  return (int)launch((const void*)m2_kernel<kGlobal>, 0, N, [&](int grid) {
    m2_kernel<kGlobal><<<grid, kThreads, 0, s>>>(vals, valid, mask, ids, mean, Q, G, N, out);
  });
}
