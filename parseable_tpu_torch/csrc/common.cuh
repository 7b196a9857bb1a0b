// Host caches and warp helpers shared by the port's CUDA sources
// (groupby.cu, stats.cu): device attributes and occupancy read once, grid
// clamps, a vector reduction into global memory, and the warp-adaptive
// aggregation of lanes that share a key. Every name is in an anonymous
// namespace: each library has its own copy.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kAggLanes = 6;           // group size from which a warp aggregates
constexpr int kSmemCap = 200 * 1024;   // bytes of dynamic shared memory a CTA may ask for
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ host caches

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  int smem_per_sm = 0;    // shared memory of one SM
  int smem_reserved = 0;  // of it, reserved by the system for each CTA
};

std::mutex g_mu;
std::map<int, DeviceInfo> g_info;
std::map<std::tuple<int, const void*, int, int>, int> g_resident;
std::map<std::pair<int, const void*>, int> g_smem_set;

DeviceInfo device_info(int dev) {
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_info.find(dev);
  if (it != g_info.end()) return it->second;
  DeviceInfo info;
  cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&info.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&info.smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  g_info[dev] = info;
  return info;
}

int smem_budget(const DeviceInfo& info) {
  return info.smem_optin < kSmemCap ? info.smem_optin : kSmemCap;
}

// CTAs of `kernel` that one SM holds at `threads` x `smem` bytes of dynamic
// shared memory; raises the kernel's shared-memory limit first when needed.
cudaError_t resident_ctas(int dev, const void* kernel, int threads, int smem, int* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  const auto key = std::make_tuple(dev, kernel, threads, smem);
  auto it = g_resident.find(key);
  if (it != g_resident.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  int& limit = g_smem_set[std::make_pair(dev, kernel)];
  if (smem > limit) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                                  (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  g_resident[key] = per_sm;
  *out = per_sm;
  return cudaSuccess;
}

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

int clamp_grid(long long ctas, long long cap) {
  if (ctas > cap) ctas = cap;
  return ctas < 1 ? 1 : (int)ctas;
}

// ------------------------------------------------------------ warp helpers

// Lanes of the warp that share `key`, and the next higher lane among them
// (-1 for the highest). Every lane of the warp must call it.
struct Peers {
  int next;
  int steps;  // pointer-jumping steps the largest group of the warp needs
  bool leader;
};

__device__ __forceinline__ Peers warp_peers(int key) {
  const int lane = threadIdx.x & 31;
  Peers p;
  const unsigned mask = __match_any_sync(kFull, key);
  const unsigned above = mask & (0xFFFFFFFEu << lane);
  p.next = above ? __ffs(above) - 1 : -1;
  const int most = (int)__reduce_max_sync(kFull, (unsigned)__popc(mask));
  p.steps = 32 - __clz(most - 1);
  p.leader = (mask & ((1u << lane) - 1u)) == 0u;
  return p;
}

// Warp-adaptive aggregation: a warp matches its ids only when a quick test
// on the first row of its step finds a crowded group, one of at least
// kAggLanes lanes among the groups of three probe lanes (a shuffle and a
// ballot each); otherwise every lane is a group of its own and a fold costs
// no match. Skewed ids (a constant time bin, status 200 on half of the rows)
// pay one atomic per distinct id; spread ids, where a match costs more than
// the collisions it saves, pay three ballots a step.
__device__ __forceinline__ bool crowded(int key) {
  int most = 0;
#pragma unroll
  for (int src = 0; src < 32; src += 11) {
    const int probe = __shfl_sync(kFull, key, src);
    const int n = __popc(__ballot_sync(kFull, key == probe));
    most = n > most ? n : most;
  }
  return most >= kAggLanes;
}

__device__ __forceinline__ Peers fold_peers(int key, bool crowd) {
  if (crowd) return warp_peers(key);
  Peers solo;
  solo.next = -1;
  solo.steps = 0;
  solo.leader = true;
  return solo;
}

// A vector reduction into global memory (sm_90): one L2 atomic operation
// adds four consecutive f32 (16-byte aligned) and returns nothing.
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
}

// `v` combined by `op` over the lanes that share this lane's key, by pointer
// jumping: after step s each lane holds the combination of 2^s consecutive
// peers from itself, so the lowest lane (the leader) ends with all of them.
// Every lane of the warp must call it.
template <typename T, typename Op>
__device__ __forceinline__ T peer_reduce(T v, const Peers& p, Op op) {
  int next = p.next;
  for (int s = 0; s < p.steps; ++s) {
    const int src = next < 0 ? 0 : next;
    const T o = __shfl_sync(kFull, v, src);
    const int after = __shfl_sync(kFull, next, src);
    if (next >= 0) {
      v = op(v, o);
      next = after;
    }
  }
  return v;
}

}  // namespace
