// Hand-written Hopper (sm_90a) kernels of the device top-k (K8).
//
// Replaces the XLA program of parseable_tpu/query/executor_tpu.py:2165
// _run_topk_program (its `run`, :2199-2246) with parseable_tpu/ops/kernels.py
// :71 topk (lax.top_k): for ORDER BY <aggregate> LIMIT k over the dense
// accumulator acc f32 [R, G], pick the k groups with the largest sort keys
// and gather their columns, so that only [R, k] and k ids cross back to the
// host instead of the G-sized accumulator.
//
// What it computes, per group g (parseable_tpu_torch/ops/topk_cuda.py
// topk_groups_plain is the same in torch ops):
// - the aggregate's value: the value row itself, avg = sum / max(pac, 1),
//   var = max(M2 / (max(pac, 2) - 1), 0), stddev = its sqrt; in f32 with
//   IEEE division and square root (no fast-math) and NaN kept by max;
// - an int32 score: the f32 bits mapped to a monotone int32 (an ascending
//   order negates it), and below every real key, in this order, a NaN key,
//   a NULL aggregate (pac 0, or pac < 2 for var/stddev) and an empty slot
//   (count 0) (ADVICE r3 #1, JAX :2219-2244);
// - a u64 key unique per group: (score ^ 0x80000000) << 32 | (~0u - g). The
//   k largest keys are exactly lax.top_k's picks, in its order: the larger
//   score first, the lower index first among equal scores.
//
// Bound: bytes. The function reads the rows its score needs (count, pac,
// value, M2: up to 4 x 4 bytes a group) and the k gathered columns, and
// writes [R, k] f32 and k int32: 1.5 MB at the main path's R=3 G=2^17, a
// bound under 1 us. What costs is latency: dependent launches and grid-wide
// handoffs. Two regimes (`topk_cuda.topk_regime(G, k)`):
//
// "block" (k <= kBlockMaxK, G <= topk_cuda.TOPK_BLOCK_MAX_G): ONE launch,
// k8_block. A grid of min(ceil(G / 512), SMs) CTAs of 512 threads, each a
// contiguous slice of groups (`topk_cuda.block_grid`):
// 1. the CTA scores its slice into shared memory (coalesced loads of the
//    rows the score needs, 4 bytes a group);
// 2. block_cut: an MSB radix select on the 32-bit score word, 8 bits a pass,
//    over shared memory (one shared atomic an item), which stops as soon as
//    the bucket it lands in holds exactly the keys still needed; no global
//    histogram, no global atomic per key;
// 3. block_take: a stable compaction (one block scan) writes the slice's
//    top min(k, slice) by (score, lower index), in index order, as u64 keys
//    to the CTA's slots of a candidate buffer (pad slots 0). Every global
//    top-k key is in its own slice's top k;
// 4. the last CTA to finish (a ticket behind __threadfence, as kernel B's
//    decode) loads the candidates into shared memory (cp.async, every copy
//    in flight at once: the merge is one CTA, and a load a step left it
//    latency-bound) and runs the same cut and compaction over them: the
//    buffer holds them in index order, so ties at the cut still go to the
//    lower index, and pads are never picked. Each of the k winners' threads
//    counts the keys above its own (keys are unique) for its rank, the CTA
//    gathers out[r, j] = acc[r, ids[j]], writes the ids, and resets the
//    ticket for the next call, so the wrapper launches no memset.
//
// "radix" (any k up to kMaxK = 4,096, any G): the first design, 12
// dependent launches:
// 1. k8_score: one thread a group writes its u64 key (8 bytes a group) and
//    CTA 0 resets the select state;
// 2. k8_select, 8 launches, one a byte of the key from the top: an MSB
//    radix select. Each CTA histograms, in shared memory, the byte of the
//    keys that match the prefix found so far, adds its 256 counts into a
//    global histogram, and the last CTA to finish (a ticket counter) finds,
//    with one warp, the bucket that holds the k-th largest key and extends
//    the prefix. After the 8th byte the prefix IS the k-th largest key T
//    (keys are unique);
// 3. k8_compact: every key >= T (exactly k) goes to a list of k, in any
//    order (an atomic slot counter);
// 4. k8_sort: one CTA sorts the k keys descending, a bitonic sort over the
//    next power of two (<= 4,096 x 8 bytes = 32 KB of shared memory; the
//    pad keys are 0, below every real key, whose low word is ~0u - g > 0),
//    and writes the ids;
// 5. k8_gather: out[r, j] = acc[r, ids[j]].
// No library top-k or sort is called; the wrapper allocates every buffer,
// and keeps the block regime's ticket (zeroed once) for each stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kMaxK = 4096;  // topk_cuda.TOPK_MAX_K
constexpr int kBins = 256;
constexpr int kBlockThreads = 512;  // topk_cuda.BLOCK_THREADS
constexpr int kBlockMaxK = 128;     // topk_cuda.TOPK_BLOCK_MAX_K

// the select state, in u32 words of the wrapper's scratch tensor
struct State {
  unsigned long long prefix;  // the key bytes found so far
  unsigned long long mask;    // which bytes they are
  unsigned remaining;         // rank of T among the keys that match the prefix
  unsigned done;              // CTAs finished in this pass (the ticket)
  unsigned count;             // keys the compaction has written
  unsigned pad;
  unsigned hist[kBins];
};
static_assert(sizeof(State) == 264 * 4, "topk_cuda.STATE_WORDS");

enum KeyMode { kValue = 0, kAvg = 1, kVar = 2, kStddev = 3 };
enum NullMode { kPacPositive = 0, kPacAboveOne = 1, kCountPositive = 2 };

__device__ __forceinline__ float max_nan(float a, float b) {  // jnp.maximum: NaN wins
  return a != a ? a : (a < b ? b : a);
}

__device__ __forceinline__ int score_of(const float* __restrict__ acc, long long g, long long G,
                                        int key_mode, int null_mode, int val_row, int pac_row,
                                        int sq_row, int desc) {
  const float count = acc[g];
  const float pacv = acc[(long long)pac_row * G + g];
  float keyv;
  if (key_mode == kAvg) {
    keyv = __fdiv_rn(acc[(long long)val_row * G + g], max_nan(pacv, 1.0f));
  } else if (key_mode == kVar || key_mode == kStddev) {
    const float n = max_nan(pacv, 2.0f);
    keyv = max_nan(__fdiv_rn(acc[(long long)sq_row * G + g], __fsub_rn(n, 1.0f)), 0.0f);
    if (key_mode == kStddev) keyv = __fsqrt_rn(keyv);
  } else {
    keyv = acc[(long long)val_row * G + g];
  }
  const bool notnull = null_mode == kPacPositive   ? pacv > 0.0f
                       : null_mode == kPacAboveOne ? pacv > 1.0f
                                                   : count > 0.0f;
  const bool occupied = count > 0.0f;
  const bool live = occupied && notnull;
  if (live && !isnan(keyv)) {
    const int bits = __float_as_int(keyv);
    const int u = bits >= 0 ? bits : (int)(0x80000000u - (unsigned)bits);
    if (desc) return u;
    return u == INT_MIN ? INT_MAX : -u;
  }
  if (live) return -2139095339;     // NaN key: below every real key
  if (occupied) return -2147483647;  // NULL aggregate
  return INT_MIN;                    // empty slot
}

// the u64 key of group g: its score's order, then the lower index
__device__ __forceinline__ unsigned long long key_of(int score, long long g) {
  return ((unsigned long long)((unsigned)score ^ 0x80000000u) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned)g);
}

// ------------------------------------------------------------ "block" regime

// The cut of a block select: item p is picked iff (w & mask) > prefix, or
// (w & mask) == prefix and fewer than `remaining` such items come before it.
struct Cut {
  unsigned prefix;
  unsigned mask;
  unsigned remaining;
};

struct BlockShared {
  unsigned hist[kBins];
  unsigned long long warp_sums[kBlockThreads / 32];
  Cut cut;
  unsigned done;  // the bucket holds exactly the items still needed
  unsigned last;
  unsigned long long top[kBlockMaxK];
  int ids[kBlockMaxK];
};

// The cut of the m largest words among the items [0, n) that `word` admits
// (word(p, w) sets w and returns false for a pad), the lower position first
// among equal words. An MSB radix select, 8 bits a pass, over shared memory;
// it stops as soon as the bucket it lands in holds exactly the items still
// needed. At least m items must be admitted. Every thread calls it.
template <class Word>
__device__ Cut block_cut(Word word, int n, int m, BlockShared& sh) {
  Cut c{0u, 0u, (unsigned)m};
  if (m >= n) return c;  // every admitted item is picked
  const int lane = threadIdx.x & 31;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh.hist[i] = 0u;
    __syncthreads();
    // one shared atomic an item: folding a warp's equal bytes first with
    // __match_any_sync was 13% slower at hc_topk_path's shape (PERF.md)
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      unsigned w;
      if (word(p, w) && (w & c.mask) == c.prefix) atomicAdd(&sh.hist[(w >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l sums bins 255 - 8l down to 248 - 8l, a scan over the lanes
      // gives the items above each lane's bins, and the first lane whose
      // running count reaches the rank walks its own 8 bins
      unsigned cnt[8], t = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = sh.hist[kBins - 1 - 8 * lane - j];
        t += cnt[j];
      }
      unsigned run = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run += v;
      }
      const unsigned hit = __ballot_sync(kFull, run >= c.remaining);
      if (hit != 0u && lane == __ffs(hit) - 1) {
        unsigned above = run - t;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + cnt[j] >= c.remaining) {
            sh.cut.prefix = c.prefix | ((unsigned)(kBins - 1 - 8 * lane - j) << shift);
            sh.cut.mask = c.mask | (0xFFu << shift);
            sh.cut.remaining = c.remaining - above;
            sh.done = cnt[j] == c.remaining - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
    c = sh.cut;
    if (sh.done) break;
  }
  return c;
}

// An asynchronous 16-byte copy from global to shared memory that bypasses
// L1 (the merge reads what other CTAs wrote); cp_async_wait waits for all.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// The exclusive prefix sum of v over the CTA's threads, in thread order.
__device__ unsigned long long block_exclusive_sum(unsigned long long v, BlockShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long x = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += x;
  }
  if (lane == 31) sh.warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long own = lane < warps ? sh.warp_sums[lane] : 0ull;
    unsigned long long run = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long x = __shfl_up_sync(kFull, run, o);
      if (lane >= o) run += x;
    }
    if (lane < warps) sh.warp_sums[lane] = run - own;
  }
  __syncthreads();
  return sh.warp_sums[warp] + inc - v;
}

// emit(p, j) for each item the cut picks, j its place in position order. A
// thread takes a run of consecutive positions; one block scan of its
// (above, tied) counts places the run. Every thread calls it.
template <class Word, class Emit>
__device__ void block_take(Word word, int n, const Cut& c, BlockShared& sh, Emit emit) {
  const int per = (n + (int)blockDim.x - 1) / (int)blockDim.x;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  unsigned above = 0u, tied = 0u;
  for (int p = lo; p < hi; ++p) {
    unsigned w;
    if (!word(p, w)) continue;
    above += (w & c.mask) > c.prefix;
    tied += (w & c.mask) == c.prefix;
  }
  const unsigned long long before =
      block_exclusive_sum(((unsigned long long)above << 32) | tied, sh);
  unsigned seen = (unsigned)before;  // tied items before this thread's run
  unsigned j = (unsigned)(before >> 32) + min(seen, c.remaining);
  for (int p = lo; p < hi; ++p) {
    unsigned w;
    if (!word(p, w)) continue;
    if ((w & c.mask) > c.prefix) {
      emit(p, j++);
    } else if ((w & c.mask) == c.prefix) {
      if (seen < c.remaining) emit(p, j++);
      ++seen;
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads)
    k8_block(const float* __restrict__ acc, int R, long long G, int key_mode, int null_mode,
             int val_row, int pac_row, int sq_row, int desc, int k, int slice,
             unsigned long long* __restrict__ cand, unsigned* __restrict__ ticket,
             int* __restrict__ ids, float* __restrict__ out) {
  // the slice's scores, then the candidates (16-byte aligned for cp.async)
  extern __shared__ __align__(16) unsigned long long s_dyn[];
  __shared__ BlockShared sh;
  int* s_score = reinterpret_cast<int*>(s_dyn);
  const long long first = (long long)blockIdx.x * slice;
  const int n = (int)min((long long)slice, G - first);
  const int stride = min(k, slice);  // candidate slots a CTA
  const int m = min(k, n);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    s_score[p] = score_of(acc, first + p, G, key_mode, null_mode, val_row, pac_row, sq_row, desc);
  }
  __syncthreads();
  const auto score_word = [&](int p, unsigned& w) {
    w = (unsigned)s_score[p] ^ 0x80000000u;
    return true;
  };
  unsigned long long* mine = cand + (long long)blockIdx.x * stride;
  block_take(score_word, n, block_cut(score_word, n, m, sh), sh,
             [&](int p, unsigned j) { mine[j] = key_of(s_score[p], first + p); });
  for (int j = m + threadIdx.x; j < stride; j += blockDim.x) mine[j] = 0ull;

  // the last CTA to finish merges the candidates
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  const int total = gridDim.x * stride;
  unsigned long long* s_key = s_dyn;
  // every copy in flight at once: two keys a copy, and an odd last key
  for (int i = threadIdx.x; i < total / 2; i += blockDim.x) {
    cp_async16(s_key + 2 * i, cand + 2 * i);
  }
  if ((total & 1) && threadIdx.x == 0) s_key[total - 1] = __ldcg(cand + total - 1);
  cp_async_wait();
  __syncthreads();
  const auto key_word = [&](int p, unsigned& w) {
    const unsigned long long key = s_key[p];
    w = (unsigned)(key >> 32);
    return key != 0ull;
  };
  block_take(key_word, total, block_cut(key_word, total, k, sh), sh,
             [&](int p, unsigned j) { sh.top[j] = s_key[p]; });
  __syncthreads();
  if (threadIdx.x < k) {
    const unsigned long long key = sh.top[threadIdx.x];
    int rank = 0;
    for (int i = 0; i < k; ++i) rank += sh.top[i] > key;
    sh.ids[rank] = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) ids[j] = sh.ids[j];
  for (int e = threadIdx.x; e < R * k; e += blockDim.x) {
    out[e] = acc[(long long)(e / k) * G + sh.ids[e % k]];
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// ------------------------------------------------------------ "radix" regime

__global__ void __launch_bounds__(kThreads)
    k8_score(const float* __restrict__ acc, long long G, int key_mode, int null_mode,
             int val_row, int pac_row, int sq_row, int desc, int k,
             unsigned long long* __restrict__ keys, State* __restrict__ st) {
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) st->hist[i] = 0u;
    if (threadIdx.x == 0) {
      st->prefix = 0ull;
      st->mask = 0ull;
      st->remaining = (unsigned)k;
      st->done = 0u;
      st->count = 0u;
    }
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G; g += step) {
    keys[g] = key_of(score_of(acc, g, G, key_mode, null_mode, val_row, pac_row, sq_row, desc), g);
  }
}

__global__ void __launch_bounds__(kThreads)
    k8_select(const unsigned long long* __restrict__ keys, long long G, int shift,
              State* __restrict__ st) {
  __shared__ unsigned s_hist[kBins];
  __shared__ bool s_last;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_hist[i] = 0u;
  __syncthreads();
  const unsigned long long prefix = st->prefix, mask = st->mask;
  const long long step = (long long)gridDim.x * blockDim.x;
  // every lane of a warp runs the same number of iterations (the match
  // below needs the whole warp)
  const long long first = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  for (long long base = first; base < G; base += step) {
    const long long g = base + (threadIdx.x & 31);
    int bin = -1;  // -1: no key, or a key outside the prefix
    if (g < G) {
      const unsigned long long key = keys[g];
      if ((key & mask) == prefix) bin = (int)((key >> shift) & 0xFFull);
    }
    const unsigned peers = __match_any_sync(kFull, bin);
    const bool leader = (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0u;
    if (bin >= 0 && leader) atomicAdd(&s_hist[bin], (unsigned)__popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (s_hist[i]) atomicAdd(&st->hist[i], s_hist[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&st->done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last CTA: every CTA's counts are in (each fenced before its ticket).
  // Its threads bring the 256 counts in from L2 at once, then one warp finds
  // the bucket: lane l sums bins 255 - 8l down to 248 - 8l, a scan over the
  // lanes gives the counts above each lane's bins, and the first lane whose
  // running count reaches the rank walks its own 8 bins.
  __threadfence();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) s_hist[i] = __ldcg(&st->hist[i]);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned need = st->remaining;
    unsigned c[8], t = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = s_hist[kBins - 1 - 8 * lane - j];
      t += c[j];
    }
    unsigned run = t;  // keys in the bins of lanes 0..lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, run, o);
      if (lane >= o) run += v;
    }
    const unsigned hit = __ballot_sync(kFull, run >= need);
    if (hit != 0u && lane == __ffs(hit) - 1) {
      unsigned above = run - t;
      int digit = 0;
      for (int j = 0; j < 8; ++j) {
        if (above + c[j] >= need) {
          digit = kBins - 1 - 8 * lane - j;
          break;
        }
        above += c[j];
      }
      st->prefix = prefix | ((unsigned long long)digit << shift);
      st->mask = mask | (0xFFull << shift);
      st->remaining = need - above;
      st->done = 0u;
    }
  }
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) st->hist[i] = 0u;
}

__global__ void __launch_bounds__(kThreads)
    k8_compact(const unsigned long long* __restrict__ keys, long long G, int k,
               State* __restrict__ st, unsigned long long* __restrict__ sel) {
  const unsigned long long t = st->prefix;  // the k-th largest key
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G; g += step) {
    const unsigned long long key = keys[g];
    if (key >= t) {
      const unsigned at = atomicAdd(&st->count, 1u);
      if (at < (unsigned)k) sel[at] = key;
    }
  }
}

__global__ void __launch_bounds__(kSortThreads)
    k8_sort(const unsigned long long* __restrict__ sel, int k, int* __restrict__ ids) {
  __shared__ unsigned long long s[kMaxK];
  int p = 1;
  while (p < k) p <<= 1;
  for (int i = threadIdx.x; i < p; i += blockDim.x) s[i] = i < k ? sel[i] : 0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = s[i], b = s[j];
          // descending runs where (i & size) == 0: the last merge (size == p)
          // leaves the whole list descending
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    ids[j] = (int)(0xFFFFFFFFu - (unsigned)(s[j] & 0xFFFFFFFFull));
  }
}

__global__ void __launch_bounds__(kThreads)
    k8_gather(const float* __restrict__ acc, long long G, int R, int k,
              const int* __restrict__ ids, float* __restrict__ out) {
  const long long total = (long long)R * k;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += step) {
    const int r = (int)(e / k), j = (int)(e % k);
    out[e] = acc[(long long)r * G + ids[j]];
  }
}

int grid_for(long long n) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  return clamp_grid(ceil_div(n, (long long)kThreads), 8LL * info.sms);
}

}  // namespace

extern "C" int topk_block(const float* acc, int R, long long G, int key_mode, int null_mode,
                          int val_row, int pac_row, int sq_row, int desc, int k, int ctas,
                          int slice, unsigned long long* cand, unsigned* ticket, int* ids,
                          float* out, void* stream) {
  if (R < 1 || G < 1 || G > 0x7FFFFFFFLL || k < 1 || k > kBlockMaxK || k > G || slice < 1 ||
      ctas < 1 || (long long)(ctas - 1) * slice >= G || (long long)ctas * slice < G) {
    return (int)cudaErrorInvalidValue;
  }
  const int stride = k < slice ? k : slice;
  const long long smem = 4LL * slice > 8LL * ctas * stride ? 4LL * slice : 8LL * ctas * stride;
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > smem_budget(device_info(dev))) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  const cudaError_t err =
      resident_ctas(dev, (const void*)k8_block, kBlockThreads, (int)smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  k8_block<<<ctas, kBlockThreads, (size_t)smem, (cudaStream_t)stream>>>(
      acc, R, G, key_mode, null_mode, val_row, pac_row, sq_row, desc, k, slice, cand, ticket, ids,
      out);
  return (int)cudaGetLastError();
}

extern "C" int topk_radix(const float* acc, int R, long long G, int key_mode, int null_mode,
                          int val_row, int pac_row, int sq_row, int desc, int k,
                          unsigned long long* keys, unsigned* state, unsigned long long* sel,
                          int* ids, float* out, void* stream) {
  if (R < 1 || G < 1 || G > 0x7FFFFFFFLL || k < 1 || k > kMaxK || k > G) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  State* s = reinterpret_cast<State*>(state);
  const int grid = grid_for(G);
  k8_score<<<grid, kThreads, 0, st>>>(acc, G, key_mode, null_mode, val_row, pac_row, sq_row,
                                      desc, k, keys, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int shift = 56; shift >= 0; shift -= 8) {
    k8_select<<<grid, kThreads, 0, st>>>(keys, G, shift, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  k8_compact<<<grid, kThreads, 0, st>>>(keys, G, k, s, sel);
  k8_sort<<<1, kSortThreads, 0, st>>>(sel, k, ids);
  k8_gather<<<grid_for((long long)R * k), kThreads, 0, st>>>(acc, G, R, k, ids, out);
  return (int)cudaGetLastError();
}
