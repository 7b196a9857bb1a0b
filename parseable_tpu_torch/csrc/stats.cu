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
//   when the register already holds as much. Presence is an idempotent store
//   of 1.0f: no atomic. The "compact" regime (below; the rule's pick for HLL
//   up to 65,536 groups, for presence where a copy holds every group) keeps
//   presence as bits and HLL as u32 registers (at most kHllCopyWords) in a
//   copy of only the groups a CTA's rows touch: a minute file reaches a few
//   of its groups, and folded in global memory every row would re-read a few
//   hot entries from L2. The earlier regimes stay selectable: "shared" (a
//   whole copy of the G * cap entries a CTA, up to 8,192) and "global".
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
//   puts half of every group's rows into the ~12 bins of [256, 500)), so a
//   CTA counts into a shared copy of only the groups its rows touch, u16
//   counters two to a word (the compact regime, below), and adds each
//   nonzero count into the accumulator once. The earlier regimes stay
//   selectable: "shared" (all G histograms a CTA, G <= 24) and "global" (f32
//   atomics per row; a warp whose rows crowd onto one slot adds each slot's
//   count once, __match_any_sync).
//
// K7, centered_m2: m2[q, g] = sum over live, valid rows of (v - mean[q, g])^2.
//   Replaces parseable_tpu/query/executor_tpu.py:889 _block_m2 (the
//   segment_sum of centred squares; the Chan merge :938 stays elementwise in
//   the caller). mean is this block's per-group mean, sums / max(count, 1)
//   from kernel A's outputs, computed on the stream by the caller.
//   Bound: bytes, N (4 + 1 + 5 Q) read, 4.7 us at Q = 2 and 2^20 rows.
//   Design: the "compact" regime (below; the rule's pick for Q <= 2 and
//   Q * G <= 16, the main path's stddev/var by status) streams contiguous
//   chunks with vector loads and sums each thread's rows into a private
//   column of shared memory: no atomics, ballots or matches in the row loop
//   (the earlier regimes pay for those on every row: the status key puts
//   half of the rows in one group). Past 16 cells, a per-CTA [Q, G] f32
//   accumulator (with the means beside it) in shared memory where it fits
//   ("shared"), with warp-adaptive aggregation of each row's square over the
//   lanes that share a group when a ballot finds a crowded group.
//   Past it, "global" (the block-local fold's 2^17-2^22 groups): what
//   bounds it is not its bytes but the L2's random operations, two a live
//   row and value row, the gather of its group's mean and the add of its
//   square; the card does about as many a second whatever their width
//   (PERF.md, scripts/torch_local_fold_variants.py: without the gather the
//   kernel takes 19 us of 27 at G = 2^20, without the add 16). A lane takes
//   four rows a step by vector loads, gathers the means of its live, valid
//   rows only, before any add, probes for crowding once a step, and adds
//   each nonzero square with one atomic. A [G, 2Q] record of means and
//   sums, which puts the gather and the add in one sector, was slower (the
//   same two operations, and a record to build first).
//
// Interface: plain C, called through ctypes. Every pointer is a device
// pointer; `stream` is the caller's cudaStream_t; `mode` is the wrapper's
// regime choice (0 shared, 1 global, 2 compact). Each
// entry returns cudaGetLastError() after its launch (0 on success), or
// cudaErrorInvalidValue for a shape the regime does not fit.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <utility>
#include <vector>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 1024;           // query/sketch.py BINS
constexpr int kNB = 2 * kBins + 1;    // query/sketch.py DEVICE_NB
constexpr unsigned kOne = 0x3F800000u;  // 1.0f

enum Mode { kShared = 0, kGlobal = 1, kCompact = 2 };

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

// ------------------------------------------------- the compact regime (K5, K6)
//
// A CTA of kCompactThreads threads takes a contiguous chunk of the block, up
// to 4 rows a thread for K6 (two CTAs an SM, at 32 registers a thread) or 8
// for K5 (one CTA an SM), loads them 4 at a time (16-byte vector loads where
// every input reaches a 16-byte phase after the same head) and keeps them in
// registers. Where the copies of all G groups fit in kPreZeroWords
// (K6 up to 8 groups, presence up to 32,768 bits) it zeroes them while its
// loads are in flight and folds into them directly. Otherwise it marks the
// groups its live rows reach in a shared bitmap of G bits, counting the
// groups it marks first, and numbers them by prefix counts: a group's compact
// index is the set bits below it (for G <= 1,024 each warp counts the
// bitmap's words itself, in registers). Where those T groups' copies fit the
// CTA's shared memory (decided on the device, per CTA), the rows fold into a
// copy of only those groups (the first few zeroed while the loads were in
// flight) and the CTA flushes its copy's nonzero entries at its end.
// Otherwise the CTA folds its rows straight into the accumulator with global
// atomics, and a warp that finds the count already past what the copy holds
// stops marking and does so at once, without waiting for the other warps:
// where every CTA's rows spread over more groups than it holds, the atomics
// start as soon as the rows arrive, as in the "global" regime. What holds
// the regime (PERF.md): the block's data reaches the last CTAs late in the
// kernel, and a CTA's marks, fold and flush then run in series, behind a
// barrier each.

constexpr int kCompactThreads = 1024;   // threads of a compact CTA (the fastest of 256-1,024)
constexpr int kPctRows = 4;             // rows a K6 thread holds in registers, at most
constexpr int kDistinctRows = 8;        // rows a K5 thread holds in registers, at most
constexpr int kBitmapG = 65536;         // groups the bitmap covers (8 KB of bits)
constexpr int kRegPrefixW = 32;         // bitmap words a warp numbers in registers
constexpr int kHalfNB = (kNB + 1) / 2;  // u32 words of one group's u16 histogram
constexpr int kPreZeroWords = 8 * kHalfNB;  // copy words a CTA zeroes while its loads fly
constexpr int kFlushWords = 8;  // presence words a warp flushes at once
// presence copy words a CTA holds at most: its flush reads the entries of
// every set bit, kFlushWords words a warp at a time, one round trip each
constexpr int kPresenceWords = 1024;
// HLL registers a CTA's copy holds at most, twice the rows the CTA holds:
// zeroing and flushing a larger copy cost more than folding the rows into
// the accumulator (uniform 8 x 4,096 on an H100, PERF.md)
constexpr int kHllCopyWords = 2 * kCompactThreads * kDistinctRows;
// A K6 chunk holds at most kCompactThreads * kPctRows rows, so no u16 bin of
// a CTA's histogram can reach 65,536 and carry into the bin beside it.
static_assert(kCompactThreads * kPctRows < 65536, "a u16 bin could overflow");

// A block's rows as quads of 4: quads 0..nq-1 are the body, from a head of
// up to 3 rows that brings every input to a 16-byte phase (vector loads),
// quad nq is that scalar head and quad nq + 1 the ragged tail of up to 3 rows.
struct Quads {
  long long n, head, nq;
};

// First row and row count of quad v; true for a body quad.
__device__ __forceinline__ bool quad_rows(const Quads& q, long long v, long long* first,
                                          int* count) {
  if (v < q.nq) {
    *first = q.head + 4 * v;
    *count = 4;
    return true;
  }
  if (v == q.nq) {
    *first = 0;
    *count = (int)q.head;
    return false;
  }
  *first = q.head + 4 * q.nq;
  *count = (int)(q.n - *first);
  return false;
}

// Four consecutive elements from a 16-byte-phased address, read once
// (streamed, evict-first).
__device__ __forceinline__ void load4(const int* p, int o[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load4(const uint8_t* p, int o[4]) {
  const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = (int)((w >> (8 * k)) & 0xffu);
}
__device__ __forceinline__ void load4(const int8_t* p, int o[4]) {
  const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(p));
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = (int)(int8_t)(w >> (8 * k));
}
__device__ __forceinline__ void load4(const int16_t* p, int o[4]) {
  const uint2 w = __ldcs(reinterpret_cast<const uint2*>(p));
  o[0] = (int)(int16_t)(w.x & 0xffffu), o[1] = (int)(int16_t)(w.x >> 16);
  o[2] = (int)(int16_t)(w.y & 0xffffu), o[3] = (int)(int16_t)(w.y >> 16);
}

// The rows of quad v of one input: a vector load for a body quad when VEC,
// else one scalar load a row; rows past the quad's count read 0.
template <bool VEC, typename A, typename TA>
__device__ __forceinline__ void load_part(const Quads& q, long long v, const A* a, TA o[4]) {
  long long first;
  int count;
  const bool body = quad_rows(q, v, &first, &count);
  if (VEC && body) {
    load4(a + first, o);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = k < count ? (TA)a[first + k] : (TA)0;
}

// The rows of quad v of (a, b, mask), as load_part: rows past the quad's
// count get mask 0.
template <bool VEC, typename A, typename TA, typename B>
__device__ __forceinline__ void load_quad(const Quads& q, long long v, const A* a, TA oa[4],
                                          const B* b, int ob[4], const uint8_t* mask, int om[4]) {
  load_part<VEC>(q, v, a, oa);
  load_part<VEC>(q, v, b, ob);
  load_part<VEC>(q, v, mask, om);
}

// This CTA's rows of (a, b, mask), `quads` quads a thread (R / 4 at most),
// into registers: vector loads for body quads when VEC; rows past a quad's
// count, or quads past the block, get mask 0.
template <bool VEC, int R, typename A, typename TA, typename B>
__device__ __forceinline__ void load_rows(const Quads& q, int quads, const A* a, TA (&oa)[R],
                                          const B* b, int (&ob)[R], const uint8_t* mask,
                                          int (&om)[R]) {
  const long long v0 = (long long)blockIdx.x * kCompactThreads * quads + threadIdx.x;
#pragma unroll
  for (int r = 0; r < R / 4; ++r) {
    const long long v = v0 + (long long)r * kCompactThreads;
    if (r < quads && v < q.nq + 2) {
      load_quad<VEC>(q, v, a, oa + 4 * r, b, ob + 4 * r, mask, om + 4 * r);
    } else {
#pragma unroll
      for (int k = 4 * r; k < 4 * r + 4; ++k) oa[k] = (TA)0, ob[k] = 0, om[k] = 0;
    }
  }
}

// Words of the bitmap for G groups: 0 past kBitmapG, or where the bitmap and
// its prefix counts would not fit `smem_words`.
__host__ __device__ inline int bitmap_words(int G, long long smem_words) {
  const int W = (G + 31) >> 5;
  return G <= kBitmapG && 2LL * W + 4 <= smem_words ? W : 0;
}

// Exclusive prefix counts of the set bits of bits[0, W) into pre[0, W).
// Every thread of the CTA must call it.
__device__ void bit_prefix(const unsigned* bits, unsigned* pre, int W) {
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (W + kCompactThreads - 1) / kCompactThreads;
  const int lo = min(W, (int)threadIdx.x * per), hi = min(W, lo + per);
  int mine = 0;
  for (int w = lo; w < hi; ++w) mine += __popc(bits[w]);
  int x = mine;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) warp_sum[lane] = t;
  }
  __syncthreads();
  int run = x - mine + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int w = lo; w < hi; ++w) {
    pre[w] = (unsigned)run;
    run += __popc(bits[w]);
  }
}

// Marks in the bitmap the groups of this thread's rows (g[] holds -1 for a
// dropped row) and adds to *marked the groups it marks first. Returns false,
// its other rows left unmarked, once *marked passes `cap`: the CTA's groups
// cannot all fit its copy then. Every lane of the warp must call it.
template <int R>
__device__ __forceinline__ bool mark_groups(unsigned* bits, int* marked, int cap,
                                            const int (&g)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (__shfl_sync(kFull, *(volatile int*)marked, 0) > cap) return false;
    bool first = false;
    if (g[k] >= 0) {
      unsigned* w = bits + (g[k] >> 5);
      const unsigned bit = 1u << (g[k] & 31);
      first = !(*w & bit) && !(atomicOr(w, bit) & bit);
    }
    const unsigned firsts = __ballot_sync(kFull, first);
    if (firsts && (threadIdx.x & 31) == 0) atomicAdd(marked, __popc(firsts));
  }
  return true;
}

// The marked groups, numbered. For W <= kRegPrefixW each lane holds the
// prefix count of bitmap word `lane` (`below`); past that they are in pre[].
struct Touched {
  const unsigned* bits;
  const unsigned* pre;
  int W;
  unsigned below;  // W <= kRegPrefixW: set bits in the words before word `lane`
};

// Numbers the groups of the bitmap, complete behind a barrier the caller
// passed. Every thread of the CTA must call it; past kRegPrefixW words it
// ends on a barrier.
__device__ __forceinline__ Touched number_groups(const unsigned* bits, unsigned* pre, int W) {
  Touched t{bits, pre, W, 0u};
  if (W <= kRegPrefixW) {
    const int lane = threadIdx.x & 31;
    const int mine = lane < W ? __popc(bits[lane]) : 0;
    int x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    t.below = (unsigned)(x - mine);
    return t;
  }
  bit_prefix(bits, pre, W);
  __syncthreads();
  return t;
}

// Group g's compact index (g >= 0; any value for a dropped row, whose result
// is unused). Every lane of the warp must call it.
__device__ __forceinline__ int compact_index(const Touched& t, int g) {
  const int w = g < 0 ? 0 : g >> 5;
  const unsigned in_word = __popc(t.bits[w] & ((1u << (g & 31)) - 1u));
  const unsigned before = t.W <= kRegPrefixW ? __shfl_sync(kFull, t.below, w & 31) : t.pre[w];
  return (int)(before + in_word);
}

// list[c] = the group of compact index c.
__device__ __forceinline__ void list_groups(const Touched& t, unsigned* list) {
  for (int w = threadIdx.x; w < t.W; w += kCompactThreads) {
    unsigned b = t.bits[w];
    unsigned k = t.W <= kRegPrefixW ? t.below : t.pre[w];  // for W <= 32, w is this lane
    while (b) {
      list[k++] = (unsigned)(w * 32 + __ffs(b) - 1);
      b &= b - 1u;
    }
  }
}

// Zeroes n words from a 16-byte-aligned p.
__device__ __forceinline__ void zero_words(unsigned* p, int n) {
  uint4* v = reinterpret_cast<uint4*>(p);
  for (int j = threadIdx.x; j < n / 4; j += kCompactThreads) v[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int j = (n & ~3) + threadIdx.x; j < n; j += kCompactThreads) p[j] = 0u;
}

// A compact CTA's shared memory, in u32 words, for copies of `wpg` words a
// group, `max_words` at most. Direct, where all G groups' copies fit in
// kPreZeroWords: they lie from word 0 and a group's compact index is the
// group itself (no bitmap). Otherwise: the bitmap [W], its prefix counts [W],
// the numbered groups [cap] and, from a 16-byte boundary, the copy of up to
// `cap` groups (none without a bitmap, W 0). Either way the first `ready`
// groups' copies (all, when direct) and the bitmap are zeroed here, while
// the CTA's loads are in flight, and *marked is set to 0 (past `cap` without
// a bitmap); the caller's next barrier publishes them.
struct Copy {
  unsigned* bits;
  unsigned* pre;
  unsigned* list;
  unsigned* copy;
  int W, cap, ready;
  bool direct;
};

__device__ __forceinline__ Copy copy_layout(unsigned* csm, int* marked, int G, int smem_words,
                                            int wpg, int max_words) {
  Copy c;
  const long long all = (long long)G * wpg;
  c.direct = all <= kPreZeroWords && all <= smem_words && all <= max_words;
  if (c.direct) {
    c.bits = c.pre = c.list = nullptr;
    c.copy = csm;
    c.W = 0;
    c.cap = c.ready = G;
  } else {
    c.W = bitmap_words(G, smem_words);
    c.bits = csm;
    c.pre = csm + c.W;
    c.list = csm + 2 * c.W;
    const long long room = smem_words - 2LL * c.W - 4;
    long long cap = c.W && room > 0 ? room / (wpg + 1) : 0;
    cap = cap < max_words / wpg ? cap : max_words / wpg;
    c.cap = (int)(cap < G ? cap : G);
    c.copy = csm + ((2 * c.W + c.cap + 3) & ~3);
    c.ready = kPreZeroWords / wpg < c.cap ? kPreZeroWords / wpg : c.cap;
    for (int j = threadIdx.x; j < c.W; j += kCompactThreads) c.bits[j] = 0u;
  }
  if (threadIdx.x == 0) *marked = c.W || c.direct ? 0 : c.cap + 1;
  zero_words(c.copy, c.ready * wpg);
  return c;
}

// Makes the copies of groups [ready, T) zero (a barrier when there are any).
// Every thread of the CTA must call it.
__device__ __forceinline__ void zero_rest(const Copy& c, int T, int wpg) {
  if (T <= c.ready) return;
  zero_words(c.copy + c.ready * wpg, (T - c.ready) * wpg);
  __syncthreads();
}

// Where a CTA's flush starts in its copy of `words` entries: CTAs that end
// together spread their atomics over the accumulator instead of reaching the
// same entries at once.
__device__ __forceinline__ int flush_start(int words) {
  return (int)((blockIdx.x * 2654435761u) % (unsigned)words);
}

// Quads of n rows whose inputs (pointer, element size) all reach a 16-byte
// phase after one head; *vec is false (no head, scalar loads) where they
// disagree.
Quads make_quads(long long n, const std::vector<std::pair<const void*, int>>& inputs,
                 bool* vec) {
  int head = -1;
  *vec = true;
  for (const auto& in : inputs) {
    const int h = (int)((4 - ((uintptr_t)in.first / in.second)) & 3);
    if (head < 0) head = h;
    *vec = *vec && h == head;
  }
  Quads q;
  q.n = n;
  q.head = *vec ? (head < n ? head : n) : 0;
  q.nq = (n - q.head) / 4;
  return q;
}

// Launches a compact kernel. Each CTA gets its share of an SM's shared
// memory at the occupancy its registers allow (up to the budget, and no more
// than `smem_all`, all G groups' copies): a CTA keeps only the groups its
// rows touch, so residency comes first. Each thread takes as many quads (up
// to `quads_max`) as spread the block over the CTAs the card then holds at
// once, and the grid as many CTAs as the block needs.
template <typename Go>
cudaError_t launch_compact(const void* kernel, int quads_max, long long smem_all, const Quads& q,
                           Go go) {
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  int per_sm = 0;
  cudaError_t err = resident_ctas(dev, kernel, kCompactThreads, 0, &per_sm);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // shared memory is allocated in 1 KB steps
  long long smem = info.smem_per_sm / per_sm - info.smem_reserved - (long long)attr.sharedSizeBytes;
  if (smem > smem_budget(info)) smem = smem_budget(info);
  smem = smem < 0 ? 0 : smem & ~1023LL;
  if (smem > ((smem_all + 1023) & ~1023LL)) smem = (smem_all + 1023) & ~1023LL;
  err = resident_ctas(dev, kernel, kCompactThreads, (int)smem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long quads_all = q.nq + 2;
  long long quads = ceil_div(quads_all, (long long)per_sm * info.sms * kCompactThreads);
  quads = quads < 1 ? 1 : (quads > quads_max ? quads_max : quads);
  const long long grid = ceil_div(quads_all, kCompactThreads * quads);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  go((int)grid, (int)quads, (int)smem);
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

// Folds this thread's rows (g[] -1 for a dropped row) straight into the
// accumulator: an HLL register maxed behind a plain read, a presence entry
// stored where it does not hold 1.0f yet, one row after another (reading
// every row's entry first was slower on an H100: more of the reads find an
// entry not yet written by the CTAs that fold at the same time; PERF.md).
template <bool HLL, int R>
__device__ __forceinline__ void fold_rows(unsigned* acc, int cap, const int (&g)[R],
                                          const int (&slot)[R], const unsigned (&val)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (g[k] < 0) continue;
    unsigned* p = acc + (long long)g[k] * cap + slot[k];
    if (HLL) {
      if (val[k] > __ldcg(p)) atomicMax(p, val[k]);
    } else if (__ldcg(p) != kOne) {
      *p = kOne;
    }
  }
}

// Compact regime: a CTA's copy holds, per touched group, `cap` u32 registers
// (HLL) or `cap` bits (presence). The flush maxes each nonzero register in
// with a reduction (no read first, as in the fold: every CTA ends at once,
// so few reads would find the register already maxed), and stores 1.0f for
// each set bit whose entry does not hold it yet.
template <typename C, bool HLL, bool VEC>
__global__ void __launch_bounds__(kCompactThreads)
    distinct_compact_kernel(const int* __restrict__ ids, const C* __restrict__ codes,
                            const uint8_t* __restrict__ mask, const int* __restrict__ lut_idx,
                            const int* __restrict__ lut_rank, int V, int cap, int G, Quads q,
                            int quads, int smem_words, unsigned* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned csm[];  // Copy
  __shared__ int marked;
  // this thread's rows, all loads in flight while the copy is zeroed
  int g[kDistinctRows], slot[kDistinctRows], m[kDistinctRows];
  unsigned val[kDistinctRows];
  load_rows<VEC>(q, quads, ids, g, codes, slot, mask, m);
  const int wpg = HLL ? cap : (cap + 31) >> 5;  // words of one group's copy
  const Copy c =
      copy_layout(csm, &marked, G, smem_words, wpg, HLL ? kHllCopyWords : kPresenceWords);
  __syncthreads();  // zeroed; the rows' uses below wait on their own loads
  // in place: g (the group, -1 for a dropped row), slot and value
#pragma unroll
  for (int k = 0; k < kDistinctRows; ++k) {
    const int code = slot[k];
    int sl = -1;
    val[k] = kOne;
    if (m[k] && (unsigned)g[k] < (unsigned)G && (unsigned)code < (unsigned)V) {
      sl = lut_idx ? __ldg(lut_idx + code) : code;
      sl = sl < cap - 1 ? sl : cap - 1;
      if (HLL && sl >= 0) {
        const int rank = __ldg(lut_rank + code);
        val[k] = __float_as_uint((float)rank);
        if (rank <= 0) sl = -1;
      }
    }
    g[k] = sl >= 0 ? g[k] : -1;
    slot[k] = sl;
  }
  bool pending = true;  // this thread's rows are still to fold
  int T = G;
  if (!c.direct) {
    if (!mark_groups(c.bits, &marked, c.cap, g)) {
      fold_rows<HLL>(acc, cap, g, slot, val);
      pending = false;
    }
    __syncthreads();
    T = marked;
  }
  if (T > c.cap) {  // the touched groups do not fit: fold into the accumulator
    if (pending) fold_rows<HLL>(acc, cap, g, slot, val);
    return;
  }
  if (T == 0) return;
  Touched t{};
  if (!c.direct) {
    t = number_groups(c.bits, c.pre, c.W);
    zero_rest(c, T, wpg);
    list_groups(t, c.list);
  }
  int at[kDistinctRows];  // each row's word in the copy (-1: none)
#pragma unroll
  for (int k = 0; k < kDistinctRows; ++k) {
    if (k >= 4 * quads) break;
    const int ci = c.direct ? g[k] : compact_index(t, g[k]);
    at[k] = g[k] < 0 ? -1 : ci * wpg + (HLL ? slot[k] : slot[k] >> 5);
  }
#pragma unroll
  for (int k = 0; k < kDistinctRows; ++k) {
    if (k >= 4 * quads) break;
    if (at[k] < 0) continue;
    unsigned* w = c.copy + at[k];
    if (HLL) {
      if (val[k] > *w) atomicMax(w, val[k]);
    } else {
      const unsigned bit = 1u << (slot[k] & 31);
      if (!(*w & bit)) atomicOr(w, bit);
    }
  }
  __syncthreads();
  const int words = T * wpg;
  const int start = flush_start(words);
  if (HLL) {
    for (int k = threadIdx.x; k < words; k += kCompactThreads) {
      const int j = k + start < words ? k + start : k + start - words;
      const unsigned x = c.copy[j];
      if (x == 0u) continue;
      const int ci = j / wpg;
      atomicMax(acc + (c.direct ? ci : (long long)c.list[ci]) * cap + (j - ci * wpg), x);
    }
    return;
  }
  // a warp takes kFlushWords words at a time, a lane a bit of each: their
  // entries are read together, then those not yet 1.0f are stored
  const int lane = threadIdx.x & 31;
  for (int k0 = (threadIdx.x >> 5) * kFlushWords; k0 < words;
       k0 += (kCompactThreads >> 5) * kFlushWords) {
    unsigned* p[kFlushWords];
    unsigned held[kFlushWords];
#pragma unroll
    for (int u = 0; u < kFlushWords; ++u) {
      const int k = k0 + u;
      const int j = k + start < words ? k + start : k + start - words;
      p[u] = nullptr;
      if (k < words && ((c.copy[j] >> lane) & 1u)) {
        const int ci = j / wpg;
        p[u] = acc + (c.direct ? ci : (long long)c.list[ci]) * cap + (j - ci * wpg) * 32 + lane;
        held[u] = __ldcg(p[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFlushWords; ++u) {
      if (p[u] && held[u] != kOne) *p[u] = kOne;
    }
  }
}

template <typename C>
cudaError_t launch_distinct_compact(const int* ids, const C* codes, const uint8_t* mask,
                                    const int* lut_idx, const int* lut_rank, int V, int cap,
                                    int G, long long N, unsigned* acc, cudaStream_t s) {
  bool vec = false;
  const Quads q = make_quads(N, {{ids, 4}, {codes, (int)sizeof(C)}, {mask, 1}}, &vec);
  const bool hll = lut_rank != nullptr;
  const long long wpg = hll ? cap : (cap + 31) / 32;
  const long long W = bitmap_words(G, 1LL << 40);
  const long long smem_all = W ? 4 * (2 * W + G + 4 + G * wpg) : 0;
  auto go = [&](auto kernel) {
    return launch_compact((const void*)kernel, kDistinctRows / 4, smem_all, q,
                          [&](int grid, int quads, int smem) {
      kernel<<<grid, kCompactThreads, (size_t)smem, s>>>(ids, codes, mask, lut_idx, lut_rank, V,
                                                         cap, G, q, quads, smem / 4, acc);
    });
  };
  if (hll) {
    return vec ? go(distinct_compact_kernel<C, true, true>)
               : go(distinct_compact_kernel<C, true, false>);
  }
  return vec ? go(distinct_compact_kernel<C, false, true>)
             : go(distinct_compact_kernel<C, false, false>);
}

template <typename C>
cudaError_t launch_distinct(const int* ids, const C* codes, const uint8_t* mask,
                            const int* lut_idx, const int* lut_rank, int V, int cap, int G,
                            long long N, unsigned* acc, int mode, cudaStream_t s) {
  if (mode == kCompact) {
    return launch_distinct_compact(ids, codes, mask, lut_idx, lut_rank, V, cap, G, N, acc, s);
  }
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

// Adds this thread's rows (g[] -1 for a dropped row) straight into the
// accumulator.
template <int R>
__device__ __forceinline__ void add_rows(float* out, const int (&g)[R], const int (&slot)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (g[k] >= 0) atomicAdd(out + g[k] * kNB + slot[k], 1.f);
  }
}

// Compact regime: a CTA's copy holds, per touched group, 2049 u16 counters
// packed two to a u32 word (kHalfNB words), each added to as the u32 word
// with 1 shifted into its half (no carry: see kPctRows). Two CTAs an SM: a
// thread holds 4 rows in 32 registers. No warp aggregation: on an H100 it
// paid only where every row of a block shares one slot (PERF.md).
template <bool VEC>
__global__ void __launch_bounds__(kCompactThreads, 2)
    pct_hist_compact_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                            const uint8_t* __restrict__ mask, int G, Quads q, int quads,
                            int smem_words, float lo, float hi, float scale,
                            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned csm[];  // Copy
  __shared__ int marked;
  // this thread's rows (the mask in `slot`), all loads in flight while the
  // copy is zeroed
  float x[kPctRows];
  int g[kPctRows], slot[kPctRows];
  load_rows<VEC>(q, quads, vals, x, ids, g, mask, slot);
  const Copy c = copy_layout(csm, &marked, G, smem_words, kHalfNB, 0x7fffffff);
  __syncthreads();  // zeroed; the rows' uses below wait on their own loads
  // in place: g (the group, -1 for a dropped row) and slot
#pragma unroll
  for (int k = 0; k < kPctRows; ++k) {
    const bool live = slot[k] && x[k] == x[k] && (unsigned)g[k] < (unsigned)G;
    g[k] = live ? g[k] : -1;
    slot[k] = live ? pct_slot(x[k], lo, hi, scale) : 0;
  }
  bool pending = true;  // this thread's rows are still to add
  int T = G;
  if (!c.direct) {
    if (!mark_groups(c.bits, &marked, c.cap, g)) {
      add_rows(out, g, slot);
      pending = false;
    }
    __syncthreads();
    T = marked;
  }
  if (T > c.cap) {  // the touched groups do not fit: add into the accumulator
    if (pending) add_rows(out, g, slot);
    return;
  }
  if (T == 0) return;
  Touched t{};
  if (!c.direct) {
    t = number_groups(c.bits, c.pre, c.W);
    zero_rest(c, T, kHalfNB);
    list_groups(t, c.list);
  }
  int key[kPctRows];  // each row's u16 counter in the copy (-1: none)
#pragma unroll
  for (int k = 0; k < kPctRows; ++k) {
    if (k >= 4 * quads) break;
    const int ci = c.direct ? g[k] : compact_index(t, g[k]);
    key[k] = g[k] < 0 ? -1 : ci * (2 * kHalfNB) + slot[k];
  }
#pragma unroll
  for (int k = 0; k < kPctRows; ++k) {
    if (key[k] >= 0) atomicAdd(c.copy + (key[k] >> 1), 1u << ((key[k] & 1) << 4));
  }
  __syncthreads();
  const int words = T * kHalfNB;
  const int start = flush_start(words);
  for (int k = threadIdx.x; k < words; k += kCompactThreads) {
    const int j = k + start < words ? k + start : k + start - words;
    const unsigned w = c.copy[j];
    if (w == 0u) continue;
    const int ci = j / kHalfNB;
    const long long grp = c.direct ? ci : c.list[ci];
    float* o = out + grp * kNB + 2 * (j - ci * kHalfNB);
    if (w & 0xffffu) atomicAdd(o, (float)(w & 0xffffu));
    if (w >> 16) atomicAdd(o + 1, (float)(w >> 16));
  }
}

// ------------------------------------------------------------------ K7

__global__ void __launch_bounds__(kThreads)
    m2_shared_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                     const uint8_t* __restrict__ mask, const int* __restrict__ ids,
                     const float* __restrict__ mean, int Q, int G, long long N,
                     float* __restrict__ out) {
  extern __shared__ float sm[];  // [Q * G] sums, then [Q * G] means
  const int qg = Q * G;
  for (int j = threadIdx.x; j < qg; j += blockDim.x) {
    sm[j] = 0.f;
    sm[qg + j] = mean[j];
  }
  __syncthreads();
  const float* mu = sm + qg;
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
      if (g >= 0 && peers.leader && d2 != 0.f) atomicAdd(sm + q * G + g, d2);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < qg; j += blockDim.x) {
    const float x = sm[j];
    if (x != 0.f) atomicAdd(out + j, x);
  }
}

// The "global" regime of K7: mean [Q, G] and out [Q, G]. A lane takes a
// quad of four rows a step (the Quads of the compact regime: 16-byte and
// 4-byte vector loads where every input reaches a 16-byte phase after the
// same head), gathers the means of its live, valid rows before any add,
// probes the warp for crowding once a step, and adds each nonzero square
// with one atomic. What bounds it is the L2's random operations, two a live
// row and value row (the gather and the add), not its bytes.
constexpr int kM2Held = 2;  // value rows a lane holds in registers

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    m2_global_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                     const uint8_t* __restrict__ mask, const int* __restrict__ ids,
                     const float* __restrict__ mean, int Q, int G, Quads qd,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long quads = qd.nq + 2, N = qd.n;
  const long long step = (long long)gridDim.x * blockDim.x;
  // warp-uniform loop: every lane takes part in the probe and the match
  for (long long w = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); w < quads;
       w += step) {
    const long long v = w + lane;
    int g[4], live[4], ok[kM2Held][4];
    float x[kM2Held][4], mu[kM2Held][4];
    long long first = 0;
    int count = 0;
    if (v < quads) {
      quad_rows(qd, v, &first, &count);
      load_part<VEC>(qd, v, ids, g);
      load_part<VEC>(qd, v, mask, live);
#pragma unroll
      for (int p = 0; p < kM2Held; ++p) {
        if (p < Q) {
          load_part<VEC>(qd, v, vals + p * N, x[p]);
          load_part<VEC>(qd, v, valid + p * N, ok[p]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] = -1, live[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g[k] = live[k] && (unsigned)g[k] < (unsigned)G ? g[k] : -1;
#pragma unroll
      for (int p = 0; p < kM2Held; ++p) {
        mu[p][k] = p < Q && g[k] >= 0 && ok[p][k] ? __ldcg(mean + (long long)p * G + g[k]) : 0.f;
      }
    }
    const bool crowd = crowded(g[0]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Peers peers = fold_peers(g[k], crowd);
      const bool lead = g[k] >= 0 && peers.leader;
#pragma unroll
      for (int p = 0; p < kM2Held; ++p) {
        if (p < Q) {
          float d2 = 0.f;
          if (g[k] >= 0 && ok[p][k]) {
            const float d = __fsub_rn(x[p][k], mu[p][k]);
            d2 = __fmul_rn(d, d);
          }
          d2 = peer_reduce(d2, peers, [](float a, float b) { return a + b; });
          if (lead && d2 != 0.f) atomicAdd(out + (long long)p * G + g[k], d2);
        }
      }
      for (int p = kM2Held; p < Q; ++p) {  // value rows past the held ones
        float d2 = 0.f;
        const long long at = (long long)p * N + first + k;
        if (g[k] >= 0 && valid[at]) {
          const float d = __fsub_rn(vals[at], __ldcg(mean + (long long)p * G + g[k]));
          d2 = __fmul_rn(d, d);
        }
        d2 = peer_reduce(d2, peers, [](float a, float b) { return a + b; });
        if (lead && d2 != 0.f) atomicAdd(out + (long long)p * G + g[k], d2);
      }
    }
  }
}

// The compact regime of K7, for Q <= 2 and Q * G <= kM2Cells (the main
// path's stddev/var by status: Q = 2, G = 8). A CTA of kCompactThreads
// threads streams a contiguous chunk of the block, a quad of 4 rows a
// thread: the quad's ids, mask bytes, value rows and valid rows by one
// 16-byte or 4-byte load each (where every input reaches a 16-byte phase
// after the same head), all issued before the thread adds anything, so it
// waits for memory once a quad; the first quad's loads fly while the CTA
// copies the block's means into shared memory. Each thread adds its rows'
// squares into a private column of kM2Cells cells in shared memory (thread
// t's cell c is word c * kCompactThreads + t: no two lanes of a warp share a
// bank), by a plain read and write, into the cell the row's group and value
// row select, so a NaN or inf value reaches its own group only. The row loop
// has no atomic, ballot, match or barrier. At its end two warps sum each
// cell over the columns, and the CTA adds each nonzero cell into `out` once.
// What holds it (PERF.md): a 2^20-row block (15.7 MB at Q = 2) is too small
// for the card to reach its streaming rate in one pass; one torch.sum over
// as many bytes takes about as long.
constexpr int kM2Cells = 16;  // [Q, G] cells of a thread's column
constexpr int kM2Quads = 2;   // quads a K7 thread takes, at most
constexpr int kM2Smem = kM2Cells * kCompactThreads * 4;  // bytes of a CTA's columns

template <bool VEC, int QT>  // QT: Q (1 or 2); G <= kM2Cells / QT
__global__ void __launch_bounds__(kCompactThreads)
    m2_compact_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                      const uint8_t* __restrict__ mask, const int* __restrict__ ids,
                      const float* __restrict__ mean, int G, Quads q, int quads,
                      float* __restrict__ out) {
  extern __shared__ float cols[];  // [kM2Cells][kCompactThreads]
  constexpr int kWarps = kCompactThreads / 32;
  static_assert(kWarps == 2 * kM2Cells, "two warps sum each cell");
  __shared__ float mu[kM2Cells];
  __shared__ float halves[kWarps];
  float* col = cols + threadIdx.x;
  const long long v0 = (long long)blockIdx.x * kCompactThreads * quads + threadIdx.x;
  for (int r = 0; r < quads; ++r) {
    const long long v = v0 + (long long)r * kCompactThreads;
    const bool in = v < q.nq + 2;
    int g[4], live[4], ok[QT][4];
    float x[QT][4];
    if (in) {
      load_part<VEC>(q, v, ids, g);
      load_part<VEC>(q, v, mask, live);
#pragma unroll
      for (int p = 0; p < QT; ++p) {
        load_part<VEC>(q, v, vals + p * q.n, x[p]);
        load_part<VEC>(q, v, valid + p * q.n, ok[p]);
      }
    }
    if (r == 0) {
      if (threadIdx.x < QT * G) mu[threadIdx.x] = mean[threadIdx.x];
#pragma unroll
      for (int c = 0; c < kM2Cells; ++c) col[c * kCompactThreads] = 0.f;
      __syncthreads();
    }
    if (!in) break;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!live[k] || (unsigned)g[k] >= (unsigned)G) continue;
#pragma unroll
      for (int p = 0; p < QT; ++p) {
        if (!ok[p][k]) continue;
        const int cell = p * G + g[k];
        const float d = __fsub_rn(x[p][k], mu[cell]);
        col[cell * kCompactThreads] += __fmul_rn(d, d);
      }
    }
  }
  __syncthreads();
  // cell w / 2, columns [512 (w % 2), + 512) by warp w, a float4 a lane at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4* half = reinterpret_cast<const float4*>(
      cols + (warp >> 1) * kCompactThreads + (warp & 1) * (kCompactThreads / 2));
  float t = 0.f;
#pragma unroll
  for (int i = lane; i < kCompactThreads / 8; i += 32) {
    const float4 f = half[i];
    t += (f.x + f.y) + (f.z + f.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  if (lane == 0) halves[warp] = t;
  __syncthreads();
  if (threadIdx.x < QT * G) {
    const float sum = halves[2 * threadIdx.x] + halves[2 * threadIdx.x + 1];
    if (sum != 0.f) atomicAdd(out + threadIdx.x, sum);
  }
}

}  // namespace

// acc: f32 [G * cap], folded in place. code_bytes: 1, 2 or 4. lut_idx null:
// the code is the slot; lut_rank null: presence (value 1).
extern "C" int distinct_fold(const int* ids, const void* codes, int code_bytes,
                             const uint8_t* mask, const int* lut_idx, const int* lut_rank, int V,
                             int cap, int G, long long N, float* acc, int mode, void* stream) {
  if (G <= 0 || cap <= 0 || N <= 0) return (int)cudaGetLastError();
  if (mode != kShared && mode != kGlobal && mode != kCompact) return (int)cudaErrorInvalidValue;
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
  if (mode == kCompact) {
    bool vec = false;
    const Quads q = make_quads(N, {{vals, 4}, {ids, 4}, {mask, 1}}, &vec);
    const long long W = bitmap_words(G, 1LL << 40);
    const long long smem_all = W ? 4 * (2 * W + G + 4 + (long long)G * kHalfNB) : 0;
    auto go = [&](auto kernel) {
      return launch_compact((const void*)kernel, kPctRows / 4, smem_all, q,
                            [&](int grid, int quads, int smem) {
        kernel<<<grid, kCompactThreads, (size_t)smem, s>>>(vals, ids, mask, G, q, quads, smem / 4,
                                                           lo, hi, scale, out);
      });
    };
    return (int)(vec ? go(pct_hist_compact_kernel<true>) : go(pct_hist_compact_kernel<false>));
  }
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
  if (mode != kShared && mode != kGlobal && mode != kCompact) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)Q * G * sizeof(float), s);
  if (err != cudaSuccess || N <= 0) return (int)err;
  std::vector<std::pair<const void*, int>> inputs{{ids, 4}, {mask, 1}};
  for (int p = 0; p < Q; ++p) {
    inputs.push_back({vals + (long long)p * N, 4});
    inputs.push_back({valid + (long long)p * N, 1});
  }
  bool vec = false;
  const Quads q = make_quads(N, inputs, &vec);
  if (mode == kCompact) {
    if (Q > 2 || Q * G > kM2Cells) return (int)cudaErrorInvalidValue;
    bool launched = false;
    auto go = [&](auto kernel) {
      err = launch_compact((const void*)kernel, kM2Quads, kM2Smem, q,
                           [&](int grid, int quads, int smem) {
        if (smem < kM2Smem) return;  // the CTA's columns must fit
        kernel<<<grid, kCompactThreads, kM2Smem, s>>>(vals, valid, mask, ids, mean, G, q, quads,
                                                      out);
        launched = true;
      });
      return err == cudaSuccess && !launched ? cudaErrorInvalidValue : err;
    };
    if (Q == 1) return (int)(vec ? go(m2_compact_kernel<true, 1>) : go(m2_compact_kernel<false, 1>));
    return (int)(vec ? go(m2_compact_kernel<true, 2>) : go(m2_compact_kernel<false, 2>));
  }
  if (mode == kShared) {
    const long long smem = 2LL * Q * G * 4;
    if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
    return (int)launch((const void*)m2_shared_kernel, (int)smem, N, [&](int grid) {
      m2_shared_kernel<<<grid, kThreads, (size_t)smem, s>>>(vals, valid, mask, ids, mean, Q, G, N,
                                                            out);
    });
  }
  // global: a quad a lane a step, as many CTAs as the quads need, at most 8 an SM
  return (int)launch((const void*)m2_global_kernel<true>, 0, q.nq + 2, [&](int grid) {
    if (vec) {
      m2_global_kernel<true><<<grid, kThreads, 0, s>>>(vals, valid, mask, ids, mean, Q, G, q, out);
    } else {
      m2_global_kernel<false><<<grid, kThreads, 0, s>>>(vals, valid, mask, ids, mean, Q, G, q, out);
    }
  });
}
