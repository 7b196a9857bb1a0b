// Hand-written Hopper (sm_90a) kernels for the per-block group-by.
//
// One scanned block of the dense aggregate path reduces into a [rows, groups]
// partial aggregate. These kernels compute all of it. Main-path blocks hold
// N = 2^20 rows whose ids are often heavily skewed: a block is one minute
// file, so a time-bin key is constant in it, and `status` is 200 for half of
// the rows.
//
// Kernel A, additive_groupby: out[R, G] = rows[R, N] @ onehot(ids)[N, G].
//   Replaces parseable_tpu/ops/pallas_groupby.py:53 additive_groupby_pallas
//   (body _additive_kernel :33, pallas_call :63), the additive half of
//   parseable_tpu/ops/kernels.py:108 fused_groupby_block. The rows are
//   [row mask | per-aggregate validity | masked sums]. Ids outside [0, G) are
//   dropped, as the one-hot product drops them.
//   Bound: bytes. It must read ids and rows once, 4N(R+1) bytes; at N = 2^20,
//   R = 5 that is 25 MB, or 7.5 us at 3.35 TB/s. The wrapper picks one of
//   three regimes per shape (ops/groupby_cuda.py additive_regime); the entry
//   zeroes the output with a memset first.
//
//   tensor (R <= 8, G <= 128, the product's operations bound under the bytes
//     bound, and fewer 16-group m-tiles than value rows): the Pallas kernel's
//     own formula on the tensor cores, out^T[G, 3R] = onehot^T[G, K] X[K, 3R],
//     with mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each warp builds the
//     one-hot fragment in registers from its tile of ids, one bf16x2 compare
//     (HSET2) per register; it never touches memory. Each f32 value becomes
//     three bf16 pieces split by truncation, hi = x & 0xFFFF0000, mid =
//     trunc16(x - hi), lo = x - hi - mid: hi + mid + lo == x exactly and no
//     piece overflows (rounding 3.4e38 to bf16 gives inf). The pieces go to
//     three n-tiles, so a lane reads one float4 of its value row and makes
//     all three pieces with four instructions. The k order inside a 16-row
//     tile is permuted so that lane (group g, thread t) owns data rows
//     4t..4t+3 in both the A and the B fragment: its ids are one int4 and its
//     values one float4. Each warp streams 64-row chunks through a 3-stage
//     ring in shared memory filled by cp.async, so its loads hold no
//     registers. The [G, R] sums stay in registers for the whole row walk and
//     are flushed once per CTA, with at most G*R global atomics: no atomic is
//     left in the row loop, so skew costs nothing. What bounds it is the mma
//     issue (three per m-tile and 16 rows), so its time grows with G. A NaN
//     or +-inf value would poison every group of the product (inf * 0 = NaN),
//     so it enters the product as 0 and is added into its own group by a
//     global atomic on a side path. Counts (0/1 rows) are exact: 0/1 products
//     accumulate in f32, exact below 2^24. Pieces are exact in bf16 for
//     |x| >= 2^-110; below that the bits under 2^-133 are dropped.
//     Why mma.sync and not wgmma: the one-hot operand is made in registers
//     per 16-row tile and the product is tiny (M = G <= 128, N = 24); wgmma
//     wants its B operand in shared memory and 64-row tiles of A, so every
//     tile would take a round trip through shared memory and a fence for no
//     gain at these sizes.
//   shared (R*G*4 fits in shared memory): each CTA keeps an [R, G] f32
//     accumulator in shared memory and flushes its nonzero entries with
//     global atomics. Each lane loads four consecutive rows a step with
//     vector loads (the first 4 or 8 value rows in registers) before it folds
//     any, so a step waits on memory once. Aggregation is warp-adaptive (fold_peers below): a warp
//     whose ids collide heavily sums the lanes that share an id
//     (__match_any_sync, then pointer jumping over shuffles) and its leader
//     issues one atomic per distinct id and row; a warp of spread ids skips
//     the match, which costs more than the collisions it saves. The grid is
//     as many CTAs as the card holds: timed over CTA counts at G = 8192,
//     fewer CTAs, each flushing less, were slower; the flush is not what
//     costs, the reads need every SM.
//   global (anything larger; the block-local fold's 2^17-2^22 groups): what
//     bounds it is not its bytes but the L2's random operations. The card
//     does about the same number of them a second whatever their width, 16
//     bytes or 4 (PERF.md, scripts/torch_local_fold_variants.py), and in
//     [R, G] a row's R values lie G*4 bytes apart, R operations a row. So
//     the kernel folds into a group-major record [G, record_width(R)]
//     (scratch, zeroed by a memset): after the loads and the adaptive
//     aggregation of the shared regime (four rows a lane by vector loads,
//     one crowding probe a step), a row's values go in by one 16-byte
//     vector reduction (red.global.add.v4.f32) per four value rows, one
//     operation a row for R <= 4, and a row whose values are all 0 (a
//     masked-off row) is skipped. The loads are evict-first (read once), so
//     that the record keeps its place in L2, and the kernel runs at 64
//     registers, two CTAs of 512 an SM: at 32 it spilled and ran 1.3x
//     slower. A second launch lays the record out as [R, G], a thread a
//     group; it is bound by its bytes (a read of the record, a write of the
//     output: 13 us of 39 at R = 4, G = 2^20). A NaN or +-inf value adds
//     into its own group like any other.
//
// Kernel B, minmax_groupby: per-group min of the first n_min value rows and
//   max of the rest, with the semantics of kernels.py:233-248 (segment_min /
//   segment_max): a row that is masked off or invalid contributes +F32_MAX to
//   a min and -F32_MAX to a max; a group no row reaches keeps the identity,
//   +inf for a min and -inf for a max; a NaN propagates.
//   Bound: bytes. It reads ids, K value rows, K validity rows and the mask,
//   N(4 + 5K + 1) bytes, and writes 4KG.
//   Design: f32 maps to an order-preserving u32 key, complemented for a min,
//   so that every fold is an unsigned max and 0 means "no row": the key
//   buffer is zeroed with one memset, not a kernel. Rows fold into a per-CTA
//   [K, G] key array in shared memory with the same warp-adaptive
//   aggregation as kernel A, the max over peers taken by pointer jumping
//   over shuffles (__reduce_max_sync with a different peer mask in each
//   group of the warp measured several times slower), and a leader's atomic
//   only after a plain read shows it can change the key. Each CTA flushes
//   its keys into the global buffer; the last CTA to finish (a global
//   counter behind __threadfence) decodes them into the output, so one
//   launch does it all. Past ops/groupby_cuda.py MINMAX_DECODE_IN_KERNEL
//   (2048) entries the decode is a launch of its own, which is faster once
//   one CTA would walk thousands of keys alone (the wrapper's choice,
//   minmax_decode, timed both ways). When K*G*4 exceeds the
//   shared-memory budget the rows fold straight into the global buffer.
//
// Interface: plain C, called through ctypes. Every pointer is a device
// pointer; `stream` is the caller's cudaStream_t. The caller allocates the
// outputs; B's key buffer holds K*G + 1 words. Device attributes are read
// once per device and the occupancy of a kernel once per (device, kernel,
// shared-memory size). Each entry returns cudaGetLastError() after its
// launches (0 on success), or cudaErrorInvalidValue for a regime the shape
// does not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;       // atomic regimes and kernel B
constexpr int kGlobalCtas = 2;      // global regime, R <= 4: CTAs an SM must hold at once
constexpr bool kGlobalStream = true;  // global regime: evict-first loads of the rows
constexpr int kHeldB = 4;           // kernel B: value rows held in registers
constexpr int kTcThreads = 256;     // tensor regime: 8 warps
constexpr int kTcChunk = 64;        // rows of one ring stage: four 16-row k-tiles
constexpr int kTcStages = 3;        // ring stages per warp
constexpr int kTcMaxMTiles = 8;     // 16 groups each: G <= 128
constexpr int kTcCols = 8;          // value rows per n-tile: R <= 8
constexpr float kF32Max = 3.4e38f;

enum AdditiveMode { kTensor = 0, kShared = 1, kGlobal = 2 };

// CTAs for a kernel with a per-CTA accumulator: as many as the card holds at
// once, while there are rows for them. Fewer CTAs would shrink the flush, but
// on this card the flush is not what costs: the reads need every SM.
int resident_grid(long long n, long long resident) {
  return clamp_grid(ceil_div(n, (long long)kThreads * 4), resident);
}

int streaming_grid(long long n, int sms) {
  return clamp_grid(ceil_div(n, (long long)kThreads * 4), (long long)sms * 16);
}

// ------------------------------------------------------- kernel A, tensor

__device__ __forceinline__ float trunc16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// {lo, hi} as a bf16x2 register; both must be exact in bf16 (low 16 bits 0)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ unsigned bf16x2_of(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 1.0 or 0.0 in each bf16 half: a == b
__device__ __forceinline__ unsigned eq_bf16x2(unsigned a, unsigned b) {
  const __nv_bfloat162 r = __heq2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&r);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage of a warp's ring: the ids and up to 8 value rows of 64 rows. A
// value row is padded by 16 bytes so that the 8 rows of a fragment load fall
// in different banks.
constexpr int kStageIds = kTcChunk;                  // ints
constexpr int kStageRow = kTcChunk + 4;              // floats per value row
constexpr int kStageWords = kStageIds + kTcCols * kStageRow;
constexpr int kTcSmem = kTcThreads / 32 * kTcStages * kStageWords * 4;

// Copies chunk `c` (rows [64c, 64c + 64)) into `stage`: 16-byte cp.async
// copies spread over the lanes when the chunk is whole and aligned, else
// plain loads with the edge masked (ids past N become -1, values 0).
__device__ __forceinline__ void tc_stage_load(int* stage, const int* __restrict__ ids,
                                              const float* __restrict__ rows, int R,
                                              long long N, long long c, int vec) {
  const int lane = threadIdx.x & 31;
  const long long base = c * kTcChunk;
  float* vals = reinterpret_cast<float*>(stage + kStageIds);
  if (vec && base + kTcChunk <= N) {
    const int segs = (1 + R) * (kTcChunk / 4);  // 16-byte segments
    for (int s = lane; s < segs; s += 32) {
      const int row = s / (kTcChunk / 4) - 1, off = 4 * (s % (kTcChunk / 4));
      if (row < 0) {
        cp_async16(stage + off, ids + base + off);
      } else {
        cp_async16(vals + row * kStageRow + off, rows + (long long)row * N + base + off);
      }
    }
  } else {
    for (int j = lane; j < kTcChunk; j += 32) {
      const bool in = base + j < N;
      stage[j] = in ? ids[base + j] : -1;
      for (int r = 0; r < R; ++r) vals[r * kStageRow + j] = in ? rows[(long long)r * N + base + j] : 0.f;
    }
  }
}

// One 16-row k-tile from shared memory into the accumulators. Lane (g, t):
// g = lane / 4 is its value row (B column) and its group within each
// 16-group m-tile (with g + 8); t = lane % 4 owns data rows 4t..4t+3 of the
// tile, which stand at k = 2t, 2t+1, 2t+8, 2t+9 of the mma's K: the
// permutation makes its ids one int4 and its values one float4, in A's
// fragment and B's alike.
template <int MT>
__device__ __forceinline__ void tc_tile(const int* stage, int q, const unsigned (&target)[MT][2],
                                        float (&acc)[MT][3][4], float* __restrict__ out, int G,
                                        int R) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int4 iv = *reinterpret_cast<const int4*>(stage + 16 * q + 4 * tig);
  float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (gid < R) {
    xv = *reinterpret_cast<const float4*>(stage + kStageIds + gid * kStageRow + 16 * q + 4 * tig);
  }
  const int id[4] = {iv.x, iv.y, iv.z, iv.w};
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = (unsigned)id[e] < (unsigned)G ? (float)id[e] : -1.f;
  const unsigned ids01 = bf16x2_of(f[0], f[1]), ids23 = bf16x2_of(f[2], f[3]);

  const float x[4] = {xv.x, xv.y, xv.z, xv.w};
  float hi[4], d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = trunc16(x[e]);
    d[e] = x[e] - hi[e];  // NaN exactly when x is NaN or +-inf
  }
  const float probe = (d[0] + d[1]) + (d[2] + d[3]);
  if (probe != probe) {
    // side path: a non-finite value goes into its own group only
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!isfinite(x[e])) {
        if ((unsigned)id[e] < (unsigned)G) atomicAdd(&out[(long long)gid * G + id[e]], x[e]);
        hi[e] = 0.f;
        d[e] = 0.f;
      }
    }
  }
  float mid[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mid[e] = trunc16(d[e]);
    lo[e] = d[e] - mid[e];
  }
  const unsigned b[3][2] = {{pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3])},
                            {pack_bf16(mid[0], mid[1]), pack_bf16(mid[2], mid[3])},
                            {pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3])}};
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const unsigned a[4] = {eq_bf16x2(ids01, target[j][0]), eq_bf16x2(ids01, target[j][1]),
                           eq_bf16x2(ids23, target[j][0]), eq_bf16x2(ids23, target[j][1])};
#pragma unroll
    for (int p = 0; p < 3; ++p) mma_bf16(acc[j][p], a, b[p][0], b[p][1]);
  }
}

// Each warp walks 64-row chunks through a ring of kTcStages stages in shared
// memory, kept full with cp.async, so that its loads need no registers and
// overlap its mma work.
template <int MT>
__global__ void __launch_bounds__(kTcThreads, MT <= 4 ? 2 : 1)
    additive_tc_kernel(const int* __restrict__ ids, const float* __restrict__ rows,
                       float* __restrict__ out, int R, long long N, int G, int vec) {
  extern __shared__ __align__(16) int ring[];  // [warps][kTcStages][kStageWords]
  __shared__ float part[MT * 16 * kTcCols];    // [group][value row], the CTA's sums
  for (int j = threadIdx.x; j < MT * 16 * kTcCols; j += blockDim.x) part[j] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3, warp = threadIdx.x >> 5;
  int* my_ring = ring + warp * kTcStages * kStageWords;
  unsigned target[MT][2];  // groups 16j + gid and 16j + gid + 8, in both halves
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float t = (float)(16 * j + gid + 8 * h);
      target[j][h] = bf16x2_of(t, t);
    }
  }
  float acc[MT][3][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][p][e] = 0.f;

  const int warps = blockDim.x >> 5;
  const long long nwarps = (long long)gridDim.x * warps;
  const long long chunks = ceil_div(N, kTcChunk);
  const long long first = (long long)blockIdx.x * warps + warp;
  const long long mine = first < chunks ? ceil_div(chunks - first, nwarps) : 0;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < mine) tc_stage_load(my_ring + s * kStageWords, ids, rows, R, N, first + s * nwarps, vec);
    cp_async_commit();
  }
  for (long long k = 0; k < mine; ++k) {
    const long long ahead = k + kTcStages - 1;
    if (ahead < mine) {
      tc_stage_load(my_ring + (int)(ahead % kTcStages) * kStageWords, ids, rows, R, N,
                    first + ahead * nwarps, vec);
    }
    cp_async_commit();
    cp_async_wait<kTcStages - 1>();
    __syncwarp();
    const int* stage = my_ring + (int)(k % kTcStages) * kStageWords;
#pragma unroll
    for (int q = 0; q < kTcChunk / 16; ++q) tc_tile<MT>(stage, q, target, acc, out, G, R);
    __syncwarp();
  }

  // D fragment: element 2h + c is group 16j + gid + 8h, value row 2t + c.
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = 16 * j + gid + 8 * (e >> 1), r = 2 * tig + (e & 1);
      const float s = (acc[j][2][e] + acc[j][1][e]) + acc[j][0][e];
      if (s != 0.f && r < R && g < G) atomicAdd(&part[g * kTcCols + r], s);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < MT * 16 * kTcCols; j += blockDim.x) {
    const int g = j / kTcCols, r = j % kTcCols;
    const float v = part[j];
    if (g < G && r < R && v != 0.f) atomicAdd(&out[(long long)r * G + g], v);
  }
}

// ------------------------------------------------- kernel A, atomic regimes

// Four consecutive entries of one array from entry i: one vector load when
// `whole` (aligned, all four inside), else one by one with `fill` past N.
// CS: evict-first loads (ld.global.cs) for data read once, so that what the
// kernel writes keeps its place in L2.
template <bool CS, typename T>
__device__ __forceinline__ T load1(const T* p) {
  return CS ? __ldcs(p) : __ldg(p);
}

template <bool CS = false>
__device__ __forceinline__ void load4(int (&d)[4], const int* __restrict__ p, long long i,
                                      long long N, bool whole, int fill) {
  if (whole) {
    const int4 v = load1<CS>(reinterpret_cast<const int4*>(p + i));
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = i + e < N ? load1<CS>(p + i + e) : fill;
  }
}

template <bool CS = false>
__device__ __forceinline__ void load4(float (&d)[4], const float* __restrict__ p, long long i,
                                      long long N, bool whole, float fill) {
  if (whole) {
    const float4 v = load1<CS>(reinterpret_cast<const float4*>(p + i));
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = i + e < N ? load1<CS>(p + i + e) : fill;
  }
}

__device__ __forceinline__ void load4(uint8_t (&d)[4], const uint8_t* __restrict__ p, long long i,
                                      long long N, bool whole, uint8_t fill) {
  if (whole) {
    const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(p + i));
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = i + e < N ? __ldg(p + i + e) : fill;
  }
}

// Each lane folds four consecutive rows a step (a warp 128); every load of
// the step, the first HELD value rows held in registers, is issued before
// the first fold, so a step waits on memory once.
// With 4 held rows the kernel fits in 32 registers, so that four CTAs share
// an SM and one wave covers a main-path block of 2^20 rows.
template <int HELD>
__global__ void __launch_bounds__(kThreads, HELD <= 4 ? 4 : 2)
    additive_shared_kernel(const int* __restrict__ ids, const float* __restrict__ rows,
                           float* __restrict__ out, int R, long long N, int G, int vec) {
  extern __shared__ float acc[];  // [R, G]
  for (int j = threadIdx.x; j < R * G; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x * 4;
  // warp-uniform loop: every lane takes part in the match below
  for (long long base = ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * 4;
       base < N; base += step) {
    const long long i = base + 4 * lane;
    const bool whole = vec && i + 4 <= N;
    int g[4];
    float v[HELD][4];
    load4(g, ids, i, N, whole, -1);
#pragma unroll
    for (int r = 0; r < HELD; ++r) {
      if (r < R) {
        load4(v[r], rows + (long long)r * N, i, N, whole, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[r][e] = 0.f;
      }
    }
    const bool crowd = crowded((unsigned)g[0] < (unsigned)G ? g[0] : -1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool inside = (unsigned)g[e] < (unsigned)G;
      const Peers peers = fold_peers(inside ? g[e] : -1, crowd);
      auto fold = [&](int r, float x) {
        x = peer_reduce(x, peers, [](float a, float b) { return a + b; });
        if (inside && peers.leader && x != 0.f) atomicAdd(acc + r * G + g[e], x);
      };
#pragma unroll
      for (int r = 0; r < HELD; ++r) {
        if (r < R) fold(r, v[r][e]);
      }
      for (int r = HELD; r < R; ++r) fold(r, i + e < N ? rows[(long long)r * N + i + e] : 0.f);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < R * G; j += blockDim.x) {
    const float x = acc[j];
    if (x != 0.f) atomicAdd(&out[j], x);
  }
}

// Floats of a group's record in the "global" regime: R rounded up to whole
// 16-byte vectors (ops/groupby_cuda.py record_width).
__host__ __device__ inline int record_width(int R) { return (R + 3) & ~3; }

// One row's values x[0..3] of value rows c..c+3 into its group g's record:
// summed over the lanes that share g when the warp is crowded (every lane
// must call it), then one 16-byte vector reduction by the leader. A chunk
// whose four values are all 0 is skipped.
__device__ __forceinline__ void fold_chunk(float* __restrict__ record, int g, int c, float (&x)[4],
                                           const Peers& peers, bool lead, int R) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = peer_reduce(x[k], peers, [](float a, float b) { return a + b; });
  }
  if (lead && (x[0] != 0.f || x[1] != 0.f || x[2] != 0.f || x[3] != 0.f)) {
    red_add4(record + (long long)g * record_width(R) + c, x[0], x[1], x[2], x[3]);
  }
}

// The "global" regime's fold into a group-major record [G, record_width(R)].
// Loads as additive_shared_kernel (four rows a lane, every load of the step
// before the first fold, HELD value rows held in registers); the crowding
// probe runs once a step; a row folds into its group with one vector
// reduction per four value rows, one L2 operation a row for R <= 4.
template <int HELD>
__global__ void __launch_bounds__(kThreads, HELD <= 4 ? kGlobalCtas : 2)
    additive_global_kernel(const int* __restrict__ ids, const float* __restrict__ rows,
                           float* __restrict__ record, int R, long long N, int G, int vec) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x * 4;
  for (long long base = ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * 4;
       base < N; base += step) {
    const long long i = base + 4 * lane;
    const bool whole = vec && i + 4 <= N;
    int g[4];
    float v[HELD][4];
    load4<kGlobalStream>(g, ids, i, N, whole, -1);
#pragma unroll
    for (int r = 0; r < HELD; ++r) {
      if (r < R) {
        load4<kGlobalStream>(v[r], rows + (long long)r * N, i, N, whole, 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[r][e] = 0.f;
      }
    }
    const bool crowd = crowded((unsigned)g[0] < (unsigned)G ? g[0] : -1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool inside = (unsigned)g[e] < (unsigned)G;
      const Peers peers = fold_peers(inside ? g[e] : -1, crowd);
      const bool lead = inside && peers.leader;
#pragma unroll
      for (int c = 0; c < HELD; c += 4) {
        if (c < R) {
          float x[4] = {v[c][e], v[c + 1][e], v[c + 2][e], v[c + 3][e]};
          fold_chunk(record, g[e], c, x, peers, lead, R);
        }
      }
      for (int c = HELD; c < R; c += 4) {  // value rows past the held ones
        float x[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float* at = rows + (long long)(c + k) * N + i + e;
          x[k] = c + k < R && i + e < N ? load1<kGlobalStream>(at) : 0.f;
        }
        fold_chunk(record, g[e], c, x, peers, lead, R);
      }
    }
  }
}

// The record [G, record_width(R)] into out [R, G]: a thread a group, one
// 16-byte read per four value rows and one 4-byte write a value row, both
// coalesced over the warp. Bound by its bytes.
__global__ void additive_record_rows_kernel(const float* __restrict__ record, int R, int G,
                                            float* __restrict__ out) {
  const int width = record_width(R);
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < G;
       g += (long long)gridDim.x * blockDim.x) {
    for (int c = 0; c < R; c += 4) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(record + g * width + c));
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c + k < R) out[(long long)(c + k) * G + g] = x[k];
      }
    }
  }
}

// ------------------------------------------------------------------ kernel B

// Order-preserving u32 key of a f32, complemented for a min so that both fold
// with an unsigned max. 0 is left free for "no row"; a NaN takes 0xFFFFFFFF,
// above every value, so it propagates through min and max alike.
__device__ __forceinline__ unsigned enc_key(float x, bool is_min) {
  if (x != x) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(x);
  const unsigned u = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return is_min ? ~u : u;
}

__device__ __forceinline__ float dec_key(unsigned k, bool is_min) {
  if (k == 0u) return is_min ? INFINITY : -INFINITY;
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  const unsigned u = is_min ? ~k : k;
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

template <bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
    minmax_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                  const uint8_t* __restrict__ valid, const uint8_t* __restrict__ mask,
                  unsigned* __restrict__ keys, float* __restrict__ out, int K, int n_min,
                  long long N, int G, int vec, int decode) {
  extern __shared__ unsigned local[];  // [K, G] unless GLOBAL; 0 = no row yet
  __shared__ bool last;
  const int kg = K * G;
  unsigned* acc = GLOBAL ? keys : local;
  if (!GLOBAL) {
    for (int j = threadIdx.x; j < kg; j += blockDim.x) local[j] = 0u;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * blockDim.x * 4;
  // four consecutive rows a lane, all loads first, as in kernel A
  for (long long base = ((long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31)) * 4;
       base < N; base += step) {
    const long long i = base + 4 * lane;
    const bool whole = vec && i + 4 <= N;
    int g[4];
    uint8_t live[4];
    float v[kHeldB][4];
    uint8_t ok[kHeldB][4];
    load4(g, ids, i, N, whole, -1);
    load4(live, mask, i, N, whole, (uint8_t)0);
#pragma unroll
    for (int k = 0; k < kHeldB; ++k) {
      if (k < K) {
        load4(v[k], vals + (long long)k * N, i, N, whole, 0.f);
        load4(ok[k], valid + (long long)k * N, i, N, whole, (uint8_t)0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[k][e] = 0.f, ok[k][e] = 0;
      }
    }
    const bool crowd = crowded((unsigned)g[0] < (unsigned)G ? g[0] : -1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool inside = (unsigned)g[e] < (unsigned)G;
      const Peers peers = fold_peers(inside ? g[e] : -1, crowd);
      const bool leader = inside && peers.leader;
      auto fold = [&](int k, bool use, float x) {
        const bool is_min = k < n_min;
        if (!use) x = is_min ? kF32Max : -kF32Max;
        const unsigned key = peer_reduce(inside ? enc_key(x, is_min) : 0u, peers,
                                         [](unsigned a, unsigned b) { return a > b ? a : b; });
        if (leader) {
          unsigned* p = acc + (long long)k * G + g[e];
          if (key > (GLOBAL ? __ldcg(p) : *p)) atomicMax(p, key);
        }
      };
#pragma unroll
      for (int k = 0; k < kHeldB; ++k) {
        if (k < K) fold(k, live[e] && ok[k][e], v[k][e]);
      }
      for (int k = kHeldB; k < K; ++k) {
        const long long at = (long long)k * N + i + e;
        const bool use = i + e < N && live[e] && valid[at] != 0;
        fold(k, use, use ? vals[at] : 0.f);
      }
    }
  }

  if (!GLOBAL) {
    __syncthreads();
    for (int j = threadIdx.x; j < kg; j += blockDim.x) {
      const unsigned x = local[j];
      if (x != 0u && x > __ldcg(keys + j)) atomicMax(keys + j, x);
    }
  }
  if (!decode) return;
  // the last CTA to finish decodes every key
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(keys + kg, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < kg; j += blockDim.x) out[j] = dec_key(__ldcg(keys + j), j / G < n_min);
}

__global__ void minmax_decode_kernel(const unsigned* __restrict__ keys, float* __restrict__ out,
                                     long long kg, int n_min, int G) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < kg;
       j += (long long)gridDim.x * blockDim.x) {
    out[j] = dec_key(keys[j], j / G < n_min);
  }
}

// ---------------------------------------------------------------- launches

template <int MT>
cudaError_t launch_tc(int dev, const DeviceInfo& info, const int* ids, const float* rows,
                      float* out, int R, long long N, int G, int vec, cudaStream_t s) {
  const void* fn = (const void*)additive_tc_kernel<MT>;
  int per_sm = 0;
  cudaError_t err = resident_ctas(dev, fn, kTcThreads, kTcSmem, &per_sm);
  if (err != cudaSuccess) return err;
  const long long chunks = ceil_div(N, kTcChunk);
  const int grid = clamp_grid(ceil_div(chunks, kTcThreads / 32), (long long)per_sm * info.sms);
  additive_tc_kernel<MT><<<grid, kTcThreads, kTcSmem, s>>>(ids, rows, out, R, N, G, vec);
  return cudaSuccess;
}

template <int HELD>
cudaError_t launch_shared(int dev, const DeviceInfo& info, const int* ids, const float* rows,
                          float* out, int R, long long N, int G, int vec, cudaStream_t s) {
  const int smem = R * G * (int)sizeof(float);
  int per_sm = 0;
  const cudaError_t err =
      resident_ctas(dev, (const void*)additive_shared_kernel<HELD>, kThreads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int grid = resident_grid(N, (long long)per_sm * info.sms);
  additive_shared_kernel<HELD><<<grid, kThreads, (size_t)smem, s>>>(ids, rows, out, R, N, G, vec);
  return cudaSuccess;
}

cudaError_t launch_global(const DeviceInfo& info, const int* ids, const float* rows, float* record,
                          float* out, int R, long long N, int G, int vec, cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(record, 0, (size_t)record_width(R) * G * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (N > 0) {
    const int grid = streaming_grid(N, info.sms);
    if (R <= 4) {
      additive_global_kernel<4><<<grid, kThreads, 0, s>>>(ids, rows, record, R, N, G, vec);
    } else {
      additive_global_kernel<8><<<grid, kThreads, 0, s>>>(ids, rows, record, R, N, G, vec);
    }
  }
  if (out != nullptr) {
    additive_record_rows_kernel<<<streaming_grid(G, info.sms), kThreads, 0, s>>>(record, R, G, out);
  }
  return cudaSuccess;
}

}  // namespace

// mode: 0 tensor, 1 shared, 2 global (the wrapper's regime choice). out:
// [R, G], zeroed first. The global regime folds into `record`, scratch of
// [G, record_width(R)] floats, zeroed first, then lays it out into `out`
// (left as the record when `out` is null); the other regimes ignore it.
extern "C" int additive_groupby(const int* ids, const float* rows, float* record, float* out,
                                int R, long long N, int G, int mode, void* stream) {
  if (R <= 0 || G <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  if (mode == kTensor && (R > kTcCols || (G + 15) / 16 > kTcMaxMTiles)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = (long long)R * G * sizeof(float);
  if (mode == kShared && smem > smem_budget(info)) return (int)cudaErrorInvalidValue;
  if (mode != kTensor && mode != kShared && mode != kGlobal) return (int)cudaErrorInvalidValue;
  const int vec = (N % 4 == 0) && ((uintptr_t)ids % 16 == 0) && ((uintptr_t)rows % 16 == 0);
  if (mode == kGlobal) {
    if (record == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_global(info, ids, rows, record, out, R, N, G, vec, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)R * G * sizeof(float), s);
  if (err != cudaSuccess || N <= 0) return (int)err;
  if (mode == kTensor) {
    switch ((G + 15) / 16) {
      case 1: err = launch_tc<1>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 2: err = launch_tc<2>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 3: err = launch_tc<3>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 4: err = launch_tc<4>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 5: err = launch_tc<5>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 6: err = launch_tc<6>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      case 7: err = launch_tc<7>(dev, info, ids, rows, out, R, N, G, vec, s); break;
      default: err = launch_tc<8>(dev, info, ids, rows, out, R, N, G, vec, s); break;
    }
  } else {
    err = R <= 4 ? launch_shared<4>(dev, info, ids, rows, out, R, N, G, vec, s)
                 : launch_shared<8>(dev, info, ids, rows, out, R, N, G, vec, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// keys: K*G + 1 words of scratch (the last is the CTA counter); out: [K, G].
// decode: 1 = the last CTA decodes the keys, 0 = a decode launch of its own
// (the wrapper's choice, groupby_cuda.minmax_decode).
extern "C" int minmax_groupby(const int* ids, const float* vals, const uint8_t* valid,
                              const uint8_t* mask, unsigned* keys, float* out, int K, int n_min,
                              long long N, int G, int decode, void* stream) {
  if (K <= 0 || G <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  int dev = 0;
  cudaGetDevice(&dev);
  const DeviceInfo info = device_info(dev);
  const long long kg = (long long)K * G;
  cudaError_t err = cudaMemsetAsync(keys, 0, (size_t)(kg + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const int vec = (N % 4 == 0) && ((uintptr_t)ids % 16 == 0) && ((uintptr_t)vals % 16 == 0) &&
                  ((uintptr_t)valid % 4 == 0) && ((uintptr_t)mask % 4 == 0);
  const long long smem = kg * (long long)sizeof(unsigned);
  if (smem <= smem_budget(info)) {
    const void* fn = (const void*)minmax_kernel<false>;
    int per_sm = 0;
    err = resident_ctas(dev, fn, kThreads, (int)smem, &per_sm);
    if (err != cudaSuccess) return (int)err;
    const int grid = resident_grid(N, (long long)per_sm * info.sms);
    minmax_kernel<false><<<grid, kThreads, (size_t)smem, s>>>(ids, vals, valid, mask, keys, out,
                                                              K, n_min, N, G, vec, decode);
  } else {
    minmax_kernel<true><<<streaming_grid(N, info.sms), kThreads, 0, s>>>(
        ids, vals, valid, mask, keys, out, K, n_min, N, G, vec, decode);
  }
  if (!decode) {
    minmax_decode_kernel<<<streaming_grid(kg, info.sms), kThreads, 0, s>>>(keys, out, kg, n_min,
                                                                           G);
  }
  return (int)cudaGetLastError();
}
