// Hand-written Hopper (sm_90a) kernel of the device mesh: K10 mesh_combine.
//
// Under a mesh, every device folds its row shard of a block into a partial
// of its own, and the partials combine into one. The JAX package does that
// inside its shard_map programs with XLA collectives over the `data` axis:
// psum / pmin / pmax of count, per-aggregate counts, sums, mins and maxs
// (parseable_tpu/parallel/mesh.py:91-95; the dense fold at
// query/executor_tpu.py:2982-2987, the local fold at :2533-2539), the
// distinct bitmaps' pmax (:2948), the histograms' psum (:2980), and Chan's
// two-psum recentre of the stddev/var moments (_psum_m2, :917-934). Here
// the D partials are first copied to the combining device (plain tensor
// copies, the counterpart of the ICI transfers) and stacked as parts
// f32 [D, R, W]; one launch of this kernel combines them into out f32
// [R, W], each row by its own op (desc int32 [R, 3]: op, n row, s row):
//
//   SUM  out = ((p0 + p1) + p2) + ...           (d in order)
//   MIN  the least of p0..pD-1, MAX the greatest, in the order of kernel B's
//        keys (-0.0 below +0.0); a NaN in any shard makes the result NaN,
//        and +-inf are values like any other, as in kernel B's partials;
//   M2   Chan's form as _psum_m2 computes it: n_t = sum n_d, s_t = sum s_d
//        (the rows `n row` and `s row`), mean_t = s_t / max(n_t, 1),
//        out = sum over d with n_d > 0 of
//              M2_d + (n_d * (mean_d - mean_t)) * (mean_d - mean_t),
//        mean_d = s_d / max(n_d, 1); a shard with n_d = 0 adds nothing.
//
// Every add, product and quotient is an explicit round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA and the plain PyTorch
// version (ops/mesh_cuda.py mesh_combine_plain), which runs the same
// operations one torch op at a time, gives the same bits.
//
// Bound: bytes. It reads the D partials once and writes the result once,
// (D + 1) R W 4 bytes (an M2 row also reads its n and s rows again, which
// the bound does not count). Design: the simple one the bound asks for, a
// thread a column of a row, consecutive threads on consecutive columns (each
// shard's read of a warp is one 128-byte line), the D shards walked in
// order in registers; one CTA row of the grid per partial row, so that the
// op is uniform across a CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Op { kSum = 0, kMin = 1, kMax = 2, kM2 = 3 };

// kernel B's order of f32 values as a signed int: -0.0 below +0.0
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}

__global__ void __launch_bounds__(kThreads)
    mesh_combine_kernel(const float* __restrict__ parts, const int* __restrict__ desc,
                        float* __restrict__ out, int d_count, int rows, long long width) {
  const int r = blockIdx.y;
  const int op = desc[3 * r];
  const long long plane = (long long)rows * width;  // one shard's partial
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x; w < width; w += step) {
    const float* p = parts + (long long)r * width + w;
    float acc;
    if (op == kSum) {
      acc = p[0];
      for (int d = 1; d < d_count; ++d) acc = __fadd_rn(acc, p[d * plane]);
    } else if (op == kMin || op == kMax) {
      acc = p[0];
      bool nan = acc != acc;
      for (int d = 1; d < d_count; ++d) {
        const float x = p[d * plane];
        nan |= x != x;
        const bool take = op == kMin ? order_key(x) < order_key(acc) : order_key(x) > order_key(acc);
        if (take) acc = x;
      }
      if (nan) acc = __int_as_float(0x7FC00000);
    } else {
      const float* pn = parts + (long long)desc[3 * r + 1] * width + w;
      const float* ps = parts + (long long)desc[3 * r + 2] * width + w;
      float n_t = pn[0], s_t = ps[0];
      for (int d = 1; d < d_count; ++d) {
        n_t = __fadd_rn(n_t, pn[d * plane]);
        s_t = __fadd_rn(s_t, ps[d * plane]);
      }
      const float mean_t = __fdiv_rn(s_t, n_t > 1.0f ? n_t : 1.0f);
      acc = 0.0f;
      for (int d = 0; d < d_count; ++d) {
        const float n_d = pn[d * plane];
        if (!(n_d > 0.0f)) continue;
        const float dev = __fsub_rn(__fdiv_rn(ps[d * plane], n_d > 1.0f ? n_d : 1.0f), mean_t);
        const float term = __fadd_rn(p[d * plane], __fmul_rn(__fmul_rn(n_d, dev), dev));
        acc = __fadd_rn(acc, term);
      }
    }
    out[(long long)r * width + w] = acc;
  }
}

}  // namespace

extern "C" int mesh_combine(const float* parts, const int* desc, float* out, int d_count,
                            int rows, long long width, void* stream) {
  if (d_count < 1 || rows < 1 || width < 1 || rows > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long ctas = (width + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 132);  // a grid-stride loop past it
  if (ctas > cap) ctas = cap;
  const dim3 grid((unsigned)ctas, (unsigned)rows);
  mesh_combine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(parts, desc, out, d_count,
                                                                   rows, width);
  return (int)cudaGetLastError();
}
