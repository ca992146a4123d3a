// Fused RMSNorm for Hopper (sm_90a): per row
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// in fp32, cast back to x's type (the gemma-style unit offset).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` / `rmsnorm_fused`
// (src/repro/kernels/rmsnorm/rmsnorm.py).  One CTA of 256 threads per row:
// a strided fp32 sum of squares, a warp-shuffle + shared-memory block
// reduction, then one elementwise pass.  There is no 256-row tile and no
// padded tail: the grid is the row count.
//
// Bound on the H100: bytes (one read and one write per element; the second
// read of the row hits L1/L2).  At the engine's shapes (28 to 448 rows of
// 2048) it moves under 4 MB and launch latency dominates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* x, const T* scale, T* out, int D, long long x_rs,
                   float eps) {
  const T* xr = x + blockIdx.x * x_rs;
  T* orow = out + static_cast<long long>(blockIdx.x) * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = repro::to_f(xr[d]);
    ss += v * v;
  }
  __shared__ float red[kThreads / 32];
  ss = repro::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? red[threadIdx.x] : 0.f;
    t = repro::warp_sum(t);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / static_cast<float>(D) + eps);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = repro::to_f(xr[d]) * r;
    orow[d] = repro::from_f<T>(v * (1.f + repro::to_f(scale[d])));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int D, long long x_rs, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), D, x_rs, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int dtype, int rows, int D, long long x_rs,
                              float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch<float>(x, scale, out, rows, D, x_rs, eps, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, scale, out, rows, D, x_rs, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
