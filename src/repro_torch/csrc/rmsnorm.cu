// Fused RMSNorm for Hopper (sm_90a): per row
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// in fp32, cast back to x's type (the gemma-style unit offset).
//
// Replaces the Pallas TPU kernel `_rmsnorm_kernel` / `rmsnorm_fused`
// (src/repro/kernels/rmsnorm/rmsnorm.py).  Bound on the H100: bytes (each
// element read once and written once), and at the engine's shapes (28 to
// 7168 rows, 0.2-4 MB) the launch and one round trip to device memory.
//
// Rows are packed into CTAs: a group of `lanes` threads (a power of two)
// owns one row, and a CTA of max(lanes, 128) threads holds 128 / lanes
// rows.  Each lane reads its `ITEMS` loads of `VEC` elements once into
// registers (VEC = 16 bytes' worth when the rows, the scale and the row
// stride are 16-byte aligned, else 1), sums their squares, reduces with
// warp shuffles (a butterfly, so every lane gets the same bits), and writes
// the row once with the same vector width.  Only a row wider than a warp
// meets its other warps in shared memory, behind one barrier, and adds
// their partial sums in warp order.  The launch plan (VEC, lanes, ITEMS)
// comes from the shapes alone: `kernels/rmsnorm/ops.py:launch_plan`.
//   olmoe's qk-norm, 7168 x 128 bf16: 16 lanes x 8 values a row, 8 rows a
//   CTA, 896 CTAs; d_model 2048 / 4096 bf16: 128 / 256 lanes x 16 values,
//   one row a CTA.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCtaThreads = 128;

// VEC elements at p as fp32: one 16-byte load, or one scalar load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = repro::to_f(*p);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = repro::to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = repro::from_f<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = repro::from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int rows, int D, long long x_rs,
                   int lanes, float eps) {
  const int slot = threadIdx.x / lanes;           // row within the CTA
  const int lane = threadIdx.x & (lanes - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + slot;
  const bool live = row < rows;
  const int nv = D / VEC;                         // vectors in a row
  const T* xr = x + row * x_rs;
  T* orow = out + row * D;

  float v[ITEMS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int vi = it * lanes + lane;
    if (live && vi < nv) {
      load_vec<T, VEC>(xr + vi * VEC, v[it]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[it][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss += v[it][e] * v[it][e];
  }
  // Butterfly over the row's lanes within a warp: every lane of a group
  // ends with the same sum, and every warp runs the shuffles whole.
  const int width = lanes < 32 ? lanes : 32;
  for (int off = width >> 1; off > 0; off >>= 1)
    ss += __shfl_xor_sync(repro::kFullMask, ss, off);
  if (lanes > 32) {
    // A row spans lanes / 32 warps: add their sums in warp order.
    __shared__ float red[kMaxThreads / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = ss;
    __syncthreads();
    const int first = slot * (lanes >> 5);
    ss = 0.f;
    for (int w = 0; w < (lanes >> 5); ++w) ss += red[first + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int vi = it * lanes + lane;
    if (vi >= nv) continue;
    float s[VEC];
    load_vec<T, VEC>(scale + vi * VEC, s);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = v[it][e] * r * (1.f + s[e]);
    store_vec<T, VEC>(orow + vi * VEC, s);
  }
}

template <typename T, int VEC>
cudaError_t launch_items(const void* x, const void* scale, void* out,
                         int rows, int D, long long x_rs, int lanes,
                         int items, float eps, cudaStream_t stream) {
  const int threads = lanes > kCtaThreads ? lanes : kCtaThreads;
  const int per_cta = threads / lanes;
  const int grid = (rows + per_cta - 1) / per_cta;
  const T* xt = static_cast<const T*>(x);
  const T* st = static_cast<const T*>(scale);
  T* ot = static_cast<T*>(out);
  switch (items) {
    case 1:
      rmsnorm_kernel<T, VEC, 1><<<grid, threads, 0, stream>>>(
          xt, st, ot, rows, D, x_rs, lanes, eps);
      break;
    case 2:
      rmsnorm_kernel<T, VEC, 2><<<grid, threads, 0, stream>>>(
          xt, st, ot, rows, D, x_rs, lanes, eps);
      break;
    case 4:
      rmsnorm_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
          xt, st, ot, rows, D, x_rs, lanes, eps);
      break;
    case 8:
      if constexpr (VEC * 8 <= 32) {
        rmsnorm_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
            xt, st, ot, rows, D, x_rs, lanes, eps);
        break;
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int D, long long x_rs, int vec, int lanes, int items,
                   float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (lanes < 1 || lanes > kMaxThreads || (lanes & (lanes - 1)) != 0 ||
      static_cast<long long>(lanes) * items * vec < D)
    return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec == kVec && aligned && D % kVec == 0 && x_rs % kVec == 0)
    return launch_items<T, kVec>(x, scale, out, rows, D, x_rs, lanes, items,
                                 eps, stream);
  if (vec == 1)
    return launch_items<T, 1>(x, scale, out, rows, D, x_rs, lanes, items,
                              eps, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward, for training
// ---------------------------------------------------------------------------
//
// No Pallas kernel has a backward (the reference trains through its pure-JAX
// norm); the port's forward runs the kernel above, so its gradient is a
// kernel too.  Per row, with r = rsqrt(mean(x^2) + eps), xh = x r and
// g = dy (1 + scale), all in fp32:
//   dx     = r (g - xh mean(g xh))            written in x's dtype
//   dscale = sum over every row of dy xh      written in scale's dtype
// A group of `lanes` threads (a power of two, 32-1024) owns one row at a
// time, each lane every lanes-th column; a CTA of max(lanes, 256) threads
// holds threads / lanes such groups (slots) and walks rows slot-strided
// over a grid-stride loop, so a launch has at most kBwdMaxCtas CTAs
// whatever the row count.  Pass 1 reduces sum(x^2) and sum(g x) over the
// row's lanes (shuffles, then shared memory in warp order past a warp);
// pass 2 reads the row again (from L1/L2), writes dx and adds dy xh into
// the slot's fp32 column partials in shared memory.  dscale is a column sum
// over every row, so it is taken without atomics, in a fixed order: each
// CTA adds its slots' partials in slot order into one row of `part`
// [ctas, D], and a second kernel adds those rows in CTA order, compensated.
// The same inputs give the same bits.  Bound by bytes: x and dy read, dx
// written (the partials are ctas x D fp32 on top).

constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ scale, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int D,
                       long long x_rs, long long dy_rs, int lanes, float eps) {
  extern __shared__ float colsum[];               // [slots][D]
  __shared__ float red[2][kMaxThreads / 32];
  const int slots = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  float* mine = colsum + static_cast<long long>(slot) * D;
  for (int j = lane; j < D; j += lanes) mine[j] = 0.f;

  const long long stride = static_cast<long long>(gridDim.x) * slots;
  // The loop bound depends on the CTA alone, so every thread reaches the
  // barriers below the same number of times.
  for (long long row0 = static_cast<long long>(blockIdx.x) * slots;
       row0 < rows; row0 += stride) {
    const long long row = row0 + slot;
    const bool live = row < rows;
    const T* xr = x + row * x_rs;
    const T* dr = dy + row * dy_rs;
    float ss = 0.f, sg = 0.f;
    if (live) {
      for (int j = lane; j < D; j += lanes) {
        const float xv = repro::to_f(xr[j]);
        const float g = repro::to_f(dr[j]) * (1.f + repro::to_f(scale[j]));
        ss += xv * xv;
        sg += g * xv;
      }
    }
    const int width = lanes < 32 ? lanes : 32;
    for (int off = width >> 1; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(repro::kFullMask, ss, off);
      sg += __shfl_xor_sync(repro::kFullMask, sg, off);
    }
    if (lanes > 32) {
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) {
        red[0][warp] = ss;
        red[1][warp] = sg;
      }
      __syncthreads();
      const int first = slot * (lanes >> 5);
      ss = sg = 0.f;
      for (int w = 0; w < (lanes >> 5); ++w) {
        ss += red[0][first + w];
        sg += red[1][first + w];
      }
      __syncthreads();  // red is rewritten by the next row
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c = sg * r / static_cast<float>(D);  // mean(g xh)
    T* out = dx + row * D;
    for (int j = lane; j < D; j += lanes) {
      const float xh = repro::to_f(xr[j]) * r;
      const float d = repro::to_f(dr[j]);
      const float g = d * (1.f + repro::to_f(scale[j]));
      out[j] = repro::from_f<T>(r * (g - xh * c));
      mine[j] += d * xh;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < D; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slots; ++k)
      s += colsum[static_cast<long long>(k) * D + j];
    part[static_cast<long long>(blockIdx.x) * D + j] = s;
  }
}

// dscale[j] = sum over CTAs c, in order, of part[c, j].  The sum is
// compensated (Kahan): a plain running sum of hundreds of partials loses
// about sqrt(ctas) roundings of the running total, which on a column whose
// partials cancel is more than an fp32 sum over every row should.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_dscale_kernel(const float* __restrict__ part,
                          T* __restrict__ dscale, int ctas, int D) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D) return;
  float s = 0.f, lost = 0.f;
  for (int c = 0; c < ctas; ++c) {
    const float y = part[static_cast<long long>(c) * D + j] - lost;
    const float t = s + y;
    lost = (t - s) - y;
    s = t;
  }
  dscale[j] = repro::from_f<T>(s);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* scale,
                       void* dx, void* part, int rows, int D, long long x_rs,
                       long long dy_rs, int lanes, int threads, int ctas,
                       float eps, cudaStream_t s) {
  if (lanes < 32 || lanes > kMaxThreads || (lanes & (lanes - 1)) != 0 ||
      threads < lanes || threads > kMaxThreads || threads % lanes != 0 ||
      ctas < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(threads / lanes) * D * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<T><<<ctas, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(scale), static_cast<T*>(dx),
      static_cast<float*>(part), rows, D, x_rs, dy_rs, lanes, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dscale(const void* part, void* dscale, int ctas, int D,
                          cudaStream_t s) {
  if (ctas < 1) return cudaErrorInvalidValue;
  rmsnorm_dscale_kernel<T><<<(D + kBwdThreads - 1) / kBwdThreads,
                             kBwdThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(dscale), ctas, D);
  return cudaGetLastError();
}

}  // namespace

// The backward's rows: dx [rows, D] (row stride D) from x (row stride
// x_rs), dy (row stride dy_rs) and scale, on `ctas` CTAs of `threads`
// threads, `lanes` a row, and each CTA's fp32 column partials of dscale in
// `part` [ctas, D].  `rmsnorm_dscale_launch` then sums them.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* scale, void* dx, void* part,
                                  int dtype, int rows, int D, long long x_rs,
                                  long long dy_rs, int lanes, int threads,
                                  int ctas, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch_bwd<float>(x, dy, scale, dx, part, rows,
                                              D, x_rs, dy_rs, lanes, threads,
                                              ctas, eps, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(
        x, dy, scale, dx, part, rows, D, x_rs, dy_rs, lanes, threads, ctas,
        eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dscale [D] in scale's dtype: the column sum of `part` [ctas, D] (fp32),
// its rows added in order.
extern "C" int rmsnorm_dscale_launch(const void* part, void* dscale,
                                     int dtype, int ctas, int D,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch_dscale<float>(part, dscale, ctas, D, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        launch_dscale<__nv_bfloat16>(part, dscale, ctas, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int dtype, int rows, int D, long long x_rs,
                              int vec, int lanes, int items, float eps,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch<float>(x, scale, out, rows, D, x_rs, vec,
                                          lanes, items, eps, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(launch<__nv_bfloat16>(
        x, scale, out, rows, D, x_rs, vec, lanes, items, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
