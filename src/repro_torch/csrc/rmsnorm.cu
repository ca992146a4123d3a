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
// Bound by bytes: x and dy read once, dx written once.
//
// One pass, in registers, one launch.  A row is held by `lanes` threads in
// the forward's layout (`ops.launch_plan`: ITEMS loads of VEC elements a
// lane, 16-byte vectors where the rows, the strides and the bases allow,
// else one element at a time), so x and dy are read once, as loaded, and
// dx is written from the same registers.  A CTA of 1024 threads (one an
// SM) holds threads / lanes rows at a time (slots, at most 15 where a row
// spans warps) and walks the rows slot-strided over a grid-stride loop; a
// row's sums cross its warps through shared memory (double-buffered by
// row, one named barrier of the row's own warps a row; none within a
// warp).  A lane owns the same columns on every row it takes, so its dscale
// partials stay in registers until the CTA's rows are done (scale is read
// again at each use, from L1, so that x, dy and the partials fit 64
// registers a thread).  Then the CTA adds its slots' partials in slot
// order into its row of `part`, and dscale, a column sum over every row,
// is taken in the same launch without atomic sums, in a fixed order: the
// last CTA of each group of `group` CTAs to finish (a ticket on a device
// counter, atomicInc, which wraps the counter back to 0 for the next
// launch) adds its group's rows in CTA order, and the last group to finish
// adds the groups' rows in order and writes dscale.  Both sums are
// compensated (Kahan): a plain running sum over hundreds of partials loses
// about sqrt(n) roundings of the total, more than an fp32 sum over every
// row should on a column whose partials cancel.  The same inputs give the
// same bits.  The two sums are the serial tail of a launch (PERF.md).

// VEC elements of T as loaded: one 16-byte vector, or one element.
template <typename T, int VEC>
struct Raw {
  using type = uint4;
  static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes");
  __device__ __forceinline__ static type load(const T* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static type zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ static float at(const type& v, int i) {
    return repro::to_f(reinterpret_cast<const T*>(&v)[i]);
  }
};

template <typename T>
struct Raw<T, 1> {
  using type = T;
  __device__ __forceinline__ static type load(const T* p) { return *p; }
  __device__ __forceinline__ static type zero() {
    return repro::from_f<T>(0.f);
  }
  __device__ __forceinline__ static float at(const type& v, int) {
    return repro::to_f(v);
  }
};

// Columns [j, j + W) of rows [r0, r0 + n) of `part` (row length D, W = 4:
// 16-byte aligned rows), each added in row order, compensated, into out.
// Eight rows' loads are in flight before their adds.
template <int W>
__device__ __forceinline__ void column_sums(const float* part, int r0, int n,
                                            int D, int j, float (&out)[W]) {
  constexpr int kRows = 8;
  float lost[W];
#pragma unroll
  for (int w = 0; w < W; ++w) out[w] = lost[w] = 0.f;
  for (int c0 = r0; c0 < r0 + n; c0 += kRows) {
    float v[kRows][W];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (c0 + i >= r0 + n) continue;
      const float* p = part + static_cast<long long>(c0 + i) * D + j;
      if constexpr (W == 4) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
        v[i][0] = q.x;
        v[i][1] = q.y;
        v[i][2] = q.z;
        v[i][3] = q.w;
      } else {
        v[i][0] = __ldcg(p);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (c0 + i >= r0 + n) break;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float y = v[i][w] - lost[w];
        const float t = out[w] + y;
        lost[w] = (t - out[w]) - y;
        out[w] = t;
      }
    }
  }
}

// Row `dst` of `part` (or dscale, when `fin`) = the column sums of rows
// [r0, r0 + n), by the CTA's threads: four columns a thread where the rows
// are 16-byte aligned (D a multiple of 4), else one.
template <typename T>
__device__ __forceinline__ void sum_rows(float* part, int r0, int n, int D,
                                         long long dst, T* dscale, bool fin) {
  if (D % 4 == 0) {
    for (int j = 4 * threadIdx.x; j < D; j += 4 * blockDim.x) {
      float s[4];
      column_sums<4>(part, r0, n, D, j, s);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (fin)
          dscale[j + w] = repro::from_f<T>(s[w]);
        else
          part[dst * D + j + w] = s[w];
      }
    }
  } else {
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float s[1];
      column_sums<1>(part, r0, n, D, j, s);
      if (fin)
        dscale[j] = repro::from_f<T>(s[0]);
      else
        part[dst * D + j] = s[0];
    }
  }
}

template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(kMaxThreads, 1)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ scale, T* __restrict__ dx,
                       T* __restrict__ dscale, float* __restrict__ part,
                       unsigned int* __restrict__ tickets, int rows, int D,
                       long long x_rs, long long dy_rs, int lanes, int group,
                       float eps) {
  using V = Raw<T, VEC>;
  using R = typename V::type;
  extern __shared__ float colsum[];            // [slots][D] when slots > 1
  __shared__ float2 red[2][kMaxThreads / 32];  // a row's sums, by warp
  __shared__ bool last;
  const int slots = blockDim.x / lanes;
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const int nv = D / VEC;                      // vectors in a row

  float acc[ITEMS][VEC];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[it][e] = 0.f;

  const long long stride = static_cast<long long>(gridDim.x) * slots;
  int buf = 0;
  // The loop bound depends on the CTA alone, so every thread reaches the
  // shuffles and barriers below the same number of times.
  for (long long row0 = static_cast<long long>(blockIdx.x) * slots;
       row0 < rows; row0 += stride, buf ^= 1) {
    const long long row = row0 + slot;
    const bool live = row < rows;
    R xr[ITEMS], dr[ITEMS];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int vi = it * lanes + lane;
      if (live && vi < nv) {
        xr[it] = V::load(x + row * x_rs + vi * VEC);
        dr[it] = V::load(dy + row * dy_rs + vi * VEC);
      } else {
        xr[it] = dr[it] = V::zero();
      }
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int vi = it * lanes + lane;
      // scale: read at each use (L1), not held across rows.
      const R sv = live && vi < nv ? V::load(scale + vi * VEC) : V::zero();
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xv = V::at(xr[it], e);
        const float g = V::at(dr[it], e) * (1.f + V::at(sv, e));
        ss += xv * xv;
        sg += g * xv;
      }
    }
    // Butterfly over the row's lanes within a warp (every lane ends with
    // the same sums), then across the row's warps in warp order.
    const int width = lanes < 32 ? lanes : 32;
    for (int off = width >> 1; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(repro::kFullMask, ss, off);
      sg += __shfl_xor_sync(repro::kFullMask, sg, off);
    }
    if (lanes > 32) {
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) red[buf][warp] = make_float2(ss, sg);
      // The row's warps only; the buffer alternates by row, so a warp
      // that runs ahead writes the other one.
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(lanes)
                   : "memory");
      const int first = slot * (lanes >> 5);
      ss = sg = 0.f;
      for (int w = 0; w < (lanes >> 5); ++w) {
        ss += red[buf][first + w].x;
        sg += red[buf][first + w].y;
      }
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    const float c = sg * r / static_cast<float>(D);  // mean(g xh)
    T* out = dx + row * D;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int vi = it * lanes + lane;
      if (vi >= nv) continue;
      const R sv = V::load(scale + vi * VEC);
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = V::at(dr[it], e);
        const float xh = V::at(xr[it], e) * r;
        o[e] = r * (d * (1.f + V::at(sv, e)) - xh * c);
        acc[it][e] += d * xh;
      }
      store_vec<T, VEC>(out + vi * VEC, o);
    }
  }

  // The CTA's row of partials: its slots' added in slot order.
  float* mine = slots == 1 ? part + static_cast<long long>(blockIdx.x) * D
                           : colsum + static_cast<long long>(slot) * D;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int vi = it * lanes + lane;
    if (vi >= nv) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) mine[vi * VEC + e] = acc[it][e];
  }
  if (slots > 1) {
    __syncthreads();
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float s = 0.f;
      for (int k = 0; k < slots; ++k)
        s += colsum[static_cast<long long>(k) * D + j];
      part[static_cast<long long>(blockIdx.x) * D + j] = s;
    }
  }

  // dscale: the last CTA of each group adds the group's rows into the
  // group's row (after the CTAs' rows), the last group adds those.
  const int ctas = gridDim.x;
  const int groups = (ctas + group - 1) / group;
  const int g = blockIdx.x / group, g0 = g * group;
  const int gn = min(group, ctas - g0);
  if (!repro::last_to_arrive(tickets + g, gn, &last)) return;
  sum_rows<T>(part, g0, gn, D, ctas + g, dscale, false);
  if (!repro::last_to_arrive(tickets + groups, groups, &last)) return;
  sum_rows<T>(part, ctas, groups, D, 0, dscale, true);
}

template <typename T, int VEC>
cudaError_t launch_bwd_items(const void* x, const void* dy, const void* scale,
                             void* dx, void* dscale, void* part,
                             void* tickets, int rows, int D, long long x_rs,
                             long long dy_rs, int lanes, int items,
                             int threads, int ctas, int group, float eps,
                             cudaStream_t s) {
  const int slots = threads / lanes;
  const int smem = slots > 1 ? slots * D * static_cast<int>(sizeof(float))
                             : 0;
  if (smem > 96 * 1024) return cudaErrorInvalidValue;
#define REPRO_BWD(ITEMS)                                                    \
  if (smem > 48 * 1024 &&                                                  \
      cudaFuncSetAttribute(rmsnorm_bwd_kernel<T, VEC, ITEMS>,              \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           smem) != cudaSuccess)                           \
    return cudaErrorInvalidValue;                                           \
  rmsnorm_bwd_kernel<T, VEC, ITEMS><<<ctas, threads, smem, s>>>(           \
      static_cast<const T*>(x), static_cast<const T*>(dy),                 \
      static_cast<const T*>(scale), static_cast<T*>(dx),                   \
      static_cast<T*>(dscale), static_cast<float*>(part),                  \
      static_cast<unsigned int*>(tickets), rows, D, x_rs, dy_rs, lanes,    \
      group, eps)
  // At most 32 bytes a lane of each of x, dy and scale (held in registers
  // with the fp32 partials: 64 registers a thread).
  constexpr int kVecBytes = VEC * static_cast<int>(sizeof(T));
  switch (items) {
    case 1:
      REPRO_BWD(1);
      break;
    case 2:
      if constexpr (kVecBytes * 2 <= 32) {
        REPRO_BWD(2);
        break;
      }
      return cudaErrorInvalidValue;
    case 4:
      if constexpr (kVecBytes * 4 <= 32) {
        REPRO_BWD(4);
        break;
      }
      return cudaErrorInvalidValue;
    case 8:
      if constexpr (kVecBytes * 8 <= 32) {
        REPRO_BWD(8);
        break;
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* scale,
                       void* dx, void* dscale, void* part, void* tickets,
                       int rows, int D, long long x_rs, long long dy_rs,
                       int vec, int lanes, int items, int threads, int ctas,
                       int group, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (lanes < 1 || lanes > kMaxThreads || (lanes & (lanes - 1)) != 0 ||
      threads < lanes || threads > kMaxThreads || threads % lanes != 0 ||
      threads % 32 != 0 || (lanes > 32 && threads / lanes > 15) ||
      static_cast<long long>(lanes) * items * vec < D || ctas < 1 ||
      group < 1)
    return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (vec == kVec && aligned && D % kVec == 0 && x_rs % kVec == 0 &&
      dy_rs % kVec == 0)
    return launch_bwd_items<T, kVec>(x, dy, scale, dx, dscale, part, tickets,
                                     rows, D, x_rs, dy_rs, lanes, items,
                                     threads, ctas, group, eps, s);
  if (vec == 1)
    return launch_bwd_items<T, 1>(x, dy, scale, dx, dscale, part, tickets,
                                  rows, D, x_rs, dy_rs, lanes, items, threads,
                                  ctas, group, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The backward in one launch: dx [rows, D] (row stride D) from x (row
// stride x_rs), dy (row stride dy_rs) and scale, and dscale [D], on the
// plan of ops.bwd_plan (vec, lanes, items, threads, ctas, group).  `part`
// holds (ctas + ceil(ctas / group)) x D fp32 partials; `tickets` at least
// ceil(ctas / group) + 1 counters, zero before the first launch (each
// launch leaves them zero).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* scale, void* dx, void* dscale,
                                  void* part, void* tickets, int dtype,
                                  int rows, int D, long long x_rs,
                                  long long dy_rs, int vec, int lanes,
                                  int items, int threads, int ctas, int group,
                                  float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch_bwd<float>(
        x, dy, scale, dx, dscale, part, tickets, rows, D, x_rs, dy_rs, vec,
        lanes, items, threads, ctas, group, eps, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(launch_bwd<__nv_bfloat16>(
        x, dy, scale, dx, dscale, part, tickets, rows, D, x_rs, dy_rs, vec,
        lanes, items, threads, ctas, group, eps, s));
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
