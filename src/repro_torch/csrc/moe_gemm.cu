// Grouped expert GEMM for Hopper (sm_90a): y[e] = x[e] @ w[e] for
// x [E, C, K], w [E, K, N] (both row-major, one dtype), y [E, C, N] in x's
// dtype, with fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_moe_gemm_kernel` / `moe_gemm`
// (src/repro/kernels/moe_gemm/moe_gemm.py), the product of the expert
// dispatch buffer of models/moe.py.  The Pallas grid walks K as a sequential
// "arbitrary" axis with an fp32 VMEM accumulator; here each CTA owns whole
// output tiles and walks K itself, so nothing carries between CTAs.  Three
// variants, chosen by capacity C and dtype:
//
//  * skinny (C <= 8, decode; both dtypes).  The step's work is reading every
//    expert's weights once (3 x 64 x 2048 x 1024 bf16 = 805 MB a layer for
//    olmoe-1b-7b): bound by bytes.  A CTA of 8 warps owns one expert, 8 rows
//    and 32 x 16-byte column vectors (256 bf16 / 128 fp32 columns); each lane
//    streams one 16-byte vector of w per K row and applies it to all 8 rows of
//    x, which sit in shared memory.  The warps split K (warp i takes rows
//    i, i + 8, ...), keep 8 loads in flight each, and their partial sums are
//    added in a fixed order through shared memory, so results do not vary
//    from run to run.
//  * tensor-core tile (C > 8, bf16; prefill).  64 x 128 output tile per CTA,
//    K in steps of 32 staged through shared memory, 8 warps each running
//    2 x 2 wmma 16x16x16 bf16 fragments with fp32 accumulators; the next K
//    tile's global loads are issued into registers before the current tile's
//    products.  Bound by operations at large C.
//  * SIMT tile (C > 8, fp32).  64 x 64 output tile, K in steps of 16, 4 x 4
//    outputs per thread in fp32 FMA (fp32 stays out of the tensor cores: TF32
//    would not hold the fp32 tolerance).
//
// K and N must be multiples of 8 so that every 16-byte vector is wholly
// inside or wholly outside the matrix; the wrapper (kernels/moe_gemm/ops.py)
// checks that, and the kernels mask the ragged edges of C, K and N tiles.
// wgmma/TMA pipelines are later work.
// common.cuh brings in cuda_bf16.h, which must precede <mma.h> for the
// bf16 wmma fragments.
#include "common.cuh"

#include <mma.h>

namespace {

using repro::from_f;

// A 16-byte vector of T: raw load and conversion to floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static void unpack(const Raw& v, float (&o)[4]) {
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ static void unpack(const Raw& v, float (&o)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

// ---------------------------------------------------------------------------
// Skinny variant (C <= 8)
// ---------------------------------------------------------------------------

constexpr int kSkinnyRows = 8;     // rows of x per CTA
constexpr int kSkinnyWarps = 8;    // warps splitting K
constexpr int kSkinnyKc = 2048;    // K chunk of x staged in shared memory
constexpr int kSkinnyUnroll = 8;   // w loads in flight per lane

template <typename T>
constexpr int skinny_smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kSkinnyRows * kSkinnyKc + kSkinnyWarps * 32 * Vec16<T>::kN);
}

template <typename T>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
    moe_gemm_skinny(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, int C, int K, int N) {
  using V = Vec16<T>;
  constexpr int kV = V::kN;
  constexpr int kBN = 32 * kV;
  constexpr int kVecPerRow = kSkinnyKc / kV;
  extern __shared__ float skinny_smem[];
  float* xs = skinny_smem;                         // [rows][Kc], 64 KB
  float* part = xs + kSkinnyRows * kSkinnyKc;      // [warps][BN]

  const int e = blockIdx.z;
  const int c0 = blockIdx.y * kSkinnyRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kBN + lane * kV;
  const bool col_ok = n < N;
  const T* xe = x + static_cast<long long>(e) * C * K;
  const T* we = w + static_cast<long long>(e) * K * N + n;

  float acc[kSkinnyRows][kV];
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r)
#pragma unroll
    for (int j = 0; j < kV; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSkinnyKc) {
    const int kc = min(kSkinnyKc, K - k0);
    __syncthreads();  // previous chunk consumed
    for (int i = threadIdx.x; i < kSkinnyRows * kVecPerRow; i += blockDim.x) {
      const int r = i / kVecPerRow, kv = (i % kVecPerRow) * kV;
      float f[kV];
      if (c0 + r < C && kv < kc) {
        V::unpack(V::load(xe + static_cast<long long>(c0 + r) * K + k0 + kv),
                  f);
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kV; ++j) xs[r * kSkinnyKc + kv + j] = f[j];
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int kk = warp; kk < kc; kk += kSkinnyWarps * kSkinnyUnroll) {
      typename V::Raw raw[kSkinnyUnroll];
#pragma unroll
      for (int u = 0; u < kSkinnyUnroll; ++u) {
        const int ku = kk + u * kSkinnyWarps;
        raw[u] = ku < kc ? V::load(we + static_cast<long long>(k0 + ku) * N)
                         : V::zero();
      }
#pragma unroll
      for (int u = 0; u < kSkinnyUnroll; ++u) {
        const int ku = kk + u * kSkinnyWarps;
        if (ku >= kc) break;  // warp-uniform
        float wf[kV];
        V::unpack(raw[u], wf);
        const float* xr = xs + ku;
#pragma unroll
        for (int r = 0; r < kSkinnyRows; ++r) {
          const float xv = xr[r * kSkinnyKc];
#pragma unroll
          for (int j = 0; j < kV; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
        }
      }
    }
  }

  // Sum the warps' partials in warp order, one output row at a time.
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kV; ++j) part[warp * kBN + lane * kV + j] = acc[r][j];
    __syncthreads();
    for (int col = threadIdx.x; col < kBN; col += blockDim.x) {
      const int nn = blockIdx.x * kBN + col;
      if (c0 + r < C && nn < N) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < kSkinnyWarps; ++wi) s += part[wi * kBN + col];
        y[(static_cast<long long>(e) * C + c0 + r) * N + nn] = from_f<T>(s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core tile variant (C > 8, bf16)
// ---------------------------------------------------------------------------

constexpr int kTcM = 64, kTcN = 128, kTcK = 32;
constexpr int kTcThreads = 256;   // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kTcApad = kTcK + 8;  // row strides of the staged tiles (elements)
constexpr int kTcBpad = kTcN + 8;
constexpr int kTcCpad = kTcN + 4;
constexpr int kTcABytes = kTcM * kTcApad * 2;
constexpr int kTcBBytes = kTcK * kTcBpad * 2;
constexpr int kTcCBytes = kTcM * kTcCpad * 4;
constexpr int kTcSmem =
    kTcCBytes > kTcABytes + kTcBBytes ? kTcCBytes : kTcABytes + kTcBBytes;

struct TcLoads {
  uint4 a;     // one 8-wide vector of the 64 x 32 x tile
  uint4 b[2];  // two 8-wide vectors of the 32 x 128 w tile
};

__device__ __forceinline__ void tc_load(const __nv_bfloat16* xe,
                                        const __nv_bfloat16* we, int C, int K,
                                        int N, int m0, int n0, int k0,
                                        int tid, TcLoads& t) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int ar = tid >> 2, ak = (tid & 3) * 8;
  t.a = (m0 + ar < C && k0 + ak < K)
            ? __ldg(reinterpret_cast<const uint4*>(
                  xe + static_cast<long long>(m0 + ar) * K + k0 + ak))
            : zero;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kTcThreads;
    const int bk = idx >> 4, bn = (idx & 15) * 8;
    t.b[i] = (k0 + bk < K && n0 + bn < N)
                 ? __ldg(reinterpret_cast<const uint4*>(
                       we + static_cast<long long>(k0 + bk) * N + n0 + bn))
                 : zero;
  }
}

__global__ void __launch_bounds__(kTcThreads)
    moe_gemm_tc_bf16(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     __nv_bfloat16* __restrict__ y, int C, int K, int N) {
  namespace wmma = nvcuda::wmma;
  __shared__ __align__(128) unsigned char smem[kTcSmem];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + kTcABytes);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kTcM, n0 = blockIdx.x * kTcN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const __nv_bfloat16* xe = x + static_cast<long long>(e) * C * K;
  const __nv_bfloat16* we = w + static_cast<long long>(e) * K * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  TcLoads t;
  tc_load(xe, we, C, K, N, m0, n0, 0, tid, t);
  for (int k0 = 0; k0 < K; k0 += kTcK) {
    *reinterpret_cast<uint4*>(As + (tid >> 2) * kTcApad + (tid & 3) * 8) = t.a;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kTcThreads;
      *reinterpret_cast<uint4*>(Bs + (idx >> 4) * kTcBpad + (idx & 15) * 8) =
          t.b[i];
    }
    __syncthreads();
    if (k0 + kTcK < K) tc_load(xe, we, C, K, N, m0, n0, k0 + kTcK, tid, t);
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * kTcApad + kk,
                               kTcApad);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * kTcBpad + wn * 32 + j * 16,
                               kTcBpad);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // tiles consumed before the next store (or Cs reuse)
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (wm * 32 + i * 16) * kTcCpad + wn * 32 + j * 16, acc[i][j],
          kTcCpad, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kTcM * kTcN / 8; idx += kTcThreads) {
    const int r = idx / (kTcN / 8), c = (idx % (kTcN / 8)) * 8;
    if (m0 + r >= C || n0 + c >= N) continue;
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
    const float* cr = Cs + r * kTcCpad + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(cr[2 * j], cr[2 * j + 1]);
    *reinterpret_cast<uint4*>(
        y + (static_cast<long long>(e) * C + m0 + r) * N + n0 + c) = out;
  }
}

// ---------------------------------------------------------------------------
// SIMT tile variant (C > 8, fp32)
// ---------------------------------------------------------------------------

constexpr int kSimtM = 64, kSimtN = 64, kSimtK = 16;

__global__ void __launch_bounds__(256)
    moe_gemm_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int C, int K, int N) {
  __shared__ __align__(16) float As[kSimtK][kSimtM + 4];  // x tile, k-major
  __shared__ __align__(16) float Bs[kSimtK][kSimtN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kSimtM, n0 = blockIdx.x * kSimtN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ar = tid >> 2, ak = (tid & 3) * 4;   // x: 64 rows x 4 vectors
  const int bk = tid >> 4, bn = (tid & 15) * 4;  // w: 16 rows x 16 vectors
  const float* xe = x + static_cast<long long>(e) * C * K;
  const float* we = w + static_cast<long long>(e) * K * N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSimtK) {
    const float4 a =
        (m0 + ar < C && k0 + ak < K)
            ? __ldg(reinterpret_cast<const float4*>(
                  xe + static_cast<long long>(m0 + ar) * K + k0 + ak))
            : zero;
    const float4 b =
        (k0 + bk < K && n0 + bn < N)
            ? __ldg(reinterpret_cast<const float4*>(
                  we + static_cast<long long>(k0 + bk) * N + n0 + bn))
            : zero;
    __syncthreads();  // previous tile consumed
    As[ak + 0][ar] = a.x;
    As[ak + 1][ar] = a.y;
    As[ak + 2][ar] = a.z;
    As[ak + 3][ar] = a.w;
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = b;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimtK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }

  const int n = n0 + tx * 4;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < C)
      *reinterpret_cast<float4*>(y + (static_cast<long long>(e) * C + m) * N +
                                 n) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <typename T>
cudaError_t launch_skinny(const void* x, const void* w, void* y, int E, int C,
                          int K, int N, cudaStream_t s) {
  constexpr int kBN = 32 * Vec16<T>::kN;
  const dim3 grid((N + kBN - 1) / kBN, (C + kSkinnyRows - 1) / kSkinnyRows, E);
  constexpr int kSmem = skinny_smem_bytes<T>();
  auto kern = moe_gemm_skinny<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kSkinnyWarps * 32, kSmem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      C, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int moe_gemm_launch(const void* x, const void* w, void* y,
                               int dtype, int E, int C, int K, int N,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || C < 1 || K < 1 || N < 1 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= kSkinnyRows) {
    if (dtype == repro::kBFloat16)
      return static_cast<int>(
          launch_skinny<__nv_bfloat16>(x, w, y, E, C, K, N, s));
    return static_cast<int>(launch_skinny<float>(x, w, y, E, C, K, N, s));
  }
  if (dtype == repro::kBFloat16) {
    const dim3 grid((N + kTcN - 1) / kTcN, (C + kTcM - 1) / kTcM, E);
    moe_gemm_tc_bf16<<<grid, kTcThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        C, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((N + kSimtN - 1) / kSimtN, (C + kSimtM - 1) / kSimtM, E);
  moe_gemm_simt_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w),
                                         static_cast<float*>(y), C, K, N);
  return static_cast<int>(cudaGetLastError());
}
