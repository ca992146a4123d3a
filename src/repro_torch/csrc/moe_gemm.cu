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
//  * TMA + wgmma (C > 8, bf16; prefill).  One CTA per (expert, 128
//    columns) owns all C rows (row blocks of 256), so at C <= 256 each byte
//    of w is read from device memory once; a producer thread keeps 4 TMA
//    stages in flight and two warpgroups run wgmma.m64n128k16 on them (see
//    the section below).  At olmoe-1b-7b's prefill (C = 224) it is bound by
//    bytes: ~170 operations a byte of x, w and y, under the card's ~295.
//  * SIMT tile (C > 8, fp32).  64 x 64 output tile, K in steps of 16, 4 x 4
//    outputs per thread in fp32 FMA (fp32 stays out of the tensor cores: TF32
//    would not hold the fp32 tolerance).
//
// K and N must be multiples of 8 so that every 16-byte vector is wholly
// inside or wholly outside the matrix (and every TMA stride a multiple of
// 16 bytes); the wrapper (kernels/moe_gemm/ops.py) checks that, and the
// kernels mask the ragged edges of C, K and N tiles.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

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
// TMA + wgmma variant (C > 8, bf16)
// ---------------------------------------------------------------------------
//
// A tile is one (expert, 128 output columns) with all C rows, in row blocks
// of 256 (4 m64 tiles), so at C <= 256 each byte of w is read from device
// memory once.  The grid is persistent (one CTA an SM, tiles taken in
// turn, an expert's column tiles side by side so its x is read from L2),
// so the loads of a CTA's next tile overlap the epilogue of its last.  One
// producer thread keeps a ring of 4 stages in flight:
// each stage is the row block's x tiles (64 rows x 64 K each, as many as
// the block has rows) and the 64 x 128 w tile (two 64-column boxes), loaded
// by TMA through 3-D tensor maps ([E, C, K] and [E, K, N]), so rows past C
// and K past the end are zero-filled within the expert and no row of the
// next expert is read; 128-byte swizzle.  A full/empty mbarrier pair guards
// each stage.  Two consumer warpgroups (warpgroup i takes m-tiles i and
// i + 2) run wgmma.m64n128k16 bf16 -> fp32 with both operands in shared
// memory: x K-major, w N-major (the transpose bit of B), one group of
// products left in flight while the next stage is waited for.  The epilogue
// casts each 64 x 128 output tile to bf16 into a swizzled staging buffer of
// the warpgroup's and writes it with one TMA store, which drops the rows
// past C and columns past N and runs on while the next tile is computed.

constexpr int kWgN = 128;                         // output columns a CTA
constexpr int kWgK = 64;                          // K a stage (one 128-B row)
constexpr int kWgTiles = 4;                       // m64 tiles a row block
constexpr int kWgRows = 64 * kWgTiles;
constexpr int kWgStages = 4;
constexpr int kWgBox = 64 * kWgK * 2;             // one 64 x 64 bf16 box
constexpr int kWgABytes = kWgTiles * kWgBox;      // x tiles of a stage
constexpr int kWgStageBytes = kWgABytes + 2 * kWgBox;
constexpr int kWgConsumers = 256;                 // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;     // + the producer warp
constexpr int kWgOutBytes = 2 * kWgBox;  // a warpgroup's 64 x 128 output tile
constexpr int kWgSmem = kWgStages * kWgStageBytes + 2 * kWgOutBytes + 1024 +
                        2 * kWgStages * 8;

// The K loop of one row block for a consumer warpgroup with NT m-tiles
// (tiles wg and wg + 2): each stage's products committed as one group, one
// group left in flight, and a stage released once its products are done.
// NT = 0 (a warpgroup with no rows in the block) only waits and releases.
// NT is a template argument so that no branch sits between the products.
template <int NT>
__device__ __forceinline__ void consume_block(float (&acc)[2][64],
                                              uint32_t base, uint32_t bars,
                                              int wg, int nk, int& it) {
  int prev = -1;  // the stage whose products may still be in flight
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % kWgStages;
    mbar_wait(bars + 8 * s, (it / kWgStages) & 1);
    if constexpr (NT > 0) {
      const uint32_t a = base + s * kWgStageBytes;
      const uint32_t b = a + kWgABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgK / 16; ++kk) {
        // x: K-major rows of 128 B, 8-row groups 1024 B apart; a k16 step
        // is 32 B along the row.  w: N-major, 8-k groups 1024 B apart, the
        // two 64-column boxes 8 KB apart; a k16 step is 16 rows (2 KB).
        const uint64_t db = gmma_desc(b + kk * 2048, kWgBox, 1024);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          wgmma_m64n128k16(
              acc[t], gmma_desc(a + (wg + 2 * t) * kWgBox + kk * 32, 16, 1024),
              db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
    }
    if (prev >= 0) mbar_arrive(bars + 8 * (kWgStages + prev));
    prev = s;
  }
  if constexpr (NT > 0) wgmma_wait<0>();
  mbar_arrive(bars + 8 * (kWgStages + prev));
}

__global__ void __launch_bounds__(kWgThreads, 1)
    moe_gemm_wgmma_bf16(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap ymap, int E,
                        int C, int K, int N) {
  extern __shared__ unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t bars = base + kWgStages * kWgStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };
  const int col_tiles = (N + kWgN - 1) / kWgN;
  const int n_tiles = E * col_tiles;
  const int nk = (K + kWgK - 1) / kWgK;
  const int n_blocks = (C + kWgRows - 1) / kWgRows;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // producer warp: one thread starts TMA
    if (threadIdx.x != kWgConsumers) return;
    uint64_t keep, stream;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(keep));
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(stream));
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int e = tile / col_tiles, n0 = (tile % col_tiles) * kWgN;
      for (int rb = 0; rb < n_blocks; ++rb) {
        const int r0 = rb * kWgRows;
        const int tiles = min(kWgTiles, (C - r0 + 63) / 64);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kWgStages;
          mbar_wait(empty(s), ((it / kWgStages) & 1) ^ 1);
          mbar_expect_tx(full(s), (tiles + 2) * kWgBox);
          const uint32_t a = base + s * kWgStageBytes;
          for (int t = 0; t < tiles; ++t)
            tma_load_3d(a + t * kWgBox, &xmap, full(s), kt * kWgK,
                        r0 + 64 * t, e, keep);
          tma_load_3d(a + kWgABytes, &wmap, full(s), n0, kt * kWgK, e,
                      stream);
          tma_load_3d(a + kWgABytes + kWgBox, &wmap, full(s), n0 + 64,
                      kt * kWgK, e, stream);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;              // consumer warpgroup 0 or 1
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  float acc[2][64];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e = tile / col_tiles, n0 = (tile % col_tiles) * kWgN;
    for (int rb = 0; rb < n_blocks; ++rb) {
      const int r0 = rb * kWgRows;
      const int tiles = min(kWgTiles, (C - r0 + 63) / 64);
      // Warpgroup-uniform: whether it has rows in m-tile wg and wg + 2.
      const bool act0 = wg < tiles, act1 = wg + 2 < tiles;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
      if (act1)
        consume_block<2>(acc, base, bars, wg, nk, it);
      else if (act0)
        consume_block<1>(acc, base, bars, wg, nk, it);
      else
        consume_block<0>(acc, base, bars, wg, nk, it);

      // Accumulator layout of m64nN: warp w of the warpgroup holds rows
      // 16w + lane/4 (+8), register 4j + r column 8j + 2 (lane % 4) + r % 2.
      // The staging buffer is two 64-column boxes of 64 rows x 128 B, in
      // the 128-byte swizzle the TMA store reads (16-byte chunk c of row r
      // at chunk c ^ (r % 8)).
      const uint32_t out = base + kWgStages * kWgStageBytes + wg * kWgOutBytes;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (!(t == 0 ? act0 : act1)) continue;
        if (tid == 0)  // the buffer's last store has read it
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        warpgroup_sync(wg);
        const int row = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
        for (int j = 0; j < kWgN / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h;
            const uint32_t addr = out + (j >> 3) * kWgBox + r * 128 +
                                  (((j & 7) ^ (r & 7)) << 4) + 4 * (lane & 3);
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                         "r"(*reinterpret_cast<const uint32_t*>(&v))
                         : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_sync(wg);
        if (tid == 0) {
          const int m0 = r0 + (wg + 2 * t) * 64;
          tma_store_3d(&ymap, out, n0, m0, e);
          tma_store_3d(&ymap, out + kWgBox, n0 + 64, m0, e);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A 3-D map over a row-major [d2, d1, d0] bf16 tensor with 64 x 64 boxes.
bool make_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* x, const void* w, void* y, int E, int C,
                         int K, int N, cudaStream_t s) {
  CUtensorMap xmap, wmap, ymap;
  if (!make_map(&xmap, x, K, C, E) || !make_map(&wmap, w, N, K, E) ||
      !make_map(&ymap, y, N, C, E))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_wgmma_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return cudaErrorInvalidValue;
  const int n_tiles = E * ((N + kWgN - 1) / kWgN);
  moe_gemm_wgmma_bf16<<<n_tiles < sms ? n_tiles : sms, kWgThreads, kWgSmem,
                        s>>>(xmap, wmap, ymap, E, C, K, N);
  return cudaGetLastError();
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
  if (dtype == repro::kBFloat16)
    return static_cast<int>(launch_wgmma(x, w, y, E, C, K, N, s));
  const dim3 grid((N + kSimtN - 1) / kSimtN, (C + kSimtM - 1) / kSimtM, E);
  moe_gemm_simt_f32<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<const float*>(w),
                                         static_cast<float*>(y), C, K, N);
  return static_cast<int>(cudaGetLastError());
}
