// Grouped expert GEMM for Hopper (sm_90a): y[e] = x[e] @ w[e] for
// x [E, C, K], w [E, K, N] (both row-major, one dtype), y [E, C, N] in x's
// dtype, with fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_moe_gemm_kernel` / `moe_gemm`
// (src/repro/kernels/moe_gemm/moe_gemm.py), the product of the expert
// dispatch buffer of models/moe.py.  The Pallas grid walks K as a sequential
// "arbitrary" axis with an fp32 VMEM accumulator; here each CTA owns whole
// output tiles and walks K itself, so nothing carries between CTAs and the
// same inputs give the same bits.  Four variants, chosen by capacity C and
// dtype:
//
//  * decode, bf16 (C <= 8; `moe_gemm_decode_launch`).  The step's work is
//    reading every expert's weights once (3 x 64 x 2048 x 1024 bf16 = 805 MB
//    a layer for olmoe-1b-7b): bound by bytes, ~0.08 ms a product at the
//    card's 3.35 TB/s.  The operands are swapped so that w is the 64-row
//    operand of the tensor cores, y_e^T [N x C] = w_e^T [N x K] x_e^T
//    [K x C]: wgmma.m64n8k16 with A = a 64 (K) x 64 (N) box of w in shared
//    memory, N-major (the transpose bit of A), and B = the expert's 8 rows
//    of x, K-major (rows past C read as zeros).  A persistent grid of one
//    CTA an SM walks work units of (expert, 64 columns), full K, in the
//    order that `ops.decode_plan` gives (at olmoe's shapes the busiest SM
//    reads 3 % above the mean); one producer thread keeps 8 TMA stages of
//    8 KB of w in flight (72 KB an SM with x's boxes, over twice the SM's
//    share of the card's memory rate times its latency; 128-byte swizzle,
//    w evicted first from L2), across unit boundaries, so the epilogue of
//    one unit overlaps the next unit's loads.  No arithmetic on the CUDA
//    cores but the epilogue's casts.
//  * skinny, fp32 (C <= 8).  A CTA of 8 warps owns one expert, 8 rows and
//    32 x 16-byte column vectors (128 fp32 columns); each lane streams one
//    16-byte vector of w per K row and applies it to all 8 rows of x, which
//    sit in shared memory.  The warps split K and add their partial sums in
//    a fixed order through shared memory.  (It beats torch.bmm; the tensor
//    cores would need 3xTF32 at fp32's doubled bytes.)
//  * TMA + wgmma (C > 8, bf16; prefill).  One CTA per (expert, 128
//    columns) owns all C rows (row blocks of 256), so at C <= 256 each byte
//    of w is read from device memory once; a producer thread keeps 4 TMA
//    stages in flight and two warpgroups run wgmma.m64n128k16 on them (see
//    the section below).  At olmoe-1b-7b's prefill (C = 224) it is bound by
//    bytes: ~170 operations a byte of x, w and y, under the card's ~295.
//  * 3xTF32 tile (C > 8, fp32).  A 128 x 128 output tile a CTA, two CTAs
//    an SM, K in stages of 32 staged by cp.async in a ring of 3 (row
//    pitches padded so that the fragment loads hit no bank conflicts), 8
//    warps of 64 x 32, and mma.sync.m16n8k8 in TF32 with the 3xTF32 split
//    of tf32.cuh (~2^-20 relative a product).  Each 3xTF32 product starts
//    from zero and is added to the accumulator on the CUDA cores: the
//    tensor core truncates its own fp32 sums, an error that grows with K in
//    an accumulator kept there to many times an fp32 FMA loop's, where
//    this one stays near it.  Bound by the tensor cores' TF32 rate at
//    three products for each fp32 one (~0.36 ms at olmoe's prefill,
//    against ~0.21 by bytes).  A warp's m16 tiles interleave with its
//    neighbour's (rows 16 (wm + 2i)), so a tile with rows past C (C = 224 =
//    1.75 x 128) idles both warps alike, and they skip the products of m16
//    tiles wholly past C.  The grid runs an expert's row tiles of one
//    column block side by side, so w comes from L2 after its first read.
//
// The backward (training) has two products, dx[e] = dy[e] w[e]^T and
// dw[e] = x[e]^T dy[e].  In bf16 they read their operands in place, as
// autograd hands them over (`moe_gemm_dx_launch`, `moe_gemm_dw_launch`):
// both on a persistent cooperative variant of TMA + wgmma on 128 x 256
// tiles whose operand layouts are template arguments (see the section
// "Backward variant").  fp32 has no transpose bits (wgmma transposes
// 16-bit types only) and its tile and skinny variants take row-major
// operands, so fp32 dx and dw run the variants above on transposed copies
// (`moe_transpose`, at the end of this file; dw's capacity zero-padded to
// a multiple of 8).
//
// K and N must be multiples of 8 so that every 16-byte vector is wholly
// inside or wholly outside the matrix (and every TMA stride a multiple of
// 16 bytes); the wrapper (kernels/moe_gemm/ops.py) checks that, and the
// kernels mask the ragged edges of C, K and N tiles.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

namespace {

using namespace repro;

// A 16-byte vector of T: raw load and conversion to floats (fp32 only: the
// skinny kernel's one type).
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

// ---------------------------------------------------------------------------
// Skinny variant (C <= 8, fp32)
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
// Decode variant (C <= 8, bf16): w streamed through wgmma.m64n8k16
// ---------------------------------------------------------------------------
//
// A work unit is (expert, 64 output columns) over the whole of K.  Stage kt
// holds a box of w (64 K rows x 64 columns, 128 B a row) and the expert's x
// box (8 rows x 64 K, rows past C zero-filled), loaded by TMA through 3-D
// tensor maps, so K past the end and columns past N read as zeros within
// the expert.  The consumer warpgroup computes the unit's 64 x 8 tile of
// y_e^T as A = the w box (N-major: 128-byte rows along N, 8-k groups
// 1024 B apart, a k16 step 2 KB) times B = x (K-major: one 8-row swizzle
// atom, a k16 step 32 B along the row), one stage's products left in
// flight while the next stage is waited for.

constexpr int kGvN = 64;                         // output columns a unit
constexpr int kGvK = 64;                         // K a stage
constexpr int kGvStages = 8;                     // 72 KB in flight an SM
constexpr int kGvWBox = kGvK * kGvN * 2;         // 64 x 64 bf16, 8 KB
constexpr int kGvXBox = 8 * kGvK * 2;            // 8 x 64 bf16, 1 KB
constexpr int kGvStageBytes = kGvWBox + kGvXBox;
constexpr int kGvConsumers = 128;                // one warpgroup
constexpr int kGvThreads = kGvConsumers + 32;    // + the producer warp
constexpr int kGvSmem = kGvStages * kGvStageBytes + 1024 + 2 * kGvStages * 8;

__global__ void __launch_bounds__(kGvThreads, 1)
    moe_gemm_decode_bf16(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         __nv_bfloat16* __restrict__ y, int E, int C, int K,
                         int N) {
  extern __shared__ unsigned char gv_smem[];
  const uint32_t base = (smem_u32(gv_smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t bars = base + kGvStages * kGvStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kGvStages + s); };
  const int col_blocks = (N + kGvN - 1) / kGvN;
  const int units = E * col_blocks;
  const int nk = (K + kGvK - 1) / kGvK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGvStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kGvConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kGvConsumers) {  // producer warp: one thread starts TMA
    if (threadIdx.x != kGvConsumers) return;
    uint64_t keep, stream;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(keep));
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(stream));
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int e = u / col_blocks, n0 = (u % col_blocks) * kGvN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kGvStages;
        mbar_wait(empty(s), ((it / kGvStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kGvStageBytes);
        const uint32_t a = base + s * kGvStageBytes;
        tma_load_3d(a, &wmap, full(s), n0, kt * kGvK, e, stream);
        tma_load_3d(a + kGvWBox, &xmap, full(s), kt * kGvK, 0, e, keep);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int e = u / col_blocks, n0 = (u % col_blocks) * kGvN;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int prev = -1;  // the stage whose products may still be in flight
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kGvStages;
      mbar_wait(full(s), (it / kGvStages) & 1);
      const uint32_t a = base + s * kGvStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGvK / 16; ++kk)
        wgmma_m64n8k16_ta(acc, gmma_desc(a + kk * 2048, kGvWBox, 1024),
                          gmma_desc(a + kGvWBox + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    mbar_arrive(empty(prev));

    // Accumulator layout of m64n8: warp w holds rows 16w + lane/4 (+8 for
    // registers 2, 3) of y_e^T, that is columns n of y, and register r
    // column 2 (lane % 4) + r % 2 of y_e^T, that is row c of y.
    __nv_bfloat16* ye = y + static_cast<long long>(e) * C * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + 16 * warp + (lane >> 2) + 8 * (r >> 1);
      const int c = 2 * (lane & 3) + (r & 1);
      if (c < C && n < N)
        ye[static_cast<long long>(c) * N + n] = __float2bfloat16(acc[r]);
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
  // The mbarriers follow the two warpgroups' output staging buffers, which
  // the epilogue writes while the producer's next loads are in flight.
  const uint32_t bars = base + kWgStages * kWgStageBytes + 2 * kWgOutBytes;
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

// A 3-D map over a row-major [d2, d1, d0] bf16 tensor with boxes of 64
// along d0 (128 bytes, one swizzle row) and `rows` along d1.
bool make_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
              int rows = 64) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
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
// Backward variant (bf16): dx and dw with their operands read in place
// ---------------------------------------------------------------------------
//
// out[e] (M x Nn) = A[e] (M x Kc) B[e] (Kc x Nn), with A and B read by TMA as
// they lie in device memory:
//   dx[e] = dy[e] w[e]^T (TA = TB = 0): M = C, Nn = K, Kc = N.  A = dy
//     [C, N] and B = w [K, N] are both K-major (their rows run along the
//     contraction): no transpose bit.
//   dw[e] = x[e]^T dy[e] (TA = TB = 1): M = K, Nn = N, Kc = C.  A = x
//     [C, K] is M-major (the transpose bit of A) and B = dy [C, N]
//     N-major (the bit of B, as the forward reads w).  Rows past C read as
//     zeros within the expert, so the capacity needs no padding.
// Bound at olmoe-1b-7b's training products ([64, 640, 2048] x [64, 2048,
// 1024] and back) by the tensor cores: 172 GFLOP a product, 0.174 ms at the
// bf16 peak, against 0.10-0.16 ms for the bytes of device memory.  Close
// behind comes what the tiles stream from L2 into shared memory, 2-3 GB a
// product: a tile has to do ~85 operations a byte of it or more.
//
// A CTA tile is 128 x 256: two consumer warpgroups take one 128 x 128 half
// each (two m64n128k16 products a k16 step, 128 fp32 accumulators a
// thread), both on every stage, which holds 64 of the contraction of A's
// 128 rows (two 8 KB boxes of 64 rows, or of 64 columns M-major) and B's
// 256 columns (48 KB a stage, a ring of 4; 85 operations a byte of it).
// (Warpgroups on tiles of their own in turn, "ping-pong", stream 64 a byte
// and ran 1.5x slower; CTA pairs sharing an operand by TMA multicast in
// clusters of 2 gained nothing measurable: PERF.md.)  128 rows split
// C = 640 into five whole tiles; K = 1024 / 2048 and N take whole
// 256-column tiles.  The grid is persistent (a CTA an SM, tiles taken in
// turn, an expert's side by side so its operands come from L2 after their
// first read), so the loads of a CTA's next tile run under the epilogue of
// its last (bf16 through a 16 KB swizzled staging buffer a warpgroup and
// TMA stores, which clip rows past M and columns past Nn).  Each tile is
// owned by one CTA that walks K in order: the same bits every run.

constexpr int kBwM = 128, kBwN = 128, kBwK = 64;  // a warpgroup's tile
constexpr int kBwHalf = 64 * kBwK * 2;              // 8 KB: 64 rows x 64
constexpr int kBwA = 2 * kBwHalf;                   // A a stage: 128 rows
constexpr int kBwB = 4 * kBwHalf;                   // B a stage: 256 columns
constexpr int kBwStageBytes = kBwA + kBwB;
constexpr int kBwStages = 4;
constexpr int kBwOutBytes = 64 * kBwN * 2;          // a 64 x 128 half tile
constexpr int kBwThreads = 2 * 128 + 32;            // + the producer warp
constexpr int kBwSmem =
    kBwStages * kBwStageBytes + 2 * kBwOutBytes + 1024 + 2 * kBwStages * 8;
static_assert(kBwSmem <= 232448, "the SM's shared memory");

template <int TA, int TB>
__global__ void __launch_bounds__(kBwThreads, 1)
    moe_gemm_bwd_bf16(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap omap, int E, int M,
                      int Nn, int Kc) {
  extern __shared__ unsigned char bw_smem[];
  const uint32_t base = (smem_u32(bw_smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t bars = base + kBwStages * kBwStageBytes + 2 * kBwOutBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kBwStages + s); };
  const int m_tiles = (M + kBwM - 1) / kBwM;
  const int n_tiles = (Nn + 2 * kBwN - 1) / (2 * kBwN);
  const int per_expert = m_tiles * n_tiles;
  const int tiles = E * per_expert;
  const int nk = (Kc + kBwK - 1) / kBwK;
  const int warp = threadIdx.x >> 5;
  // Tile u: (expert, first row, first column).
  auto tile_of = [&](int u, int& e, int& m0, int& n0) {
    e = u / per_expert;
    const int r = u % per_expert;
    m0 = (r / n_tiles) * kBwM;
    n0 = (r % n_tiles) * 2 * kBwN;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer warp: one thread starts TMA
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      int e, m0, n0;
      tile_of(u, e, m0, n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kBwStages;
        mbar_wait(empty(s), ((it / kBwStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kBwStageBytes);
        const uint32_t a = base + s * kBwStageBytes, b = a + kBwA;
        const int k0 = kt * kBwK;
        // A in two boxes of 64 rows (TA 0) or 64 columns (TA 1); B in
        // two of 128 rows (TB 0) or four of 64 columns (TB 1).
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = TA == 0 ? k0 : m0 + 64 * h;
          const int c1 = TA == 0 ? m0 + 64 * h : k0;
          tma_load_3d(a + h * kBwHalf, &amap, full(s), c0, c1, e);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // 128 columns each
          const uint32_t d = b + h * 2 * kBwHalf;
          const int n = n0 + kBwN * h;
          if constexpr (TB == 0) {
            tma_load_3d(d, &bmap, full(s), k0, n, e);
          } else {
            tma_load_3d(d, &bmap, full(s), n, k0, e);
            tma_load_3d(d + kBwHalf, &bmap, full(s), n + 64, k0, e);
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2;              // consumer warpgroup 0 or 1
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const uint32_t out = base + kBwStages * kBwStageBytes + wg * kBwOutBytes;
  float acc[2][64];
  int it = 0;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    int e, m0, n0;
    tile_of(u, e, m0, n0);
    n0 += kBwN * wg;                     // this warpgroup's 128 columns
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[t][i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kBwStages;
      mbar_wait(full(s), (it / kBwStages) & 1);
      const uint32_t a = base + s * kBwStageBytes,
                     b = a + kBwA + wg * 2 * kBwHalf;
      // All four k16 steps, a short last stage's too (TMA zero-filled its
      // contraction past Kc): a branch on the count between the products
      // would make ptxas serialize them.  K-major (TA / TB = 0): 128-byte
      // rows, 8-row groups 1024 B apart, a k16 step 32 B along the row,
      // the second m64 tile 8 KB on; M- or N-major (1): 64-column boxes
      // 8 KB apart, 8-k groups 1024 B apart, a k16 step 16 rows (2 KB).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwK / 16; ++kk) {
        const uint64_t db = TB == 0 ? gmma_desc(b + kk * 32, 16, 1024)
                                    : gmma_desc(b + kk * 2048, 8192, 1024);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wgmma_m64n128k16_ss<TB, TA>(
              acc[t],
              TA == 0 ? gmma_desc(a + t * 8192 + kk * 32, 16, 1024)
                      : gmma_desc(a + t * 8192 + kk * 2048, 8192, 1024),
              db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0) mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    mbar_arrive(empty(prev));

    // Epilogue, one 64-row half at a time through the staging buffer
    // (accumulator and swizzle layouts as in moe_gemm_wgmma_bf16).
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (m0 + 64 * t >= M || n0 >= Nn) break;
      if (tid == 0)  // the buffer's last store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(wg);
      const int row = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
      for (int j = 0; j < kBwN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = row + 8 * h;
          const uint32_t addr = out + (j >> 3) * kBwHalf + rr * 128 +
                                (((j & 7) ^ (rr & 7)) << 4) + 4 * (lane & 3);
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
        tma_store_3d(&omap, out, n0, m0 + 64 * t, e);
        tma_store_3d(&omap, out + kBwHalf, n0 + 64, m0 + 64 * t, e);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int TA, int TB>
cudaError_t launch_bwd(const CUtensorMap& amap, const CUtensorMap& bmap,
                       const CUtensorMap& omap, int E, int M, int Nn, int Kc,
                       int ctas, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_bwd_bf16<TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwSmem);
  if (err != cudaSuccess) return err;
  moe_gemm_bwd_bf16<TA, TB><<<ctas, kBwThreads, kBwSmem, s>>>(
      amap, bmap, omap, E, M, Nn, Kc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3xTF32 tile variant (C > 8, fp32)
// ---------------------------------------------------------------------------
//
// Warp (wm, wn) of the 2 x 4 owns columns 32 wn .. 32 wn + 31 of the tile
// (four n8 tiles) and the m16 tiles at rows 16 (wm + 2i), i < 4.  A stage
// is x's 128 x 32 tile (row pitch 36: fragment loads at banks 4g + t) and
// w's 32 x 128 tile (row pitch 136: banks 8t + g), each 16-byte chunk
// copied by cp.async or zero-filled past C, K or N.

constexpr int kTfM = 128, kTfN = 128, kTfK = 32, kTfStages = 3;
constexpr int kTfAP = kTfK + 4;
constexpr int kTfBP = kTfN + 8;
constexpr int kTfStageFloats = kTfM * kTfAP + kTfK * kTfBP;
constexpr int kTfSmem = kTfStages * kTfStageFloats * 4;  // 105 KB
constexpr int kTfThreads = 256;
static_assert(kTfM == kTfN, "x's and w's tiles copy as many 16-byte chunks");

__global__ void __launch_bounds__(kTfThreads, 2)
    moe_gemm_tf32(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int C, int K, int N) {
  extern __shared__ __align__(16) float tf_smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kTfM, n0 = blockIdx.y * kTfN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const float* xe = x + static_cast<long long>(e) * C * K;
  const float* we = w + static_cast<long long>(e) * K * N;
  const int nk = (K + kTfK - 1) / kTfK;
  // The warp's m16 tiles that hold rows below C (warp-uniform).
  const int mt = min(4, max(0, (C - m0 - 16 * wm + 31) / 32));

  auto load = [&](int slot, int kt) {
    float* as = tf_smem + slot * kTfStageFloats;
    float* bs = as + kTfM * kTfAP;
    const int k0 = kt * kTfK;
#pragma unroll
    for (int j = 0; j < kTfM * kTfK / 4 / kTfThreads; ++j) {
      const int i = tid + j * kTfThreads;
      const int r = i / (kTfK / 4), q = i % (kTfK / 4) * 4;  // x: K/4 a row
      const bool ok = m0 + r < C && k0 + q < K;
      cp_async16_zfill(as + r * kTfAP + q,
                       ok ? xe + static_cast<long long>(m0 + r) * K + k0 + q
                          : x,
                       ok);
      const int kr = i >> 5, nq = (i & 31) * 4;    // w: 32 chunks a row
      const bool okw = k0 + kr < K && n0 + nq < N;
      cp_async16_zfill(bs + kr * kTfBP + nq,
                       okw ? we + static_cast<long long>(k0 + kr) * N + n0 + nq
                           : w,
                       okw);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kTfStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTfStages - 2>();   // stage kt has landed
    __syncthreads();                  // and stage kt - 1 is consumed
    if (kt + kTfStages - 1 < nk)
      load((kt + kTfStages - 1) % kTfStages, kt + kTfStages - 1);
    cp_async_commit();
    const float* as = tf_smem + (kt % kTfStages) * kTfStageFloats;
    const float* bs = as + kTfM * kTfAP;
#pragma unroll
    for (int kk = 0; kk < kTfK; kk += 8) {
      Split<2> b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (kk + t4) * kTfBP + 32 * wn + 8 * j + g;
        const float f[2] = {p[0], p[4 * kTfBP]};
        b[j] = split(f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= mt) break;
        const float* p = as + (16 * (wm + 2 * i) + g) * kTfAP + kk + t4;
        const float f[4] = {p[0], p[8 * kTfAP], p[4], p[8 * kTfAP + 4]};
        const Split<4> a = split(f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(t, t, a, b[j]);
          add4(acc[i][j], t);
        }
      }
    }
  }
  cp_async_wait_all();

  float* ye = y + static_cast<long long>(e) * C * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= mt) break;
    const int r = m0 + 16 * (wm + 2 * i) + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * wn + 8 * j + 2 * t4;
      if (n >= N) continue;
      if (r < C)
        *reinterpret_cast<float2*>(ye + static_cast<long long>(r) * N + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (r + 8 < C)
        *reinterpret_cast<float2*>(ye + static_cast<long long>(r + 8) * N +
                                   n) = make_float2(acc[i][j][2],
                                                    acc[i][j][3]);
    }
  }
}

cudaError_t launch_tf32(const void* x, const void* w, void* y, int E, int C,
                        int K, int N, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kTfM - 1) / kTfM, (N + kTfN - 1) / kTfN, E);
  moe_gemm_tf32<<<grid, kTfThreads, kTfSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), C, K, N);
  return cudaGetLastError();
}

cudaError_t launch_skinny(const void* x, const void* w, void* y, int E, int C,
                          int K, int N, cudaStream_t s) {
  constexpr int kBN = 32 * Vec16<float>::kN;
  const dim3 grid((N + kBN - 1) / kBN, (C + kSkinnyRows - 1) / kSkinnyRows, E);
  constexpr int kSmem = skinny_smem_bytes<float>();
  auto kern = moe_gemm_skinny<float>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kSkinnyWarps * 32, kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), C, K, N);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Transposed copy, for the backward
// ---------------------------------------------------------------------------
//
// The fp32 backward's products dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T
// dy[e] (kernels/moe_gemm/ops.py) run on the fp32 variants above, which take
// row-major [E, C, K] x [E, K, N] operands; this kernel makes the transposed
// operand:
// dst[e, j, i] = src[e, i, j] for src [E, R, Cc] and dst [E, Cc, Rp], with
// the rows R <= i < Rp of dst's last axis zero (dw's contraction runs over
// the capacity, padded to a multiple of 8).  A CTA of 32 x 8 threads moves
// a 32 x 32 tile through shared memory (row pitch 33: no bank conflicts),
// reading and writing 32 consecutive elements a warp.  Bound by bytes.

constexpr int kTrTile = 32, kTrRows = 8;

template <typename T>
__global__ void __launch_bounds__(kTrTile * kTrRows)
    moe_transpose(const T* __restrict__ src, T* __restrict__ dst, int R,
                  int Cc, int Rp) {
  __shared__ T tile[kTrTile][kTrTile + 1];
  const long long e = blockIdx.z;
  const int i0 = blockIdx.y * kTrTile, j0 = blockIdx.x * kTrTile;
  const T* se = src + e * R * Cc;
  T* de = dst + e * Cc * Rp;
  for (int k = threadIdx.y; k < kTrTile; k += kTrRows) {
    const int i = i0 + k, j = j0 + threadIdx.x;
    tile[k][threadIdx.x] = i < R && j < Cc
                               ? se[static_cast<long long>(i) * Cc + j]
                               : from_f<T>(0.f);
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTrTile; k += kTrRows) {
    const int j = j0 + k, i = i0 + threadIdx.x;
    if (j < Cc && i < Rp)
      de[static_cast<long long>(j) * Rp + i] = tile[threadIdx.x][k];
  }
}

template <typename T>
cudaError_t launch_transpose(const void* src, void* dst, int E, int R, int Cc,
                             int Rp, cudaStream_t s) {
  const dim3 grid((Cc + kTrTile - 1) / kTrTile, (Rp + kTrTile - 1) / kTrTile,
                  E);
  moe_transpose<T><<<grid, dim3(kTrTile, kTrRows), 0, s>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), R, Cc, Rp);
  return cudaGetLastError();
}

bool shape_ok(int E, int C, int K, int N) {
  return E >= 1 && E <= 65535 && C >= 1 && K >= 1 && N >= 1 && K % 8 == 0 &&
         N % 8 == 0;
}

}  // namespace

// Every variant but the bf16 decode one: fp32 at any C, bf16 at C > 8.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* y,
                               int dtype, int E, int C, int K, int N,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(C <= kSkinnyRows
                                ? launch_skinny(x, w, y, E, C, K, N, s)
                                : launch_tf32(x, w, y, E, C, K, N, s));
  if (dtype == repro::kBFloat16 && C > kSkinnyRows)
    return static_cast<int>(launch_wgmma(x, w, y, E, C, K, N, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 decode variant (C <= 8) on the `ctas` CTAs of ops.decode_plan.
extern "C" int moe_gemm_decode_launch(const void* x, const void* w, void* y,
                                      int E, int C, int K, int N, int ctas,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, K, N) || C > kSkinnyRows || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, x, K, C, E, 8) || !make_map(&wmap, w, N, K, E))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_decode_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gemm_decode_bf16<<<ctas, kGvThreads, kGvSmem, s>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(y), E, C, K, N);
  return static_cast<int>(cudaGetLastError());
}

// bf16 dx [E, C, K] = dy [E, C, N] w [E, K, N]^T, both read in place, on
// the `ctas` CTAs of ops.bwd_plan (rows past C read as zeros and are not
// stored, so every C >= 1 takes this variant).
extern "C" int moe_gemm_dx_launch(const void* dy, const void* w, void* dx,
                                  int E, int C, int K, int N, int ctas,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, K, N) || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap, omap;
  if (!make_map(&amap, dy, N, C, E) || !make_map(&bmap, w, N, K, E, kBwN) ||
      !make_map(&omap, dx, K, C, E))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_bwd<0, 0>(amap, bmap, omap, E, C, K, N, ctas, s));
}

// bf16 dw [E, K, N] = x [E, C, K]^T dy [E, C, N], both read in place, on
// the `ctas` CTAs of ops.bwd_plan.
extern "C" int moe_gemm_dw_launch(const void* x, const void* dy, void* dw,
                                  int E, int C, int K, int N, int ctas,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(E, C, K, N) || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap, omap;
  if (!make_map(&amap, x, K, C, E) || !make_map(&bmap, dy, N, C, E) ||
      !make_map(&omap, dw, N, K, E))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_bwd<1, 1>(amap, bmap, omap, E, K, N, C, ctas, s));
}

// dst [E, Cc, Rp] = src [E, R, Cc] transposed, zero rows past R (Rp >= R).
extern "C" int moe_transpose_launch(const void* src, void* dst, int dtype,
                                    int E, int R, int Cc, int Rp,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || R < 1 || Cc < 1 || Rp < R ||
      (Rp + kTrTile - 1) / kTrTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch_transpose<float>(src, dst, E, R, Cc, Rp, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        launch_transpose<__nv_bfloat16>(src, dst, E, R, Cc, Rp, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
