// WKV6 recurrence of RWKV-6 for Hopper (sm_90a).  Per (batch b, head h),
// with an N x N fp32 state S indexed [key, value]:
//   y_t = r_t . (S + diag(u) k_t v_t^T)
//   S   = diag(exp(logw_t)) S + k_t v_t^T
// r/k/v [B, S, H, N] fp32 or bf16 read in place through their strides,
// logw fp32 with the same strides, u [H, N] fp32, state fp32 [B, H, N, N]
// (the initial state, overwritten with the final one), y fp32 [B, S, H, N]
// contiguous.
//
// Replaces the Pallas TPU kernel `_wkv6_kernel` / `wkv6_chunked`
// (src/repro/kernels/rwkv6/rwkv6.py:31).  That grid walks the chunks of one
// (b, h) as a sequential "arbitrary" axis with the state in VMEM scratch,
// and starts from zero whatever state it is given.  Here a CTA walks the
// chunks itself and starts from the given state.  Two variants, chosen by
// the chunk C:
//
//  * chunk (C > 1; prefill), in the reference's blocked form
//    (models/rwkv6.wkv6_chunked), mid-chunk renormalisation included:
//      inter  y_i += (r_i e^cum_excl_i) . S
//      intra  y_i += sum_{j<i} <r_i e^(cum_excl_i - mid), k_j e^(mid - cum_j)> v_j
//      bonus  y_i += <r_i, u k_i> v_i
//      state  S = e^total S + sum_j (k_j e^(total - cum_j)) v_j^T
//    Column m of S evolves from r, k, logw and v[:, m] alone, and y[:, m]
//    reads only that column, so a CTA owns one (b, h) and each of its warps
//    a 16-column slice of the values (and, where the head has fewer than
//    four such slices, a part of the key axis).  A warp keeps its slice of
//    the state
//    in registers from the first chunk to the last, as the accumulator of
//    the tensor-core products, and reads and writes it in device memory
//    once.  Per chunk (padded to 32 positions; past C every operand is 0,
//    so the products run whole and only y's stores look at C), behind
//    three barriers (four where a warp holds part of the keys):
//      1. the chunk's r, k, v and logw arrive in shared memory by 16-byte
//         cp.async copies, issued while the previous chunk computes (plain
//         loads where the inputs are not 16-byte aligned);
//      2. one lane a position: the prefix sums of logw by warp scans
//         (__shfl_up over the chunk's positions, eight channels a lane, in
//         log2 units so that each decay is one ex2), the four decay
//         factors and the bonus dots;
//      3. A = (r e^(cum_excl - mid)) (k e^(mid - cum))^T, strictly lower,
//         then, without waiting for A, y^T = S^T (r e^cum_excl)^T and the
//         state update S^T = e^total S^T + v^T (k e^(total - cum));
//      4. behind A's barrier, y^T += v^T A^T + bonus, stored from the
//         accumulators (or, where keys are split, summed in shared memory
//         first).
//    Products are `mma.sync.m16n8k8` in TF32 with the 3xTF32 split of
//    tf32.cuh (x = big + small, big*big + big*small + small*big: ~2^-20
//    relative error, where plain TF32 keeps three decimal digits); v in
//    bf16 is exact in TF32, so its products drop a term.  The state slice
//    feeds S^T (r e^cum_excl)^T straight from its accumulator registers:
//    the products' k axis is taken in the order (0, 2, 4, 6, 1, 3, 5, 7) of
//    each 8 keys, the order in which an accumulator tile holds its columns,
//    and the other operand is read in the same order.
//  * step (C == 1; the decode step and the prompt's per-token tail).  The
//    state lives in registers: thread (m, g) holds S[n][m] for its N/G rows
//    n, reads each once from device memory and writes each once at the end,
//    whatever S is; the G partial sums of y_t[m] meet in shared memory and
//    are added in a fixed order.
//
// Bound on the H100: bytes.  At rwkv6-3b's decode step (B 28, H 40, N 64)
// reading and writing the 18.4 MB state is nearly all the traffic; the
// chunked prefill at S 64 moves ~100 MB (state, r/k/v, logw, y) against
// ~1.5 GFLOP of fp32 work, which the tensor cores take at three TF32
// products each.
//
// The training backward of both forms (`wkv6_bwd_launch`, a kernel of its
// own: the Pallas kernel has no backward; the same chunked form on tensor
// cores, a chunk of 16) is described at its kernel below.
#include <cstdint>

#include "common.cuh"
#include "tf32.cuh"

namespace {

using repro::add4;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::mma3;
using repro::split;
using repro::split_rn;
using repro::Split;
using repro::to_f;

constexpr int kThreads = 256;   // the step kernel's CTA
constexpr int kMaxChunk = 32;   // the chunk kernel pads every chunk to it

// 2^x on the SFU (relative error ~2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// --- the chunk kernel --------------------------------------------------------

// Shapes, pitches and shared-memory layout of the chunk kernel for head dim
// N.  Pitches (in elements) keep each warp's fragment loads free of bank
// conflicts and every row 16-byte aligned.
template <typename T, int N>
struct ChunkGeo {
  static constexpr int CP = kMaxChunk;        // positions, padded
  static constexpr int VB = N / 16;           // 16-column value slices
  static constexpr int NP = (4 / VB < N / 8) ? 4 / VB : N / 8;  // key parts
  static constexpr int kWarps = VB * NP;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int NT = N / NP / 8;       // 8-key tiles a warp
  static constexpr int EV = 16 / sizeof(T);   // elements a 16-byte copy
  static constexpr int LW_P = N + 4;          // staged logw (fp32)
  static constexpr int RK_P = N + EV;         // staged r, k, v (T)
  static constexpr int RD_P = N + 8;          // r e^cum_excl, k e^(total-cum)
  static constexpr int RN_P = N + 4;          // r e^(ce-mid), k e^(mid-cum)
  static constexpr int VF_P = N + 8;          // v in fp32
  static constexpr int A_P = CP + 4;          // intra-chunk weights
  static constexpr int YB_P = N + 4;          // y partials, [NP][CP][N]
  // Byte offsets.
  static constexpr int oLw = 0;
  static constexpr int oR = oLw + CP * LW_P * 4;
  static constexpr int oK = oR + CP * RK_P * int(sizeof(T));
  static constexpr int oV = oK + CP * RK_P * int(sizeof(T));
  static constexpr int oRd = oV + CP * RK_P * int(sizeof(T));
  static constexpr int oKf = oRd + CP * RD_P * 4;
  static constexpr int oRn = oKf + CP * RD_P * 4;   // rn, kn; then y partials
  static constexpr int oKn = oRn + CP * RN_P * 4;
  static constexpr int kRegionX =
      2 * CP * RN_P * 4 > NP * CP * YB_P * 4 ? 2 * CP * RN_P * 4
                                             : NP * CP * YB_P * 4;
  static constexpr int oVf = oRn + kRegionX;
  static constexpr int oA = oVf + CP * VF_P * 4;
  static constexpr int oU = oA + CP * A_P * 4;
  static constexpr int oEt = oU + N * 4;
  static constexpr int oUb = oEt + N * 4;
  static constexpr int oUbT = oUb + kWarps * CP * 4;
  static constexpr int kSmemBytes = oUbT + CP * 4;
  static_assert(N / NP % 8 == 0, "key parts");
  static_assert(oR % 16 == 0 && oK % 16 == 0 && oV % 16 == 0 &&
                    oRd % 16 == 0 && oRn % 16 == 0 && oVf % 16 == 0,
                "16-byte aligned tiles");
};

// Eight consecutive values of T at p (16-byte aligned) as fp32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = to_f(e[i]);
  } else {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <typename T, int N, bool ASYNC>
__global__ void __launch_bounds__(ChunkGeo<T, N>::kThreads)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u, float* __restrict__ state,
                      float* __restrict__ y, int S, int H, int C,
                      long long sb, long long ss, long long sh) {
  using G = ChunkGeo<T, N>;
  constexpr int CP = G::CP, NT = G::NT, EV = G::EV, kW = G::kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sLw = reinterpret_cast<float*>(smem + G::oLw);
  T* sR = reinterpret_cast<T*>(smem + G::oR);
  T* sK = reinterpret_cast<T*>(smem + G::oK);
  T* sV = reinterpret_cast<T*>(smem + G::oV);
  float* sRd = reinterpret_cast<float*>(smem + G::oRd);
  float* sKf = reinterpret_cast<float*>(smem + G::oKf);
  float* sRn = reinterpret_cast<float*>(smem + G::oRn);
  float* sKn = reinterpret_cast<float*>(smem + G::oKn);
  float* sY = reinterpret_cast<float*>(smem + G::oRn);   // once A is done
  float* sVf = reinterpret_cast<float*>(smem + G::oVf);
  float* sA = reinterpret_cast<float*>(smem + G::oA);
  float* sU = reinterpret_cast<float*>(smem + G::oU);
  float* sEt = reinterpret_cast<float*>(smem + G::oEt);
  float* sUb = reinterpret_cast<float*>(smem + G::oUb);    // per warp
  float* sUbT = reinterpret_cast<float*>(smem + G::oUbT);  // their sum

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const int m0 = (warp / G::NP) * 16;          // the warp's value slice
  const int np = warp % G::NP;                 // and its part of the keys
  const int nw = np * (N / G::NP);
  const int mid_row = C / 2 - 1;

  // The warp's slice of the state, S^T[m][n] in accumulator tiles: tile q
  // holds keys nw + 8q + (2 t4, 2 t4 + 1) of values m0 + (g, g + 8).
  float* st = state + static_cast<long long>(bh) * N * N + m0 + g;
  float sacc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int n = nw + 8 * q + 2 * t4;
    sacc[q][0] = st[n * N];
    sacc[q][1] = st[(n + 1) * N];
    sacc[q][2] = st[n * N + 8];
    sacc[q][3] = st[(n + 1) * N + 8];
  }
  if (tid < N) sU[tid] = u[h * N + tid];

  auto stage = [&](int t0) {
    const long long row0 = base + t0 * ss;
    if constexpr (ASYNC) {
      for (int e = tid; e < C * (N / 4); e += G::kThreads) {
        const int i = e / (N / 4), q = e % (N / 4);
        cp_async16(sLw + i * G::LW_P + 4 * q, logw + row0 + i * ss + 4 * q);
      }
      for (int e = tid; e < C * (N / EV); e += G::kThreads) {
        const int i = e / (N / EV), q = e % (N / EV);
        const long long off = row0 + i * ss + q * EV;
        cp_async16(sR + i * G::RK_P + q * EV, r + off);
        cp_async16(sK + i * G::RK_P + q * EV, k + off);
        cp_async16(sV + i * G::RK_P + q * EV, v + off);
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < C * N; e += G::kThreads) {
        const int i = e / N, n = e % N;
        const long long off = row0 + i * ss + n;
        sLw[i * G::LW_P + n] = logw[off];
        sR[i * G::RK_P + n] = r[off];
        sK[i * G::RK_P + n] = k[off];
        sV[i * G::RK_P + n] = v[off];
      }
    }
  };

  stage(0);
  for (int t0 = 0; t0 < S; t0 += C) {
    if constexpr (ASYNC) cp_async_wait_all();
    __syncthreads();

    // 2. One lane a position, eight channels at a time: prefix sums by warp
    //    scans, then the decay factors and the bonus dots.  Positions past
    //    C hold zeros.
    const bool live = lane < C;
    float ub = 0.f;
    static_assert(N / 8 % kW == 0, "octets a warp");
#pragma unroll
    for (int o = 0; o < N / 8 / kW; ++o) {
      const int n0 = 8 * (warp + o * kW);
      float lw[8], rr[8], kk[8];
      if (live) {
        load8(sLw + lane * G::LW_P + n0, lw);
        load8(sR + lane * G::RK_P + n0, rr);
        load8(sK + lane * G::RK_P + n0, kk);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lw[j] = rr[j] = kk[j] = 0.f;
      }
      // Prefix sums in log2 units, so each decay is one ex2.
      float cum[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) cum[j] = lw[j] *= kLog2e;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = __shfl_up_sync(repro::kFullMask, cum[j], off);
          if (lane >= off) cum[j] += x;
        }
      }
      float rd[8], rn[8], kn[8], kf[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float mid = __shfl_sync(repro::kFullMask, cum[j], mid_row);
        const float tot = __shfl_sync(repro::kFullMask, cum[j], C - 1);
        const float ce = cum[j] - lw[j];
        // Past C, r = k = 0 and cum = total, so each factor there meets a
        // zero: kf's is 1, rd's and rn's at most 1; kn's has no bound, so
        // it is selected away.
        rd[j] = rr[j] * ex2(ce);
        rn[j] = rr[j] * ex2(ce - mid);
        kn[j] = live ? kk[j] * ex2(mid - cum[j]) : 0.f;
        kf[j] = kk[j] * ex2(tot - cum[j]);
        ub += rr[j] * (sU[n0 + j] * kk[j]);
        if (lane == 0) sEt[n0 + j] = ex2(tot);
      }
      store8(sRd + lane * G::RD_P + n0, rd);
      store8(sRn + lane * G::RN_P + n0, rn);
      store8(sKn + lane * G::RN_P + n0, kn);
      store8(sKf + lane * G::RD_P + n0, kf);
    }
    sUb[warp * CP + lane] = ub;
    for (int e = tid; e < CP * N; e += G::kThreads) {
      const int i = e / N, m = e % N;
      sVf[i * G::VF_P + m] = i < C ? to_f(sV[i * G::RK_P + m]) : 0.f;
    }
    __syncthreads();
    if (t0 + C < S) stage(t0 + C);   // lands while this chunk computes

    // 3. A[i][j] = <rn_i, kn_j> for j < i: the six 16 x 8 tiles on or
    //    below the diagonal of the 32 x 32 chunk.  Positions past C hold
    //    zeros in every tile, so all products run whole and only the stores
    //    of y look at C.
    for (int tile = warp; tile < 6; tile += kW) {
      const int i0 = tile < 2 ? 0 : 16;
      const int j0 = 8 * (tile < 2 ? tile : tile - 2);
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < N; kk += 8) {
        const float* pa = sRn + (i0 + g) * G::RN_P + kk + t4;
        const float* pb = sKn + (j0 + g) * G::RN_P + kk + t4;
        const float a[4] = {pa[0], pa[8 * G::RN_P], pa[4],
                            pa[8 * G::RN_P + 4]};
        const float bb[2] = {pb[0], pb[4]};
        mma3(acc, lo, split(a), split(bb));
      }
      add4(acc, lo);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + g + (q >> 1) * 8, j = j0 + 2 * t4 + (q & 1);
        sA[i * G::A_P + j] = j < i ? acc[q] : 0.f;
      }
    }
    if (warp == kW - 1) {    // the last warp has no more tiles than others
      float d = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) d += sUb[w * CP + lane];
      sUbT[lane] = d;
    }

    // 4. y^T[m][i] for the warp's values m and every position i, and the
    //    state update, which need no A and so run before A's barrier.
    //    Inter: the state's accumulator tiles are the A operand, with the
    //    keys of each 8 in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides.
    constexpr int IT = CP / 8;
    constexpr bool kExactV = sizeof(T) == 2;    // v holds bf16 values
    float yacc[IT][4], ylo[IT][4];
#pragma unroll
    for (int it = 0; it < IT; ++it)
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[it][c] = ylo[it][c] = 0.f;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const float a[4] = {sacc[q][0], sacc[q][2], sacc[q][1], sacc[q][3]};
      const Split<4> sa = split(a);
      const int nb = nw + 8 * q + 2 * t4;
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const float2 p =
            *reinterpret_cast<const float2*>(sRd + (8 * it + g) * G::RD_P + nb);
        const float bb[2] = {p.x, p.y};
        mma3(yacc[it], ylo[it], sa, split(bb));
      }
    }
    // The state decays by e^total, then gains v^T (k e^(total - cum)), 8
    // positions j at a time with v^T as the A operand.
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const float2 e =
          *reinterpret_cast<const float2*>(sEt + nw + 8 * q + 2 * t4);
      sacc[q][0] *= e.x;
      sacc[q][1] *= e.y;
      sacc[q][2] *= e.x;
      sacc[q][3] *= e.y;
    }
    auto v_frag = [&](int j0) {
      const float* pv = sVf + (j0 + t4) * G::VF_P + m0 + g;
      const float a[4] = {pv[0], pv[8], pv[4 * G::VF_P], pv[4 * G::VF_P + 8]};
      return split(a);
    };
#pragma unroll
    for (int j0 = 0; j0 < CP; j0 += 8) {
      const Split<4> sa = v_frag(j0);
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const float* pk = sKf + (j0 + t4) * G::RD_P + nw + 8 * q + g;
        const float bb[2] = {pk[0], pk[4 * G::RD_P]};
        mma3<kExactV>(sacc[q], sacc[q], sa, split(bb));
      }
    }
    __syncthreads();

    // Intra: v^T A^T, zero unless j < i (key part 0 only).
    if (np == 0) {
#pragma unroll
      for (int j0 = 0; j0 < CP; j0 += 8) {
        const Split<4> sa = v_frag(j0);
#pragma unroll
        for (int it = j0 / 8; it < IT; ++it) {
          const float* pa = sA + (8 * it + g) * G::A_P + j0 + t4;
          const float bb[2] = {pa[0], pa[4]};
          mma3<kExactV>(yacc[it], ylo[it], sa, split(bb));
        }
      }
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) add4(yacc[it], ylo[it]);

    // Bonus: y[i][m] += <r_i, u k_i> v[i][m].  A warp that holds all keys
    // stores its y^T tiles as they are (eight values m a 32-byte sector);
    // else the key parts' partials meet in shared memory as y[i][m].
    float* yrow = y + (static_cast<long long>(b) * S + t0) * H * N +
                  static_cast<long long>(h) * N;
#pragma unroll
    for (int it = 0; it < IT; ++it) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * it + 2 * t4 + (q & 1), m = m0 + g + (q >> 1) * 8;
        if (np == 0) yacc[it][q] += sUbT[i] * sVf[i * G::VF_P + m];
        if constexpr (G::NP == 1) {
          if (i < C) yrow[static_cast<long long>(i) * H * N + m] = yacc[it][q];
        } else {
          sY[(np * CP + i) * G::YB_P + m] = yacc[it][q];
        }
      }
    }
    if constexpr (G::NP == 1) continue;
    __syncthreads();

    // y rows of this chunk: the key parts' partials added in order, 16
    // bytes at a time.
    for (int e = tid; e < C * (N / 4); e += G::kThreads) {
      const int i = e / (N / 4), c4 = 4 * (e % (N / 4));
      float4 acc = *reinterpret_cast<const float4*>(sY + i * G::YB_P + c4);
#pragma unroll
      for (int p = 1; p < G::NP; ++p) {
        const float4 o = *reinterpret_cast<const float4*>(
            sY + (p * CP + i) * G::YB_P + c4);
        acc.x += o.x, acc.y += o.y, acc.z += o.z, acc.w += o.w;
      }
      *reinterpret_cast<float4*>(yrow + static_cast<long long>(i) * H * N +
                                 c4) = acc;
    }
  }

#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const int n = nw + 8 * q + 2 * t4;
    st[n * N] = sacc[q][0];
    st[(n + 1) * N] = sacc[q][1];
    st[n * N + 8] = sacc[q][2];
    st[(n + 1) * N + 8] = sacc[q][3];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ logw,
                     const float* __restrict__ u, float* __restrict__ state,
                     float* __restrict__ y, int S, int H, long long sb,
                     long long ss, long long sh) {
  constexpr int G = kThreads / N;
  constexpr int R = N / G;
  __shared__ float sr[N], sk[N], sv[N], sw[N];
  __shared__ float red[G][N];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int m = tid % N, g = tid / N;
  const long long base = b * sb + h * sh;
  float* st = state + static_cast<long long>(bh) * N * N;

  float s[R], uu[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int n = g + G * q;
    s[q] = st[n * N + m];
    uu[q] = u[h * N + n];
  }

  for (int t = 0; t < S; ++t) {
    if (tid < N) {
      const long long off = base + t * ss + tid;
      sr[tid] = to_f(r[off]);
      sk[tid] = to_f(k[off]);
      sv[tid] = to_f(v[off]);
      sw[tid] = expf(logw[off]);
    }
    __syncthreads();
    const float vm = sv[m];
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int n = g + G * q;
      const float kv = sk[n] * vm;
      acc += sr[n] * (s[q] + uu[q] * kv);
      s[q] = sw[n] * s[q] + kv;
    }
    red[g][m] = acc;
    __syncthreads();
    if (tid < N) {
      float out = 0.f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) out += red[gg][tid];
      y[((static_cast<long long>(b) * S + t) * H + h) * N + tid] = out;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < R; ++q) st[(g + G * q) * N + m] = s[q];
}

template <typename T, int N, bool ASYNC>
cudaError_t launch_chunk(const T* r, const T* k, const T* v,
                         const float* logw, const float* u, float* state,
                         float* y, int B, int S, int H, int C, long long sb,
                         long long ss, long long sh, cudaStream_t stream) {
  using G = ChunkGeo<T, N>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T, N, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (configured != cudaSuccess) return configured;
  wkv6_chunk_kernel<T, N, ASYNC><<<B * H, G::kThreads, G::kSmemBytes, stream>>>(
      r, k, v, logw, u, state, y, S, H, C, sb, ss, sh);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, float* state, float* y,
                   int B, int S, int H, int C, long long sb, long long ss,
                   long long sh, bool async, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (C == 1) {
    wkv6_step_kernel<T, N><<<B * H, kThreads, 0, stream>>>(
        rt, kt, vt, logw, u, state, y, S, H, sb, ss, sh);
    return cudaGetLastError();
  }
  if (!async)
    return launch_chunk<T, N, false>(rt, kt, vt, logw, u, state, y, B, S, H,
                                     C, sb, ss, sh, stream);
  // 16-byte copies need 16-byte aligned rows of r, k, v and logw.
  constexpr long long ev = 16 / sizeof(T);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(r) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(logw);
  if (bases % 16 != 0 || sb % ev != 0 || ss % ev != 0 || sh % ev != 0)
    return cudaErrorInvalidValue;
  return launch_chunk<T, N, true>(rt, kt, vt, logw, u, state, y, B, S, H, C,
                                  sb, ss, sh, stream);
}

template <typename T>
cudaError_t dispatch_n(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, float* state,
                       float* y, int B, int S, int H, int N, int C,
                       long long sb, long long ss, long long sh, bool async,
                       cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, async, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, async, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, async, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// --- the backward kernel -----------------------------------------------------
//
// Gradients of y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T) and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T (w = exp(logw)) given dy, from the
// initial state S_0 (a constant).  G_t, the gradient reaching S_t, walks
// backward from G_{S-1} = 0: G_{t-1} = diag(w_t) G_t + r_t dy_t^T.  With
// vdy_t = v_t . dy_t and ruk_t = r_t . (u k_t):
//   dr_t = S_{t-1} dy_t + u k_t vdy_t          (the first term: dr^s_t)
//   dk_t = G_t v_t + u r_t vdy_t               (the first term: dk^s_t)
//   dv_t = G_t^T k_t + ruk_t dy_t
//   du   = sum over b, t of r_t k_t vdy_t
//   dlogw_t = w_t rowsum(G_t o S_{t-1})
//           = sum_{i > t} r_i dr^s_i - sum_{j >= t} k_j dk^s_j,
// the last form because each term of both sums is a pair (j < i) of the
// recurrence, r_i k_j (v_j . dy_i) prod_{j<l<i} w_l (j = -1: the initial
// state's term), and logw_t moves exactly the pairs with j < t < i; the
// pairs with j >= t appear in both sums and cancel.  So no pass needs S_{t-1}
// and G_t at the same t, which run in opposite directions.  The two suffix
// sums are carried in fp64, so that their difference keeps fp32's precision
// when each is much larger than it (slow decays over long sequences).
//
// Chunked form.  Per chunk of C = kBwdChunk positions (the last padded with
// zeros), with cum the inclusive prefix sums of logw in the chunk, ce the
// exclusive ones, tot the chunk's total and mid = cum at the chunk's middle
// (the forward's renormalisation: every factor below is formed about mid,
// so no exponent leaves fp32's range over half a chunk), B_ij = dy_i . v_j
// and A_ij = <r_i e^(ce_i - mid), k_j e^(mid - cum_j)> for j < i (zero
// else), S_c the state at the chunk's start and G_e the gradient at its end:
//   dr^s = e^ce o (dy S_c^T) + e^(ce - mid) o (B (k e^(mid - cum)))
//   dk^s = e^(tot - cum) o (v G_e^T) + e^(mid - cum) o (B^T (r e^(ce - mid)))
//   dv^s = (k e^(tot - cum)) G_e + A^T dy
//   S_c <- e^tot o S_c + (k e^(tot - cum))^T v,
//   G_e <- e^tot o G_e + (r e^ce)^T dy,
// nine products (B twice) on the tensor cores, as `mma.sync.m16n8k8` in
// TF32 with the split of tf32.cuh.  dlogw's two suffix sums are taken a
// chunk of per-position terms at a time.
//
// A CTA owns one (b, h) and walks the chunks twice:
//  A. forward, with the state in registers: dr and r dr^s (parked in
//     dlogw's place), stored from the accumulators; du's per-(b, h) part;
//  B. backward, with G in registers: dk (staged, then stored a row at a
//     time), dv (stored from the accumulators) and dlogw.
// A warp owns 16 keys n of the state (or of G): rows n of S and G are
// independent, so dr^s and dk^s (sums over the values m of the warp's own
// rows) need no sum across warps, and both states stay in the accumulator
// registers of the products from the first chunk to the last, feeding them
// straight as A operands (the keys of each 8 in the order (0, 2, 4, 6, 1,
// 3, 5, 7), the order in which an accumulator tile holds its columns, and
// the other operand read in the same order).  dv^s sums over the keys, so
// each chunk the warps put their rows of G in shared memory and a warp
// takes 16 value columns of dv over every key.  Each chunk: the inputs
// arrive by 16-byte cp.async copies, issued while the previous chunk
// computes (plain loads where they are not 16-byte aligned; rows past S
// zero-filled); one lane a position and 8 keys makes the prefix sums by
// warp scans (in log2 units, so each decay is one ex2), the scaled k and
// r and the two per-position dot products; the C x C products B and A;
// the products above.  dlogw's suffix sums take two threads a key, one for
// each half of the chunk, and both carry the sums across chunks, the same
// bits on both.  du, a sum over B and S, is taken in the same launch
// without atomic sums: each CTA writes its (b, h) part, and the last of a
// head's B CTAs to finish (a ticket, `last_to_arrive`) adds the parts in
// b order, in fp64.  The same inputs give the same bits.
//
// Precision.  dlogw is a small difference of two long sums, so each
// term's error is amplified by the length of the sequence: a pair (j < i)
// of the recurrence reaches r_i dr^s_i and k_j dk^s_j through the same
// rounded factors (e^(ce - mid) e^mid and e^(mid - cum) e^(tot - mid),
// formed once in the prep), and the states carried from chunk to chunk
// take each chunk's gain in one rounding on the CUDA cores, as the tensor
// core's truncated sums would bias them.  Every product is 3xTF32
// (`mma3`), dropping only a cross term that is exactly zero: the one that
// reads v's small part where v holds bf16 values.  fp32 inputs, whose
// dlogw is held to 1e-4 over sums of thousands of terms, also round both
// parts of every operand to nearest (`split_rn`: no product's error
// leans one way along the suffix sums, which truncation's bias pushed to
// the tolerance at S 2048), take a fourth TF32 product (small * small)
// and add each k-step's products on the CUDA cores (`sum_mma`).  bf16
// inputs, held to 2e-2, keep the cheaper truncating split.
//
// Bound on the H100: at rwkv6-3b's training shape (B 8, S 512, 40 x 64)
// the bytes are ~257 MB (r, k, v and dr, dk, dv in bf16; logw, dy and
// dlogw in fp32; the initial state), 0.077 ms at 3.35 TB/s; the nine
// products in 3xTF32 take ~0.041 ms at the TF32 peak, so the bytes bound
// it.  What sets the pace is each (b, h)'s serial chain of 64 chunk steps
// (two sweeps of 32), whose latency one CTA alone already shows (PERF.md:
// `scripts/ab_recurrent_bwd.py` times B 1 to 8), and the two walks'
// traffic, ~1.9x the bound's bytes (the inputs twice, the parked terms out
// and back).  So a chunk is 16 positions, every staged array small enough
// for three CTAs of 4 warps an SM (all 320 resident at once), the next
// chunk's inputs stage while this one computes, and each thread's copy
// and store offsets are taken once, not a chunk at a time.

constexpr int kBwdChunk = 16;   // positions a chunk (the last padded)

// a b as mma3 makes it, plus, where FOUR, small * small: fp32 inputs take
// the fourth product (dlogw's suffix sums amplify each term's error, and
// the fourth product makes a term ~4x more exact); bf16 inputs, whose
// tolerance is wider, take three.
template <bool EXACT_A, bool EXACT_B, bool FOUR>
__device__ __forceinline__ void bmma(float (&hi)[4], float (&lo)[4],
                                     const Split<4>& a, const Split<2>& b) {
  mma3<EXACT_A, EXACT_B>(hi, lo, a, b);
  if constexpr (FOUR && !EXACT_A && !EXACT_B)
    repro::mma_tf32(lo, a.small, b.small);
}

// The backward's split of x: to nearest where RN (fp32 inputs), else
// truncated; x as it is where EXACT (bf16 values: exact in TF32, so the
// small parts are zero and the products that read them are dropped).
template <bool EXACT, bool RN, int K>
__device__ __forceinline__ Split<K> split_as(const float (&x)[K]) {
  if constexpr (EXACT) {
    Split<K> s;
#pragma unroll
    for (int i = 0; i < K; ++i) s.big[i] = __float_as_uint(x[i]), s.small[i] = 0u;
    return s;
  } else if constexpr (RN) {
    return split_rn(x);
  } else {
    return split(x);
  }
}

// bmma for a product whose terms feed dlogw's suffix sums (dr^s, dk^s and
// the states' gains).  Where FOUR (fp32 inputs) each k-step's products go
// to a fresh accumulator and are added to `hi` on the CUDA cores, rounded
// to nearest: the tensor core truncates the sums it keeps, a bias that a
// chain of k-steps adds up and the suffix sums would carry; `lo` is then
// unused.
template <bool EXACT_A, bool EXACT_B, bool FOUR>
__device__ __forceinline__ void sum_mma(float (&hi)[4], float (&lo)[4],
                                        const Split<4>& a,
                                        const Split<2>& b) {
  if constexpr (FOUR) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    bmma<EXACT_A, EXACT_B, true>(t, t, a, b);
    add4(hi, t);
  } else {
    bmma<EXACT_A, EXACT_B, false>(hi, lo, a, b);
  }
}

template <typename T, int N>
struct BwdGeo {
  static constexpr int CP = kBwdChunk;
  static constexpr int W = N / 16;            // warps: 16 keys each
  static constexpr int kThreads = 32 * W;
  static constexpr int NT = N / 8;            // 8-column tiles of a row
  static constexpr int EV = 16 / sizeof(T);   // elements a 16-byte copy
  static constexpr int FP = N + 4;            // fp32 [position][channel]
  static constexpr int TP = N + EV;           // T [position][channel]
  static constexpr int BP = CP + 4;           // B and A, [i][j]
  // One stage of the inputs (two, alternating by chunk): logw in rows
  // 1..C of `cum`, overwritten in place by the inclusive prefix sums in
  // log2 units (row 0 stays 0, so row i holds ce_i and row i + 1 cum_i);
  // dy (fp32), r, k, v (T).
  static constexpr int oCum = 0;
  static constexpr int oDy = oCum + (CP + 1) * FP * 4;
  static constexpr int oR = oDy + CP * FP * 4;
  static constexpr int oK = oR + CP * TP * int(sizeof(T));
  static constexpr int oV = oK + CP * TP * int(sizeof(T));
  static constexpr int kStage = oV + CP * TP * int(sizeof(T));
  // Per chunk: k e^(mid - cum), r e^(ce - mid), B, A, G's rows, two output
  // tiles, per-key mid, e^tot, e^mid, e^(tot - mid) and u, and the warps'
  // parts of vdy and ruk.
  static constexpr int oKn = 2 * kStage;
  static constexpr int oRn = oKn + CP * FP * 4;
  static constexpr int oB = oRn + CP * FP * 4;
  static constexpr int oA = oB + CP * BP * 4;
  static constexpr int oG = oA + CP * BP * 4;
  static constexpr int oO1 = oG + N * FP * 4;
  static constexpr int oO2 = oO1 + CP * FP * 4;
  static constexpr int oVec = oO2 + CP * FP * 4;
  static constexpr int oDot = oVec + 5 * N * 4;
  static constexpr int kSmemBytes = oDot + 2 * W * CP * 4;
  static_assert(N % 16 == 0 && CP == 16, "a warp 16 keys, a lane a position");
  static_assert((CP + 1) * FP * 4 % 16 == 0 && CP * TP * sizeof(T) % 16 == 0 &&
                    kStage % 16 == 0 && oKn % 16 == 0 && oG % 16 == 0,
                "16-byte aligned tiles");
};

template <typename T>
struct BwdStage {
  float* cum;
  float* dy;
  T* r;
  T* k;
  T* v;
};

// Four consecutive fp32 values of a staged row to `n` elements of T at p.
template <typename T>
__device__ __forceinline__ void store4_as(T* p, float4 x) {
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = x;
  }
}

template <typename T>
__device__ __forceinline__ void store2_as(T* p, float a, float b) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

template <typename T, int N, bool ASYNC>
__global__ void __launch_bounds__(BwdGeo<T, N>::kThreads, 3)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u,
                    const float* __restrict__ state0,
                    const float* __restrict__ dy, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv, float* dlogw,
                    float* __restrict__ du, float* __restrict__ part,
                    unsigned int* __restrict__ tickets, int B, int S, int H,
                    long long sb, long long ss, long long sh) {
  using G = BwdGeo<T, N>;
  constexpr int CP = G::CP, W = G::W, NT = G::NT, EV = G::EV;
  constexpr int FP = G::FP, TP = G::TP, BP = G::BP, kT = G::kThreads;
  constexpr bool kExactV = sizeof(T) == 2;    // v holds bf16 values
  constexpr bool kFour = sizeof(T) == 4;      // four TF32 products (bmma)
  auto sp = [](const auto& x) { return split_as<false, kFour>(x); };
  extern __shared__ __align__(16) unsigned char smem[];
  float* sKn = reinterpret_cast<float*>(smem + G::oKn);
  float* sRn = reinterpret_cast<float*>(smem + G::oRn);
  float* sB = reinterpret_cast<float*>(smem + G::oB);
  float* sA = reinterpret_cast<float*>(smem + G::oA);
  float* sG = reinterpret_cast<float*>(smem + G::oG);
  float* sO1 = reinterpret_cast<float*>(smem + G::oO1);
  float* sO2 = reinterpret_cast<float*>(smem + G::oO2);
  float* sMid = reinterpret_cast<float*>(smem + G::oVec);
  float* sEt = sMid + N;      // e^tot
  float* sEm = sEt + N;       // e^mid
  float* sEtm = sEm + N;      // e^(tot - mid)
  float* sU = sEtm + N;
  float* sVdy = reinterpret_cast<float*>(smem + G::oDot);   // [W][CP]
  float* sRuk = sVdy + W * CP;
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;      // mma fragment coordinates
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const int n0 = warp * 16;                    // the warp's keys
  const int chunks = (S + CP - 1) / CP;
  // Offset of (b, t, h, 0) in the contiguous [B, S, H, N] tensors; a row
  // of them is HN elements on.
  const int HN = H * N;
  auto row = [&](int t) {
    return (static_cast<long long>(b) * S + t) * HN +
           static_cast<long long>(h) * N;
  };
  auto stage_at = [&](int buf) {
    unsigned char* p = smem + buf * G::kStage;
    return BwdStage<T>{reinterpret_cast<float*>(p + G::oCum),
                       reinterpret_cast<float*>(p + G::oDy),
                       reinterpret_cast<T*>(p + G::oR),
                       reinterpret_cast<T*>(p + G::oK),
                       reinterpret_cast<T*>(p + G::oV)};
  };
  for (int e = tid; e < 2 * N; e += kT) stage_at(e / N).cum[e % N] = 0.f;
  for (int e = tid; e < N; e += kT) sU[e] = u[h * N + e];

  // Chunk c's inputs into stage buffer `buf`, rows past S zero.  A
  // thread's copies keep their rows and columns from chunk to chunk, so
  // their offsets from the chunk's first row are taken once.
  constexpr int kC1 = CP / 8;                   // logw and dy copies a thread
  constexpr int kC2 = CP * (N / EV) / kT;       // r, k and v copies
  static_assert(CP * (N / 4) == kC1 * kT && CP * (N / EV) == kC2 * kT,
                "whole copies a thread");
  long long in_off[kC1 > kC2 ? kC1 : kC2];
  auto stage = [&](int c, int buf) {
    const BwdStage<T> st = stage_at(buf);
    const int t0 = c * CP, lc = min(CP, S - t0);
    if constexpr (ASYNC) {
      const long long in0 = base + static_cast<long long>(t0) * ss;
      const long long dy0 = row(t0);
#pragma unroll
      for (int x = 0; x < kC1; ++x) {
        const int e = tid + x * kT, i = e / (N / 4), q = 4 * (e % (N / 4));
        const bool ok = i < lc;
        repro::cp_async16_zfill(st.cum + (i + 1) * FP + q,
                                logw + in0 + (ok ? in_off[x] : 0) + q, ok);
        repro::cp_async16_zfill(st.dy + i * FP + q,
                                dy + dy0 + (ok ? i * HN : 0) + q, ok);
      }
#pragma unroll
      for (int x = 0; x < kC2; ++x) {
        const int e = tid + x * kT, i = e / (N / EV), q = EV * (e % (N / EV));
        const bool ok = i < lc;
        const long long off = in0 + (ok ? (kC1 == kC2 ? in_off[x]
                                                     : i * ss) : 0) + q;
        repro::cp_async16_zfill(st.r + i * TP + q, r + off, ok);
        repro::cp_async16_zfill(st.k + i * TP + q, k + off, ok);
        repro::cp_async16_zfill(st.v + i * TP + q, v + off, ok);
      }
      cp_async_commit();
    } else {
      const T zero = repro::from_f<T>(0.f);
      for (int e = tid; e < CP * N; e += kT) {
        const int i = e / N, n = e % N;
        const bool ok = i < lc;
        const long long off = base + (t0 + i) * ss + n;
        st.cum[(i + 1) * FP + n] = ok ? logw[off] : 0.f;
        st.dy[i * FP + n] = ok ? dy[row(t0 + i) + n] : 0.f;
        st.r[i * TP + n] = ok ? r[off] : zero;
        st.k[i * TP + n] = ok ? k[off] : zero;
        st.v[i * TP + n] = ok ? v[off] : zero;
      }
    }
  };
#pragma unroll
  for (int x = 0; x < (kC1 > kC2 ? kC1 : kC2); ++x)
    in_off[x] = static_cast<long long>((tid + x * kT) / (N / 4)) * ss;

  // One lane a position i and 8 keys (the warp's 16 in two halves of the
  // warp): the prefix sums of logw by warp scans in log2 units, written
  // over the staged logw; k e^(mid - cum) (and, backward, r e^(ce - mid));
  // the per-key factors; the warp's parts of vdy and ruk.  Positions past
  // the chunk hold zeros, so cum there is tot.
  auto prep = [&](const BwdStage<T>& st, int lc, bool backward) {
    const int half = lane >> 4, i = lane & 15;
    const int c0 = n0 + 8 * half;
    const bool live = i < lc;
    float lw[8], cum[8], rr[8], kk[8], vv[8], dd[8];
    load8(st.cum + (i + 1) * FP + c0, lw);
    load8(st.r + i * TP + c0, rr);
    load8(st.k + i * TP + c0, kk);
    load8(st.v + i * TP + c0, vv);
    load8(st.dy + i * FP + c0, dd);
#pragma unroll
    for (int j = 0; j < 8; ++j) cum[j] = lw[j] *= kLog2e;
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __shfl_up_sync(repro::kFullMask, cum[j], off, 16);
        if (i >= off) cum[j] += x;
      }
    }
    float kn[8], rn[8], vdy = 0.f, ruk = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float mid = __shfl_sync(repro::kFullMask, cum[j], CP / 2 - 1, 16);
      // ce_i = cum_{i-1}, the same bits as the row the outputs read.
      const float prev = __shfl_up_sync(repro::kFullMask, cum[j], 1, 16);
      const float ce = i == 0 ? 0.f : prev;
      kn[j] = live ? kk[j] * ex2(mid - cum[j]) : 0.f;
      rn[j] = rr[j] * ex2(ce - mid);
      vdy += vv[j] * dd[j];
      ruk += rr[j] * (sU[c0 + j] * kk[j]);
    }
    store8(st.cum + (i + 1) * FP + c0, cum);
    // The per-key vectors, a lane a key: mid = cum_{C/2-1}, tot = cum_{C-1}.
    __syncwarp();
    if (i < 8) {
      const int n = c0 + i;
      const float mid = st.cum[CP / 2 * FP + n], tot = st.cum[CP * FP + n];
      sMid[n] = mid;
      sEt[n] = ex2(tot);
      sEm[n] = ex2(mid);
      sEtm[n] = ex2(tot - mid);
    }
    store8(sKn + i * FP + c0, kn);
    if (backward) store8(sRn + i * FP + c0, rn);

    vdy += __shfl_xor_sync(repro::kFullMask, vdy, 16);
    if (half == 0) sVdy[warp * CP + i] = vdy;
    if (backward) {
      ruk += __shfl_xor_sync(repro::kFullMask, ruk, 16);
      if (half == 0) sRuk[warp * CP + i] = ruk;
    }
  };
  // A B operand of dy at offsets o0 and o1 of a chunk's tile.
  auto dy_frag = [&](const BwdStage<T>& st, int o0, int o1) {
    const float b[2] = {st.dy[o0], st.dy[o1]};
    return sp(b);
  };
  // vdy_i and ruk_i: the warps' parts added in warp order.
  auto dot_of = [&](const float* parts, int i) {
    float x = parts[i];
#pragma unroll
    for (int w = 1; w < W; ++w) x += parts[w * CP + i];
    return x;
  };

  // B^T tile `it`: B^T[j][i] = v_j . dy_i for every j and i in [8 it,
  // 8 it + 8), stored as B[i][j], zero unless j < i.  B reaches dr^s_i and
  // dk^s_j of a pair through the same values, so its error cancels in
  // dlogw's sums.
  auto b_tile = [&](const BwdStage<T>& st, int it) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < N; kk += 8) {
      const T* pv = st.v + g * TP + kk + t4;
      const float a[4] = {to_f(pv[0]), to_f(pv[8 * TP]), to_f(pv[4]),
                          to_f(pv[8 * TP + 4])};
      const int o = (8 * it + g) * FP + kk + t4;
      const Split<2> bb = dy_frag(st, o, o + 4);
      bmma<kExactV, false, kFour>(acc, lo, split_as<kExactV, kFour>(a), bb);
    }
    add4(acc, lo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = g + (q >> 1) * 8, i = 8 * it + 2 * t4 + (q & 1);
      sB[i * BP + j] = j < i ? acc[q] : 0.f;
    }
  };
  // A tile `jt`: A[i][j] = <rn_i, kn_j> for every i and j in [8 jt,
  // 8 jt + 8), zero unless j < i.
  auto a_tile = [&](int jt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, lo[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < N; kk += 8) {
      const float* pr = sRn + g * FP + kk + t4;
      const float a[4] = {pr[0], pr[8 * FP], pr[4], pr[8 * FP + 4]};
      const float* pk = sKn + (8 * jt + g) * FP + kk + t4;
      const float bb[2] = {pk[0], pk[4]};
      bmma<false, false, kFour>(acc, lo, sp(a), sp(bb));
    }
    add4(acc, lo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = g + (q >> 1) * 8, j = 8 * jt + 2 * t4 + (q & 1);
      sA[i * BP + j] = j < i ? acc[q] : 0.f;
    }
  };
  // The rows [i0, i0 + lc) of a staged [C][N] fp32 tile to `out` (T), 16
  // bytes a thread.
  auto store_rows = [&](const float* tile, auto* out, int t0, int lc) {
    auto* o = out + row(t0);
    for (int e = tid; e < lc * (N / 4); e += kT) {
      const int i = e / (N / 4), c4 = 4 * (e % (N / 4));
      const float4 x = *reinterpret_cast<const float4*>(tile + i * FP + c4);
      store4_as(o + i * HN + c4, x);
    }
  };
  // The A operand of a product over the warp's 16 rows of an accumulator
  // state, tile q: keys in the order (0, 2, 4, 6, 1, 3, 5, 7).
  auto state_a = [&](const float (&s)[4]) {
    const float a[4] = {s[0], s[2], s[1], s[3]};
    return sp(a);
  };
  // An accumulator tile of the state (or G) decayed by its rows' e^tot,
  // plus a gain, one rounding each.
  auto decay_add = [](float (&s)[4], float e_lo, float e_hi,
                      const float (&up)[4]) {
    s[0] = fmaf(s[0], e_lo, up[0]);
    s[1] = fmaf(s[1], e_lo, up[1]);
    s[2] = fmaf(s[2], e_hi, up[2]);
    s[3] = fmaf(s[3], e_hi, up[3]);
  };
  // vdy (or ruk) at the four positions 8 it + 2 t4 + c of a lane's
  // accumulator columns, [it][c].
  auto lane_dots = [&](const float* parts, float (&x)[2][2]) {
#pragma unroll
    for (int it = 0; it < 2; ++it)
#pragma unroll
      for (int c = 0; c < 2; ++c) x[it][c] = dot_of(parts, 8 * it + 2 * t4 + c);
  };
  const float u_lo = u[h * N + n0 + g], u_hi = u[h * N + n0 + g + 8];

  // A. Forward: the state's rows n0 .. n0 + 15, S[n][m] in tiles q of 8
  // values m: (n0 + g, 8q + 2 t4 (+1)) and (n0 + g + 8, ...).
  float sacc[NT][4];
  {
    const float* s0 = state0 + static_cast<long long>(bh) * N * N;
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const float2 a = *reinterpret_cast<const float2*>(
          s0 + (n0 + g) * N + 8 * q + 2 * t4);
      const float2 c = *reinterpret_cast<const float2*>(
          s0 + (n0 + g + 8) * N + 8 * q + 2 * t4);
      sacc[q][0] = a.x, sacc[q][1] = a.y, sacc[q][2] = c.x, sacc[q][3] = c.y;
    }
  }
  double du_lo = 0.0, du_hi = 0.0;
  stage(0, 0);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * CP, lc = min(CP, S - t0);
    const BwdStage<T> st = stage_at(c & 1);
    if constexpr (ASYNC) cp_async_wait_all();
    __syncthreads();
    prep(st, lc, false);
    __syncthreads();
    if (c + 1 < chunks) stage(c + 1, (c + 1) & 1);
    for (int tile = warp; tile < 2; tile += W) b_tile(st, tile);

    // Inter: (dy S_c^T)^T[n][i], from the state before its update.
    float ai[2][4] = {}, al[2][4] = {};
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const Split<4> sa = state_a(sacc[q]);
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int o = (8 * it + g) * FP + 8 * q + 2 * t4;
        sum_mma<false, false, kFour>(ai[it], al[it], sa,
                                     dy_frag(st, o, o + 1));
      }
    }
    // The state decays by e^tot and gains (k e^(tot - cum))^T v, with
    // k e^(tot - cum) = kn e^(tot - mid): the gain in fresh accumulators,
    // added to the decayed state in one rounding (the tensor core's
    // truncated sums would bias a state carried over every chunk).
    {
      const float f_lo = sEtm[n0 + g], f_hi = sEtm[n0 + g + 8];
      Split<4> sa[CP / 8];
#pragma unroll
      for (int ks = 0; ks < CP / 8; ++ks) {
        const float* pk = sKn + (8 * ks + t4) * FP + n0 + g;
        const float a[4] = {pk[0] * f_lo, pk[8] * f_hi, pk[4 * FP] * f_lo,
                            pk[4 * FP + 8] * f_hi};
        sa[ks] = sp(a);
      }
      const float e_lo = sEt[n0 + g], e_hi = sEt[n0 + g + 8];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        float up[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < CP / 8; ++ks) {
          const T* pv = st.v + (8 * ks + t4) * TP + 8 * q + g;
          const float bb[2] = {to_f(pv[0]), to_f(pv[4 * TP])};
          sum_mma<false, kExactV, kFour>(up, up, sa[ks],
                                         split_as<kExactV, kFour>(bb));
        }
        decay_add(sacc[q], e_lo, e_hi, up);
      }
    }
    __syncthreads();    // B

    // Intra: (B kn)^T[n][i] = sum_{j < i} kn^T[n][j] B[i][j].
    float ia[2][4] = {};    // (one accumulator: a short chain)
#pragma unroll
    for (int kk = 0; kk < CP; kk += 8) {
      const float* pk = sKn + (kk + t4) * FP + n0 + g;
      const float a[4] = {pk[0], pk[8], pk[4 * FP], pk[4 * FP + 8]};
      const Split<4> sa = sp(a);
#pragma unroll
      for (int it = kk / 8; it < 2; ++it) {
        const float* pb = sB + (8 * it + g) * BP + kk + t4;
        const float bb[2] = {pb[0], pb[4]};
        sum_mma<false, false, kFour>(ia[it], ia[it], sa, sp(bb));
      }
    }
    // dr = dr^s + u k vdy; r dr^s parked in dlogw's place; du's terms.  Each
    // pair (j < i) of the recurrence reaches r_i dr^s_i here and k_j dk^s_j
    // in the backward sweep through the same rounded factors, e^(ce - mid)
    // e^mid (as G's gain forms r e^ce) and e^(mid - cum) e^(tot - mid) (as
    // the state's forms k e^(tot - cum)), so that dlogw's suffix sums
    // cancel to within the products' rounding.
    {
      const long long r0 = row(t0);
      const float m_lo = sMid[n0 + g], m_hi = sMid[n0 + g + 8];
      const float em_lo = sEm[n0 + g], em_hi = sEm[n0 + g + 8];
      float vdy[2][2], du_chunk[2] = {0.f, 0.f};
      lane_dots(sVdy, vdy);
#pragma unroll
      for (int it = 0; it < 2; ++it) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool hi = q >> 1;
          const int n = n0 + g + 8 * hi, i = 8 * it + 2 * t4 + (q & 1);
          const float drs = ex2(st.cum[i * FP + n] - (hi ? m_hi : m_lo)) *
                            ((hi ? em_hi : em_lo) * (ai[it][q] + al[it][q]) +
                             ia[it][q]);
          const float rr = to_f(st.r[i * TP + n]);
          const float kk = to_f(st.k[i * TP + n]);
          const float kv = kk * vdy[it][q & 1];
          if (i < lc) {    // stored from the accumulators: no barrier
            const long long o = r0 + i * HN + n;
            dr[o] = repro::from_f<T>(drs + (hi ? u_hi : u_lo) * kv);
            dlogw[o] = rr * drs;
          }
          du_chunk[hi] += rr * kv;
        }
      }
      du_lo += static_cast<double>(du_chunk[0]);
      du_hi += static_cast<double>(du_chunk[1]);
    }
  }

  // du: this (b, h)'s part (the four lanes of a key in a fixed order), then
  // the head's last CTA adds the B parts in b order.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    du_lo += __shfl_xor_sync(repro::kFullMask, du_lo, off);
    du_hi += __shfl_xor_sync(repro::kFullMask, du_hi, off);
  }
  if (t4 == 0) {
    part[static_cast<long long>(bh) * N + n0 + g] = static_cast<float>(du_lo);
    part[static_cast<long long>(bh) * N + n0 + g + 8] =
        static_cast<float>(du_hi);
  }
  // (last_to_arrive ends behind a barrier with the CTA's writes visible:
  // the parked terms and the last stage's buffers are free.)
  if (repro::last_to_arrive(tickets + h, B, &last) && tid < N) {
    double sum = 0.0;
    for (int bb = 0; bb < B; ++bb)
      sum += part[(static_cast<long long>(bb) * H + h) * N + tid];
    du[h * N + tid] = static_cast<float>(sum);
  }

  // B. Backward: G's rows n0 .. n0 + 15 as the state's were.  dlogw: two
  // threads a key dn, for the halves dh of a chunk; each holds its half's
  // parked terms through the chunk, and both carry the key's suffix sums.
  float gacc[NT][4];
#pragma unroll
  for (int q = 0; q < NT; ++q)
    gacc[q][0] = gacc[q][1] = gacc[q][2] = gacc[q][3] = 0.f;
  const int dn = tid >> 1, dh = tid & 1;
  double suf_r = 0.0, suf_k = 0.0;
  float parked[CP / 2];
  // A chunk's last steps: its dk rows from the staged tile, and dlogw
  // from its parked terms and the staged k dk^s.
  auto finish = [&](int t0, int lc) {
    store_rows(sO1, dk, t0, lc);
    float* dlw0 = dlogw + row(t0) + dn;
    // dlogw_j = sum_{i > j} r_i dr^s_i - sum_{i >= j} k_i dk^s_i, in fp64:
    // the later half's sums first, then each half walks its positions
    // backward.
    {
      double p_own = 0.0, q_own = 0.0;
      float qv[CP / 2];
#pragma unroll
      for (int s = 0; s < CP / 2; ++s) {
        qv[s] = sO2[(CP / 2 * dh + s) * FP + dn];
        p_own += static_cast<double>(parked[s]);
        q_own += static_cast<double>(qv[s]);
      }
      const double p_oth = __shfl_xor_sync(repro::kFullMask, p_own, 1);
      const double q_oth = __shfl_xor_sync(repro::kFullMask, q_own, 1);
      double sr = suf_r + (dh ? 0.0 : p_oth);
      double sk = suf_k + (dh ? 0.0 : q_oth);
#pragma unroll
      for (int s = CP / 2 - 1; s >= 0; --s) {
        const int j = CP / 2 * dh + s;
        sk += static_cast<double>(qv[s]);
        if (j < lc) dlw0[j * HN] = static_cast<float>(sr - sk);
        sr += static_cast<double>(parked[s]);
      }
      suf_r = (suf_r + (dh ? p_own : p_oth)) + (dh ? p_oth : p_own);
      suf_k = (suf_k + (dh ? q_own : q_oth)) + (dh ? q_oth : q_own);
    }
  };
  stage(chunks - 1, (chunks - 1) & 1);
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * CP, lc = min(CP, S - t0);
    const BwdStage<T> st = stage_at(c & 1);
    if constexpr (ASYNC) cp_async_wait_all();
    __syncthreads();
    prep(st, lc, true);
    __syncthreads();
    if (c > 0) stage(c - 1, (c - 1) & 1);
    // This chunk's parked terms, consumed by its finish (loaded after the
    // prep, whose shared-memory loads they would otherwise delay).
#pragma unroll
    for (int s = 0; s < CP / 2; ++s) {
      const int j = CP / 2 * dh + s;
      parked[s] = j < lc ? dlogw[row(t0) + j * HN + dn] : 0.f;
    }
    for (int tile = warp; tile < 4; tile += W) {
      if (tile < 2)
        b_tile(st, tile);
      else
        a_tile(tile - 2);
    }
    // G_e's rows to shared memory, for dv's sum over the keys.
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      *reinterpret_cast<float2*>(sG + (n0 + g) * FP + 8 * q + 2 * t4) =
          make_float2(gacc[q][0], gacc[q][1]);
      *reinterpret_cast<float2*>(sG + (n0 + g + 8) * FP + 8 * q + 2 * t4) =
          make_float2(gacc[q][2], gacc[q][3]);
    }
    // dk's inter part: (v G_e^T)^T[n][j].
    float kg[2][4] = {}, kgl[2][4] = {};
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const Split<4> sa = state_a(gacc[q]);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const T* pv = st.v + (8 * jt + g) * TP + 8 * q + 2 * t4;
        const float bb[2] = {to_f(pv[0]), to_f(pv[1])};
        sum_mma<false, kExactV, kFour>(kg[jt], kgl[jt], sa,
                                       split_as<kExactV, kFour>(bb));
      }
    }
    // G decays by e^tot and gains (r e^ce)^T dy, r e^ce = rn e^mid, as the
    // state does (the products above and dv's below read G_e).
    {
      const float f_lo = sEm[n0 + g], f_hi = sEm[n0 + g + 8];
      Split<4> sa[CP / 8];
#pragma unroll
      for (int ks = 0; ks < CP / 8; ++ks) {
        const float* pr = sRn + (8 * ks + t4) * FP + n0 + g;
        const float a[4] = {pr[0] * f_lo, pr[8] * f_hi, pr[4 * FP] * f_lo,
                            pr[4 * FP + 8] * f_hi};
        sa[ks] = sp(a);
      }
      const float e_lo = sEt[n0 + g], e_hi = sEt[n0 + g + 8];
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        float up[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < CP / 8; ++ks) {
          const int o = (8 * ks + t4) * FP + 8 * q + g;
          sum_mma<false, false, kFour>(up, up, sa[ks],
                                       dy_frag(st, o, o + 4 * FP));
        }
        decay_add(gacc[q], e_lo, e_hi, up);
      }
    }
    __syncthreads();    // B, A, G_e

    // dk's intra part: (B^T rn)^T[n][j] = sum_{i > j} rn^T[n][i] B[i][j].
    float kb[2][4] = {};    // (one accumulator: a short chain)
#pragma unroll
    for (int kk = 0; kk < CP; kk += 8) {
      const float* pr = sRn + (kk + t4) * FP + n0 + g;
      const float a[4] = {pr[0], pr[8], pr[4 * FP], pr[4 * FP + 8]};
      const Split<4> sa = sp(a);
#pragma unroll
      for (int jt = 0; jt <= kk / 8; ++jt) {
        const float* pb = sB + (kk + t4) * BP + 8 * jt + g;
        const float bb[2] = {pb[0], pb[4 * BP]};
        sum_mma<false, false, kFour>(kb[jt], kb[jt], sa, sp(bb));
      }
    }
    // dv^s for the warp's 16 value columns m0 + (0..15) and every
    // position j: (k e^(tot - cum)) G_e over every key, then A^T dy.
    const int m0 = 16 * warp;
    float va[2][4] = {};    // (one accumulator each)
#pragma unroll
    for (int kk = 0; kk < N; kk += 8) {
      const float e0 = sEtm[kk + t4], e1 = sEtm[kk + t4 + 4];
      const float* pk = sKn + g * FP + kk + t4;
      const float a[4] = {pk[0] * e0, pk[8 * FP] * e0, pk[4] * e1,
                          pk[8 * FP + 4] * e1};
      const Split<4> sa = sp(a);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* pg = sG + (kk + t4) * FP + m0 + 8 * mt + g;
        const float bb[2] = {pg[0], pg[4 * FP]};
        bmma<false, false, kFour>(va[mt], va[mt], sa, sp(bb));
      }
    }
#pragma unroll
    for (int kk = 0; kk < CP; kk += 8) {
      const float* pa = sA + (kk + t4) * BP + g;
      const float a[4] = {pa[0], pa[8], pa[4 * BP], pa[4 * BP + 8]};
      const Split<4> sa = sp(a);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (kk + t4) * FP + m0 + 8 * mt + g;
        bmma<false, false, kFour>(va[mt], va[mt], sa,
                                  dy_frag(st, o, o + 4 * FP));
      }
    }
    // dv = dv^s + ruk dy, stored from the accumulators (pairs of values).
    const float ruk_rows[2] = {dot_of(sRuk, g), dot_of(sRuk, g + 8)};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int j = g + 8 * hi, m = m0 + 8 * mt + 2 * t4;
        if (j >= lc) continue;
        const float ruk = ruk_rows[hi];
        const float2 d = *reinterpret_cast<const float2*>(st.dy + j * FP + m);
        store2_as(dv + row(t0) + j * HN + m,
                  va[mt][2 * hi] + ruk * d.x, va[mt][2 * hi + 1] + ruk * d.y);
      }
    }
    // dk = dk^s + u r vdy to a staged tile; k dk^s for dlogw (the factors
    // as the forward sweep's).
    {
      const float m_lo = sMid[n0 + g], m_hi = sMid[n0 + g + 8];
      const float f_lo = sEtm[n0 + g], f_hi = sEtm[n0 + g + 8];
      float vdy[2][2];
      lane_dots(sVdy, vdy);
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool hi = q >> 1;
          const int n = n0 + g + 8 * hi, j = 8 * jt + 2 * t4 + (q & 1);
          const float dks =
              ex2((hi ? m_hi : m_lo) - st.cum[(j + 1) * FP + n]) *
              ((hi ? f_hi : f_lo) * (kg[jt][q] + kgl[jt][q]) +
               kb[jt][q]);
          const float rr = to_f(st.r[j * TP + n]);
          const float kk = to_f(st.k[j * TP + n]);
          sO1[j * FP + n] = dks + (hi ? u_hi : u_lo) * rr * vdy[jt][q & 1];
          sO2[j * FP + n] = kk * dks;
        }
      }
    }
    __syncthreads();
    finish(t0, lc);
  }
}

template <typename T, int N, bool ASYNC>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* state0,
                       const float* dy, void* dr, void* dk, void* dv,
                       float* dlogw, float* du, float* part,
                       unsigned int* tickets, int B, int S, int H,
                       long long sb, long long ss, long long sh,
                       cudaStream_t stream) {
  using G = BwdGeo<T, N>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, N, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (configured != cudaSuccess) return configured;
  wkv6_bwd_kernel<T, N, ASYNC><<<B * H, G::kThreads, G::kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state0, dy, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dlogw, du, part, tickets, B,
      S, H, sb, ss, sh);
  return cudaGetLastError();
}

// CTAs of wkv6_bwd_kernel<T, N, ASYNC> one SM holds at once.
template <typename T, int N, bool ASYNC>
cudaError_t occupancy_bwd(int* ctas) {
  using G = BwdGeo<T, N>;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<T, N, ASYNC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, wkv6_bwd_kernel<T, N, ASYNC>, G::kThreads, G::kSmemBytes);
}

template <typename T>
cudaError_t occupancy_bwd_n(int N, bool async, int* ctas) {
  switch (N) {
    case 16:
      return async ? occupancy_bwd<T, 16, true>(ctas)
                   : occupancy_bwd<T, 16, false>(ctas);
    case 32:
      return async ? occupancy_bwd<T, 32, true>(ctas)
                   : occupancy_bwd<T, 32, false>(ctas);
    case 64:
      return async ? occupancy_bwd<T, 64, true>(ctas)
                   : occupancy_bwd<T, 64, false>(ctas);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd(const void* r, const void* k, const void* v,
                         const float* logw, const float* u,
                         const float* state0, const float* dy, void* dr,
                         void* dk, void* dv, float* dlogw, float* du,
                         float* part, unsigned int* tickets, int B, int S,
                         int H, int N, long long sb, long long ss,
                         long long sh, bool async, cudaStream_t stream) {
  if (async) {
    // 16-byte copies need 16-byte aligned rows of r, k, v, logw and dy.
    constexpr long long ev = 16 / sizeof(T);
    const uintptr_t bases = reinterpret_cast<uintptr_t>(r) |
                            reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) |
                            reinterpret_cast<uintptr_t>(logw) |
                            reinterpret_cast<uintptr_t>(dy);
    if (bases % 16 != 0 || sb % ev != 0 || ss % ev != 0 || sh % ev != 0)
      return cudaErrorInvalidValue;
  }
#define REPRO_WKV6_BWD(NN)                                                   \
  case NN:                                                                   \
    return async ? launch_bwd<T, NN, true>(r, k, v, logw, u, state0, dy, dr, \
                                           dk, dv, dlogw, du, part, tickets, \
                                           B, S, H, sb, ss, sh, stream)      \
                 : launch_bwd<T, NN, false>(r, k, v, logw, u, state0, dy,    \
                                            dr, dk, dv, dlogw, du, part,     \
                                            tickets, B, S, H, sb, ss, sh,    \
                                            stream);
  switch (N) {
    REPRO_WKV6_BWD(16)
    REPRO_WKV6_BWD(32)
    REPRO_WKV6_BWD(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_WKV6_BWD
}

}  // namespace

// async: stage the chunk kernel's inputs with 16-byte cp.async copies (they
// must be 16-byte aligned), else with plain loads.  The step kernel (C 1)
// ignores it.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, void* state,
                           void* y, int dtype, int B, int S, int H, int N,
                           int C, long long sb, long long ss, long long sh,
                           int async, void* stream) {
  if (C < 1 || C > kMaxChunk || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  float* yf = static_cast<float*>(y);
  if (dtype == repro::kFloat32)
    return static_cast<int>(dispatch_n<float>(r, k, v, lw, uf, sf, yf, B, S,
                                              H, N, C, sb, ss, sh,
                                              async != 0, st));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_n<__nv_bfloat16>(
        r, k, v, lw, uf, sf, yf, B, S, H, N, C, sb, ss, sh, async != 0, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of `wkv6_launch`'s chunked or step form (the same function):
// r, k, v and logw as there (one set of strides), u [H, N] and the initial
// state state0 [B, H, N, N] fp32, dy fp32 [B, S, H, N] contiguous.  Writes
// dr, dk, dv ([B, S, H, N] contiguous, r's type), dlogw (fp32, the same
// shape) and du (fp32 [H, N]); `part` holds B x H x N fp32 partials and
// `tickets` H zeroed counters (zero again after the launch).  async: stage
// the inputs with 16-byte cp.async copies (r, k, v, logw and dy must be
// 16-byte aligned), else with plain loads.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* state0, const void* dy, void* dr,
                               void* dk, void* dv, void* dlogw, void* du,
                               void* part, void* tickets, int dtype, int B,
                               int S, int H, int N, long long sb,
                               long long ss, long long sh, int async,
                               void* stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lw = static_cast<const float*>(logw);
  const auto* uf = static_cast<const float*>(u);
  const auto* s0 = static_cast<const float*>(state0);
  const auto* dyf = static_cast<const float*>(dy);
  auto* dlw = static_cast<float*>(dlogw);
  auto* duf = static_cast<float*>(du);
  auto* pf = static_cast<float*>(part);
  auto* tk = static_cast<unsigned int*>(tickets);
  if (dtype == repro::kFloat32)
    return static_cast<int>(dispatch_bwd<float>(
        r, k, v, lw, uf, s0, dyf, dr, dk, dv, dlw, duf, pf, tk, B, S, H, N,
        sb, ss, sh, async != 0, st));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_bwd<__nv_bfloat16>(
        r, k, v, lw, uf, s0, dyf, dr, dk, dv, dlw, duf, pf, tk, B, S, H, N,
        sb, ss, sh, async != 0, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of the backward kernel `wkv6_bwd_launch` launches for `dtype`, N
// and `async` that one SM of the current device holds at once, into
// *ctas (its registers, shared memory and launch bound).
extern "C" int wkv6_bwd_occupancy(int dtype, int N, int async, void* ctas) {
  int* out = static_cast<int*>(ctas);
  if (dtype == repro::kFloat32)
    return static_cast<int>(occupancy_bwd_n<float>(N, async != 0, out));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(
        occupancy_bwd_n<__nv_bfloat16>(N, async != 0, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
