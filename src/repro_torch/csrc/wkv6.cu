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
// own: the Pallas kernel has no backward) is described at its kernel
// below.
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
// A CTA owns one (b, h), a thread a row n of the state (the RWKV-6
// authors' layout for their CUDA backward, re-derived here; at N 16 two
// lanes a row, so that a CTA is a whole warp), and walks the sequence
// twice:
//  A. forward: thread n holds S[n][:] and computes dr_t[n] (and parks
//     r_t dr^s_t in dlogw's place); du's per-(b, h) part in fp64;
//  B. backward: thread n holds G[n][:] (for dk and the row sums) and
//     G[:][n] (the column n, for dv), both updated each step; dk, dv and
//     dlogw are stored.
// Every thread of a warp reads the same words of the step's vectors (v and
// dy, or k, w and r), so each 16-byte shared load is one broadcast: the
// state's N^2 values a step cost N / 4 loads a vector a thread.  Steps
// are staged kBwdSteps at a time into one of two shared buffers (fp32,
// w = exp(logw), then vdy and ruk by warp sums) from registers that
// loaded them while the previous kBwdSteps computed; outputs go to device
// memory as they are made (a row of N a step, coalesced).  du, a sum over
// B and S, is taken in the same launch without atomic sums: each CTA
// writes its (b, h) part, and the last of a head's B CTAs to finish (a
// ticket, `last_to_arrive`) adds the parts in b order, in fp64.  The same
// inputs give the same bits.
//
// Bound on the H100: at rwkv6-3b's training shape (B 8, S 512, 40 x 64)
// the bytes are ~257 MB (r, k, v and dr, dk, dv in bf16; logw, dy and
// dlogw in fp32; the initial state), 0.077 ms at 3.35 TB/s.  The same
// gradients in chunked form run their products on tensor cores in 3xTF32,
// ~0.041 ms at the TF32 peak, so the bytes bound it.  This kernel's 12 N^2
// fp32 operations a step and head (dr, the state's update, dk, dv and G's
// two updates) alone take 0.120 ms at fp32's peak, and the two serial
// walks of 512 steps on 320 CTAs of 64 threads set the pace (PERF.md).

constexpr int kBwdSteps = 8;    // steps a shared buffer holds

template <int N>
struct BwdGeo {
  static constexpr int T = N < 32 ? 32 : N;   // threads a CTA
  static constexpr int P = T / N;             // lanes a row
  static constexpr int M = N / P;             // state columns a lane
  static constexpr int Q = kBwdSteps / P;     // steps a thread stages
  static_assert(M % 4 == 0 && kBwdSteps % P == 0, "16-byte slices");
};

// The sum of x over the P consecutive lanes of a row, the same bits on
// each (a butterfly: every lane adds the same pairs).
template <int P>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(repro::kFullMask, x, off);
  return x;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The staged arrays of a step, by index.
enum { kR, kK, kV, kW, kDy, kParked, kArrays };

template <typename T, int N>
__global__ void __launch_bounds__(BwdGeo<N>::T)
    wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u,
                    const float* __restrict__ state0,
                    const float* __restrict__ dy, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv, float* dlogw,
                    float* __restrict__ du, float* __restrict__ part,
                    unsigned int* __restrict__ tickets, int B, int S, int H,
                    long long sb, long long ss, long long sh) {
  using G = BwdGeo<N>;
  constexpr int P = G::P, M = G::M, Q = G::Q, L = kBwdSteps;
  constexpr int kWarps = G::T / 32;
  __shared__ __align__(16) float sbuf[2][kArrays][L][N];
  __shared__ float sVdy[2][L], sRuk[2][L], sU[N];
  __shared__ bool last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = tid / P, c0 = (tid % P) * M;
  const bool lead = tid % P == 0;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  // Row (b, t, h, :) of the contiguous tensors (dy and the outputs).
  auto row = [&](int t) {
    return ((static_cast<long long>(b) * S + t) * H + h) * N;
  };
  if (tid < N) sU[tid] = u[h * N + tid];
  const float un = u[h * N + n];

  // Staging: thread tid loads column tid % N of steps tid / N + P q.
  const int sc = tid % N, si = tid / N;
  T raw[3][Q];
  float fp[3][Q];     // logw, dy, the parked terms
  auto fetch = [&](int t0, int lc, bool parked) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = si + P * q;
      if (i >= lc) continue;
      const long long off = base + (t0 + i) * ss + sc;
      raw[0][q] = r[off];
      raw[1][q] = k[off];
      raw[2][q] = v[off];
      fp[0][q] = logw[off];
      fp[1][q] = dy[row(t0 + i) + sc];
      if (parked) fp[2][q] = dlogw[row(t0 + i) + sc];
    }
  };
  // The fetched steps into buffer `buf`, then (behind a barrier) their
  // vdy and ruk.  Ends behind a barrier.
  auto put = [&](int buf, int lc, bool parked) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = si + P * q;
      if (i >= lc) continue;
      sbuf[buf][kR][i][sc] = repro::to_f(raw[0][q]);
      sbuf[buf][kK][i][sc] = repro::to_f(raw[1][q]);
      sbuf[buf][kV][i][sc] = repro::to_f(raw[2][q]);
      sbuf[buf][kW][i][sc] = expf(fp[0][q]);
      sbuf[buf][kDy][i][sc] = fp[1][q];
      if (parked) sbuf[buf][kParked][i][sc] = fp[2][q];
    }
    __syncthreads();
    for (int i = warp; i < lc; i += kWarps) {
      float x = 0.f, z = 0.f;
      for (int c = lane; c < N; c += 32) {
        x += sbuf[buf][kV][i][c] * sbuf[buf][kDy][i][c];
        z += sbuf[buf][kR][i][c] * (sU[c] * sbuf[buf][kK][i][c]);
      }
      x = repro::warp_sum(x);
      z = repro::warp_sum(z);
      if (lane == 0) sVdy[buf][i] = x, sRuk[buf][i] = z;
    }
    __syncthreads();
  };
  const int chunks = (S + L - 1) / L;

  // A. Forward: the state's row n, columns [c0, c0 + M).
  float st[M];
  const float* s0 = state0 + static_cast<long long>(bh) * N * N + n * N + c0;
#pragma unroll
  for (int j = 0; j < M; ++j) st[j] = s0[j];
  double du_part = 0.0;
  fetch(0, min(L, S), false);
  put(0, min(L, S), false);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * L, lc = min(L, S - t0), buf = c & 1;
    if (c + 1 < chunks) fetch(t0 + L, min(L, S - t0 - L), false);
    for (int i = 0; i < lc; ++i) {
      const float* dyv = sbuf[buf][kDy][i] + c0;
      const float* vv = sbuf[buf][kV][i] + c0;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < M; j += 4) {
        const float4 d = lds4(dyv + j);
        a0 += st[j] * d.x, a1 += st[j + 1] * d.y;
        a2 += st[j + 2] * d.z, a3 += st[j + 3] * d.w;
      }
      const float drs = row_sum<P>((a0 + a1) + (a2 + a3));
      const float rr = sbuf[buf][kR][i][n], kk = sbuf[buf][kK][i][n];
      const float ww = sbuf[buf][kW][i][n], vdy = sVdy[buf][i];
      if (lead) {
        const long long o = row(t0 + i) + n;
        dr[o] = repro::from_f<T>(drs + un * kk * vdy);
        dlogw[o] = rr * drs;
      }
      du_part += static_cast<double>(rr * kk * vdy);
#pragma unroll
      for (int j = 0; j < M; j += 4) {
        const float4 x = lds4(vv + j);
        st[j] = ww * st[j] + kk * x.x;
        st[j + 1] = ww * st[j + 1] + kk * x.y;
        st[j + 2] = ww * st[j + 2] + kk * x.z;
        st[j + 3] = ww * st[j + 3] + kk * x.w;
      }
    }
    if (c + 1 < chunks) put(buf ^ 1, min(L, S - t0 - L), false);
  }

  // du: this (b, h)'s part, then the head's last CTA adds the B parts.
  if (lead) part[static_cast<long long>(bh) * N + n] =
      static_cast<float>(du_part);
  if (repro::last_to_arrive(tickets + h, B, &last) && tid < N) {
    double sum = 0.0;
    for (int bb = 0; bb < B; ++bb)
      sum += part[(static_cast<long long>(bb) * H + h) * N + tid];
    du[h * N + tid] = static_cast<float>(sum);
  }

  // B. Backward: G's row n and column n, columns / rows [c0, c0 + M).
  // (last_to_arrive ended behind a barrier: the parked terms are visible.)
  float gr[M], gc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) gr[j] = gc[j] = 0.f;
  double suf_r = 0.0, suf_k = 0.0;
  {
    const int t0 = (chunks - 1) * L;
    fetch(t0, S - t0, true);
    put((chunks - 1) & 1, S - t0, true);
  }
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * L, lc = min(L, S - t0), buf = c & 1;
    if (c > 0) fetch(t0 - L, L, true);
    for (int i = lc - 1; i >= 0; --i) {
      const float* vv = sbuf[buf][kV][i] + c0;
      const float* kv = sbuf[buf][kK][i] + c0;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
#pragma unroll
      for (int j = 0; j < M; j += 4) {
        const float4 x = lds4(vv + j), z = lds4(kv + j);
        a0 += gr[j] * x.x, a1 += gr[j + 1] * x.y;
        a2 += gr[j + 2] * x.z, a3 += gr[j + 3] * x.w;
        b0 += gc[j] * z.x, b1 += gc[j + 1] * z.y;
        b2 += gc[j + 2] * z.z, b3 += gc[j + 3] * z.w;
      }
      const float dks = row_sum<P>((a0 + a1) + (a2 + a3));
      const float dvs = row_sum<P>((b0 + b1) + (b2 + b3));
      const float rr = sbuf[buf][kR][i][n], kk = sbuf[buf][kK][i][n];
      const float ww = sbuf[buf][kW][i][n], dyn = sbuf[buf][kDy][i][n];
      suf_k += static_cast<double>(kk * dks);
      const double dlw = suf_r - suf_k;
      suf_r += static_cast<double>(sbuf[buf][kParked][i][n]);
      if (lead) {
        const long long o = row(t0 + i) + n;
        dk[o] = repro::from_f<T>(dks + un * rr * sVdy[buf][i]);
        dv[o] = repro::from_f<T>(dvs + sRuk[buf][i] * dyn);
        dlogw[o] = static_cast<float>(dlw);
      }
      const float* dyv = sbuf[buf][kDy][i] + c0;
      const float* wv = sbuf[buf][kW][i] + c0;
      const float* rv = sbuf[buf][kR][i] + c0;
#pragma unroll
      for (int j = 0; j < M; j += 4) {
        const float4 d = lds4(dyv + j), w4 = lds4(wv + j),
                     r4 = lds4(rv + j);
        gr[j] = ww * gr[j] + rr * d.x;
        gr[j + 1] = ww * gr[j + 1] + rr * d.y;
        gr[j + 2] = ww * gr[j + 2] + rr * d.z;
        gr[j + 3] = ww * gr[j + 3] + rr * d.w;
        gc[j] = w4.x * gc[j] + r4.x * dyn;
        gc[j + 1] = w4.y * gc[j + 1] + r4.y * dyn;
        gc[j + 2] = w4.z * gc[j + 2] + r4.z * dyn;
        gc[j + 3] = w4.w * gc[j + 3] + r4.w * dyn;
      }
    }
    if (c > 0) put(buf ^ 1, L, true);
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, const float* state0,
                       const float* dy, void* dr, void* dk, void* dv,
                       float* dlogw, float* du, float* part,
                       unsigned int* tickets, int B, int S, int H,
                       long long sb, long long ss, long long sh,
                       cudaStream_t stream) {
  wkv6_bwd_kernel<T, N><<<B * H, BwdGeo<N>::T, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state0, dy, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), dlogw, du, part, tickets, B,
      S, H, sb, ss, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* r, const void* k, const void* v,
                         const float* logw, const float* u,
                         const float* state0, const float* dy, void* dr,
                         void* dk, void* dv, float* dlogw, float* du,
                         float* part, unsigned int* tickets, int B, int S,
                         int H, int N, long long sb, long long ss,
                         long long sh, cudaStream_t stream) {
#define REPRO_WKV6_BWD(NN)                                                   \
  case NN:                                                                   \
    return launch_bwd<T, NN>(r, k, v, logw, u, state0, dy, dr, dk, dv,       \
                             dlogw, du, part, tickets, B, S, H, sb, ss, sh,  \
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
// `tickets` H zeroed counters (zero again after the launch).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* logw, const void* u,
                               const void* state0, const void* dy, void* dr,
                               void* dk, void* dv, void* dlogw, void* du,
                               void* part, void* tickets, int dtype, int B,
                               int S, int H, int N, long long sb,
                               long long ss, long long sh, void* stream) {
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
        sb, ss, sh, st));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_bwd<__nv_bfloat16>(
        r, k, v, lw, uf, s0, dyf, dr, dk, dv, dlw, duf, pf, tk, B, S, H, N,
        sb, ss, sh, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
