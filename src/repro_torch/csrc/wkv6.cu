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
// and starts from zero whatever state it is given.  Here one CTA owns one
// (b, h) for the whole sequence, walks the chunks itself with the state in
// shared memory, and starts from the given state.  Two variants, chosen by
// the chunk C:
//
//  * chunk (C > 1; prefill).  Per chunk, r, k, v and logw are staged in
//    shared memory, one thread per channel forms the fp32 prefix sums, and
//    the chunk is computed in the reference's blocked form
//    (models/rwkv6.wkv6_chunked), mid-chunk renormalisation included:
//      inter  y_i += (r_i e^cum_excl_i) . S
//      intra  y_i += sum_{j<i} <r_i e^(cum_excl_i - mid), k_j e^(mid - cum_j)> v_j
//      bonus  y_i += <r_i, u k_i> v_i
//      state  S = e^total S + sum_j (k_j e^(total - cum_j)) v_j^T
//    Thread (column m, row group g) computes the y rows i = g, g + G, ...
//    of column m, reusing each state element it reads across those rows,
//    and then owns state rows n = g, g + G, ... of column m for the update.
//    The [C, N] tiles have a row pitch of N + 1 so that reads down a
//    column do not collide on one shared-memory bank.
//  * step (C == 1; the decode step and the prompt's per-token tail).  The
//    state lives in registers: thread (m, g) holds S[n][m] for its N/G rows
//    n, reads each once from device memory and writes each once at the end,
//    whatever S is; the G partial sums of y_t[m] meet in shared memory and
//    are added in a fixed order.
//
// Bound on the H100: bytes.  At rwkv6-3b's decode step (B 28, H 40, N 64)
// reading and writing the 18.4 MB state is nearly all the traffic; the
// chunked prefill at S 64 moves ~100 MB (state, r/k/v, logw, y) against
// ~1.5 GFLOP of fp32 work.  No tensor cores, TMA or cp.async yet.
#include "common.cuh"

namespace {

using repro::to_f;

constexpr int kThreads = 256;
constexpr int kMaxChunk = 32;

__host__ __device__ constexpr int chunk_smem_floats(int n, int c) {
  // S [N][N]; five [C][N + 1] tiles; A [C][C + 1]; total, mid, u [N]; the
  // bonus dots [C].
  return n * n + 5 * c * (n + 1) + c * (c + 1) + 3 * n + c;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ logw,
                      const float* __restrict__ u, float* __restrict__ state,
                      float* __restrict__ y, int S, int H, int C,
                      long long sb, long long ss, long long sh) {
  constexpr int P = N + 1;
  constexpr int G = kThreads / N;
  constexpr int RY = (kMaxChunk + G - 1) / G;
  constexpr int RS = N / G;
  extern __shared__ float smem[];
  float* sS = smem;                  // state [N][N]
  float* sRd = sS + N * N;           // r, then r e^cum_excl
  float* sRn = sRd + C * P;          // cum_excl, then r e^(cum_excl - mid)
  float* sKn = sRn + C * P;          // k, then k e^(mid - cum)
  float* sKf = sKn + C * P;          // logw, then cum, then k e^(total - cum)
  float* sV = sKf + C * P;           // v
  float* sA = sV + C * P;            // [C][C + 1] intra-chunk weights
  float* sTot = sA + C * (C + 1);    // total = cum at the chunk's end
  float* sMid = sTot + N;            // cum at the chunk's middle
  float* sU = sMid + N;              // bonus u of this head
  float* sUb = sU + N;               // <r_i, u k_i>

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int m = tid % N, g = tid / N;
  const long long base = b * sb + h * sh;
  float* st = state + static_cast<long long>(bh) * N * N;
  const int mid_row = C > 1 ? C / 2 - 1 : 0;

  for (int e = tid; e < N * N; e += kThreads) sS[e] = st[e];
  if (tid < N) sU[tid] = u[h * N + tid];

  for (int t0 = 0; t0 < S; t0 += C) {
    // 1. Stage the chunk.
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const long long off = base + (t0 + i) * ss + n;
      sRd[i * P + n] = to_f(r[off]);
      sKn[i * P + n] = to_f(k[off]);
      sV[i * P + n] = to_f(v[off]);
      sKf[i * P + n] = logw[off];
    }
    __syncthreads();

    // 2. Prefix sums, one thread a channel; the bonus dots, one thread a
    //    row (N + C <= 96 threads).
    if (tid < N) {
      float acc = 0.f;
      for (int i = 0; i < C; ++i) {
        const float lw = sKf[i * P + tid];
        sRn[i * P + tid] = acc;
        acc += lw;
        sKf[i * P + tid] = acc;
        if (i == mid_row) sMid[tid] = acc;
      }
      sTot[tid] = acc;
    } else if (tid < N + C) {
      const int i = tid - N;
      float d = 0.f;
      for (int n = 0; n < N; ++n)
        d += sRd[i * P + n] * (sU[n] * sKn[i * P + n]);
      sUb[i] = d;
    }
    __syncthreads();

    // 3. Decay factors.
    for (int e = tid; e < C * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const float ce = sRn[i * P + n], cu = sKf[i * P + n];
      const float rr = sRd[i * P + n], kk = sKn[i * P + n];
      const float mid = sMid[n];
      sRd[i * P + n] = rr * expf(ce);
      sRn[i * P + n] = rr * expf(ce - mid);
      sKn[i * P + n] = kk * expf(mid - cu);
      sKf[i * P + n] = kk * expf(sTot[n] - cu);
    }
    __syncthreads();

    // 4. Intra-chunk weights, strictly lower triangle.
    for (int e = tid; e < C * C; e += kThreads) {
      const int i = e / C, j = e % C;
      float a = 0.f;
      if (j < i) {
#pragma unroll 8
        for (int n = 0; n < N; ++n) a += sRn[i * P + n] * sKn[j * P + n];
      }
      sA[i * (C + 1) + j] = a;
    }
    __syncthreads();

    // 5. y rows i = g + G q of column m.
    float acc[RY];
#pragma unroll
    for (int q = 0; q < RY; ++q) acc[q] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float s = sS[n * N + m];
#pragma unroll
      for (int q = 0; q < RY; ++q) {
        const int i = g + G * q;
        if (i < C) acc[q] += sRd[i * P + n] * s;
      }
    }
#pragma unroll
    for (int q = 0; q < RY; ++q) {
      const int i = g + G * q;
      if (i >= C) continue;
      float intra = 0.f;
      for (int j = 0; j < i; ++j) intra += sA[i * (C + 1) + j] * sV[j * P + m];
      const float out = acc[q] + intra + sUb[i] * sV[i * P + m];
      y[((static_cast<long long>(b) * S + t0 + i) * H + h) * N + m] = out;
    }
    __syncthreads();

    // 6. State rows n = g + G q of column m.
    float kv[RS];
#pragma unroll
    for (int q = 0; q < RS; ++q) kv[q] = 0.f;
    for (int j = 0; j < C; ++j) {
      const float vj = sV[j * P + m];
#pragma unroll
      for (int q = 0; q < RS; ++q) kv[q] += sKf[j * P + g + G * q] * vj;
    }
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      const int n = g + G * q;
      sS[n * N + m] = expf(sTot[n]) * sS[n * N + m] + kv[q];
    }
    __syncthreads();
  }

  for (int e = tid; e < N * N; e += kThreads) st[e] = sS[e];
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

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, float* state, float* y,
                   int B, int S, int H, int C, long long sb, long long ss,
                   long long sh, cudaStream_t stream) {
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  if (C == 1) {
    wkv6_step_kernel<T, N><<<B * H, kThreads, 0, stream>>>(
        rt, kt, vt, logw, u, state, y, S, H, sb, ss, sh);
    return cudaGetLastError();
  }
  static const cudaError_t configured = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      chunk_smem_floats(N, kMaxChunk) * static_cast<int>(sizeof(float)));
  if (configured != cudaSuccess) return configured;
  const size_t smem = chunk_smem_floats(N, C) * sizeof(float);
  wkv6_chunk_kernel<T, N><<<B * H, kThreads, smem, stream>>>(
      rt, kt, vt, logw, u, state, y, S, H, C, sb, ss, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* r, const void* k, const void* v,
                       const float* logw, const float* u, float* state,
                       float* y, int B, int S, int H, int N, int C,
                       long long sb, long long ss, long long sh,
                       cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, state, y, B, S, H, C, sb, ss,
                           sh, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, void* state,
                           void* y, int dtype, int B, int S, int H, int N,
                           int C, long long sb, long long ss, long long sh,
                           void* stream) {
  if (C < 1 || C > kMaxChunk || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lw = static_cast<const float*>(logw);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  float* yf = static_cast<float*>(y);
  if (dtype == repro::kFloat32)
    return static_cast<int>(dispatch_n<float>(r, k, v, lw, uf, sf, yf, B, S,
                                              H, N, C, sb, ss, sh, st));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_n<__nv_bfloat16>(
        r, k, v, lw, uf, sf, yf, B, S, H, N, C, sb, ss, sh, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
