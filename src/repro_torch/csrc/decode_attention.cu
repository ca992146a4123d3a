// Decode attention for Hopper (sm_90a): one new query token per sequence
// against the KV cache, GQA, per-row valid window [kv_start, kv_len).
//
// Replaces the Pallas TPU kernel `_decode_kernel` /
// `decode_attention_fwd` (src/repro/kernels/decode_attention/
// decode_attention.py).  The TPU kernel walks the cache as a sequential
// grid axis with (m, l, acc) carried in VMEM; here the KV axis is split
// across CTAs instead (split-KV, "flash decoding"):
//
//  * `decode_attention_split`: grid (B * KVH, n_splits, head groups), 4
//    warps.  A CTA owns one (batch, KV head), up to 8 of its G query heads
//    and the keys [split range) ∩ [kv_start, kv_len).  K and V rows are
//    copied with 16-byte `cp.async.cg` into a ring of 2-3 stages of 64 keys,
//    so the next chunks are in flight while the current one is scored.  A
//    key row is split over the lanes of a lane group (D * sizeof(T) / 16
//    lanes, one 16-byte vector each); every lane reads back only the vectors
//    it copied itself, so the loop needs no barrier, only
//    `cp.async.wait_group`.  Each lane group scores its key against all the
//    CTA's heads (each lane keeps its columns of q in registers, pre-scaled
//    by scale * log2 e), sums the dot product over the group with shuffles,
//    and keeps a thread-local online softmax (m, l, acc over its vector's
//    columns).  The lane groups and warps are merged at the end in a fixed
//    order.  With one split the CTA writes o directly; otherwise it writes
//    its partial (m, l, acc) in fp32 to a scratch buffer.  A split with no
//    valid key writes m = -1e30, l = 0, acc = 0.
//  * `decode_attention_combine`: one CTA per (batch, query head) merges the
//    partials in split order (so results do not vary from run to run) and
//    writes o in q's dtype; a row whose total l is 0 gets 0.
//
// n_splits is chosen on the host from (B, KVH, S) alone
// (kernels/decode_attention/ops.py), never from the window bounds, which
// live on the device: the launch reads nothing back, so it can be captured
// in a CUDA graph.
//
// Bound on the H100: bytes.  Each valid K/V row is read once per KV head
// (about 4 operations a byte at G = 4), so CUDA cores suffice; the design
// keeps enough 16-byte copies in flight on enough CTAs to stream the cache
// at the memory rate.  The cache is read in place through its strides
// (batch, slot and head strides must be multiples of 16 bytes).
#include "common.cuh"

namespace {

using repro::from_f;
using repro::kFullMask;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;                      // keys a stage
constexpr int kKeysPerWarp = kChunk / kWarps;   // 16
constexpr int kMaxHeads = 8;                    // query heads a CTA
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct SplitParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;               // [B, H, D] in q's dtype, written when n_splits == 1
  float* part;           // [B, H, n_splits, D + 2]: m, l, acc[D]
  const int* kv_len;     // [B] exclusive end of the window
  const int* kv_start;   // [B] inclusive start, or nullptr (= 0)
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int H, KVH, S, split_len, n_splits;
  float scale_log2;      // softmax scale * log2(e)
};

// Geometry of one instance: T storage, D head dim.
template <typename T, int D>
struct Geo {
  static constexpr int kEpv = 16 / static_cast<int>(sizeof(T));  // per vector
  static constexpr int kVpk = D / kEpv;          // vectors a key row
  // Lanes a key: the power of two >= kVpk (lanes past kVpk idle; D 96).
  static constexpr int kLpk = kVpk <= 4 ? 4 : kVpk <= 8 ? 8 : kVpk <= 16 ? 16
                                                                         : 32;
  static constexpr int kKpw = 32 / kLpk;         // keys a warp step
  static constexpr int kSteps = kKeysPerWarp / kKpw;
  // Keys scored before one online-softmax update.
  static constexpr int kSub = kSteps < 4 ? kSteps : 4;
  static constexpr int kHalfStage = kChunk * kLpk * 16;  // K (or V) bytes
  static constexpr int kStages = 2 * kHalfStage <= 32768 ? 3 : 2;
  static_assert(kVpk * kEpv == D && kVpk <= 32, "head dim");
  static_assert(kSteps % kSub == 0, "steps");
};

template <typename T, int D, int GB>
constexpr size_t split_smem_bytes() {
  using G = Geo<T, D>;
  return static_cast<size_t>(G::kStages) * 2 * G::kHalfStage +
         sizeof(float) * (GB * D + kWarps * GB * (D + 2));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The kEpv floats of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* f) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_attention_split(const SplitParams p) {
  using Gm = Geo<T, D>;
  constexpr int kEpv = Gm::kEpv, kLpk = Gm::kLpk, kKpw = Gm::kKpw;
  constexpr int kStages = Gm::kStages, kSub = Gm::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [stage][K|V][key][kLpk]
  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * Gm::kHalfStage);
  float* red = qs + GB * D;                       // [warp][GB][D + 2]

  const int b = blockIdx.x / p.KVH;
  const int kvh = blockIdx.x % p.KVH;
  const int split = blockIdx.y;
  const int G = p.H / p.KVH;
  const int g0 = blockIdx.z * GB;                 // first head of the CTA
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane % kLpk;                   // vector of the key row
  const int kgrp = lane / kLpk;                   // key of the warp step
  const bool has_vec = slot < Gm::kVpk;

  const int start = p.kv_start != nullptr ? max(p.kv_start[b], 0) : 0;
  const int lo = max(start, split * p.split_len);
  const int hi = min(min(p.kv_len[b], p.S), (split + 1) * p.split_len);
  const int nchunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;

  const T* qg = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[i] = g0 + g < G ? repro::to_f(qg[b * p.q_sb + (kvh * G + g0 + g) *
                                                        p.q_sh + d]) *
                             p.scale_log2
                       : 0.f;
  }

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh +
                   slot * kEpv;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh +
                   slot * kEpv;
  // This lane's vector slot of key row `kr` in stage `st` (K; V follows).
  auto kslot = [&](int st, int kr) {
    return ring + (st * 2 * kChunk + kr) * kLpk + slot;
  };
  auto load_chunk = [&](int c, int st) {
    if (!has_vec) return;
    const int c0 = lo + c * kChunk;
#pragma unroll
    for (int j = 0; j < Gm::kSteps; ++j) {
      const int kr = warp * kKeysPerWarp + j * kKpw + kgrp;
      const int key = c0 + kr;
      const bool ok = key < hi;
      const long long kk = ok ? key : 0;
      uint4* ks = kslot(st, kr);
      cp_async16(ks, kbase + kk * p.k_ss, ok ? 16 : 0);
      cp_async16(ks + kChunk * kLpk, vbase + kk * p.v_ss, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nchunks) load_chunk(c, c);
    cp_async_commit();
  }
  __syncthreads();  // q staged
  float qv[GB][kEpv];  // this lane's columns of every head's q
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < kEpv; ++e)
      qv[g][e] = qs[g * D + (has_vec ? slot * kEpv : 0) + e];

  float m[GB], l[GB], acc[GB][kEpv];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEpv; ++e) acc[g][e] = 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    if (c + kStages - 1 < nchunks)
      load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of chunk c landed
    const int st = c % kStages;
    const int c0 = lo + c * kChunk;
#pragma unroll
    for (int j0 = 0; j0 < Gm::kSteps; j0 += kSub) {
      float s[GB][kSub];
      bool valid[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int kr = warp * kKeysPerWarp + (j0 + u) * kKpw + kgrp;
        valid[u] = c0 + kr < hi;
        float kf[kEpv];
        if (has_vec) {
          unpack<T>(*kslot(st, kr), kf);
        } else {
#pragma unroll
          for (int e = 0; e < kEpv; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kEpv; ++e) dot = fmaf(qv[g][e], kf[e], dot);
#pragma unroll
          for (int off = 1; off < kLpk; off <<= 1)
            dot += __shfl_xor_sync(kFullMask, dot, off);
          s[g][u] = valid[u] ? dot : kNeg;
        }
      }
      // Scores become weights in place.
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mc = s[g][0];
#pragma unroll
        for (int u = 1; u < kSub; ++u) mc = fmaxf(mc, s[g][u]);
        const float m_new = fmaxf(m[g], mc);
        const float corr = exp2f(m[g] - m_new);
        m[g] = m_new;
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < kEpv; ++e) acc[g][e] *= corr;
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          s[g][u] = valid[u] ? exp2f(s[g][u] - m_new) : 0.f;
          l[g] += s[g][u];
        }
      }
      if (has_vec) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int kr = warp * kKeysPerWarp + (j0 + u) * kKpw + kgrp;
          float vf[kEpv];
          unpack<T>(*(kslot(st, kr) + kChunk * kLpk), vf);
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int e = 0; e < kEpv; ++e)
              acc[g][e] = fmaf(s[g][u], vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Merge the warp's lane groups (same slot, other keys), then the warps.
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float mw = m[g];
#pragma unroll
    for (int off = kLpk; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(kFullMask, mw, off));
    const float f = exp2f(m[g] - mw);
    float lw = l[g] * f;
#pragma unroll
    for (int off = kLpk; off < 32; off <<= 1)
      lw += __shfl_xor_sync(kFullMask, lw, off);
#pragma unroll
    for (int e = 0; e < kEpv; ++e) {
      float a = acc[g][e] * f;
#pragma unroll
      for (int off = kLpk; off < 32; off <<= 1)
        a += __shfl_xor_sync(kFullMask, a, off);
      acc[g][e] = a;
    }
    float* rw = red + (warp * GB + g) * (D + 2);
    if (lane == 0) {
      rw[0] = mw;
      rw[1] = lw;
    }
    if (kgrp == 0 && has_vec) {
#pragma unroll
      for (int e = 0; e < kEpv; ++e) rw[2 + slot * kEpv + e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < GB * D; i += kThreads) {
    const int g = i / D, d = i % D;
    if (g0 + g >= G) continue;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, red[(w * GB + g) * (D + 2)]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = red + (w * GB + g) * (D + 2);
      const float f = exp2f(rw[0] - mx);
      lt += f * rw[1];
      at += f * rw[2 + d];
    }
    const long long row = static_cast<long long>(b) * p.H + kvh * G + g0 + g;
    if (p.n_splits == 1) {
      static_cast<T*>(p.o)[row * D + d] = from_f<T>(lt > 0.f ? at / lt : 0.f);
    } else {
      float* pr = p.part + (row * p.n_splits + split) * (D + 2);
      if (d == 0) {
        pr[0] = mx;
        pr[1] = lt;
      }
      pr[2 + d] = at;
    }
  }
}

template <typename T>
__global__ void decode_attention_combine(const float* __restrict__ part,
                                         T* __restrict__ o, int n_splits,
                                         int D) {
  const long long row = blockIdx.x;  // b * H + h
  const float* pr = part + row * n_splits * (D + 2);
  float mx = kNeg;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, pr[i * (D + 2)]);
  float lt = 0.f, at = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float f = exp2f(pr[i * (D + 2)] - mx);
    lt += f * pr[i * (D + 2) + 1];
    at += f * pr[i * (D + 2) + 2 + threadIdx.x];
  }
  o[row * D + threadIdx.x] = from_f<T>(lt > 0.f ? at / lt : 0.f);
}

template <typename T, int D, int GB>
cudaError_t launch_split(const SplitParams& p, int B, cudaStream_t s) {
  constexpr size_t smem = split_smem_bytes<T, D, GB>();
  auto kern = decode_attention_split<T, D, GB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int G = p.H / p.KVH;
  const dim3 grid(B * p.KVH, p.n_splits, (G + GB - 1) / GB);
  kern<<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;
  decode_attention_combine<T><<<B * p.H, D, 0, s>>>(
      p.part, static_cast<T*>(p.o), p.n_splits, D);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const SplitParams& p, int B, cudaStream_t s) {
  const int G = p.H / p.KVH;
  if (G <= 1) return launch_split<T, D, 1>(p, B, s);
  if (G <= 2) return launch_split<T, D, 2>(p, B, s);
  if (G <= 4) return launch_split<T, D, 4>(p, B, s);
  return launch_split<T, D, kMaxHeads>(p, B, s);
}

template <typename T>
cudaError_t launch_t(const SplitParams& p, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch_d<T, 32>(p, B, s);
    case 64: return launch_d<T, 64>(p, B, s);
    case 96: return launch_d<T, 96>(p, B, s);
    case 128: return launch_d<T, 128>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode-attention call: the split kernel, then (n_splits > 1) the
// combine kernel.  `part` is fp32 scratch of B * H * n_splits * (D + 2)
// floats (unused when n_splits == 1).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part,
    const int* kv_len, const int* kv_start, int dtype, int B, int H, int KVH,
    int D, int S, int n_splits, int split_len, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  if (B < 1 || KVH < 1 || H % KVH || n_splits < 1 || n_splits > 65535 ||
      split_len < 1 || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SplitParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.part = static_cast<float*>(part);
  p.kv_len = kv_len;
  p.kv_start = kv_start;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.split_len = split_len;
  p.n_splits = n_splits;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return static_cast<int>(launch_t<float>(p, B, D, s));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(launch_t<__nv_bfloat16>(p, B, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
