// Blocked online-softmax attention on the CUDA cores: the fp32 route of the
// prefill kernel (flash_attention.cu; bf16 takes the wgmma kernel there).
// fp32 stays off the tensor cores, whose fp32 mode (TF32) would miss the
// 2e-5 tolerance the fp32 model checks hold the kernel to.
//
// One CTA owns one (batch, KV head) and a block of query rows; the G query
// heads of that KV head and all of the block's rows form the CTA's
// (row, head) "pairs".  K and V are read in place through their strides
// (the [B, S, KVH, D] cache layout, no transpose) in chunks of 32 keys that
// the whole CTA stages into shared memory once and every pair reuses, so GQA
// costs one pass over the keys regardless of G.  Inside a chunk each lane of
// a warp scores one key; the online-softmax statistics (m, l) are warp
// reductions and the p.V product is accumulated with each lane owning D/32
// output columns.  The KV loop inside the CTA takes the place of the Pallas
// kernels' sequential "arbitrary" grid axis.
//
// Masking: key j is valid for a query at position qpos iff
//   (j < prefix_len[b] or kv_start[b] <= j < Sk), and (causal) j <= qpos,
//   and (window) j > qpos - W.
// Row i of the prompt sits at qpos = i.  A prefix placed before left pads
// makes two segments of valid keys, [0, prefix_len) and [kv_start, Sk); the
// key loop walks each in turn, so the chunks of the pad gap between them are
// never read.  Without a prefix (prefix_len null or 0, or no gap) the loop
// is the one segment [kv_start, Sk).
// Scores are masked by select against a finite sentinel and the weights of
// masked keys are selected to 0, so a row with no valid key (a left-pad
// query row in prefill) ends with l = 0 and writes acc / max(l, 1e-30) = 0:
// finite, never NaN that would leak into the next layer's K/V.
#pragma once

#include "common.cuh"

namespace repro {

constexpr float kNegSentinel = -1e30f;
constexpr int kChunk = 32;  // keys per staged chunk: one per lane

struct AttnParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_start;    // [B] first valid key after the pads, or nullptr
  const int* prefix_len;  // [B] keys valid before the pads, or nullptr
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Sk, H, KVH;
  int rows_per_cta;
  int causal, window;
  float scale, softcap;
};

// DPL = D / 32 output columns per lane; NWARPS warps; PPW pairs per warp.
template <typename T, int DPL, int NWARPS, int PPW>
__global__ void __launch_bounds__(NWARPS * 32)
    attention_kernel(const AttnParams p) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* qs = smem;                        // [NWARPS * PPW][D], pre-scaled
  float* ks = qs + NWARPS * PPW * D;       // [kChunk][D + 1] (padded rows)
  float* vs = ks + kChunk * (D + 1);       // [kChunk][D]

  const int G = p.H / p.KVH;
  const int b = blockIdx.x / p.KVH;
  const int kvh = blockIdx.x % p.KVH;
  const int row0 = blockIdx.y * p.rows_per_cta;
  const int rows = min(p.rows_per_cta, p.Sq - row0);
  const int npairs = rows * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int start = p.kv_start != nullptr ? max(p.kv_start[b], 0) : 0;
  int pre =
      p.prefix_len != nullptr ? min(max(p.prefix_len[b], 0), p.Sk) : 0;
  if (start <= pre) start = pre = 0;  // no gap: one segment [0, Sk)
  const int qlo = row0;
  const int qhi = row0 + rows - 1;

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  for (int idx = threadIdx.x; idx < npairs * D; idx += NWARPS * 32) {
    const int pr = idx / D, d = idx % D;
    const int r = pr / G, g = pr % G;
    qs[pr * D + d] =
        to_f(qg[b * p.q_sb + (row0 + r) * p.q_ss + (kvh * G + g) * p.q_sh + d]) *
        p.scale;
  }

  float m[PPW], l[PPW], acc[PPW][DPL];
#pragma unroll
  for (int t = 0; t < PPW; ++t) {
    m[t] = kNegSentinel;
    l[t] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[t][c] = 0.f;
  }

  // Segment 0: the prefix [0, pre); segment 1: the keys [start, Sk).
  for (int seg = pre > 0 ? 0 : 1; seg < 2; ++seg) {
    const int lo = seg == 0 ? 0 : start;
    int kbeg = lo;
    if (p.window > 0) kbeg = max(kbeg, qlo - p.window + 1);
    const int hi = seg == 0 ? pre : p.Sk;
    const int kend = p.causal ? min(hi, qhi + 1) : hi;
    for (int j0 = kbeg; j0 < kend; j0 += kChunk) {
      __syncthreads();  // q staged / previous chunk consumed
      for (int idx = threadIdx.x; idx < kChunk * D; idx += NWARPS * 32) {
        const int j = idx / D, d = idx % D;
        const int key = j0 + j;
        float kx = 0.f, vx = 0.f;
        if (key < kend) {
          kx = to_f(kg[b * p.k_sb + key * p.k_ss + kvh * p.k_sh + d]);
          vx = to_f(vg[b * p.v_sb + key * p.v_ss + kvh * p.v_sh + d]);
        }
        ks[j * (D + 1) + d] = kx;
        vs[j * D + d] = vx;
      }
      __syncthreads();

      const int key = j0 + lane;
#pragma unroll
      for (int t = 0; t < PPW; ++t) {
        const int pr = warp + NWARPS * t;
        if (pr >= npairs) break;  // warp-uniform
        const int qpos = row0 + pr / G;
        bool valid = key < kend && key >= lo;
        if (p.causal) valid = valid && key <= qpos;
        if (p.window > 0) valid = valid && key > qpos - p.window;
        if (!__any_sync(kFullMask, valid)) continue;

        float s = kNegSentinel;
        if (valid) {
          const float* qr = qs + pr * D;
          const float* kr = ks + lane * (D + 1);
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
          if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
          s = dot;
        }
        const float m_new = fmaxf(m[t], warp_max(s));
        const float pj = valid ? expf(s - m_new) : 0.f;
        const float corr = expf(m[t] - m_new);
        l[t] = l[t] * corr + warp_sum(pj);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[t][c] *= corr;
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) {
          const float pb = __shfl_sync(kFullMask, pj, j);
#pragma unroll
          for (int c = 0; c < DPL; ++c)
            acc[t][c] += pb * vs[j * D + lane + 32 * c];
        }
        m[t] = m_new;
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int t = 0; t < PPW; ++t) {
    const int pr = warp + NWARPS * t;
    if (pr >= npairs) break;
    const int r = pr / G, g = pr % G;
    const float denom = fmaxf(l[t], 1e-30f);
    T* orow = og + b * p.o_sb + (row0 + r) * p.o_ss + (kvh * G + g) * p.o_sh;
#pragma unroll
    for (int c = 0; c < DPL; ++c) orow[lane + 32 * c] = from_f<T>(acc[t][c] / denom);
  }
}

template <typename T, int DPL, int NWARPS, int PPW>
cudaError_t launch_attention_d(const AttnParams& p, dim3 grid,
                               cudaStream_t stream) {
  constexpr int D = DPL * 32;
  const size_t smem =
      sizeof(float) * (NWARPS * PPW * D + kChunk * (D + 1) + kChunk * D);
  auto kern = attention_kernel<T, DPL, NWARPS, PPW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, NWARPS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int NWARPS, int PPW>
cudaError_t launch_attention_t(const AttnParams& p, int D, dim3 grid,
                               cudaStream_t stream) {
  switch (D) {
    case 32: return launch_attention_d<T, 1, NWARPS, PPW>(p, grid, stream);
    case 64: return launch_attention_d<T, 2, NWARPS, PPW>(p, grid, stream);
    case 96: return launch_attention_d<T, 3, NWARPS, PPW>(p, grid, stream);
    case 128: return launch_attention_d<T, 4, NWARPS, PPW>(p, grid, stream);
    // recurrentgemma's heads.  At 8 warps x 8 pairs the CTA stages 64 query
    // rows of 1 KB plus a 32-key K/V chunk: ~129 KB of shared memory, so
    // one CTA an SM, and 64 fp32 accumulators a lane.
    case 256: return launch_attention_d<T, 8, NWARPS, PPW>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int NWARPS, int PPW>
cudaError_t launch_attention_f32(const AttnParams& p, int D, dim3 grid,
                                 cudaStream_t stream) {
  return launch_attention_t<float, NWARPS, PPW>(p, D, grid, stream);
}

}  // namespace repro
