// Prefill (flash) attention forward for Hopper (sm_90a): causal, sliding
// window, tanh softcap, GQA, per-row left-pad start `kv_start`.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py), plus what the
// engine's prefill needs and the Pallas kernel lacks: the per-row start of
// the valid keys (the left-pad prefix of models/flash.py's `kv_valid`).
// Grid: (B * KVH, ceil(Sq / rows_per_cta)); a CTA of 8 warps owns one KV
// head and rows_per_cta = 64 / G query rows, i.e. 64 (row, head) pairs, and
// walks only the keys some of its rows can see (dead chunks beyond the
// causal frontier or before the window are never loaded).  q/k/v are read
// in [B, S, H, D] in place through their strides; the output is written
// contiguous [B, Sq, H, D].
//
// Bound on the H100: at the engine's prefill (28 x 16 tokens) the work is
// ~0.1 GFLOP and ~2 MB, so launch latency bounds it; at long prompts it is
// operations, where this CUDA-core kernel is far from the tensor-core peak
// (a wgmma/TMA version is later work).
#include "attention.cuh"

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* kv_start,
    int dtype, int B, int Sq, int Sk, int H, int KVH, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  constexpr int kWarps = 8, kPairsPerWarp = 8;
  const int G = H / KVH;
  if (G < 1 || G > kWarps * kPairsPerWarp) return cudaErrorInvalidValue;
  repro::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_start = kv_start;
  p.kv_len = nullptr;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = static_cast<long long>(Sq) * H * D;  // o: contiguous [B,Sq,H,D]
  p.o_ss = static_cast<long long>(H) * D;
  p.o_sh = D;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KVH = KVH;
  p.rows_per_cta = (kWarps * kPairsPerWarp) / G;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const dim3 grid(B * KVH, (Sq + p.rows_per_cta - 1) / p.rows_per_cta);
  // Wide: head_dim 256 (recurrentgemma) is built here, not for decode.
  return static_cast<int>(
      repro::launch_attention<kWarps, kPairsPerWarp, /*WIDE=*/true>(
          p, dtype, D, grid, static_cast<cudaStream_t>(stream)));
}
