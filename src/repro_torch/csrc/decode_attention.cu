// Decode attention for Hopper (sm_90a): one new query token per sequence
// against the KV cache, GQA, per-row valid window [kv_start, kv_len).
//
// Replaces the Pallas TPU kernel `_decode_kernel` /
// `decode_attention_fwd` (src/repro/kernels/decode_attention/
// decode_attention.py).  Grid: one CTA per (batch, KV head) with 4 warps;
// the G query heads of the KV head are the CTA's pairs (one per warp at
// G = 4), and the CTA walks the window's keys in 32-key chunks (see
// attention.cuh).  The cache is read in place through its strides — the
// Pallas wrapper's [B*KVH, S, D] transpose would copy the whole cache on
// every layer of every step here — and only the window's rows are read.
//
// Bound on the H100: bytes.  Each valid K/V row is read once per KV head
// and reused by all G heads from shared memory; at the engine's shapes
// (cache 128, batch 4-28) the kernel moves well under a megabyte and launch
// latency dominates.  At batch 4 the grid is only B*KVH = 32 CTAs on 132
// SMs; a split-KV second pass would fill the card on long caches and is
// left for a later change.
#include "attention.cuh"

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* kv_len,
    const int* kv_start, int dtype, int B, int H, int KVH, int D, int S,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  repro::AttnParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_start = kv_start;
  p.kv_len = kv_len;
  p.q_sb = q_sb;
  p.q_ss = 0;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = static_cast<long long>(H) * D;  // o: contiguous [B, H, D]
  p.o_ss = 0;
  p.o_sh = D;
  p.Sq = 1;
  p.Sk = S;
  p.H = H;
  p.KVH = KVH;
  p.rows_per_cta = 1;
  p.causal = 1;
  p.window = 0;
  p.scale = scale;
  p.softcap = 0.f;
  const dim3 grid(B * KVH, 1);
  return static_cast<int>(repro::launch_attention<4, 8>(
      p, dtype, D, grid, static_cast<cudaStream_t>(stream)));
}
