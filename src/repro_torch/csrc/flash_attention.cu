// Prefill (flash) attention forward for Hopper (sm_90a): causal, sliding
// window, tanh softcap, GQA, per-row left-pad start `kv_start` and per-row
// `prefix_len` (keys valid before the pads).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` / `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py:38, call :134),
// plus what the engine's prefill needs and the Pallas kernel lacks: the
// per-row start of the valid keys (the left-pad prefix of models/flash.py's
// `kv_valid`), and a prefix of keys that stay valid before the pads (prefix
// embeddings before a left-padded prompt: a row's valid keys are
// [0, prefix_len) and [kv_start, Sk)).  q/k/v are read in [B, S, H, D] in
// place through their strides; the output is written contiguous
// [B, Sq, H, D].  Two routes, one
// C entry point each, chosen by the wrapper (kernels/flash_attention/ops.py)
// from the dtype:
//
//  * bf16: `flash_attention_wgmma` below, on the tensor cores.
//  * fp32: the CUDA-core kernel of attention.cuh (`flash_attention_launch`).
//
// What bounds the bf16 route on the H100: at 4 x 4000 tokens (llama heads,
// causal) the work is 2.6e11 operations over a few MB of q/k/v/o, so the
// tensor cores' 989 TFLOP/s bound it (0.265 ms).  At head_dim 64 the
// softmax costs as much issue time as the two products: per score one max,
// one FFMA, one exponential (MUFU, 16 a clock an SM) and half a bf16
// conversion, against 256 tensor-core operations.  At the engine's
// 28 x 16-token prefills the work is ~0.1 GFLOP and ~2 MB: launch latency
// and one TMA round trip bound it.
//
// Design.  A work item is one (batch, KV head), `gp` of that KV head's
// query heads (the largest power of two dividing the group, at most 64) and
// a block of positions; the gp heads of 64 / gp positions are packed into
// the 64 rows of a warpgroup's tile (row = position * gp + head, the order in
// which a TMA box {64 d, gp heads, 64 / gp positions} lands in shared
// memory), so GQA shares each K/V tile across the packed heads and a
// 16-token prompt fills whole tiles.  One persistent CTA an SM takes items
// in turn, the heavy ones (late rows under a causal mask) first.  NWG
// consumer warpgroups take 64 rows each; a producer warpgroup (one thread
// issuing, its registers handed to the consumers by setmaxnreg) loads each
// item's q into one of two buffers and streams K/V tiles of BN keys through
// a ring of ST stages with TMA (128-byte swizzle, full/empty mbarrier
// pairs), running on into the next item while this one finishes.  Only the
// key range some row of the item can see is loaded (causal frontier, window
// start, kv_start); a warpgroup skips the tiles none of its rows can see,
// and only the tiles at the edges of its range are masked.  With a prefix
// before the pads an item's tiles are two runs, the prefix's [0, prefix_len)
// and then [kv_start, Sk): the tiles of the pad gap between them are never
// loaded, and each run's tiles are masked to their own run, so a key that
// both runs' edge tiles cover counts once.  Per tile a
// warpgroup runs S = q K^T (wgmma, both operands in shared memory), the
// online softmax in registers (fp32, exp2 with the scale folded into one
// FFMA, quad shuffles for the row max, a stale max kept while it is within
// 2^8 so O is rarely rescaled), rounds P to bf16 in registers and runs
// O += P V (wgmma with P as the register A operand: the accumulator layout
// of S is the A-fragment layout).  A warpgroup pipelines its tiles: issue
// q K^T (t) and P V (t - 1), wait for S (t), then the softmax of t runs
// while the tensor cores do P V (t - 1).  For D <= 128 each stage carries,
// after V, a constant chunk whose first 8 columns are 1, so P V's last 8
// columns are P's row sums, summed by the tensor cores from the same bf16 P
// as the output.  Shapes by head dim (D = 32 and 96 are read as 64 and 128
// wide; TMA fills the columns past D with zeros):
//
//   D <= 64:  BN 96, 4 stages, 3 consumer warpgroups that take turns
//     issuing their products (named barriers), 160 registers each; shared
//     memory q 2 x 24 KB + 4 x 36 KB.
//   D <= 128: BN 128, 2 stages, 2 consumer warpgroups of 232 registers;
//     q 2 x 32 KB + 2 x 80 KB.
//   D = 256:  BN 64, 2 stages, 2 consumer warpgroups; q 64 KB (a second
//     buffer does not fit) + 2 x 64 KB.
//     The 64 x 256 fp32 O tile takes 128 registers a thread; a 64-key S
//     tile adds 32 and its bf16 P 16, under the 232 a consumer gets.
//     Splitting D across the two warpgroups instead would compute S twice
//     or pass it through shared memory every tile.  (N = 256 leaves no room
//     for the row-sum columns: the row sums are FADDs here.)
//
// A row with no valid key (a left-pad query row) ends with l = 0 and writes
// 0, finite.
#include <math_constants.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kTcRows = 64;     // rows of a warpgroup's tile
constexpr int kRowBytes = 128;  // 64 bf16: one swizzle span
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  void* o;
  const int* kv_start;    // [B] first valid key after the pads, or nullptr
  const int* prefix_len;  // [B] keys valid before the pads, or nullptr (= 0)
  long long o_sb, o_ss;
  int Sq, Sk, D, G;
  int gp_log2;          // log2 of the query heads packed into a tile
  int n_pb, n_hg;       // position blocks; head groups a KV head
  int B, KVH;
  int causal, window;
  float scale, softcap;
};

// NC chunks of 64 head-dim columns, BN keys a K/V tile, ST stages, NWG
// consumer warpgroups (plus one producer warpgroup).
template <int NC, int BN, int ST, int NWG>
struct TcShape {
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kQChunk = kTcRows * kRowBytes;     // 64 rows x 64 d
  static constexpr int kQBytes = NWG * NC * kQChunk;
  static constexpr int kKVChunk = BN * kRowBytes;         // BN keys x 64 d
  static constexpr int kLoadBytes = 2 * NC * kKVChunk;    // K, then V
  // With a ones column (D <= 128) V is followed by a chunk whose first 8
  // columns are 1: P V's extra columns are then the row sums of P.
  static constexpr bool kOnes = NC <= 2;
  static constexpr int kORegs = 32 * NC + (kOnes ? 4 : 0);
  static constexpr int kStageBytes = kLoadBytes + (kOnes ? kKVChunk : 0);
  // q buffers: two where shared memory allows, so the next item's q loads
  // while this one's last tiles run.
  static constexpr int kQB = NC <= 2 ? 2 : 1;
  static constexpr int kSmem = kQB * kQBytes + ST * kStageBytes + 1024 +
                               8 * (2 * kQB + 2 * ST);
  // Three warpgroups take turns issuing their products (two gained
  // nothing from it on the H100).
  static constexpr bool kTurns = NWG == 3;
  // Registers of a producer and of a consumer thread after setmaxnreg:
  // together no more than the launch gave (65536 / kThreads, in steps of 8).
  static constexpr int kProducerRegs = NWG == 2 ? 40 : 32;
  static constexpr int kConsumerRegs = NWG == 2 ? 232 : 160;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x BN) = q (64 x 16 k-step) @ K^T: both K-major in shared memory.
template <int BN>
__device__ __forceinline__ void qk_step(float (&s)[BN / 2], uint64_t da,
                                        uint64_t db, int acc) {
  if constexpr (BN == 128)
    wgmma_m64n128k16_ss<0>(s, da, db, acc);
  else if constexpr (BN == 96)
    wgmma_m64n96k16_ss<0>(s, da, db, acc);
  else
    wgmma_m64n64k16_ss<0>(s, da, db, acc);
}

// O (64 x N) += P (64 x 16 keys, registers) @ V (N-major in shared memory,
// chunks of 64 columns); N = 2 * R, the row sums' 8 columns included.
template <int R>
__device__ __forceinline__ void pv_step(float (&o)[R], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (R == 36)
    wgmma_m64n72k16_rs<1>(o, a, db);
  else if constexpr (R == 68)
    wgmma_m64n136k16_rs<1>(o, a, db);
  else
    wgmma_m64n256k16_rs<1>(o, a, db);
}

template <int NC, int BN, int ST, int NWG, bool kPrefix>
__global__ void __launch_bounds__(TcShape<NC, BN, ST, NWG>::kThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const TcParams p) {
  using Sh = TcShape<NC, BN, ST, NWG>;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t base = (smem_u32(tc_smem) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t kvs = base + Sh::kQB * Sh::kQBytes;
  const uint32_t bars = kvs + ST * Sh::kStageBytes;
  auto qfull = [&](int i) { return bars + 8 * i; };
  auto qempty = [&](int i) { return bars + 8 * (Sh::kQB + i); };
  auto full = [&](int s) { return bars + 8 * (2 * Sh::kQB + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * Sh::kQB + ST + s); };

  // A persistent CTA takes work items blockIdx.x, + gridDim.x, ...: an
  // item is one (batch, KV head, head group, position block), numbered
  // with the heavy position blocks (late rows under a causal mask) first.
  const int gp = 1 << p.gp_log2;
  const int P = kTcRows >> p.gp_log2;  // positions a warpgroup
  const int per_pb = p.KVH * p.n_hg * p.B;
  const int n_items = per_pb * p.n_pb;
  // Tile t of an item starts at key kb + t * BN.  With a prefix (kPrefix,
  // the instantiation launched when prefix_len is given) tiles [0, n_pre)
  // start at kp + t * BN and hold the prefix [0, pre), and tiles
  // [n_pre, n_tiles) start at kb + (t - n_pre) * BN and hold [start, Sk);
  // with no gap between the two, n_pre = 0.
  struct Item {
    int b, kvh, h0, pos0, start, kb, n_tiles, pre, kp, n_pre;
  };
  auto tile_key = [](const Item& w, int t) {  // first key of tile t
    if constexpr (kPrefix)
      return t < w.n_pre ? w.kp + t * BN : w.kb + (t - w.n_pre) * BN;
    else
      return w.kb + t * BN;
  };
  auto item_at = [&](int idx) {
    Item w;
    const int pb = p.n_pb - 1 - idx / per_pb;
    int rest = idx % per_pb;
    const int hg = rest % p.n_hg;
    rest /= p.n_hg;
    w.kvh = rest % p.KVH;
    w.b = rest / p.KVH;
    w.h0 = w.kvh * p.G + hg * gp;
    w.pos0 = pb * NWG * P;
    // The keys some row of the item can see: [kb, ke), and with a prefix
    // [kp, kpe) of it before them.
    w.start = p.kv_start != nullptr ? max(p.kv_start[w.b], 0) : 0;
    const int pos_hi = min(w.pos0 + NWG * P, p.Sq) - 1;
    const int ke = p.causal ? min(p.Sk, pos_hi + 1) : p.Sk;
    w.pre = w.kp = w.n_pre = 0;
    if constexpr (kPrefix) {
      w.pre = min(max(p.prefix_len[w.b], 0), p.Sk);
      if (w.start <= w.pre) w.start = w.pre = 0;  // no gap: one run [0, Sk)
      const int lo = p.window > 0 ? w.pos0 - p.window + 1 : 0;
      w.kp = max(0, lo);
      const int kpe = p.causal ? min(w.pre, pos_hi + 1) : w.pre;
      w.n_pre = kpe > w.kp ? (kpe - w.kp + BN - 1) / BN : 0;
      w.kb = max(w.start, lo);
    } else {
      w.kb = w.start;
      if (p.window > 0) w.kb = max(w.kb, w.pos0 - p.window + 1);
    }
    w.n_tiles = w.n_pre + (ke > w.kb ? (ke - w.kb + BN - 1) / BN : 0);
    return w;
  };
  const int wg = threadIdx.x >> 7;

  if constexpr (Sh::kOnes) {  // each stage's ones chunk: 16 bytes a row
    for (int i = threadIdx.x; i < ST * BN; i += Sh::kThreads) {
      const int row = i % BN;
      const uint32_t at = kvs + (i / BN) * Sh::kStageBytes + Sh::kLoadBytes +
                          row * kRowBytes + (row & 7) * 16;
      asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(at),
                   "r"(0x3F803F80u)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < Sh::kQB; ++i) {
      mbar_init(qfull(i), 1);
      mbar_init(qempty(i), 128 * NWG);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // producer warpgroup: one thread starts TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     Sh::kProducerRegs)
                 : "memory");
    if (threadIdx.x == 128 * NWG) {
      int it = 0;  // K/V tiles loaded so far, over all items
      for (int k = 0, idx = blockIdx.x; idx < n_items;
           ++k, idx += gridDim.x) {
        const Item w = item_at(idx);
        // q into its buffer once the item before last has done with it;
        // K/V tiles run on through the ring across items.
        const int qb = k % Sh::kQB;
        mbar_wait(qempty(qb), ((k / Sh::kQB) & 1) ^ 1);
        mbar_expect_tx(qfull(qb), Sh::kQBytes);
        for (int g = 0; g < NWG; ++g)
          for (int c = 0; c < NC; ++c)
            tma_load_4d(base + qb * Sh::kQBytes + (g * NC + c) * Sh::kQChunk,
                        &qmap, qfull(qb), 64 * c, w.h0, w.pos0 + g * P, w.b);
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int s = it % ST;
          mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
          mbar_expect_tx(full(s), Sh::kLoadBytes);
          const uint32_t st = kvs + s * Sh::kStageBytes;
          const int j0 = tile_key(w, t);
          for (int c = 0; c < NC; ++c) {
            tma_load_4d(st + c * Sh::kKVChunk, &kmap, full(s), 64 * c, w.kvh,
                        j0, w.b);
            tma_load_4d(st + (NC + c) * Sh::kKVChunk, &vmap, full(s), 64 * c,
                        w.kvh, j0, w.b);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows r and r + 8 of its tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     Sh::kConsumerRegs)
                 : "memory");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = 16 * (tid >> 5) + (lane >> 2);
    const bool capped = p.softcap > 0.f;
    const float x_scale = (capped ? 1.f : p.scale) * kLog2e;
    float o[Sh::kORegs];
    float sc[BN / 2];
    uint32_t a[BN / 16][4];
    int it0 = 0;  // K/V tiles of the items before this one
    for (int k = 0, idx = blockIdx.x; idx < n_items; ++k, idx += gridDim.x) {
      const Item w = item_at(idx);
      const int b = w.b, h0 = w.h0, start = w.start, kb = w.kb;
      const int n_tiles = w.n_tiles;
      const int qb = k % Sh::kQB;
      const int wlo = w.pos0 + wg * P;
      const int whi = min(wlo + P, p.Sq) - 1;
      const int qp0 = wlo + (r >> p.gp_log2);
      const int qp1 = wlo + ((r + 8) >> p.gp_log2);
      // This warpgroup's keys [kb_w, ke_w) lie in tiles [t_lo, t_hi).
      int t_lo = 0, t_hi = 0;
      if constexpr (kPrefix) {
        // [kp_w, kpe_w) of the prefix too.  Under a causal mask a warpgroup
        // that sees keys after the pads sees the whole prefix, and under a
        // window one that sees some of the prefix sees every key from
        // start on, so no tile it needs lies outside one unbroken range.
        const int n_pre = w.n_pre;
        const int lo_w = p.window > 0 ? wlo - p.window + 1 : 0;
        const int hi_w = p.causal ? whi + 1 : p.Sk;
        if (wlo < p.Sq && n_tiles > 0) {
          int tl = n_tiles, th = 0;
          const int kp_w = max(0, lo_w), kpe_w = min(w.pre, hi_w);
          if (n_pre > 0 && kpe_w > kp_w) {
            tl = max(0, (kp_w - w.kp) / BN);
            th = min(n_pre, (kpe_w - w.kp + BN - 1) / BN);
          }
          const int kb_w = max(start, lo_w), ke_w = min(p.Sk, hi_w);
          if (n_tiles > n_pre && ke_w > kb_w) {
            tl = min(tl, n_pre + max(0, (kb_w - kb) / BN));
            th = max(th, min(n_tiles, n_pre + (ke_w - kb + BN - 1) / BN));
          }
          if (tl < th) {
            t_lo = tl;
            t_hi = th;
          }
        }
      } else {
        int kb_w = start;
        if (p.window > 0) kb_w = max(kb_w, wlo - p.window + 1);
        const int ke_w = p.causal ? min(p.Sk, whi + 1) : p.Sk;
        if (wlo < p.Sq && ke_w > kb_w && n_tiles > 0) {
          t_lo = max(0, (kb_w - kb) / BN);
          t_hi = min(n_tiles, (ke_w - kb + BN - 1) / BN);
        }
      }
      const uint32_t qa = base + qb * Sh::kQBytes + wg * NC * Sh::kQChunk;
      // Tile t of this item sits in stage (it0 + t) % ST.
      auto stage = [&](int t) { return (it0 + t) % ST; };
      auto phase = [&](int t) { return ((it0 + t) / ST) & 1; };
      auto k_tile = [&](int t) { return kvs + stage(t) * Sh::kStageBytes; };

#pragma unroll
      for (int i = 0; i < Sh::kORegs; ++i) o[i] = 0.f;
      float m0 = kNegSentinel, m1 = kNegSentinel, l0 = 0.f, l1 = 0.f;

      // S = q K^T of tile t into sc, committed as one wgmma group.  A
      // 16-deep step is 32 bytes along a 128-byte row, 8-row groups 1024
      // bytes apart, one box (chunk) a 64 columns of d; the offsets are
      // added to the descriptors' address field (16-byte units).
      const uint64_t dq = gmma_desc(qa, 16, 1024);
      auto issue_qk = [&](int t) {
        const uint64_t dk = gmma_desc(k_tile(t), 16, 1024);
#pragma unroll
        for (int kk = 0; kk < NC * 4; ++kk)
          qk_step<BN>(
              sc, dq + (((kk >> 2) * Sh::kQChunk + (kk & 3) * 32) >> 4),
              dk + (((kk >> 2) * Sh::kKVChunk + (kk & 3) * 32) >> 4), kk > 0);
        wgmma_commit();
      };
      // O += P V of tile t, P in a, committed as one wgmma group.  V is
      // N-major: 16 keys (2 KB) a step, d chunks kKVChunk apart.
      auto issue_pv = [&](int t) {
        const uint64_t dv =
            gmma_desc(k_tile(t) + NC * Sh::kKVChunk, Sh::kKVChunk, 1024);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          pv_step<Sh::kORegs>(o, a[kk], dv + ((kk * 2048) >> 4));
        wgmma_commit();
      };
      // The online softmax of tile t: sc becomes the weights (fp32); returns
      // the factors c0, c1 that rescale rows r and r + 8 of O.
      auto softmax = [&](int t, float& c0, float& c1) {
        const int j0 = tile_key(w, t);
        // The run tile t belongs to: the prefix [0, pre) or [start, Sk).
        const bool in_pre = kPrefix && t < w.n_pre;
        const int seg_lo = in_pre ? 0 : start;
        const int seg_hi = in_pre ? w.pre : p.Sk;
        if (capped) {
          const float inv = p.scale / p.softcap;
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            sc[i] = p.softcap * tanhf(sc[i] * inv);
        }
        // Only the tiles at the edges of some row's key range are masked.
        const bool edge = j0 < seg_lo || j0 + BN > seg_hi ||
                          (p.causal && j0 + BN - 1 > wlo) ||
                          (p.window > 0 && j0 <= whi - p.window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            const int qp = (i & 2) ? qp1 : qp0;
            bool ok = key >= seg_lo && key < seg_hi;
            if (p.causal) ok = ok && key <= qp;
            if (p.window > 0) ok = ok && key > qp - p.window;
            if (!ok) sc[i] = kNegSentinel;
          }
        }
        // Row maxima over 4 partial maxima each (short dependency chains),
        // then across the quad that shares a row.
        float u0[4], u1[4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float x0 = fmaxf(sc[4 * j], sc[4 * j + 1]);
          const float x1 = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
          u0[j & 3] = j < 4 ? x0 : fmaxf(u0[j & 3], x0);
          u1[j & 3] = j < 4 ? x1 : fmaxf(u1[j & 3], x1);
        }
        float mx0 = fmaxf(fmaxf(u0[0], u0[1]), fmaxf(u0[2], u0[3]));
        float mx1 = fmaxf(fmaxf(u1[0], u1[1]), fmaxf(u1[2], u1[3]));
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, off));
        }
        // A stale max is kept while the new one exceeds it by at most 8 in
        // the exponent (weights up to 2^8, exact enough in fp32 and bf16),
        // so most tiles leave O unscaled.
        const float mn0 = (mx0 - m0) * x_scale > 8.f ? mx0 : m0;
        const float mn1 = (mx1 - m1) * x_scale > 8.f ? mx1 : m1;
        c0 = fast_exp2((m0 - mn0) * x_scale);
        c1 = fast_exp2((m1 - mn1) * x_scale);
        // A row with no valid key yet keeps every weight at 0; otherwise a
        // masked score (the sentinel) gives exp2 of a huge negative, 0.
        const float b0 = mn0 == kNegSentinel ? -CUDART_INF_F : -mn0 * x_scale;
        const float b1 = mn1 == kNegSentinel ? -CUDART_INF_F : -mn1 * x_scale;
        m0 = mn0;
        m1 = mn1;
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          sc[4 * j] = fast_exp2(fmaf(sc[4 * j], x_scale, b0));
          sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], x_scale, b0));
          sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], x_scale, b1));
          sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], x_scale, b1));
          if (!Sh::kOnes) {
            t0[j & 3] += sc[4 * j] + sc[4 * j + 1];
            t1[j & 3] += sc[4 * j + 2] + sc[4 * j + 3];
          }
        }
        if (!Sh::kOnes) {  // this thread's share of the row sums
          l0 = l0 * c0 + ((t0[0] + t0[1]) + (t0[2] + t0[3]));
          l1 = l1 * c1 + ((t1[0] + t1[1]) + (t1[2] + t1[3]));
        }
      };
      // O *= c (per row; skipped when no row's max moved), then P = sc
      // rounded to bf16 into the A fragments
      // (the accumulator layout of S is the A-fragment layout).
      auto rescale_pack = [&](float c0, float c1) {
        if (__any_sync(kFullMask, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
          for (int j = 0; j < Sh::kORegs / 4; ++j) {
            o[4 * j] *= c0;
            o[4 * j + 1] *= c0;
            o[4 * j + 2] *= c1;
            o[4 * j + 3] *= c1;
          }
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          a[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          a[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          a[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          a[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      // The warpgroups take turns issuing their products, one slot a K/V
      // tile (n_tiles + 1 slots an item: slot t issues q K^T of tile t and
      // P V of tile t - 1), warpgroup 0 first, so that one's softmax runs
      // while the next one's products keep the tensor cores busy.  Named
      // barrier 1 + g: warpgroup g syncs on it, warpgroup g - 1 arrives; the
      // last warpgroup arrives on barrier 1 once before an item's first slot
      // and not after its last, so every barrier completes as often as it
      // is waited on.
      int slot = 0;
      auto turn_wait = [&]() {
        if (Sh::kTurns)
          asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
      };
      auto turn_pass = [&]() {
        if (Sh::kTurns && !(wg == NWG - 1 && slot == n_tiles))
          asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % NWG)
                       : "memory");
        ++slot;
      };
      // A tile this warpgroup cannot see: wait for it, give it back, and
      // pass its turn.
      auto skip = [&](int t) {
        mbar_wait(full(stage(t)), phase(t));
        mbar_arrive(empty(stage(t)));
        turn_wait();
        turn_pass();
      };

      mbar_wait(qfull(qb), (k / Sh::kQB) & 1);
      if (Sh::kTurns && wg == NWG - 1)
        asm volatile("bar.arrive 1, 256;\n" ::: "memory");
      for (int t = 0; t < t_lo; ++t) skip(t);
      // The rest in a pipeline: the softmax of tile t runs while the tensor
      // cores do P V of tile t - 1.
      if (t_lo < t_hi) {
        float c0, c1;
        mbar_wait(full(stage(t_lo)), phase(t_lo));
        turn_wait();
        wgmma_fence();
        issue_qk(t_lo);
        turn_pass();
        wgmma_wait<0>();
        softmax(t_lo, c0, c1);
        rescale_pack(c0, c1);
        for (int t = t_lo + 1; t < t_hi; ++t) {
          mbar_wait(full(stage(t)), phase(t));
          turn_wait();
          wgmma_fence();
          issue_qk(t);
          issue_pv(t - 1);
          turn_pass();
          wgmma_wait<1>();  // S of tile t
          softmax(t, c0, c1);
          wgmma_wait<0>();  // P V of tile t - 1
          mbar_arrive(empty(stage(t - 1)));
          rescale_pack(c0, c1);
        }
        turn_wait();
        wgmma_fence();
        issue_pv(t_hi - 1);
        turn_pass();
        wgmma_wait<0>();
        mbar_arrive(empty(stage(t_hi - 1)));
      }
      mbar_arrive(qempty(qb));  // no product of this item reads q any more
      for (int t = max(t_lo, t_hi); t < n_tiles; ++t) skip(t);
      while (slot <= n_tiles) {  // a warpgroup with no tile: its last slot
        turn_wait();
        turn_pass();
      }
      it0 += n_tiles;

      // Epilogue: the quad's shares of l, then bf16 pairs straight to o.
      if constexpr (Sh::kOnes) {
        l0 = o[Sh::kORegs - 4];
        l1 = o[Sh::kORegs - 2];
      } else {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(kFullMask, l0, off);
        l1 += __shfl_xor_sync(kFullMask, l1, off);
      }
      }
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qp = half ? qp1 : qp0;
        if (qp >= p.Sq) continue;
        const float l = half ? l1 : l0;
        const float inv = l > 0.f ? 1.f / l : 0.f;
        const int head = h0 + ((r + 8 * half) & (gp - 1));
        __nv_bfloat16* orow = og + b * p.o_sb + qp * p.o_ss +
                              static_cast<long long>(head) * p.D;
#pragma unroll
        for (int j = 0; j < NC * 8; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          if (col < p.D)
            *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(
                o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
        }
      }
    }
  }
}

// A 4-D map over a bf16 [B, S, heads, D] tensor with unit last-dim stride
// and the given element strides, in boxes of {64 d, box_heads, box_rows, 1}
// with 128-byte swizzle (columns and rows past the extent read as zeros).
bool make_attn_map(CUtensorMap* map, const void* ptr, int D, int heads,
                   int S, int B, long long sh, long long ss, long long sb,
                   int box_heads, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_heads),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TcArgs {
  const void *q, *k, *v;
  int B, Sq, Sk, H, KVH, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <int NC, int BN, int ST, int NWG>
cudaError_t launch_tc(const TcArgs& a, TcParams p, cudaStream_t stream) {
  using Sh = TcShape<NC, BN, ST, NWG>;
  const int gp = 1 << p.gp_log2;
  const int rows = NWG * (kTcRows / gp);  // positions a CTA
  p.n_pb = (a.Sq + rows - 1) / rows;
  CUtensorMap qmap, kmap, vmap;
  if (!make_attn_map(&qmap, a.q, a.D, a.H, a.Sq, a.B, a.q_sh, a.q_ss, a.q_sb,
                     gp, kTcRows / gp) ||
      !make_attn_map(&kmap, a.k, a.D, a.KVH, a.Sk, a.B, a.k_sh, a.k_ss,
                     a.k_sb, 1, BN) ||
      !make_attn_map(&vmap, a.v, a.D, a.KVH, a.Sk, a.B, a.v_sh, a.v_ss,
                     a.v_sb, 1, BN))
    return cudaErrorInvalidValue;
  // The prefix-aware instantiation only where a prefix is given: without
  // one the kernel is the one the wrapper always launched.
  auto kern = p.prefix_len != nullptr
                  ? flash_attention_wgmma<NC, BN, ST, NWG, true>
                  : flash_attention_wgmma<NC, BN, ST, NWG, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (err != cudaSuccess) return err;
  // One persistent CTA an SM (or one an item, if fewer).
  const long long items =
      static_cast<long long>(a.B) * a.KVH * p.n_hg * p.n_pb;
  int dev = 0, sms = 0;
  if (items < 1 || items > 0x7fffffffLL || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(items < sms ? items : sms), Sh::kThreads,
         Sh::kSmem, stream>>>(qmap, kmap, vmap, p);
  return cudaGetLastError();
}

}  // namespace

// The fp32 route: the CUDA-core kernel of attention.cuh.  Grid: (B * KVH,
// ceil(Sq / rows_per_cta)); a CTA of 8 warps owns one KV head and
// rows_per_cta = 64 / G query rows, i.e. 64 (row, head) pairs.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* kv_start,
    const int* prefix_len, int B, int Sq, int Sk, int H, int KVH, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh,
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
  p.prefix_len = prefix_len;
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
  return static_cast<int>(repro::launch_attention_f32<kWarps, kPairsPerWarp>(
      p, D, grid, static_cast<cudaStream_t>(stream)));
}

// The bf16 route: `flash_attention_wgmma`.  q/k/v need 16-byte aligned
// bases and strides (TMA); the wrapper checks both.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, const int* kv_start,
    const int* prefix_len, int B, int Sq, int Sk, int H, int KVH, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH)
    return cudaErrorInvalidValue;
  const int G = H / KVH;
  if (G > 64) return cudaErrorInvalidValue;
  const int gp = G & -G;  // a power of two dividing G and 64
  int gp_log2 = 0;
  while ((1 << gp_log2) < gp) ++gp_log2;
  TcParams p{};
  p.o = o;
  p.kv_start = kv_start;
  p.prefix_len = prefix_len;
  p.o_ss = static_cast<long long>(H) * D;  // o: contiguous [B,Sq,H,D]
  p.o_sb = static_cast<long long>(Sq) * p.o_ss;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.G = G;
  p.gp_log2 = gp_log2;
  p.n_hg = G / gp;
  p.B = B;
  p.KVH = KVH;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const TcArgs a{q,    k,    v,    B,    Sq,   Sk,   H,    KVH,
                 D,    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                 v_ss, v_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
    case 64:
      return static_cast<int>(
          launch_tc<1, 96, 4, 3>(a, p, s));
    case 96:
    case 128: return static_cast<int>(launch_tc<2, 128, 2, 2>(a, p, s));
    case 256: return static_cast<int>(launch_tc<4, 64, 2, 2>(a, p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
