// RG-LRU of RecurrentGemma / Griffin for Hopper (sm_90a): one kernel, two
// front ends.  Per batch row and channel, from the given state h_0:
//   h_t = a_t * h_{t-1} + b_t,   a_t = exp(log_a_t),
// - plain front end (`rglru_launch`): log_a and b fp32 [B, S, W] given;
// - gated front end (`rglru_gated_launch`): log_a and b made in registers
//   from the gate pre-activations za = y W_a and zi = y W_i and the conv
//   output y (one type, fp32 or bf16, [B, S, W]) and fp32 [W] b_a, b_i and
//   lambda, as the reference's `_rglru_gates` (src/repro/models/rglru.py)
//   makes them:
//     r = sigmoid(za + b_a),  i = sigmoid(zi + b_i),
//     log_a = -8 softplus(lambda) r,  b = sqrt(max(1 - a^2, 1e-9)) (i y),
//   softplus as F.softplus (threshold 20).
// The inputs are read in place through one set of (shared) strides with a
// unit stride on W; the state fp32 [B, W] (h_0 in, h_S out, in place) and
// h fp32 [B, S, W] are contiguous.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan`
// (src/repro/kernels/rglru/rglru.py:31).  That grid walks chunks of 16
// steps as a sequential "arbitrary" axis with the running state in VMEM
// scratch, evaluates each chunk in log-space prefix form (cumulative log
// clipped at -60) to vectorise it, and starts from zero whatever the
// caller holds.  Here a thread keeps h in registers and walks S itself,
// from the given state; the prefix form's clipped terms are below fp32
// resolution, so the two agree within the reference's tolerance.  Each
// step is a rounded product and a rounded sum, as the reference's
// one-token step computes it, so a decode step (S == 1) matches that step
// up to expf's last bit; the gate arithmetic runs in the plain version's
// order, each sum and product rounded on its own (no contraction into
// FMAs), the division and square root to within 2 ulp.
//
// Bound on the H100: bytes, and at the decode step (S == 1: 2.1 MB at
// recurrentgemma-9b's batch 28) one round trip to device memory and, for
// the gated front end, the instructions of its gates, which at one CTA an
// SM no other warp hides.  So a thread owns 4 consecutive channels of one
// batch row and moves them with one 16-byte access a tensor (8 bytes for
// bf16 inputs), and the gates take no branching slow paths: 28 x 4096
// channels are a grid of 4 x 28 CTAs of 256 threads, one wave on the 132
// SMs, with no index division.  A thread starts every load of a step
// (with the state, and for the gated front end its channels' b_a, b_i and
// lambda) before any arithmetic, and over S > 1 keeps a ring of kDepth
// steps of loads in flight ahead of the serial walk: the loads of steps
// t+1 .. t+kDepth-1 are out before step t's recurrence, and step t's slot
// is refilled with step t+kDepth before it.  Where W is not a multiple of
// 4, or the strides or a base forbid vector accesses
// (`kernels/rglru/ops.py:launch_plan`), the same kernel moves one channel
// at a time, and a row's last thread takes only the channels left (the
// tail).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;    // channels a thread owns
constexpr int kDepth = 4;    // steps of loads in flight ahead of the walk

// The unsigned type of N bytes, which one load or store moves.
template <int N> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };

// kLanes consecutive channels of one row of a tensor, as stored: one
// 16-byte vector of fp32, 8 bytes of bf16.
template <typename T>
struct Quad {
  typename Bits<kLanes * sizeof(T)>::type raw;
  __device__ __forceinline__ float at(int c) const {
    return repro::to_f(reinterpret_cast<const T*>(&raw)[c]);
  }
};

// Channels [0, n) at p (n == kLanes on the vector route); the rest zero.
template <bool Vec, typename T>
__device__ __forceinline__ Quad<T> load4(const T* p, int n) {
  Quad<T> q;
  if constexpr (Vec) {
    q.raw = *reinterpret_cast<const decltype(q.raw)*>(p);
  } else {
    T* e = reinterpret_cast<T*>(&q.raw);
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      e[c] = c < n ? p[c] : repro::from_f<T>(0.f);
  }
  return q;
}

template <bool Vec>
__device__ __forceinline__ void store4(float* p, const float (&x)[kLanes],
                                       int n) {
  if constexpr (Vec) {
    typename Bits<kLanes * sizeof(float)>::type v;
    float* e = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int c = 0; c < kLanes; ++c) e[c] = x[c];
    *reinterpret_cast<decltype(v)*>(p) = v;
  } else {
#pragma unroll
    for (int c = 0; c < kLanes; ++c)
      if (c < n) p[c] = x[c];
  }
}

// The gates' division and square root take the hardware's reciprocal and
// reciprocal square root (2 ulp, no branch to a slow path); exponentials
// and logarithms are the accurate ones.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, __fadd_rn(1.f, expf(-x)));
}

struct Args {
  const void* x0;      // log_a (plain) or za (gated)
  const void* x1;      // b or zi
  const void* x2;      // y (gated only)
  const float* b_a;    // gated only, as the next two
  const float* b_i;
  const float* lam;
  float* state;
  float* h;
  int B, S, W;
  long long sb, ss;    // the inputs' batch and step strides, in elements
};

template <bool Gated, bool Vec, typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel(const Args a) {
  constexpr int kIn = Gated ? 3 : 2;
  const int w0 = (blockIdx.x * kThreads + threadIdx.x) * kLanes;
  if (w0 >= a.W) return;
  const long long row = blockIdx.y;
  const int n = min(kLanes, a.W - w0);
  const void* bases[3] = {a.x0, a.x1, a.x2};
  const T* in[kIn];
#pragma unroll
  for (int k = 0; k < kIn; ++k)
    in[k] = static_cast<const T*>(bases[k]) + row * a.sb + w0;
  float* out = a.h + row * a.S * a.W + w0;
  float* st = a.state + row * a.W + w0;

  // Every load of the first kDepth steps, the state and the channels'
  // parameters, before any arithmetic.
  Quad<T> ring[kDepth][kIn];
#pragma unroll
  for (int d = 0; d < kDepth; ++d)
    if (d < a.S) {
#pragma unroll
      for (int k = 0; k < kIn; ++k)
        ring[d][k] = load4<Vec>(in[k] + d * a.ss, n);
    }
  const Quad<float> h0 = load4<Vec>(st, n);
  Quad<float> pa, pi, pl;
  if constexpr (Gated) {
    pa = load4<Vec>(a.b_a + w0, n);
    pi = load4<Vec>(a.b_i + w0, n);
    pl = load4<Vec>(a.lam + w0, n);
  }

  float h[kLanes], neg_c[kLanes];
#pragma unroll
  for (int c = 0; c < kLanes; ++c) {
    h[c] = h0.at(c);
    if constexpr (Gated) {
      const float lam = pl.at(c);
      neg_c[c] = -8.f * (lam > 20.f ? lam : log1pf(expf(lam)));
    }
  }

  for (int t0 = 0; t0 < a.S; t0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int t = t0 + d;
      if (t >= a.S) break;
      float x[kIn][kLanes];
#pragma unroll
      for (int k = 0; k < kIn; ++k)
#pragma unroll
        for (int c = 0; c < kLanes; ++c) x[k][c] = ring[d][k].at(c);
      if (t + kDepth < a.S) {
#pragma unroll
        for (int k = 0; k < kIn; ++k)
          ring[d][k] = load4<Vec>(
              in[k] + static_cast<long long>(t + kDepth) * a.ss, n);
      }
#pragma unroll
      for (int c = 0; c < kLanes; ++c) {
        float av, b;
        if constexpr (Gated) {
          const float r = sigmoid(__fadd_rn(x[0][c], pa.at(c)));
          const float i = sigmoid(__fadd_rn(x[1][c], pi.at(c)));
          av = expf(__fmul_rn(neg_c[c], r));
          const float q = fmaxf(__fsub_rn(1.f, __fmul_rn(av, av)), 1e-9f);
          b = __fmul_rn(__fmul_rn(q, rsqrtf(q)), __fmul_rn(i, x[2][c]));
        } else {
          av = expf(x[0][c]);
          b = x[1][c];
        }
        h[c] = __fadd_rn(__fmul_rn(av, h[c]), b);
      }
      store4<Vec>(out + static_cast<long long>(t) * a.W, h, n);
    }
  }
  store4<Vec>(st, h, n);
}

template <bool Gated, typename T>
int launch(const Args& a, int vec, void* stream) {
  if (a.B < 1 || a.S < 1 || a.W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (a.W + kLanes - 1) / kLanes;
  const dim3 grid((groups + kThreads - 1) / kThreads, a.B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    rglru_kernel<Gated, true, T><<<grid, kThreads, 0, s>>>(a);
  else
    rglru_kernel<Gated, false, T><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// --- the backward of the gated front end ---------------------------------
//
// Gradients of h (and not of the final state) given dh, from the same
// inputs and h0 (a constant) and the forward's h, which gives h_{t-1} for
// t > 0.  Per channel, walking t from S - 1 down to 0 with the gates made
// again as the forward makes them:
//   g_t = dh_t + a_{t+1} g_{t+1}                 (the gradient reaching h_t)
//   dlog_a_t = g_t h_{t-1} a_t
//            - g_t (i y) a^2 / sqrt(1 - a^2)     (where 1 - a^2 > 1e-9; the
//                                                 clamp passes no gradient)
//   dza = dlog_a (-8 softplus(lambda)) r (1 - r),
//   dzi = g sqrt(max(1 - a^2, 1e-9)) y i (1 - i),
//   dy  = g sqrt(max(1 - a^2, 1e-9)) i,
// and the sums over B and S: d b_a = sum dza, d b_i = sum dzi, d lambda =
// -8 sigmoid(lambda) sum dlog_a r.
//
// g is linear in its carry, and every output of step t is g_t times
// factors of step t alone, so the sequence splits into chunks of Lc steps
// (`kernels/rglru/ops.py:bwd_plan`) walked side by side, in two launches:
//  1. `rglru_gated_bwd_local`, chunks 1 .. n - 1: each (row, chunk,
//     channel) walks its chunk backward from a zero carry and records the
//     carry it would pass on, L_c = a_{t0} g^_{t0}, and the product of a
//     over the chunk, P_c (za and dh read; chunk 0 passes nothing on);
//  2. `rglru_gated_bwd_kernel`: each (row, chunk, channel) makes its true
//     carry from the later chunks' records, C = L_c' + P_c' C from the
//     last chunk down, walks its chunk again from it and writes dza, dzi,
//     dy and its three sums in fp64 (`part`, a slot a row and chunk).
// A thread walks one channel and keeps a ring of kBwdDepth steps of loads
// in flight ahead of its walk (the inputs as stored, converted at use).
// The sums over B and the chunks are taken in the second launch without
// atomic sums: the last of a column's B x n CTAs to finish (a ticket,
// `last_to_arrive`) adds the slots in (row, chunk) order, in fp64.  The
// same inputs give the same bits.  Accesses are one element a thread,
// coalesced across a warp, whatever W, the strides or the bases.
//
// Bound on the H100: bytes.  At recurrentgemma-9b's training shape (B 8,
// S 512, W 4096, bf16 za, zi, y) it reads za, zi, y, h and dh and writes
// dza, dzi and dy once: ~335 MB, 0.1 ms at 3.35 TB/s.  What holds it back
// is memory latency with too few loads in flight: a walk of all S steps a
// thread would give B x W threads (128 CTAs here), one CTA an SM, each
// thread's next load waiting on its ring.  Chunks of 64 give 8 x 128 CTAs
// of the second launch, and the first reads only za and dh (~1.3x the
// bound's bytes in all).

// Steps of loads in flight ahead of a walk, and the CTAs an SM runs: a
// short ring keeps a thread's registers few enough for four CTAs of 256 an
// SM, and more threads in flight hide more of each step's latency than a
// deeper ring does (rings of 4 and 8 ran slower on the H100).
constexpr int kBwdDepth = 2;
constexpr int kBwdCtasPerSm = 4;

struct BwdArgs {
  const void* za;
  const void* zi;
  const void* y;
  const float* b_a;
  const float* b_i;
  const float* lam;
  const float* h0;     // [B, W], the initial state
  const float* h;      // [B, S, W], the forward's output
  const float* dh;     // [B, S, W]
  void* dza;           // [B, S, W] contiguous, the inputs' type
  void* dzi;
  void* dy;
  double* part;        // [3, B x n, W]: each (row, chunk)'s sums
  float* carry;        // [2, B x n, W]: L_c, then P_c
  unsigned int* tickets;
  float* d_b_a;        // [W]
  float* d_b_i;
  float* d_lam;
  int B, S, W;
  int chunk, chunks;   // Lc and n = ceil(S / Lc)
  long long sb, ss;    // the inputs' batch and step strides, in elements
};

__device__ __forceinline__ float sigmoid_acc(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float softplus_neg8(float lam) {
  return -8.f * (lam > 20.f ? lam : log1pf(expf(lam)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
    rglru_gated_bwd_local(const BwdArgs a) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= a.W) return;
  const int per = a.chunks - 1;
  const long long row = blockIdx.y / per;
  const int c = 1 + static_cast<int>(blockIdx.y % per);
  const int t0 = c * a.chunk, t1 = min(a.S, t0 + a.chunk);
  const T* za = static_cast<const T*>(a.za) + row * a.sb + w;
  const float* dh = a.dh + row * a.S * a.W + w;

  T rz[kBwdDepth];
  float rd[kBwdDepth];
#pragma unroll
  for (int d = 0; d < kBwdDepth; ++d) {
    const int t = t1 - 1 - d;
    if (t >= t0) {
      rz[d] = za[static_cast<long long>(t) * a.ss];
      rd[d] = dh[static_cast<long long>(t) * a.W];
    }
  }
  const float ba = a.b_a[w];
  const float neg_c = softplus_neg8(a.lam[w]);
  float carry = 0.f, prod = 1.f;
  for (int t1d = t1 - 1; t1d >= t0; t1d -= kBwdDepth) {
#pragma unroll
    for (int d = 0; d < kBwdDepth; ++d) {
      const int t = t1d - d;
      if (t < t0) break;
      const float zv = repro::to_f(rz[d]), dv = rd[d];
      if (t - kBwdDepth >= t0) {
        rz[d] = za[static_cast<long long>(t - kBwdDepth) * a.ss];
        rd[d] = dh[static_cast<long long>(t - kBwdDepth) * a.W];
      }
      const float av = expf(neg_c * sigmoid_acc(zv + ba));
      carry = av * (dv + carry);
      prod *= av;
    }
  }
  const long long o = (row * a.chunks + c) * a.W + w;
  a.carry[o] = carry;
  a.carry[static_cast<long long>(a.B) * a.chunks * a.W + o] = prod;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdCtasPerSm)
    rglru_gated_bwd_kernel(const BwdArgs a) {
  __shared__ bool last;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const bool live = w < a.W;
  const long long row = blockIdx.y / a.chunks;
  const int c = static_cast<int>(blockIdx.y % a.chunks);
  const long long slots = static_cast<long long>(a.B) * a.chunks;
  if (live) {
    const int t0 = c * a.chunk, t1 = min(a.S, t0 + a.chunk);
    // The carry into this chunk, from the later chunks' records.
    float carry = 0.f;
    for (int cc = a.chunks - 1; cc > c; --cc) {
      const long long o = (row * a.chunks + cc) * a.W + w;
      carry = a.carry[o] + a.carry[slots * a.W + o] * carry;
    }
    const T* in[3];
    const void* bases[3] = {a.za, a.zi, a.y};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      in[k] = static_cast<const T*>(bases[k]) + row * a.sb + w;
    const long long o = row * a.S * a.W + w;
    T* out[3] = {static_cast<T*>(a.dza) + o, static_cast<T*>(a.dzi) + o,
                 static_cast<T*>(a.dy) + o};

    // Step t's loads, as stored: za, zi, y; dh and h_{t-1}.
    T rx[kBwdDepth][3];
    float rf[kBwdDepth][2];
    auto load = [&](int t, T (&x)[3], float (&f)[2]) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        x[k] = in[k][static_cast<long long>(t) * a.ss];
      f[0] = a.dh[o + static_cast<long long>(t) * a.W];
      f[1] = t > 0 ? a.h[o + static_cast<long long>(t - 1) * a.W]
                   : a.h0[row * a.W + w];
    };
#pragma unroll
    for (int d = 0; d < kBwdDepth; ++d)
      if (t1 - 1 - d >= t0) load(t1 - 1 - d, rx[d], rf[d]);
    const float ba = a.b_a[w], bi = a.b_i[w], lam = a.lam[w];
    const float neg_c = softplus_neg8(lam);
    double s_a = 0.0, s_i = 0.0, s_l = 0.0;

    for (int t1d = t1 - 1; t1d >= t0; t1d -= kBwdDepth) {
#pragma unroll
      for (int d = 0; d < kBwdDepth; ++d) {
        const int t = t1d - d;
        if (t < t0) break;
        const float za = repro::to_f(rx[d][0]), zi = repro::to_f(rx[d][1]);
        const float yv = repro::to_f(rx[d][2]);
        const float dh = rf[d][0], hp = rf[d][1];
        if (t - kBwdDepth >= t0) load(t - kBwdDepth, rx[d], rf[d]);
        const float r = sigmoid_acc(za + ba);
        const float i = sigmoid_acc(zi + bi);
        const float av = expf(neg_c * r);
        const float q = 1.f - av * av;
        const float s = sqrtf(fmaxf(q, 1e-9f));
        const float g = dh + carry;
        const float xin = i * yv;
        float dla = g * hp * av;
        if (q > 1e-9f) dla -= g * xin * (av * av / s);
        const float dxin = g * s;
        const float dza = dla * neg_c * (r * (1.f - r));
        const float dzi = dxin * yv * (i * (1.f - i));
        const long long ot = static_cast<long long>(t) * a.W;
        out[0][ot] = repro::from_f<T>(dza);
        out[1][ot] = repro::from_f<T>(dzi);
        out[2][ot] = repro::from_f<T>(dxin * i);
        s_a += static_cast<double>(dza);
        s_i += static_cast<double>(dzi);
        s_l += static_cast<double>(dla * r);
        carry = av * g;
      }
    }
    const long long pw = (row * a.chunks + c) * a.W + w;
    a.part[pw] = s_a;
    a.part[slots * a.W + pw] = s_i;
    a.part[2 * slots * a.W + pw] = s_l * (-8.0 * sigmoid_acc(lam));
  }
  // The last of the column's B x n CTAs adds the slots in (row, chunk)
  // order.
  if (!repro::last_to_arrive(a.tickets + blockIdx.x,
                             static_cast<unsigned>(slots), &last) ||
      !live)
    return;
  float* outs[3] = {a.d_b_a, a.d_b_i, a.d_lam};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double acc = 0.0;
    for (long long sl = 0; sl < slots; ++sl)
      acc += a.part[(k * slots + sl) * a.W + w];
    outs[k][w] = static_cast<float>(acc);
  }
}

template <typename T>
int launch_bwd(const BwdArgs& a, void* stream) {
  if (a.B < 1 || a.S < 1 || a.W < 1 || a.chunk < 1 ||
      a.chunks != (a.S + a.chunk - 1) / a.chunk ||
      static_cast<long long>(a.B) * a.chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned cols = (a.W + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.chunks > 1) {
    rglru_gated_bwd_local<T><<<dim3(cols, a.B * (a.chunks - 1)), kThreads,
                               0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_gated_bwd_kernel<T><<<dim3(cols, a.B * a.chunks), kThreads, 0, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rglru_launch(const void* log_a, const void* b, void* state,
                            void* h, int B, int S, int W, long long sb,
                            long long ss, int vec, void* stream) {
  const Args a{log_a, b, nullptr, nullptr, nullptr, nullptr,
               static_cast<float*>(state), static_cast<float*>(h),
               B, S, W, sb, ss};
  return launch<false, float>(a, vec, stream);
}

extern "C" int rglru_gated_launch(const void* za, const void* zi,
                                  const void* y, const void* b_a,
                                  const void* b_i, const void* lam,
                                  void* state, void* h, int dtype, int B,
                                  int S, int W, long long sb, long long ss,
                                  int vec, void* stream) {
  const Args a{za, zi, y, static_cast<const float*>(b_a),
               static_cast<const float*>(b_i), static_cast<const float*>(lam),
               static_cast<float*>(state), static_cast<float*>(h),
               B, S, W, sb, ss};
  if (dtype == repro::kFloat32) return launch<true, float>(a, vec, stream);
  if (dtype == repro::kBFloat16)
    return launch<true, __nv_bfloat16>(a, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward of `rglru_gated_launch` given dh fp32 [B, S, W] contiguous:
// the inputs as there, h0 the state before the forward and h its output
// (fp32, contiguous), in chunks of `chunk` steps (n = ceil(S / chunk)).
// Writes dza, dzi and dy ([B, S, W] contiguous, the inputs' type) and
// d_b_a, d_b_i and d_lam (fp32 [W]); `part` holds 3 x B x n x W fp64 and
// `carry` 2 x B x n x W fp32, `tickets` ceil(W / 256) zeroed counters (zero
// again after the launch).  Two kernel launches where n > 1, else one.
extern "C" int rglru_gated_bwd_launch(
    const void* za, const void* zi, const void* y, const void* b_a,
    const void* b_i, const void* lam, const void* h0, const void* h,
    const void* dh, void* dza, void* dzi, void* dy, void* part, void* carry,
    void* tickets, void* d_b_a, void* d_b_i, void* d_lam, int dtype, int B,
    int S, int W, int chunk, long long sb, long long ss, void* stream) {
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{za, zi, y, static_cast<const float*>(b_a),
                  static_cast<const float*>(b_i),
                  static_cast<const float*>(lam),
                  static_cast<const float*>(h0),
                  static_cast<const float*>(h),
                  static_cast<const float*>(dh), dza, dzi, dy,
                  static_cast<double*>(part), static_cast<float*>(carry),
                  static_cast<unsigned int*>(tickets),
                  static_cast<float*>(d_b_a), static_cast<float*>(d_b_i),
                  static_cast<float*>(d_lam), B, S, W, chunk,
                  (S + chunk - 1) / chunk, sb, ss};
  if (dtype == repro::kFloat32) return launch_bwd<float>(a, stream);
  if (dtype == repro::kBFloat16) return launch_bwd<__nv_bfloat16>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
