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
