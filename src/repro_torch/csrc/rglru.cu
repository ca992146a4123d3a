// RG-LRU linear recurrence of RecurrentGemma / Griffin for Hopper (sm_90a).
// Per batch row and channel:
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   from the given h_0,
// log_a and b fp32 [B, S, W] read in place through their (shared) strides
// with a unit stride on W, the state fp32 [B, W] (h_0 in, h_S out, in
// place), h fp32 [B, S, W] contiguous.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan`
// (src/repro/kernels/rglru/rglru.py:31).  That grid walks chunks of 16
// steps as a sequential "arbitrary" axis with the running state in VMEM
// scratch, evaluates each chunk in log-space prefix form (cumulative log
// clipped at -60) to vectorise it, and starts from zero whatever the
// caller holds.  Here one thread owns one (batch, channel), keeps h in a
// register and walks S itself, starting from the given state; the prefix
// form's clipped terms are below fp32 resolution, so the two agree within
// the reference's tolerance.  Each step is a rounded product and a rounded
// sum, as the reference's one-token step computes it, so a decode step
// (S == 1) matches that step up to expf's last bit.
//
// Bound on the H100: bytes.  Every element of log_a, b and h is touched
// once (loads coalesced across W, consecutive threads on consecutive
// channels), plus the state read and written once.  recurrentgemma-9b at
// batch 28 has 114,688 channels: 448 CTAs of 256 threads, one wave on the
// 132 SMs.  The loads of step t do not depend on h, so unrolling the walk
// keeps several in flight per thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ b, float* __restrict__ state,
                      float* __restrict__ h, int S, int W, long long sb,
                      long long ss) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const float* la = log_a + row * sb + w;
  const float* bb = b + row * sb + w;
  float* out = h + row * S * W + w;
  float* st = state + row * W + w;
  float hv = *st;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    hv = __fadd_rn(__fmul_rn(expf(la[t * ss]), hv), bb[t * ss]);
    out[static_cast<long long>(t) * W] = hv;
  }
  *st = hv;
}

}  // namespace

extern "C" int rglru_launch(const void* log_a, const void* b, void* state,
                            void* h, int B, int S, int W, long long sb,
                            long long ss, void* stream) {
  if (B < 1 || S < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<float*>(state), static_cast<float*>(h), S, W, sb, ss);
  return static_cast<int>(cudaGetLastError());
}
