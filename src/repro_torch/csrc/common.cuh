// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel takes fp32 or bf16 storage, converts to fp32 on load and
// accumulates in fp32.  The host entry points are plain C functions (no
// PyTorch headers, so nvcc builds each file in seconds); they launch on the
// stream they are given, allocate nothing and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes passed by the Python wrappers.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

// Whether this CTA is the last of `n` to reach `counter` (a ticket on a
// device counter, zero before the first arrival).  Every thread's writes
// before the call are made visible to the other CTAs first (the CTA
// barrier, then thread 0's fence, which is cumulative); atomicInc wraps the
// counter back to 0 at the n-th arrival, so it is zero again for the next
// launch.  Every thread of the CTA calls it.
__device__ __forceinline__ bool last_to_arrive(unsigned int* counter,
                                               unsigned int n, bool* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicInc(counter, n - 1) == n - 1;
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

}  // namespace repro
