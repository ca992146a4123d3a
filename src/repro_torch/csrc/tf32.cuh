// fp32 products on the tensor cores for the port's mma.sync kernels
// (wkv6.cu, moe_gemm.cu): the 3xTF32 split, the m16n8k8 TF32 product, and
// the 16-byte cp.async copies that stage their operands.
//
// 3xTF32: x = big + small, big*big + big*small + small*big.  Each product
// errs by ~2^-20 relative, where plain TF32 keeps three decimal digits, so
// fp32 tolerances hold (tests/test_torch_moe.py emulates the split on the
// CPU over K = 2048).  The tensor core truncates the fp32 sums it keeps in
// its accumulator, so a kernel that sums thousands of products (moe_gemm's
// tile) starts each product from zero and adds it on the CUDA cores.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// A 16-byte copy that writes zeros instead when `valid` is false (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// x = big + small: big is x cut to TF32's 10 mantissa bits (one LOP3), small
// the exact rest, which the tensor core reads to its own top 10 bits.  The
// product big*big + big*small + small*big then errs by ~2^-20 relative, where
// cvt.rna.tf32 (several instructions on this target) would gain one bit.
template <int K>
struct Split {
  uint32_t big[K], small[K];
};

template <int K>
__device__ __forceinline__ Split<K> split(const float (&x)[K]) {
  Split<K> s;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s.big[i] = __float_as_uint(x[i]) & 0xffffe000u;
    s.small[i] = __float_as_uint(x[i] - __uint_as_float(s.big[i]));
  }
  return s;
}

// x = big + small with both parts rounded to the nearest TF32 value (the
// magnitude's half up, as cvt.rna; two integer instructions a part): small
// is then exactly what the tensor core reads, and a product's error leans
// neither way, where `split`'s truncations bias it toward zero (for sums
// whose terms' errors add up).
template <int K>
__device__ __forceinline__ Split<K> split_rn(const float (&x)[K]) {
  Split<K> s;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    s.big[i] = (__float_as_uint(x[i]) + 0x1000u) & 0xffffe000u;
    s.small[i] =
        (__float_as_uint(x[i] - __uint_as_float(s.big[i])) + 0x1000u) &
        0xffffe000u;
  }
  return s;
}

// d += a b for one m16n8k8 tile.  Fragments (g = lane / 4, t = lane % 4):
// a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, col g), b1 (t + 4, g); d0 (row g, col 2t), d1 (g, 2t + 1),
// d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b at fp32 accuracy: big * big into `hi`, the cross terms into `lo`
// (two accumulators, so that a run of products forms two short dependency
// chains; the caller adds them, or passes one accumulator for both).
// EXACT_A (EXACT_B): a (b) is exactly TF32 (bf16 values), so its small
// part is zero and one cross term drops.
template <bool EXACT_A = false, bool EXACT_B = false>
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const Split<4>& a, const Split<2>& b) {
  if constexpr (!EXACT_A) mma_tf32(lo, a.small, b.big);
  if constexpr (!EXACT_B) mma_tf32(lo, a.big, b.small);
  mma_tf32(hi, a.big, b.big);
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += x[i];
}

}  // namespace repro
