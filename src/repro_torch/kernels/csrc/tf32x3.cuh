// TF32 tensor-core products with a three-term split, and cp.async
// staging: the helpers that K1's float32 path (flash_attention/csrc),
// K4 (rwkv6_wkv/csrc/wkv_mma.cuh) and K5 (mamba2_ssd/csrc/ssd_mma.cuh)
// share.  common.load_library passes this directory to nvcc with -I, and
// each kernel's ops module lists this file among the headers it hashes,
// so an edit here rebuilds every library that includes it.
//
// Each product runs on mma.sync m16n8k8 in TF32 with every operand split
// as a = hi + lo (hi = cvt.rna.tf32(a), lo = a - hi, which the tensor cores
// read truncated to TF32) and the product taken as hi*lo + lo*hi + hi*hi
// with fp32 accumulation.  Plain TF32 keeps 11 significant bits, an error
// near 1e-3 on sums of a few dozen terms; the split's dropped terms are
// about 2^-21 of each product.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi rounded to TF32 (to nearest), lo the exact rest as
// an fp32 value; the tensor cores read only the top 19 bits of a TF32
// operand, so lo enters the products truncated to TF32 (an error of at
// most 2^-21 of x) at no instruction's cost
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The same split with hi rounded by two integer operations on the bit
// pattern, (x + 0x1000) & ~0x1fff: round to nearest, ties away from zero,
// at TF32's 10 mantissa bits, which is cvt.rna.tf32's result for every
// finite x (a NaN may come out as an infinity, and its lo as NaN).  K1's
// float32 kernels ran 15-21% faster on it than on cvt.rna
// (scripts/k1_fp32_variants.py, cvt_split).
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_bits(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b with both split: hi * hi into d, the cross terms lo * hi + hi * lo
// into dx (two accumulators: shorter dependency chains)
__device__ __forceinline__ void mma3(float (&d)[4], float (&dx)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(dx, al, bh);
  mma_tf32(dx, ah, bl);
  mma_tf32(d, ah, bh);
}

// a b with both split into one accumulator: the cross terms first, then
// hi * hi
__device__ __forceinline__ void mma3_acc(float (&d)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// A fragment of m16n8k8 from four values: rows g, g+8; columns tig, tig+4
__device__ __forceinline__ void split_a(float v0, float v1, float v2,
                                        float v3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(v0, hi[0], lo[0]);
  split(v1, hi[1], lo[1]);
  split(v2, hi[2], lo[2]);
  split(v3, hi[3], lo[3]);
}

__device__ __forceinline__ void split_a_bits(float v0, float v1, float v2,
                                             float v3, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bits(v0, hi[0], lo[0]);
  split_bits(v1, hi[1], lo[1]);
  split_bits(v2, hi[2], lo[2]);
  split_bits(v3, hi[3], lo[3]);
}

// 16-byte (or 4-byte) copy to shared memory; zero fill when !full
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a),
               "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
