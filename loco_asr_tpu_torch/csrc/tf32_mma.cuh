// Helpers shared by the tensor-core flash kernels (csrc/flash_causal.cu,
// csrc/flash_rel.cu, csrc/flash_rel_bwd.cu): three-pass TF32 products on
// mma.sync, 16- and 4-byte cp.async copies, quad reductions, and the
// once-per-device shared-memory attribute.  Included, never compiled on its
// own.
//
// Three-pass TF32 products.  A float x is split into big = x rounded to
// TF32 (to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds a
// finite value) and small = x - big, which is exact in f32; the mma reads
// only the top 19 bits of each TF32 operand, so it truncates small.  a.b is
// then small_a.big_b + big_a.small_b + big_a.big_b, accumulated in f32: the
// dropped small.small term and the truncated bits of small are ~2^-21 of
// the product, so the result is as accurate as an f32 product to within a
// few ulp, while one TF32 product keeps only ~2^-11.  This is CUTLASS's
// OpMultiplyAddFastF32 split, which PyTorch's f32 memory-efficient
// attention uses; rounding big with two integer ops and leaving small raw
// costs 3 instructions a value, fewer than two cvt.rna.tf32.f32, which
// sm_90 runs as instruction sequences.
//
// m16n8k8 fragments (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

// x -> (big, small) as mma operands; x finite
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a.b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in f32 accuracy: the two cross terms first, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4],
                                           const unsigned (&b_big)[2],
                                           const unsigned (&b_small)[2]) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; zero when !valid (for rows of
// floats whose starts are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>   // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// max and sum over the 4 lanes of a quad (the lanes that share a C row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Raises a kernel's dynamic shared-memory limit once per device: to
// ``bytes``, or with ``bytes`` <= 0 to the most a block may opt in to on
// the device.  ``done`` holds one bit per device (devices >= 64 set it on
// every call).  Called before every launch; after the first it costs one
// cudaGetDevice.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, int bytes,
                            std::atomic<unsigned long long>& done) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  if (bytes <= 0) {
    e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace
