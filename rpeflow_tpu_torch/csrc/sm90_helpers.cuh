// Device helpers shared by the Hopper kernels (gdfn.cu, mdta.cu, dwconv.cu): 3xTF32
// products on the tensor cores and asynchronous copies to shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// v = big + small: big is v rounded to TF32 (10 mantissa bits; integer ops,
// which run at full rate where cvt.rna.tf32 does not), small the exact f32
// remainder, which the tensor core reads truncated to TF32
// (|error| <= 2^-21 |v|).
__device__ __forceinline__ void split(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += a[i] @ b[j] over MT x NT tiles in 3xTF32: every tile's
// remainder products first, then the main ones, so that consecutive mma
// instructions never wait on each other's accumulator.
template <int MT, int NT>
__device__ __forceinline__ void mma3(float (&acc)[MT][NT][4], const uint32_t (&ab)[MT][4],
                                     const uint32_t (&as)[MT][4], const uint32_t (&bb)[NT][2],
                                     const uint32_t (&bs)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) mma(acc[i][j], as[i], bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) mma(acc[i][j], ab[i], bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i) mma(acc[i][j], ab[i], bb[j][0], bb[j][1]);
}

// 4-, 8- and 16-byte asynchronous copies to shared memory; zero-filled
// where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
