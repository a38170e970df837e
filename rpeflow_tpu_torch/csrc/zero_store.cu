// Zero store on Hopper (sm_90a).
//
// Replaces: triage/repro_xla_custom_call.py : pallas_zero (zero_kernel), a
// kernel that stores only zeros over [B, H, W, C] f32, one (1, th, W, C)
// tile per grid step (B, H // th). It exists to put a custom kernel whose
// value cannot matter into a conv graph (the repro of that script); the
// port's counterpart does the same for scripts/torch_repro_custom_call.py.
//
// What bounds it on the H100: bytes. The function reads no byte of its
// input (the zeros do not depend on it) and writes B * H * W * C floats:
// 70.8 MB at the default [2, 144, 240, 256], 21.1 us at 3.35 TB/s.
//
// Design: the zeros do not depend on the tiling, so the grid is not the
// Pallas grid (which gave 36 blocks of the 132 SMs at the default shape,
// about 96 SMs storing nothing) but the whole B * H * W * C span cut in
// 16 KB pieces, one a block of 256 threads, each thread storing four
// 16-byte words 4 KB apart (a warp: four 512-byte runs): 4,320 blocks at the
// default shape, eight resident on each SM at a time. The last n % 4 floats
// are 4-byte stores of block 0. A base that is not 16-byte aligned takes
// 4-byte stores throughout, 4 KB a block. (Measured against this, in
// PERF.md: a persistent grid of 1 to 64 blocks an SM walking the span, and
// one issuing TMA bulk stores from a zeroed shared-memory tile, were 5-30%
// slower.) The caller guarantees H % th == 0: the Pallas grid never writes
// rows past (H // th) * th, so the wrapper refuses such a shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // stores a thread
constexpr long long kPerBlock = (long long)kThreads * kPerThread;

// vec4: `out` is 16-byte aligned; the span's n / 4 words are stored as
// float4, the rest as floats. Otherwise all n as floats.
__global__ void __launch_bounds__(kThreads)
zero_store_kernel(float* __restrict__ out, long long n, int vec4) {
  const long long base = blockIdx.x * kPerBlock + threadIdx.x;
  if (vec4) {
    const long long words = n / 4;
    float4* v = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (base + j * kThreads < words) v[base + j * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (blockIdx.x == 0 && threadIdx.x < n - words * 4) out[words * 4 + threadIdx.x] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (base + j * kThreads < n) out[base + j * kThreads] = 0.f;
  }
}

}  // namespace

// out: n float32
extern "C" int rpeflow_zero_store(float* out, long long n, void* stream) {
  if (n == 0) return 0;
  const int vec4 = ((uintptr_t)out) % 16 == 0;
  const long long units = vec4 ? n / 4 : n;
  const long long blocks = units > kPerBlock ? (units + kPerBlock - 1) / kPerBlock : 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  zero_store_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(out, n, vec4);
  return (int)cudaGetLastError();
}
