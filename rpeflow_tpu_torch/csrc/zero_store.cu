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
// Design: the grid is the Pallas grid, one block per (b, tile of th rows),
// 36 blocks at the default shape, so each block has 1024 threads to keep
// enough stores in flight. A tile of an NHWC map is th * W * C contiguous
// floats, which the block writes as 16-byte stores when the tile's length
// and base allow it (every W * C that is a multiple of 4), else as 4-byte
// stores. The caller guarantees H % th == 0 (the Pallas grid never writes
// rows past (H // th) * th; the wrapper refuses such a shape).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
zero_tile_kernel(float* __restrict__ out, long long tile_elems, int vec4) {
  const long long tile = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  float* base = out + tile * tile_elems;
  if (vec4) {
    float4* v = reinterpret_cast<float4*>(base);
    const long long n4 = tile_elems / 4;
    for (long long k = threadIdx.x; k < n4; k += kThreads) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (long long k = threadIdx.x; k < tile_elems; k += kThreads) base[k] = 0.f;
  }
}

}  // namespace

// out [B, H, W, C] float32; row_elems = W * C; th divides H
extern "C" int rpeflow_zero_store(float* out, long long b, long long h, long long row_elems,
                                  int th, void* stream) {
  if (th <= 0 || h % th != 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || row_elems == 0) return 0;
  const long long tile_elems = th * row_elems;
  const int vec4 = tile_elems % 4 == 0 && ((uintptr_t)out) % 16 == 0;
  const dim3 grid((unsigned)(h / th), (unsigned)b);
  zero_tile_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(out, tile_elems, vec4);
  return (int)cudaGetLastError();
}
