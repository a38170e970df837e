// Furthest point sampling on Hopper (sm_90a).
//
// Replaces: rpeflow_tpu/ops/pallas/fps.py : furthest_point_sampling_pallas
// (_fps_kernel), which runs the whole sequential selection inside one TPU
// program with the coordinates resident in VMEM.
//
// Semantics (rpeflow_tpu/ops/fps.py : furthest_point_sampling_scan): start at
// index 0; the min-distance field starts at 1e10; each step folds in
// min(d, |p - p_last|^2) and picks the argmax, the lowest index winning ties.
//
// What bounds it on the H100: the selection is sequential, so each batch row
// is one chain of S dependent steps (S = 4096 at the flagship shape). Each
// step is a block-wide min/argmax over N points followed by two barriers;
// the latency of that chain, not bandwidth or FLOPs, sets the time, and only
// B blocks (8 at the flagship shape) are busy.
//
// Design: one block of 1024 threads per batch row. The row's coordinates
// and its distance field live in dynamic shared memory (16 B per point,
// 128 KB at N = 8192), so after one load nothing touches device memory but
// the S output indices. The squared distance is summed as (dx^2 + dy^2) + dz^2
// with round-to-nearest intrinsics so nvcc cannot contract it into FMAs:
// the indices then match the plain PyTorch version bit for bit, where an
// FMA would flip argmax ties.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void argmax_pair(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int n, int s, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* dist = zs + n;
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_cur;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = xyz + (size_t)b * n * 3;

  for (int i = tid; i < n; i += kThreads) {
    xs[i] = row[3 * i + 0];
    ys[i] = row[3 * i + 1];
    zs[i] = row[3 * i + 2];
    dist[i] = 1e10f;
  }
  if (tid == 0) s_cur = 0;
  __syncthreads();

  for (int it = 0; it < s; ++it) {
    const int cur = s_cur;
    if (tid == 0) out[(size_t)b * s + it] = cur;
    const float sx = xs[cur], sy = ys[cur], sz = zs[cur];

    float best = -1.0f;
    int best_i = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float dx = xs[i] - sx;
      const float dy = ys[i] - sy;
      const float dz = zs[i] - sz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[i], d);
      dist[i] = m;
      if (m > best) {  // i grows, so the first index keeps a tie
        best = m;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      argmax_pair(best, best_i, ov, oi);
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = red_v[lane];
      best_i = red_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        argmax_pair(best, best_i, ov, oi);
      }
      if (lane == 0) s_cur = best_i;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int rpeflow_fps(const float* xyz, int b, int n, int s, int* out,
                           void* stream) {
  const size_t smem = (size_t)4 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(xyz, n, s, out);
  return (int)cudaGetLastError();
}
