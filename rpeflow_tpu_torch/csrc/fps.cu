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
// is one chain of S dependent steps (S = 4096 at the flagship shape), each a
// block-wide min/argmax over N points. The latency of that chain, not
// bandwidth or FLOPs, sets the time, and only B blocks (8 at the flagship
// shape) are busy.
//
// Design: one block of 512 threads per batch row, so each step costs as
// few instructions, dependent latencies and barriers as possible:
//  * each thread holds its PPT points (i = tid + j * 512) and their running
//    minimum distance in registers (slots past N hold distance -1, never
//    chosen); a copy of the row's xyz in shared memory serves only the
//    broadcast read of the chosen point;
//  * the argmax orders (d, -i): d >= 0, so its bits order like the floats.
//    A warp reduces it with two redux.sync instructions (the largest bits,
//    then the lowest index among the lanes that hold them) instead of
//    five levels of shuffles;
//  * one barrier per step: each warp's winner, packed as
//    (bits(d) << 32) | i, goes into a slot array that is double-buffered by
//    step parity; after the barrier every warp reduces the 16 slots itself
//    (no second barrier, no idle warps), and thread 0 writes the index.
// The squared distance is summed as (dx^2 + dy^2) + dz^2 with round-to-nearest
// intrinsics so nvcc cannot contract it into FMAs: the indices then match the
// plain PyTorch version bit for bit, where an FMA would flip argmax ties.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// (bits, index) of the lane with the largest bits, the lowest index on a tie
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  idx = __reduce_min_sync(0xffffffffu, bits == top ? idx : 0xffffffffu);
  bits = top;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, int n, int s, int* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  __shared__ unsigned long long slots[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = xyz + (size_t)b * n * 3;

  for (int i = tid; i < n; i += kThreads) {
    xs[i] = row[3 * i + 0];
    ys[i] = row[3 * i + 1];
    zs[i] = row[3 * i + 2];
  }
  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = tid + j * kThreads;
    px[j] = py[j] = pz[j] = 0.0f;
    dist[j] = -1.0f;
    if (i < n) {
      px[j] = row[3 * i + 0];
      py[j] = row[3 * i + 1];
      pz[j] = row[3 * i + 2];
      dist[j] = 1e10f;
    }
  }
  __syncthreads();

  int cur = 0;
  for (int it = 0; it < s; ++it) {
    if (tid == 0) out[(size_t)b * s + it] = cur;
    const float sx = xs[cur], sy = ys[cur], sz = zs[cur];
    float best = -1.0f;
    int best_j = 0;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = px[j] - sx;
      const float dy = py[j] - sy;
      const float dz = pz[j] - sz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[j], d);  // stays -1 past N
      dist[j] = m;
      if (m > best) {  // i grows with j, so the first index keeps a tie
        best = m;
        best_j = j;
      }
    }
    // a thread with no point holds bits 0 and the largest index, below
    // every real point (whose d >= 0)
    unsigned bits = best >= 0.0f ? __float_as_uint(best) : 0u;
    unsigned idx = best >= 0.0f ? (unsigned)(tid + best_j * kThreads) : 0xffffffffu;
    warp_argmax(bits, idx);
    if (lane == 0) slots[it & 1][warp] = ((unsigned long long)bits << 32) | idx;
    __syncthreads();
    const unsigned long long other = lane < kWarps ? slots[it & 1][lane] : 0ull;
    bits = (unsigned)(other >> 32);
    idx = lane < kWarps ? (unsigned)other : 0xffffffffu;
    warp_argmax(bits, idx);
    cur = (int)idx;
  }
}

template <int PPT>
int launch(const float* xyz, int b, int n, int s, int* out, cudaStream_t st) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PPT><<<b, kThreads, smem, st>>>(xyz, n, s, out);
  return (int)cudaGetLastError();
}

}  // namespace

// n <= 32 * 512 (the wrapper checks)
extern "C" int rpeflow_fps(const float* xyz, int b, int n, int s, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= kThreads) return launch<1>(xyz, b, n, s, out, st);
  if (n <= 2 * kThreads) return launch<2>(xyz, b, n, s, out, st);
  if (n <= 4 * kThreads) return launch<4>(xyz, b, n, s, out, st);
  if (n <= 8 * kThreads) return launch<8>(xyz, b, n, s, out, st);
  if (n <= 16 * kThreads) return launch<16>(xyz, b, n, s, out, st);
  if (n <= 32 * kThreads) return launch<32>(xyz, b, n, s, out, st);
  return (int)cudaErrorInvalidValue;
}
