// Local 2-D cost volume on Hopper (sm_90a), forward only.
//
// Replaces: rpeflow_tpu/ops/pallas/correlation.py : correlation2d_pallas
// (_corr_kernel), which keeps an f1 row tile and a haloed f2 slab in VMEM and
// emits every displacement channel in one pass.
//
// out[b, y, x, (dy + d) * (2d + 1) + (dx + d)]
//     = (1 / C) * sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c],
// with f2 read as zero outside the frame; channels-last in and out.
//
// What bounds it on the H100: every f1 value meets (2d + 1)^2 = 81 f2 values,
// so read from device memory once the op is 81 multiply-adds per 8 bytes,
// far below the FP32 roofline's bytes; what limits a direct version is the
// 81x re-read of f2. The shared-memory loads that feed the FMAs are the
// bound here.
//
// Design: one block per (batch, 4-row x 16-column pixel tile). Channels are
// walked in chunks of 32: each chunk stages the f1 tile and the f2 tile with
// its +-d halo in shared memory, transposed to [channel][row][column] so the
// threads of a warp (neighbouring columns) read neighbouring banks. Each of
// the 256 threads owns one pixel and every fourth displacement (at most 21
// accumulators in registers), so device memory sees f1 once, f2 about
// (4 + 2d)(16 + 2d) / 64 times, and the output once. The sum is divided by C
// at the end, as the plain version does.

#include <cuda_runtime.h>

namespace {

constexpr int kTH = 4;          // output rows per block
constexpr int kTW = 16;         // output columns per block
constexpr int kPix = kTH * kTW;
constexpr int kGroups = 4;      // displacement groups per pixel
constexpr int kThreads = kPix * kGroups;
constexpr int kMaxD = 4;
constexpr int kMaxK = (2 * kMaxD + 1) * (2 * kMaxD + 1);
constexpr int kPerThread = (kMaxK + kGroups - 1) / kGroups;
constexpr int kCC = 32;         // channels per shared-memory chunk
constexpr int kHaloRows = kTH + 2 * kMaxD;
constexpr int kHaloCols = kTW + 2 * kMaxD;
constexpr int kF2Plane = kHaloRows * kHaloCols + 1;  // +1: conflict-free stores
constexpr int kF1Plane = kPix + 1;

__global__ void __launch_bounds__(kThreads)
corr_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
            float* __restrict__ out, int h, int w, int c, int d) {
  __shared__ float s_f1[kCC * kF1Plane];
  __shared__ float s_f2[kCC * kF2Plane];

  const int side = 2 * d + 1;
  const int nk = side * side;
  const int halo_rows = kTH + 2 * d;
  const int halo_cols = kTW + 2 * d;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int p = tid % kPix;
  const int g = tid / kPix;
  const int py = p / kTW;
  const int px = p % kTW;

  int off[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = g + j * kGroups;
    off[j] = (k < nk) ? (k / side) * kHaloCols + (k % side) : 0;
  }
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;

  const size_t img = (size_t)b * h * w;
  for (int c0 = 0; c0 < c; c0 += kCC) {
    const int cc = min(kCC, c - c0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < kCC * halo_rows * halo_cols; e += kThreads) {
      const int ch = e % kCC;
      const int rc = e / kCC;
      const int col = rc % halo_cols;
      const int r = rc / halo_cols;
      const int gy = y0 - d + r;
      const int gx = x0 - d + col;
      float v = 0.0f;
      if (ch < cc && gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = f2[(img + (size_t)gy * w + gx) * c + c0 + ch];
      s_f2[ch * kF2Plane + r * kHaloCols + col] = v;
    }
    for (int e = tid; e < kCC * kPix; e += kThreads) {
      const int ch = e % kCC;
      const int q = e / kCC;
      const int gy = y0 + q / kTW;
      const int gx = x0 + q % kTW;
      float v = 0.0f;
      if (ch < cc && gy < h && gx < w)
        v = f1[(img + (size_t)gy * w + gx) * c + c0 + ch];
      s_f1[ch * kF1Plane + q] = v;
    }
    __syncthreads();
    for (int ch = 0; ch < cc; ++ch) {
      const float a = s_f1[ch * kF1Plane + p];
      const float* base = s_f2 + ch * kF2Plane + py * kHaloCols + px;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[j] += a * base[off[j]];
    }
  }

  const int y = y0 + py;
  const int x = x0 + px;
  if (y >= h || x >= w) return;
  float* o = out + (img + (size_t)y * w + x) * nk;
  const float inv = (float)c;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int k = g + j * kGroups;
    if (k < nk) o[k] = acc[j] / inv;
  }
}

}  // namespace

extern "C" int rpeflow_correlation2d(const float* f1, const float* f2, float* out,
                                     int b, int h, int w, int c, int d,
                                     void* stream) {
  if (d < 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, b);
  corr_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(f1, f2, out, h, w, c, d);
  return (int)cudaGetLastError();
}
