// Gated depthwise-conv feed-forward (GDFN) on Hopper (sm_90a), forward only.
//
// Replaces: rpeflow_tpu/ops/pallas/gdfn.py : gdfn_pallas (_gdfn_kernel).
// For x [B, H, W, C], w_in [C, 2h], w_dw [3, 3, 2h], w_out [h, C]:
//   hid = x @ w_in                          1x1 conv, no bias
//   a   = dw3x3(hid), zero padding          exact zeros: hid has no bias
//   g   = gelu(a[..., :h]) * a[..., h:]     exact GELU through erff
//   y   = g @ w_out
// held to rpeflow_tpu/nn/mdta.py : _gdfn_ref (the Pallas kernel's own erf is
// a rational approximation; this one is not).
//
// What bounds it on the H100: the two products are 2 * 3 * C * 2h FLOPs per
// pixel (C = 192, 2h = 1020: ~1.2 MFLOP), the depthwise conv and the gate a
// few FLOPs per byte of the 2h-wide hidden map. With the hidden map staged
// through device memory (below) the 2h-wide write and 9-tap read dominate.
//
// Design, first version: the hidden width reaches 2h = 1020 at C = 192, so a
// 3-row x W x 2h slab does not fit a block's shared memory; hid and g are
// staged through device memory instead, in three launches:
//  1. gemm_kernel: hid = x @ w_in, a 64 x 64 output tile per block with
//     16-deep operand tiles in shared memory and 4 x 4 outputs per thread;
//  2. dw_gelu_kernel: one thread per (pixel, hidden channel) sums both 3x3
//     windows (gate and value halves) and writes g;
//  3. gemm_kernel again: y = g @ w_out.
// A fused version that keeps a pixel tile's hidden slab on chip, chunked
// over hidden channels, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kGemmThreads = 256;

// C[M, N] = A[M, K] @ B[K, N], all row-major f32.
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ bm,
            float* __restrict__ cm, long long m, int n, int k) {
  __shared__ float s_a[kBK][kBM + 4];
  __shared__ float s_b[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // output rows tr*4 .. tr*4+3
  const int tc = tid % 16;  // output cols tc*4 .. tc*4+3
  const long long row0 = (long long)blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBK) {
    __syncthreads();
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      const int r = e / kBK;
      const int kk = e % kBK;
      const long long gr = row0 + r;
      s_a[kk][r] = (gr < m && k0 + kk < k) ? a[gr * k + k0 + kk] : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kGemmThreads) {
      const int kk = e / kBN;
      const int cc = e % kBN;
      s_b[kk][cc] = (k0 + kk < k && col0 + cc < n) ? bm[(long long)(k0 + kk) * n + col0 + cc]
                                                   : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s_a[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[kk][tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gr = row0 + tr * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tc * 4 + j;
      if (gc < n) cm[gr * n + gc] = acc[i][j];
    }
  }
}

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// g[pix, ch] = gelu(dw(hid)[pix, ch]) * dw(hid)[pix, hidden + ch]
__global__ void dw_gelu_kernel(const float* __restrict__ hid, const float* __restrict__ w_dw,
                               float* __restrict__ g, int b, int h, int w, int hidden) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)b * h * w * hidden;
  if (e >= total) return;
  const int ch = (int)(e % hidden);
  const long long pix = e / hidden;
  const int xx = (int)(pix % w);
  const int yy = (int)((pix / w) % h);
  const long long img = pix - ((long long)yy * w + xx);
  const int h2 = 2 * hidden;
  float a0 = 0.0f, a1 = 0.0f;
  for (int di = 0; di < 3; ++di) {
    const int sy = yy + di - 1;
    if (sy < 0 || sy >= h) continue;
    for (int dj = 0; dj < 3; ++dj) {
      const int sx = xx + dj - 1;
      if (sx < 0 || sx >= w) continue;
      const float* src = hid + (img + (long long)sy * w + sx) * h2;
      const float* t = w_dw + (di * 3 + dj) * h2;
      a0 += src[ch] * t[ch];
      a1 += src[hidden + ch] * t[hidden + ch];
    }
  }
  g[e] = gelu_exact(a0) * a1;
}

int launch_gemm(const float* a, const float* bm, float* cm, long long m, int n, int k,
                cudaStream_t st) {
  dim3 grid((n + kBN - 1) / kBN, (unsigned)((m + kBM - 1) / kBM));
  gemm_kernel<<<grid, kGemmThreads, 0, st>>>(a, bm, cm, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: hid (P * 2h floats) then g (P * h floats), P = B * H * W.
extern "C" int rpeflow_gdfn(const float* x, const float* w_in, const float* w_dw,
                            const float* w_out, float* out, float* scratch, int b,
                            int h, int w, int c, int hidden, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long pixels = (long long)b * h * w;
  float* hid = scratch;
  float* g = hid + pixels * 2 * hidden;
  int err = launch_gemm(x, w_in, hid, pixels, 2 * hidden, c, st);
  if (err != 0) return err;
  const long long total = pixels * hidden;
  dw_gelu_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(hid, w_dw, g, b, h, w,
                                                                    hidden);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_gemm(g, w_out, out, pixels, c, hidden, st);
}
