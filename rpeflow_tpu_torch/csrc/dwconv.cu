// Depthwise kh x 3 convolution on Hopper (sm_90a): forward and taps gradient.
//
// Replaces: rpeflow_tpu/ops/pallas/dwconv.py : dwconv_pallas (_dw_kernel).
// For x [B, H, W, C] and taps [kh, 3, C] (kh = 3 for 2-D maps, kh = 1 for
// point maps entering as [B, 1, N, C]):
//   out[b, y, x, c] = sum_{i, j} x[b, y + i - kh/2, x + j - 1, c] * taps[i, j, c]
// zero padding, no bias, held to rpeflow_tpu/nn/mdta.py : _dw_flat.
//
// The port's MDTA and GDFN backwards (ops/dwconv.py) use it three ways: the
// forward, the input gradient (the same conv of the output gradient with the
// taps rotated by 180 degrees, exact for a stride-1 zero-padded
// cross-correlation), and the taps gradient
//   dtaps[i, j, c] = sum_{b, y, x} g[b, y, x, c] * x[b, y + i - kh/2, x + j - 1, c]
// which is the second entry point here.
//
// What bounds it on the H100: 2 * 9 FLOPs per output element against at
// least 8 bytes of traffic (one read of x, one write of out), so it is
// bandwidth-bound; the taps gradient reads two maps for 18 FLOPs per element
// and writes only C * 9 numbers.
//
// Design, first version:
//  * forward: one thread computes kPix consecutive pixels of one row for one
//    channel; neighbouring threads take neighbouring channels, so a warp's
//    loads and stores are coalesced on the channels-last layout. A thread
//    loads the kPix + 2 columns of each of its kh rows once and reuses them
//    for its kPix outputs (18 loads for 4 outputs instead of 36); the rows
//    shared by vertically adjacent threads come from L1/L2.
//  * taps gradient: the TPU kernel's sequential grid could carry sums across
//    steps; Hopper blocks run in no order. A block takes 32 channels and 8
//    pixel lanes; each lane walks segments of kSeg columns of one row with a
//    sliding kh x 3 window of x in registers and accumulates the kh * 3
//    products per channel. The block sums its lanes in shared memory in a
//    fixed order and writes one partial per block; a second kernel sums the
//    partials in block order, so the result is deterministic (no atomics).

#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;        // forward: pixels per thread along W
constexpr int kThreads = 256;
constexpr int kCh = 32;        // taps gradient: channels per block
constexpr int kLanes = kThreads / kCh;
constexpr int kSeg = 32;       // taps gradient: columns per work unit
constexpr int kTargetBlocks = 1024;

template <int KH>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ taps,
              float* __restrict__ out, int h, int w, int c, int groups, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long pg = e / c;
  const int x0 = (int)(pg % groups) * kPix;
  const long long row = pg / groups;  // b * h + y
  const int yy = (int)(row % h);
  const long long row0 = row - yy;    // b * h

  float t[KH][3];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) t[i][j] = __ldg(taps + (i * 3 + j) * c + ch);

  float acc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p] = 0.0f;
#pragma unroll
  for (int i = 0; i < KH; ++i) {
    const int sy = yy + i - KH / 2;
    if (sy < 0 || sy >= h) continue;
    const float* src = x + (row0 + sy) * w * (long long)c + ch;
    float col[kPix + 2];
#pragma unroll
    for (int j = 0; j < kPix + 2; ++j) {
      const int sx = x0 + j - 1;
      col[j] = (sx >= 0 && sx < w) ? __ldg(src + (long long)sx * c) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < kPix; ++p)
      acc[p] += col[p] * t[i][0] + col[p + 1] * t[i][1] + col[p + 2] * t[i][2];
  }
  float* dst = out + row * w * (long long)c + ch;
#pragma unroll
  for (int p = 0; p < kPix; ++p)
    if (x0 + p < w) dst[(long long)(x0 + p) * c] = acc[p];
}

// Work units per block of the taps gradient; a unit is kSeg columns of one row.
long long taps_units_per_block(int b, int h, int w, int c) {
  const long long units = (long long)b * h * ((w + kSeg - 1) / kSeg);
  const int cblocks = (c + kCh - 1) / kCh;
  long long nb = (kTargetBlocks + cblocks - 1) / cblocks;
  const long long max_nb = (units + kLanes - 1) / kLanes;  // >= one unit per lane
  if (nb > max_nb) nb = max_nb;
  if (nb < 1) nb = 1;
  return (units + nb - 1) / nb;
}

template <int KH>
__global__ void __launch_bounds__(kThreads)
dw_taps_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ part, int h, int w, int c, long long units,
               long long units_per_block) {
  const int cc = threadIdx.x % kCh;
  const int lane = threadIdx.x / kCh;
  const int ch = blockIdx.x * kCh + cc;
  const int segs = (w + kSeg - 1) / kSeg;

  float acc[KH][3];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = 0.0f;

  if (ch < c) {
    const long long u0 = (long long)blockIdx.y * units_per_block;
    const long long u1 = u0 + units_per_block < units ? u0 + units_per_block : units;
    for (long long u = u0 + lane; u < u1; u += kLanes) {
      const long long row = u / segs;  // b * h + y
      const int xs = (int)(u % segs) * kSeg;
      const int xe = xs + kSeg < w ? xs + kSeg : w;
      const int yy = (int)(row % h);
      const long long row0 = row - yy;
      const float* src[KH];
      bool ok[KH];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        const int sy = yy + i - KH / 2;
        ok[i] = sy >= 0 && sy < h;
        src[i] = x + (row0 + (ok[i] ? sy : yy)) * w * (long long)c + ch;
      }
      float win[KH][3];
#pragma unroll
      for (int i = 0; i < KH; ++i) {
        win[i][0] = (ok[i] && xs >= 1) ? __ldg(src[i] + (long long)(xs - 1) * c) : 0.0f;
        win[i][1] = ok[i] ? __ldg(src[i] + (long long)xs * c) : 0.0f;
      }
      const float* gp = g + row * w * (long long)c + ch;
      for (int xx = xs; xx < xe; ++xx) {
#pragma unroll
        for (int i = 0; i < KH; ++i)
          win[i][2] = (ok[i] && xx + 1 < w) ? __ldg(src[i] + (long long)(xx + 1) * c) : 0.0f;
        const float gv = __ldg(gp + (long long)xx * c);
#pragma unroll
        for (int i = 0; i < KH; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) acc[i][j] += gv * win[i][j];
          win[i][0] = win[i][1];
          win[i][1] = win[i][2];
        }
      }
    }
  }

  __shared__ float s_acc[kLanes][KH * 3][kCh];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s_acc[lane][i * 3 + j][cc] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < KH * 3 * kCh; e += kThreads) {
    const int tap = e / kCh;
    const int ec = e % kCh;
    const int gch = blockIdx.x * kCh + ec;
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += s_acc[l][tap][ec];
    if (gch < c) part[((long long)blockIdx.y * KH * 3 + tap) * c + gch] = s;
  }
}

// out[j] = sum_n part[n, j] over n in order, j < m.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int n, int m) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += part[(long long)i * m + j];
  out[j] = s;
}

}  // namespace

extern "C" int rpeflow_dwconv(const float* x, const float* taps, float* out, int b, int h,
                              int w, int c, int kh, void* stream) {
  if (kh != 1 && kh != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = (w + kPix - 1) / kPix;
  const long long total = (long long)b * h * groups * c;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (kh == 3)
    dw_fwd_kernel<3><<<blocks, kThreads, 0, st>>>(x, taps, out, h, w, c, groups, total);
  else
    dw_fwd_kernel<1><<<blocks, kThreads, 0, st>>>(x, taps, out, h, w, c, groups, total);
  return (int)cudaGetLastError();
}

// Blocks along the pixel axis of the taps gradient (the partials' leading
// extent): the scratch of rpeflow_dwconv_taps_grad holds blocks * kh * 3 * C floats.
extern "C" int rpeflow_dwconv_taps_blocks(int b, int h, int w, int c) {
  const long long units = (long long)b * h * ((w + kSeg - 1) / kSeg);
  const long long upb = taps_units_per_block(b, h, w, c);
  return (int)((units + upb - 1) / upb);
}

extern "C" int rpeflow_dwconv_taps_grad(const float* x, const float* g, float* dtaps,
                                        float* scratch, int b, int h, int w, int c, int kh,
                                        void* stream) {
  if (kh != 1 && kh != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long units = (long long)b * h * ((w + kSeg - 1) / kSeg);
  const long long upb = taps_units_per_block(b, h, w, c);
  const int nb = rpeflow_dwconv_taps_blocks(b, h, w, c);
  dim3 grid((c + kCh - 1) / kCh, nb);
  if (kh == 3)
    dw_taps_kernel<3><<<grid, kThreads, 0, st>>>(x, g, scratch, h, w, c, units, upb);
  else
    dw_taps_kernel<1><<<grid, kThreads, 0, st>>>(x, g, scratch, h, w, c, units, upb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = kh * 3 * c;
  sum_partials_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, st>>>(scratch, dtaps, nb, m);
  return (int)cudaGetLastError();
}
