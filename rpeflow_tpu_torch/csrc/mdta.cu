// Fused MDTA front half on Hopper (sm_90a), forward only.
//
// Replaces: rpeflow_tpu/ops/pallas/mdta.py : mdta_qkv_pallas (_mdta_kernel).
// For x, y [B, H, W, C] (point maps enter as [B, 1, N, C]) it computes
//   xn = LN(x; lnx), yn = LN(y; lny)           channel LayerNorm, eps 1e-5
//   q = dw(xn; taps[..., :C]), k = dw(yn; taps[..., C:2C]),
//   v = dw(yn; taps[..., 2C:])                 depthwise kh x 3, zero padding
//   qk[b] = sum_t q_t^T k_t   [C, C]
//   sq[b] = (sum_t q_t^2, sum_t k_t^2)   [2, C]
// The zero padding of the depthwise conv applies to the LayerNorm OUTPUT:
// LN(0) is the LN bias, not 0, so out-of-image neighbours are skipped, not
// normalised.
//
// What bounds it on the H100: the LN and the 9-tap depthwise conv are a few
// FLOPs per byte and bandwidth-bound; the token reduction q^T k is
// 2 T C^2 FLOPs (C <= 192), light next to the map traffic.
//
// Design, first version: four launches instead of one fused pass.
//  1. ln_kernel: one warp per token normalises x and y into scratch.
//  2. dw_kernel: one thread per (token, channel) sums the kh x 3 taps for q,
//     k and v; q and k go to scratch, v is the output.
//  3. gram_kernel: the TPU kernel carries qk and sq across sequential grid
//     steps; Hopper blocks run in no order, so each block reduces one chunk
//     of 256 tokens for one 32 x 32 tile of qk (and the sq rows of its
//     tile) into its own slot of a partial-sum scratch buffer.
//  4. reduce_kernel: sums the partials over chunks in a fixed order, so the
//     result is deterministic (no atomics).
// Fusing 1-3 into one pass over the map, as the TPU kernel does, is later
// work; xn, yn, q and k are staged through device memory here.

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-5f;
constexpr int kMaxCPerLane = 8;     // C <= 256
constexpr int kGramTile = 32;       // qk tile edge
constexpr int kGramChunk = 256;     // tokens per partial sum
constexpr int kGramStep = 32;       // tokens staged in shared memory at a time

__global__ void ln_kernel(const float* __restrict__ x, const float* __restrict__ y,
                          const float* __restrict__ ln, float* __restrict__ xn,
                          float* __restrict__ yn, long long tokens, int c) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= 2 * tokens) return;
  const bool is_y = warp >= tokens;
  const long long t = is_y ? warp - tokens : warp;
  const float* src = (is_y ? y : x) + t * c;
  float* dst = (is_y ? yn : xn) + t * c;
  const float* wgt = ln + (is_y ? 2 : 0) * c;
  const float* bias = wgt + c;

  float vals[kMaxCPerLane];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxCPerLane; ++j) {
    const int ch = lane + 32 * j;
    vals[j] = ch < c ? src[ch] : 0.0f;
    sum += vals[j];
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / (float)c;
  float var = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxCPerLane; ++j) {
    const int ch = lane + 32 * j;
    const float dv = ch < c ? vals[j] - mu : 0.0f;
    var += dv * dv;
  }
  for (int off = 16; off > 0; off >>= 1) var += __shfl_xor_sync(0xffffffffu, var, off);
  const float denom = sqrtf(var / (float)c + kEps);
#pragma unroll
  for (int j = 0; j < kMaxCPerLane; ++j) {
    const int ch = lane + 32 * j;
    if (ch < c) dst[ch] = (vals[j] - mu) / denom * wgt[ch] + bias[ch];
  }
}

// q, k, v for one (token, channel); taps [kh, 3, 3C] in (q | k | v) order.
__global__ void dw_kernel(const float* __restrict__ xn, const float* __restrict__ yn,
                          const float* __restrict__ taps, float* __restrict__ q,
                          float* __restrict__ k, float* __restrict__ v, int b,
                          int h, int w, int c, int kh) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)b * h * w * c;
  if (e >= total) return;
  const int ch = (int)(e % c);
  const long long pix = e / c;
  const int xx = (int)(pix % w);
  const int yy = (int)((pix / w) % h);
  const long long img = pix - ((long long)yy * w + xx);  // first pixel of the image
  const int halo = kh / 2;
  float aq = 0.0f, ak = 0.0f, av = 0.0f;
  for (int di = 0; di < kh; ++di) {
    const int sy = yy + di - halo;
    for (int dj = 0; dj < 3; ++dj) {
      const int sx = xx + dj - 1;
      if (sy < 0 || sy >= h || sx < 0 || sx >= w) continue;
      const long long src = (img + (long long)sy * w + sx) * c + ch;
      const float* t = taps + (di * 3 + dj) * 3 * c;
      aq += xn[src] * t[ch];
      const float yv = yn[src];
      ak += yv * t[c + ch];
      av += yv * t[2 * c + ch];
    }
  }
  q[e] = aq;
  k[e] = ak;
  v[e] = av;
}

// One block: batch b, token chunk blockIdx.x, qk tile (blockIdx.y / nt,
// blockIdx.y % nt). Writes partial qk [C, C] and sq [2, C] for that chunk.
__global__ void __launch_bounds__(256)
gram_kernel(const float* __restrict__ q, const float* __restrict__ k,
            float* __restrict__ part_qk, float* __restrict__ part_sq,
            long long t_per_b, int c, int n_chunks) {
  __shared__ float s_q[kGramStep][kGramTile + 1];
  __shared__ float s_k[kGramStep][kGramTile + 1];
  const int nt = (c + kGramTile - 1) / kGramTile;
  const int chunk = blockIdx.x;
  const int ti = blockIdx.y / nt;
  const int tj = blockIdx.y % nt;
  const int b = blockIdx.z;
  const int i0 = ti * kGramTile;
  const int j0 = tj * kGramTile;
  const int tid = threadIdx.x;
  const int r = tid / 8;        // qk row in the tile, 0..31
  const int cb = tid % 8;       // qk columns cb, cb + 8, cb + 16, cb + 24
  const long long t_begin = (long long)chunk * kGramChunk;
  const long long t_end =
      t_begin + kGramChunk < t_per_b ? t_begin + kGramChunk : t_per_b;
  const float* qb = q + (long long)b * t_per_b * c;
  const float* kb = k + (long long)b * t_per_b * c;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sqq = 0.0f, sqk = 0.0f;
  for (long long t0 = t_begin; t0 < t_end; t0 += kGramStep) {
    __syncthreads();
    for (int e = tid; e < kGramStep * kGramTile; e += 256) {
      const int tt = e / kGramTile;
      const int cc = e % kGramTile;
      const long long t = t0 + tt;
      const bool ok_t = t < t_end;
      s_q[tt][cc] = (ok_t && i0 + cc < c) ? qb[t * c + i0 + cc] : 0.0f;
      s_k[tt][cc] = (ok_t && j0 + cc < c) ? kb[t * c + j0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int tt = 0; tt < kGramStep; ++tt) {
      const float a = s_q[tt][r];
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[m] += a * s_k[tt][cb + 8 * m];
    }
    if (tid < kGramTile) {
      for (int tt = 0; tt < kGramStep; ++tt) sqq += s_q[tt][tid] * s_q[tt][tid];
    } else if (tid < 2 * kGramTile) {
      const int cc = tid - kGramTile;
      for (int tt = 0; tt < kGramStep; ++tt) sqk += s_k[tt][cc] * s_k[tt][cc];
    }
  }

  float* pq = part_qk + ((long long)b * n_chunks + chunk) * c * c;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + r;
    const int j = j0 + cb + 8 * m;
    if (i < c && j < c) pq[(long long)i * c + j] = acc[m];
  }
  float* ps = part_sq + ((long long)b * n_chunks + chunk) * 2 * c;
  if (tj == 0 && tid < kGramTile && i0 + tid < c) ps[i0 + tid] = sqq;
  if (ti == 0 && tid >= kGramTile && tid < 2 * kGramTile && j0 + tid - kGramTile < c)
    ps[c + j0 + tid - kGramTile] = sqk;
}

// Sums [B, n_chunks, m] partials over chunks, in chunk order.
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int b, int n_chunks, int m) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)b * m) return;
  const long long bi = e / m;
  const long long j = e % m;
  const float* p = part + bi * n_chunks * m + j;
  float s = 0.0f;
  for (int ci = 0; ci < n_chunks; ++ci) s += p[(long long)ci * m];
  out[e] = s;
}

}  // namespace

extern "C" int rpeflow_mdta_gram_chunks(long long tokens_per_batch) {
  return (int)((tokens_per_batch + kGramChunk - 1) / kGramChunk);
}

// scratch: xn, yn, q, k (each B*H*W*C floats), then part_qk
// (B * n_chunks * C * C) and part_sq (B * n_chunks * 2C).
extern "C" int rpeflow_mdta_qkv(const float* x, const float* y, const float* ln,
                                const float* taps, float* v, float* qk, float* sq,
                                float* scratch, int b, int h, int w, int c, int kh,
                                void* stream) {
  if (c > 32 * kMaxCPerLane || (kh != 1 && kh != 3)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long t_per_b = (long long)h * w;
  const long long tokens = (long long)b * t_per_b;
  const long long elems = tokens * c;
  const int n_chunks = rpeflow_mdta_gram_chunks(t_per_b);
  float* xn = scratch;
  float* yn = xn + elems;
  float* q = yn + elems;
  float* k = q + elems;
  float* part_qk = k + elems;
  float* part_sq = part_qk + (long long)b * n_chunks * c * c;

  const int ln_threads = 256;
  const long long ln_blocks = (2 * tokens * 32 + ln_threads - 1) / ln_threads;
  ln_kernel<<<(unsigned)ln_blocks, ln_threads, 0, st>>>(x, y, ln, xn, yn, tokens, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long dw_blocks = (elems + 255) / 256;
  dw_kernel<<<(unsigned)dw_blocks, 256, 0, st>>>(xn, yn, taps, q, k, v, b, h, w, c, kh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nt = (c + kGramTile - 1) / kGramTile;
  dim3 grid(n_chunks, nt * nt, b);
  gram_kernel<<<grid, 256, 0, st>>>(q, k, part_qk, part_sq, t_per_b, c, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long m_qk = (long long)c * c;
  reduce_kernel<<<(unsigned)((b * m_qk + 255) / 256), 256, 0, st>>>(
      part_qk, qk, b, n_chunks, (int)m_qk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)((b * 2LL * c + 255) / 256), 256, 0, st>>>(
      part_sq, sq, b, n_chunks, 2 * c);
  return (int)cudaGetLastError();
}
