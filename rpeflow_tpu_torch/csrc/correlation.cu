// Local 2-D cost volume on Hopper (sm_90a): the forward, and both input
// gradients in one backward launch.
//
// Replaces: rpeflow_tpu/ops/pallas/correlation.py : correlation2d_pallas
// (_corr_kernel), which keeps an f1 row tile and a haloed f2 slab in VMEM and
// emits every displacement channel in one pass; and the backward that the
// JAX package computes in XLA, rpeflow_tpu/ops/correlation.py :
// _correlation2d_bwd_ref.
//
// With K = (2d + 1)^2 displacements k = (dy + d)(2d + 1) + (dx + d), and f1,
// f2, g read as zero outside the frame, channels-last in and out:
//   out[b, y, x, k] = (1 / C) sum_c f1[b, y, x, c] * f2[b, y + dy, x + dx, c]
//   grad1[q, c]     = (1 / C) sum_k g[q, k] * f2[q + delta_k, c]
//   grad2[q, c]     = (1 / C) sum_k g[q - delta_k, k] * f1[q - delta_k, c]
//                   = (1 / C) sum_k g[q + delta_k, K - 1 - k] * f1[q + delta_k, c]
// The last form (delta_{K-1-k} = -delta_k) makes both gradients one gather,
// out_r[q, c] = (1 / C) sum_k A_r[q, k] * F_r[q + delta_k, c], with
// A_0 = g, F_0 = f2 and A_1[q, k] = g[q + delta_k, K - 1 - k], F_1 = f1: no
// atomics, and two calls are bitwise equal.
//
// What bounds it on the H100: bytes. The forward moves 4 (2C + K) bytes a
// pixel for 2 K C operations (C = 32: 1.4 s of bytes to 0.6 of f32 FMA at
// the card's peaks); the backward 4 (4C + K) bytes for 4 K C. What limits a
// direct version is reading f2 (and in the backward g) again for every
// displacement, and the forward's 81-float rows of output.
//
// Design (the plan, the tile, is Python: ops/correlation.py :
// correlation_plan; the entry points refuse a plan they cannot run):
// * Blocks of TH x TW output pixels (TW 16 or 32). Channels go through
//   shared memory in chunks of 32, by cp.async (16 bytes where C % 4 == 0,
//   else 4), zero-filled outside the frame and past C, one chunk at a time
//   (a second stage, filled while the first is read, was no faster: at C =
//   32 a block has one chunk, and two blocks share an SM).
//   A pixel's 32 channels are 8 float4 slots, slot s stored at s ^ swz(row,
//   col), so that the float4 reads of a quarter-warp (8 column groups, or 8
//   channel groups) hit 8 distinct bank groups.
// * Forward: a thread owns one output row r, one displacement row dy and
//   R = 4 adjacent pixels, so per float4 of channels it reads 4 f1 values and
//   4 + 2d f2 values for 4 (2d + 1) dot products (9 multiply-adds a shared
//   memory read at d = 4). The tile's TH x TW x K outputs are staged in
//   shared memory and stored row by row, each row one contiguous run of
//   TW x K floats, with 16-byte stores after a head to 16-byte alignment.
// * Backward: gridDim.z = 2B; block z computes gradient z & 1 of batch
//   element z >> 1 (the two gradients have the same arithmetic and the same
//   bytes, so one block a gradient gives twice the blocks of one block for
//   both, in the same shared memory). The block stages its A tile (TH x TW
//   x K, once, by 4-byte cp.async: copied with loads and stores through
//   registers, its latency was two thirds of the kernel's time) and then,
//   chunk by chunk, the F halo (TH + 2d rows, TW + 2d columns); a thread
//   owns 4 adjacent pixels and one float4 of channels and writes its 4
//   gradient float4s straight to device memory (8 threads a pixel: 128
//   contiguous bytes).

#include <cuda_runtime.h>

#include "sm90_helpers.cuh"

namespace {

constexpr int kMaxD = 4;
constexpr int kChunk = 32;  // channels a stage holds per pixel (8 float4 slots)
constexpr int kR = 4;       // adjacent pixels a thread owns
constexpr int kMaxTh = 4;         // output rows a block takes at most
constexpr int kMaxThreads = 288;  // kMaxTh rows x 9 displacement rows x 8 column groups
constexpr int kBlocksPerSm = 2;   // what the launch bounds hold the registers to
constexpr int kSmemLimit = 232448;

// The plan, as ops/correlation.py : CorrPlan.c_plan writes it.
struct Plan {
  long long b, h, w, c, d, th, tw;
};

__device__ __forceinline__ int swz(int row, int col) { return ((col >> 2) ^ (row << 2)) & 7; }

// Stage channels [c0, c0 + 32) of the rows x cols window of f whose top-left
// pixel is (y0, x0) into buf as [row][col][slot ^ swz]; zero outside the
// frame and past C.
template <bool kVec>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ f, size_t img,
                                      int h, int w, int c, int c0, int y0, int x0, int rows,
                                      int cols) {
  if (kVec) {
    for (int e = threadIdx.x; e < rows * cols * 8; e += blockDim.x) {
      const int s = e & 7, pc = e >> 3;
      const int col = pc % cols, row = pc / cols;
      const int gy = y0 + row, gx = x0 + col;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c0 + 4 * s < c;
      const float* src = ok ? f + (img + (size_t)gy * w + gx) * c + c0 + 4 * s : f;
      cp_async16(buf + (pc * 8 + (s ^ swz(row, col))) * 4, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols * kChunk; e += blockDim.x) {
      const int ch = e & (kChunk - 1), pc = e / kChunk;
      const int col = pc % cols, row = pc / cols;
      const int gy = y0 + row, gx = x0 + col;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w && c0 + ch < c;
      const float* src = ok ? f + (img + (size_t)gy * w + gx) * c + c0 + ch : f;
      cp_async4(buf + (pc * 8 + ((ch >> 2) ^ swz(row, col))) * 4 + (ch & 3), src, ok);
    }
  }
}

// The float4 at slot offset u (in floats: (s ^ swz) * 4) of pixel p of a row
// whose first pixel is at px: the pixel's 32 floats start at p * 32, so the
// loops below, unrolled over p, read at immediate offsets from one pointer.
__device__ __forceinline__ float4 ld4(const float* row, int p, int u) {
  return *reinterpret_cast<const float4*>(row + p * kChunk + u);
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// ---------------------------------------------------------------- forward

template <int D, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
corr_fwd(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
         int h, int w, int c, int th, int tw) {
  constexpr int kSide = 2 * D + 1;
  constexpr int kK = kSide * kSide;
  constexpr int kWin = kR + 2 * D;
  extern __shared__ __align__(16) float smem[];
  const int rows = th + 2 * D, cols = tw + 2 * D;
  const int f1_floats = th * tw * kChunk;
  const int b = blockIdx.z, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const size_t img = (size_t)b * h * w;
  const int nxg = tw / kR;
  const int xg = threadIdx.x % nxg;
  const int dy = (threadIdx.x / nxg) % kSide;
  const int r = threadIdx.x / (nxg * kSide);
  const int px = xg * kR;

  float acc[kR][kSide];
#pragma unroll
  for (int j = 0; j < kR; ++j)
#pragma unroll
    for (int i = 0; i < kSide; ++i) acc[j][i] = 0.0f;

  const int chunks = (c + kChunk - 1) / kChunk;
  auto issue = [&](int chunk) {
    stage<kVec>(smem, f1, img, h, w, c, chunk * kChunk, y0, x0, th, tw);
    stage<kVec>(smem + f1_floats, f2, img, h, w, c, chunk * kChunk, y0 - D, x0 - D, rows, cols);
    cp_async_commit();
  };
  issue(0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<0>();
    __syncthreads();
    // this thread's pixels px.. of f1 row r and of f2 window row r + dy; a
    // group of 4 pixels (px is a multiple of 4) shares one swizzle
    const float* a_row = smem + (r * tw + px) * kChunk;
    const float* v_row = smem + f1_floats + ((r + dy) * cols + px) * kChunk;
    const int n4 = min(8, (c - chunk * kChunk + 3) / 4);
    for (int s = 0; s < n4; ++s) {
      const int ua = (s ^ swz(r, px)) * 4;
      int uv[(kWin + 3) / 4];
#pragma unroll
      for (int q = 0; q < (kWin + 3) / 4; ++q) uv[q] = (s ^ swz(r + dy, px + 4 * q)) * 4;
      float4 a[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) a[j] = ld4(a_row, j, ua);
#pragma unroll
      for (int t = 0; t < kWin; ++t) {
        const float4 v = ld4(v_row, t, uv[t / 4]);
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int dx = t - j;
          if (dx >= 0 && dx < kSide) acc[j][dx] = dot4(acc[j][dx], a[j], v);
        }
      }
    }
    __syncthreads();  // the stage's readers are done before it is refilled
    if (chunk + 1 < chunks) issue(chunk + 1);
  }

  // the tile's outputs, [row][col][k], in the (now idle) stage memory; the
  // mean as a product with 1 / C (a division here cost a quarter of the
  // kernel's instructions)
  const float inv_c = 1.0f / (float)c;
#pragma unroll
  for (int j = 0; j < kR; ++j)
#pragma unroll
    for (int i = 0; i < kSide; ++i)
      smem[(r * tw + px + j) * kK + dy * kSide + i] = acc[j][i] * inv_c;
  __syncthreads();
  const int n_cols = min(tw, w - x0);
  for (int rr = 0; rr < th && y0 + rr < h; ++rr) {
    const size_t g0 = (img + (size_t)(y0 + rr) * w + x0) * kK;
    const float* o = smem + rr * tw * kK;
    const int n = n_cols * kK;
    const int head = min(n, (int)((4 - (g0 & 3)) & 3));
    const int body = (n - head) / 4;
    for (int e = threadIdx.x; e < head; e += blockDim.x) out[g0 + e] = o[e];
    if (head == 0) {  // the shared-memory row is 16-byte aligned too
      for (int e = threadIdx.x; e < body; e += blockDim.x)
        reinterpret_cast<float4*>(out + g0)[e] = reinterpret_cast<const float4*>(o)[e];
    } else {
      for (int e = threadIdx.x; e < body; e += blockDim.x) {
        const int i = head + 4 * e;
        *reinterpret_cast<float4*>(out + g0 + i) =
            make_float4(o[i], o[i + 1], o[i + 2], o[i + 3]);
      }
    }
    for (int e = head + 4 * body + threadIdx.x; e < n; e += blockDim.x) out[g0 + e] = o[e];
  }
}

// --------------------------------------------------------------- backward

template <int D, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
corr_bwd(const float* __restrict__ f1, const float* __restrict__ f2,
         const float* __restrict__ g, float* __restrict__ grad1, float* __restrict__ grad2,
         int h, int w, int c, int th, int tw) {
  constexpr int kSide = 2 * D + 1;
  constexpr int kK = kSide * kSide;
  constexpr int kWin = kR + 2 * D;
  extern __shared__ __align__(16) float smem[];
  const int rows = th + 2 * D, cols = tw + 2 * D;
  const int role = blockIdx.z & 1;
  const int b = blockIdx.z >> 1, y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const size_t img = (size_t)b * h * w;
  const float* __restrict__ f = role ? f1 : f2;
  float* __restrict__ grad = role ? grad2 : grad1;
  float* a_tile = smem;  // [th][tw][K]
  float* f_stage = smem + th * tw * kK;

  const int chunks = (c + kChunk - 1) / kChunk;
  auto issue = [&](int chunk) {
    stage<kVec>(f_stage, f, img, h, w, c, chunk * kChunk,
                y0 - D, x0 - D, rows, cols);
    cp_async_commit();
  };
  issue(0);

  // The A tile, by 4-byte cp.async (zero outside the frame), in flight
  // beside the first F stage. A_0[q, k] = g[q, k]: each tile row one
  // contiguous run of tw x K floats.
  if (role == 0) {
    for (int ty = 0; ty < th; ++ty) {
      const float* src_row = g + (img + (size_t)(y0 + ty) * w + x0) * kK;
      for (int e = threadIdx.x; e < tw * kK; e += blockDim.x) {
        const bool ok = y0 + ty < h && x0 + e / kK < w;
        cp_async4(a_tile + ty * tw * kK + e, ok ? src_row + e : g, ok);
      }
    }
  } else {
    // A_1[ty][tx][k] = g[y0 + ty + dy - D, x0 + tx + dx - D, K - 1 - k]: for
    // the source pixel in halo column sx and the channel m of its
    // displacement row 2D - dy, dx = 2D - m and tx = sx - dx, so each source
    // pixel gives 2D + 1 contiguous floats. (A thread a source pixel, its
    // 2D + 1 copies unrolled: flattening the copies over the threads, with
    // their index arithmetic and the skipped columns, made this twice as slow.)
    for (int e = threadIdx.x; e < th * kSide * cols; e += blockDim.x) {
      const int sx = e % cols, dy = (e / cols) % kSide, ty = e / (cols * kSide);
      const int gy = y0 + ty + dy - D, gx = x0 - D + sx;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const float* src = ok ? g + (img + (size_t)gy * w + gx) * kK + (2 * D - dy) * kSide : g;
      float* dst = a_tile + (ty * tw + sx - 2 * D) * kK + dy * kSide + 2 * D;
#pragma unroll
      for (int m = 0; m < kSide; ++m) {
        const int tx = sx - 2 * D + m;
        if (tx >= 0 && tx < tw) cp_async4(dst + m * (kK - 1), ok ? src + m : g, ok);
      }
    }
  }
  cp_async_commit();

  const int cg = threadIdx.x & 7;
  const int ngr = tw / kR;
  const int px = ((threadIdx.x >> 3) % ngr) * kR;
  const int ty = (threadIdx.x >> 3) / ngr;
  const float* a_row = a_tile + (ty * tw + px) * kK;
  const float inv_c = 1.0f / (float)c;

  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<0>();  // the chunk's group, and before the first the A tile
    __syncthreads();
    float4 acc[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // one displacement row at a time: unrolled further, the A loads of all
    // rows are hoisted and the registers spill
#pragma unroll 1
    for (int dy = 0; dy < kSide; ++dy) {
      const float* v_row = f_stage + ((ty + dy) * cols + px) * kChunk;
      int uv[(kWin + 3) / 4];
#pragma unroll
      for (int q = 0; q < (kWin + 3) / 4; ++q) uv[q] = (cg ^ swz(ty + dy, px + 4 * q)) * 4;
#pragma unroll
      for (int t = 0; t < kWin; ++t) {
        const float4 v = ld4(v_row, t, uv[t / 4]);
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int dx = t - j;
          if (dx < 0 || dx >= kSide) continue;
          const float a = a_row[j * kK + dy * kSide + dx];
          acc[j].x = fmaf(a, v.x, acc[j].x);
          acc[j].y = fmaf(a, v.y, acc[j].y);
          acc[j].z = fmaf(a, v.z, acc[j].z);
          acc[j].w = fmaf(a, v.w, acc[j].w);
        }
      }
    }
    const int ch = chunk * kChunk + 4 * cg;
    const int y = y0 + ty;
    if (y < h && ch < c) {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int x = x0 + px + j;
        if (x >= w) break;
        float* o = grad + (img + (size_t)y * w + x) * c + ch;
        const float4 val = make_float4(acc[j].x * inv_c, acc[j].y * inv_c, acc[j].z * inv_c,
                                       acc[j].w * inv_c);
        if (kVec) {
          *reinterpret_cast<float4*>(o) = val;
        } else {
          const float vals[4] = {val.x, val.y, val.z, val.w};
          for (int i = 0; i < 4 && ch + i < c; ++i) o[i] = vals[i];
        }
      }
    }
    __syncthreads();  // the stage's readers are done before it is refilled
    if (chunk + 1 < chunks) issue(chunk + 1);
  }
}

// ------------------------------------------------------------ host side

long long fwd_smem(const Plan& p) {
  const long long k = (2 * p.d + 1) * (2 * p.d + 1);
  const long long stage = p.th * p.tw * kChunk + (p.th + 2 * p.d) * (p.tw + 2 * p.d) * kChunk;
  const long long outs = p.th * p.tw * k;
  return 4 * (stage > outs ? stage : outs);
}

long long bwd_smem(const Plan& p) {
  const long long k = (2 * p.d + 1) * (2 * p.d + 1);
  return 4 * (p.th * p.tw * k + (p.th + 2 * p.d) * (p.tw + 2 * p.d) * kChunk);
}

bool plan_ok(const Plan& p, bool backward) {
  if (p.b < 1 || p.h < 1 || p.w < 1 || p.c < 1 || p.d < 0 || p.d > kMaxD) return false;
  if ((p.tw != 16 && p.tw != 32) || p.th < 1 || p.th > kMaxTh) return false;
  const long long threads = backward ? p.th * (p.tw / kR) * 8 : p.th * (2 * p.d + 1) * (p.tw / kR);
  if (threads > kMaxThreads || (backward ? 2 * p.b : p.b) > 65535) return false;
  if ((p.h + p.th - 1) / p.th > 65535) return false;
  return (backward ? bwd_smem(p) : fwd_smem(p)) <= kSmemLimit;
}

template <int D, bool kVec>
int launch_fwd(const float* f1, const float* f2, float* out, const Plan& p, cudaStream_t st) {
  const int smem = (int)fwd_smem(p);
  auto kern = corr_fwd<D, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w + p.tw - 1) / p.tw, (p.h + p.th - 1) / p.th, p.b);
  const int threads = (int)(p.th * (2 * D + 1) * (p.tw / kR));
  kern<<<grid, threads, smem, st>>>(f1, f2, out, (int)p.h, (int)p.w, (int)p.c, (int)p.th,
                                    (int)p.tw);
  return (int)cudaGetLastError();
}

template <int D, bool kVec>
int launch_bwd(const float* f1, const float* f2, const float* g, float* grad1, float* grad2,
               const Plan& p, cudaStream_t st) {
  const int smem = (int)bwd_smem(p);
  auto kern = corr_bwd<D, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w + p.tw - 1) / p.tw, (p.h + p.th - 1) / p.th, 2 * p.b);
  const int threads = (int)(p.th * (p.tw / kR) * 8);
  kern<<<grid, threads, smem, st>>>(f1, f2, g, grad1, grad2, (int)p.h, (int)p.w, (int)p.c,
                                    (int)p.th, (int)p.tw);
  return (int)cudaGetLastError();
}

template <bool kVec>
int dispatch_fwd(const float* f1, const float* f2, float* out, const Plan& p, cudaStream_t st) {
  switch (p.d) {
    case 0: return launch_fwd<0, kVec>(f1, f2, out, p, st);
    case 1: return launch_fwd<1, kVec>(f1, f2, out, p, st);
    case 2: return launch_fwd<2, kVec>(f1, f2, out, p, st);
    case 3: return launch_fwd<3, kVec>(f1, f2, out, p, st);
    default: return launch_fwd<4, kVec>(f1, f2, out, p, st);
  }
}

template <bool kVec>
int dispatch_bwd(const float* f1, const float* f2, const float* g, float* grad1, float* grad2,
                 const Plan& p, cudaStream_t st) {
  switch (p.d) {
    case 0: return launch_bwd<0, kVec>(f1, f2, g, grad1, grad2, p, st);
    case 1: return launch_bwd<1, kVec>(f1, f2, g, grad1, grad2, p, st);
    case 2: return launch_bwd<2, kVec>(f1, f2, g, grad1, grad2, p, st);
    case 3: return launch_bwd<3, kVec>(f1, f2, g, grad1, grad2, p, st);
    default: return launch_bwd<4, kVec>(f1, f2, g, grad1, grad2, p, st);
  }
}

}  // namespace

// plan: int64 (B, H, W, C, d, TH, TW)
extern "C" int rpeflow_correlation2d(const float* f1, const float* f2, float* out,
                                     const long long* plan, void* stream) {
  const Plan p = *reinterpret_cast<const Plan*>(plan);
  if (!plan_ok(p, false)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return p.c % 4 == 0 ? dispatch_fwd<true>(f1, f2, out, p, st)
                      : dispatch_fwd<false>(f1, f2, out, p, st);
}

extern "C" int rpeflow_correlation2d_bwd(const float* f1, const float* f2, const float* g,
                                         float* grad1, float* grad2, const long long* plan,
                                         void* stream) {
  const Plan p = *reinterpret_cast<const Plan*>(plan);
  if (!plan_ok(p, true)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return p.c % 4 == 0 ? dispatch_bwd<true>(f1, f2, g, grad1, grad2, p, st)
                      : dispatch_bwd<false>(f1, f2, g, grad1, grad2, p, st);
}
