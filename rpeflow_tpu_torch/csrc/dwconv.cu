// Depthwise kh x 3 convolution on Hopper (sm_90a): forward and fused backward.
//
// Replaces: rpeflow_tpu/ops/pallas/dwconv.py : dwconv_pallas (_dw_kernel).
// For x [B, H, W, C] and taps [kh, 3, C] (kh = 3 for 2-D maps, kh = 1 for
// point maps entering as [B, 1, N, C]):
//   out[b, y, x, c] = sum_{i, j} x[b, y + i - kh/2, x + j - 1, c] * taps[i, j, c]
// zero padding, no bias, held to rpeflow_tpu/nn/mdta.py : _dw_flat. The
// backward of the port's autograd function (ops/dwconv.py) is one call that
// makes one pass over the output gradient g:
//   dx[b, y, x, c]  = sum_{i, j} g[b, y - i + kh/2, x - j + 1, c] * taps[i, j, c]
//   dtaps[i, j, c] = sum_{b, y, x} x[b, y, x, c] * g[b, y - i + kh/2, x - j + 1, c]
// (the second is sum g * shift(x) with the shift moved onto g).
//
// What bounds it on the H100: 2 * 3kh FLOPs per output element against 8
// bytes of traffic (the forward reads x and writes out; the backward reads x
// and g and writes dx), far below the card's 20 FLOPs a byte: bandwidth.
// So every element should leave device memory once, with enough bytes in
// flight to cover the memory's latency.
//
// Design:
//  * a block owns a tile of cols columns by cgb * V channels (a thread: V
//    consecutive channels, V = 4, 2 or 1 as C allows, of TX adjacent
//    columns; a warp's accesses are one contiguous run of the channels-last
//    layout) and walks the rows of a strip, then the next unit (batch
//    element, strip, column tile) nb units on: blocks persist, so the
//    pipeline runs on across units.
//  * each row of the tile (with its two halo columns, and in the backward
//    x's row) is copied to a ring of shared-memory stages by cp.async,
//    several rows ahead of the arithmetic: the bytes in flight do not
//    depend on registers. Each input element leaves device memory once,
//    apart from the halo columns and the two halo rows of each strip.
//  * each thread keeps a rolling window of three rows by TX + 2 columns in
//    registers (one new row from shared memory a step) and the taps in
//    registers. Two columns a thread (TX = 2) share the window's loads and
//    halve the per-step work of the pipeline (copies, barrier, bookkeeping)
//    per output. The forward at V = 4 takes one (TX = 1): at two its
//    registers spill. Either way two blocks run on an SM.
//  * the backward's window is over g: dx reads the taps rotated by index
//    (no flipped copy), and x[y, x] times the same window gives the kh * 3
//    taps products, accumulated in registers over every unit the block
//    walks (the TPU kernel's sequential grid carried its sums across steps;
//    Hopper's blocks run in no order). Each block sums its threads in
//    shared memory in a fixed order and writes one partial; a second launch
//    sums the partials in a fixed order. No float atomics: two calls are
//    bitwise equal.
//  * the plan (V, cgb, cols, rh, nb; TX follows from V) is Python
//    (ops/dwconv.py : dwconv_plan); the entry points refuse a plan they
//    cannot run. scripts/torch_dwconv_probe.py times other plans.

#include <cuda_runtime.h>
#include <cstdint>

#include "sm90_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 8;  // ring stages at one column a thread; kStages / 2 at two
constexpr int kMaxSmem = 48 * 1024;  // static launch limit: no opt-in needed
constexpr int kBlocksPerSm = 2;      // what the launch bounds hold the registers to

// Columns a thread: 1 for the forward at V = 4, else 2.
__host__ __device__ constexpr int cols_per_thread(int v, bool bwd) {
  return !bwd && v == 4 ? 1 : 2;
}

struct Plan {
  int b, h, w, c, kh, v, cgb, cols, rh, nb, tx;
  int cg, ch_blocks, col_tiles, strips;
  long long units;
};

// The plan array (int64): B, H, W, C, kh, V, cgb, cols, rh, nb, tx.
bool read_plan(const long long* a, Plan& p) {
  for (int i = 0; i < 11; ++i)
    if (a[i] < 0 || a[i] > 0x7fffffffLL) return false;
  p.b = (int)a[0]; p.h = (int)a[1]; p.w = (int)a[2]; p.c = (int)a[3]; p.kh = (int)a[4];
  p.v = (int)a[5]; p.cgb = (int)a[6]; p.cols = (int)a[7]; p.rh = (int)a[8]; p.nb = (int)a[9];
  p.tx = (int)a[10];
  if (p.b < 1 || p.h < 1 || p.w < 1 || p.c < 1 || (p.kh != 1 && p.kh != 3)) return false;
  if ((p.v != 1 && p.v != 2 && p.v != 4) || p.c % p.v) return false;
  if ((p.tx != 1 && p.tx != 2) || p.cols % p.tx || p.cols / p.tx < 2) return false;
  if (p.cgb < 1 || p.cgb * (p.cols / p.tx) > kThreads || p.rh < 1) return false;
  if (p.nb < 1 || p.nb > 65535) return false;
  p.cg = p.c / p.v;
  p.ch_blocks = (p.cg + p.cgb - 1) / p.cgb;
  p.col_tiles = (p.w + p.cols - 1) / p.cols;
  p.strips = (p.h + p.rh - 1) / p.rh;
  p.units = (long long)p.b * p.strips * p.col_tiles;
  return true;
}

// Floats of one ring stage: a row of the tile with its halo columns, and in
// the backward x's row of the tile.
__host__ __device__ __forceinline__ int stage_floats(const Plan& p, bool bwd) {
  return (p.cols + 2 + (bwd ? p.cols : 0)) * p.cgb * p.v;
}

// Dynamic shared memory of a launch: the ring, or the backward's block sum
// (reusing it), whichever is larger.
int smem_bytes(const Plan& p, bool bwd) {
  const int ring = kStages / p.tx * stage_floats(p, bwd);
  const int sums = bwd ? p.cols * p.cgb * p.v * p.kh * 3 : 0;
  return 4 * (ring > sums ? ring : sums);
}

bool aligned(const void* ptr, int v) { return (reinterpret_cast<uintptr_t>(ptr) % (4 * v)) == 0; }

template <int V>
__device__ __forceinline__ void load_global(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_shared(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = p[0];
  }
}

template <int V>
__device__ __forceinline__ void store_global(float* p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    p[0] = d[0];
  }
}

template <int V>
__device__ __forceinline__ void cp_async_v(float* dst, const float* src, bool valid) {
  if constexpr (V == 4) {
    cp_async16(dst, src, valid);
  } else if constexpr (V == 2) {
    cp_async8(dst, src, valid);
  } else {
    cp_async4(dst, src, valid);
  }
}

// A block's walk over its units (u = blockIdx.y, + nb, ...) and their rows:
// for a strip [y0, y1) the rows y0 - kh/2 .. y1 - 1 + kh/2; a row's output
// row is sy - kh/2 once that is inside the strip.
struct Walk {
  long long u;
  int bb, c0, y0, y1, sy;
};

template <int KH>
__device__ __forceinline__ void walk_begin(Walk& k, long long u, const Plan& p) {
  k.u = u;
  if (u >= p.units) return;
  k.c0 = (int)(u % p.col_tiles) * p.cols;
  const long long bs = u / p.col_tiles;
  k.bb = (int)(bs / p.strips);
  k.y0 = (int)(bs % p.strips) * p.rh;
  k.y1 = min(k.y0 + p.rh, p.h);
  k.sy = k.y0 - KH / 2;
}

template <int KH>
__device__ __forceinline__ void walk_next(Walk& k, const Plan& p) {
  if (++k.sy == k.y1 + KH / 2) walk_begin<KH>(k, k.u + p.nb, p);
}

// A thread's share of the copies of one ring stage, the same for every row
// of every unit: chunks tid, tid + threads, ... of the tile row with its
// halo columns (tile column -1 .. cols), and of x's row of the tile (the
// backward). kNone marks a chunk the thread has not (or one of channels
// beyond C, which nobody reads).
constexpr int kNone = -(1 << 30);

template <int N>
struct Copies {
  int col[N];  // tile column of each chunk, or kNone
  int dst[N];  // offset in the stage, floats
  int ch[N];   // first channel
};

template <int N>
__device__ __forceinline__ void chunks(Copies<N>& cp, int tid, int nthreads, int n, int first_col,
                                       int base, const Plan& p, int chb, int v) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int q = tid + k * nthreads;
    cp.col[k] = kNone;
    if (q >= n) continue;
    const int cc = q / p.cgb;
    const int gi = chb * p.cgb + (q - cc * p.cgb);
    if (gi >= p.cg) continue;
    cp.col[k] = first_col + cc;
    cp.dst[k] = base + cc * p.cgb * v + (q - cc * p.cgb) * v;
    cp.ch[k] = gi * v;
  }
}

// Copy row sy of the tile from src (zeros outside the map) to one ring stage.
template <int V, int N>
__device__ __forceinline__ void issue_row(float* stage, const Copies<N>& cp, const float* src,
                                          long long img_row, bool row_ok, int c0, const Plan& p) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (cp.col[i] == kNone) continue;
    const int sx = c0 + cp.col[i];
    const bool ok = row_ok && sx >= 0 && sx < p.w;
    cp_async_v<V>(stage + cp.dst[i], ok ? src + (img_row + sx) * p.c + cp.ch[i] : src, ok);
  }
}

// The forward (BWD false: in = x, out = out) or the backward (in = g, out =
// dx if need_out, the per-block taps partials into part if need_dtaps).
// grid (ch_blocks, nb), block (cgb, cols / TX): a thread takes V channels of
// TX adjacent columns. Its window holds rows sy - 2, sy - 1, sy of in as r0,
// r1, r2 (kh = 3; kh = 1: r2 alone), columns -1 .. TX of its own. Forward:
// output column t takes taps row i, column j from window row i, column t + j.
// Backward: dx pairs window row r with taps row kh - 1 - r and column t + j
// with taps column 2 - j; dtaps[i][j] takes x[y, t] times window row
// kh - 1 - i, column t + 2 - j.
template <int KH, int V, int TX, bool BWD>
__device__ __forceinline__ void dw_pass(const float* __restrict__ in, const float* __restrict__ x,
                                        const float* __restrict__ taps, float* __restrict__ out,
                                        float* __restrict__ part, const Plan& p, int need_out,
                                        int need_dtaps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int W = TX + 2;  // window columns
  constexpr int S = kStages / TX;  // ring stages: the same bytes in flight at either TX
  const int chb = blockIdx.x;
  const int tch = p.cgb * V;
  const int sf = stage_floats(p, BWD);
  const int gi = chb * p.cgb + threadIdx.x;
  const bool ch_ok = gi < p.cg;
  const int ch = (ch_ok ? gi : 0) * V;
  const int lc = threadIdx.y * TX;  // the thread's first column in the tile

  float t[KH][3][V];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) load_global<V>(t[i][j], taps + (i * 3 + j) * p.c + ch);
  float acc[KH][3][V];
#pragma unroll
  for (int i = 0; i < KH; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][j][e] = 0.0f;
  float r0[W][V], r1[W][V], r2[W][V];

  // the tile row with its halo: (cols + 2) * cgb chunks, at most TX + 1 a
  // thread (threads = cols / TX * cgb, with cols / TX >= 2); x's row: TX
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  Copies<TX + 1> cg;
  chunks(cg, tid, nthreads, (p.cols + 2) * p.cgb, -1, 0, p, chb, V);
  Copies<TX> cx;
  chunks(cx, tid, nthreads, BWD ? p.cols * p.cgb : 0, 0, (p.cols + 2) * tch, p, chb, V);

  Walk prod, cons;
  walk_begin<KH>(prod, blockIdx.y, p);
  cons = prod;
  auto issue = [&](float* stage) {
    const long long img = (long long)prod.bb * p.h;
    issue_row<V>(stage, cg, in, (img + prod.sy) * p.w, prod.sy >= 0 && prod.sy < p.h, prod.c0,
                 p);
    if constexpr (BWD) {
      const int xy = prod.sy - KH / 2;  // x's output row, when inside the strip
      if (need_dtaps && xy >= prod.y0 && xy < prod.y1)
        issue_row<V>(stage, cx, x, (img + xy) * p.w, true, prod.c0, p);
    }
    walk_next<KH>(prod, p);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (prod.u < p.units) issue(smem + s * sf);
    cp_async_commit();
  }
  for (int k = 0; cons.u < p.units; ++k) {
    cp_async_wait<S - 2>();  // this step's row has landed, for every thread's copies
    __syncthreads();         // and every thread is done with the stage refilled next
    if (prod.u < p.units) issue(smem + ((k + S - 1) % S) * sf);
    cp_async_commit();
    const float* st = smem + (k % S) * sf;
    const int col = cons.c0 + lc;
    if (ch_ok && col < p.w) {
      if constexpr (KH == 3) {
#pragma unroll
        for (int j = 0; j < W; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            r0[j][e] = r1[j][e];
            r1[j][e] = r2[j][e];
          }
      }
#pragma unroll
      for (int j = 0; j < W; ++j)
        load_shared<V>(r2[j], st + (lc + j) * tch + threadIdx.x * V);
      const int y = cons.sy - KH / 2;
      if (y >= cons.y0) {
        float* dst = out + (((long long)cons.bb * p.h + y) * p.w + col) * p.c + ch;
        if (!BWD || need_out) {
#pragma unroll
          for (int c = 0; c < TX; ++c) {
            float o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
              float a = 0.0f;
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                if constexpr (KH == 3) {
                  a += r0[c + j][e] * t[BWD ? 2 : 0][BWD ? 2 - j : j][e];
                  a += r1[c + j][e] * t[1][BWD ? 2 - j : j][e];
                }
                a += r2[c + j][e] * t[BWD ? 0 : KH - 1][BWD ? 2 - j : j][e];
              }
              o[e] = a;
            }
            if (TX == 1 || col + c < p.w) store_global<V>(dst + c * p.c, o);
          }
        }
        if constexpr (BWD) {
          if (need_dtaps) {
#pragma unroll
            for (int c = 0; c < TX; ++c) {
              float xv[V];  // zeros beyond the map's edge
              load_shared<V>(xv, st + (p.cols + 2 + lc + c) * tch + threadIdx.x * V);
#pragma unroll
              for (int j = 0; j < 3; ++j)
#pragma unroll
                for (int e = 0; e < V; ++e) {
                  acc[0][j][e] += xv[e] * r2[c + 2 - j][e];
                  if constexpr (KH == 3) {
                    acc[1][j][e] += xv[e] * r1[c + 2 - j][e];
                    acc[2][j][e] += xv[e] * r0[c + 2 - j][e];
                  }
                }
            }
          }
        }
      }
    }
    walk_next<KH>(cons, p);
  }
  if constexpr (BWD) {
    if (!need_dtaps) return;
    // the block's sum over its column groups, in order: s[group][tap][cgb * V]
    __syncthreads();  // the ring is free: every row consumed, no copy in flight
    float* s = smem;
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e)
          s[(threadIdx.y * KH * 3 + i * 3 + j) * tch + threadIdx.x * V + e] = acc[i][j][e];
    __syncthreads();
    for (int e = tid; e < KH * 3 * tch; e += nthreads) {
      const int tap = e / tch;
      const int q = e - tap * tch;
      float sum = 0.0f;
      for (int l = 0; l < (int)blockDim.y; ++l) sum += s[(l * KH * 3 + tap) * tch + q];
      const int channel = chb * tch + q;
      if (channel < p.c) part[((long long)blockIdx.y * KH * 3 + tap) * p.c + channel] = sum;
    }
  }
}

// ops/dwconv.py : BLOCKS_PER_SM sizes the grid to kBlocksPerSm.
template <int KH, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ taps,
              float* __restrict__ out, Plan p) {
  dw_pass<KH, V, cols_per_thread(V, false), false>(x, nullptr, taps, out, nullptr, p, 1, 0);
}

template <int KH, int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
dw_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ taps, float* __restrict__ dx,
              float* __restrict__ part, Plan p, int need_dx, int need_dtaps) {
  dw_pass<KH, V, cols_per_thread(V, true), true>(g, x, taps, dx, part, p, need_dx, need_dtaps);
}

// out[j] = sum_n part[n, j], j < m: block (32, 8), lane row r sums n = r, r + 8,
// ... in order, then the eight lane rows are added in order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int m) {
  __shared__ float s[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float a = 0.0f;
  if (j < m)
    for (int i = threadIdx.y; i < n; i += 8) a += part[(long long)i * m + j];
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && j < m) {
    float t = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) t += s[r][threadIdx.x];
    out[j] = t;
  }
}

using FwdFn = void (*)(const float*, const float*, float*, Plan, cudaStream_t);
using BwdFn = void (*)(const float*, const float*, const float*, float*, float*, Plan, int, int,
                       cudaStream_t);

template <int KH, int V>
void launch_fwd(const float* x, const float* taps, float* out, Plan p, cudaStream_t st) {
  dw_fwd_kernel<KH, V><<<dim3(p.ch_blocks, p.nb), dim3(p.cgb, p.cols / p.tx),
                         smem_bytes(p, false), st>>>(x, taps, out, p);
}

template <int KH, int V>
void launch_bwd(const float* x, const float* g, const float* taps, float* dx, float* part, Plan p,
                int need_dx, int need_dtaps, cudaStream_t st) {
  dw_bwd_kernel<KH, V><<<dim3(p.ch_blocks, p.nb), dim3(p.cgb, p.cols / p.tx),
                         smem_bytes(p, true), st>>>(x, g, taps, dx, part, p, need_dx, need_dtaps);
}

// [kh == 3][V = 1, 2, 4]
constexpr FwdFn kFwd[2][3] = {{launch_fwd<1, 1>, launch_fwd<1, 2>, launch_fwd<1, 4>},
                              {launch_fwd<3, 1>, launch_fwd<3, 2>, launch_fwd<3, 4>}};
// [kh == 3][V = 1, 2]
constexpr BwdFn kBwd[2][2] = {{launch_bwd<1, 1>, launch_bwd<1, 2>},
                              {launch_bwd<3, 1>, launch_bwd<3, 2>}};

int vi(int v) { return v == 4 ? 2 : v - 1; }

}  // namespace

extern "C" int rpeflow_dwconv(const float* x, const float* taps, float* out,
                              const long long* plan, void* stream) {
  Plan p;
  if (!read_plan(plan, p) || p.tx != cols_per_thread(p.v, false) ||
      smem_bytes(p, false) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, p.v) || !aligned(taps, p.v) || !aligned(out, p.v))
    return (int)cudaErrorMisalignedAddress;
  kFwd[p.kh == 3][vi(p.v)](x, taps, out, p, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// One backward call: dx (if need_dx) and dtaps (if need_dtaps, through
// scratch of nb * kh * 3 * C floats); two launches.
extern "C" int rpeflow_dwconv_bwd(const float* x, const float* g, const float* taps, float* dx,
                                  float* dtaps, float* scratch, const long long* plan,
                                  int need_dx, int need_dtaps, void* stream) {
  Plan p;
  if (!read_plan(plan, p) || p.v == 4 || p.tx != cols_per_thread(p.v, true) ||
      smem_bytes(p, true) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, p.v) || !aligned(g, p.v) || !aligned(taps, p.v) ||
      (need_dx && !aligned(dx, p.v)))
    return (int)cudaErrorMisalignedAddress;
  if (!need_dx && !need_dtaps) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  kBwd[p.kh == 3][vi(p.v)](x, g, taps, dx, scratch, p, need_dx, need_dtaps, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !need_dtaps) return (int)err;
  const int m = p.kh * 3 * p.c;
  sum_partials_kernel<<<(m + 31) / 32, dim3(32, 8), 0, st>>>(scratch, dtaps, p.nb, m);
  return (int)cudaGetLastError();
}
