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
// LN(0) is the LN bias, not 0, so out-of-image neighbours stay zero and are
// not normalised.
//
// What bounds it on the H100: bytes. The function reads x and y and writes
// v (3 map-sized passes; qk and sq are small), a few FLOPs per byte for the
// LayerNorms and the kh x 3 taps. The Gram matrix is 2 T C^2 FLOPs; on the
// tensor cores as 3xTF32 (three TF32 products for each f32 one, f32
// accuracy to ~2^-20) it stays below the byte time at every C <= 192.
//
// Design: one pass over the map, then one small launch that sums the
// per-block partials; q and k never leave the chip.
//  * The grid is (nblk blocks per batch element, Gram column slices, B),
//    about as many blocks as the card holds at once. A block walks the tiles
//    t = blk, blk + nblk, ... of its batch element (TH x TW tokens; a run of
//    TW tokens along N for kh = 1), so the blocks that run together work on
//    neighbouring tiles and share their halos in L2.
//  * Per tile, in shared memory: the x and y halos ((TH + 2) x (TW + 2)
//    tokens, or TW + 2 for kh = 1; cp.async, 16 bytes at a time where
//    C % 4 == 0, 4 bytes and a warp per token otherwise; out-of-image tokens
//    and padded channels are zero-filled), each LayerNormed in place (eight
//    lanes per in-image token); then q (all channels) and k (this slice's
//    channels) of the tile's tokens, one warp per (32 channels, 2 tile rows,
//    row segment) sliding a 4 x 3 window along the row. v is written once
//    from the same pass, 32 channels a warp-store on the channels-last
//    layout.
//  * The x and y halos are double-buffered by phase: the next tile's x halo
//    streams in while k, v and the Gram of this tile run, its y halo while
//    the Gram and the next q run.
//  * qk accumulates in registers across the block's tiles: 3xTF32
//    mma.m16n8k8, A = q^T read transposed out of the [token][channel] tile,
//    B = k. The q and k rows are padded to CP + 8 floats (CP a multiple of
//    32), so the fragment loads are free of bank conflicts. sq accumulates in
//    one register per (column, token phase) thread.
//  * Each block writes its partial [CP][NS] + [2][NS] to the scratch; the
//    second launch sums the partials over blocks in block order
//    (deterministic, no atomics) and drops the padded rows and columns. (A
//    single cooperative launch with a grid-wide sync before the sum measured
//    no faster: its launch costs the host about two ordinary ones.)
// Width classes (Width below): C padded to CP = 32, 64, 96, 128 (one slice:
// the whole C x C accumulator in the block's registers, up to 64 floats a
// thread), 192 (two slices of 96) and 256 (four of 64): above C = 128 the
// accumulator would not fit, so each slice recomputes the LayerNorms and q
// and takes its own k, v and Gram columns. C = 81 takes the 96 class with
// zero-padded channels and 4-byte copies. Tiles (rows x columns / row
// segment; ops/mdta.py : TILES): 8 x 12/6 at C <= 32, 8 x 8/8 at 64,
// 8 x 12/12 at 96 (one 512-thread block per SM: the tile takes 187 KB),
// 8 x 4/4 above; point runs of 128 (C <= 32), 64 (up to 128) and 32 tokens.
// The plan (tile, blocks, scratch) is made in Python (ops/mdta.py :
// mdta_plan); this file refuses (cudaErrorInvalidValue) a plan it cannot run.

#include <cuda_runtime.h>
#include <cstdint>

#include "sm90_helpers.cuh"

namespace {

constexpr float kEps = 1e-5f;
constexpr size_t kMaxSmemBytes = 232448;  // per block on an H100

struct Geom {
  int h, w, c, th, tw, seg, tiles_w, tiles;
  int hw;             // halo columns, tw + 2
  unsigned hw_magic;  // ceil(2^32 / hw): p / hw = umulhi(p, hw_magic) for p, hw < 2^16
};

// A width class: C padded to CP; NS Gram columns per slice (CP / NS
// slices); the Gram's 16 x 8 tiles over WM x (8 / WM) warps; NT threads a
// block, MINB blocks per SM (the launch bounds: at most 128 registers a
// thread for 2 x 256 or 1 x 512 threads). The 96 class (the fusers' C = 81
// and 96 at every level) runs one block of 16 warps per SM: its 8 x 12
// tile takes 187 KB of shared memory, and the two warp halves split the
// Gram's tokens.
template <int CP> struct Width;
template <> struct Width<32> { static constexpr int NS = 32, WM = 2, NT = 256, MINB = 2; };
template <> struct Width<64> { static constexpr int NS = 64, WM = 2, NT = 256, MINB = 2; };
template <> struct Width<96> { static constexpr int NS = 96, WM = 2, NT = 512, MINB = 1; };
template <> struct Width<128> { static constexpr int NS = 128, WM = 2, NT = 256, MINB = 1; };
template <> struct Width<192> { static constexpr int NS = 96, WM = 4, NT = 256, MINB = 1; };
template <> struct Width<256> { static constexpr int NS = 64, WM = 4, NT = 256, MINB = 1; };

// first halo row and column of tile t
template <int KH>
__device__ __forceinline__ void halo_origin(const Geom& g, int t, int& ty0, int& tx0) {
  ty0 = (t / g.tiles_w) * g.th - KH / 2;
  tx0 = (t % g.tiles_w) * g.tw - 1;
}

// image row and column of halo token p (p = row * hw + column)
__device__ __forceinline__ void halo_pos(const Geom& g, int ty0, int tx0, int p, int& yy,
                                         int& xx) {
  const int r = (int)__umulhi((unsigned)p, g.hw_magic);
  yy = ty0 + r;
  xx = tx0 + p - r * g.hw;
}

// the halo of tile t of one map into dst [halo tokens][CP]: 16-byte copies
// spread over the block; 4-byte copies a warp per token, lanes over the
// channels
template <int CP, int KH, int NT>
__device__ __forceinline__ void load_halo(float* dst, const float* src, const Geom& g, int t,
                                          bool vec4, int tid) {
  const int hp = (g.th + KH - 1) * g.hw;
  int ty0, tx0;
  halo_origin<KH>(g, t, ty0, tx0);
  if (vec4) {
    constexpr int PT = CP / 4;
    for (int e = tid; e < hp * PT; e += NT) {
      const int p = e / PT;
      const int k = (e - p * PT) * 4;
      int yy, xx;
      halo_pos(g, ty0, tx0, p, yy, xx);
      const bool valid = k < g.c && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      cp_async16(dst + p * CP + k, valid ? src + ((size_t)yy * g.w + xx) * g.c + k : src, valid);
    }
  } else {
    const int lane = tid & 31;
    for (int p = tid >> 5; p < hp; p += NT / 32) {
      int yy, xx;
      halo_pos(g, ty0, tx0, p, yy, xx);
      const bool in = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      const float* row = in ? src + ((size_t)yy * g.w + xx) * g.c : src;
#pragma unroll
      for (int k = lane; k < CP; k += 32) {
        const bool valid = in && k < g.c;
        cp_async4(dst + p * CP + k, valid ? row + k : src, valid);
      }
    }
  }
}

// LayerNorm of every in-image halo token in place; out-of-image tokens keep
// the zeros of the copy: the conv's zero padding. Padded channels have
// weight and bias 0 and stay 0. Eight lanes per token, 16 bytes a lane at a
// time (a quarter-warp reads one token's 128 contiguous bytes: no bank
// conflicts), so a warp normalises 4 tokens at once and reduces each over
// 3 shuffles; U rounds of 4 tokens are in flight together.
template <int CP, int KH, int NT>
__device__ __forceinline__ void layer_norm(float* hb, const float* lw, const float* lb,
                                           const Geom& g, int t, int warp, int lane) {
  constexpr int J = CP / 32;  // float4 chunks per lane: chunk l + 8 j of its token
  constexpr int U = J <= 2 ? 2 : 1;
  const int hp = (g.th + KH - 1) * g.hw;
  int ty0, tx0;
  halo_origin<KH>(g, t, ty0, tx0);
  const float inv_c = 1.0f / (float)g.c;
  const int sub = lane & 7;
  const int p0 = lane >> 3;  // this lane's token in each group of 4
  for (int base = warp * 4 * U; base < hp; base += 4 * U * (NT / 32)) {  // uniform in a warp
    bool in[U];
    float4 vals[U][J];
    float sum[U], var[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + p0 + 4 * u;
      int yy, xx;
      halo_pos(g, ty0, tx0, p, yy, xx);
      in[u] = p < hp && yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
      sum[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        vals[u][j] = in[u] ? *reinterpret_cast<const float4*>(hb + p * CP + 4 * (sub + 8 * j))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sum[u] += (vals[u][j].x + vals[u][j].y) + (vals[u][j].z + vals[u][j].w);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sum[u] *= inv_c;  // the mean
      var[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int ch = 4 * (sub + 8 * j);
        const float4 d = vals[u][j];
        const float mu = sum[u];
        var[u] += (ch < g.c ? (d.x - mu) * (d.x - mu) : 0.0f) +
                  (ch + 1 < g.c ? (d.y - mu) * (d.y - mu) : 0.0f) +
                  (ch + 2 < g.c ? (d.z - mu) * (d.z - mu) : 0.0f) +
                  (ch + 3 < g.c ? (d.w - mu) * (d.w - mu) : 0.0f);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) var[u] += __shfl_xor_sync(0xffffffffu, var[u], off);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!in[u]) continue;
      const float rstd = rsqrtf(var[u] * inv_c + kEps);
      const float mu = sum[u];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int ch = 4 * (sub + 8 * j);
        const float4 d = vals[u][j];
        const float4 wt = *reinterpret_cast<const float4*>(lw + ch);
        const float4 bs = *reinterpret_cast<const float4*>(lb + ch);
        float4 o;
        o.x = (d.x - mu) * rstd * wt.x + bs.x;
        o.y = (d.y - mu) * rstd * wt.y + bs.y;
        o.z = (d.z - mu) * rstd * wt.z + bs.z;
        o.w = (d.w - mu) * rstd * wt.w + bs.w;
        *reinterpret_cast<float4*>(hb + (base + p0 + 4 * u) * CP + ch) = o;
      }
    }
  }
}

// The taps of a tile, a warp per item: 32 channels (group gi), R tile rows
// from r, a row segment of `seg` tokens from column c0. Each lane slides a
// (kh + R - 1) x 3 window of its channel along the segment and keeps R
// outputs: for 3 x 3 taps R = 2, 4 halo values a column for 2 outputs and
// two independent sums.
template <int KH>
struct Taps {
  static constexpr int R = KH == 3 ? 2 : 1;
  static constexpr int WR = KH + R - 1;  // window rows
};

__device__ __forceinline__ void tap_item(const Geom& g, int it, int groups, int rows, int& gi,
                                         int& r, int& c0) {
  const int segs = g.tw / g.seg;
  gi = it % groups;
  const int rs = it / groups;
  r = rs / segs * rows;
  c0 = (rs % segs) * g.seg;
}

// q of the tile's tokens into qs [TH * TW][CP + 8] (0 outside the image)
template <int CP, int KH, int NT>
__device__ __forceinline__ void taps_q(const float* hx, float* qs, const float* __restrict__ taps,
                                       const Geom& g, int t, int warp, int lane) {
  constexpr int G = CP / 32;
  constexpr int QS = CP + 8;
  constexpr int R = Taps<KH>::R, WR = Taps<KH>::WR;
  const int hw = g.hw;
  const int y0 = (t / g.tiles_w) * g.th;
  const int x0 = (t % g.tiles_w) * g.tw;
  const int items = G * (g.th / R) * (g.tw / g.seg);
  for (int it = warp; it < items; it += NT / 32) {
    int gi, r, c0;
    tap_item(g, it, G, R, gi, r, c0);
    const int ch = gi * 32 + lane;
    float tp[KH][3];
#pragma unroll
    for (int di = 0; di < KH; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        tp[di][dj] = ch < g.c ? __ldg(taps + (di * 3 + dj) * 3 * g.c + ch) : 0.0f;
    const float* src = hx + (r * hw + c0) * CP + ch;
    float win[WR][3];
#pragma unroll
    for (int rr = 0; rr < WR; ++rr) {
      win[rr][0] = src[rr * hw * CP];
      win[rr][1] = src[(rr * hw + 1) * CP];
    }
    float* dst = qs + (r * g.tw + c0) * QS + ch;
#pragma unroll 4
    for (int j = 0; j < g.seg; ++j) {
#pragma unroll
      for (int rr = 0; rr < WR; ++rr) win[rr][2] = src[(rr * hw + j + 2) * CP];
      const bool col_in = x0 + c0 + j < g.w;
#pragma unroll
      for (int o = 0; o < R; ++o) {
        float a = 0.0f;
#pragma unroll
        for (int di = 0; di < KH; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) a = fmaf(win[o + di][dj], tp[di][dj], a);
        dst[(o * g.tw + j) * QS] = col_in && y0 + r + o < g.h ? a : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < WR; ++rr) {
        win[rr][0] = win[rr][1];
        win[rr][1] = win[rr][2];
      }
    }
  }
}

// k (this slice's channels n0..n0+NS) into ks [TH * TW][NS + 8] and v into
// the output, as taps_q
template <int CP, int NS, int KH, int NT>
__device__ __forceinline__ void taps_kv(const float* hy, float* ks, float* __restrict__ v,
                                        const float* __restrict__ taps, const Geom& g, int b,
                                        int t, int n0, int warp, int lane) {
  constexpr int G = NS / 32;
  constexpr int KS = NS + 8;
  constexpr int R = Taps<KH>::R, WR = Taps<KH>::WR;
  const int hw = g.hw;
  const int y0 = (t / g.tiles_w) * g.th;
  const int x0 = (t % g.tiles_w) * g.tw;
  const int items = G * (g.th / R) * (g.tw / g.seg);
  for (int it = warp; it < items; it += NT / 32) {
    int gi, r, c0;
    tap_item(g, it, G, R, gi, r, c0);
    const int ch = n0 + gi * 32 + lane;
    const bool ch_ok = ch < g.c;
    float tk[KH][3], tv[KH][3];
#pragma unroll
    for (int di = 0; di < KH; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const float* tap = taps + (di * 3 + dj) * 3 * g.c + ch;
        tk[di][dj] = ch_ok ? __ldg(tap + g.c) : 0.0f;
        tv[di][dj] = ch_ok ? __ldg(tap + 2 * g.c) : 0.0f;
      }
    const float* src = hy + (r * hw + c0) * CP + ch;
    float win[WR][3];
#pragma unroll
    for (int rr = 0; rr < WR; ++rr) {
      win[rr][0] = src[rr * hw * CP];
      win[rr][1] = src[(rr * hw + 1) * CP];
    }
    float* dst = ks + (r * g.tw + c0) * KS + gi * 32 + lane;
    float* vout = v + (((size_t)b * g.h + y0 + r) * g.w + x0 + c0) * g.c + ch;
#pragma unroll 4
    for (int j = 0; j < g.seg; ++j) {
#pragma unroll
      for (int rr = 0; rr < WR; ++rr) win[rr][2] = src[(rr * hw + j + 2) * CP];
      const bool col_in = x0 + c0 + j < g.w;
#pragma unroll
      for (int o = 0; o < R; ++o) {
        float ak = 0.0f, av = 0.0f;
#pragma unroll
        for (int di = 0; di < KH; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            ak = fmaf(win[o + di][dj], tk[di][dj], ak);
            av = fmaf(win[o + di][dj], tv[di][dj], av);
          }
        const bool in = col_in && y0 + r + o < g.h;
        dst[(o * g.tw + j) * KS] = in ? ak : 0.0f;
        if (in && ch_ok) vout[((size_t)o * g.w + j) * g.c] = av;
      }
#pragma unroll
      for (int rr = 0; rr < WR; ++rr) {
        win[rr][0] = win[rr][1];
        win[rr][1] = win[rr][2];
      }
    }
  }
}

template <int CP, int KH>
__global__ void __launch_bounds__(Width<CP>::NT, Width<CP>::MINB)
mdta_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ ln, const float* __restrict__ taps,
            float* __restrict__ v, float* __restrict__ part, Geom g, int nblk, bool vec4) {
  using W = Width<CP>;
  constexpr int NS = W::NS, WM = W::WM, NT = W::NT;
  constexpr int QS = CP + 8;
  constexpr int KS = NS + 8;
  constexpr int WN = 8 / WM;
  constexpr int KG = NT / 256;          // warp groups of 8 that split the Gram's tokens
  constexpr int MTW = CP / 16 / WM;     // Gram m-tiles (q channels) per warp
  constexpr int NTW = NS / 8 / WN;      // Gram n-tiles (k channels) per warp
  constexpr int SQ = 2 * NS;            // sq columns: q then k of this slice
  constexpr int P = NT / SQ;            // token phases of the sq sums
  static_assert(CP % 32 == 0 && NS % 32 == 0 && MTW * 16 * WM == CP && NTW * 8 * WN == NS,
                "width class");
  static_assert(SQ <= NT && (KG == 1 || KG == 2), "threads");
  extern __shared__ __align__(16) float smem[];
  const int hp = (g.th + KH - 1) * g.hw;
  const int tt = g.th * g.tw;
  float* hx = smem;               // [hp][CP] x halo, then xn
  float* hy = hx + hp * CP;       // [hp][CP] y halo, then yn
  float* qs = hy + hp * CP;       // [tt][QS]
  float* ks = qs + tt * QS;       // [tt][KS]
  float* lnw = ks + tt * KS;      // [4][CP]: lnx weight, bias, lny weight, bias

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // mma fragment row / column group
  const int tq = lane & 3;   // mma fragment thread in group
  const int blk = blockIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const int n0 = s * NS;
  const int sq_col = tid % SQ;
  const int sq_ph = tid / SQ;
  const int kg = warp / 8;  // this warp's share of the Gram's 8-token steps
  const int m0 = (warp % WM) * MTW * 16;
  const int nb0 = (warp % 8 / WM) * NTW * 8;
  const size_t map = (size_t)g.h * g.w * g.c;
  const float* xb = x + b * map;
  const float* yb = y + b * map;

  for (int i = tid; i < 4 * CP; i += NT) {
    const int row = i / CP;
    const int ch = i - row * CP;
    lnw[i] = ch < g.c ? ln[row * g.c + ch] : 0.0f;
  }
  if (blk < g.tiles) {
    load_halo<CP, KH, NT>(hx, xb, g, blk, vec4, tid);
    cp_async_commit();
    load_halo<CP, KH, NT>(hy, yb, g, blk, vec4, tid);
    cp_async_commit();
  }

  float acc[MTW][NTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  float sqa = 0.0f;

  for (int t = blk; t < g.tiles; t += nblk) {
    const int next = t + nblk;
    cp_async_wait<1>();  // x halo of t
    __syncthreads();
    layer_norm<CP, KH, NT>(hx, lnw, lnw + CP, g, t, warp, lane);
    __syncthreads();
    taps_q<CP, KH, NT>(hx, qs, taps, g, t, warp, lane);
    __syncthreads();
    if (next < g.tiles) load_halo<CP, KH, NT>(hx, xb, g, next, vec4, tid);
    cp_async_commit();
    cp_async_wait<1>();  // y halo of t
    __syncthreads();
    layer_norm<CP, KH, NT>(hy, lnw + 2 * CP, lnw + 3 * CP, g, t, warp, lane);
    __syncthreads();
    taps_kv<CP, NS, KH, NT>(hy, ks, v, taps, g, b, t, n0, warp, lane);
    __syncthreads();
    if (next < g.tiles) load_halo<CP, KH, NT>(hy, yb, g, next, vec4, tid);
    cp_async_commit();

    if (sq_ph < P) {
      const bool is_q = sq_col < NS;
      const float* src = is_q ? qs + n0 + sq_col : ks + sq_col - NS;
      const int st = is_q ? QS : KS;
      float a = sqa;
#pragma unroll 4
      for (int k = sq_ph; k < tt; k += P) {
        const float z = src[k * st];
        a = fmaf(z, z, a);
      }
      sqa = a;
    }
    for (int k0 = 8 * kg; k0 < tt; k0 += 8 * KG) {
      const float* qa = qs + (k0 + tq) * QS + m0 + gq;
      uint32_t ab[MTW][4], as[MTW][4];
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        split(qa[16 * i], ab[i][0], as[i][0]);
        split(qa[16 * i + 8], ab[i][1], as[i][1]);
        split(qa[4 * QS + 16 * i], ab[i][2], as[i][2]);
        split(qa[4 * QS + 16 * i + 8], ab[i][3], as[i][3]);
      }
      const float* kb = ks + (k0 + tq) * KS + nb0 + gq;
      uint32_t bb[NTW][2], bs[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        split(kb[8 * j], bb[j][0], bs[j][0]);
        split(kb[4 * KS + 8 * j], bb[j][1], bs[j][1]);
      }
      mma3(acc, ab, as, bb, bs);
    }
  }

  // this block's partial: qk [CP][NS] (the second warp group's sums added
  // to the first's), then sq [2][NS] (the token phases summed in phase
  // order), both through shared memory
  __syncthreads();  // the tiles no longer read
  float* red = smem;  // [CP][NS]: fits in the halos (checked on the host)
  if (kg == 1) {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int row = m0 + 16 * i + gq;
        const int col = nb0 + 8 * j + 2 * tq;
        red[row * NS + col] = acc[i][j][0];
        red[row * NS + col + 1] = acc[i][j][1];
        red[(row + 8) * NS + col] = acc[i][j][2];
        red[(row + 8) * NS + col + 1] = acc[i][j][3];
      }
  }
  qs[tid] = sqa;
  __syncthreads();
  float* pp = part + ((size_t)(b * gridDim.y + s) * nblk + blk) * (CP * NS + SQ);
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int row = m0 + 16 * i + gq;
        const int col = nb0 + 8 * j + 2 * tq;
        const bool two = KG == 2;
        pp[row * NS + col] = acc[i][j][0] + (two ? red[row * NS + col] : 0.0f);
        pp[row * NS + col + 1] = acc[i][j][1] + (two ? red[row * NS + col + 1] : 0.0f);
        pp[(row + 8) * NS + col] = acc[i][j][2] + (two ? red[(row + 8) * NS + col] : 0.0f);
        pp[(row + 8) * NS + col + 1] =
            acc[i][j][3] + (two ? red[(row + 8) * NS + col + 1] : 0.0f);
      }
  }
  if (tid < SQ) {
    float a = 0.0f;
#pragma unroll
    for (int ph = 0; ph < P; ++ph) a += qs[ph * SQ + tid];
    pp[CP * NS + tid] = a;
  }
}

// qk [B, C, C] and sq [B, 2, C]: each entry the sum of its partials
// [B][slices][nblk][CP * NS + 2 NS] in block order, padded rows and columns
// dropped
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ qk,
                             float* __restrict__ sq, int b, int c, int cp, int ns, int slices,
                             int nblk) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)c * c + 2 * c;
  if (e >= b * per) return;
  const int bi = (int)(e / per);
  const int r = (int)(e - bi * per);
  const bool is_qk = r < c * c;
  const int row = is_qk ? r / c : (r - c * c) / c;
  const int j = is_qk ? r % c : (r - c * c) % c;
  const int sl = j / ns;
  const size_t psz = (size_t)cp * ns + 2 * ns;
  const float* src = part + ((size_t)bi * slices + sl) * nblk * psz + (is_qk ? 0 : cp * ns) +
                     row * ns + j - sl * ns;
  float a = 0.0f;
#pragma unroll 8
  for (int k = 0; k < nblk; ++k) a += src[k * psz];
  if (is_qk)
    qk[(size_t)bi * c * c + r] = a;
  else
    sq[(size_t)bi * 2 * c + r - c * c] = a;
}

// C padded to its width class, its Gram columns per slice and its threads
template <int CP>
bool take(int c, int& cp, int& ns, int& nt) {
  if (c > CP) return false;
  cp = CP;
  ns = Width<CP>::NS;
  nt = Width<CP>::NT;
  return true;
}
bool width_class(int c, int& cp, int& ns, int& nt) {
  return c >= 1 && (take<32>(c, cp, ns, nt) || take<64>(c, cp, ns, nt) ||
                    take<96>(c, cp, ns, nt) || take<128>(c, cp, ns, nt) ||
                    take<192>(c, cp, ns, nt) || take<256>(c, cp, ns, nt));
}

size_t smem_bytes(int cp, int ns, int kh, int th, int tw) {
  const size_t halo = (size_t)(th + kh - 1) * (tw + 2);
  const size_t tt = (size_t)th * tw;
  return sizeof(float) * (2 * halo * cp + tt * (cp + 8) + tt * (ns + 8) + 4 * (size_t)cp);
}

template <int CP, int KH>
int launch(const float* x, const float* y, const float* ln, const float* taps, float* v,
           float* part, const Geom& g, int b, int nblk, bool vec4, size_t smem, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(mdta_kernel<CP, KH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  mdta_kernel<CP, KH><<<dim3(nblk, CP / Width<CP>::NS, b), Width<CP>::NT, smem, st>>>(
      x, y, ln, taps, v, part, g, nblk, vec4);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block for C at a tile of th x tw tokens, or -1 for
// C > 256 (the same count as ops/mdta.py : mdta_plan).
extern "C" long long rpeflow_mdta_smem_bytes(int c, int kh, int th, int tw) {
  int cp, ns, nt;
  if (!width_class(c, cp, ns, nt)) return -1;
  return (long long)smem_bytes(cp, ns, kh, th, tw);
}

// plan: int64 {scratch floats, B, H, W, C, kh, th, tw, seg, nblk}
// (ops/mdta.py : MdtaPlan): tiles of th x tw tokens cut in row segments of
// seg tokens, nblk blocks per batch element and slice; the scratch holds the
// partials, exactly B * slices * nblk * (CP * NS + 2 NS) floats. Two
// launches: the pass, then the sum of the partials. Refuses
// (cudaErrorInvalidValue) a plan it cannot run.
extern "C" int rpeflow_mdta_qkv(const float* x, const float* y, const float* ln,
                                const float* taps, float* v, float* qk, float* sq,
                                float* scratch, const long long* plan, void* stream) {
  const long long scratch_floats = plan[0];
  const int b = (int)plan[1], h = (int)plan[2], w = (int)plan[3], c = (int)plan[4];
  const int kh = (int)plan[5], th = (int)plan[6], tw = (int)plan[7], seg = (int)plan[8];
  const int nblk = (int)plan[9];
  int cp, ns, nt;
  if (!width_class(c, cp, ns, nt) || (kh != 1 && kh != 3) || b < 1 || b > 65535 ||
      h < 1 || w < 1 || th < 1 || tw < 1 || seg < 1 || tw % seg != 0 || (th * tw) % 8 != 0 ||
      nblk < 1 || (th + kh - 1) * (tw + 2) >= 65536 ||
      th % (kh == 3 ? Taps<3>::R : Taps<1>::R) != 0)
    return (int)cudaErrorInvalidValue;
  const int slices = cp / ns;
  const size_t smem = smem_bytes(cp, ns, kh, th, tw);
  const size_t halos = 2 * (size_t)(th + kh - 1) * (tw + 2) * cp;
  if (smem > kMaxSmemBytes ||
      scratch_floats != (long long)b * slices * nblk * ((long long)cp * ns + 2 * ns) ||
      (nt == 512 && halos < (size_t)cp * ns))  // the second warp group's Gram sums
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.h = h;
  g.w = w;
  g.c = c;
  g.th = th;
  g.tw = tw;
  g.seg = seg;
  g.tiles_w = (w + tw - 1) / tw;
  g.tiles = ((h + th - 1) / th) * g.tiles_w;
  g.hw = tw + 2;
  g.hw_magic = (unsigned)((((unsigned long long)1 << 32) + g.hw - 1) / g.hw);
  const bool vec4 =
      c % 4 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)y & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;

  int err = (int)cudaErrorInvalidValue;
#define RPEFLOW_MDTA_LAUNCH(CP)                                                                \
  err = kh == 3 ? launch<CP, 3>(x, y, ln, taps, v, scratch, g, b, nblk, vec4, smem, st)     \
                : launch<CP, 1>(x, y, ln, taps, v, scratch, g, b, nblk, vec4, smem, st)
  switch (cp) {
    case 32: RPEFLOW_MDTA_LAUNCH(32); break;
    case 64: RPEFLOW_MDTA_LAUNCH(64); break;
    case 96: RPEFLOW_MDTA_LAUNCH(96); break;
    case 128: RPEFLOW_MDTA_LAUNCH(128); break;
    case 192: RPEFLOW_MDTA_LAUNCH(192); break;
    case 256: RPEFLOW_MDTA_LAUNCH(256); break;
  }
#undef RPEFLOW_MDTA_LAUNCH
  if (err != cudaSuccess) return err;

  const long long outs = (long long)b * ((long long)c * c + 2 * c);
  sum_partials<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(scratch, qk, sq, b, c, cp, ns,
                                                              slices, nblk);
  return (int)cudaGetLastError();
}
