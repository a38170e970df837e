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
// What bounds it on the H100: the two products, 2 * 3h * C FLOPs per pixel
// (~60 GFLOP over one flagship forward), against 2 * C * 4 bytes of input
// and output per pixel, as long as the 2h-wide hidden map stays on chip.
// The products run on the tensor cores as 3xTF32 (each f32 operand split
// into a TF32 value and a TF32 remainder; three products, the two
// remainders' product dropped), which keeps f32 accuracy to ~2^-20: 3 *
// FLOPs at 495 TFLOP/s. A register-tiled f32 FMA version of this design was no
// faster than the plain composition: shared memory delivers one word per
// thread per transaction, against 4 FMAs per word at 8 x 8 outputs a thread.
//
// Design: one launch; the hidden map never leaves the SM (as the TPU
// kernel's (th+2)-row slab). A block of 8 warps owns a TH x 30 tile of
// output pixels and all C output channels:
//  * it loads the (TH+2) x 32 halo of x into shared memory once (cp.async,
//    16 bytes at a time where C allows), zero outside the image. GDFN has
//    no bias, so the halo's hidden values there are exactly the zero
//    padding the depthwise conv needs;
//  * it loops over chunks of 32 gate channels with their 32 value channels:
//    (a) hid[halo pixels, 64] = x_halo @ w_in[:, chunk] (mma.m16n8k8, each
//        warp 16 or 32 halo pixels x 64 channels) into shared memory;
//    (b) the 3x3 depthwise conv and the exact-GELU gate on the interior,
//        g[TH * 32, 32] into shared memory (rows padded to 32 columns, so
//        a warp reads one halo row without bank conflicts);
//    (c) y_acc[TH * 32, C] += g @ w_out[chunk, :] (mma, each warp a quarter
//        of the pixels x half of the channels), accumulated in registers
//        across chunks;
//    the next chunk's weights stream in with cp.async while the current
//    chunk computes (w_in during (b)-(c), w_out and the taps during (a));
//  * y is written once at the end.
// The mma fragments' shared-memory loads are free of bank conflicts: the x
// halo's pixel rows are padded by 4 floats, the other operands' rows are
// XOR-swizzled ((k & 3) << 3 on the column).
// The halo rows and columns are recomputed by neighbouring blocks (256 halo
// pixels for 180 outputs at TH = 6): ~40% more work in (a), which the bound
// does not count. TH = 6 for C <= 96 (144/72/36/18 rows and 240/120/60/30
// columns split exactly); TH = 2 above, where the x halo of up to 192
// channels would not fit otherwise, and on maps with few 6-row tiles.

#include <cuda_runtime.h>
#include <cstdint>

#include "sm90_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 30;           // output columns per tile
constexpr int kHW = kTW + 2;      // halo columns (32)
constexpr int kHC = 32;           // gate channels per chunk (+ as many value channels)
constexpr int kNC = 2 * kHC;      // hidden channels per chunk
// Below this many 6-row tiles a map takes 2-row tiles: a block's chunk loop
// is serial, so on small maps more blocks beat less halo recompute (the
// 36 x 60 maps, 48-96 tiles, are faster with 6 rows on an H100).
constexpr int kMinTallTiles = 40;

template <int TH, int CP>
struct Tile {
  static constexpr int HP = (TH + 2) * kHW;           // halo pixels: 256 or 128
  static constexpr int TPP = TH * kHW;                // output pixels, 32 a row: 192 or 64
  static constexpr int HS = HP + 1;                   // hid row stride
  static constexpr int MTA = HP / 128;                // (a): m-tiles per warp
  static constexpr int MTC = TPP / 64;                // (c): m-tiles per warp
  static constexpr int NTC = CP / 16;                 // (c): n-tiles per warp
  static size_t smem_floats(int c) {
    const size_t ck = (c + 7) / 8 * 8;
    return (ck + 4) * HP + ck * kNC + (size_t)kHC * CP + (size_t)kHC * TPP +
           (size_t)kNC * HS + 9 * kNC;
  }
};

// column swizzle of a shared-memory row k (row lengths are multiples of 32)
__device__ __forceinline__ int swz(int k, int col) { return col ^ ((k & 3) << 3); }

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// Columns of chunk j0 (gate j0.. -> 0..31, value h+j0.. -> 32..63, zero
// past the hidden width) of a [rows, 2h] matrix into dst [rows_pad][64]
// (rows from `rows` on zero; swizzled rows when `swizzle`). A thread keeps
// one column (kThreads is a multiple of 64) and steps over rows.
__device__ __forceinline__ void load_hidden_cols(float* dst, const float* src, int rows,
                                                 int rows_pad, int hidden, int j0, bool swizzle,
                                                 int tid) {
  constexpr int kRowStep = kThreads / kNC;
  const int j = tid % kNC;
  const int hc = j0 + (j % kHC);
  const bool col_ok = hc < hidden;
  const size_t stride = 2 * (size_t)hidden;
  const float* col = src + (j < kHC ? 0 : hidden) + hc;
  const int k0 = tid / kNC;
  const int dst_col = swizzle ? swz(k0, j) : j;  // k0 & 3 is the same on every row visited
  for (int k = k0; k < rows_pad; k += kRowStep) {
    const bool valid = col_ok && k < rows;
    cp_async4(dst + k * kNC + dst_col, valid ? col + k * stride : src, valid);
  }
}

// rows j0..j0+31 of w_out into wos [32][CP], swizzled; a warp per row
template <int CP>
__device__ __forceinline__ void load_out_chunk(float* wos, const float* w_out, int c, int hidden,
                                               int j0, int warp, int lane) {
  for (int k = warp; k < kHC; k += kThreads / 32) {
    const bool row_ok = j0 + k < hidden;
    const float* row = w_out + (size_t)(j0 + k) * c;
#pragma unroll
    for (int col = lane; col < CP; col += 32) {
      const bool valid = row_ok && col < c;
      cp_async4(wos + k * CP + swz(k, col), valid ? row + col : w_out, valid);
    }
  }
}

template <int TH, int CP>
__global__ void __launch_bounds__(kThreads, 1)
gdfn_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
            const float* __restrict__ w_dw, const float* __restrict__ w_out,
            float* __restrict__ out, int h, int w, int c, int hidden) {
  using T = Tile<TH, CP>;
  extern __shared__ __align__(16) float smem[];
  const int ck = (c + 7) / 8 * 8;
  const int xst = ck + 4;                   // x row stride: conflict-free fragments
  float* xs = smem;                          // [HP][xst]
  float* wis = xs + (size_t)T::HP * xst;     // [ck][64], swizzled
  float* wos = wis + (size_t)ck * kNC;       // [32][CP], swizzled
  float* gs = wos + kHC * CP;                // [32][TPP], swizzled
  float* hs = gs + kHC * T::TPP;             // [64][HS]
  float* wds = hs + kNC * T::HS;             // [9][64]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // mma fragment row / column group
  const int tq = lane & 3;   // mma fragment thread in group
  const int tiles_w = (w + kTW - 1) / kTW;
  const int tiles_h = (h + TH - 1) / TH;
  const int blk = blockIdx.x;
  const int b = blk / (tiles_w * tiles_h);
  const int ty = (blk / tiles_w) % tiles_h;
  const int tx = blk % tiles_w;
  const int y0 = ty * TH;
  const int x0 = tx * kTW;

  load_hidden_cols(wis, w_in, c, ck, hidden, 0, true, tid);
  load_hidden_cols(wds, w_dw, 9, 9, hidden, 0, false, tid);
  load_out_chunk<CP>(wos, w_out, c, hidden, 0, warp, lane);
  // x halo, pixel-major; 16-byte copies where the channels allow
  const int vec = (c % 4 == 0 && ((size_t)x & 15) == 0) ? 4 : 1;
  const int per_px = ck / vec;
  for (int e = tid; e < T::HP * per_px; e += kThreads) {
    const int hp = e / per_px;
    const int k = (e - hp * per_px) * vec;
    const int yy = y0 - 1 + hp / kHW;
    const int xx = x0 - 1 + hp % kHW;
    const bool valid = k < c && yy >= 0 && yy < h && xx >= 0 && xx < w;
    const float* src = valid ? x + (((size_t)b * h + yy) * w + xx) * c + k : x;
    if (vec == 4)
      cp_async16(xs + hp * xst + k, src, valid);
    else
      cp_async4(xs + hp * xst + k, src, valid);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float y[T::MTC][T::NTC][4];
#pragma unroll
  for (int i = 0; i < T::MTC; ++i)
#pragma unroll
    for (int j = 0; j < T::NTC; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) y[i][j][r] = 0.0f;
  const int cm0 = (warp & 3) * (16 * T::MTC);  // (c): this warp's first pixel
  const int cn0 = (warp >> 2) * (CP / 2);      // (c): this warp's first channel

  const int chunks = (hidden + kHC - 1) / kHC;
  for (int q = 0; q < chunks; ++q) {
    // (a) hid[halo pixel, 64] = x_halo @ w_in chunk
    {
      const int am0 = warp * (16 * T::MTA);
      float acc[T::MTA][8][4];
#pragma unroll
      for (int i = 0; i < T::MTA; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
      for (int k0 = 0; k0 < ck; k0 += 8) {
        const int k1 = k0 + tq;
        const int k2 = k1 + 4;
        uint32_t ab[T::MTA][4], as[T::MTA][4];
#pragma unroll
        for (int i = 0; i < T::MTA; ++i) {
          const int m = am0 + 16 * i + gq;
          split(xs[m * xst + k1], ab[i][0], as[i][0]);
          split(xs[(m + 8) * xst + k1], ab[i][1], as[i][1]);
          split(xs[m * xst + k2], ab[i][2], as[i][2]);
          split(xs[(m + 8) * xst + k2], ab[i][3], as[i][3]);
        }
        uint32_t bb[8][2], bs[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          split(wis[k1 * kNC + swz(k1, 8 * j + gq)], bb[j][0], bs[j][0]);
          split(wis[k2 * kNC + swz(k2, 8 * j + gq)], bb[j][1], bs[j][1]);
        }
        mma3(acc, ab, as, bb, bs);
      }
#pragma unroll
      for (int i = 0; i < T::MTA; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = am0 + 16 * i + gq;
          const int ch = 8 * j + 2 * tq;
          hs[ch * T::HS + m] = acc[i][j][0];
          hs[(ch + 1) * T::HS + m] = acc[i][j][1];
          hs[ch * T::HS + m + 8] = acc[i][j][2];
          hs[(ch + 1) * T::HS + m + 8] = acc[i][j][3];
        }
    }
    cp_async_wait_all();  // this chunk's w_out and taps
    __syncthreads();      // hid complete; w_in chunk no longer read
    if (q + 1 < chunks) load_hidden_cols(wis, w_in, c, ck, hidden, (q + 1) * kHC, true, tid);
    cp_async_commit();

    // (b) g[interior pixel, 32] = gelu(dw(hid gate)) * dw(hid value); each
    // warp takes 4 channels (taps in registers), its lanes the pixels
#pragma unroll 1
    for (int cc = 0; cc < kHC / 8; ++cc) {
      const int ch = warp * (kHC / 8) + cc;
      float tg[9], tv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        tg[t] = wds[t * kNC + ch];
        tv[t] = wds[t * kNC + kHC + ch];
      }
      // lanes take one row's columns, so the halo reads are free of bank
      // conflicts; columns 30 and 31 read finite values and store 0. No
      // branch, so the rows' chains interleave.
      const float keep = lane < kTW ? 1.0f : 0.0f;
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        const int p = r * kHW + lane;
        const int center = (r + 1) * kHW + lane + 1;
        const float* hg = hs + ch * T::HS + center;
        const float* hv = hs + (ch + kHC) * T::HS + center;
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            const int o = (di - 1) * kHW + dj - 1;
            a0 = fmaf(hg[o], tg[di * 3 + dj], a0);
            a1 = fmaf(hv[o], tv[di * 3 + dj], a1);
          }
        gs[ch * T::TPP + swz(ch, p)] = gelu_exact(a0) * a1 * keep;
      }
    }
    __syncthreads();

    // (c) y_acc += g @ w_out chunk
#pragma unroll
    for (int k0 = 0; k0 < kHC; k0 += 8) {
      const int k1 = k0 + tq;
      const int k2 = k1 + 4;
      uint32_t ab[T::MTC][4], as[T::MTC][4];
#pragma unroll
      for (int i = 0; i < T::MTC; ++i) {
        const int m = cm0 + 16 * i + gq;
        split(gs[k1 * T::TPP + swz(k1, m)], ab[i][0], as[i][0]);
        split(gs[k1 * T::TPP + swz(k1, m + 8)], ab[i][1], as[i][1]);
        split(gs[k2 * T::TPP + swz(k2, m)], ab[i][2], as[i][2]);
        split(gs[k2 * T::TPP + swz(k2, m + 8)], ab[i][3], as[i][3]);
      }
      uint32_t bb[T::NTC][2], bs[T::NTC][2];
#pragma unroll
      for (int j = 0; j < T::NTC; ++j) {
        split(wos[k1 * CP + swz(k1, cn0 + 8 * j + gq)], bb[j][0], bs[j][0]);
        split(wos[k2 * CP + swz(k2, cn0 + 8 * j + gq)], bb[j][1], bs[j][1]);
      }
      mma3(y, ab, as, bb, bs);
    }
    cp_async_wait_all();  // next chunk's w_in
    __syncthreads();      // w_out chunk, taps and g no longer read
    if (q + 1 < chunks) {
      load_out_chunk<CP>(wos, w_out, c, hidden, (q + 1) * kHC, warp, lane);
      load_hidden_cols(wds, w_dw, 9, 9, hidden, (q + 1) * kHC, false, tid);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < T::MTC; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = cm0 + 16 * i + gq + 8 * half;
      const int yy = y0 + p / kHW;
      const int xx = x0 + p % kHW;
      if (p % kHW >= kTW || yy >= h || xx >= w) continue;
      float* dst = out + (((size_t)b * h + yy) * w + xx) * c;
#pragma unroll
      for (int j = 0; j < T::NTC; ++j) {
        const int col = cn0 + 8 * j + 2 * tq;
        if (col < c) dst[col] = y[i][j][2 * half];
        if (col + 1 < c) dst[col + 1] = y[i][j][2 * half + 1];
      }
    }
}

template <int TH, int CP>
int launch(const float* x, const float* w_in, const float* w_dw, const float* w_out, float* out,
           int b, int h, int w, int c, int hidden, cudaStream_t st) {
  using T = Tile<TH, CP>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(gdfn_kernel<TH, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(T::smem_floats(CP) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long blocks = (long long)b * ((h + TH - 1) / TH) * ((w + kTW - 1) / kTW);
  gdfn_kernel<TH, CP><<<(unsigned)blocks, kThreads, T::smem_floats(c) * sizeof(float), st>>>(
      x, w_in, w_dw, w_out, out, h, w, c, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows of the output tile that rpeflow_gdfn takes at this shape: 6 up to
// 96 channels; 2 above 96 channels (shared memory) and on small maps
// (kMinTallTiles).
extern "C" int rpeflow_gdfn_tile_rows(int b, int h, int w, int c) {
  const long long tall_tiles = (long long)b * ((h + 5) / 6) * ((w + kTW - 1) / kTW);
  return c <= 96 && tall_tiles >= kMinTallTiles ? 6 : 2;
}

// C <= 192 (the wrapper checks).
extern "C" int rpeflow_gdfn(const float* x, const float* w_in, const float* w_dw,
                            const float* w_out, float* out, int b, int h, int w, int c,
                            int hidden, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool tall = rpeflow_gdfn_tile_rows(b, h, w, c) == 6;
#define RPEFLOW_GDFN_LAUNCH(TH, CP) \
  return launch<TH, CP>(x, w_in, w_dw, w_out, out, b, h, w, c, hidden, st)
  if (c <= 32) {
    if (tall) RPEFLOW_GDFN_LAUNCH(6, 32);
    RPEFLOW_GDFN_LAUNCH(2, 32);
  }
  if (c <= 64) {
    if (tall) RPEFLOW_GDFN_LAUNCH(6, 64);
    RPEFLOW_GDFN_LAUNCH(2, 64);
  }
  if (c <= 96) {
    if (tall) RPEFLOW_GDFN_LAUNCH(6, 96);
    RPEFLOW_GDFN_LAUNCH(2, 96);
  }
  if (c <= 128) RPEFLOW_GDFN_LAUNCH(2, 128);
  if (c <= 160) RPEFLOW_GDFN_LAUNCH(2, 160);
  if (c <= 192) RPEFLOW_GDFN_LAUNCH(2, 192);
#undef RPEFLOW_GDFN_LAUNCH
  return (int)cudaErrorInvalidValue;
}
