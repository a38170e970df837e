// The 2-D decoder's 3x3 convolutions on Hopper (sm_90a): a direct f32
// implicit GEMM, forward only.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (rpeflow_tpu/nn/layers.py : ConvNormAct, lax.conv_general_dilated). Added
// because at the decoder's shapes (96 to 243 input channels, 32 to 192
// output channels, a quarter of the frame down to 1/64) cuDNN's heuristic
// sends the widest of these convs to an FFT algorithm of tens of thousands
// of launches and hundreds of ms a forward.
//
// With zero padding d, dilation d, stride 1 and channels-last maps:
//   out[b, y, x, n] = bias[n] + sum_{ty, tx, c} w[n, c, ty, tx]
//                               * in[b, y + (ty - 1) d, x + (tx - 1) d, c]
// in [B, H, W, Cin] and out [B, H, W, Cout] f32, contiguous; w [Cout, Cin, 3,
// 3] as PyTorch stores it.
//
// What bounds it on the H100: operations. A pixel costs 2 * 9 * Cin * Cout
// FLOP against 4 (Cin + Cout) bytes (conv1, 243 -> 192: 1,931 FLOP a byte),
// far above the card's 20 FLOP a byte for f32 on the CUDA cores; at 67
// TFLOP/s the decoder's 55 convs of an FT3D forward take 7.8 ms at least.
// Products and sums are f32 FFMA: no TF32, no tensor cores.
//
// Design (the tile, BM x BN, is Python: ops/conv3x3.py : conv3x3_plan; the
// entry point refuses a plan it cannot run):
// * A GEMM of M = B H W pixels by N = Cout by K = 9 Cin, walked as chunks of
//   CK input channels (outer) and the 9 taps (inner): one step is one tap
//   of one chunk. A block of 128 threads (16 pixel lanes x 8 channel lanes)
//   owns BM = 16 TM pixels by BN = 8 TN output channels; a thread owns TM
//   pixels (lane, lane + 16, ...) by TN channels (4 lane + [0, 4), and 32 +
//   4 lane + [0, 4) at TN = 8), so that the float4 reads of a warp hit
//   distinct bank groups. TM, TN are 8 or 4, CK 16, or 32 for the smallest
//   tile: a map too small to fill the card with blocks runs each block's
//   steps one after another, and a step's fixed cost (its barrier, its
//   copies' latency) is then the time; twice the channels a step halves
//   the steps.
// * The input tile of a step (BM pixels shifted by the tap, CK channels)
//   goes by cp.async into a kStages-deep ring in shared memory, issued
//   kStages - 1 steps ahead: 16-byte copies where Cin % 4 == 0 (every pixel
//   row then starts 16-byte aligned), 8-byte where Cin % 4 == 2 (98
//   channels), 4-byte where Cin is odd (243: a 243-float row is 972 bytes).
//   Taps outside the frame, pixels past M and channels past Cin are
//   zero-filled; a step skips the groups of 4 channels that lie wholly past
//   Cin.
// * The weights of a chunk, w[n0 + n, c0 + c, :, :], are one run of 9 CK
//   floats for each output channel: copied whole (cp.async, coalesced; 16
//   bytes where Cin % 4 == 0, else 4) with the chunk's first step, then
//   transposed once in shared memory to [tap][c][n] (a float4 of a run
//   read, its 4 floats written to 4 rows), from which a thread reads its TN
//   channels as float4s. No copy kernel runs per call.
// * The epilogue adds the bias and stores each pixel's channels as float4s
//   (Cout % 4 == 0). No atomics and no split of K: every output is one
//   thread's sum in a fixed order, so two calls are bitwise equal.

#include <cuda_runtime.h>

#include "sm90_helpers.cuh"

namespace {

constexpr int kThreads = 128;  // 16 pixel lanes x 8 channel lanes
constexpr int kTaps = 9;
constexpr int kStages = 4;     // the input tiles' ring
constexpr int kBlocksPerSm = 2;
constexpr int kSmemLimit = 232448;

// The plan, as ops/conv3x3.py : Conv3x3Plan.c_plan writes it.
struct Plan {
  long long b, h, w, cin, cout, d, bm, bn, ck;
};

// A block's tile: BM = 16 TM pixels by BN = 8 TN output channels, CK input
// channels a step.
template <int TM_, int TN_, int CK_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, CK = CK_;
  static constexpr int kBm = 16 * TM, kBn = 8 * TN;
  static constexpr int kGroups = CK / 4;                   // 4-channel groups of a pixel
  static constexpr int kUnits = kBm * kGroups / kThreads;  // (pixel, group) a thread stages
  static constexpr int kSa = CK + 4;                       // floats a staged pixel: 16-byte
                                                           // rows, 4 consecutive rows on
                                                           // distinct bank groups
  static constexpr int kRun = CK * kTaps;                  // a chunk's weights per channel
  static constexpr int kRawStride = kRun + 4;              // 16-byte rows, 8 consecutive rows
                                                           // on distinct bank groups
  static constexpr int kRing = kStages * kBm * kSa;
  static constexpr int kRaw = kBn * kRawStride;
  static constexpr int kTrans = kTaps * CK * kBn;
  static constexpr int kSmemBytes = 4 * (kRing + kRaw + kTrans);
};

template <class T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ out, int h, int w,
                   int cin, int cout, int d, int m_total, int n_tiles, int x_width,
                   bool w_vec) {
  constexpr int TM = T::TM, TN = T::TN, CK = T::CK, kSa = T::kSa, kRun = T::kRun;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;            // [kStages][kBm][kSa]
  float* raw = ring + T::kRing;  // [kBn][kRawStride]: w[n0 + n, c0 + j / 9, j % 9] at j
  float* trans = raw + T::kRaw;  // [kTaps][CK][kBn]

  const int tid = threadIdx.x;
  const int tm = tid >> 3, tn = tid & 7;
  const int n0 = (blockIdx.x % n_tiles) * T::kBn;
  const int m0 = (blockIdx.x / n_tiles) * T::kBm;
  const int hw = h * w;

  // the pixels this thread stages, tid / G + (128 / G) r, and its 4 channels
  // of each chunk, 4 (tid % G) + [0, 4), G = CK / 4
  const int cg = 4 * (tid % T::kGroups);
  const int mt = tid / T::kGroups;
  constexpr int kMStride = kThreads / T::kGroups;
  int py[T::kUnits], px[T::kUnits], poff[T::kUnits];
#pragma unroll
  for (int r = 0; r < T::kUnits; ++r) {
    const int p = m0 + mt + kMStride * r;
    if (p < m_total) {
      const int rem = p % hw;
      py[r] = rem / w;
      px[r] = rem - py[r] * w;
      poff[r] = p * cin;
    } else {  // outside the frame at every tap
      py[r] = -(1 << 28);
      px[r] = 0;
      poff[r] = 0;
    }
  }

  const int chunks = (cin + CK - 1) / CK;
  const int steps = chunks * kTaps;

  // Issue the copies of step s (tap s % 9 of chunk s / 9) into its ring slot,
  // with the chunk's weights at its first tap; one commit group a step.
  auto issue = [&](int s) {
    const int chunk = s / kTaps, tap = s - chunk * kTaps;
    const int c0 = chunk * CK;
    const int dy = (tap / 3 - 1) * d, dx = (tap % 3 - 1) * d;
    float* slot = ring + (s % kStages) * (T::kBm * kSa);
    const int c = c0 + cg;
#pragma unroll
    for (int r = 0; r < T::kUnits; ++r) {
      const int y = py[r] + dy, xx = px[r] + dx;
      const bool in = (unsigned)y < (unsigned)h && (unsigned)xx < (unsigned)w;
      const float* src = x + (in ? poff[r] + (dy * w + dx) * cin + c : 0);
      float* dst = slot + (mt + kMStride * r) * kSa + cg;
      if (x_width == 4) {
        const bool ok = in && c < cin;
        cp_async16(dst, ok ? src : x, ok);
      } else if (x_width == 2) {
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          const bool ok = in && c + q < cin;
          cp_async8(dst + q, ok ? src + q : x, ok);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = in && c + q < cin;
          cp_async4(dst + q, ok ? src + q : x, ok);
        }
      }
    }
    if (tap == 0) {
      const int valid = min(kRun, (cin - c0) * kTaps);
      if (w_vec) {  // Cin % 4 == 0: every run starts 16-byte aligned, valid % 4 == 0
        for (int e = tid; e < T::kBn * (kRun / 4); e += kThreads) {
          const int n = e / (kRun / 4), j = 4 * (e - n * (kRun / 4));
          const bool ok = n0 + n < cout && j < valid;
          cp_async16(raw + n * T::kRawStride + j,
                     ok ? wt + ((size_t)(n0 + n) * cin + c0) * kTaps + j : wt, ok);
        }
      } else {
        for (int e = tid; e < T::kBn * kRun; e += kThreads) {
          const int n = e / kRun, j = e - n * kRun;
          const bool ok = n0 + n < cout && j < valid;
          cp_async4(raw + n * T::kRawStride + j,
                    ok ? wt + ((size_t)(n0 + n) * cin + c0) * kTaps + j : wt, ok);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    else cp_async_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed (this thread's copies) ...
    __syncthreads();               // ... and everyone's; slot s - 1 is free
    const int chunk = s / kTaps, tap = s - chunk * kTaps;
    if (tap == 0) {  // the chunk's weights, [n][c 9 + t] -> [t][c][n], 4 j a read
      for (int e = tid; e < T::kBn * (kRun / 4); e += kThreads) {
        const int n = e % T::kBn, j = 4 * (e / T::kBn);
        const float4 v = *reinterpret_cast<const float4*>(raw + n * T::kRawStride + j);
        const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = (j + q) / kTaps, t = j + q - c * kTaps;
          trans[(t * CK + c) * T::kBn + n] = vals[q];
        }
      }
      __syncthreads();  // the weights are in place, and raw may be refilled
    }
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    else cp_async_commit();

    const float* a = ring + (s % kStages) * (T::kBm * kSa);
    const float* bk = trans + tap * (CK * T::kBn) + 4 * tn;
    const int valid = cin - chunk * CK;
#pragma unroll
    for (int kq = 0; kq < CK / 4; ++kq) {
      if (4 * kq >= valid) break;
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (tm + 16 * i) * kSa + 4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int half = 0; half < TN / 4; ++half) {
          const float4 v =
              *reinterpret_cast<const float4*>(bk + (4 * kq + kk) * T::kBn + 32 * half);
          bv[4 * half] = v.x;
          bv[4 * half + 1] = v.y;
          bv[4 * half + 2] = v.z;
          bv[4 * half + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait_all();

  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + 32 * (j / 4) + 4 * tn + j % 4;
    bv[j] = bias != nullptr && n < cout ? bias[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + tm + 16 * i;
    if (p >= m_total) break;
#pragma unroll
    for (int half = 0; half < TN / 4; ++half) {
      const int n = n0 + 32 * half + 4 * tn;
      if (n < cout) {
        const int j = 4 * half;
        *reinterpret_cast<float4*>(out + (size_t)p * cout + n) =
            make_float4(acc[i][j] + bv[j], acc[i][j + 1] + bv[j + 1], acc[i][j + 2] + bv[j + 2],
                        acc[i][j + 3] + bv[j + 3]);
      }
    }
  }
}

// ------------------------------------------------------------ host side

// f(Tile<...>{}) for the plan's tile, -1 for a tile the kernel has not
template <class F>
long long with_tile(long long bm, long long bn, long long ck, F&& f) {
  if (bm == 128 && bn == 64 && ck == 16) return f(Tile<8, 8, 16>{});
  if (bm == 128 && bn == 32 && ck == 16) return f(Tile<8, 4, 16>{});
  if (bm == 64 && bn == 64 && ck == 16) return f(Tile<4, 8, 16>{});
  if (bm == 64 && bn == 32 && ck == 16) return f(Tile<4, 4, 16>{});
  if (bm == 64 && bn == 32 && ck == 32) return f(Tile<4, 4, 32>{});
  return -1;
}

bool plan_ok(const Plan& p) {
  if (p.b < 1 || p.h < 1 || p.w < 1 || p.cin < 1 || p.cout < 4 || p.cout % 4 || p.d < 1)
    return false;
  const long long s = with_tile(p.bm, p.bn, p.ck, [](auto t) { return decltype(t)::kSmemBytes; });
  if (s < 0 || kBlocksPerSm * s > kSmemLimit) return false;
  const long long m = p.b * p.h * p.w;
  const long long lim = 1LL << 31;
  if (m * p.cin >= lim || m * p.cout >= lim || 9 * p.cin * p.cout >= lim) return false;
  // a tap's offset (d W + d) Cin stays inside an int
  if ((p.d * (p.w + 1) + m) * p.cin >= lim) return false;
  return ((m + p.bm - 1) / p.bm) * ((p.cout + p.bn - 1) / p.bn) < lim;
}

template <class T>
int prepare() {
  auto kern = conv3x3_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
}

template <class T>
int launch(const float* x, const float* w, const float* bias, float* out, const Plan& p,
           cudaStream_t st) {
  const int err = prepare<T>();
  if (err != 0) return err;
  const long long m = p.b * p.h * p.w;
  const int n_tiles = (int)((p.cout + T::kBn - 1) / T::kBn);
  const long long blocks = ((m + T::kBm - 1) / T::kBm) * n_tiles;
  // the widest copies of the input rows and the weight runs their alignment allows
  const auto aligned = [](const float* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int x_width = !aligned(x) ? 1 : p.cin % 4 == 0 ? 4 : p.cin % 2 == 0 ? 2 : 1;
  conv3x3_fwd_kernel<T><<<(unsigned)blocks, kThreads, T::kSmemBytes, st>>>(
      x, w, bias, out, (int)p.h, (int)p.w, (int)p.cin, (int)p.cout, (int)p.d, (int)m, n_tiles,
      x_width, aligned(w) && p.cin % 4 == 0);
  return (int)cudaGetLastError();
}

template <class T>
int occupancy() {
  int blocks = -1;
  if (prepare<T>() != 0 || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &blocks, conv3x3_fwd_kernel<T>, kThreads, T::kSmemBytes) !=
                               cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// Shared memory of one block of the (bm, bn, ck) tile, -1 for a tile the
// kernel has not.
extern "C" long long rpeflow_conv3x3_smem_bytes(int bm, int bn, int ck) {
  return with_tile(bm, bn, ck, [](auto t) { return decltype(t)::kSmemBytes; });
}

// Blocks of the (bm, bn, ck) tile an SM of the current device holds at once,
// -1 for a tile the kernel has not or a failed query.
extern "C" int rpeflow_conv3x3_blocks_per_sm(int bm, int bn, int ck) {
  return (int)with_tile(bm, bn, ck, [](auto t) { return occupancy<decltype(t)>(); });
}

// plan: int64 (B, H, W, Cin, Cout, d, BM, BN, CK); bias may be null
extern "C" int rpeflow_conv3x3(const float* x, const float* w, const float* bias, float* out,
                               const long long* plan, void* stream) {
  const Plan p = *reinterpret_cast<const Plan*>(plan);
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)with_tile(p.bm, p.bn, p.ck, [&](auto t) {
    return launch<decltype(t)>(x, w, bias, out, p, st);
  });
}
