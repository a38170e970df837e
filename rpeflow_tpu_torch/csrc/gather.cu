// Batched KNN-style gathers on Hopper (sm_90a).
//
// Replaces: scripts/bench_gather.py : pallas_rows and pallas_rowloop (the
// row gather out[b, m, :] = table[b, idx[b, m], :], one with the whole
// [N, C] table resident in VMEM and a vector take over a 2048-row tile, the
// other with a per-row fori_loop; both compute the same function, so one
// kernel serves both) and pallas_lanes (the channels-first gather
// out[b, :, m] = table[b, :, idx[b, m]]).
//
// Contract, as in the Pallas kernels: 0 <= idx < N; nothing is checked.
//
// What bounds them on the H100: bytes. At the tool's shape (B = 4, N = 8192,
// C = 128 f32, M = N * 16) the output is 268.4 MB, the table 16.8 MB and the
// indices 2.1 MB: 85.8 us at 3.35 TB/s. Each table row is read about 16
// times, but the whole table fits the 50 MB L2, so device memory sees the
// output written once and the table read about once.
//
// Design:
//  * rows: a warp per output row, or a group of lanes per row where a row
//    is shorter than 32 words (C = 8 f32: 2 lanes a row, 16 rows a warp).
//    A row of C * itemsize bytes is copied as 16-byte words when the row
//    length and both base pointers allow it (C = 128 f32: 32 lanes x 16
//    bytes, one load and one store a lane), else as 4-byte or 2-byte words.
//    Each lane reads its row's index itself (a broadcast load within the
//    group). Loads of the table go through the L2; the output rows a warp
//    writes are contiguous.
//  * lanes, staged (a table row of N * itemsize bytes fits the 227 KB a
//    block may hold: N <= 58,112 f32 or 116,224 bf16): a block takes
//    (b, a group of g channels, a range of m) and copies its g rows, one
//    contiguous g * N span, into shared memory once: by the TMA engine
//    (cp.async.bulk, one copy a row, completion on an mbarrier) where the
//    table's base and N * itemsize are multiples of 16 bytes, else by plain
//    loads. It then walks its m range four consecutive m a thread: one
//    16-byte load of four int32 indices (two of int64), g x 4 reads of
//    shared memory, g stores of four entries (16 bytes f32, 8 bf16),
//    coalesced along m and marked evict-first (st.global.cs: the output
//    streams through the L2 without pushing out the indices, which every
//    channel group reads again). M not a multiple of 4, or an index or
//    output base that is not aligned for those words, takes the same walk
//    one m a thread. Device memory sees the table read once and the output
//    written once; the indices are read from the L2 once per channel group
//    (C / g times: 134 MB at the tool's shape, g = 2). The plan (g, threads,
//    splits of M) is ops/gather.py : lanes_plan: g = 2 where two rows fit,
//    512 threads, M split so that the blocks fill the SMs when B * C / g
//    is short of them. At the tool's shape: 256 blocks of 64 KB, three an
//    SM, all resident at once.
//  * lanes, through the L2 (a row larger than that): a thread per output
//    column m (consecutive threads, consecutive m), so every store is
//    coalesced along m; the thread loads idx[b, m] once and walks a chunk of
//    channels, reading table[b, c, idx] through the L2 (4 bytes of each
//    32-byte sector it pulls). Channels are split over gridDim.z so that
//    B * M / 256 * chunks blocks fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;  // 8 warps
constexpr int kLaneThreads = 256;
constexpr int kLaneChunk = 32;    // channels a thread of the L2 lanes kernel walks
constexpr long long kStageBytes = 232448;  // shared memory a block may take (227 KB)

// A row is copied by a group of `group` lanes (a power of two, 32 for rows
// of 32 words or more), so a warp copies 32 / group short rows at once.
template <typename W, typename I>
__global__ void __launch_bounds__(kRowThreads)
gather_rows_kernel(const W* __restrict__ table, const I* __restrict__ idx,
                   W* __restrict__ out, long long rows, long long m, long long n,
                   int words, int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const long long stride = (long long)gridDim.x * (kRowThreads / 32) * per_warp;
  for (long long r = ((long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5)) * per_warp +
                     lane / group;
       r < rows; r += stride) {
    const long long b = r / m;
    const long long src = b * n + (long long)__ldg(idx + r);
    const W* from = table + src * words;
    W* to = out + r * words;
    for (int k = lane % group; k < words; k += group) to[k] = __ldg(from + k);
  }
}

// Four entries of a row packed as one store: 16 bytes of f32, 8 of bf16.
template <typename T>
struct Pack4;
template <>
struct Pack4<uint32_t> {
  using type = uint4;
  static __device__ __forceinline__ uint4 make(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return make_uint4(a, b, c, d);
  }
};
template <>
struct Pack4<uint16_t> {
  using type = uint2;
  static __device__ __forceinline__ uint2 make(uint16_t a, uint16_t b, uint16_t c, uint16_t d) {
    return make_uint2((uint32_t)a | ((uint32_t)b << 16), (uint32_t)c | ((uint32_t)d << 16));
  }
};

// Four consecutive indices from a 16-byte-aligned address.
__device__ __forceinline__ void load4(const int* p, int (&i)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  i[0] = v.x, i[1] = v.y, i[2] = v.z, i[3] = v.w;
}
__device__ __forceinline__ void load4(const long long* p, int (&i)[4]) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  i[0] = (int)a.x, i[1] = (int)a.y, i[2] = (int)b.x, i[3] = (int)b.y;
}

// Block blockIdx.x = (b * groups + group) * splits + split: the g rows
// table[b, c0 : c0 + g, :] staged in shared memory, then the split's range
// of m. kVec: four m a thread (M % 4 == 0, chunk % 4 == 0, aligned bases).
template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(1024)
gather_lanes_staged_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                           T* __restrict__ out, int c, int n, long long m, int g, int splits,
                           long long chunk, int tma) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t staged;
  T* rows = reinterpret_cast<T*>(smem);
  const int groups = (c + g - 1) / g;
  const int split = blockIdx.x % splits;
  const long long bg = blockIdx.x / splits;
  const long long b = bg / groups;
  const int c0 = (int)(bg % groups) * g;
  const int gc = min(g, c - c0);
  const T* src = table + (b * c + c0) * n;
  if (tma) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(&staged);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const unsigned row_bytes = (unsigned)(n * sizeof(T));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(row_bytes * gc) : "memory");
      for (int k = 0; k < gc; ++k)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            ::"r"((unsigned)__cvta_generic_to_shared(rows + (long long)k * n)),
            "l"(src + (long long)k * n), "r"(row_bytes), "r"(bar) : "memory");
    }
    __syncthreads();  // the barrier is initialised before any thread waits on it
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  } else {
    for (long long j = threadIdx.x; j < (long long)gc * n; j += blockDim.x) rows[j] = src[j];
    __syncthreads();
  }
  const long long m0 = split * chunk;
  const long long m1 = min(m, m0 + chunk);
  const I* ib = idx + b * m;
  T* ob = out + (b * c + c0) * m;
  if (kVec) {
    using P = typename Pack4<T>::type;
    for (long long q = m0 + 4LL * threadIdx.x; q < m1; q += 4LL * blockDim.x) {
      int i[4];
      load4(ib + q, i);
#pragma unroll 4
      for (int k = 0; k < gc; ++k) {
        const T* r = rows + k * n;
        __stcs(reinterpret_cast<P*>(ob + k * m + q),
               Pack4<T>::make(r[i[0]], r[i[1]], r[i[2]], r[i[3]]));
      }
    }
  } else {
    for (long long q = m0 + threadIdx.x; q < m1; q += blockDim.x) {
      const int i = (int)__ldg(ib + q);
#pragma unroll 4
      for (int k = 0; k < gc; ++k) __stcs(ob + k * m + q, rows[k * n + i]);
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kLaneThreads)
gather_lanes_l2_kernel(const T* __restrict__ table, const I* __restrict__ idx,
                    T* __restrict__ out, int c, long long n, long long m) {
  const long long col = (long long)blockIdx.x * kLaneThreads + threadIdx.x;
  if (col >= m) return;
  const long long b = blockIdx.y;
  const int c0 = blockIdx.z * kLaneChunk;
  const int c1 = min(c, c0 + kLaneChunk);
  const long long src = (long long)__ldg(idx + b * m + col);
  const T* from = table + (b * c + c0) * n + src;
  T* to = out + (b * c + c0) * m + col;
#pragma unroll 8
  for (int k = 0; k < c1 - c0; ++k) to[k * m] = __ldg(from + k * n);
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p) % bytes == 0; }

template <typename I>
int launch_rows(const void* table, const I* idx, void* out, long long b, long long n,
                long long m, long long row_bytes, cudaStream_t st) {
  const long long rows = b * m;
  if (rows == 0 || row_bytes == 0) return 0;
  const int word = row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16) ? 16
                   : row_bytes % 4 == 0 && aligned(table, 4) && aligned(out, 4) ? 4
                   : row_bytes % 2 == 0 ? 2 : 0;
  if (word == 0) return (int)cudaErrorInvalidValue;
  const long long words = row_bytes / word;
  int group = 1;
  while (group < 32 && group < words) group *= 2;
  const long long rows_per_block = (kRowThreads / 32) * (32 / group);
  const long long want = (rows + rows_per_block - 1) / rows_per_block;
  const int blocks = (int)(want < 65535LL * 16 ? want : 65535LL * 16);
  if (word == 16)
    gather_rows_kernel<uint4, I><<<blocks, kRowThreads, 0, st>>>(
        (const uint4*)table, idx, (uint4*)out, rows, m, n, (int)words, group);
  else if (word == 4)
    gather_rows_kernel<uint32_t, I><<<blocks, kRowThreads, 0, st>>>(
        (const uint32_t*)table, idx, (uint32_t*)out, rows, m, n, (int)words, group);
  else
    gather_rows_kernel<uint16_t, I><<<blocks, kRowThreads, 0, st>>>(
        (const uint16_t*)table, idx, (uint16_t*)out, rows, m, n, (int)words, group);
  return (int)cudaGetLastError();
}

// Staged lanes (g > 0) for T the table's element bits and I the index type.
template <typename T, typename I>
int launch_lanes_staged(const T* table, const I* idx, T* out, long long b, long long c,
                        long long n, long long m, int g, int threads, int splits,
                        cudaStream_t st) {
  const long long smem = (long long)g * n * (long long)sizeof(T);
  const long long blocks = b * ((c + g - 1) / g) * splits;
  if (smem > kStageBytes || threads < 32 || threads > 1024 || threads % 32 || splits <= 0 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long chunk = ((m + splits - 1) / splits + 3) / 4 * 4;
  const bool vec = m % 4 == 0 && aligned(idx, 16) && aligned(out, 4 * sizeof(T));
  const int tma = aligned(table, 16) && (n * sizeof(T)) % 16 == 0;
  auto kernel =
      vec ? gather_lanes_staged_kernel<T, I, true> : gather_lanes_staged_kernel<T, I, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, (size_t)smem, st>>>(table, idx, out, (int)c, (int)n, m, g,
                                                          splits, chunk, tma);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_lanes_l2(const T* table, const I* idx, T* out, long long b, long long c, long long n,
                    long long m, cudaStream_t st) {
  if (b > 65535 || (c + kLaneChunk - 1) / kLaneChunk > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kLaneThreads - 1) / kLaneThreads), (unsigned)b,
                  (unsigned)((c + kLaneChunk - 1) / kLaneChunk));
  gather_lanes_l2_kernel<T, I><<<grid, kLaneThreads, 0, st>>>(table, idx, out, (int)c, n, m);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_lanes(const void* table, const I* idx, void* out, long long b, long long c,
                 long long n, long long m, int g, int threads, int splits, cudaStream_t st) {
  if (b == 0 || c == 0 || m == 0) return 0;
  return g > 0 ? launch_lanes_staged((const T*)table, idx, (T*)out, b, c, n, m, g, threads,
                                     splits, st)
               : launch_lanes_l2((const T*)table, idx, (T*)out, b, c, n, m, st);
}

}  // namespace

// table [B, N, row_bytes] (any element type), idx [B, M] int32 (idx64 = 0)
// or int64 (idx64 = 1) -> out [B, M, row_bytes]
extern "C" int rpeflow_gather_rows(const void* table, const void* idx, void* out, long long b,
                                   long long n, long long m, long long row_bytes, int idx64,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return idx64 ? launch_rows(table, (const long long*)idx, out, b, n, m, row_bytes, st)
               : launch_rows(table, (const int*)idx, out, b, n, m, row_bytes, st);
}

// table [B, C, N] of 4- or 2-byte elements, idx [B, M] -> out [B, C, M];
// g > 0: stage g rows a block (g * N * itemsize <= 227 KB), `threads` a
// block, M cut in `splits` ranges; g = 0: through the L2
extern "C" int rpeflow_gather_lanes(const void* table, const void* idx, void* out, long long b,
                                    long long c, long long n, long long m, int itemsize,
                                    int idx64, int g, int threads, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long* i64 = (const long long*)idx;
  const int* i32 = (const int*)idx;
  if (itemsize == 4)
    return idx64 ? launch_lanes<uint32_t>(table, i64, out, b, c, n, m, g, threads, splits, st)
                 : launch_lanes<uint32_t>(table, i32, out, b, c, n, m, g, threads, splits, st);
  if (itemsize == 2)
    return idx64 ? launch_lanes<uint16_t>(table, i64, out, b, c, n, m, g, threads, splits, st)
                 : launch_lanes<uint16_t>(table, i32, out, b, c, n, m, g, threads, splits, st);
  return (int)cudaErrorInvalidValue;
}
