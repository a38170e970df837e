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
// What bounds it on the H100: bytes. At the tool's shape (B = 4, N = 8192,
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
//  * lanes: a thread per output column m (consecutive threads, consecutive
//    m), so every store is coalesced along m; the thread loads idx[b, m]
//    once and walks a chunk of channels, reading table[b, c, idx] through
//    the L2 (the table is read scattered along N). Channels are split over
//    gridDim.z so that B * M / 256 * chunks blocks fill the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;  // 8 warps
constexpr int kLaneThreads = 256;
constexpr int kLaneChunk = 32;    // channels a lanes thread walks

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

template <typename T, typename I>
__global__ void __launch_bounds__(kLaneThreads)
gather_lanes_kernel(const T* __restrict__ table, const I* __restrict__ idx,
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

template <typename I>
int launch_lanes(const void* table, const I* idx, void* out, long long b, long long c,
                 long long n, long long m, int itemsize, cudaStream_t st) {
  if (b == 0 || c == 0 || m == 0) return 0;
  if (b > 65535 || (c + kLaneChunk - 1) / kLaneChunk > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((m + kLaneThreads - 1) / kLaneThreads), (unsigned)b,
                  (unsigned)((c + kLaneChunk - 1) / kLaneChunk));
  if (itemsize == 4)
    gather_lanes_kernel<uint32_t, I><<<grid, kLaneThreads, 0, st>>>(
        (const uint32_t*)table, idx, (uint32_t*)out, (int)c, n, m);
  else if (itemsize == 2)
    gather_lanes_kernel<uint16_t, I><<<grid, kLaneThreads, 0, st>>>(
        (const uint16_t*)table, idx, (uint16_t*)out, (int)c, n, m);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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

// table [B, C, N] of 4- or 2-byte elements, idx [B, M] -> out [B, C, M]
extern "C" int rpeflow_gather_lanes(const void* table, const void* idx, void* out, long long b,
                                    long long c, long long n, long long m, int itemsize,
                                    int idx64, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return idx64 ? launch_lanes(table, (const long long*)idx, out, b, c, n, m, itemsize, st)
               : launch_lanes(table, (const int*)idx, out, b, c, n, m, itemsize, st);
}
