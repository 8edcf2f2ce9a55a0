// GrooMeD-NMS's greedy grouping for Hopper (sm_90a).
//
// Computes what groomed_nms_tpu/ops/groomed_nms.py::group_leaders computes
// with a lax.while_loop (no TPU kernel: JAX leaves the loop to XLA), and
// what the port's plain version (ops/kernels.py::group_leaders_plain) does
// with batched products.  For B images of N score-sorted rows, an overlap
// matrix m [B, N, N] f32 (row i, column j, any asymmetry) and valid [B, N]:
//   * row i is a leader when it is valid and no earlier leader j < i has
//     m[i, j] > thr (strict f32 compare; NaN is never over);
//   * a valid row's group is the first leader j <= i with m[i, j] > thr (i
//     itself for a leader);
//   * its rank counts the valid rows k <= i of the same group; a row stays
//     in its group while rank < cap (cap = group_size + 1), else it and
//     every padding row get -1.
// Output leader [B, N] int64.
//
// What bounds it on this card: not bytes -- reading the lower triangle of m
// is 4.2 MB at [8, 512] (1.25 us at 3.35 TB/s) -- but the greedy chain, row
// block after row block, as in K2.  The design:
//   kernel 1 (group_bits): one 256-thread block per lower-triangle 64 x 64
//     tile (rb >= cb) of every image, each tile of m read once, 128 bytes a
//     warp load.  A warp thresholds a row's 64 columns into one word by two
//     ballots (`over`, row layout: row i, word cb, bit j for m[i, j] > thr,
//     j < i); the tile's 64 words, transposed by ballots in shared memory,
//     give `sup` in K2's column layout (row j, word rb, bit i for m[i, j] >
//     thr, i > j).  64 KB of bits an image at N = 512.
//   kernel 2 (group_sweep): one block per image.  The leaders are the
//     greedy survivors of `sup` among the valid rows: the sweep of
//     nms_sweep.cuh, K2's, with validity from `valid` (as bits in shared
//     memory) and the kept rows kept in shared memory.  Then, in the same
//     block, every thread takes rows: a non-leader's group is the lowest
//     set bit of over[i] & leaders, word by word.  Last one warp walks the
//     rows in order, 32 at a time: __match_any_sync finds the lanes of one
//     group, a counter per group in shared memory carries the ranks across
//     steps, and the output is written as int64.
// There is no host copy between the two kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_sweep.cuh"

namespace {

using nms::kBlock;
using nms::kFull;
using nms::kSweepThreads;
using nms::u64;

constexpr int kBitsThreads = 256;
constexpr int kBitsWarps = kBitsThreads / 32;
constexpr int kRowsPerWarp = kBlock / kBitsWarps;

// Block (x, b): lower-triangle tile x of image b, x -> (rb, cb) with
// rb >= cb (tile row rb starts at rb (rb + 1) / 2).
__global__ void __launch_bounds__(kBitsThreads)
group_bits(const float* __restrict__ m, u64* __restrict__ sup,
           u64* __restrict__ over, int n, int nwords, float thr) {
  __shared__ u64 sover[kBlock];
  const int b = blockIdx.y;
  const long long t = blockIdx.x;
  long long r = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  const int rb = (int)r, cb = (int)(t - r * (r + 1) / 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = cb * kBlock + lane, j1 = j0 + 32;

  float x0[kRowsPerWarp], x1[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {       // all loads in flight
    const int i = rb * kBlock + warp * kRowsPerWarp + k;
    const float* row = m + ((size_t)b * n + i) * n;
    x0[k] = i < n && j0 < n ? row[j0] : 0.0f;
    x1[k] = i < n && j1 < n ? row[j1] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int li = warp * kRowsPerWarp + k, i = rb * kBlock + li;
    const bool in = i < n;
    const u64 word =
        (u64)__ballot_sync(kFull, in && j0 < i && x0[k] > thr) |
        ((u64)__ballot_sync(kFull, in && j1 < i && x1[k] > thr) << 32);
    if (lane == 0) {
      sover[li] = word;
      if (in) over[((size_t)b * n + i) * nwords + cb] = word;
    }
  }
  __syncthreads();
  // sup[j][rb] for the tile's columns j: bit i of column j over the rows
  const u64 lo = sover[lane], hi = sover[lane + 32];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int lj = warp * kRowsPerWarp + k, j = cb * kBlock + lj;
    const u64 word = (u64)__ballot_sync(kFull, (lo >> lj) & 1ULL) |
                     ((u64)__ballot_sync(kFull, (hi >> lj) & 1ULL) << 32);
    if (lane == k && j < n) sup[((size_t)b * n + j) * nwords + rb] = word;
  }
}

// the sweep's rows: candidates from the valid bits, leaders kept in shared
// memory
struct LeaderRows {
  const u64* svalid;
  u64* sleader;

  __device__ __forceinline__ void prefetch(int, int, int, bool) {}
  __device__ __forceinline__ u64 valid(int, int rb, int) const {
    return svalid[rb];
  }
  __device__ __forceinline__ void kept(int rb, int lane, u64 kept) const {
    if (lane == 0) sleader[rb] = kept;
  }
};

__global__ void __launch_bounds__(kSweepThreads)
group_sweep(const uint8_t* __restrict__ valid, const u64* __restrict__ sup,
            const u64* __restrict__ over, long long* __restrict__ out, int n,
            int nwords, int cap) {
  extern __shared__ u64 smem[];
  u64* removed = smem;                          // nwords
  u64* svalid = removed + nwords;               // nwords
  u64* sleader = svalid + nwords;               // nwords
  int* sfirst = reinterpret_cast<int*>(sleader + nwords);   // n
  int* count = sfirst + n;                      // n
  const int b = blockIdx.x, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32, warps = blockDim.x / 32;
  const uint8_t* v = valid + (size_t)b * n;
  for (int w = warp; w < nwords; w += warps) {
    const int r0 = w * kBlock + lane, r1 = r0 + 32;
    const u64 bits =
        (u64)__ballot_sync(kFull, r0 < n && v[r0] != 0) |
        ((u64)__ballot_sync(kFull, r1 < n && v[r1] != 0) << 32);
    if (lane == 0) svalid[w] = bits;
  }
  for (int i = t; i < n; i += blockDim.x) count[i] = 0;

  LeaderRows rows{svalid, sleader};
  nms::greedy_sweep(sup + (size_t)b * n * nwords, n, nwords, removed, rows);

  // every row's group: itself for a leader, else the first leader it is
  // over (a valid non-leader always has one), -1 for padding
  const u64* ov = over + (size_t)b * n * nwords;
  for (int i = t; i < n; i += blockDim.x) {
    const int w = i / kBlock, bit = i % kBlock;
    int first = -1;
    if ((svalid[w] >> bit) & 1ULL) {
      if ((sleader[w] >> bit) & 1ULL) {
        first = i;
      } else {
        const u64* row = ov + (size_t)i * nwords;
        for (int k = 0; k <= w; ++k) {
          const u64 hit = row[k] & sleader[k];
          if (hit) {
            first = k * kBlock + __ffsll((long long)hit) - 1;
            break;
          }
        }
      }
    }
    sfirst[i] = first;
  }
  __syncthreads();
  if (warp != 0) return;
  // ranks in row order, 32 rows a step
  long long* o = out + (size_t)b * n;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int first = i < n ? sfirst[i] : -1;
    const unsigned peers = __match_any_sync(kFull, first >= 0 ? first
                                                              : n + lane);
    const int rank = first >= 0 ? count[first] + __popc(peers & below) : 0;
    __syncwarp();
    // the group's last lane in this step carries its count on
    if (first >= 0 && (peers >> lane) == 1u) count[first] += __popc(peers);
    __syncwarp();
    if (i < n) o[i] = first >= 0 && rank < cap ? first : -1;
  }
}

}  // namespace

// m [B, N, N] f32, valid [B, N] bool as bytes, sup / over scratch
// [B, N, nwords] u64, out [B, N] int64; all contiguous on the current
// device.  cap = group_size + 1 clamped to [0, N + 1].  Launches on
// `stream` and returns cudaGetLastError() as an int (cudaErrorInvalidValue
// for a size the grids cannot hold).
extern "C" int group_leaders(const void* m, const void* valid, void* sup,
                             void* over, void* out, int batch, int n,
                             float thr, int cap, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int nwords = (n + kBlock - 1) / kBlock;
  const long long tiles = (long long)nwords * (nwords + 1) / 2;
  if (tiles > 0x7fffffffLL || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  group_bits<<<dim3((unsigned)tiles, batch), kBitsThreads, 0, s>>>(
      static_cast<const float*>(m), static_cast<u64*>(sup),
      static_cast<u64*>(over), n, nwords, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 3 * nwords * sizeof(u64) + 2 * (size_t)n * sizeof(int);
  err = cudaFuncSetAttribute(group_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  group_sweep<<<batch, kSweepThreads, smem, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const u64*>(sup),
      static_cast<const u64*>(over), static_cast<long long*>(out), n, nwords,
      cap);
  return (int)cudaGetLastError();
}
