// Batched exact greedy NMS for Hopper (sm_90a), bitmask design.
//
// Replaces the TPU kernel groomed_nms_tpu/ops/pallas_kernels.py::
// greedy_nms_pallas (body _nms_kernel).  Rows are score-sorted per image; a
// row with score <= 0 is padding: it is never kept and suppresses nothing.
// Row j suppresses a later row i when
//     inter / max(area_i + area_j - inter, 1e-12) > thr
// with the +shift pixel convention, written in the same operation order as
// _nms_kernel.  Build with -fmad=false and without --use_fast_math, so every
// product, sum and quotient rounds on its own exactly as the plain PyTorch
// version's separate ops do, and a keep decision on an IoU next to the
// threshold matches it bit for bit.
//
// What bounds it on this card: not bytes (boxes, scores and keep are ~0.2 MB
// at B=8, N=3000) but the sequential dependence of greedy NMS, block after
// block of rows, and the O(N^2) IoU tests (36 M at B=8, N=3000).  The design
// takes the tests off that chain and keeps the chain in registers:
//   kernel 1 (nms_mask): tiles of (image, 64-row block rb, 64-column block
//     cb >= rb) on a triangular grid (a linear index mapped to (rb, cb): no
//     tile of the lower triangle is launched), two tiles a 128-thread
//     block.  It writes one uint64 per row per column block, bit c set when
//     the row suppresses column cb*64+c, later columns only (words before
//     the row block are never written nor read).  A thread owns one row of
//     a tile and runs its 64 tests, against column boxes and areas staged
//     once in shared memory, without a branch from an approximate quotient;
//     the few within 2^-16 of the threshold are divided exactly (IEEE)
//     after, so every bit is the one the plain version's division gives.  A
//     warp whose 32 rows are all padding writes nothing: none of them is
//     kept, so the sweep never reads their words.
//   kernel 2 (nms_sweep): one block per image, the greedy sweep of
//     nms_sweep.cuh (shared with the GrooMeD grouping kernel), a row's
//     validity its score > 0, prefetched beside its mask words.
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

constexpr int kMaskThreads = 128;           // 64 rows x 2 tiles

__device__ __forceinline__ float box_area(float4 b, float shift) {
  return (b.z - b.x + shift) * (b.w - b.y + shift);
}

// The IoU test's operands, in _nms_kernel's order: (min - max) + shift,
// clamp at 0, the product; (aa + ac) - inter, clamp at 1e-12
__device__ __forceinline__ void inter_union(float4 a, float aa, float4 c,
                                            float ac, float shift,
                                            float& inter, float& uni) {
  const float iw = fmaxf(fminf(a.z, c.z) - fmaxf(a.x, c.x) + shift, 0.0f);
  const float ih = fmaxf(fminf(a.w, c.w) - fmaxf(a.y, c.y) + shift, 0.0f);
  inter = iw * ih;
  uni = fmaxf(aa + ac - inter, 1e-12f);
}

// true when box `a` (area aa) and box `c` (area ac) overlap above thr:
// the IEEE quotient, as the plain version divides
__device__ __forceinline__ bool overlaps(float4 a, float aa, float4 c,
                                         float ac, float thr, float shift) {
  float inter, uni;
  inter_union(a, aa, c, ac, shift, inter, uni);
  return inter / uni > thr;
}

// 1 / x within 1 ulp (PTX rcp.approx.f32) for a normal x whose reciprocal
// is normal
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// bits [from, to) of a 32-bit word, the bounds clamped to [0, 32]
__device__ __forceinline__ uint32_t bit_range(int from, int to) {
  from = max(from, 0);
  to = min(to, 32);
  if (from >= to) return 0u;
  const uint32_t below_to = to == 32 ? 0xffffffffu : (1u << to) - 1u;
  return below_to & ~((1u << from) - 1u);
}

// Block (x, b): its two halves take tiles 2x and 2x + 1 of the upper
// triangle of image b's nwords x nwords tiles (nwords - rb tiles for row
// block rb); a thread owns one row and all 64 columns of its half's tile.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask(const float4* __restrict__ boxes, const float* __restrict__ scores,
         u64* __restrict__ mask, int n, int nwords, float thr, float shift) {
  const int t = threadIdx.x;
  const int i = t % kBlock, half = t / kBlock;
  const int b = blockIdx.y;
  // u counts the tiles from the end: the row block with r + 1 tiles (r =
  // nwords - 1 - rb) starts at u = r (r + 1) / 2.  A half past the last
  // tile takes row block nwords, which has no rows.
  const long long tiles = (long long)nwords * (nwords + 1) / 2;
  const long long tile = 2LL * blockIdx.x + half;
  const bool live = tile < tiles;
  const long long u = live ? tiles - 1 - tile : 0;
  long long r = (long long)((sqrt(8.0 * (double)u + 1.0) - 1.0) * 0.5);
  while (r * (r + 1) / 2 > u) --r;
  while ((r + 1) * (r + 2) / 2 <= u) ++r;
  const int rb = live ? nwords - 1 - (int)r : nwords;
  const int cb = nwords - 1 - (int)(u - r * (r + 1) / 2);

  __shared__ float4 cbox[2][kBlock];
  __shared__ float carea[2][kBlock];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int col0 = cb * kBlock;
  const int ncols = min(kBlock, n - col0);
  const float4 c = i < ncols ? boxes[(size_t)b * n + col0 + i] : zero;
  cbox[half][i] = c;
  carea[half][i] = box_area(c, shift);
  const int row = rb * kBlock + i;
  const size_t rr = (size_t)b * n + row;
  const bool in = row < n;
  const bool valid = in && scores[rr] > 0.0f;
  const float4 a = in ? boxes[rr] : zero;
  const float aa = box_area(a, shift);
  __syncthreads();
  // 32 rows of padding (or past n): no word of theirs is ever read
  if (!__any_sync(kFull, valid)) return;
  // Each 32 tests without a branch, from an approximate quotient q (within
  // 2 ulp: rcp_approx and a product).  Where q lies more than `band` (2^-16
  // relative) from thr it decides as the IEEE quotient would; the rest,
  // near the threshold, and any union rcp_approx would flush, are marked
  // unsure and divided exactly after.
  const float band = fabsf(thr) * 0x1p-16f + 1e-30f;
  const float above = thr + band, below = thr - band;
  const float4* cbh = cbox[half];
  const float* cah = carea[half];
  u64 word = 0ULL;
#pragma unroll
  for (int lo = 0; lo < kBlock; lo += 32) {
    uint32_t bits = 0u, unsure = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      float inter, uni;
      inter_union(a, aa, cbh[lo + k], cah[lo + k], shift, inter, uni);
      const float q = inter * rcp_approx(uni);
      bits |= (uint32_t)(q > above) << k;
      unsure |= (uint32_t)(!(q > above || q < below) || !(uni < 0x1p126f))
                << k;
    }
    // later columns of this tile only, none for a padding row
    const uint32_t cols =
        valid ? bit_range((cb == rb ? i + 1 : 0) - lo, ncols - lo) : 0u;
    bits &= cols;
    unsure &= cols;
    while (unsure) {
      const int k = __ffs(unsure) - 1;
      unsure &= unsure - 1u;
      const uint32_t bit = 1u << k;
      bits = overlaps(a, aa, cbh[lo + k], cah[lo + k], thr, shift)
                 ? bits | bit : bits & ~bit;
    }
    word |= (u64)bits << lo;
  }
  if (in) mask[rr * nwords + cb] = word;
}

// K2's rows: valid when the score is > 0 (zero-filled past n), kept rows
// written out as 0/1 bytes
struct ScoreRows {
  const float* s;
  unsigned char* k;
  float (*sscore)[kBlock];
  int n;

  __device__ __forceinline__ void prefetch(int buf, int i, int row, bool in) {
    nms::cp_async<4>(&sscore[buf][i], in ? s + row : s, in);
  }
  __device__ __forceinline__ u64 valid(int buf, int, int lane) const {
    return (u64)__ballot_sync(kFull, sscore[buf][lane] > 0.0f) |
           ((u64)__ballot_sync(kFull, sscore[buf][lane + 32] > 0.0f) << 32);
  }
  __device__ __forceinline__ void kept(int rb, int lane, u64 kept) const {
    const int row = rb * kBlock + lane;
    if (row < n) k[row] = (unsigned char)((kept >> lane) & 1ULL);
    if (row + 32 < n)
      k[row + 32] = (unsigned char)((kept >> (lane + 32)) & 1ULL);
  }
};

__global__ void __launch_bounds__(kSweepThreads)
nms_sweep(const float* __restrict__ scores, const u64* __restrict__ mask,
          unsigned char* __restrict__ keep, int n, int nwords) {
  extern __shared__ u64 removed[];             // nwords
  __shared__ float sscore[2][kBlock];
  const int b = blockIdx.x;
  ScoreRows rows{scores + (size_t)b * n, keep + (size_t)b * n, sscore, n};
  nms::greedy_sweep(mask + (size_t)b * n * nwords, n, nwords, removed, rows);
}

}  // namespace

// boxes [B, N, 4] f32, scores [B, N] f32, mask scratch [B, N, nwords] u64,
// keep [B, N] u8 (0/1); all contiguous on the current device.  Launches on
// `stream` and returns cudaGetLastError() as an int (cudaErrorInvalidValue
// for a size the grids cannot hold).
extern "C" int greedy_nms(const void* boxes, const void* scores, void* mask,
                          void* keep, int batch, int n, float thr,
                          float shift, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int nwords = (n + kBlock - 1) / kBlock;
  // two tiles of the upper triangle a block
  const long long blocks = ((long long)nwords * (nwords + 1) / 2 + 1) / 2;
  if (blocks > 0x7fffffffLL || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask<<<dim3((unsigned)blocks, batch), kMaskThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<u64*>(mask), n, nwords, thr, shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = nwords * sizeof(u64);
  err = cudaFuncSetAttribute(nms_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_sweep<<<batch, kSweepThreads, smem, s>>>(
      static_cast<const float*>(scores), static_cast<const u64*>(mask),
      static_cast<unsigned char*>(keep), n, nwords);
  return (int)cudaGetLastError();
}
