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
// at B=8, N=3000) but the sequential dependence of greedy NMS, row after row.
// The design takes the O(N^2) IoU work off that chain:
//   kernel 1 (nms_mask): one 64-thread block per (image, 64-row block,
//     64-column block >= row block) writes one uint64 per row per column
//     block, bit c set when the row suppresses column cb*64+c, later columns
//     only (B x N x ceil(N/64) words, ~9 MB at B=8, N=3000; the words for
//     column blocks before the row block are never written nor read);
//   kernel 2 (nms_sweep): one block per image sweeps the rows with the
//     removed bitset in shared memory.  Per 64-row block one thread resolves
//     the rows in order from the diagonal words alone, then the block ORs the
//     kept rows' words into every later column block, loads that do not
//     depend on one another.  The serial chain is 64 register steps per row
//     block, not one device-memory round trip per row.
// There is no host copy between the two kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr int kSweepThreads = 128;

__device__ __forceinline__ float box_area(float4 b, float shift) {
  return (b.z - b.x + shift) * (b.w - b.y + shift);
}

// true when box `a` (area aa) and box `c` (area ac) overlap above thr;
// the operation order of _nms_kernel: (min - max) + shift, clamp at 0,
// (aa + ac) - inter, clamp at 1e-12, divide, compare
__device__ __forceinline__ bool overlaps(float4 a, float aa, float4 c,
                                         float ac, float thr, float shift) {
  float iw = fmaxf(fminf(a.z, c.z) - fmaxf(a.x, c.x) + shift, 0.0f);
  float ih = fmaxf(fminf(a.w, c.w) - fmaxf(a.y, c.y) + shift, 0.0f);
  float inter = iw * ih;
  float uni = fmaxf(aa + ac - inter, 1e-12f);
  return inter / uni > thr;
}

__global__ void nms_mask(const float4* __restrict__ boxes,
                         const float* __restrict__ scores,
                         unsigned long long* __restrict__ mask, int n,
                         int nwords, float thr, float shift) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  const int t = threadIdx.x;
  const int col0 = cb * kBlock;
  const int ncols = min(kBlock, n - col0);
  if (t < ncols) {
    float4 c = boxes[(size_t)b * n + col0 + t];
    cbox[t] = c;
    carea[t] = box_area(c, shift);
  }
  __syncthreads();
  const int row = rb * kBlock + t;
  if (row >= n) return;
  const size_t r = (size_t)b * n + row;
  unsigned long long bits = 0;
  if (scores[r] > 0.0f) {
    const float4 a = boxes[r];
    const float aa = box_area(a, shift);
    const int start = (cb == rb) ? t + 1 : 0;
    for (int c = start; c < ncols; ++c) {
      if (overlaps(a, aa, cbox[c], carea[c], thr, shift)) bits |= 1ULL << c;
    }
  }
  mask[r * nwords + cb] = bits;
}

__global__ void nms_sweep(const float* __restrict__ scores,
                          const unsigned long long* __restrict__ mask,
                          unsigned char* __restrict__ keep, int n,
                          int nwords) {
  extern __shared__ unsigned long long removed[];   // nwords
  __shared__ unsigned long long diag[kBlock];
  __shared__ bool valid[kBlock];
  __shared__ unsigned long long kept_bits;
  const int b = blockIdx.x, t = threadIdx.x;
  for (int w = t; w < nwords; w += blockDim.x) removed[w] = 0ULL;
  __syncthreads();
  for (int rb = 0; rb < nwords; ++rb) {
    const int row = rb * kBlock + t;
    const size_t r = (size_t)b * n + row;
    if (t < kBlock) {
      const bool v = row < n && scores[r] > 0.0f;
      valid[t] = v;
      diag[t] = v ? mask[r * nwords + rb] : 0ULL;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[rb], kept = 0ULL;
      for (int i = 0; i < kBlock; ++i) {
        if (valid[i] && !((rem >> i) & 1ULL)) {
          kept |= 1ULL << i;
          rem |= diag[i];
        }
      }
      kept_bits = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (t < kBlock && row < n) keep[r] = (unsigned char)((kept >> t) & 1ULL);
    const size_t row0 = (size_t)b * n + (size_t)rb * kBlock;
    for (int w = rb + 1 + t; w < nwords; w += blockDim.x) {
      unsigned long long acc = removed[w];
      for (unsigned long long k = kept; k; k &= k - 1) {
        acc |= mask[(row0 + __ffsll((long long)k) - 1) * nwords + w];
      }
      removed[w] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes [B, N, 4] f32, scores [B, N] f32, mask scratch [B, N, nwords] u64,
// keep [B, N] u8 (0/1); all contiguous on the current device.  Launches on
// `stream` and returns cudaGetLastError() as an int.
extern "C" int greedy_nms(const void* boxes, const void* scores, void* mask,
                          void* keep, int batch, int n, float thr,
                          float shift, void* stream) {
  if (batch == 0 || n == 0) return 0;
  const int nwords = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask<<<dim3(nwords, nwords, batch), kBlock, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<unsigned long long*>(mask), n, nwords, thr, shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep<<<batch, kSweepThreads, nwords * sizeof(unsigned long long), s>>>(
      static_cast<const float*>(scores),
      static_cast<const unsigned long long*>(mask),
      static_cast<unsigned char*>(keep), n, nwords);
  return (int)cudaGetLastError();
}
