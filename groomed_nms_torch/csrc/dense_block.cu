// One eval-mode DenseNet block (K4) for Hopper (sm_90a), bf16 in, f32 sums.
//
// Replaces the TPU kernel groomed_nms_tpu/ops/pallas_dense_block.py::
// dense_block_eval (body _make_block_kernel).  Each of L layers computes
//     h   = relu(relu(x[:, :cin] * mul1 + add1) @ w1 * mul2 + add2)   1x1
//     out = conv3x3_dilated(h, w2)     (zero padding of h)             3x3
// and appends out's G channels to the block's stack, cin = c0 + l * G.
// BatchNorm arrives folded into per-channel (mul, add) vectors.
//
// What bounds it on this card: the block's stack does not fit on chip.
// Block 1 of the flagship holds 128 x 440 x 256 bf16 per image (28.8 MB, the
// TPU kernel kept it in VMEM), against 227 KB of shared memory per block.  So
// the stack stays in device memory ([B, H, W, cmax], the channels_last
// layout of [B, cmax, H, W]) and each layer runs as two implicit GEMMs over
// pixels:
//   kernel (a) conv1x1_bn_relu: M = pixels, N = bw, K = cin.  The operand
//     load applies BN1 + ReLU in f32 and rounds to bf16 (no normalised copy
//     of the stack is ever written); the epilogue applies BN2 + ReLU and
//     writes the bf16 bottleneck h [pixels, bw] to a scratch buffer;
//   kernel (b) conv3x3: M = pixels, N = G, K = 9 * bw, one k step per
//     (tap, 32 channels); a tap outside the image loads 0 in h space (zero
//     padding of relu(BN2(.)), as the TPU kernel's zeroed hpad ring).  The
//     epilogue writes the G new channels into stack channels [cin, cin + G):
//     no concatenation.
// The O(L^2) traffic is the stack read of kernel (a), one bf16 read of the
// channels a layer consumes; the O(L) traffic is h (written once, read by
// the nine taps, mostly from L2).  Tensor cores through nvcuda::wmma
// (bf16 x bf16 -> f32, 16x16x16), one k step at a time through shared
// memory: a simple design first, no TMA / wgmma pipeline yet.
//
// Rounding points (the plain version, ops/kernels.py::
// dense_block_eval_plain, has the same ones): BN1 affine and ReLU in f32 from
// the bf16 stack and bf16 (mul, add), rounded to bf16; products summed in
// f32; BN2 affine and ReLU in f32 on the f32 sum, rounded to bf16; the 3x3
// sums in f32, rounded to bf16.  Built with -fmad=false, so x * mul + add
// rounds twice, as the plain version's separate PyTorch ops do.
//
// Sizes: bf16 only; c0 and G multiples of 8, G <= 64, bw a multiple of 32 up
// to 128 (the wrapper checks; DenseNet-121 has G = 32, bw = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;      // 8 warps
constexpr int kBM = 128;           // pixels per block
constexpr int kBK = 32;            // channels per k step
constexpr int kLds = kBK + 8;      // shared row stride in bf16 (80 bytes)
constexpr int kVecs = kBK / 8;     // 16-byte vectors per row of a k step

// 8 bf16 at a 16-byte aligned address -> 8 floats
__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}

// 8 floats -> 8 bf16 (round to nearest even) in one 16-byte word
__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
  return u;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Kernel (a).  BN = bw.  Warp w owns rows (w % 4) * 32 .. +32 and columns
// (w / 4) * BN / 2 .. +BN / 2 of the block's [128, BN] tile.
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_relu(const bf16* __restrict__ stack, long long npix, int cmax,
                int cin, const bf16* __restrict__ mul1,
                const bf16* __restrict__ add1, const bf16* __restrict__ w1,
                const bf16* __restrict__ mul2, const bf16* __restrict__ add2,
                bf16* __restrict__ h) {
  constexpr int kWN = BN / 2;
  constexpr int kNF = kWN / 16;
  __shared__ __align__(128) bf16 As[kBM * kLds];
  __shared__ __align__(128) bf16 Bs[BN * kLds];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long m0 = (long long)blockIdx.x * kBM;

  FragC acc[2][kNF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    // A: [128 pixels, 32 channels] of the stack, BN1 + ReLU on the load;
    // channels >= cin (and pixels past the end) load as 0
    for (int v = tid; v < kBM * kVecs; v += kThreads) {
      const int r = v / kVecs, c = (v % kVecs) * 8;
      const long long p = m0 + r;
      const int k = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p < npix && k < cin) {
        float x[8], m[8], a[8];
        load8(stack + p * cmax + k, x);
        load8(mul1 + k, m);
        load8(add1 + k, a);
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = fmaxf(x[q] * m[q] + a[q], 0.0f);
        val = pack8(x);
      }
      *reinterpret_cast<uint4*>(&As[r * kLds + c]) = val;
    }
    // B: w1 rows are output channels, K contiguous: [BN, 32]
    for (int v = tid; v < BN * kVecs; v += kThreads) {
      const int n = v / kVecs, c = (v % kVecs) * 8;
      const int k = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < cin) val = *reinterpret_cast<const uint4*>(w1 + (long long)n * cmax + k);
      *reinterpret_cast<uint4*>(&Bs[n * kLds + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 32 + i * 16) * kLds + kk], kLds);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, &Bs[(wn * kWN + j * 16) * kLds + kk], kLds);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue through a per-warp 16x16 f32 tile: BN2 + ReLU, round, store h;
  // lane -> (row lane / 2, 8 columns at (lane % 2) * 8)
  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long p = m0 + wm * 32 + i * 16 + r;
      const int n = wn * kWN + j * 16 + c;
      if (p < npix) {
        float y[8], m[8], a[8];
        load8(mul2 + n, m);
        load8(add2 + n, a);
#pragma unroll
        for (int q = 0; q < 8; ++q) y[q] = fmaxf(cs[r * 16 + c + q] * m[q] + a[q], 0.0f);
        *reinterpret_cast<uint4*>(h + p * BN + n) = pack8(y);
      }
      __syncwarp();
    }
  }
}

// Kernel (b).  GP = G rounded up to 16.  Warp w owns rows w * 16 .. +16 and
// all GP columns; k runs over (tap, 32-channel chunk of bw).
template <int GP>
__global__ void __launch_bounds__(kThreads)
conv3x3(const bf16* __restrict__ h, int bw, int height, int width,
        long long npix, int dil, const bf16* __restrict__ w2, int growth,
        bf16* __restrict__ stack, int cmax, int cin) {
  constexpr int kNF = GP / 16;
  constexpr int kSlots = kBM * kVecs / kThreads;   // A vectors per thread
  __shared__ __align__(128) bf16 As[kBM * kLds];
  __shared__ __align__(128) bf16 Bs[GP * kLds];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * kBM;

  // every k step, a thread loads the same (pixel, 8 channels) slots at
  // another tap: decompose its pixels once
  long long img[kSlots];
  int py[kSlots], px[kSlots];
  bool ok[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const long long p = m0 + (tid + s * kThreads) / kVecs;
    ok[s] = p < npix;
    long long q = ok[s] ? p : 0;
    px[s] = (int)(q % width);
    q /= width;
    py[s] = (int)(q % height);
    img[s] = q / height;
  }

  FragC acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int chunks = bw / kBK;
  const long long krow = 9LL * bw;                 // w2 row length
  for (int step = 0; step < 9 * chunks; ++step) {
    const int tap = step / chunks, k0 = (step % chunks) * kBK;
    const int dy = (tap / 3 - 1) * dil, dx = (tap % 3 - 1) * dil;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int v = tid + s * kThreads;
      const int r = v / kVecs, c = (v % kVecs) * 8;
      const int yy = py[s] + dy, xx = px[s] + dx;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ok[s] && yy >= 0 && yy < height && xx >= 0 && xx < width) {
        const long long q = (img[s] * height + yy) * width + xx;
        val = *reinterpret_cast<const uint4*>(h + q * bw + k0 + c);
      }
      *reinterpret_cast<uint4*>(&As[r * kLds + c]) = val;
    }
    for (int v = tid; v < GP * kVecs; v += kThreads) {
      const int n = v / kVecs, c = (v % kVecs) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < growth)
        val = *reinterpret_cast<const uint4*>(w2 + n * krow + tap * bw + k0 + c);
      *reinterpret_cast<uint4*>(&Bs[n * kLds + c]) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, &As[warp * 16 * kLds + kk], kLds);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, &Bs[j * 16 * kLds + kk], kLds);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
  const int r = lane / 2, c = (lane % 2) * 8;
  const long long p = m0 + warp * 16 + r;
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    wmma::store_matrix_sync(cs, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int n = j * 16 + c;
    if (p < npix && n < growth) {
      float y[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) y[q] = cs[r * 16 + c + q];
      *reinterpret_cast<uint4*>(stack + p * cmax + cin + n) = pack8(y);
    }
    __syncwarp();
  }
}

template <int BN>
cudaError_t launch_conv1(int grid, cudaStream_t s, const bf16* stack,
                         long long npix, int cmax, int cin, const bf16* mul1,
                         const bf16* add1, const bf16* w1, const bf16* mul2,
                         const bf16* add2, bf16* h) {
  conv1x1_bn_relu<BN><<<grid, kThreads, 0, s>>>(stack, npix, cmax, cin, mul1,
                                                add1, w1, mul2, add2, h);
  return cudaGetLastError();
}

template <int GP>
cudaError_t launch_conv2(int grid, cudaStream_t s, const bf16* h, int bw,
                         int height, int width, long long npix, int dil,
                         const bf16* w2, int growth, bf16* stack, int cmax,
                         int cin) {
  conv3x3<GP><<<grid, kThreads, 0, s>>>(h, bw, height, width, npix, dil, w2,
                                        growth, stack, cmax, cin);
  return cudaGetLastError();
}

}  // namespace

// stack [B, H, W, cmax] bf16 with the block input in channels [0, c0);
// h scratch [B * H * W, bw] bf16; per layer l (all contiguous, bf16):
// mul1/add1 [L, cmax], w1 [L, bw, cmax], mul2/add2 [L, bw],
// w2 [L, G, 9 * bw] with k = (ty * 3 + tx) * bw + channel.  Fills channels
// [c0, cmax) of the stack: 2 launches per layer on `stream`.  Returns 0, or
// the first CUDA error (cudaErrorInvalidValue for a size it does not take).
extern "C" int dense_block_eval(void* stack, void* h, const void* mul1,
                                const void* add1, const void* w1,
                                const void* mul2, const void* add2,
                                const void* w2, int batch, int height,
                                int width, int c0, int cmax, int layers,
                                int bw, int growth, int dilation,
                                void* stream) {
  const long long npix = (long long)batch * height * width;
  if (npix == 0 || layers == 0) return 0;
  if (c0 % 8 || growth % 8 || growth > 64 || bw % 32 || bw > 128 ||
      cmax != c0 + layers * growth || dilation < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (npix + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* st = static_cast<bf16*>(stack);
  bf16* hb = static_cast<bf16*>(h);
  for (int l = 0; l < layers; ++l) {
    const int cin = c0 + l * growth;
    const bf16* m1 = static_cast<const bf16*>(mul1) + (long long)l * cmax;
    const bf16* a1 = static_cast<const bf16*>(add1) + (long long)l * cmax;
    const bf16* k1 = static_cast<const bf16*>(w1) + (long long)l * bw * cmax;
    const bf16* m2 = static_cast<const bf16*>(mul2) + (long long)l * bw;
    const bf16* a2 = static_cast<const bf16*>(add2) + (long long)l * bw;
    const bf16* k2 = static_cast<const bf16*>(w2) + (long long)l * growth * 9 * bw;
    cudaError_t err;
    switch (bw) {
      case 32: err = launch_conv1<32>(grid, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 64: err = launch_conv1<64>(grid, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 96: err = launch_conv1<96>(grid, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      default: err = launch_conv1<128>(grid, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
    }
    if (err != cudaSuccess) return (int)err;
    switch ((growth + 15) / 16) {
      case 1: err = launch_conv2<16>(grid, s, hb, bw, height, width, npix, dilation, k2, growth, st, cmax, cin); break;
      case 2: err = launch_conv2<32>(grid, s, hb, bw, height, width, npix, dilation, k2, growth, st, cmax, cin); break;
      case 3: err = launch_conv2<48>(grid, s, hb, bw, height, width, npix, dilation, k2, growth, st, cmax, cin); break;
      default: err = launch_conv2<64>(grid, s, hb, bw, height, width, npix, dilation, k2, growth, st, cmax, cin); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
