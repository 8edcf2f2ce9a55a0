// One eval-mode DenseNet block (K4) for Hopper (sm_90a), in bf16.  The f32
// form (3xTF32, its own tiling and wgmma) is csrc/dense_block_f32.cu.
//
// Replaces the TPU kernel groomed_nms_tpu/ops/pallas_dense_block.py::
// dense_block_eval (body _make_block_kernel), which is generic in its
// dtype.  Each of L layers computes
//     h   = relu(relu(x[:, :cin] * mul1 + add1) @ w1 * mul2 + add2)   1x1
//     out = conv3x3_dilated(h, w2)     (zero padding of h)             3x3
// and appends out's G channels to the block's stack, cin = c0 + l * G.
// BatchNorm arrives folded into per-channel (mul, add) vectors.
//
// What bounds it on this card: operations.  The flagship's block 1
// ([8, 64, 128, 440] -> 256 channels, L = 6) is 298.97 GFLOP against 288.4
// MB of input read once and stack written once: 0.30 ms at 989 TFLOP/s
// against 0.09 ms at 3.35 TB/s; block 2 ([8, 128, 64, 220] -> 512, L = 12)
// is 204.85 GFLOP, 0.21 ms.  The stack (28.8 MB per image for block 1)
// does not fit in shared memory, so it stays in device memory ([B, H, W,
// cmax], the channels_last layout of [B, cmax, H, W]) and each layer runs
// as two implicit GEMMs on the tensor
// cores (ldmatrix + mma.sync), both fed by cp.async rings in dynamic shared
// memory:
//   kernel (a) conv1x1_bn_relu: M = 128 pixels, N = bw, K = cin in 64-byte
//     steps (32 channels) through a 4-stage ring of [128 x step] stack
//     and [bw x step] w1 tiles.  The layer's mul1/add1
//     are staged once per block; each thread applies BN1 + ReLU to the
//     16-byte chunks it copied, between the stage's wait and the barrier, so
//     no normalised copy of the stack is ever written.  The epilogue
//     applies BN2 + ReLU and writes the bottleneck h [pixels, bw] through
//     shared memory in 16-byte stores.
//   kernel (b) conv3x3: one block per 16 x 16 output tile of one image (one
//     dilation phase of it, below), M = 256 pixels, N = G, K = 9 * bw.  The
//     tile's h halo, 18 x 18 pixels, is staged in shared memory 64 bytes of
//     channels at a time beside the matching [9 taps x G x step] slice of
//     w2, in a double-buffered ring; all nine taps read their A operand from
//     that halo through ldmatrix, each lane giving its own (shifted) pixel's
//     address, so h is read from device memory once per tile (1.27x with
//     the halo), not once per tap.  A halo pixel outside the image is
//     zero-filled by the copy itself (cp.async with src-size 0): the zero
//     padding of relu(BN2(.)), as the TPU kernel's zeroed hpad ring.  A
//     dilation d > 1 splits the image into its d x d phases (y mod d,
//     x mod d); within one phase the dilated 3x3 is an ordinary 3x3 on the
//     phase's subgrid, so the halo is 18 x 18 pixels whatever d is.  The
//     epilogue writes the G new channels into stack channels [cin, cin + G)
//     through shared memory: no concatenation.
// Every tile has a k step of 64 bytes in shared-memory rows padded by 16
// bytes (a row stride of 80 bytes), so the eight row addresses of each
// ldmatrix phase fall in eight different bank groups, and one mma's depth of
// 32 bytes (k16).
//
// What it still leaves, on block 1: the h round trip through device memory
// (0.69 GB written by (a) and read back by (b) in bf16, ~0.4 ms at 3.35
// TB/s) and (a)'s O(L^2) stack re-reads (0.78 GB, ~0.23 ms), against 0.29 GB
// that the block must move; every block re-reading its layer's weights from
// L2; and mma.sync's rate, below wgmma's.  wgmma + TMA and one fused kernel
// per layer that keeps h on chip are the next steps.
//
// Rounding points, the TPU kernel's (the plain version, ops/kernels.py::
// dense_block_eval_plain, has the same ones): each folded norm is x * mul +
// add in bf16 as JAX applies it, the product rounded and then the sum, then
// ReLU (bn_relu); the 1x1's products summed in f32 and the sum rounded to
// bf16 before BN2; the 3x3 sums in f32, rounded to bf16.
//
// Sizes: c0 and G multiples of 8, G <= 64, bw a multiple of 32 up to 128
// (the wrapper checks; DenseNet-121 has G = 32, bw = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // 8 warps

// kernel (a): 128 pixels x one 64-byte k step, 4 stages
constexpr int kBM = 128;
constexpr int kStages = 4;

// kernel (b): 16 x 16 output pixels, a halo of 18 x 18, one 64-byte step
// of channels a stage
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;

// The tiles in elements of T.
template <typename T>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // a 16-byte chunk
  static constexpr int kStep = 4 * kVec;            // a k step: 64 bytes
  static constexpr int kLd = kStep + kVec;          // row stride: 80 bytes
  static constexpr int kMmaK = 2 * kVec;            // an mma's depth: 32 B
  static constexpr int kMinBlocks3x3 = 2;           // kernel (b)'s blocks an SM
};

// relu(x * m + a) for two channels, rounded as JAX's bf16 ops round: the
// product of two bf16 values is exact in f32 (8 + 8 significant bits, and
// -fmad=false keeps it a product of its own), so rounding it gives the bf16
// product; the f32 sum of two bf16 values is then rounded to bf16, as the
// plain version's bf16 add does.  ReLU commutes with the rounding.
__device__ __forceinline__ __nv_bfloat162 bn_relu(float2 x, __nv_bfloat162 m,
                                                  __nv_bfloat162 a) {
  const float2 mf = __bfloat1622float2(m), af = __bfloat1622float2(a);
  const float2 p =
      __bfloat1622float2(__floats2bfloat162_rn(x.x * mf.x, x.y * mf.y));
  return __floats2bfloat162_rn(fmaxf(p.x + af.x, 0.0f),
                               fmaxf(p.y + af.y, 0.0f));
}

// BN1 + ReLU in place on one 16-byte chunk of a stack row
__device__ __forceinline__ void bn_relu16(bf16* x, const bf16* m,
                                          const bf16* a) {
  uint4 u = *reinterpret_cast<uint4*>(x);
  const uint4 mu = *reinterpret_cast<const uint4*>(m);
  const uint4 au = *reinterpret_cast<const uint4*>(a);
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&u);
  const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&mu);
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&au);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    x2[q] = bn_relu(__bfloat1622float2(x2[q]), m2[q], a2[q]);
  *reinterpret_cast<uint4*>(x) = u;
}

// kernel (a)'s epilogue for two channels n, n + 1: the 1x1's f32 sums
// (rounded to bf16 in bf16), then BN2 + ReLU
__device__ __forceinline__ void store_bn_relu2(bf16* dst, float c0, float c1,
                                               const bf16* m, const bf16* a) {
  const float2 c = __bfloat1622float2(__floats2bfloat162_rn(c0, c1));
  *reinterpret_cast<__nv_bfloat162*>(dst) =
      bn_relu(c, *reinterpret_cast<const __nv_bfloat162*>(m),
              *reinterpret_cast<const __nv_bfloat162*>(a));
}

// kernel (b)'s epilogue for two channels: the f32 sums in the block's dtype
__device__ __forceinline__ void store2(bf16* dst, float c0, float c1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(c0, c1);
}

__device__ __forceinline__ void set_zero(bf16& x) {
  x = __float2bfloat16(0.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; when !valid nothing is read and
// the 16 bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the "memory" clobber keeps the compiler from moving this thread's reads
// of a landed stage above the wait
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] (row) * b[16 x 8] (col), bf16 in, f32 sums
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragment addresses for ldmatrix from [rows][k] tiles (k contiguous, 80
// bytes a row).  A, x4: lane -> row lane % 16, k half lane / 16.  B, x4
// (two n8 tiles): lane -> n (lane % 8) + 8 * (lane / 16), k half (lane / 8)
// % 2; registers {0, 1} are the first tile's, {2, 3} the second's.  A k
// half is 16 bytes: 8 bf16 or 4 f32.
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
template <typename T>
__device__ __forceinline__ int b_koff(int lane) {
  return ((lane >> 3) & 1) * Tile<T>::kVec;
}

// Kernel (a).  BN = bw.  Warp w owns rows (w % 4) * 32 .. +32 and columns
// (w / 4) * BN / 2 .. +BN / 2 of the block's [128, BN] tile.  Dynamic shared
// memory: kStages x ([128][kLd] stack + [BN][kLd] w1), then mul1 and add1
// for the first ktiles * kStep channels; the epilogue reuses the ring.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv1x1_bn_relu(const T* __restrict__ stack, long long npix, int cmax,
                int cin, const T* __restrict__ mul1,
                const T* __restrict__ add1, const T* __restrict__ w1,
                const T* __restrict__ mul2, const T* __restrict__ add2,
                T* __restrict__ h) {
  using Tl = Tile<T>;
  constexpr int kV = Tl::kVec, kBK = Tl::kStep, kLdA = Tl::kLd;
  constexpr int kVecs = kBK / kV;             // 16-byte vectors a row
  constexpr int kWN = BN / 2;                 // columns per warp
  constexpr int kNT = kWN / 8;                // n8 tiles per warp (even)
  constexpr int kStageElems = (kBM + BN) * kLdA;
  constexpr int kAChunks = kBM * kVecs / kThreads;     // per thread
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int ktiles = (cin + kBK - 1) / kBK;
  T* m1s = ring + kStages * kStageElems;
  T* a1s = m1s + ktiles * kBK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const long long m0 = (long long)blockIdx.x * kBM;

  for (int k = tid; k < ktiles * kBK; k += kThreads) {
    if (k < cin) {
      m1s[k] = mul1[k];
      a1s[k] = add1[k];
    } else {
      set_zero(m1s[k]);
      set_zero(a1s[k]);
    }
  }

  auto load_tile = [&](int kt, int stage) {
    T* As = ring + stage * kStageElems;
    T* Bs = As + kBM * kLdA;
    const int k0 = kt * kBK;
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int v = tid + s * kThreads;
      const int r = v / kVecs, c = (v % kVecs) * kV;
      const long long p = m0 + r;
      const bool ok = p < npix && k0 + c < cin;
      cp_async16(As + r * kLdA + c, ok ? stack + p * cmax + k0 + c : stack, ok);
    }
    for (int v = tid; v < BN * kVecs; v += kThreads) {
      const int n = v / kVecs, c = (v % kVecs) * kV;
      const bool ok = k0 + c < cin;
      cp_async16(Bs + n * kLdA + c, ok ? w1 + (long long)n * cmax + k0 + c : w1,
                 ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  __syncthreads();                             // m1s / a1s

  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();              // this thread's copies of kt
    const int stage = kt % kStages;
    T* As = ring + stage * kStageElems;
    const T* Bs = As + kBM * kLdA;
    // BN1 + ReLU on the chunks this thread copied (channels < cin only:
    // the zero-filled rest must stay 0)
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int v = tid + s * kThreads;
      const int r = v / kVecs, c = (v % kVecs) * kV;
      const int k = kt * kBK + c;
      if (m0 + r < npix && k < cin) bn_relu16(As + r * kLdA + c, m1s + k, a1s + k);
    }
    // every thread's tile kt has landed and been transformed, and every warp
    // is done with stage (kt - 1) % kStages, which the next load refills
    __syncthreads();
    if (kt + kStages - 1 < ktiles)
      load_tile(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += Tl::kMmaK) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], As + (wm * 32 + i * 16 + (lane & 15)) * kLdA + kk +
                              (lane >> 4) * kV);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, Bs + (wn * kWN + jp * 16 + b_row(lane)) * kLdA + kk +
                           b_koff<T>(lane));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * jp], a[i], b);
          mma16816(acc[i][2 * jp + 1], a[i], b + 2);
        }
      }
    }
  }

  // epilogue: BN2 + ReLU on the f32 sums (store_bn_relu2), staged as
  // [128][BN + kV] in the ring, then 16-byte stores of h.  Accumulator
  // layout: c[0..1] at row lane / 4, columns 2 * (lane % 4) + {0, 1};
  // c[2..3] 8 rows below.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLdC = BN + kV;
  T* Cs = ring;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = wn * kWN + j * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + i * 16 + g + half * 8;
        store_bn_relu2(Cs + r * kLdC + n, acc[i][j][2 * half],
                       acc[i][j][2 * half + 1], mul2 + n, add2 + n);
      }
    }
  }
  __syncthreads();
  for (int v = tid; v < kBM * BN / kV; v += kThreads) {
    const int r = v / (BN / kV), c = (v % (BN / kV)) * kV;
    const long long p = m0 + r;
    if (p < npix)
      *reinterpret_cast<uint4*>(h + p * BN + c) =
          *reinterpret_cast<const uint4*>(Cs + r * kLdC + c);
  }
}

// Kernel (b).  NT = G / 8 n8 tiles.  Block (bx, by, z): image z / d^2, phase
// (py, px) = ((z % d^2) / d, z % d); output pixel (i, j) of the tile is image
// pixel (py + d * (16 by + i), px + d * (16 bx + j)) and halo pixel (i, j)
// is image pixel (py + d * (16 by - 1 + i), px + d * (16 bx - 1 + j)).  Warp
// w owns output rows 2w and 2w + 1 (one m16 tile each) and all G columns.
// Dynamic shared memory: 2 stages x ([324][kLd] halo + [9 * G][kLd] w2);
// the epilogue reuses the ring.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, Tile<T>::kMinBlocks3x3)
conv3x3(const T* __restrict__ h, int bw, int height, int width, int dil,
        const T* __restrict__ w2, T* __restrict__ stack, int cmax, int cin) {
  using Tl = Tile<T>;
  constexpr int G = NT * 8;
  constexpr int kV = Tl::kVec, kKC = Tl::kStep, kLdB = Tl::kLd;
  constexpr int kVecs = kKC / kV;             // 16-byte vectors a row
  constexpr int kHaloElems = kHaloPix * kLdB;
  constexpr int kStageElems = kHaloElems + 9 * G * kLdB;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int phases = dil * dil;
  const int img = blockIdx.z / phases, phase = blockIdx.z % phases;
  const int py = phase / dil, px = phase % dil;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  // a tile of the subgrid of a phase whose rows or columns end early
  if (py + dil * ty0 >= height || px + dil * tx0 >= width) return;
  const T* himg = h + (long long)img * height * width * bw;

  auto load_chunk = [&](int ch, int stage) {
    T* hs = ring + stage * kStageElems;
    T* ws = hs + kHaloElems;
    const int k0 = ch * kKC;
    for (int v = tid; v < kHaloPix * kVecs; v += kThreads) {
      const int hp = v / kVecs, c = (v % kVecs) * kV;
      const int hy = hp / kHalo, hx = hp - hy * kHalo;
      const int iy = py + dil * (ty0 - 1 + hy), ix = px + dil * (tx0 - 1 + hx);
      const bool ok = iy >= 0 && iy < height && ix >= 0 && ix < width;
      cp_async16(hs + hp * kLdB + c,
                 ok ? himg + ((long long)iy * width + ix) * bw + k0 + c : h, ok);
    }
    // w2 [G][9 * bw], k = tap * bw + channel -> ws [tap][G][kLd]
    for (int v = tid; v < 9 * G * kVecs; v += kThreads) {
      const int row = v / kVecs, c = (v % kVecs) * kV;
      const int tap = row / G, n = row - tap * G;
      cp_async16(ws + row * kLdB + c,
                 w2 + (long long)n * 9 * bw + tap * bw + k0 + c, true);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int chunks = bw / kKC;
  load_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<0>();
    // chunk ch visible to all; every warp is done with the other stage
    __syncthreads();
    if (ch + 1 < chunks) load_chunk(ch + 1, (ch + 1) & 1);
    cp_async_commit();
    const T* hs = ring + (ch & 1) * kStageElems;
    const T* ws = hs + kHaloElems;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ty = tap / 3, tx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += Tl::kMmaK) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int hp = (warp * 2 + i + ty) * kHalo + (lane & 15) + tx;
          ldmatrix_x4(a[i], hs + hp * kLdB + kk + (lane >> 4) * kV);
        }
        const T* wt = ws + tap * G * kLdB + kk + b_koff<T>(lane);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, wt + (jp * 16 + b_row(lane)) * kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma16816(acc[i][2 * jp], a[i], b);
            mma16816(acc[i][2 * jp + 1], a[i], b + 2);
          }
        }
        if (NT % 2) {
          uint32_t b[2];
          ldmatrix_x2(b, wt + ((NT - 1) * 8 + (lane & 7)) * kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma16816(acc[i][NT - 1], a[i], b);
        }
      }
    }
  }

  // epilogue: the sums in T (store2), staged [256][G + kV] in the ring, then
  // 16-byte stores into stack channels [cin, cin + G) of the pixels in the
  // image
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLdC = G + kV;
  constexpr int kCV = G / kV;                 // 16-byte vectors a pixel
  T* Cs = ring;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (warp * 2 + i) * kTile + g + half * 8;
        store2(Cs + r * kLdC + j * 8 + 2 * t, acc[i][j][2 * half],
               acc[i][j][2 * half + 1]);
      }
  __syncthreads();
  T* simg = stack + (long long)img * height * width * cmax;
  for (int v = tid; v < kTile * kTile * kCV; v += kThreads) {
    const int r = v / kCV, c = (v % kCV) * kV;
    const int y = py + dil * (ty0 + r / kTile);
    const int x = px + dil * (tx0 + r % kTile);
    if (y < height && x < width)
      *reinterpret_cast<uint4*>(simg + ((long long)y * width + x) * cmax + cin +
                                c) =
          *reinterpret_cast<const uint4*>(Cs + r * kLdC + c);
  }
}

template <typename T>
constexpr size_t conv1_smem(int bn, int ktiles) {
  return sizeof(T) * ((size_t)kStages * (kBM + bn) * Tile<T>::kLd +
                      2 * (size_t)ktiles * Tile<T>::kStep);
}

template <typename T>
constexpr size_t conv2_smem(int growth) {
  return sizeof(T) * 2 * (size_t)(kHaloPix + 9 * growth) * Tile<T>::kLd;
}

template <typename T, int BN>
cudaError_t launch_conv1(int grid, cudaStream_t s, const T* stack,
                         long long npix, int cmax, int cin, const T* mul1,
                         const T* add1, const T* w1, const T* mul2,
                         const T* add2, T* h) {
  const size_t bytes =
      conv1_smem<T>(BN, (cin + Tile<T>::kStep - 1) / Tile<T>::kStep);
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_bn_relu<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  conv1x1_bn_relu<T, BN><<<grid, kThreads, bytes, s>>>(
      stack, npix, cmax, cin, mul1, add1, w1, mul2, add2, h);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_conv2(dim3 grid, cudaStream_t s, const T* h, int bw,
                         int height, int width, int dil, const T* w2,
                         T* stack, int cmax, int cin) {
  const size_t bytes = conv2_smem<T>(NT * 8);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  conv3x3<T, NT><<<grid, kThreads, bytes, s>>>(h, bw, height, width, dil, w2,
                                               stack, cmax, cin);
  return cudaGetLastError();
}

template <typename T>
int run_block(void* stack, void* h, const void* mul1, const void* add1,
              const void* w1, const void* mul2, const void* add2,
              const void* w2, int batch, int height, int width, int c0,
              int cmax, int layers, int bw, int growth, int dilation,
              void* stream) {
  const long long npix = (long long)batch * height * width;
  if (npix == 0 || layers == 0) return 0;
  if (c0 % 8 || growth % 8 || growth > 64 || bw % 32 || bw > 128 ||
      cmax != c0 + layers * growth || dilation < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (npix + kBM - 1) / kBM;
  // the 3x3's grid: tiles of one phase's subgrid x (image, phase)
  const long long sub_h = (height + dilation - 1) / dilation;
  const long long sub_w = (width + dilation - 1) / dilation;
  const long long grid_z = (long long)batch * dilation * dilation;
  if (blocks > 0x7fffffffLL || grid_z > 65535 ||
      (sub_h + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const int grid1 = (int)blocks;
  const dim3 grid2((unsigned)((sub_w + kTile - 1) / kTile),
                   (unsigned)((sub_h + kTile - 1) / kTile), (unsigned)grid_z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* st = static_cast<T*>(stack);
  T* hb = static_cast<T*>(h);
  for (int l = 0; l < layers; ++l) {
    const int cin = c0 + l * growth;
    const T* m1 = static_cast<const T*>(mul1) + (long long)l * cmax;
    const T* a1 = static_cast<const T*>(add1) + (long long)l * cmax;
    const T* k1 = static_cast<const T*>(w1) + (long long)l * bw * cmax;
    const T* m2 = static_cast<const T*>(mul2) + (long long)l * bw;
    const T* a2 = static_cast<const T*>(add2) + (long long)l * bw;
    const T* k2 = static_cast<const T*>(w2) + (long long)l * growth * 9 * bw;
    cudaError_t err;
    switch (bw) {
      case 32: err = launch_conv1<T, 32>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 64: err = launch_conv1<T, 64>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 96: err = launch_conv1<T, 96>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      default: err = launch_conv1<T, 128>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
    }
    if (err != cudaSuccess) return (int)err;
    switch (growth / 8) {
      case 1: err = launch_conv2<T, 1>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 2: err = launch_conv2<T, 2>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 3: err = launch_conv2<T, 3>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 4: err = launch_conv2<T, 4>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 5: err = launch_conv2<T, 5>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 6: err = launch_conv2<T, 6>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 7: err = launch_conv2<T, 7>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      default: err = launch_conv2<T, 8>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// stack [B, H, W, cmax] with the block input in channels [0, c0); h scratch
// [B * H * W, bw]; per layer l (all contiguous bf16):
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
  return run_block<bf16>(stack, h, mul1, add1, w1, mul2, add2, w2, batch,
                         height, width, c0, cmax, layers, bw, growth,
                         dilation, stream);
}
