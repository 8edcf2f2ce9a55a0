// One eval-mode DenseNet block (K4) in f32 for Hopper (sm_90a), with its
// products at f32 accuracy from three TF32 products each (3xTF32).
//
// Replaces, with csrc/dense_block.cu (the bf16 form), the TPU kernel
// groomed_nms_tpu/ops/pallas_dense_block.py::dense_block_eval (body
// _make_block_kernel), which is generic in its dtype.  Each of L layers
// computes
//     h   = relu(relu(x[:, :cin] * mul1 + add1) @ w1 * mul2 + add2)   1x1
//     out = conv3x3_dilated(h, w2)     (zero padding of h)             3x3
// and appends out's G channels to the block's stack, cin = c0 + l * G.
// BatchNorm arrives folded into per-channel (mul, add) vectors.
//
// 3xTF32: a single TF32 product keeps 11 significant bits of each operand,
// errors of order 2^-11 (~5e-4), which f32 must not lose.  Each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), both rounded as
// cvt.rna.tf32.f32 rounds (the difference is exact), and a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, off by the dropped a_lo * b_lo
// (< 2^-22 |a b|) and lo's own rounding.  No product loop splits anything:
//   * tf32_split, one launch at the head of a call, splits w1 and w2 into
//     their hi and lo halves, in scratch the wrapper allocates: the weights
//     are split once a call (3.3 MB for the flagship's block 1, 9.8 MB for
//     block 2), not by every warp of every block;
//   * the activations are split once a stage, in shared memory, by the
//     threads that landed them: hi in place, lo into a second tile.
//
// What bounds it on this card: the products.  The flagship's block 1
// ([8, 64, 128, 440] -> 256 channels, L = 6) is 298.97 GFLOP, three TF32
// products each: 1.81 ms at 494.7 TFLOP/s, against 576.7 MB of input read
// once and stack written once (0.17 ms at 3.35 TB/s).  The stack does not fit
// in shared memory, so it stays in device memory ([B, H, W, cmax], the
// channels_last layout of [B, cmax, H, W]) and each layer is two kernels,
// both on wgmma.mma_async .f32.tf32.tf32 with A from registers (ldmatrix from
// shared memory, the activations' hi and lo) and B from shared memory
// through a descriptor (the weights' hi and lo, K-major as TF32 requires, in
// wgmma's canonical layout without swizzle: core matrices of 8 rows x 16
// bytes, as tf32_split wrote them, so a step's tile is one linear copy):
//   kernel (a) conv1x1_bn_relu_f32: M = 128 pixels (a warpgroup each 64),
//     N = bw (one m64nBWk8 wgmma a product), K = cin in 128-byte steps (32
//     channels) through a 3-stage cp.async ring of [128 x 32] stack and [bw
//     x 32] w1 tiles, hi and lo each, the stack's rows swizzled for
//     ldmatrix (one block an SM).  Each thread applies BN1 + ReLU to the
//     stack chunks it copied and splits them, those of step kt + 1 while
//     step kt's products run.  The epilogue applies BN2 + ReLU and writes the
//     bottleneck h [pixels, bw].  Its bytes (the stack re-read each layer, h
//     written) make it the lighter of the two by its floors.
//   kernel (b) conv3x3_f32: one block of two warpgroups per 16 x 16 output
//     tile of one image (one dilation phase of it, below), M = 256 pixels,
//     N = G (m64nGk8), K = 9 * bw in 32-byte steps (8 channels, one wgmma
//     depth).  The tile's h halo, 18 x 18 pixels, lands in shared memory
//     (three stages, copied two steps ahead) beside the step's [9 taps x G x
//     8] w2 slice, hi and lo (two stages), and is split there; two blocks an
//     SM up to G = 32.  A warp's 16 rows of an m64 tile are one output row,
//     read from the halo by ldmatrix with each lane giving its own shifted
//     pixel: an m64 tile is four output rows, 18 halo pixels apart at each
//     16, which no single descriptor stride describes.  The two tiles of a
//     warpgroup interleave their rows, so each warp's halo rows r .. r + 3,
//     read once for a column of taps, serve both tiles' three taps.  A halo
//     pixel outside the image is zero-filled by the copy itself (cp.async
//     with src-size 0): the zero padding of relu(BN2(.)).  A dilation d > 1
//     splits the image into its d x d phases (y mod d, x mod d); within one
//     phase the dilated 3x3 is an ordinary 3x3 on the phase's subgrid, so
//     the halo is 18 x 18 pixels whatever d is.  The epilogue writes the G
//     new channels into stack channels [cin, cin + G): no concatenation.
//
// Sums: the tensor cores add without the round-to-nearest of an f32 add, so
// the products of 16 to 24 channels (three a channel, small terms first) go
// into a fresh partial tile (scale-d = 0 on its first wgmma), which joins
// the running sums with an f32 add: the running sums of K up to ~1,150 then
// round as f32 sums do.  Two partials alternate (wgmma.wait_group 1), one
// adding while the other's products run: in (a) a step's two 64-byte
// halves (16 channels each, as the earlier design's step), in (b) a
// warpgroup's two tiles, each over a column of three taps.  Nothing stays
// in flight across a loop's back edge (each step ends with wait_group 0):
// ptxas serialises every wgmma of a kernel when a register move at the back
// edge touches an accumulator in flight.
//
// What it still leaves: the h round trip through device memory and (a)'s
// O(L^2) stack re-reads; a barrier, a drain and a split pass every step;
// every block re-reading its layer's weights (now hi and lo) from L2, and
// shared memory read about as fast as the tensor cores take it (each
// m64nGk8 reads its G x 32-byte B, and the three products read B hi
// twice).  One fused kernel per layer that keeps h on chip, with TMA and
// warp specialisation, is the next step.
//
// Rounding points, the TPU kernel's (the plain version, ops/kernels.py::
// dense_block_eval_plain, has the same ones): each folded norm is x * mul +
// add, the product rounded and then the sum, then ReLU (-fmad=false keeps
// the two apart); the 1x1's and the 3x3's products summed in f32.
//
// Sizes: c0 and G multiples of 8, G <= 64, bw a multiple of 32 up to 128
// (the wrapper checks; DenseNet-121 has G = 32, bw = 128).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps, two warpgroups

// kernel (a): 128 pixels x one 128-byte k step (32 f32), 3 stages
constexpr int kBM = 128;
constexpr int kStages1 = 3;
constexpr int kStep1 = 32;
constexpr int kRow1 = kStep1 * 4;  // bytes a tile row
// kernel (a)'s k8 parts a partial: a partial sums 8 kParts1 channels (one
// or four ran the flagship's blocks within 3% on an H100)
constexpr int kParts1 = 2;

// kernel (b): 16 x 16 output pixels, a halo of 18 x 18, one 32-byte k step
// (8 f32) a stage, two blocks an SM up to G = 32.  On an H100
// (scripts/k4_compare.py) a 64-byte step, one block an SM, ran this kernel
// 18-21% slower at the flagship's blocks 1-2, and a 16 x 32 tile of four
// warpgroups (half the w2 copies a pixel), one block an SM, 5-8% slower
// (in an earlier form of the tap loop)
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kStep2 = 8;
constexpr int kRow2 = kStep2 * 4;
constexpr int kHaloBytes = kHaloPix * kRow2;        // one halo tile, hi or lo
// the halo (from device memory) is copied two steps ahead, w2 (from L2) one
constexpr int kHaloStages = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of kRow-byte rows (C =
// kRow / 16 chunks, 2 to 8): the chunk XOR (r * C / 8) % C puts any 8
// consecutive rows' chunk c in 8 different bank groups (ldmatrix reads 8
// rows a phase)
template <int kRow>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = kRow / 16;
  return r * kRow + ((c ^ ((r * C / 8) % C)) << 4);
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

// tf32(x) rounded to nearest, ties away from zero, in an f32 with its low
// 13 bits zero
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z),
                   tf32_rna(x.w));
  lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                   tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
}

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// acc += part, element by element in f32 (round to nearest), as asm
// statements: they stay after the wgmma wait that retires `part` (the asm
// statements keep their order; plain adds might be moved above it), and
// they only read `part`, so ptxas keeps the other partial's wgmma in flight
template <int N>
__device__ __forceinline__ void add_partial(float (&acc)[N],
                                            const float (&part)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("add.rn.f32 %0, %0, %1;\n" : "+f"(acc[i]) : "f"(part[i]));
}

// A K-major operand in shared memory without swizzle: core matrices of 8
// rows x 16 bytes (rows 16 bytes apart), `lbo` bytes between the two core
// matrices of one k8 step (K), `sbo` bytes between groups of 8 rows (N)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[64 x 8 NT] (+)= a[64 x 8] (registers, one m16k8 tf32 fragment a warp)
// * b[8 x 8 NT] (shared memory, `desc`); scale_d = 0 starts a fresh sum.
// d's layout a warp is mma.sync's m16n8 accumulator for each n8 tile j in
// d[4j .. 4j + 3].  A warp's fragment comes from ldmatrix x4 with lane ->
// row lane % 16, k half (16 bytes, 4 f32) lane / 16: an m8n8 .b16 matrix of
// f32 rows gives each lane the f32 at (row lane / 4, column lane % 4), the
// tf32 fragment's layout.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT * 4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<1>(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<2>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<3>(float (&d)[12],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<5>(float (&d)[20],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<6>(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<7>(float (&d)[28],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<12>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the prep kernel -------------------------------------------------------

// Where tf32_split puts one tensor: logical [L][rows][len] f32 (row n of
// layer l) -> out [L][steps][hi, lo][nc][rows][4 f32]: each k step of a
// layer one contiguous block, hi then lo, each nc chunks of [rows][16 B] --
// wgmma's canonical K-major layout without swizzle, so that a kernel copies
// a step's tile in one run.  Chunk c of step kt holds columns (c / cps) *
// tap_stride + kt * step + (c % cps) * 4 .. +4, zero from `limit` on.
struct SplitLayout {
  const float* x;
  float* out;
  int layers, rows, len, steps, nc, cps, step, tap_stride, limit;
};

// w1 as kernel (a) reads it: 32 channels (8 chunks) a step
SplitLayout w1_layout(const float* x, float* out, int layers, int rows,
                      int len) {
  return {x, out, layers, rows, len, (len + kStep1 - 1) / kStep1, 8, 8,
          kStep1, 0, len};
}

// w2 [L][G][9 * bw] as kernel (b) reads it: kStep2 channels of each tap a
// step, chunk c = tap * kStep2 / 4 + its 16 bytes
SplitLayout w2_layout(const float* x, float* out, int layers, int growth,
                      int bw) {
  return {x,  out,    layers, growth, 9 * bw, bw / kStep2, 9 * kStep2 / 4,
          kStep2 / 4, kStep2, bw, bw};
}

long long split_floats(const SplitLayout& t) {
  return 2LL * t.layers * t.steps * t.nc * t.rows * 4;
}

// hi = tf32(x), lo = tf32(x - hi) of each element, into t.out in its
// layout; blockIdx.y picks the tensor
__global__ void __launch_bounds__(kThreads)
tf32_split(SplitLayout a, SplitLayout b) {
  const SplitLayout t = blockIdx.y ? b : a;
  const long long n4 = (long long)t.layers * t.steps * t.nc * t.rows;
  const long long part = (long long)t.nc * t.rows * 4;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    const int n = (int)(i % t.rows);
    const long long q = i / t.rows;
    const int c = (int)(q % t.nc);
    const long long block = q / t.nc;            // l * steps + kt
    const int kt = (int)(block % t.steps), l = (int)(block / t.steps);
    const int col = kt * t.step + (c % t.cps) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col < t.limit)
      v = *reinterpret_cast<const float4*>(
          t.x + ((long long)l * t.rows + n) * t.len +
          (c / t.cps) * t.tap_stride + col);
    float4 vh, vl;
    split4(v, vh, vl);
    float* dst = t.out + block * 2 * part + ((long long)c * t.rows + n) * 4;
    *reinterpret_cast<float4*>(dst) = vh;
    *reinterpret_cast<float4*>(dst + part) = vl;
  }
}

cudaError_t launch_split(SplitLayout a, SplitLayout b, cudaStream_t s) {
  const long long n4 = (long long)(a.layers * a.steps * a.nc) * a.rows;
  const long long m4 = (long long)(b.layers * b.steps * b.nc) * b.rows;
  const long long blocks = ((n4 > m4 ? n4 : m4) + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  tf32_split<<<dim3((unsigned)(blocks < 2048 ? blocks : 2048), 2), kThreads,
               0, s>>>(a, b);
  return cudaGetLastError();
}

// ---- kernel (a) ------------------------------------------------------------

// BN = bw.  Warpgroup q owns rows 64q .. 64q + 63 of the block's [128, BN]
// tile and all BN columns, one m64nBNk8 wgmma a product; warp i of it gives
// rows 64q + 16i .. +16, its m16 fragment, by ldmatrix.  Dynamic shared
// memory: kStages1 x (stack hi, stack lo [128 x 128 B], rows by swz; w1
// hi, w1 lo [8 chunks][BN][16 B] as tf32_split laid them out), then mul1
// and add1 for the first ktiles * 16 channels; the epilogue reuses the
// ring.  w1s: the layer's split w1, a step's hi and lo together.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_bn_relu_f32(const float* __restrict__ stack, long long npix,
                    int cmax, int cin, const float* __restrict__ mul1,
                    const float* __restrict__ add1,
                    const float* __restrict__ w1s,
                    const float* __restrict__ mul2,
                    const float* __restrict__ add2, float* __restrict__ h) {
  constexpr int NT = BN / 8;                  // n8 tiles: wgmma's N / 8
  constexpr int kATile = kBM * kRow1, kBTile = BN * kRow1;
  constexpr int kStageBytes = 2 * (kATile + kBTile);
  constexpr int kVecs = kStep1 / 4;           // 16-byte chunks a row
  constexpr int kAChunks = kBM * kVecs / kThreads;     // per thread
  extern __shared__ __align__(128) unsigned char smem[];
  const int ktiles = (cin + kStep1 - 1) / kStep1;
  float* m1s = reinterpret_cast<float*>(smem + kStages1 * kStageBytes);
  float* a1s = m1s + ktiles * kStep1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4;
  const long long m0 = (long long)blockIdx.x * kBM;

  for (int k = tid; k < ktiles * kStep1; k += kThreads) {
    m1s[k] = k < cin ? mul1[k] : 0.0f;
    a1s[k] = k < cin ? add1[k] : 0.0f;
  }

  // a stage: [stack hi][stack lo][w1 hi][w1 lo]
  auto load_tile = [&](int kt, int stage) {
    unsigned char* st = smem + stage * kStageBytes;
    const int k0 = kt * kStep1;
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int v = tid + s * kThreads;
      const int r = v / kVecs, c = v % kVecs;
      const long long p = m0 + r;
      const bool ok = p < npix && k0 + 4 * c < cin;
      cp_async16(st + swz<kRow1>(r, c), ok ? stack + p * cmax + k0 + 4 * c : stack,
                 ok);
    }
    const float* w = w1s + (long long)kt * 2 * BN * kStep1;
    for (int v = tid; v < 2 * kBTile / 16; v += kThreads)
      cp_async16(st + 2 * kATile + v * 16, w + v * 4, true);
  };

  // BN1 + ReLU and the split on the chunks of step kt that this thread
  // copied, hi in place and lo beside it.  Channels past cin stay 0 (mul1 =
  // add1 = 0 there); rows past npix are computed and never stored
  auto split_tile = [&](int kt) {
    unsigned char* Ahi = smem + (kt % kStages1) * kStageBytes;
#pragma unroll
    for (int s = 0; s < kAChunks; ++s) {
      const int v = tid + s * kThreads;
      const int off = swz<kRow1>(v / kVecs, v % kVecs);
      const int k = kt * kStep1 + 4 * (v % kVecs);
      float4 x = *reinterpret_cast<const float4*>(Ahi + off);
      const float4 m = *reinterpret_cast<const float4*>(m1s + k);
      const float4 a = *reinterpret_cast<const float4*>(a1s + k);
      x = make_float4(fmaxf(x.x * m.x + a.x, 0.0f), fmaxf(x.y * m.y + a.y, 0.0f),
                      fmaxf(x.z * m.z + a.z, 0.0f), fmaxf(x.w * m.w + a.w, 0.0f));
      float4 vh, vl;
      split4(x, vh, vl);
      *reinterpret_cast<float4*>(Ahi + off) = vh;
      *reinterpret_cast<float4*>(Ahi + kATile + off) = vl;
    }
  };

  // copy groups, one a step in commit order; step kt + 1 is split while
  // step kt's products run
#pragma unroll
  for (int s = 0; s < kStages1 - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  __syncthreads();                             // m1s / a1s
  cp_async_wait<kStages1 - 2>();               // this thread's copies of 0
  split_tile(0);

  // the running sums, and two partials that a step's groups of k8 parts
  // alternate in
  float acc[NT * 4], part[2][NT * 4];
#pragma unroll
  for (int q = 0; q < NT * 4; ++q) acc[q] = part[0][q] = part[1][q] = 0.0f;

  for (int kt = 0; kt < ktiles; ++kt) {
    unsigned char* Ahi = smem + (kt % kStages1) * kStageBytes;
    unsigned char* Alo = Ahi + kATile;
    // this thread's copies of w1 seen by wgmma (the async proxy); every
    // thread's tile kt landed and split, and every warpgroup done with
    // stage (kt - 1) % kStages1, which the next load refills
    fence_proxy_async();
    __syncthreads();
    if (kt + kStages1 - 1 < ktiles)
      load_tile(kt + kStages1 - 1, (kt + kStages1 - 1) % kStages1);
    cp_async_commit();

    // the step's k8 parts in groups of kParts1, each group's three products
    // a part into a fresh partial (part[g % 2]); while group g runs, group
    // g - 1's partial joins the sums and group g + 1's A fragments load,
    // and while the first runs, step kt + 1 is split
    const uint32_t bhi = smem_addr(Alo + kATile), blo = bhi + kBTile;
    uint32_t ahi[2][kParts1][4], alo[2][kParts1][4];
    auto load_a = [&](int g, int slot) {
#pragma unroll
      for (int j = 0; j < kParts1; ++j) {
        const int off = swz<kRow1>(64 * wg + 16 * wi + (lane & 15),
                                   2 * (g * kParts1 + j) + (lane >> 4));
        ldmatrix_x4(ahi[slot][j], Ahi + off);
        ldmatrix_x4(alo[slot][j], Alo + off);
      }
    };
    constexpr int kGroups = kStep1 / 8 / kParts1;
    load_a(0, 0);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kParts1; ++j) {
        const int s = g * kParts1 + j;       // the k8 part: chunks 2s, 2s + 1
        const uint64_t dh = kmajor_desc(bhi + 2 * s * BN * 16, BN * 16, 128);
        const uint64_t dl = kmajor_desc(blo + 2 * s * BN * 16, BN * 16, 128);
        wgmma_tf32<NT>(part[g % 2], alo[g % 2][j], dh, j > 0);
        wgmma_tf32<NT>(part[g % 2], ahi[g % 2][j], dl, 1);
        wgmma_tf32<NT>(part[g % 2], ahi[g % 2][j], dh, 1);
      }
      wgmma_commit();
      if (g == 0) {
        cp_async_wait<kStages1 - 2>();         // this thread's copies of kt + 1
        if (kt + 1 < ktiles) split_tile(kt + 1);
      }
      if (g > 0) wgmma_wait<1>();             // group g - 1 done
      if (g + 1 < kGroups) load_a(g + 1, (g + 1) % 2);
      if (g > 0) add_partial(acc, part[(g + 1) % 2]);
    }
    wgmma_wait<0>();
    add_partial(acc, part[(kGroups - 1) % 2]);
  }

  // epilogue: BN2 + ReLU on the f32 sums, staged as [128][BN + 4] in the
  // ring, then 16-byte stores of h.  Accumulator layout a warp: acc[4j ..
  // 4j + 1] at row lane / 4, columns 8j + 2 * (lane % 4) + {0, 1}; acc[4j +
  // 2 .. 4j + 3] 8 rows below.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLdC = BN + 4;
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = j * 8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * wg + 16 * wi + g + half * 8;
      *reinterpret_cast<float2*>(Cs + r * kLdC + n) = make_float2(
          fmaxf(acc[4 * j + 2 * half] * mul2[n] + add2[n], 0.0f),
          fmaxf(acc[4 * j + 2 * half + 1] * mul2[n + 1] + add2[n + 1], 0.0f));
    }
  }
  __syncthreads();
  for (int v = tid; v < kBM * BN / 4; v += kThreads) {
    const int r = v / (BN / 4), c = (v % (BN / 4)) * 4;
    const long long p = m0 + r;
    if (p < npix)
      *reinterpret_cast<float4*>(h + p * BN + c) =
          *reinterpret_cast<const float4*>(Cs + r * kLdC + c);
  }
}

// ---- kernel (b) ------------------------------------------------------------

// NT = G / 8.  Block (bx, by, z): image z / d^2, phase (py, px) = ((z % d^2)
// / d, z % d); output pixel (i, j) of the tile is image pixel (py + d * (16
// by + i), px + d * (16 bx + j)) and halo pixel (i, j) is image pixel (py +
// d * (16 by - 1 + i), px + d * (16 bx - 1 + j)).  Warpgroup q owns two m64
// tiles, output rows 8q, 8q + 2, .., 8q + 6 (t = 0) and 8q + 1, 8q + 3, ..
// (t = 1); warp i of the warpgroup gives row 8q + 2i + t of tile t (16
// pixels, its m16 fragment).  Dynamic shared memory: kHaloStages x (halo hi, halo lo
// [324 x kRow2 bytes], rows by swz), then 2 x (w2 hi, w2 lo [9 taps][kStep2
// / 4 chunks][G][16 B], wgmma's canonical K-major layout, as tf32_split laid
// them out); the epilogue reuses the rings.  w2s: the layer's split w2, a
// step's hi and lo together.
template <int NT>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 2 : 1)
conv3x3_f32(const float* __restrict__ h, int bw, int height, int width,
            int dil, const float* __restrict__ w2s, float* __restrict__ stack,
            int cmax, int cin) {
  constexpr int G = NT * 8;
  static_assert(kStep2 == 8, "a step is one k8 of each tap");
  constexpr int kVecs = kStep2 / 4;           // 16-byte chunks a halo row
  constexpr int kWBytes = 9 * G * kRow2;      // one w2 tile, hi or lo
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wring = smem + kHaloStages * 2 * kHaloBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4;
  const int phases = dil * dil;
  const int img = blockIdx.z / phases, phase = blockIdx.z % phases;
  const int py = phase / dil, px = phase % dil;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  // a tile of the subgrid of a phase whose rows or columns end early
  if (py + dil * ty0 >= height || px + dil * tx0 >= width) return;
  const float* himg = h + (long long)img * height * width * bw;

  // the halo of step ch into its ring, [halo hi][halo lo] a stage
  auto load_halo = [&](int ch) {
    unsigned char* st = smem + (ch % kHaloStages) * 2 * kHaloBytes;
    const int k0 = ch * kStep2;
    for (int v = tid; v < kHaloPix * kVecs; v += kThreads) {
      const int hp = v / kVecs, c = v % kVecs;
      const int hy = hp / kHalo, hx = hp - hy * kHalo;
      const int iy = py + dil * (ty0 - 1 + hy), ix = px + dil * (tx0 - 1 + hx);
      const bool ok = iy >= 0 && iy < height && ix >= 0 && ix < width;
      cp_async16(st + swz<kRow2>(hp, c),
                 ok ? himg + ((long long)iy * width + ix) * bw + k0 + 4 * c
                    : h,
                 ok);
    }
  };
  // the step's w2 slice, hi and lo, as tf32_split laid it out, into its
  // ring
  auto load_w2 = [&](int ch) {
    unsigned char* st = wring + (ch & 1) * 2 * kWBytes;
    const float* w = w2s + (long long)ch * 2 * kWBytes / 4;
    for (int v = tid; v < 2 * kWBytes / 16; v += kThreads)
      cp_async16(st + v * 16, w + v * 4, true);
  };

  // the running sums of each m64 tile, and each tile's partial of a column
  // of taps
  float acc[2][NT * 4], part[2][NT * 4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int q = 0; q < NT * 4; ++q) acc[t][q] = part[t][q] = 0.0f;

  // copy groups, in commit order: {halo 0, w2 0}, {halo 1}, then a step
  // ch's {w2 ch + 1}, {halo ch + 2}: at step ch all but the last one hold
  // what the step reads
  const int chunks = bw / kStep2;
  load_halo(0);
  load_w2(0);
  cp_async_commit();
  if (chunks > 1) load_halo(1);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    unsigned char* hhi = smem + (ch % kHaloStages) * 2 * kHaloBytes;
    unsigned char* hlo = hhi + kHaloBytes;
    cp_async_wait<1>();
    // the halo's split on the chunks this thread copied (a zero-filled
    // pixel splits to 0 and 0)
    for (int v = tid; v < kHaloPix * kVecs; v += kThreads) {
      const int off = swz<kRow2>(v / kVecs, v % kVecs);
      float4 vh, vl;
      split4(*reinterpret_cast<const float4*>(hhi + off), vh, vl);
      *reinterpret_cast<float4*>(hhi + off) = vh;
      *reinterpret_cast<float4*>(hlo + off) = vl;
    }
    // this thread's writes to shared memory, seen by wgmma (the async
    // proxy) after the barrier; every warp done with step ch - 1, whose
    // halo and w2 stages the next loads refill
    fence_proxy_async();
    __syncthreads();
    if (ch + 1 < chunks) load_w2(ch + 1);
    cp_async_commit();
    if (ch + 2 < chunks) load_halo(ch + 2);
    cp_async_commit();

    // one column of taps (tx) at a time: warp i's rows of the two tiles are
    // output rows r = 8q + 2i and r + 1, so the halo rows r .. r + 3, read
    // once, shifted by tx, serve both (tile 0 takes rows r + ty, tile 1 rows
    // r + 1 + ty).  Each tile's three taps sum into a fresh partial, tile
    // 1's products run while tile 0's partial joins its sums.
    const uint32_t whi = smem_addr(wring + (ch & 1) * 2 * kWBytes);
    const uint32_t wlo = whi + kWBytes;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hp = (8 * wg + 2 * wi + r) * kHalo + (lane & 15) + tx;
        const int off = swz<kRow2>(hp, lane >> 4);
        ldmatrix_x4(ahi[r], hhi + off);
        ldmatrix_x4(alo[r], hlo + off);
      }
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          // w2's chunks 2 * tap and 2 * tap + 1 are the tap's k8
          const int tap = ty * 3 + tx;
          const uint64_t bhi = kmajor_desc(whi + tap * 2 * G * 16, G * 16, 128);
          const uint64_t blo = kmajor_desc(wlo + tap * 2 * G * 16, G * 16, 128);
          wgmma_tf32<NT>(part[t], alo[t + ty], bhi, ty > 0);
          wgmma_tf32<NT>(part[t], ahi[t + ty], blo, 1);
          wgmma_tf32<NT>(part[t], ahi[t + ty], bhi, 1);
        }
        wgmma_commit();
      }
      wgmma_wait<1>();
      add_partial(acc[0], part[0]);
      wgmma_wait<0>();
      add_partial(acc[1], part[1]);
    }
  }

  // epilogue: the sums staged [256][G + 4] in the ring, then 16-byte stores
  // into stack channels [cin, cin + G) of the pixels in the image
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kLdC = G + 4;
  constexpr int kCV = G / 4;                  // 16-byte vectors a pixel
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (8 * wg + 2 * wi + t) * kTile + g + half * 8;
        *reinterpret_cast<float2*>(Cs + r * kLdC + j * 8 + 2 * tq) =
            make_float2(acc[t][4 * j + 2 * half], acc[t][4 * j + 2 * half + 1]);
      }
  __syncthreads();
  float* simg = stack + (long long)img * height * width * cmax;
  for (int v = tid; v < kTile * kTile * kCV; v += kThreads) {
    const int r = v / kCV, c = (v % kCV) * 4;
    const int y = py + dil * (ty0 + r / kTile);
    const int x = px + dil * (tx0 + r % kTile);
    if (y < height && x < width)
      *reinterpret_cast<float4*>(simg + ((long long)y * width + x) * cmax +
                                 cin + c) =
          *reinterpret_cast<const float4*>(Cs + r * kLdC + c);
  }
}

// ---- host ------------------------------------------------------------------

template <int BN>
cudaError_t launch_conv1(int grid, cudaStream_t s, const float* stack,
                         long long npix, int cmax, int cin, const float* mul1,
                         const float* add1, const float* w1s,
                         const float* mul2, const float* add2, float* h) {
  const int ktiles = (cin + kStep1 - 1) / kStep1;
  const size_t bytes = (size_t)kStages1 * 2 * (kBM + BN) * kRow1 +
                       2 * sizeof(float) * ktiles * kStep1;
  cudaError_t err = cudaFuncSetAttribute(
      conv1x1_bn_relu_f32<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  conv1x1_bn_relu_f32<BN><<<grid, kThreads, bytes, s>>>(
      stack, npix, cmax, cin, mul1, add1, w1s, mul2, add2, h);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_conv2(dim3 grid, cudaStream_t s, const float* h, int bw,
                         int height, int width, int dil, const float* w2s,
                         float* stack, int cmax, int cin) {
  const size_t bytes =
      2 * (kHaloStages * (size_t)kHaloBytes + 2 * 9 * NT * 8 * kRow2);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_f32<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  conv3x3_f32<NT><<<grid, kThreads, bytes, s>>>(h, bw, height, width, dil,
                                                w2s, stack, cmax, cin);
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch `wsplit` that dense_block_eval_f32 needs for the weights'
// halves at these sizes, in floats (2 * (w1 + w2) when cmax is a multiple
// of 32, the 1x1's step).
extern "C" long long dense_block_eval_f32_scratch(int cmax, int layers,
                                                  int bw, int growth) {
  return split_floats(w1_layout(nullptr, nullptr, layers, bw, cmax)) +
         split_floats(w2_layout(nullptr, nullptr, layers, growth, bw));
}

// stack [B, H, W, cmax] with the block input in channels [0, c0); h scratch
// [B * H * W, bw]; wsplit scratch of dense_block_eval_f32_scratch floats for
// the weights' halves; per layer l (all contiguous f32): mul1/add1 [L,
// cmax], w1 [L, bw, cmax], mul2/add2 [L, bw], w2 [L, G, 9 * bw] with k =
// (ty * 3 + tx) * bw + channel.  Fills channels [c0, cmax) of the stack:
// one tf32_split launch, then 2 launches per layer, on `stream`.  Returns
// 0, or the first CUDA error (cudaErrorInvalidValue for a size it does not
// take).
extern "C" int dense_block_eval_f32(void* stack, void* h, void* wsplit,
                                    const void* mul1, const void* add1,
                                    const void* w1, const void* mul2,
                                    const void* add2, const void* w2,
                                    int batch, int height, int width, int c0,
                                    int cmax, int layers, int bw, int growth,
                                    int dilation, void* stream) {
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
  float* st = static_cast<float*>(stack);
  float* hb = static_cast<float*>(h);
  // the weights' halves, once a call, each in its kernel's layout
  float* ws = static_cast<float*>(wsplit);
  const SplitLayout l1 =
      w1_layout(static_cast<const float*>(w1), ws, layers, bw, cmax);
  const SplitLayout l2 = w2_layout(static_cast<const float*>(w2),
                                   ws + split_floats(l1), layers, growth, bw);
  cudaError_t err = launch_split(l1, l2, s);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < layers; ++l) {
    const int cin = c0 + l * growth;
    const float* m1 = static_cast<const float*>(mul1) + (long long)l * cmax;
    const float* a1 = static_cast<const float*>(add1) + (long long)l * cmax;
    const float* k1 = l1.out + split_floats(l1) / layers * l;
    const float* m2 = static_cast<const float*>(mul2) + (long long)l * bw;
    const float* a2 = static_cast<const float*>(add2) + (long long)l * bw;
    const float* k2 = l2.out + split_floats(l2) / layers * l;
    switch (bw) {
      case 32: err = launch_conv1<32>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 64: err = launch_conv1<64>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      case 96: err = launch_conv1<96>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
      default: err = launch_conv1<128>(grid1, s, st, npix, cmax, cin, m1, a1, k1, m2, a2, hb); break;
    }
    if (err != cudaSuccess) return (int)err;
    switch (growth / 8) {
      case 1: err = launch_conv2<1>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 2: err = launch_conv2<2>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 3: err = launch_conv2<3>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 4: err = launch_conv2<4>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 5: err = launch_conv2<5>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 6: err = launch_conv2<6>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      case 7: err = launch_conv2<7>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
      default: err = launch_conv2<8>(grid2, s, hb, bw, height, width, dilation, k2, st, cmax, cin); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The prep kernel alone, in a plain layout: x [rows, len] f32 (len a
// multiple of 4) -> out [rows][hi, lo][len], each row of x a layer of one
// row split in one step.
extern "C" int tf32_split_f32(const void* x, int rows, int len, void* out,
                              void* stream) {
  if (len % 4 || rows < 0 || len < 0) return (int)cudaErrorInvalidValue;
  const SplitLayout t = {static_cast<const float*>(x),
                         static_cast<float*>(out), rows, 1, len, 1, len / 4,
                         len / 4, len, 0, len};
  SplitLayout none = t;
  none.layers = 0;
  return (int)launch_split(t, none, static_cast<cudaStream_t>(stream));
}
