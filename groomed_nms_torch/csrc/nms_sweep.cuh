// The greedy sweep over a suppression bitmask, shared by K2
// (greedy_nms.cu: the kept rows of exact greedy NMS) and the GrooMeD
// grouping kernel (group_leaders.cu: the group leaders, which are the
// greedy survivors of "overlap > threshold").
//
// The mask is one image's [n, nwords] uint64 words in K2's column layout:
// in row j, word w, bit c is set when row j suppresses row w * 64 + c, for
// later rows only; words before row j's own block are never read.  One
// block of kSweepThreads threads walks the row blocks in order: one
// resolver warp and kUpdaters updater warps, one barrier per row block.
// For block rb the resolver holds the rows' diagonal words mask[row][rb]
// (two rows a lane), prefetched by cp.async into a double buffer in shared
// memory while block rb - 1 resolved.  The kept rows are the fixed point of
// "the candidates that no kept row suppresses", found by warp OR reductions
// in (longest chain of suppressions among the candidates) + 1 rounds, with
// no shared memory, shuffle or barrier in between.  The resolver ORs the
// kept rows' next two words, mask[row][rb+1] and mask[row][rb+2]
// (prefetched beside the diagonal), into two carries in registers: the
// next block waits on nothing else.  The updater warps OR the kept rows
// into the words >= rb + 3 of the removed bitset in shared memory, the
// loads issued one step and ORed the next, so their L2 latency falls
// across a barrier instead of on the chain.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms {

using u64 = unsigned long long;

constexpr int kBlock = 64;
constexpr int kUpdaters = 16;               // updater warps of the sweep
constexpr int kRowsPerUpdater = kBlock / kUpdaters;
constexpr int kSweepThreads = 32 * (1 + kUpdaters);
constexpr int kPipeWords = 2;               // 32-word groups an updater lane
                                            // keeps in flight across a step
constexpr unsigned kFull = 0xffffffffu;

// 4 or 8 bytes global -> shared; when !valid nothing is read and the bytes
// are zero-filled (src-size 0)
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "n"(Bytes), "r"(valid ? Bytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// the "memory" clobber keeps this thread's reads of the landed copies below
// the wait
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// OR of a 64-bit value over the warp (the intrinsic is 32-bit)
__device__ __forceinline__ u64 warp_or(u64 v) {
  return (u64)__reduce_or_sync(kFull, (uint32_t)v) |
         ((u64)__reduce_or_sync(kFull, (uint32_t)(v >> 32)) << 32);
}

// the words of this lane's two rows (lane, lane + 32) that `rows` keeps
__device__ __forceinline__ u64 own_words(u64 rows, int lane, u64 w0, u64 w1) {
  return (((rows >> lane) & 1ULL) ? w0 : 0ULL) |
         (((rows >> (lane + 32)) & 1ULL) ? w1 : 0ULL);
}

// removed[w] |= v as two 32-bit ORs (a 64-bit OR on shared memory is a
// compare-and-swap loop); v is 0 for a word past the end
__device__ __forceinline__ void or_word(u64* removed, int w, u64 v) {
  uint32_t* half = reinterpret_cast<uint32_t*>(removed + w);
  if ((uint32_t)v) atomicOr(half, (uint32_t)v);
  if (v >> 32) atomicOr(half + 1, (uint32_t)(v >> 32));
}

// The sweep of one image's mask `m` ([n, nwords]) by the whole block;
// `removed` is nwords words of shared memory.  `rows` says which rows are
// candidates and takes the result, from the resolver warp:
//   rows.prefetch(buf, i, row, in) -- issue the cp.async copies of row `row`
//     (slot i of buffer buf; `in`: row < n) that rows.valid reads;
//   rows.valid(buf, rb, lane) -> u64 -- the candidate rows of block rb, once
//     buffer buf has landed (rows past n must be 0);
//   rows.kept(rb, lane, kept) -- the kept rows of block rb.
// What a caller writes to shared memory before the call is visible to the
// resolver (the sweep starts with a barrier); what rows.kept writes there is
// visible to the whole block after it (it ends with one).
template <class Rows>
__device__ __forceinline__ void greedy_sweep(const u64* __restrict__ m, int n,
                                             int nwords, u64* removed,
                                             Rows& rows) {
  __shared__ u64 sdiag[2][kBlock], ssup1[2][kBlock], ssup2[2][kBlock];
  __shared__ u64 skept[2];
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  for (int w = t; w < nwords; w += blockDim.x) removed[w] = 0ULL;

  // resolver: rows lane and lane + 32 of row block rb into buffer rb & 1
  auto prefetch = [&](int rb) {
    const int buf = rb & 1;
    for (int q = 0; q < 2; ++q) {
      const int i = lane + 32 * q;
      const int row = rb * kBlock + i;
      const bool in = row < n;
      const bool sup1 = in && rb + 1 < nwords, sup2 = in && rb + 2 < nwords;
      const size_t at = (size_t)row * nwords + rb;
      cp_async<8>(&sdiag[buf][i], in ? m + at : m, in);
      cp_async<8>(&ssup1[buf][i], sup1 ? m + at + 1 : m, sup1);
      cp_async<8>(&ssup2[buf][i], sup2 ? m + at + 2 : m, sup2);
      rows.prefetch(buf, i, row, in);
    }
    cp_async_commit();
  };
  // resolver: the kept rows of earlier blocks into words rb and rb + 1
  u64 carry1 = 0ULL, carry2 = 0ULL;
  // updater: loads in flight, rows x words rb + 2 + lane + 32 q
  u64 pend[kRowsPerUpdater][kPipeWords];
#pragma unroll
  for (int j = 0; j < kRowsPerUpdater; ++j)
#pragma unroll
    for (int q = 0; q < kPipeWords; ++q) pend[j][q] = 0ULL;
  if (warp == 0) prefetch(0);
  __syncthreads();

  for (int rb = 0; rb < nwords; ++rb) {
    if (warp == 0) {
      if (rb + 1 < nwords) prefetch(rb + 1);
      else cp_async_commit();                  // keep one group per block
      cp_async_wait1();                        // this lane's block rb landed
      const int buf = rb & 1;
      const u64 d0 = sdiag[buf][lane], d1 = sdiag[buf][lane + 32];
      const u64 cand = rows.valid(buf, rb, lane) & ~(removed[rb] | carry1);
      // the kept rows are the fixed point of "a candidate no kept row
      // suppresses": row i's status is final once every earlier row's is,
      // so from any start the iteration ends after the longest chain of
      // suppressions among the candidates, plus one
      u64 kept = cand;
      for (;;) {
        const u64 next = cand & ~warp_or(own_words(kept, lane, d0, d1));
        if (next == kept) break;
        kept = next;
      }
      rows.kept(rb, lane, kept);
      carry1 = carry2 | warp_or(own_words(kept, lane, ssup1[buf][lane],
                                          ssup1[buf][lane + 32]));
      carry2 = warp_or(own_words(kept, lane, ssup2[buf][lane],
                                 ssup2[buf][lane + 32]));
      if (lane == 0) skept[buf] = kept;
    } else {
      // updater warp u owns rows u * kRowsPerUpdater.. of a block, a lane
      // one word in 32.  First what landed: block rb - 2 into words >= rb + 1
      const int u = warp - 1;
#pragma unroll
      for (int q = 0; q < kPipeWords; ++q) {
        u64 acc = 0ULL;
#pragma unroll
        for (int j = 0; j < kRowsPerUpdater; ++j) acc |= pend[j][q];
        or_word(removed, rb + 1 + lane + 32 * q, acc);
      }
      // then block rb - 1 into words >= rb + 2: the first 32 kPipeWords
      // loaded now and ORed next step, any further ones at once
      const u64 kept =
          rb > 0 ? skept[(rb - 1) & 1] >> (u * kRowsPerUpdater) : 0ULL;
      const u64* rows_m =
          m + ((size_t)(rb - 1) * kBlock + u * kRowsPerUpdater) * nwords;
#pragma unroll
      for (int q = 0; q < kPipeWords; ++q) {
        const int w = rb + 2 + lane + 32 * q;
#pragma unroll
        for (int j = 0; j < kRowsPerUpdater; ++j)
          pend[j][q] = ((kept >> j) & 1ULL) && w < nwords
                           ? rows_m[(size_t)j * nwords + w] : 0ULL;
      }
      if (kept & ((1ULL << kRowsPerUpdater) - 1)) {
        for (int w = rb + 2 + 32 * kPipeWords + lane; w < nwords; w += 32) {
          u64 acc = 0ULL;
#pragma unroll
          for (int j = 0; j < kRowsPerUpdater; ++j)
            if ((kept >> j) & 1ULL) acc |= rows_m[(size_t)j * nwords + w];
          or_word(removed, w, acc);
        }
      }
    }
    // the resolver's kept bits out, the updaters' words >= rb + 1 in
    __syncthreads();
  }
}

}  // namespace nms
