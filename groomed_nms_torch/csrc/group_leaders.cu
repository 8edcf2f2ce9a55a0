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
// is 4.2 MB at [8, 512] (1.25 us at 3.35 TB/s) -- but latency: the greedy
// chain (the leaders of row block rb, 64 rows, depend on those of every
// earlier block), the first loads from device memory, and the launch.  Two
// paths, chosen by the wrapper from N alone (kernels.group_leaders_plan):
//
// The cluster path (N <= kernels._GROUP_CLUSTER_MAX_N = 1024, at most 16
// row blocks; the training step's [8, 512] and the analysis path's
// [1, 1000]): one launch, group_cluster, one thread block cluster per image
// of one 1024-thread CTA a row block (more than 8 non-portable), nothing in
// device memory but m, valid and the output.
//   * CTA q owns row block q.  Its warps 1.. threshold the tiles (q, 0..q)
//     of its rows, m's strict lower triangle read once, 128 bytes a warp
//     load, eight rows a warp in flight, into its rows' `over` words in
//     shared memory (row i, word cb, bit j for m[i, j] > thr, j < i).
//   * The chain runs across the cluster in distributed shared memory
//     (DSMEM).  CTA q publishes its leader word to every later CTA as two
//     mailbox words, (1 << 32) | half: each a single-copy-atomic 64-bit
//     store that carries its own ready bit, so neither side needs a fence.
//     In CTA q, lane cb < q of warp 0 watches block cb's mailbox in its own
//     shared memory; each block is ORed into the rows' removal words (over
//     words & leader word) as it turns up, so only the latest is on the
//     chain.  The diagonal block then resolves by the fixed-point warp
//     rounds of nms_sweep.cuh (in row layout: a round is two ballots).  A
//     step of the chain is one DSMEM store, one poll and one OR; no block
//     barrier, no L2 load.
//   * Groups: a row's leader is the lowest set bit of its over words & the
//     leader words, in shared memory.  After one cluster barrier each CTA
//     counts the groups of the rows before its block, a thread a row read
//     through DSMEM from their owners, into a histogram in shared memory; a
//     row's rank is that count plus two ballots over its own block.  The
//     output is written once, as int64.
//   * A cluster barrier arrive that releases (orders the thread's writes
//     before it) waits for them to be performed cluster-wide and costs
//     several times a relaxed one, so a thread releases only where another
//     CTA reads what it wrote: warp 0 after emptying the mailboxes (warps
//     1.. arrive relaxed and start loading at once), the warps that wrote
//     the groups of a block some later CTA counts, and never at the exit
//     barrier.
// The two-kernel path (N above 1024, more row blocks than a cluster holds
// CTAs; the PR 7 design, which reads the triangle with the whole card):
//   kernel 1 (group_bits): one 256-thread block per lower-triangle 64 x 64
//     tile (rb >= cb) of every image, each tile of m read once.  A warp
//     thresholds a row's 64 columns into one word by two ballots (`over`,
//     row layout); the tile's 64 words, transposed by ballots in shared
//     memory, give `sup` in K2's column layout (row j, word rb, bit i for
//     m[i, j] > thr, i > j).
//   kernel 2 (group_sweep): one block per image.  The leaders are the
//     greedy survivors of `sup` among the valid rows: the sweep of
//     nms_sweep.cuh, K2's, with validity from `valid`.  Then every thread
//     takes rows (a non-leader's group is the lowest set bit of over[i] &
//     leaders, word by word), and one warp walks the rows in order, 32 at a
//     time, for the ranks (__match_any_sync, a counter per group).
// Shared-memory and cluster-size attributes are set once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using nms::kBlock;
using nms::kFull;
using nms::kSweepThreads;
using nms::u64;

constexpr int kMaxN = 8192;                 // kernels._GROUP_MAX_N
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// The cluster path
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 1024;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kRowsInFlight = 8;            // rows a warp loads, then ballots
// CTAs a cluster, one a row block (kernels._GROUP_CLUSTER_CTAS); more than
// 8 is non-portable.  The rows before a block are at most kClusterThreads
constexpr int kMaxCluster = 16;

// the dynamic shared memory of group_cluster at N rows in nb row blocks:
// the CTA's over words [nb][64], two mailbox words and a leader word a row
// block and its valid word (u64); a group a row of its block and a group
// count a row of the image (int32).  12.6 KB at N = 1024
size_t cluster_smem(int n, int nb) {
  return 8 * ((size_t)nb * kBlock + 3 * (size_t)nb + 1) +
         4 * ((size_t)kBlock + n);
}

// A leader word travels as two mailbox words, (1 << 32) | half: each is
// one single-copy-atomic 64-bit store that carries its own ready bit, so
// neither side needs a fence.
__device__ __forceinline__ void store_relaxed_cluster(u64* p, u64 v) {
  asm volatile("st.relaxed.cluster.u64 [%0], %1;\n" :: "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 load_relaxed_cluster(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.cluster.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// the cluster barrier in two halves; every thread of every CTA of the
// cluster takes both, in turn.  The arrive releases (orders this thread's
// writes before the barrier) or not; the wait acquires
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Block (q, b): CTA q of image b's cluster of nb CTAs, owning row block q.
__global__ void __launch_bounds__(kClusterThreads)
group_cluster(const float* __restrict__ m, const uint8_t* __restrict__ valid,
              long long* __restrict__ out, int n, int nb, float thr,
              int cap) {
  extern __shared__ u64 smem[];
  u64* sover = smem;                                  // [nb][64]
  u64* sbox = sover + (size_t)nb * kBlock;            // [nb][2] mailboxes
  u64* skept = sbox + 2 * nb;                         // [nb] leader words
  u64* svalid = skept + nb;                           // [1]
  int* sfirst = reinterpret_cast<int*>(svalid + 1);   // [64] groups
  int* scount = sfirst + kBlock;                      // [n] histogram
  cg::cluster_group cluster = cg::this_cluster();
  const int q = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int r0 = q * kBlock;                          // the block's first row

  // -- warp 0 empties the mailboxes (and the histogram), releases that (no
  // other CTA writes a mailbox before its wait below) and reads the valid
  // bits; warps 1.. read the over words of the block's rows meanwhile
  if (warp == 0) {
    for (int w = lane; w < 2 * nb; w += 32) sbox[w] = 0ULL;
    for (int i = lane; i < n; i += 32) scount[i] = 0;
    cluster_arrive_release();
    const uint8_t* v = valid + (size_t)b * n + r0;
    const u64 bits =
        (u64)__ballot_sync(kFull, r0 + lane < n && v[lane] != 0) |
        ((u64)__ballot_sync(kFull, r0 + lane + 32 < n && v[lane + 32] != 0)
         << 32);
    if (lane == 0) *svalid = bits;
  } else {
    cluster_arrive_relaxed();
    const float* mb = m + (size_t)b * n * n;
    for (int u0 = (warp - 1) * kRowsInFlight; u0 < (q + 1) * kBlock;
         u0 += (kClusterWarps - 1) * kRowsInFlight) {
      // row unit u0 -> tile (q, cb), rows li0.. of the tile
      const int cb = u0 / kBlock, li0 = u0 % kBlock;
      const int j0 = cb * kBlock + lane, j1 = j0 + 32;
      float x0[kRowsInFlight], x1[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {   // all loads in flight
        const int i = r0 + li0 + k;
        const float* row = mb + (size_t)i * n;
        x0[k] = i < n && j0 < i ? row[j0] : 0.0f;
        x1[k] = i < n && j1 < i ? row[j1] : 0.0f;
      }
      u64 mine = 0ULL;
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        const int i = r0 + li0 + k;
        const u64 word =
            (u64)__ballot_sync(kFull, i < n && j0 < i && x0[k] > thr) |
            ((u64)__ballot_sync(kFull, i < n && j1 < i && x1[k] > thr) << 32);
        if (lane == k) mine = word;
      }
      if (lane < kRowsInFlight) sover[cb * kBlock + li0 + lane] = mine;
    }
  }
  __syncthreads();
  cluster_wait();

  // -- the chain: warp 0 resolves the block once the leaders of blocks
  // 0..q-1 are in.  Rows lane and lane + 32 against them: lane cb watches
  // block cb's mailbox, and each block is ORed in as it turns up, so only
  // the latest one is on the chain
  if (warp == 0) {
    const unsigned want = (1u << q) - 1u;         // q < kMaxCluster
    unsigned folded = 0u;
    bool seen = lane >= q;
    u64 acc0 = 0ULL, acc1 = 0ULL;
    while (folded != want) {
      if (!seen) {
        const u64 lo = load_relaxed_cluster(sbox + 2 * lane);
        const u64 hi = load_relaxed_cluster(sbox + 2 * lane + 1);
        if ((lo >> 32) && (hi >> 32)) {
          skept[lane] = (lo & 0xffffffffULL) | (hi << 32);
          seen = true;
        }
      }
      unsigned fresh = __ballot_sync(kFull, seen) & want & ~folded;
      __syncwarp();                     // the decoded words to the warp
      folded |= fresh;
      while (fresh) {
        const int cb = __ffs(fresh) - 1;
        fresh &= fresh - 1;
        const u64 kw = skept[cb];
        acc0 |= sover[cb * kBlock + lane] & kw;
        acc1 |= sover[cb * kBlock + lane + 32] & kw;
      }
    }
    const u64 removed =
        (u64)__ballot_sync(kFull, acc0 != 0ULL) |
        ((u64)__ballot_sync(kFull, acc1 != 0ULL) << 32);
    const u64 cand = *svalid & ~removed;
    // the block's leaders: the fixed point of "a candidate over no leader
    // of the block", reached after the longest chain of overlaps among the
    // candidates, plus one, rounds (nms_sweep.cuh)
    const u64 d0 = sover[q * kBlock + lane], d1 = sover[q * kBlock + lane + 32];
    u64 kept = cand;
    for (;;) {
      const u64 hit = (u64)__ballot_sync(kFull, (d0 & kept) != 0ULL) |
                      ((u64)__ballot_sync(kFull, (d1 & kept) != 0ULL) << 32);
      const u64 next = cand & ~hit;
      if (next == kept) break;
      kept = next;
    }
    // publish: lane p to CTA p, for every later block p
    if (lane > q && lane < nb) {
      u64* box = cluster.map_shared_rank(sbox, lane) + 2 * q;
      store_relaxed_cluster(box, (1ULL << 32) | (kept & 0xffffffffULL));
      store_relaxed_cluster(box + 1, (1ULL << 32) | (kept >> 32));
    }
    if (lane == 0) skept[q] = kept;
  }
  __syncthreads();

  // -- every row's group: itself for a leader, else the first leader it is
  // over (a valid non-leader always has one), -1 for padding.  The words
  // are scanned from the last to the first with no early exit, so that
  // their loads overlap
  if (t < kBlock) {
    int first = -1;
    if ((*svalid >> t) & 1ULL) {
      if ((skept[q] >> t) & 1ULL) {
        first = r0 + t;
      } else {
#pragma unroll 4
        for (int cb = q; cb >= 0; --cb) {
          const u64 hit = sover[cb * kBlock + t] & skept[cb];
          if (hit) first = cb * kBlock + __ffsll((long long)hit) - 1;
        }
      }
    }
    sfirst[t] = first;
  }
  // every CTA's groups in: released by the two warps that wrote them, in
  // every CTA but the last (whose groups no later block counts)
  if (q < nb - 1 && t < kBlock) cluster_arrive_release();
  else cluster_arrive_relaxed();
  cluster_wait();

  // -- ranks: the groups of the r0 rows before the block (r0 <= 960 <
  // kClusterThreads), a thread a row read through DSMEM from their owners,
  // counted into scount; then each row's rank in its own block
  if (t < r0) {
    const int g = cluster.map_shared_rank(sfirst, t / kBlock)[t % kBlock];
    if (g >= 0) atomicAdd(&scount[g], 1);
  }
  // no more DSMEM reads from here (the one above is complete: its value is
  // used), and no DSMEM write is left in flight
  cluster_arrive_relaxed();
  __syncthreads();
  // a warp a row: its lanes hold the block's rows lane and lane + 32, and
  // two ballots count those before the row in its group
  long long* o = out + (size_t)b * n;
  const int f0 = sfirst[lane], f1 = sfirst[lane + 32];
#pragma unroll
  for (int li = warp; li < kBlock; li += kClusterWarps) {
    const int g = sfirst[li];
    const int rank = __popc(__ballot_sync(kFull, lane < li && f0 == g)) +
                     __popc(__ballot_sync(kFull, lane + 32 < li && f1 == g));
    const int i = r0 + li;
    if (lane == 0 && i < n) o[i] = g >= 0 && scount[g] + rank < cap ? g : -1;
  }
  // no CTA leaves while another may still read its shared memory
  cluster_wait();
}

// ---------------------------------------------------------------------------
// The two-kernel path
// ---------------------------------------------------------------------------

constexpr int kBitsThreads = 256;
constexpr int kBitsWarps = kBitsThreads / 32;
constexpr int kRowsPerWarp = kBlock / kBitsWarps;

size_t sweep_smem(int n, int nwords) {
  return 3 * (size_t)nwords * sizeof(u64) + 2 * (size_t)n * sizeof(int);
}

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

// The kernels' attributes, once per device: group_sweep's dynamic shared
// memory at kMaxN, and group_cluster's clusters of up to 16 CTAs (its
// shared memory stays under the default 48 KB).
cudaError_t set_attributes_once() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(group_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sweep_smem(kMaxN, kMaxN / kBlock));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(group_cluster,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// m [B, N, N] f32, valid [B, N] bool as bytes, out [B, N] int64; all
// contiguous on the current device.  cap = group_size + 1 clamped to [0,
// N + 1].  `cluster` > 0 takes the cluster path, a cluster of `cluster` =
// ceil(N / 64) <= 16 CTAs an image, as kernels.group_leaders_plan gives it
// (sup and over unused, may be null); `cluster` == 0 the two-kernel path,
// with sup / over scratch [B, N, nwords] u64.  Launches on `stream` and
// returns the launch's CUDA error as an int (cudaErrorInvalidValue for a
// size or plan the kernels cannot take).
extern "C" int group_leaders(const void* m, const void* valid, void* sup,
                             void* over, void* out, int batch, int n,
                             float thr, int cap, int cluster, void* stream) {
  if (batch == 0 || n == 0) return 0;
  if (n > kMaxN || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_attributes_once();
  if (err != cudaSuccess) return (int)err;
  const int nwords = (n + kBlock - 1) / kBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (cluster != nwords || cluster > kMaxCluster)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster, (unsigned)batch, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = cluster_smem(n, nwords);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, group_cluster,
                             static_cast<const float*>(m),
                             static_cast<const uint8_t*>(valid),
                             static_cast<long long*>(out), n, nwords, thr,
                             cap);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (sup == nullptr || over == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)nwords * (nwords + 1) / 2;
  group_bits<<<dim3((unsigned)tiles, batch), kBitsThreads, 0, s>>>(
      static_cast<const float*>(m), static_cast<u64*>(sup),
      static_cast<u64*>(over), n, nwords, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_sweep<<<batch, kSweepThreads, sweep_smem(n, nwords), s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const u64*>(sup),
      static_cast<const u64*>(over), static_cast<long long*>(out), n, nwords,
      cap);
  return (int)cudaGetLastError();
}
