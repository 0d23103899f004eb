// y = x @ w with an fp32 accumulator, for sm_90a: three kernels, by M and
// dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiered_matmul.py
// (`tiered_matmul`, body `_mm_kernel`): both inputs are cast to fp32, the
// products are summed in fp32 across K, and the result is written in x's
// dtype.  Any M, N, K: every edge is masked here, the wrapper pads nothing.
//
// What bounds it on this card: bytes.  The serving paths call it at M = 4
// (batch 4) in bf16: each weight element is used for 4 multiply-adds, about
// 4 flops per weight byte against the ~295 an H100 needs before the tensor
// cores matter.  The dry run's decode cells call it at M = 128: 128 flops a
// weight byte, still under that line.  So each kernel is a weight stream
// and its floor is K * N * 2 bytes over HBM bandwidth (20 us for gemma-2b's
// 2048 x 16384 w_gate); what costs time is bytes not in flight, a weight
// tile read more than once, a second launch, a grid that leaves SMs idle in
// a last partial wave, and any step of a block that waits on a round trip
// to memory.  The route and the grid are chosen by kernels/tiered_matmul.py
// (`route`, `plan`), by shape alone.
//
// bf16 with M <= 8 (every serving batch) and rows of w TMA can describe,
// `tiered_mma_kernel`:
// * Weight tiles of 64 rows of K by 128 columns (16 KB, two 64-column TMA
//   boxes) stream by TMA (a 2-D tensor map, 128-byte swizzle, zeros past K
//   and N) into a ring of kStages = 4 under full/empty mbarriers, from one
//   producer thread, while 4 consumer warps work on the stages that have
//   landed; a stage is refilled only after every consumer warp has
//   released it.  The ring holds 64 KB, and two blocks fit an SM, so an SM
//   keeps 64 to 128 KB in flight: Little's law asks ~25 KB an SM for
//   3.35 TB/s at ~1 us.  On the H100 3 or 4 stages streamed as fast as 6
//   or 8 (more requests in flight only queue), and 4 leaves room for the
//   second block.  The loads carry an evict-first L2 policy: the weights
//   are read once a step, and a stream that evicts only its own lines
//   leaves the rest of the cache (and other data's dirty lines) alone.
//   The tensor map of a weight is encoded once and cached by (address, N,
//   K): weights do not move between steps, so a call costs a hash lookup,
//   not an encoding.  It is passed as a __grid_constant__ parameter.
// * The math is on the tensor cores: y^T = w^T x^T with mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate).  The weight tile is the 16-row A
//   operand, loaded from the [k][n] stage by ldmatrix.trans (conflict-free
//   under the swizzle); the block's <= 8 rows of x, zero-padded to 8, are
//   the n = 8 B operand, staged once in shared memory (a window of 2048 k's,
//   rows padded by 16 bytes so ldmatrix meets no bank conflict) before the
//   stream starts.  Loaded from L2 a stage ahead instead, x made every
//   stage wait a round trip: a block's time grew with its stage count, not
//   its bytes.  bf16 x bf16 products are exact in fp32, so this is the
//   reference's function summed in another order.  One warp instruction
//   takes 256 weight elements.  M > 8 takes more blocks along y, each
//   re-reading w: the wrapper sends such M to the warpgroup kernel below
//   whenever x's rows are TMA rows too (K a multiple of 8, x 16-byte
//   aligned), so only an x that TMA cannot describe reads w more than once.
// * One launch a call.  K is split across n_split <= 8 blocks that form
//   one thread-block cluster; each leaves its fp32 partial (8 x 128) in its
//   shared memory, and after a cluster barrier every block sums a share of
//   the outputs over the partials of the whole cluster, read through
//   distributed shared memory in rank order: the same inputs give the same
//   bits on every run, with no workspace and no second kernel.  8 is the
//   portable cluster size.
// * The grid is sized to the card by the wrapper: enough K splits that
//   95 % of the SMs get a block, more while each split keeps 16 stages and
//   the grid stays one wave, so no partial wave runs on a mostly idle card.
// * A wait on an mbarrier that has not completed after ~4 s traps (the
//   launch fails) instead of spinning forever.
//
// bf16 with M >= 9 whose rows of x and of w TMA can describe,
// `tiered_wgmma_kernel` (the dry run's decode batch of 128):
// * A block takes 128 rows of x by 128 columns of w, so at M = 128 each
//   weight tile is read once a call (the "mma" kernel read it 16 times).
//   One producer thread (warp 8) streams stages of 64 rows of K by TMA into
//   a ring under full/empty mbarriers: x's 128 x 64 box (2-D map over (K,
//   M), 128-byte swizzle, zeros past M and K, evict-last: every column
//   tile reads it) and w's two 64-column boxes (the cached map above,
//   evict-first; boxes wholly past N are not loaded).  Two consumer
//   warpgroups (warps 0-7) each own 64 rows of x and all 128 columns: 4 x
//   wgmma.m64n128k16 a stage, A = x K-major from shared memory, B = w's
//   stage MN-major (its leading offset steps one box, as V in
//   flash_attention.cu), 64 fp32 accumulators a thread.  A stage is
//   released only after wgmma_wait has retired the group that read it (one
//   group in flight behind the newest).
// * x is a fresh activation at every call, so its tensor map is encoded on
//   the host at every call.  chip_smoke.py's threshold rows time both
//   tensor-core launches' host time a call at each M: on an H100 this
//   route's, map included, lay within the spread of the "mma" kernel's,
//   which encodes nothing for x -- what staging x by cp.async would cost
//   the host -- 17-30 us a call either way.  So the map stays: it keeps
//   x's loads off the consumers.
// * K splits as above (n_split <= 8 blocks of a cluster), planned by the
//   wrapper with this kernel's own shared memory; a split's 128 x 128 fp32
//   partial (64 KB) goes into the ring once the stream ends, and the
//   cluster sums the partials in rank order through DSMEM, four columns a
//   load and 8 loads in flight a thread: the same bits on every run, no
//   atomics, no workspace.  One split (the wide products) skips the
//   merge: each thread stores its sums straight to y.  With K splits the
//   ring has 3 stages (99 KB: two blocks an SM, so a cluster of 8 finds
//   room); with one split whose tiles fit one block an SM, 4.  On the H100
//   (throwaway variant sweeps, not kept) 4 stages everywhere were slower on
//   the split products and 3 everywhere on the unsplit ones; pushing the
//   partials to each row's owner block by posted DSMEM stores was slower than
//   reading them, and a merge that read one value at a time was the largest
//   cost of all.
// * Rows past M and columns past N are never stored; byte offsets into y
//   are 64-bit; K past the last stage is zeros in both boxes.
//
// fp32, and bf16 whose rows of w are not 16-byte multiples or whose base
// is not 16-byte aligned (TMA cannot describe them; no serving shape), take
// `tiered_ffma_kernel`: FFMA (no TF32, so fp32 meets the reference's 2e-5),
// each thread 8 adjacent columns of a weight row by 16-byte loads where
// the row allows it, x staged in shared memory as fp32, and the same
// cluster split-K merge.
//
// The expert route (`tiered_matmul_experts_launch`): y[r] = x[r] @
// w[expert[r]] for a stack of E weights (E, K, N) and one expert index a
// row, on the device.  It replaces no TPU kernel: the reference computes an
// MoE layer's expert products with `jnp.einsum` over a dense (B, E, C, d)
// dispatch buffer (src/repro/models/moe.py), which at decode (C = 8 slots
// an expert, one token a row) reads every expert's weights each step.  It
// is bound by the bytes of the experts the rows pick, and by nothing else:
// a moonshot-v1-16b-a3b decode step at batch 4 picks ~21 of 64 experts a
// layer (a third of the dense buffer's bytes).  The rows are grouped by
// expert inside the kernel, with no host sync and no second launch: every
// block counts the rows of each expert in shared memory (R <= a few
// thousand, E <= kMaxExperts) and takes grid slot y as the y-th (expert,
// tile of 8 rows) pair in expert order, the rows of each expert in
// increasing order; a slot past the last pair exits at once.  The grid
// has min(R, R / 8 + E) slots, enough for any grouping.  A block then runs
// the kernel above on its expert: the weight tiles come through a 3-D
// tensor map over (E, K, N) at the expert's coordinate (zeros past K and
// N), x's rows are staged from the tile's row list and y is written to
// it.  So each routed expert's weight tiles are read once a product (by
// each of its 8-row tiles: twice for 9 to 16 rows), and no other expert's.
// fp32 takes the FFMA kernel the same way, in tiles of 4 rows.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;            // blocks of a cluster (portable)
constexpr int kMaxExperts = 1024;       // experts the expert route counts

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Cluster barriers: the first publishes each block's partial in its shared
// memory (release / acquire); the last only keeps that memory alive until
// every block of the cluster has read it.
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster's K split, merged: each block holds a rows x cols fp32
// partial (row stride ld) at `part` in its shared memory; the outputs are
// the sums over the blocks in rank order, partial row r written to row
// row_of[r] of y from column n0 on, each block taking every n_split-th
// share.  Called between the two barriers.
template <typename T>
__device__ __forceinline__ void merge_partials(const float* part, int ld,
                                               int rows, int cols, T* y,
                                               long long ldy,
                                               const int* row_of, int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * blockDim.x + threadIdx.x; i < rows * cols;
       i += n_split * blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    float v[kMaxSplit];                 // every rank's load in flight at once
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      v[p] = p < n_split ? *cluster.map_shared_rank(part + r * ld + c, p)
                         : 0.f;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) s += v[p];
    from_f(s, y + (long long)row_of[r] * ldy + n0 + c);
  }
}

// The rows of the expert route's grid slot `slot`: the slot-th (expert,
// tile of tm rows) pair in expert order, each expert's rows in increasing
// order, cut into tiles of tm.  Writes the tile's rows to rows[0 .. n) and
// its expert to *e, and returns n; 0 when the slot lies past the last
// pair (the block has no work).  Every thread of the block calls it; every
// thread gets the same answer.  counts: kMaxExperts ints of shared memory,
// sel: 2.  An expert index outside [0, E) traps (a launch failure).
__device__ __forceinline__ int expert_tile(const int* expert, int R, int E,
                                           int slot, int tm, int* counts,
                                           int* sel, int* rows, int* e_out) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) counts[e] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int e = __ldg(expert + r);
    if (e < 0 || e >= E) __trap();
    atomicAdd(&counts[e], 1);           // integer counts: any order
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sel[0] = -1;
    for (int e = 0, start = 0; e < E; ++e) {
      const int tiles = (counts[e] + tm - 1) / tm;
      if (slot < start + tiles) {
        sel[0] = e;
        sel[1] = (slot - start) * tm;   // the tile's first rank
        break;
      }
      start += tiles;
    }
  }
  __syncthreads();
  const int e = sel[0];
  if (e < 0) return 0;
  const int first = sel[1];
  const int n = min(tm, counts[e] - first);
  if (threadIdx.x < 32) {               // warp 0 ranks the expert's rows
    const int lane = threadIdx.x;
    for (int r0 = 0, seen = 0; r0 < R && seen < first + n; r0 += 32) {
      const int r = r0 + lane;
      const bool mine = r < R && __ldg(expert + r) == e;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      const int rank = seen + __popc(ballot & ((1u << lane) - 1u));
      if (mine && rank >= first && rank < first + n) rows[rank - first] = r;
      seen += __popc(ballot);
    }
  }
  __syncthreads();
  *e_out = e;
  return n;
}

// ------------------------------------------------- tensor cores (bf16, TMA)
constexpr int kBK = 64;                 // rows of K a ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 4;           // consumer warps
constexpr int kTcThreads = (kConsumers + 1) * 32;   // + the producer warp
constexpr int kMRows = 8;               // rows of x a block (mma's n)
constexpr int kXWin = 2048;             // k's of x staged at once
constexpr int kXLd = kXWin + 8;         // its row stride: 16 bytes past 128s

constexpr int kBoxes = 2;               // 64-column TMA boxes a stage
constexpr int kBN = 64 * kBoxes;        // columns of a tile
constexpr int kBoxBytes = kBK * 128;
constexpr int kStageBytes = kBoxes * kBoxBytes;
// alignment, the ring, x's window, the partial, the mbarriers
constexpr int kTcSmem = 1024 + kStages * kStageBytes + kMRows * kXLd * 2
                        + kMRows * kBN * 4 + 2 * kStages * 8;

struct TcArgs {
  const __nv_bfloat16* x; __nv_bfloat16* y;
  int M, N, K, k_chunk;                 // k_chunk: rows of K a split, % kBK
  int x_vec;                            // x rows read 16 bytes at a time
  const int* expert; int E;             // the expert route: M rows' experts
};

using hopper::mbar_wait_bounded;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows rows[0 .. n_rows) of x, columns k0 .. k0 + n - 1 (n a multiple of
// 64), into xs (row stride kXLd), zero past n_rows and K; by the consumer
// threads.
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const TcArgs& a,
                                        const int* rows, int n_rows, int k0,
                                        int n) {
  const int chunks = n / 8;
  for (int i = threadIdx.x; i < kMRows * chunks; i += kConsumers * 32) {
    const int r = i / chunks, k = k0 + 8 * (i - r * chunks);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) {
      const __nv_bfloat16* p = a.x + (long long)rows[r] * a.K + k;
      if (a.x_vec && k + 8 <= a.K) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = k + j < a.K
                 ? __ldg(reinterpret_cast<const unsigned short*>(p) + j) : 0;
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(xs + r * kXLd + (k - k0)) = v;
  }
}

// One weight box of the expert route: a 3-D tensor map over (E, K, N) at
// element coordinates (n, k, e), under an L2 cache policy.
__device__ __forceinline__ void tma_load_expert(void* dst, const void* tmap,
                                                uint64_t* bar, int n, int k,
                                                int e, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(hopper::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(tmap)),
         "r"(hopper::smem_addr(bar)), "r"(n), "r"(k), "r"(e), "l"(policy)
      : "memory");
}

// A block of the tensor-core kernels.  Grid (tiles of BN columns x n_split,
// y); clusters of the n_split K-split blocks of one tile, along x.  Dense
// (kExperts false): y = ceil(M / 8), block y takes rows 8 y .. 8 y + 7 of
// the one weight (a 2-D tensor map).  Expert route: block y takes the rows
// and the expert of grid slot y (`expert_tile`), or exits.
template <bool kExperts>
__device__ __forceinline__ void tc_block(const CUtensorMap* tm_w,
                                         const TcArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int rows[kMRows];
  int n_rows, ex = 0;
  if constexpr (kExperts) {
    __shared__ int counts[kMaxExperts], sel[2];
    n_rows = expert_tile(a.expert, a.M, a.E, (int)blockIdx.y, kMRows,
                         counts, sel, rows, &ex);
    if (n_rows == 0) return;            // the whole cluster: one slot
  } else {
    const int m0 = (int)blockIdx.y * kMRows;
    n_rows = min(kMRows, a.M - m0);
    if (threadIdx.x < kMRows) rows[threadIdx.x] = m0 + threadIdx.x;
  }
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * kStageBytes);
  float* part = reinterpret_cast<float*>(xs + kMRows * kXLd);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kMRows * kBN);
  uint64_t* empty = full + kStages;

  const int n_split = (int)cg::this_cluster().num_blocks();
  const int split = (int)cg::this_cluster().block_rank();
  const int n0 = (int)blockIdx.x / n_split * kBN;
  const int kt0 = split * (a.k_chunk / kBK);
  const int kt_total = (a.K + kBK - 1) / kBK;
  const int nt = min(a.k_chunk / kBK, kt_total - kt0);   // stages to run
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  } else if (threadIdx.x == kConsumers * 32) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(tm_w)) : "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: one thread keeps the ring full, read once (evict
    // first); boxes wholly past N are not loaded (no consumer reads them)
    if (lane == 0) {
      const uint64_t policy = hopper::policy_evict_first();
      const int boxes = min(kBoxes, (a.N - n0 + 63) / 64);
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages;
        mbar_wait_bounded(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b) {
          if constexpr (kExperts)
            tma_load_expert(ring + st * kStageBytes + b * kBoxBytes, tm_w,
                            &full[st], n0 + 64 * b, (kt0 + i) * kBK, ex,
                            policy);
          else
            hopper::tma_load_2d(ring + st * kStageBytes + b * kBoxBytes,
                                tm_w, &full[st], n0 + 64 * b,
                                (kt0 + i) * kBK, policy);
        }
      }
    }
  } else {
    // ---- consumers: warp w owns columns nw .. nw + 16 kBoxes - 1 of the
    // tile, kBoxes 16-column blocks; a lane holds y^T rows nw + 16 j + g
    // and + 8, the block's x rows 2 t and + 1 (g = lane / 4, t = lane % 4)
    const int nw = warp * 16 * kBoxes;
    const bool active = n0 + nw < a.N;
    const int g = lane >> 2, t = lane & 3;
    float acc[kBoxes][4];
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // ldmatrix.x4.trans (w): lanes 0-7, 8-15, 16-23, 24-31 address the
    // rows of the 8 x 8 blocks (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15,
    // n 0-7), (k 8-15, n 8-15) of a 16 x 16 block: A's a0..a3 of mma
    // m16n8k16.  Column c of the tile is 16-byte chunk (c % 64) / 8 of box
    // c / 64.  ldmatrix.x4 (x): lane l addresses row l % 8, k's 8 (l / 8)
    // on of a 32-k step: B's b0, b1 of two k16 steps.
    const int lrow = (lane & 7) + ((lane >> 4) << 3);
    const int lhalf = (lane >> 3) & 1;
    const uint32_t xaddr = hopper::smem_addr(xs)
                           + ((lane & 7) * kXLd + (lane >> 3) * 8) * 2;
    // x is staged a window of kXWin k's at a time
    for (int w0 = 0; w0 < nt; w0 += kXWin / kBK) {
      const int wn = min(kXWin / kBK, nt - w0);
      if (w0 > 0) hopper::named_sync(1, kConsumers * 32);  // window used
      stage_x(xs, a, rows, n_rows, (kt0 + w0) * kBK, wn * kBK);
      hopper::named_sync(1, kConsumers * 32);
      for (int i = w0; i < w0 + wn; ++i) {
        const int st = i % kStages;
        mbar_wait_bounded(&full[st], (i / kStages) & 1);
        if (active) {
          const uint32_t base = hopper::smem_addr(ring + st * kStageBytes);
#pragma unroll
          for (int kp = 0; kp < kBK / 32; ++kp) {
            uint32_t xb[4];
            ldmatrix_x4(xb, xaddr + ((i - w0) * kBK + 32 * kp) * 2);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 32 * kp + 16 * h + lrow;
#pragma unroll
              for (int j = 0; j < kBoxes; ++j) {
                const int c = nw + 16 * j;
                const int chunk = ((c & 63) >> 3) + lhalf;
                uint32_t af[4];
                ldmatrix_x4_trans(af, base + (c >> 6) * kBoxBytes
                                      + row * 128
                                      + ((chunk ^ (row & 7)) << 4));
                mma_16816(acc[j], af, xb[2 * h], xb[2 * h + 1]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
      }
    }
    // the partial, [m][n] of the tile
#pragma unroll
    for (int j = 0; j < kBoxes; ++j) {
      const int n = nw + 16 * j + g;
      part[(2 * t) * kBN + n] = acc[j][0];
      part[(2 * t + 1) * kBN + n] = acc[j][1];
      part[(2 * t) * kBN + n + 8] = acc[j][2];
      part[(2 * t + 1) * kBN + n + 8] = acc[j][3];
    }
  }
  __syncwarp();                         // the barriers below are .aligned
  cluster_sync_acq_rel();
  merge_partials(part, kBN, n_rows, min(kBN, a.N - n0), a.y, a.N, rows,
                 n0);
  cluster_sync_relaxed();
}

__global__ void __launch_bounds__(kTcThreads)
tiered_mma_kernel(const __grid_constant__ CUtensorMap tm_w, TcArgs a) {
  tc_block<false>(&tm_w, a);
}

__global__ void __launch_bounds__(kTcThreads)
tiered_experts_mma_kernel(const __grid_constant__ CUtensorMap tm_w,
                          TcArgs a) {
  tc_block<true>(&tm_w, a);
}

// --------------------------------------- warpgroup MMA (bf16, large M)
constexpr int kWgRows = 128;            // rows of x a block: 2 warpgroups
constexpr int kWgThreads = 2 * 128 + 32;    // + the producer warp
constexpr int kXBoxBytes = kWgRows * 128;   // 64 k's of 128 rows of x
constexpr int kWgStageBytes = kXBoxBytes + kStageBytes;
constexpr int kWgLd = kBN + 8;          // the partial's row stride, floats
// A block's shared memory with a ring of `stages`: alignment, the ring
// (which holds the partial of a K split once the stream ends), the
// mbarriers.  3 stages with K splits (two blocks an SM), 4 without.
constexpr int wg_smem(int stages) {
  return 1024 + stages * kWgStageBytes + 2 * stages * 8;
}
static_assert(kWgRows * kWgLd * 4 <= 3 * kWgStageBytes,
              "the partial fits in the ring");

// The warpgroup kernel's K splits merged (n_split <= kSplit): each block
// holds a 128 x 128 fp32 partial (row stride kWgLd) at `part` in its
// shared memory; each output is the sum over the cluster's blocks in rank
// order, read through distributed shared memory four columns at a time,
// each block taking every n_split-th quad of the tile's first `rows` rows
// and `cols` columns (cols a multiple of 8: N is).  A thread keeps 8 of
// its loads in flight at once.  Called between the two cluster
// barriers.
template <int kSplit>
__device__ __forceinline__ void merge_quads(const float* part, int rows,
                                            int cols, __nv_bfloat16* y,
                                            long long ldy, int row0,
                                            int col0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  constexpr int kQuads = kBN / 4, kBatch = 8 / kSplit;
  const int total = rows * kQuads, stride = n_split * (int)blockDim.x;
  for (int q0 = (int)cluster.block_rank() * blockDim.x + threadIdx.x;
       q0 < total; q0 += kBatch * stride) {
    float4 v[kBatch][kSplit];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * stride, r = q / kQuads, c = 4 * (q % kQuads);
      const bool live = q < total && c < cols;
#pragma unroll
      for (int p = 0; p < kSplit; ++p)
        v[b][p] = live && p < n_split
                      ? *reinterpret_cast<const float4*>(
                            cluster.map_shared_rank(part + r * kWgLd + c, p))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b * stride, r = q / kQuads, c = 4 * (q % kQuads);
      if (q >= total || c >= cols) continue;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int p = 0; p < kSplit; ++p) {
        t.x += v[b][p].x; t.y += v[b][p].y; t.z += v[b][p].z;
        t.w += v[b][p].w;
      }
      *reinterpret_cast<uint2*>(y + (long long)(row0 + r) * ldy + col0 + c) =
          make_uint2(hopper::pack_bf16(t.x, t.y),
                     hopper::pack_bf16(t.z, t.w));
    }
  }
}

// A block of the warpgroup kernel: rows row0 .. row0 + 127 of x times
// columns col0 .. col0 + 127 of w over its K split.  Grid (tiles of kBN
// columns x n_split, ceil(M / 128)); clusters of the n_split K-split
// blocks of one tile, along x.  Warps 0-7 are two consumer warpgroups,
// warp 8 the producer.
template <int kWgStages>
__global__ void __launch_bounds__(kWgThreads, kWgStages == 3 ? 2 : 1)
tiered_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w, TcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;

  const int n_split = (int)cg::this_cluster().num_blocks();
  const int split = (int)cg::this_cluster().block_rank();
  const int col0 = (int)blockIdx.x / n_split * kBN;
  const int row0 = (int)blockIdx.y * kWgRows;
  const int m_rows = min(kWgRows, a.M - row0);
  const int tile0 = split * (a.k_chunk / kBK);    // the split's first stage
  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int steps = min(a.k_chunk / kBK, k_tiles - tile0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    hopper::mbar_fence_init();
  } else if (threadIdx.x == 256) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
  }
  __syncthreads();

  // a consumer's outputs: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the
  // tile, all 128 columns, 64 fp32 accumulators a thread: rows r and r + 8,
  // columns 8 j + c and + 1 (acc[4 j + 2 h], acc[4 j + 2 h + 1] for row
  // r + 8 h)
  const int wg = warp >> 2;
  const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c = 2 * (lane & 3);
  float acc[kBN / 2];
  if (warp == 8) {
    // ---- producer: a stage is x's 128 x 64 box (zeros past M and K; kept
    // in L2, every column tile reads it) and w's boxes (read once, evict
    // first; boxes wholly past N are not loaded: no column of them is
    // stored)
    if (lane == 0) {
      const uint64_t keep = hopper::policy_evict_last();
      const uint64_t once = hopper::policy_evict_first();
      const int boxes = min(kBoxes, (a.N - col0 + 63) / 64);
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kWgStages, k0 = (tile0 + s) * kBK;
        uint8_t* stage = ring + slot * kWgStageBytes;
        mbar_wait_bounded(&empty[slot], ((s / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[slot], kXBoxBytes + boxes * kBoxBytes);
        hopper::tma_load_2d(stage, &tm_x, &full[slot], k0, row0, keep);
        for (int b = 0; b < boxes; ++b)
          hopper::tma_load_2d(stage + kXBoxBytes + b * kBoxBytes, &tm_w,
                              &full[slot], col0 + 64 * b, k0, once);
      }
    }
  } else {
    // ---- consumers
#pragma unroll
    for (int v = 0; v < kBN / 2; ++v) acc[v] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % kWgStages;
      mbar_wait_bounded(&full[slot], (s / kWgStages) & 1);
      const uint32_t base = hopper::smem_addr(ring + slot * kWgStageBytes);
      // A: x's rows, K-major (k16 step = 32 bytes of a 128-byte row); B:
      // w's stage, MN-major, its leading offset stepping one 64-column box
      const uint32_t xa = base + wg * (64 * 128);
      const uint32_t wb = base + kXBoxBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hopper::wgmma_sst_n128(
            acc, hopper::gmma_desc(xa + kk * 32, 0, 1024),
            hopper::gmma_desc(wb + kk * 16 * 128, kBoxBytes, 1024), 1);
      hopper::wgmma_commit();
      // the previous stage's products have retired: release its slot
      hopper::wgmma_wait<1>();
      if (s > 0 && lane == 0)
        hopper::mbar_arrive(&empty[(s - 1) % kWgStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (n_split == 1) {
      // one split: the sums go straight to y, rows past M and columns past
      // N left out (N is a multiple of 8, so a pair lies inside or past it)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (r + 8 * h >= m_rows) continue;
        __nv_bfloat16* yr =
            a.y + (long long)(row0 + r + 8 * h) * a.N + col0 + c;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          if (col0 + 8 * j + c < a.N)
            *reinterpret_cast<uint32_t*>(yr + 8 * j) = hopper::pack_bf16(
                acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  if (n_split > 1) {                    // the same in every block of the
    if (warp < 8) {                     // cluster
      hopper::named_sync(1, 256);       // no product reads the ring now
      // the partial, [m][n] of the tile (row stride kWgLd), into the ring
      float* part = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        *reinterpret_cast<float2*>(part + r * kWgLd + 8 * j + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(part + (r + 8) * kWgLd + 8 * j + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    __syncwarp();                       // the barriers below are .aligned
    cluster_sync_acq_rel();
    const float* part = reinterpret_cast<const float*>(ring);
    const int cols = min(kBN, a.N - col0);
    if (n_split == 2)
      merge_quads<2>(part, m_rows, cols, a.y, a.N, row0, col0);
    else if (n_split <= 4)
      merge_quads<4>(part, m_rows, cols, a.y, a.N, row0, col0);
    else
      merge_quads<8>(part, m_rows, cols, a.y, a.N, row0, col0);
    cluster_sync_relaxed();
  }
}

// The tensor map of each weight, encoded at its first call: the map holds
// only the address, shape and strides, so the key says everything it
// encodes, and a weight freed and another placed at the same address with
// the same shape gets the same map.  Calls from Python threads may run at
// once (ctypes releases the GIL), so the cache is locked.
struct MapKey {
  const void* w; int N, K, E;           // E = 0: one (K, N) weight
  bool operator==(const MapKey& o) const {
    return w == o.w && N == o.N && K == o.K && E == o.E;
  }
};
struct MapHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.w) ^ ((size_t)k.N << 32)
           ^ ((size_t)k.K << 1) ^ ((size_t)k.E << 48);
  }
};

// A stack of E row-major (K, N) bf16 weights as a 3-D tensor map (N, K, E)
// with boxes of 64 columns x kBK rows x 1 expert, 128-byte swizzle, zeros
// past N and K.  N must be a multiple of 8 and w 16-byte aligned.
int experts_map(CUtensorMap* map, const void* w, int N, int K, int E) {
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(w), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// E = 0: a (K, N) weight's 2-D map; E > 0: an (E, K, N) stack's 3-D map.
int weight_map(const void* w, int N, int K, int E, CUtensorMap* out) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapHash> cache;
  const MapKey key{w, N, K, E};
  std::lock_guard<std::mutex> guard(lock);
  auto it = cache.find(key);
  if (it == cache.end()) {
    if (cache.size() >= 4096) cache.clear();
    CUtensorMap map;
    const int err = E == 0 ? hopper::matrix_map(&map, w, N, K, kBK)
                           : experts_map(&map, w, N, K, E);
    if (err != 0) return err;
    it = cache.emplace(key, map).first;
  }
  *out = it->second;
  return 0;
}

// grid_y: ceil(M / 8) blocks of rows, or the expert route's slots.
template <bool kExperts>
int launch_tc(const TcArgs& a, const CUtensorMap& map, int n_split,
              int grid_y, cudaStream_t stream) {
  void (*kernel)(const CUtensorMap, TcArgs) =
      kExperts ? tiered_experts_mma_kernel : tiered_mma_kernel;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN * n_split, grid_y, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = kTcSmem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The warpgroup kernel: w's map from the cache, x's encoded at every call
// (x is a fresh activation; see the header for what that costs); a ring of
// 4 stages when one split's tiles fit one block an SM, else of 3 (two
// blocks an SM: a cluster's blocks find room on fewer SMs, and a grid of
// up to twice the SMs runs in one wave).
template <int kStages>
int launch_wgmma_ring(const CUtensorMap& map_x, const CUtensorMap& map_w,
                      const TcArgs& a, int n_split, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiered_wgmma_kernel<kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem(kStages));
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN * n_split,
                     (a.M + kWgRows - 1) / kWgRows, 1);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = wg_smem(kStages);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, tiered_wgmma_kernel<kStages>, map_x, map_w, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int launch_wgmma(const void* w, const TcArgs& a, int n_split,
                 cudaStream_t stream) {
  CUtensorMap map_w, map_x;
  int err = weight_map(w, a.N, a.K, 0, &map_w);
  if (err == 0) err = hopper::matrix_map(&map_x, a.x, a.K, a.M, kWgRows);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)(a.N + kBN - 1) / kBN * ((a.M + kWgRows - 1) / kWgRows);
  return n_split == 1 && tiles <= sms
             ? launch_wgmma_ring<4>(map_x, map_w, a, 1, stream)
             : launch_wgmma_ring<3>(map_x, map_w, a, n_split, stream);
}

// ------------------------------------------------------------ FFMA route
constexpr int kTx = 32;                 // threads across columns
constexpr int kTy = 8;                  // threads across k
constexpr int kThreads = kTx * kTy;
constexpr int kVec = 8;                 // columns per thread
constexpr int kCols = kTx * kVec;       // 256 columns per block
constexpr int kRows = 4;                // rows of x per block
constexpr int kStage = 512;             // k's of x staged in shared memory
constexpr int kUnroll = 4;              // weight rows in flight per thread

// 8 consecutive elements of a weight row as floats.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x; o[2 * i + 1] = f.y;
  }
}

// One weight row's 8 columns from n0 on; `left` columns exist past n0.
template <typename T>
__device__ __forceinline__ void load_row(const T* p, bool full, int left,
                                         float* o) {
  if (full) {
    load8(p, o);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) o[c] = (c < left) ? to_f(p[c]) : 0.f;
  }
}

struct FfmaArgs {
  const void* x; const void* w; void* y;
  int M, N, K, k_chunk, vec;
  const int* expert; int E;             // the expert route: M rows' experts
};

// A block of the FFMA kernels.  Grid (ceil(N / 256), y, n_split); clusters
// of the n_split K-split blocks of one tile, along z.  Dense: y = ceil(M /
// 4), block y takes rows 4 y .. 4 y + 3.  Expert route: block y takes the
// rows and the expert of grid slot y (`expert_tile`, tiles of 4 rows), or
// exits.
template <typename T, bool kExperts>
__device__ __forceinline__ void ffma_block(const FfmaArgs& a) {
  __shared__ int row_of[kRows];
  int rows, ex = 0;
  if constexpr (kExperts) {
    __shared__ int counts[kMaxExperts], sel[2];
    rows = expert_tile(a.expert, a.M, a.E, (int)blockIdx.y, kRows, counts,
                       sel, row_of, &ex);
    if (rows == 0) return;              // the whole cluster: one slot
  } else {
    const int m0 = (int)blockIdx.y * kRows;
    rows = min(kRows, a.M - m0);
    if (threadIdx.x < kRows) row_of[threadIdx.x] = m0 + threadIdx.x;
    __syncthreads();
  }
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kCols + tx * kVec;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w) + (long long)ex * a.K * a.N;
  const bool full = a.vec && (n0 + kVec <= a.N);

  __shared__ float xs[kRows][kStage];
  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += kStage) {
    const int kn = min(kStage, k_end - ks);
    __syncthreads();                    // the previous stage is consumed
    for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
      const int r = i / kStage, kk = i % kStage;
      xs[r][kk] = (r < rows && kk < kn)
                      ? to_f(x[(long long)row_of[r] * a.K + ks + kk]) : 0.f;
    }
    __syncthreads();
    // kUnroll weight rows in flight per thread, then their products; each
    // thread still adds its k's in increasing order
    int kk = ty;
    for (; kk + (kUnroll - 1) * kTy < kn; kk += kUnroll * kTy) {
      float wv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_row(w + (long long)(ks + kk + u * kTy) * a.N + n0, full,
                 a.N - n0, wv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r][kk + u * kTy];
#pragma unroll
          for (int c = 0; c < kVec; ++c)
            acc[r][c] = fmaf(xv, wv[u][c], acc[r][c]);
        }
    }
    for (; kk < kn; kk += kTy) {
      float wv[kVec];
      load_row(w + (long long)(ks + kk) * a.N + n0, full, a.N - n0, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
  }

  // add the kTy thread-rows' sums in ty order: the block's partial
  __shared__ float red[kRows][kCols];
  for (int t = 0; t < kTy; ++t) {
    if (ty == t) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          float* slot = &red[r][tx * kVec + c];
          *slot = (t == 0) ? acc[r][c] : *slot + acc[r][c];
        }
    }
    __syncthreads();
  }
  cluster_sync_acq_rel();
  const int c0 = (int)blockIdx.x * kCols;
  merge_partials(&red[0][0], kCols, rows, min(kCols, a.N - c0),
                 static_cast<T*>(a.y), a.N, row_of, c0);
  cluster_sync_relaxed();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiered_ffma_kernel(FfmaArgs a) {
  ffma_block<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tiered_experts_ffma_kernel(FfmaArgs a) {
  ffma_block<T, true>(a);
}

// grid_y: ceil(M / 4) blocks of rows, or the expert route's slots.
template <typename T, bool kExperts>
int launch_ffma(const FfmaArgs& a, int n_split, int grid_y,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, grid_y, n_split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = n_split;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  void (*kernel)(FfmaArgs) = kExperts ? tiered_experts_ffma_kernel<T>
                                      : tiered_ffma_kernel<T>;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// y = x @ w.  x (M, K) and w (K, N) row-major and contiguous, y (M, N)
// contiguous; dtype 0 = float32, 1 = bfloat16.  route 1 (bf16 only, N a
// multiple of 8, w 16-byte aligned): the mma.sync kernel, K split in
// k_chunk rows, a multiple of 64; route 2 (the same, and K a multiple of 8
// and x 16-byte aligned): the warpgroup kernel, K split likewise; route 0:
// the FFMA kernel, k_chunk any multiple of 8.  1 <= n_split <= 8 blocks of
// k_chunk rows cover K, none empty.  vec: route 1, x rows can be read 16
// bytes at a time (K a multiple of 8, x 16-byte aligned); route 0, w rows
// can be read 8 elements at a time (N a multiple of 8, w 16-byte
// aligned); unused by route 2.  Returns a CUDA error code (0 on success).
extern "C" int tiered_matmul_launch(
    const void* x, const void* w, void* y, int M, int N, int K, int route,
    int n_split, int k_chunk, int vec, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || n_split < 1
      || n_split > kMaxSplit || (long long)(n_split - 1) * k_chunk >= K
      || (long long)n_split * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (dtype != 1 || N % 8 != 0 || K % 8 != 0 || k_chunk % kBK != 0
        || reinterpret_cast<uintptr_t>(w) % 16 != 0
        || reinterpret_cast<uintptr_t>(x) % 16 != 0
        || (M + kWgRows - 1) / kWgRows > 65535)
      return (int)cudaErrorInvalidValue;
    TcArgs a{static_cast<const __nv_bfloat16*>(x),
             static_cast<__nv_bfloat16*>(y), M, N, K, k_chunk, 1, nullptr, 0};
    return launch_wgmma(w, a, n_split, s);
  }
  if (route == 0) {
    FfmaArgs a{x, w, y, M, N, K, k_chunk, vec, nullptr, 0};
    const int grid_y = (M + kRows - 1) / kRows;
    if (dtype == 0) return launch_ffma<float, false>(a, n_split, grid_y, s);
    if (dtype == 1)
      return launch_ffma<__nv_bfloat16, false>(a, n_split, grid_y, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || dtype != 1 || N % 8 != 0 || k_chunk % kBK != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0
      || (M + kMRows - 1) / kMRows > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = weight_map(w, N, K, 0, &map);
  if (err != 0) return err;
  TcArgs a{static_cast<const __nv_bfloat16*>(x),
           static_cast<__nv_bfloat16*>(y), M, N, K, k_chunk, vec, nullptr, 0};
  return launch_tc<false>(a, map, n_split, (M + kMRows - 1) / kMRows, s);
}

// The expert route: y[r] = x[r] @ w[expert[r]] for r < R.  x (R, K), w (E,
// K, N) and y (R, N) row-major and contiguous, expert (R,) int32 on the
// device, each in [0, E) (else the kernel traps); 1 <= E <= 1024.  route,
// dtype, n_split, k_chunk and vec as for tiered_matmul_launch (route 1: N a
// multiple of 8, w 16-byte aligned, which makes every expert's weight
// 16-byte aligned).  The grid has min(R, R / tile + E) slots (tile: 8 rows
// on route 1, 4 on route 0), one for each (expert, tile) pair the rows can
// form.  Returns a CUDA error code (0 on success).
extern "C" int tiered_matmul_experts_launch(
    const void* x, const void* w, void* y, const void* expert, int R, int N,
    int K, int E, int route, int n_split, int k_chunk, int vec, int dtype,
    void* stream) {
  if (R < 1 || N < 1 || K < 1 || E < 1 || E > kMaxExperts || k_chunk < 1
      || n_split < 1 || n_split > kMaxSplit
      || (long long)(n_split - 1) * k_chunk >= K
      || (long long)n_split * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ex = static_cast<const int*>(expert);
  const int tile = route == 1 ? kMRows : kRows;
  const int slots = min(R, R / tile + E);
  if (slots > 65535) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    FfmaArgs a{x, w, y, R, N, K, k_chunk, vec, ex, E};
    if (dtype == 0) return launch_ffma<float, true>(a, n_split, slots, s);
    if (dtype == 1)
      return launch_ffma<__nv_bfloat16, true>(a, n_split, slots, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || dtype != 1 || N % 8 != 0 || k_chunk % kBK != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = weight_map(w, N, K, E, &map);
  if (err != 0) return err;
  TcArgs a{static_cast<const __nv_bfloat16*>(x),
           static_cast<__nv_bfloat16*>(y), R, N, K, k_chunk, vec, ex, E};
  return launch_tc<true>(a, map, n_split, slots, s);
}
