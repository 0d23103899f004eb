// The 0/1 knapsack DP's table recurrence (paper §3.1.3), for sm_90a.
//
// Replaces no Pallas kernel: its counterpart in the reference package is
// src/repro/core/knapsack.py `_jax_dp`, the whole recurrence as one jitted
// `lax.scan` in float64, switched on by `use_jax` above a work threshold.
// For each item i in order, with the table starting at 0.0 everywhere:
//
//   cand[c]   = table[c - s_i] + v_i            (c >= s_i)
//   better[c] = cand[c] > table[c]              (strict: ties keep the old
//                                                value, as both reference
//                                                DPs do)
//   table[c]  = better[c] ? cand[c] : table[c]
//
// and row i of `keep` is `better`, packed as np.packbits packs it: column c
// is bit 7 - (c & 7) of byte c >> 3, the pad bits of the last byte 0.  An
// item with s_i > qcap (or below 0) leaves the table as it is and its row
// all 0, as the numpy DP's `continue` and the scan's clamped slice do.  The
// additions and comparisons are the reference's IEEE float64 ones (no
// multiply, so nothing contracts into an FMA): the keep table is the same
// bits as the numpy and the jitted DPs', and the host's backtrack
// (core/knapsack.py) selects the same items.
//
// What bounds it on this card: the chain of items.  Item i reads the whole
// table item i - 1 wrote, so the n items run one after another and the
// least an item can cost is one synchronisation of whatever holds the
// table.  The bytes (the keep table written once, n * (qcap + 8) / 8) and
// the fp64 adds over the whole card take about a microsecond a solve, so
// the kernel sits far above that bound; what it can approach is the
// chain's own floor, one cross-SM handshake an item (knapsack_chain_kernel
// times it).
//
// What the design does about it (one launch a solve; no launch or grid
// barrier separates two items):
// * Route 1 (qcap + 1 <= 231,936 cells; the planner's grid of 16,385
//   among them): the table is spread over a cluster of R <= 16 blocks,
//   one an SM.  Rank r owns the columns [r W, (r + 1) W), W a multiple of
//   32 (the last rank may be short or empty); each column thread owns
//   `kCols` of them, column j T + tid of its rank, and keeps their current
//   values in registers.  Each rank holds two ping-pong buffers of its
//   columns in shared memory: item i reads one and writes the other, so
//   one handshake an item orders both the reads after the writes they need
//   and the next writes after the reads of the same buffer.  A thread
//   reads old[c - s] from its own block where c - s lies in its range,
//   else from rank floor((c - s) / W) through DSMEM (ld.shared::cluster):
//   at most two ranks for any s, one for s < W.  The candidate is compared
//   with the register (s = 0 reads its own column's old value from the
//   buffer, never the register).
// * The handshake is two mbarriers a block, one arrival a rank.  An item
//   ends on a block with __syncthreads, then its last warp (which owns no
//   column and stores no keep byte, so its release waits on no global
//   store) arrives on the item's mbarrier of every rank; the next item
//   starts once the block's own mbarrier completes.  The keep bytes are
//   packed and stored between the two.  The handshake costs less than a
//   barrier.cluster an item (knapsack_chain_kernel times both); the last
//   wait keeps every block alive until no rank can read its buffers or
//   arrive on its mbarriers (without it the launch fails).  A warp's
//   ballot over 32 consecutive columns of its rank is 4 whole bytes of the
//   row (rank starts are multiples of 32).  Items' sizes (as divmod(s,
//   W), off the chain) and values are read 32 at a time, one a lane, a
//   window ahead, and broadcast by shuffles.  The wrapper
//   (kernels/knapsack_dp.py `cluster_plan`) picks R by the grid's size and
//   mirrors `layout` below.
// * Route 2 (larger grids, from a caller's larger max_cells): the table
//   lives in global memory as two ping-pong buffers (the caller's `work`,
//   2 * (qcap + 1) doubles), read through L2 (ld.global.cg), one block of
//   1,024 threads and one launch; item i reads one buffer and writes the
//   other, so one barrier an item orders them.  Both routes give the same
//   bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;                 // route 2: one block a solve
constexpr int kMaxRanks = 16;                  // route 1: blocks a cluster
constexpr int kMaxRankThreads = 1024;          // route 1: threads a rank,
constexpr int kMaxWorkers = kMaxRankThreads - 32;  // its last warp the sync
constexpr int kMaxSmem = 232448;               // shared memory a block
constexpr int kBarBytes = 16;                  // route 1: two mbarriers
// a rank's columns at most: two buffers of doubles beside the mbarriers
constexpr int kMaxWidth =
    (kMaxSmem - kBarBytes) / (2 * (int)sizeof(double)) / 32 * 32;
constexpr int kMaxCols = (kMaxWidth + kMaxWorkers - 1) / kMaxWorkers;

// Route 1's layout of qcap + 1 cells over `ranks` blocks: rank r owns the
// columns [r * width, (r + 1) * width), width a multiple of 32; a block
// has `threads` threads, the first threads - 32 (a multiple of 32) owning
// `cols` columns each (j * (threads - 32) + tid of its rank, j < cols),
// the last warp only synchronising.  As kernels/knapsack_dp.py
// `cluster_plan`.
struct Layout {
  int ranks, width, threads, cols, smem;
};

// false where `ranks` is out of 1..16 or a rank's two buffers pass kMaxSmem
bool layout(int qcap, int ranks, Layout* l) {
  if (qcap < 0 || ranks < 1 || ranks > kMaxRanks) return false;
  const long long cells = (long long)qcap + 1;
  const long long width = ((cells + ranks - 1) / ranks + 31) / 32 * 32;
  if (width > kMaxWidth) return false;
  l->ranks = ranks;
  l->width = (int)width;
  l->cols = (l->width + kMaxWorkers - 1) / kMaxWorkers;
  l->threads = ((l->width + l->cols - 1) / l->cols + 31) / 32 * 32 + 32;
  l->smem = kBarBytes + 2 * l->width * (int)sizeof(double);
  return true;
}

// The DP's choice: strict, so a tie keeps the table's old value.
__device__ __forceinline__ bool take(double cand, double old) {
  return cand > old;
}

// A warp's ballot (bit l: column c0 + l) as the 4 bytes of columns c0 ..
// c0 + 31 in memory order, each in np.packbits' order: column c0 + 8 b + k
// at bit 7 - k of byte b.
__device__ __forceinline__ uint32_t pack_bits(uint32_t mask) {
  return __byte_perm(__brev(mask), 0, 0x0123);
}

// An item that fits no column: s > qcap, or s < 0 (read as unsigned).
// Past this test a size is narrowed to int.
__device__ __forceinline__ bool past_capacity(int64_t s, int qcap) {
  return (uint64_t)s > (uint64_t)qcap;
}

// Lanes 0-3 store the 4 bytes of the warp's 32 columns from c0 (a multiple
// of 32) into `row`, those below `row_bytes`.
__device__ __forceinline__ void store_bits(uint8_t* row, int c0,
                                           int row_bytes, uint32_t mask) {
  const int lane = threadIdx.x & 31;
  const int b = (c0 >> 3) + lane;
  if (lane < 4 && b < row_bytes)
    row[b] = (uint8_t)(pack_bits(mask) >> (8 * lane));
}

// The row of an item that takes no column (route 2: the whole row).
__device__ __forceinline__ void zero_row(uint8_t* row, int row_bytes) {
  for (int b = threadIdx.x; b < row_bytes; b += kThreads) row[b] = 0;
}

// ------------------------------------------------- route 1: the cluster
// The whole cluster's barrier, once a launch: every block running, and
// what each wrote before it visible to all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The items' synchronisation: two mbarriers a block (shared address
// `bars`, 8 bytes apart), each expecting one arrival a rank.  Item k ends
// on a block with its reads and writes done (__syncthreads) and one
// arrival on mbarrier k & 1 of every rank, released to the cluster; a
// block starts item k + 1 once its own mbarrier k & 1 has completed phase
// k >> 1, which acquires every rank's item k.  Arrivals for item k + 2
// cannot come before that phase completes (they follow every rank's wait
// on item k + 1, which follows this block's wait on item k), so two
// mbarriers keep the phases apart.
__device__ __forceinline__ void bars_init(uint32_t bars, int ranks) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "mbarrier.init.shared::cta.b64 [%2], %1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(bars), "r"(ranks), "r"(bars + 8u) : "memory");
}
// The arrivals come from the block's last warp, lane r to rank r: a
// warp that stores no keep bytes, so that its release waits on no global
// store.
__device__ __forceinline__ void item_done(uint32_t bars, int k, int ranks) {
  __syncthreads();
  const int to = (int)threadIdx.x - (int)(blockDim.x - 32);
  if (to >= 0 && to < ranks)
    asm volatile("{\n.reg .b32 r;\n"
                 "mapa.shared::cluster.u32 r, %0, %1;\n"
                 "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [r];"
                 "\n}\n"
                 :: "r"(bars + 8u * (k & 1)), "r"(to) : "memory");
}
__device__ __forceinline__ bool item_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred P;\n"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P, "
               "[%1], %2;\n"
               "selp.b32 %0, 1, 0, P;\n}\n"
               : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// Wait until every rank has ended item k; a phase that has not completed
// after ~4 s traps (a launch failure rather than a hung card).
__device__ __forceinline__ void item_wait(uint32_t bars, int k) {
  const uint32_t bar = bars + 8u * (k & 1), parity = (k >> 1) & 1;
  if (item_test(bar, parity)) return;
  const long long t0 = clock64();
  while (!item_test(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// The double at shared address `addr` of this block's layout, read from
// the block of rank `rank` (DSMEM).
__device__ __forceinline__ double load_rank(uint32_t addr, int rank) {
  uint32_t remote;
  double x;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(x) : "r"(remote));
  return x;
}

// An item's size s as (d, rem) = divmod(s, width): c - s lies d or d + 1
// ranks below column c; d = -1 for an item past the capacity.
__device__ __forceinline__ void split(int64_t s, int qcap, int width, int* d,
                                      int* rem) {
  if (past_capacity(s, qcap)) {
    *d = -1;
    *rem = 0;
  } else {
    *d = (int)s / width;
    *rem = (int)s - *d * width;
  }
}

// One item over this thread's columns (j * T + tid of its rank, T the
// column threads; the first `own` of the rank's `width` real): column c >=
// s takes old[c - s] + v where that is larger than its value (the
// register), and every column's value goes into the other buffer `nxt`.
// `old` is this block's buffer being read (shared address old_addr); c - s
// lies d = s / width or d + 1 ranks below c's (rem = s % width).  Returns
// the columns that took the item, bit j for column j.
template <int kCols>
__device__ __forceinline__ uint32_t relax(double (&reg)[kCols],
                                          const double* old,
                                          uint32_t old_addr, double* nxt,
                                          int T, int rank, int width, int own,
                                          int d, int rem, double v) {
  // reads in flight at once: one where the registers hold many columns
  // (two spilled at 64 registers a thread, H100)
  constexpr int kGroup = kCols <= 8 ? kCols : 1;
  uint32_t bits = 0;
#pragma unroll
  for (int g = 0; g < kCols; g += kGroup) {
    double x[kGroup];
    bool has[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int col = (g + k) * T + threadIdx.x;
      int src = rank - d, off = col - rem;     // c - s = src * width + off
      if (off < 0) {
        --src;
        off += width;
      }
      has[k] = g + k < kCols && col < own && src >= 0;
      x[k] = 0.0;
      if (has[k])
        x[k] = src == rank ? old[off]
                           : load_rank(old_addr + 8u * (uint32_t)off, src);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int j = g + k;
      if (j < kCols) {
        const int col = j * T + threadIdx.x;
        const double cand = x[k] + v;
        const bool better = has[k] && take(cand, reg[j]);
        if (better) reg[j] = cand;
        if (col < width) nxt[col] = reg[j];
        bits |= (uint32_t)better << j;
      }
    }
  }
  return bits;
}

// Grid (ranks), one cluster of `ranks` blocks of `threads` (layout), each
// with the two mbarriers and two buffers of `width` doubles in dynamic
// shared memory; the last warp of each block owns no column.
template <int kCols>
__global__ void __launch_bounds__(kMaxRankThreads, 1)
knapsack_cluster_kernel(const double* __restrict__ values,
                        const int64_t* __restrict__ qsizes, int n, int qcap,
                        int width, uint8_t* __restrict__ keep) {
  extern __shared__ uint64_t smem[];
  double* buf = reinterpret_cast<double*>(smem + 2);   // 2 x width cells
  const int T = blockDim.x - 32;               // the column threads
  const int R = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp_c = tid & ~31;                // the warp's first column
  const int rank = cluster_rank();
  const int start = rank * width;              // the rank's first column
  const int cells = qcap + 1;
  // the rank's real columns: the last rank's may be fewer, or none
  const int own = max(0, min(width, cells - start));
  const int row_bytes = (qcap + 8) / 8;
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t base = bars + kBarBytes;      // buf's shared address
  double reg[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) reg[j] = 0.0;
  if (tid == 0) bars_init(bars, R);
  for (int c = tid; c < width; c += blockDim.x) buf[c] = 0.0;  // buffer 0
  cluster_sync();              // mbarriers set, buffer 0 zero, everywhere
  // items a window of 32 at a time, lane l holding item 32 w + l: its
  // size as (d, rem) = divmod(s, width) (d -1 past the capacity) and its
  // value; the next window's sizes and values in flight meanwhile
  int d_win = -1, rem_win = 0;
  double v_win = 0.0, v_ahead = 0.0;
  int64_t s_ahead = 0;
  if (lane < n) {
    split(qsizes[lane], qcap, width, &d_win, &rem_win);
    v_win = values[lane];
  }
  if (32 + lane < n) {
    s_ahead = qsizes[32 + lane];
    v_ahead = values[32 + lane];
  }
  int p = 0;                        // the buffer the next item reads
  int k = 0;                        // items taken (within the capacity)
  for (int i = 0; i < n; ++i) {
    if (i > 0 && (i & 31) == 0) {
      split(s_ahead, qcap, width, &d_win, &rem_win);
      v_win = v_ahead;
      if (i + 32 + lane < n) {
        s_ahead = qsizes[i + 32 + lane];
        v_ahead = values[i + 32 + lane];
      }
    }
    const int d = __shfl_sync(0xffffffffu, d_win, i & 31);
    const int rem = __shfl_sync(0xffffffffu, rem_win, i & 31);
    const double v = __shfl_sync(0xffffffffu, v_win, i & 31);
    uint32_t bits = 0;           // an item past the capacity: a row of 0,
    if (d >= 0) {                // no barrier, no buffer flipped
      if (k > 0) item_wait(bars, k - 1);  // the last item ended everywhere
      if (tid < T)
        bits = relax<kCols>(reg, buf + p * width, base + 8u * p * width,
                            buf + (p ^ 1) * width, T, rank, width, own, d,
                            rem, v);
      item_done(bars, k, R);
      p ^= 1;
      ++k;
    }
    uint8_t* row = keep + (size_t)i * row_bytes;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (tid < T && j * T + warp_c < width)   // uniform over the warp
        store_bits(row, start + j * T + warp_c, row_bytes,
                   __ballot_sync(0xffffffffu, (bits >> j) & 1u));
  }
  // no block leaves while another can read its buffers or arrive on its
  // mbarriers
  if (k > 0) item_wait(bars, k - 1);
}

// The chain's floor: route 1's item loop with no table work, the
// synchronisation of n items as the DP does it, or (cluster_barrier) as n
// barrier.cluster would.  A check's aid.
__global__ void __launch_bounds__(kMaxRankThreads, 1)
knapsack_chain_kernel(int n, int cluster_barrier) {
  extern __shared__ uint64_t smem[];
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) bars_init(bars, gridDim.x);
  cluster_sync();
  if (cluster_barrier) {
    for (int k = 0; k < n; ++k) cluster_sync();
    return;
  }
  for (int k = 0; k < n; ++k) {
    if (k > 0) item_wait(bars, k - 1);
    item_done(bars, k, gridDim.x);
  }
  if (n > 0) item_wait(bars, n - 1);
}

__global__ void __launch_bounds__(kThreads, 1)
knapsack_global_kernel(const double* __restrict__ values,
                       const int64_t* __restrict__ qsizes, int n, int qcap,
                       uint8_t* __restrict__ keep, double* work) {
  const int tid = threadIdx.x;
  const int warp_c = tid & ~31;
  const int cells = qcap + 1;
  const int row_bytes = (qcap + 8) / 8;
  double* cur = work;
  double* nxt = work + cells;
  for (int c = tid; c < cells; c += kThreads) __stcg(cur + c, 0.0);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int64_t s64 = qsizes[i];
    const double v = values[i];
    uint8_t* row = keep + (size_t)i * row_bytes;
    if (past_capacity(s64, qcap)) {
      zero_row(row, row_bytes);
      continue;
    }
    const int s = (int)s64;
    for (int c0 = warp_c; c0 < cells; c0 += kThreads) {
      const int c = c0 + (tid & 31);
      bool better = false;
      if (c < cells) {
        const double old = __ldcg(cur + c);
        double val = old;
        if (c >= s) {
          const double cand = __ldcg(cur + c - s) + v;
          better = take(cand, old);
          if (better) val = cand;
        }
        __stcg(nxt + c, val);
      }
      store_bits(row, c0, row_bytes, __ballot_sync(0xffffffffu, better));
    }
    __syncthreads();  // the new table whole before the next item reads it
    double* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

namespace {

// Dynamic shared memory past 48 KB and clusters past 8 blocks, once a
// kernel.
cudaError_t allow_cluster(const void* fn) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Launches `fn` over the cluster of `l` on `st`, after checking once (a
// kernel, a cluster size, the largest shared memory so far) that the card
// can place the cluster: a refusal is cudaErrorLaunchOutOfResources.
template <typename... P, typename... A>
int launch_cluster(void (*fn)(P...), int* placed, const Layout& l,
                   cudaStream_t st, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.ranks, 1, 1);
  cfg.blockDim = dim3(l.threads, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = l.ranks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (l.smem > placed[l.ranks]) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    placed[l.ranks] = l.smem;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int kCols>
int launch_route1(const Layout& l, const double* v, const int64_t* s, int n,
                  int qcap, uint8_t* k, cudaStream_t st) {
  if constexpr (kCols > kMaxCols) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (l.cols != kCols)
      return launch_route1<kCols + 1>(l, v, s, n, qcap, k, st);
    static const cudaError_t attr =
        allow_cluster((const void*)knapsack_cluster_kernel<kCols>);
    if (attr != cudaSuccess) return (int)attr;
    static int placed[kMaxRanks + 1] = {};
    return launch_cluster(knapsack_cluster_kernel<kCols>, placed, l, st, v,
                          s, n, qcap, l.width, k);
  }
}

}  // namespace

// Route 1's layout of qcap + 1 cells over `ranks` blocks into out[0..3]:
// width, threads, cols and shared-memory bytes a block.  Returns 0, or
// cudaErrorInvalidValue where ranks is out of 1..16 or the buffers do not
// fit a block.
extern "C" int knapsack_dp_layout(int qcap, int ranks, int* out) {
  Layout l;
  if (!layout(qcap, ranks, &l)) return (int)cudaErrorInvalidValue;
  out[0] = l.width;
  out[1] = l.threads;
  out[2] = l.cols;
  out[3] = l.smem;
  return 0;
}

// Route 1 keeps the table in the shared memory of a cluster and takes
// qcap + 1 <= 232,448 cells; route 2 keeps it in global memory and takes
// any grid (the wrapper picks, kernels/knapsack_dp.py `pick_route`).
// Doubles of the `work` buffer the route needs: 0 for route 1, the two
// ping-pong tables for route 2.
extern "C" long long knapsack_dp_work(int qcap, int route) {
  return route == 2 ? 2LL * ((long long)qcap + 1) : 0;
}

// keep (n, (qcap + 8) / 8) uint8, row-major, from values (n,) float64 and
// qsizes (n,) int64, all contiguous on the device; work as
// knapsack_dp_work says (null for route 1); `ranks` the blocks of route
// 1's cluster (1..16; ignored by route 2).  One launch on `stream`.
// Returns a CUDA error code (0 on success); refuses route 1 past its cells
// and route 2 without work.
extern "C" int knapsack_dp_launch(const void* values, const void* qsizes,
                                  int n, int qcap, void* keep, void* work,
                                  int route, int ranks, void* stream) {
  if (n < 0 || qcap < 0 || qcap > 0x7fff0000)   // c0 + 1024 stays an int
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  const int64_t* s = static_cast<const int64_t*>(qsizes);
  uint8_t* k = static_cast<uint8_t*>(keep);
  if (route == 1) {
    Layout l;
    if (!layout(qcap, ranks, &l)) return (int)cudaErrorInvalidValue;
    return launch_route1<1>(l, v, s, n, qcap, k, st);
  }
  if (route != 2 || work == nullptr) return (int)cudaErrorInvalidValue;
  knapsack_global_kernel<<<1, kThreads, 0, st>>>(
      v, s, n, qcap, k, static_cast<double*>(work));
  return (int)cudaGetLastError();
}

// Route 1's chain floor (knapsack_chain_kernel): n items' handshakes, or n
// barrier.cluster (cluster_barrier 1), over the cluster route 1 takes for
// qcap at `ranks`.  One launch on `stream`; a CUDA error code.
extern "C" int knapsack_dp_chain_launch(int n, int qcap, int ranks,
                                        int cluster_barrier, void* stream) {
  Layout l;
  if (n < 0 || !layout(qcap, ranks, &l)) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      allow_cluster((const void*)knapsack_chain_kernel);
  if (attr != cudaSuccess) return (int)attr;
  static int placed[kMaxRanks + 1] = {};
  return launch_cluster(knapsack_chain_kernel, placed, l,
                        static_cast<cudaStream_t>(stream), n,
                        cluster_barrier);
}
