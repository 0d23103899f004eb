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
// table item i - 1 wrote, so the n items run one after another; a step is
// qcap + 1 adds and compares, ~16k at the planner's grid, a few hundred
// nanoseconds of one SM's shared-memory bandwidth.  The bytes (the keep
// table written once, n * (qcap + 8) / 8) and the fp64 adds over the whole
// card take a few microseconds, so the kernel sits far above its bound:
// it is latency, one block, a barrier or two an item.
//
// What the design does about it:
// * One launch a solve, one block of 1,024 threads: the recurrence never
//   leaves the SM, and no launch or grid barrier separates two items.
// * Route 1 (qcap + 1 <= 17,408 cells, the planner's default grid of
//   16,384 among them): the table lives in dynamic shared memory (136 KB
//   at most).  A thread owns the columns j * 1024 + tid, so a warp's
//   ballot covers 32 consecutive columns, which are 4 packed bytes that
//   lanes 0-3 store.  An item reads every old value it needs into
//   registers (the candidates of its <= 17 columns), then a barrier, then
//   it writes back the columns that took the item, then a barrier: with
//   s_i = 0 a column's candidate is its own old value plus v_i, and with
//   s_i > 0 another warp's, so every old value is read before any is
//   written.  The next item's size and value are loaded while this one
//   runs.
// * Route 2 (larger grids, from a caller's larger max_cells): the table
//   lives in global memory as two ping-pong buffers (the caller's `work`,
//   2 * (qcap + 1) doubles), read through L2 (ld.global.cg), still one
//   block and one launch; item i reads one buffer and writes the other, so
//   one barrier an item orders them.  Both routes give the same bits.
// * Spreading the table over a cluster of SMs (DSMEM) to cut the per-item
//   step is left for later (ROADMAP.md, queue 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;                 // one block a solve
constexpr int kCols = 17;                      // route 1: columns a thread
constexpr int kRoute1Cells = kThreads * kCols;  // 17,408 >= 16,385

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

// The row of an item that takes no column.
__device__ __forceinline__ void zero_row(uint8_t* row, int row_bytes) {
  for (int b = threadIdx.x; b < row_bytes; b += kThreads) row[b] = 0;
}

__global__ void __launch_bounds__(kThreads, 1)
knapsack_smem_kernel(const double* __restrict__ values,
                     const int64_t* __restrict__ qsizes, int n, int qcap,
                     uint8_t* __restrict__ keep) {
  extern __shared__ double table[];            // qcap + 1 cells
  const int tid = threadIdx.x;
  const int warp_c = tid & ~31;                // the warp's first column
  const int cells = qcap + 1;
  const int row_bytes = (qcap + 8) / 8;
  for (int c = tid; c < cells; c += kThreads) table[c] = 0.0;
  __syncthreads();
  int64_t s_next = n > 0 ? qsizes[0] : 0;
  double v_next = n > 0 ? values[0] : 0.0;
  for (int i = 0; i < n; ++i) {
    const int64_t s64 = s_next;
    const double v = v_next;
    if (i + 1 < n) {
      s_next = qsizes[i + 1];
      v_next = values[i + 1];
    }
    uint8_t* row = keep + (size_t)i * row_bytes;
    if (past_capacity(s64, qcap)) {
      zero_row(row, row_bytes);
      continue;
    }
    const int s = (int)s64;
    double cand[kCols];
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j * kThreads + warp_c < cells) {     // uniform over the warp
        const int c = j * kThreads + tid;
        bool better = false;
        if (c < cells && c >= s) {
          cand[j] = table[c - s] + v;
          better = take(cand[j], table[c]);
        }
        bits |= (uint32_t)better << j;
        store_bits(row, j * kThreads + warp_c, row_bytes,
                   __ballot_sync(0xffffffffu, better));
      }
    }
    __syncthreads();  // every old value read before any is written
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if ((bits >> j) & 1u) table[j * kThreads + tid] = cand[j];
    __syncthreads();
  }
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

// Route 1 keeps the table in shared memory and takes qcap + 1 <= 17,408
// cells; route 2 keeps it in global memory and takes any grid (the
// wrapper picks, kernels/knapsack_dp.py `pick_route`).  Doubles of the
// `work` buffer the route needs: 0 for route 1, the two
// ping-pong tables for route 2.
extern "C" long long knapsack_dp_work(int qcap, int route) {
  return route == 2 ? 2LL * ((long long)qcap + 1) : 0;
}

// keep (n, (qcap + 8) / 8) uint8, row-major, from values (n,) float64 and
// qsizes (n,) int64, all contiguous on the device; work as
// knapsack_dp_work says (null for route 1).  One launch on `stream`.
// Returns a CUDA error code (0 on success); refuses route 1 past its
// cells and route 2 without work.
extern "C" int knapsack_dp_launch(const void* values, const void* qsizes,
                                  int n, int qcap, void* keep, void* work,
                                  int route, void* stream) {
  if (n < 0 || qcap < 0 || qcap > 0x7fff0000)   // c0 + 1024 stays an int
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(values);
  const int64_t* s = static_cast<const int64_t*>(qsizes);
  uint8_t* k = static_cast<uint8_t*>(keep);
  if (route == 1) {
    if (qcap + 1 > kRoute1Cells) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        knapsack_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRoute1Cells * (int)sizeof(double));
    if (attr != cudaSuccess) return (int)attr;
    knapsack_smem_kernel<<<1, kThreads, (size_t)(qcap + 1) * sizeof(double),
                           st>>>(v, s, n, qcap, k);
  } else if (route == 2) {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    knapsack_global_kernel<<<1, kThreads, 0, st>>>(
        v, s, n, qcap, k, static_cast<double*>(work));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
