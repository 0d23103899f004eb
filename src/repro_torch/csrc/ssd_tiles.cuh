// Shapes and block-wide scans shared by the SSD-scan forward and backward
// kernels (csrc/ssd_scan.cu, csrc/ssd_scan_bwd.cu).
//
// Both run blocks of 256 threads over chunks of at most 256 positions,
// one position a thread in the scans of log a.  Their products run on the
// tensor cores, on 64 x 64 fp32 tiles in shared memory: fp32-accurate
// products on TF32 mma.sync (3xTF32) and fp64 sums on DMMA, with the tile
// helpers in csrc/ssd_mma.cuh.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows and columns of a tile
constexpr int kTile = kT * kT;  // floats in a tile
constexpr int kMaxQ = 256;      // longest chunk (one position per thread)
constexpr float kMinA = 1e-37f; // log(max(a, 1e-37)), as the reference

// Element strides of the (B, H, S) axes of a tensor; its last axis (N or
// P) has unit stride.  A stride may be 0 (k and q broadcast over H).
struct View {
  long long b, h, s;
};

// Inclusive prefix sum over the block: thread t holds element t.  `scratch`
// holds 8 values of T.  Every thread of the block must call it.  Both
// kernels scan log a in double.
template <typename T>
__device__ __forceinline__ T block_scan(T x, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kThreads / 32 ? scratch[lane] : T(0);
#pragma unroll
    for (int off = 1; off < kThreads / 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kThreads / 32) scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += scratch[warp - 1];
  __syncthreads();
  return x;
}

// Sum over the block, in a fixed order; every thread gets it.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  T total = T(0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// log(max(a_t, 1e-37)) in double for the `valid` positions of a chunk, 0
// past the end (the reference pads with a = 1).
__device__ __forceinline__ double log_decay(const float* a, long long stride,
                                            int t, int valid) {
  return t < valid ? log(fmax((double)a[t * stride], (double)kMinA)) : 0.0;
}

}  // namespace ssd
