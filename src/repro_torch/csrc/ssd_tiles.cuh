// Tiles and block-wide scans shared by the SSD-scan forward and backward
// kernels (csrc/ssd_scan.cu, csrc/ssd_scan_bwd.cu).
//
// Both kernels run on 256 threads and keep 64 x 64 fp32 tiles in shared
// memory (leading dimension 68 floats, so that the float4 row reads of a
// quarter warp fall in distinct banks).  Every product is FFMA in fp32: the
// reference's SSD tolerance (1e-4) rules out TF32.  Thread (ty, tx) =
// (tid / 16, tid % 16) owns the 4 x 4 outputs at rows ty*4 + i and columns
// tx + 16*j of a tile.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows and columns of a tile
constexpr int kLd = kT + 4;     // leading dimension in shared memory
constexpr int kMaxQ = 256;      // longest chunk (one position per thread)
constexpr float kMinA = 1e-37f; // log(max(a, 1e-37)), as the reference

// Element strides of the (B, H, S) axes of a tensor; its last axis (N or
// P) has unit stride.  A stride may be 0 (k and q broadcast over H).
struct View {
  long long b, h, s;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ int row_of(int i) { return (threadIdx.x >> 4) * 4 + i; }
__device__ __forceinline__ int col_of(int j) { return (threadIdx.x & 15) + 16 * j; }

// acc[i][j] += sum_k A[row_i][k] * B[col_j][k]   (K a multiple of 4)
__device__ __forceinline__ void mm_nt(float acc[4][4], const float* A,
                                      const float* B, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + row_of(i) * kLd + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + col_of(j) * kLd + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        acc[i][j] = fmaf(a[i].w, b[j].w, s);
      }
  }
}

// acc[i][j] += sum_k A[row_i][k] * B[k][col_j]   (K a multiple of 4)
__device__ __forceinline__ void mm_nn(float acc[4][4], const float* A,
                                      const float* B, int K) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + row_of(i) * kLd + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[(k + kk) * kLd + col_of(j)];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_{k<K} A[k][row_i] * B[k][col_j]
__device__ __forceinline__ void mm_tn(float acc[4][4], const float* A,
                                      const float* B, int K) {
  const int r0 = (threadIdx.x >> 4) * 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = ld4(A + k * kLd + r0);
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * kLd + col_of(j)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0][j] = fmaf(a.x, b[j], acc[0][j]);
      acc[1][j] = fmaf(a.y, b[j], acc[1][j]);
      acc[2][j] = fmaf(a.z, b[j], acc[2][j]);
      acc[3][j] = fmaf(a.w, b[j], acc[3][j]);
    }
  }
}

// acc[i][j] += sum_{k<K} A[k][row_i] * B[k][col_j] * scale[k], in double
// (the SSD backward's dS carry, csrc/ssd_scan_bwd.cu)
__device__ __forceinline__ void mm_tn_scaled_d(double acc[4][4],
                                               const float* A,
                                               const float* B,
                                               const float* scale, int K) {
  const int r0 = (threadIdx.x >> 4) * 4;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 a = ld4(A + k * kLd + r0);
    const double sk = scale[k];
    double b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * kLd + col_of(j)] * sk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0][j] = fma((double)a.x, b[j], acc[0][j]);
      acc[1][j] = fma((double)a.y, b[j], acc[1][j]);
      acc[2][j] = fma((double)a.z, b[j], acc[2][j]);
      acc[3][j] = fma((double)a.w, b[j], acc[3][j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero(T acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
}

// dst[r][c] = src[r * row_stride + c] for r < rows_valid and c < cols_valid,
// 0 elsewhere, for the `rows` rows (a multiple of 64) and 64 columns of dst.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int rows_valid, int cols_valid) {
  for (int idx = threadIdx.x; idx < rows * kT; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    dst[r * kLd + c] = (r < rows_valid && c < cols_valid)
                       ? src[r * row_stride + c] : 0.f;
  }
}

// Inclusive prefix sum over the block: thread t holds element t.  `scratch`
// holds 8 values of T.  Every thread of the block must call it.  The SSD
// backward scans log a and d(log a) in double (see csrc/ssd_scan_bwd.cu).
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

// Sum over the 16 lanes that share a tile row (lanes 0-15 or 16-31).
template <typename T>
__device__ __forceinline__ T sum16(T x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// log(max(a, 1e-37)) of position t of a chunk of `valid` positions, 0 past
// the end (the reference pads with a = 1).
__device__ __forceinline__ float log_decay(const float* a, long long stride,
                                           int t, int valid) {
  return t < valid ? logf(fmaxf(a[t * stride], kMinA)) : 0.f;
}

}  // namespace ssd
