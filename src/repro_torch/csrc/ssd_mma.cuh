// Tensor-core helpers of the SSD-scan kernels (csrc/ssd_scan.cu,
// csrc/ssd_scan_bwd.cu): fp32 products on TF32 mma.sync, split three ways
// (3xTF32), fp64 products on DMMA, the swizzle of their 64 x 64 fp32 tiles
// in shared memory, the tiles' cp.async copies, and the chunk sums both
// kernels form in fp64.
//
// mma.sync fragments of m16n8k8, TF32 or fp64, with g = lane / 4 and
// t = lane % 4: a rows g, g+8 at columns t, t+4; b rows t, t+4 at column g;
// c rows g, g+8 at columns 2t, 2t+1.  The depth order within a step is
// free, so the TF32 products put depth 2t in column (row) t of a (b) and
// depth 2t+1 in t+4: a thread then reads depths 2t and 2t+1, side by side.
// A warp reads a tile as 8 rows by 2 adjacent columns (8-byte reads) or as
// rows 2t (or 2t+1) by 8 columns; the swizzle serves both from distinct
// banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_tiles.cuh"

namespace ssd {

// Element (r, c) of a 64 x 64 fp32 tile sits at r * 64 + (c ^ swz(r)).  The
// XOR moves 8-float groups within a row by a function of r mod 8 that is
// one-to-one on rows 0-3, 4-7, the even rows and the odd rows.
__device__ __forceinline__ int swz(int r) {
  return (((r & 7) + ((r >> 2) & 1)) & 3) << 3;
}
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * 64 + (c ^ swz(r));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as its bits: cvt.rna.tf32.f32's result, in two integer operations (the
// cvt is a slow conversion instruction).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, hi rounded to TF32 and lo = x - hi exact; the tensor cores
// read lo's top 19 bits, so the two carry x to within 2^-21 |x| (kRound:
// lo rounded to TF32 too, to within 2^-22 |x|).
template <bool kRound>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = kRound ? to_tf32(r) : __float_as_uint(r);
}

// d += a b: one m16n8k8 product in TF32, fp32 accumulators (HMMA).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: one m16n8k8 product in fp64 (DMMA), fragments as the TF32
// shape's.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Rows [0, rows) and columns [0, cols) of a matrix with row stride
// `stride` into a swizzled tile by cp.async, zeros elsewhere: 16-byte
// copies where `wide` (address, strides and cols multiples of 16 bytes),
// else 4-byte ones.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long stride, int rows,
                                          int cols, bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = r < rows && c < cols;
      hopper::cp_async16(dst + tile_at(r, c), ok ? src + r * stride + c : src,
                         ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int r = i >> 6, c = i & 63;
      const bool ok = r < rows && c < cols;
      hopper::cp_async4(dst + tile_at(r, c), ok ? src + r * stride + c : src,
                        ok ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------- fp64 sums
// The rows of one chunk of a (B, H, S, .) matrix: its first row, the row
// stride, the valid columns (<= 64) and whether copy_tile may copy 16
// bytes at a time.
struct Rows64 {
  const float* p;
  long long stride;
  int cols;
  bool wide;
};

constexpr int kLdD = kT + 4;     // a row of the fp64 y tile, padded so that
                                 // the 8-byte reads miss no bank
// Shared memory of a sums kernel: the x and y tiles' two-stage ring, y
// widened to fp64, then the caller's e (kMaxQ doubles) and a scan's
// scratch (8 doubles).
constexpr int kSumsSmem = 4 * 4 * kTile + 8 * (kT * kLdD + kMaxQ + 8);

// Rows [64 T, 64 T + 64) of x and y (those below `valid`) into ring stage
// T % 2 of xt and yt, as one commit group.
__device__ __forceinline__ void issue_rows(float* xt, float* yt, Rows64 x,
                                           Rows64 y, int T, int valid) {
  const int rows = min(kT, valid - T * kT);
  copy_tile(xt + (T & 1) * kTile, x.p + T * kT * x.stride, x.stride, rows,
            x.cols, x.wide);
  copy_tile(yt + (T & 1) * kTile, y.p + T * kT * y.stride, y.stride, rows,
            y.cols, y.wide);
  hopper::cp_async_commit();
}

// out[n][p] = sum_{i < valid} e_i x_i[n] y_i[p] (at most 64 x 64) in fp64
// on DMMA m16n8k8, for one block; rows n < out_rows and columns p <
// out_cols of `out` (row stride ld) are written.  The caller issued rows 0
// (issue_rows(xt, yt, x, y, 0, valid)) and wrote e (shared memory, one
// double per row of the chunk) before the call; every thread calls it.
// Each y tile is widened to fp64 (yd) once for all warps.  Warp w forms
// rows 16 (w / 2).. and columns 32 (w % 2).. of out.
__device__ __forceinline__ void outer_sum_f64(float* xt, float* yt,
                                              double* yd, const double* e,
                                              Rows64 x, Rows64 y, int valid,
                                              double* out, int ld,
                                              int out_rows, int out_cols) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int nT = (valid + kT - 1) / kT;
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
  double u[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) u[nt][j] = 0.0;
  for (int T = 0; T < nT; ++T) {
    if (T + 1 < nT) issue_rows(xt, yt, x, y, T + 1, valid);
    else hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* x_ = xt + (T & 1) * kTile;
    const float* y_ = yt + (T & 1) * kTile;
    for (int i = tid; i < kTile; i += kThreads)
      yd[(i >> 6) * kLdD + (i & 63)] = (double)y_[tile_at(i >> 6, i & 63)];
    __syncthreads();
    const int rows = min(kT, valid - T * kT);
    if (m0 < out_rows) {
      for (int k = 0; k < rows; k += 8) {
        // A(n, i) = x_i[n] e_i, B(i, p) = y_i[p]
        double av[4], bv[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = k + t + 4 * (j >> 1);
          av[j] = (double)x_[tile_at(i, m0 + g + 8 * (j & 1))] * e[T * kT + i];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            bv[nt][j] = yd[(k + t + 4 * j) * kLdD + n0 + 8 * nt + g];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_f64(u[nt], av, bv[nt]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = m0 + g + 8 * (j >> 1), p = n0 + 8 * nt + 2 * t + (j & 1);
      if (n < out_rows && p < out_cols) out[n * ld + p] = u[nt][j];
    }
}

}  // namespace ssd
