// Tensor-core helpers of the SSD-scan backward (csrc/ssd_scan_bwd.cu): fp32
// products on TF32 mma.sync, split three ways (3xTF32), fp64 products on
// DMMA, and the swizzle of its 64 x 64 fp32 tiles in shared memory.
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

}  // namespace ssd
