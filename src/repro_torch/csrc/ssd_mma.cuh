// Tensor-core helpers of the SSD-scan kernels (csrc/ssd_scan.cu,
// csrc/ssd_scan_bwd.cu): fp32 products on TF32 mma.sync, split three ways
// (3xTF32), fp64 products on DMMA, the swizzle of their 64 x 64 fp32 tiles
// in shared memory, the tiles' cp.async copies, a warp's block of a
// product of two tiles (the backward's chunk kernel and both wide routes),
// and the chunk sums both kernels form in fp64.
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
// copies where `wide` (address, strides and cols multiples of 16 bytes;
// kRagged: cols any, a ragged last group of columns copying only its valid
// bytes and zero-filling the rest), else 4-byte ones.
template <bool kRagged = false>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          long long stride, int rows,
                                          int cols, bool wide) {
  if (wide) {
    for (int i = threadIdx.x; i < kTile / 4; i += kThreads) {
      const int r = i >> 4, c = (i & 15) * 4;
      const bool ok = r < rows && c < cols;
      hopper::cp_async16(dst + tile_at(r, c), ok ? src + r * stride + c : src,
                         !ok ? 0 : kRagged ? 4 * min(4, cols - c) : 16);
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

constexpr int kLdD = kT + 4;     // a row of an fp64 tile, padded so that
                                 // the 8-byte reads miss no bank

// ------------------------------------------------------- fp32 products
// Element (x, y) of an operand held in a swizzled tile: tile element
// (x, y) (Rows), or (y, x) for a transposed one (Cols).  x is the row of
// an A operand or the depth of a B operand.
template <bool kTrans>
struct Opd {
  static constexpr bool kT = kTrans;
  const float* p;
  __device__ __forceinline__ float operator()(int x, int y) const {
    return kTrans ? p[tile_at(y, x)] : p[tile_at(x, y)];
  }
};
using Rows = Opd<false>;
using Cols = Opd<true>;

// A warp's accumulators: its (16 MT) x (8 NT) block of a 64 x 64 tile, as
// MT x NT fragments of 16 x 8.
template <int MT, int NT>
using Acc = float[MT][NT][4];

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(Acc<MT, NT>& x) {
#pragma unroll
  for (int i = 0; i < 4 * MT * NT; ++i) (&x[0][0][0])[i] = 0.f;
}

template <int MT, int NT>
__device__ __forceinline__ void add_acc(Acc<MT, NT>& x,
                                        const Acc<MT, NT>& y) {
#pragma unroll
  for (int i = 0; i < 4 * MT * NT; ++i) (&x[0][0][0])[i] += (&y[0][0][0])[i];
}

// Row and column in the tile of element e of fragment (mi, ni) of the
// warp's block at (m0, n0).
__device__ __forceinline__ int frag_row(int m0, int mi, int e) {
  return m0 + 16 * mi + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int n0, int ni, int e) {
  return n0 + 8 * ni + 2 * (threadIdx.x & 3) + (e & 1);
}

// The tile offset of a fragment element at outer index o (a row of A, a
// column of B; o = lane / 4 mod 8) and depth y < 8: tile (o, y), or tile
// (y, o) when the tile runs along the depth.  A depth k (a multiple of 8)
// adds depth_shift(k) to every such offset, so the offsets are fixed for
// the thread and a depth step costs one add.
template <bool kAlongDepth>
__device__ __forceinline__ int frag_off(int o, int y) {
  return kAlongDepth ? tile_at(y, o) : tile_at(o, y);
}
template <bool kAlongDepth>
__device__ __forceinline__ int depth_shift(int k) {
  if (kAlongDepth) return k * 64;
  const int s = swz((threadIdx.x & 31) >> 2);
  return (k ^ s) - s;
}

template <int MT, int NT>
struct Frags {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
};

// Depths 2t and 2t+1 of an element, at offsets off[0] and off[1]: side by
// side in a tile along the row (one 8-byte read), in two rows of a tile
// along the depth.
template <bool kAlongDepth>
__device__ __forceinline__ float2 pair_at(const float* p,
                                          const int (&off)[2]) {
  if (kAlongDepth) return make_float2(p[off[0]], p[off[1]]);
  return *reinterpret_cast<const float2*>(p + off[0]);
}

// The warp's fragments of A (rows m0.., 16 MT) and B (columns n0.., 8 NT),
// depth step by depth step, split in TF32 hi + lo (kExact: lo rounded).
template <class TA, class TB, bool kExact, int MT, int NT>
struct Loader {
  static constexpr bool kAD = TA::kT, kBD = !TB::kT;   // along the depth
  const float* pa;
  const float* pb;
  int oa[MT][2][2], ob[NT][2];

  __device__ __forceinline__ Loader(TA A, TB B, int m0, int n0)
      : pa(A.p), pb(B.p) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          oa[mi][h][d] = frag_off<kAD>(m0 + 16 * mi + 8 * h + g, 2 * t + d);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        ob[ni][d] = frag_off<kBD>(n0 + 8 * ni + g, 2 * t + d);
    }
  }

  __device__ __forceinline__ void load(Frags<MT, NT>& f, int k) const {
    const float* a = pa + depth_shift<kAD>(k);
    const float* b = pb + depth_shift<kBD>(k);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = pair_at<kAD>(a, oa[mi][h]);
        split_tf32<kExact>(x.x, f.ah[mi][h], f.al[mi][h]);          // 2t
        split_tf32<kExact>(x.y, f.ah[mi][h + 2], f.al[mi][h + 2]);  // 2t+1
      }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float2 x = pair_at<kBD>(b, ob[ni]);
      split_tf32<kExact>(x.x, f.bh[ni][0], f.bl[ni][0]);
      split_tf32<kExact>(x.y, f.bh[ni][1], f.bl[ni][1]);
    }
  }
};

// lo += the lo terms (kSplit: 3xTF32; false leaves plain TF32), hi += hi
// hi, at one depth step; the fragments' products interleaved, so that no
// accumulator waits on its last product
template <bool kSplit, int MT, int NT>
__device__ __forceinline__ void mma3(Acc<MT, NT>& hi, Acc<MT, NT>& lo,
                                     const Frags<MT, NT>& f) {
  if (kSplit) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_tf32(lo[mi][ni], f.al[mi], f.bh[ni]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_tf32(lo[mi][ni], f.ah[mi], f.bl[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      mma_tf32(hi[mi][ni], f.ah[mi], f.bh[ni]);
}

// acc += A B over depth [k0, k1) (multiples of 8), for the warp's block at
// (m0, n0), for the products whose error is not summed further (dq, dk, dv
// and k dS): summed from zero and added to acc in fp32, so that the tensor
// cores' truncating adds run over one product only.
template <bool kSplit, int MT, int NT, class TA, class TB>
__device__ __forceinline__ void mm3(Acc<MT, NT>& acc, TA A, TB B, int m0,
                                    int n0, int k0, int k1) {
  const Loader<TA, TB, false, MT, NT> ld(A, B, m0, n0);
  Acc<MT, NT> part;
  zero_acc(part);
  for (int k = k0; k < k1; k += 8) {
    Frags<MT, NT> f;
    ld.load(f, k);
    mma3<kSplit>(part, part, f);
  }
  add_acc(acc, part);
}

// acc = A B over depth [0, K) (a multiple of 8), for the products whose
// every rounding reaches d(log a) (the scores, S dy and dS v): lo parts
// rounded, the hi products of each 16 of the depth summed from zero and
// added in fp32, the lo products in their own accumulator
// (csrc/ssd_scan_bwd.cu's note).
template <bool kSplit, int MT, int NT, class TA, class TB>
__device__ __forceinline__ void mm3_exact(Acc<MT, NT>& acc, TA A, TB B,
                                          int m0, int n0, int K) {
  const Loader<TA, TB, true, MT, NT> ld(A, B, m0, n0);
  Acc<MT, NT> lo;
  zero_acc(acc);
  zero_acc(lo);
  for (int k0 = 0; k0 < K; k0 += 16) {
    Acc<MT, NT> hi;
    zero_acc(hi);
    for (int k = k0; k < min(k0 + 16, K); k += 8) {
      Frags<MT, NT> f;
      ld.load(f, k);
      mma3<kSplit>(hi, lo, f);
    }
    add_acc(acc, hi);
  }
  add_acc(acc, lo);
}

// The warp's block of a (rows, cols)-valid tile of a row-major matrix
// with row stride ld: into acc (0 outside), or out of it.
template <int MT, int NT>
__device__ __forceinline__ void load_block(Acc<MT, NT>& acc,
                                           const float* src, int ld, int m0,
                                           int n0, int rows, int cols) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(m0, mi, e), c = frag_col(n0, ni, e);
        acc[mi][ni][e] = r < rows && c < cols ? src[(long long)r * ld + c]
                                              : 0.f;
      }
}

template <int MT, int NT>
__device__ __forceinline__ void store_block(float* dst,
                                            const Acc<MT, NT>& acc, int ld,
                                            int m0, int n0, int rows,
                                            int cols) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = frag_row(m0, mi, e), c = frag_col(n0, ni, e);
        if (r < rows && c < cols) dst[(long long)r * ld + c] = acc[mi][ni][e];
      }
}

// The warp's block into a swizzled tile.
template <int MT, int NT>
__device__ __forceinline__ void put_block(float* tile, const Acc<MT, NT>& x,
                                          int m0, int n0) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            tile + tile_at(frag_row(m0, mi, 2 * h), frag_col(n0, ni, 0))) =
            make_float2(x[mi][ni][2 * h], x[mi][ni][2 * h + 1]);
}

// Per row of the warp's block, sum_c x(row, c) * acc over its columns, in
// double, into part[row] (the four lanes of a row summed in a fixed order);
// acc in fp32 or fp64.
template <int MT, int NT, class TX, class T>
__device__ __forceinline__ void row_dots(double* part, TX X,
                                         const T (&acc)[MT][NT][4], int m0,
                                         int n0) {
  double s[MT][2] = {};
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[mi][e >> 1] = fma((double)X(frag_row(m0, mi, e),
                                      frag_col(n0, ni, e)),
                            (double)acc[mi][ni][e], s[mi][e >> 1]);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      double x = s[mi][hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if ((threadIdx.x & 3) == 0) part[frag_row(m0, mi, 2 * hh)] = x;
    }
}


// ---------------------------------------------------------------- wide route
// Both kernels' route for states wider than one tile (N or P above 64, as
// xLSTM's mLSTM: N 512, P 513).  A block forms one 64 x 64 tile of an
// output as a sum of products of 64 x 64 operand tiles -- the slices of N
// or P, or the chunk's row or column tiles -- that stream through a
// two-stage ring: step s's pair of tiles is copied into stage s % 2 while
// step s - 1's pair is multiplied.  Each warp owns the 32 x 16 block at
// (wide_m0(), wide_n0()) of the output tile.

// Shared memory of the ring's two stages of an A and a B tile.
constexpr int kRingSmem = 4 * 4 * kTile;

__device__ __forceinline__ int wide_m0() { return 32 * (threadIdx.x >> 7); }
__device__ __forceinline__ int wide_n0() {
  return 16 * ((threadIdx.x >> 5) & 3);
}

// Runs `steps` steps; the caller issued step 0 (issue(0)) before the call.
// issue(s) copies step s's tiles into stage s % 2 and commits them as one
// group (or writes them with plain stores); step(s) reads stage s % 2.
template <class Issue, class Step>
__device__ __forceinline__ void ring(int steps, Issue issue, Step step) {
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    else hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    step(s);
    __syncthreads();
  }
}

// The tile pair (I, J), I >= J, of a chunk's lower triangle of 64 x 64
// tiles, numbered by rows: p = I (I + 1) / 2 + J.
__device__ __forceinline__ void tile_pair(int p, int& I, int& J) {
  I = 0;
  while ((I + 1) * (I + 2) / 2 <= p) ++I;
  J = p - I * (I + 1) / 2;
}

// Rows [0, rows) and columns [0, cols) of an fp64 matrix (row stride
// `stride`) into a swizzled fp32 tile, rounded, zeros elsewhere; plain
// loads and stores by the whole block.
__device__ __forceinline__ void load_tile_f64(float* dst, const double* src,
                                              long long stride, int rows,
                                              int cols) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    dst[tile_at(r, c)] = r < rows && c < cols ? (float)src[r * stride + c]
                                              : 0.f;
  }
}

// An fp64 tile in shared memory, row r at r * kLdD: element (x, y) is
// (x, y) (RowsD) or (y, x) (ColsD), as Opd's.
template <bool kTrans>
struct OpdD {
  const double* p;
  __device__ __forceinline__ double operator()(int x, int y) const {
    return kTrans ? p[y * kLdD + x] : p[x * kLdD + y];
  }
};
using ColsD = OpdD<true>;

// acc += A B over depth [0, K) (a multiple of 8) in fp64 on DMMA (m16n8k8,
// csrc/ssd_mma.cuh's fragments), for the warp's (16 MT) x (8 NT) block at
// (m0, n0); A and B are tiles of either precision (Opd or OpdD).  The
// products whose roundings reach d(log a) on the wide route, where they
// sum 512 or 513 deep and fp32 would miss float64 by more than 1e-4.
template <int MT, int NT, class TA, class TB>
__device__ __forceinline__ void mm_f64(double (&acc)[MT][NT][4], TA A, TB B,
                                       int m0, int n0, int K) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  for (int k = 0; k < K; k += 8) {
    double av[MT][4], bv[NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        av[mi][j] = A(m0 + 16 * mi + g + 8 * (j & 1), k + t + 4 * (j >> 1));
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        bv[ni][j] = B(k + t + 4 * j, n0 + 8 * ni + g);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_f64(acc[mi][ni], av[mi], bv[ni]);
  }
}

// Each row's sum of the block's per-warp partials part[w][row] (w < n, in
// order), for the 64 rows of a tile, into out[row] (rows < valid); the
// first 64 threads.
__device__ __forceinline__ void sum_parts(double* out, const double* part,
                                          int n, int valid) {
  const int r = threadIdx.x;
  if (r < kT && r < valid) {
    double s = part[r];
    for (int w = 1; w < n; ++w) s += part[w * kT + r];
    out[r] = s;
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
