// Gradient of the SSD chunked scan (csrc/ssd_scan.cu), for sm_90a: da, dk,
// dv, dq and d(initial state) from a, k, v, q, dy, the chunk-entry states
// the forward saved (not recomputed) and d(final state).
//
// The TPU kernel it mirrors, src/repro/kernels/ssd_scan.py (`_ssd_kernel`),
// has no backward kernel: the JAX package differentiates its pure-JAX twin
// (`models/mamba2.py`, `chunked_linear_scan`) by autodiff.  So this kernel
// is held against the gradient of the plain version.
//
// Per chunk, with M_ij = e^{cum_i - cum_j} (i >= j, else 0), w_j =
// e^{cum_L - cum_j}, S the chunk's entry state and dS the gradient of its
// exit state:
//   dq_i = sum_j M_ij (dy_i . v_j) k_j + e^{cum_i} S dy_i
//   dk_j = sum_i M_ij (dy_i . v_j) q_i + w_j dS v_j
//   dv_j = sum_i M_ij (q_i . k_j) dy_i + w_j dS^T k_j
// and d(log a) at position t, from terms that are each formed once:
//   dlog a_t = sum_{i>=t} (R_i - C_i + X_i) + e^{cum_L} <dS, S>
//              + sum_{j<t} Y_j
//   R_i = sum_j Z_ij,  C_j = sum_i Z_ij,  Z_ij = M_ij (q_i . k_j)(dy_i . v_j)
//   X_i = e^{cum_i} q_i . (S dy_i),  Y_j = w_j k_j . (dS v_j)
//   da = dlog a / a where a > 1e-37, else 0.
// (The reference differentiates q_i . dq_i - k_i . dk_i + <dS, S_exit> at
// the last position; the same sum, rearranged: the pairs i, j >= t and the
// terms in S_exit - e^{cum_L} S cancel exactly, so they are never formed.)
// Only dS runs from chunk to chunk:
//   dS_c = e^{cum_L,c+1} dS_{c+1} + U_{c+1},  U_c = sum_i e^{cum_i} q_i dy_i^T
// from dS = d(final state) after the last chunk; d(initial state) is
// e^{cum_L,0} dS_0 + U_0.  cum restarts in every chunk, so the rest of a
// chunk, both of d(log a)'s scans included, is local once dS_c is known.
//
// What bounds it on this card: operations.  B*H*(pairs*2*(2P + 3N)
// + S*8*N*P) useful flops (pairs: the causal pairs i >= j of every chunk),
// 60.3 GFLOP at the zamba2 training shape: 0.90 ms at the fp32 FMA rate,
// 0.365 ms at the rate of fp32-accurate tensor-core products (three TF32
// products each, 495 TFLOP/s); its bytes take 0.21 ms.
//
// What the design does about it: three launches, parallel over chunks.
// * ssd_bwd_sums_kernel, one block per (b, h, chunk): U_c in fp64 on DMMA
//   (m16n8k8, 2 * 64 * 64 * Q flops a chunk), and e^{cum_L}.
// * ssd_bwd_carry_kernel: the dS scan, one thread per (b, h, n, p), in
//   fp64; U_c is overwritten by dS_c.
// * ssd_bwd_chunk_kernel, one block of 8 warps per (b, h, chunk), 2,048
//   blocks at the training shape: the chunk's 64 x 64 tile pairs (I >= J)
//   by columns: k_J and v_J held while q_I and dy_I stream through a
//   two-stage cp.async ring, each tile copied once a block.  Warps 0-3 form
//   dy_I v_J^T and then dk_J += (M o D)^T q_I, warps 4-7 q_I k_J^T and
//   dv_J += (M o Sc)^T dy_I, each warp a 32 x 32 quadrant (a 32 x 16 block
//   loads 1.5 times the operands per product); between them the scores
//   meet in shared memory, are masked (M o D, M o Sc) and give Z's row and
//   column sums in double; all eight warps form dq_I += (M o D) k_J and
//   S dy_I.  dk_J and dv_J stay in registers over the column; dq_I goes
//   back to global memory between columns, read and written by the same
//   thread.  The diagonal pairs skip what lies above the diagonal.  No
//   atomics, a fixed order of every sum: the same bits on every run.
// * Every 64 x 64 x 64 product on mma.sync in TF32 (HMMA), each operand
//   split in hi + lo (hi rounded to TF32 with two integer operations; the
//   cvt instruction costs more than the products) and three products summed
//   (hi hi + hi lo + lo hi), accurate to fp32 (plain TF32 misses the 1e-4
//   tolerance).  Each product is summed from zero and added in fp32, so
//   that the tensor cores' truncating adds run over one product only.  The
//   products whose every rounding reaches d(log a) -- the scores (through
//   Z), S dy (X) and dS v (Y) -- also round lo, sum the hi products of each
//   16 of the depth from zero, and keep the lo products in an accumulator
//   of their own.
// * Operand fragments read with per-thread offsets fixed over the depth;
//   the depth order within a step puts a thread's two depths side by side
//   (one 8-byte read where the tile runs along the row); the tiles' XOR
//   swizzle keeps every fragment read free of bank conflicts
//   (csrc/ssd_mma.cuh).
// * k and q may be broadcast over H (stride 0): each head writes its own dk
//   and dq into (B, H, S, N) outputs, and autograd sums them over H.
// * In double, as the plain version: log a and its running sum cum, Z, R,
//   C, X, Y, U, the dS carry, <dS, S> and both scans.  The products use
//   dS rounded to fp32.

#include "ssd_mma.cuh"

namespace {

using namespace ssd;

// 3xTF32: each product also takes its lo terms; false leaves plain TF32
constexpr bool kSplit = true;

struct BwdArgs {
  const float* a; const float* k; const float* v; const float* q;
  const float* dy;
  const float* states;     // (B, H, nc, N, P): each chunk's entry state
  const float* dfinal;     // (B, H, N, P), or null for zeros
  float* da; float* dk; float* dv; float* dq;   // contiguous (B, H, S, .)
  float* dinit;            // (B, H, N, P), or null
  double* carry;           // (B, H, nc, N, P): U_c, then dS_c
  double* decay;           // (B, H, nc): e^{cum_L} of each chunk
  View va, vk, vv, vq, vdy;
  int H, S, N, P, Q, nc;
  bool wk, wv, wq, wdy;    // 16-byte copies allowed
};

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

// lo += the lo terms, hi += hi hi, at one depth step; the fragments'
// products interleaved, so that no accumulator waits on its last product
template <int MT, int NT>
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
template <int MT, int NT, class TA, class TB>
__device__ __forceinline__ void mm3(Acc<MT, NT>& acc, TA A, TB B, int m0,
                                    int n0, int k0, int k1) {
  const Loader<TA, TB, false, MT, NT> ld(A, B, m0, n0);
  Acc<MT, NT> part;
  zero_acc(part);
  for (int k = k0; k < k1; k += 8) {
    Frags<MT, NT> f;
    ld.load(f, k);
    mma3(part, part, f);
  }
  add_acc(acc, part);
}

// acc = A B over depth [0, K) (a multiple of 8), for the products whose
// every rounding reaches d(log a) (the scores, S dy and dS v): lo parts
// rounded, the hi products of each 16 of the depth summed from zero and
// added in fp32, the lo products in their own accumulator (the note at the
// top).
template <int MT, int NT, class TA, class TB>
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
      mma3(hi, lo, f);
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
// double, into part[row] (the four lanes of a row summed in a fixed order).
template <int MT, int NT, class TX>
__device__ __forceinline__ void row_dots(double* part, TX X,
                                         const Acc<MT, NT>& acc, int m0,
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

// ---------------------------------------------------------------- sums
// U_c = sum_i e^{cum_i} q_i dy_i^T (N x P) in fp64 on DMMA, and e^{cum_L},
// for one (b, h, chunk).
__global__ void __launch_bounds__(kThreads) ssd_bwd_sums_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // q[2], dy[2]: a ring of
  float* yt = qt + 2 * kTile;                    // 64-row tiles
  double* yd = reinterpret_cast<double*>(yt + 2 * kTile);  // dy in fp64
  double* e = yd + kT * kLdD;                    // e^{cum_i}
  double* scratch = e + kMaxQ;

  const int tid = threadIdx.x;
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  const Rows64 x{a.q + b * a.vq.b + h * a.vq.h + s0 * a.vq.s, a.vq.s, a.N,
                 a.wq};
  const Rows64 y{a.dy + b * a.vdy.b + h * a.vdy.h + s0 * a.vdy.s, a.vdy.s,
                 a.P, a.wdy};
  issue_rows(qt, yt, x, y, 0, Qc);
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  e[tid] = tid < Qc ? exp(cs) : 0.0;
  if (tid == Qc - 1) a.decay[bhc] = exp(cs);
  outer_sum_f64(qt, yt, yd, e, x, y, Qc, a.carry + bhc * a.N * a.P, a.P,
                a.N, a.P);
}

// ---------------------------------------------------------------- carry
// dS from the last chunk to the first, one thread per (b, h, n, p): U_c is
// replaced by dS_c, the gradient of chunk c's exit state; d(initial state)
// is the gradient of the first chunk's entry state.  Eight chunks' loads
// are in flight at a time.
__global__ void __launch_bounds__(kThreads) ssd_bwd_carry_kernel(BwdArgs a,
                                                                 int blocks) {
  const long long bh = blockIdx.x / blocks;
  const int NP = a.N * a.P;
  const int i = (blockIdx.x % blocks) * kThreads + threadIdx.x;
  if (i >= NP) return;
  double ds = a.dfinal != nullptr ? (double)a.dfinal[bh * NP + i] : 0.0;
  double* slot = a.carry + bh * a.nc * NP + i;
  const double* dec = a.decay + bh * a.nc;
  for (int c0 = a.nc - 1; c0 >= 0; c0 -= 8) {
    double u[8], d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 - j >= 0) {
        u[j] = slot[(long long)(c0 - j) * NP];
        d[j] = dec[c0 - j];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 - j >= 0) {
        slot[(long long)(c0 - j) * NP] = ds;
        ds = fma(d[j], ds, u[j]);
      }
  }
  if (a.dinit != nullptr) a.dinit[bh * NP + i] = (float)ds;
}

// ---------------------------------------------------------------- chunk
constexpr int kChunkSmem = 4 * (12 * kTile + 2 * kMaxQ)
                           + 8 * (4 * kMaxQ + 12 * kT + kThreads / 32);

// Z's sums over half kHalf (rows 16 kHalf.. of the quadrant) of the warp's
// 32 x 32 quadrant at (qm, qn), from its own scores `mine` (kD: dy v^T,
// else q k^T) and the partner group's raw scores in `other`; writes M o D
// and M o Sc over the raw scores there, and Z's row sums (by column half)
// and column sums (by row quarter).
template <int kHalf, bool kD>
__device__ __forceinline__ void z_half(const Acc<2, 4>& mine, float* md,
                                       float* ms, const double* cum2, int r0,
                                       int c0, int Qc, int qm, int qn,
                                       double* rpart, double* cpart) {
  const float* other = kD ? ms : md;
  double zr[2] = {0.0, 0.0};
  double zc[4][2] = {};
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = frag_row(qm, kHalf, e), col = frag_col(qn, ni, e);
      const int r = r0 + row, cc = c0 + col;
      const float theirs = other[tile_at(row, col)];
      const float d = kD ? mine[kHalf][ni][e] : theirs;
      const float s = kD ? theirs : mine[kHalf][ni][e];
      const float m = (cc <= r && r < Qc)
                      ? exp2f((float)(cum2[r] - cum2[cc])) : 0.f;
      const float dm = d * m;
      // in double from here: rounding dm and dm s to fp32 adds 2^-24 to
      // the 2^-22 of m
      const double z = (double)(dm * s);
      zr[e >> 1] += z;
      zc[ni][e & 1] += z;
      md[tile_at(row, col)] = dm;
      ms[tile_at(row, col)] = s * m;
    }
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    double x = zr[hh];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (t == 0) rpart[(qn >> 5) * kT + qm + 16 * kHalf + g + 8 * hh] = x;
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      double x = zc[ni][j];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0)
        cpart[((qm >> 4) + kHalf) * kT + qn + 8 * ni + 2 * t + j] = x;
    }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // k_J, v_J: two columns
  float* vt = kt + 2 * kTile;
  float* qt = vt + 2 * kTile;        // q_I, dy_I: the ring's two stages
  float* yt = qt + 2 * kTile;
  float* md = yt + 2 * kTile;        // dy_I v_J^T, then M o (dy_I v_J^T)
  float* ms = md + kTile;            // q_I k_J^T, then M o (q_I k_J^T)
  float* st = ms + kTile;            // entry state S (N x P)
  float* dst = st + kTile;           // dS, rounded to fp32
  float* ecum = dst + kTile;         // e^{cum_i}
  float* wdec = ecum + kMaxQ;        // e^{cum_L - cum_j}
  double* cum = reinterpret_cast<double*>(wdec + kMaxQ);
  double* cum2 = cum + kMaxQ;        // cum / ln 2
  double* fsum = cum2 + kMaxQ;       // R_i - C_i + X_i
  double* ysum = fsum + kMaxQ;       // Y_j
  double* rpart = ysum + kMaxQ;      // [2][64]: Z's row sums by column half
  double* cpart = rpart + 2 * kT;    // [4][64]: Z's column sums by row
                                     // quarter
  double* xpart = cpart + 4 * kT;    // [4][64]: q . (S dy) by quarter of n
  double* ypart = xpart + 4 * kT;    // [2][64]: k . (dS v) by half of n
  double* scratch = ypart + 2 * kT;  // 8

  // Warps 0-3 (group 0) form dy v^T and dk_J, warps 4-7 (group 1) q k^T
  // and dv_J, each a 32 x 32 quadrant at (qm, qn); all eight share the
  // S dy and dq products in 32 x 16 blocks at (hm, hn).
  const int tid = threadIdx.x, warp = tid >> 5, grp = warp >> 2;
  const int qm = 32 * ((warp >> 1) & 1), qn = 32 * (warp & 1);
  const int hm = 32 * (warp >> 2), hn = 16 * (warp & 3);
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  const int nT = (Qc + kT - 1) / kT;
  const int kN8 = (a.N + 7) & ~7, kP8 = (a.P + 7) & ~7;
  const long long S = a.S, NP = (long long)a.N * a.P;
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  const float* K = a.k + b * a.vk.b + h * a.vk.h + s0 * a.vk.s;
  const float* V = a.v + b * a.vv.b + h * a.vv.h + s0 * a.vv.s;
  const float* Qm = a.q + b * a.vq.b + h * a.vq.h + s0 * a.vq.s;
  const float* DY = a.dy + b * a.vdy.b + h * a.vdy.h + s0 * a.vdy.s;
  float* DA = a.da + bh * S + s0;
  float* DK = a.dk + (bh * S + s0) * a.N;
  float* DQ = a.dq + (bh * S + s0) * a.N;
  float* DV = a.dv + (bh * S + s0) * a.P;

  // the tiles of step (I, J): q_I and dy_I into ring stage `stage`, and
  // k_J and v_J when the step opens column J
  auto issue = [&](int I, int J, int stage, bool column) {
    const int rI = min(kT, Qc - I * kT);
    copy_tile(qt + stage * kTile, Qm + I * kT * a.vq.s, a.vq.s, rI,
                   a.N, a.wq);
    copy_tile(yt + stage * kTile, DY + I * kT * a.vdy.s, a.vdy.s, rI,
                   a.P, a.wdy);
    if (column) {
      const int rJ = min(kT, Qc - J * kT);
      copy_tile(kt + (J & 1) * kTile, K + J * kT * a.vk.s, a.vk.s, rJ,
                     a.N, a.wk);
      copy_tile(vt + (J & 1) * kTile, V + J * kT * a.vv.s, a.vv.s, rJ,
                     a.P, a.wv);
    }
    hopper::cp_async_commit();
  };
  issue(0, 0, 0, true);

  // cum, e^{cum}, w; S and dS as fp32 tiles, <dS, S> in double
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  cum[tid] = cs;
  cum2[tid] = cs * 1.4426950408889634;
  fsum[tid] = 0.0;
  ysum[tid] = 0.0;
  const float* Sg = a.states + bhc * NP;
  const double* dSg = a.carry + bhc * NP;
  double part = 0.0;
  for (int i = tid; i < kTile; i += kThreads) {
    const int n = i >> 6, p = i & 63;
    const bool ok = n < a.N && p < a.P;
    const float sv = ok ? Sg[n * a.P + p] : 0.f;
    const double dv = ok ? dSg[n * a.P + p] : 0.0;
    st[tile_at(n, p)] = sv;
    dst[tile_at(n, p)] = (float)dv;
    part = fma(dv, (double)sv, part);
  }
  const double ds_prev = block_sum(part, scratch);   // <dS, S>; syncs
  const double cL = cum[Qc - 1];
  ecum[tid] = tid < Qc ? expf((float)cs) : 0.f;
  wdec[tid] = tid < Qc ? expf((float)(cL - cs)) : 0.f;

  Acc<2, 4> g;                         // group 0: dk_J, group 1: dv_J
  int I = 0, J = 0;
  for (int step = 0;; ++step) {
    int In = I + 1, Jn = J;            // the next step, by columns
    if (In == nT) In = Jn = J + 1;
    const bool more = Jn < nT;
    if (more) issue(In, Jn, (step + 1) & 1, Jn != J);
    else hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const float* q_ = qt + (step & 1) * kTile;
    const float* y_ = yt + (step & 1) * kTile;
    const float* k_ = kt + (J & 1) * kTile;
    const float* v_ = vt + (J & 1) * kTile;
    const bool diag = I == J;
    const int rI = min(kT, Qc - I * kT);

    if (diag) {                        // column J opens: its dS terms
      if (grp == 0) {
        mm3_exact(g, Rows{v_}, Cols{dst}, qm, qn, kP8);  // v_J dS^T
        row_dots(ypart + (qn >> 5) * kT, Rows{k_}, g, qm, qn);
      } else {
        zero_acc(g);
        mm3(g, Rows{k_}, Rows{dst}, qm, qn, 0, kN8);     // k_J dS
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            g[mi][ni][e] *= wdec[J * kT + frag_row(qm, mi, e)];
    }
    if (J == 0) {                      // row I's first visit: S dy_I
      Acc<2, 2> tq;
      mm3_exact(tq, Rows{y_}, Cols{st}, hm, hn, kP8);  // dy_I S^T
      row_dots(xpart + (warp & 3) * kT, Rows{q_}, tq, hm, hn);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tq[mi][ni][e] *= ecum[I * kT + frag_row(hm, mi, e)];
      // dq_I starts as e^{cum_i} S dy_i, in global memory
      store_block(DQ + I * kT * a.N, tq, a.N, hm, hn, rI, a.N);
    }

    // the scores (raw, to shared memory), then masked, and Z's sums
    {
      Acc<2, 4> sc;
      if (!diag || qn < qm + 32) {     // else wholly above the diagonal
        if (grp == 0) mm3_exact(sc, Rows{y_}, Cols{v_}, qm, qn, kP8);
        else mm3_exact(sc, Rows{q_}, Cols{k_}, qm, qn, kN8);
      } else {
        zero_acc(sc);
      }
      put_block(grp == 0 ? md : ms, sc, qm, qn);
      __syncthreads();
      if (grp == 0)
        z_half<0, true>(sc, md, ms, cum2, I * kT, J * kT, Qc, qm, qn, rpart,
                        cpart);
      else
        z_half<1, false>(sc, md, ms, cum2, I * kT, J * kT, Qc, qm, qn,
                         rpart, cpart);
    }
    __syncthreads();

    if (tid < kT) {                    // R, C, X, Y of this step, in order
      const int x = tid;
      double f = fsum[I * kT + x] + rpart[x] + rpart[kT + x];
      if (J == 0)
        f += (double)ecum[I * kT + x] * (xpart[x] + xpart[kT + x]
                                         + xpart[2 * kT + x]
                                         + xpart[3 * kT + x]);
      fsum[I * kT + x] = f;
      fsum[J * kT + x] -= cpart[x] + cpart[kT + x] + cpart[2 * kT + x]
                          + cpart[3 * kT + x];
      if (diag)
        ysum[J * kT + x] = (double)wdec[J * kT + x]
                           * (ypart[x] + ypart[kT + x]);
    }

    // dk_J (group 0), dv_J (group 1); dq_I (its sum so far from global
    // memory); on the diagonal only depths below it
    if (grp == 0) mm3(g, Cols{md}, Rows{q_}, qm, qn, diag ? qm : 0, kT);
    else mm3(g, Cols{ms}, Rows{y_}, qm, qn, diag ? qm : 0, kT);
    {
      Acc<2, 2> gq;
      load_block(gq, DQ + I * kT * a.N, a.N, hm, hn, rI, a.N);
      mm3(gq, Rows{md}, Rows{k_}, hm, hn, 0, diag ? hm + 32 : kT);
      store_block(DQ + I * kT * a.N, gq, a.N, hm, hn, rI, a.N);
    }
    if (I == nT - 1) {                 // column J closes
      const int rJ = min(kT, Qc - J * kT);
      if (grp == 0) store_block(DK + J * kT * a.N, g, a.N, qm, qn, rJ, a.N);
      else store_block(DV + J * kT * a.P, g, a.P, qm, qn, rJ, a.P);
    }
    __syncthreads();
    if (!more) break;
    I = In;
    J = Jn;
  }

  // dlog a_t = sum_{i>=t} fsum_i + e^{cum_L} <dS, S> + sum_{j<t} Y_j;
  // da = dlog a / a.  Thread t scans position Qc-1-t for the first sum
  // and position t for the second.
  const int idx = Qc - 1 - tid;
  const double after = block_scan(idx >= 0 ? fsum[idx] : 0.0, scratch);
  const double y = tid < Qc ? ysum[tid] : 0.0;
  const double before = block_scan(y, scratch) - y;
  ysum[tid] = before;
  const double dec = exp(cL);
  __syncthreads();
  if (idx >= 0) {
    const double dla = after + dec * ds_prev + ysum[idx];
    const float av = A[idx * a.va.s];
    DA[idx] = av > kMinA ? (float)(dla / av) : 0.f;
  }
}

bool wide(const float* p, long long sb, long long sh, long long ss,
          int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0
         && sh % 4 == 0 && ss % 4 == 0 && cols % 4 == 0;
}

}  // namespace

// Strides as in ssd_scan_fwd_launch, for a, k, v, q and dy; states
// (B,H,nc,N,P), dfinal (B,H,N,P) and the outputs da (B,H,S),
// dk, dq (B,H,S,N), dv (B,H,S,P) and dinit (B,H,N,P) contiguous; work
// holds B*H*nc*(N*P + 1) doubles.  N, P <= 64, 1 <= Q <= 256.  dfinal and
// dinit may be null.  Three launches on `stream`.  Returns a CUDA error
// code (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const float* a, const float* k, const float* v, const float* q,
    const float* dy, const float* states, const float* dfinal, float* da,
    float* dk, float* dv, float* dq, float* dinit, double* work,
    long long ab, long long ah, long long as,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long qb, long long qh, long long qs,
    long long yb, long long yh, long long ys,
    int B, int H, int S, int N, int P, int Q, void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || N > kT || P < 1 || P > kT
      || Q < 1 || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const long long chunks = (long long)B * H * nc;
  BwdArgs args{a, k, v, q, dy, states, dfinal, da, dk, dv, dq, dinit,
               work, work + chunks * N * P,
               {ab, ah, as}, {kb, kh, ks}, {vb, vh, vs}, {qb, qh, qs},
               {yb, yh, ys}, H, S, N, P, Q, nc,
               wide(k, kb, kh, ks, N), wide(v, vb, vh, vs, P),
               wide(q, qb, qh, qs, N), wide(dy, yb, yh, ys, P)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSumsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N * P + kThreads - 1) / kThreads;
  if (chunks > 0x7fffffffLL || (long long)B * H * blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ssd_bwd_sums_kernel<<<(unsigned)chunks, kThreads, kSumsSmem, st>>>(args);
  ssd_bwd_carry_kernel<<<(unsigned)(B * H * blocks), kThreads, 0, st>>>(
      args, blocks);
  ssd_bwd_chunk_kernel<<<(unsigned)chunks, kThreads, kChunkSmem, st>>>(
      args);
  return (int)cudaGetLastError();
}
