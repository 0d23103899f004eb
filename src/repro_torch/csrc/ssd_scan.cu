// Mamba-2 SSD chunked scan, forward, for sm_90a:
//   S_t = a_t S_{t-1} + k_t v_t^T ,  y_t = S_t^T q_t
// a (B,H,S) decays in (0,1]; k, q (B,H,S,N); v, y (B,H,S,P); fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (`ssd_scan`, :60;
// `_ssd_kernel`, :23).  There one grid step is one (batch, head, chunk) and
// the chunk axis runs in order with the (N, P) state in VMEM scratch.  Per
// chunk of Q positions, with cum = cumsum(log a) restarting in each chunk,
// L its last position and w_j = e^{cum_L - cum_j}:
//   y_i     = sum_{j<=i} (q_i . k_j) e^{cum_i - cum_j} v_j + e^{cum_i} q_i S_c
//   S_{c+1} = e^{cum_L} S_c + dS_c,   dS_c = sum_j w_j k_j v_j^T
// Only the state runs from chunk to chunk; once S_c is known the rest of a
// chunk is local.
//
// What bounds it on this card: operations.  B*H*S*(Q*(N+P) + 4*N*P) useful
// flops (the causal half of the two Q x Q products, the inter-chunk term
// and the state update): 25.8 GFLOP at the zamba2 training shape (B 2,
// H 64, S 4096, N = P = 64, Q 256), 0.385 ms at the fp32 FMA rate, 0.156 ms
// at the rate of fp32-accurate tensor-core products (three TF32 products
// each, 495 TFLOP/s), against 0.093 ms to move its bytes.
//
// What the design does about it: three launches, parallel over chunks.
// * ssd_fwd_sums_kernel, one block per (b, h, chunk, 64 columns of P):
//   dS_c in fp64 on DMMA (m16n8k8, 2 * N * 64 * Q flops), with cum and w in
//   double, and e^{cum_L} (csrc/ssd_mma.cuh, outer_sum_f64).
// * ssd_fwd_carry_kernel: the state scan in fp64, one thread per (b, h, n,
//   p), from the initial state or zeros; it writes each chunk's entry state
//   in fp32, (B, H, nc, N, P) contiguous (the layout csrc/ssd_scan_bwd.cu
//   reads), and the final state.  The fp64 sums and scan keep the states
//   exact to fp32: the backward's d(log a) reads them (X_i and <dS, S>).
// * ssd_fwd_chunk_kernel, one block of 8 warps per (b, h, chunk, 64
//   columns of P), 2,048 blocks at the training shape.  The chunk's q, k
//   and v (up to 4 + 4 + 4 tiles of 64 rows) and S_c are copied into
//   swizzled shared-memory tiles by cp.async, all issued at the start,
//   each tile with its own mbarrier (cp.async.mbarrier.arrive), so a warp
//   waits only for the tiles it reads next and the later tiles' loads
//   overlap the products.  Warp w owns the 16-row slabs w and 15 - w of the
//   chunk (equal work: slab s needs 2s + 2 column groups of 8), and no warp
//   waits on another: per slab it forms e^{cum_i} q_i S_c, then for each
//   column tile J at or below the diagonal the scores q_i k_j^T (16 x 64),
//   masked by e^{cum_i - cum_j}, and multiplies them by v_J straight from
//   registers (the scores' accumulator fragment is the next product's
//   operand fragment), skipping the column groups above the diagonal.
// * The mask costs one exponential per element if formed as it stands.  A
//   column j in a 16-column group before the slab's takes it as e^{cum_i -
//   e_G} e^{e_G - cum_j}, e_G = cum at the group's last column, both
//   factors <= 1: the second once per block per column, the first once per
//   row and group.  Only the slab's own 16 x 16 block forms e^{cum_i -
//   cum_j} itself, where i >= j: no factor exceeds 1, so strong decays
//   cannot overflow (the reference forms it everywhere and masks after).
// * Every product on mma.sync in TF32 (HMMA), each operand split in hi + lo
//   and three products summed (hi hi + hi lo + lo hi), accurate to fp32
//   (plain TF32 misses the 1e-4 tolerance).  Each product is summed from
//   zero and added in fp32, so that the tensor cores' truncating adds run
//   over one product only.
// * A ragged last chunk is masked in the kernel; nothing is padded.  The
//   final state equals the padded reference's (padding has a = 1, k = 0).
// * Inputs are read through element strides, so the model's k and q, one
//   (B, S, N) tensor broadcast over H (stride 0), and its (B, S, H, .)
//   layout need no copy; y is written in v's layout.
// * No atomics, a fixed order of every sum: the same bits on every run.
//
// A state wider than one tile (N > 64: xLSTM's mLSTM, N 512 and P 513 at
// B 2, H 4, S 2048, Q 256) takes the wide route: the sums kernel gains a
// grid axis over 64-row tiles of N (8 x 9 tiles a chunk there), the carry
// only its sizes, and the chunk kernel's work goes to two launches (the
// "wide" section below): 21.5 GFLOP of useful work there, 0.321 ms at the
// fp32 FMA rate, 0.130 ms at the 3xTF32 tensor rate, against 0.063 ms to
// move its bytes.  P 513's last tile is one column wide: the wide route's
// kernels copy a ragged group of columns 16 bytes at a time where the rows
// are 16-byte aligned (copy_tile<true>), the sums kernel such a tile 4
// bytes at a time; the model pads its rows to 516 floats.

#include "ssd_mma.cuh"

namespace {

using namespace ssd;

// 3xTF32: each product also takes its lo terms; false leaves plain TF32
constexpr bool kSplit = true;
constexpr int kWarps = kThreads / 32;

struct FwdArgs {
  const float* a; const float* k; const float* v; const float* q;
  const float* init;       // (B, H, N, P) contiguous, or null for zeros
  float* y;
  float* final_state;      // (B, H, N, P) contiguous
  float* states;           // (B, H, nc, N, P) contiguous: entry states
  double* sums;            // (B, H, nc, N, P): dS_c
  double* decay;           // (B, H, nc): e^{cum_L} of each chunk
  View va, vk, vv, vq, vy;
  int H, S, N, P, Q, nc;
  bool wk, wv, wq, wy;     // 16-byte copies (k, v, q), 8-byte stores (y)
  // the wide route only
  float* scores;           // (B, H, nc, Qp, Qp): M o (q k^T) of each chunk
  int Qp;                  // Q rounded up to a whole tile
  bool wS;                 // 16-byte copies of the states (P % 4 == 0)
};

// ---------------------------------------------------------------- sums
// dS_c = sum_j e^{cum_L - cum_j} k_j v_j^T (64 rows of N x 64 columns of
// P) in fp64 on DMMA, and e^{cum_L}, for one (b, h, chunk, column tile,
// row tile).
__global__ void __launch_bounds__(kThreads) ssd_fwd_sums_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // k[2], v[2]: a ring of
  float* vt = kt + 2 * kTile;                    // 64-row tiles
  double* vd = reinterpret_cast<double*>(vt + 2 * kTile);  // v in fp64
  double* w = vd + kT * kLdD;                    // cum, then w
  double* scratch = w + kMaxQ;

  const int tid = threadIdx.x;
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int p0 = blockIdx.y * kT, PT = min(kT, a.P - p0);
  const int n0 = blockIdx.z * kT, NT = min(kT, a.N - n0);
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  // 16-byte copies of a tile whose width is a multiple of 4 (on the wide
  // route the flags check only the rows' alignment)
  const Rows64 x{a.k + b * a.vk.b + h * a.vk.h + s0 * a.vk.s + n0, a.vk.s,
                 NT, a.wk && NT % 4 == 0};
  const Rows64 y{a.v + b * a.vv.b + h * a.vv.h + s0 * a.vv.s + p0, a.vv.s,
                 PT, a.wv && PT % 4 == 0};
  issue_rows(kt, vt, x, y, 0, Qc);
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  w[tid] = cs;
  __syncthreads();
  const double cL = w[Qc - 1];
  __syncthreads();
  w[tid] = tid < Qc ? exp(cL - cs) : 0.0;
  if (tid == Qc - 1 && blockIdx.y == 0 && blockIdx.z == 0)
    a.decay[bhc] = exp(cs);
  outer_sum_f64(kt, vt, vd, w, x, y, Qc,
                a.sums + bhc * a.N * a.P + (long long)n0 * a.P + p0, a.P, NT,
                PT);
}

// ---------------------------------------------------------------- carry
// The state scan, first chunk to last, one thread per (b, h, n, p), in
// fp64: each chunk's entry state is written in fp32, then S <- e^{cum_L} S
// + dS_c.  Eight chunks' loads are in flight at a time.
__global__ void __launch_bounds__(kThreads) ssd_fwd_carry_kernel(FwdArgs a,
                                                                 int blocks) {
  const long long bh = blockIdx.x / blocks;
  const int NP = a.N * a.P;
  const int i = (blockIdx.x % blocks) * kThreads + threadIdx.x;
  if (i >= NP) return;
  double s = a.init != nullptr ? (double)a.init[bh * NP + i] : 0.0;
  const double* sums = a.sums + bh * a.nc * NP + i;
  const double* dec = a.decay + bh * a.nc;
  float* st = a.states + bh * a.nc * NP + i;
  for (int c0 = 0; c0 < a.nc; c0 += 8) {
    double u[8], d[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < a.nc) {
        u[j] = sums[(long long)(c0 + j) * NP];
        d[j] = dec[c0 + j];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < a.nc) {
        st[(long long)(c0 + j) * NP] = (float)s;
        s = fma(d[j], s, u[j]);
      }
  }
  a.final_state[bh * NP + i] = (float)s;
}

// ---------------------------------------------------------------- chunk

// A warp's 16 x 64 block of a product, as 8 fragments of 16 x 8 (mma.sync
// m16n8k8: rows g, g+8 and columns 2t, 2t+1 of each, g = lane / 4, t =
// lane % 4).  The depth order within a step puts depth 2t in column
// (row) t of the A (B) fragment and 2t+1 in t+4 (csrc/ssd_mma.cuh), so a
// thread's accumulator elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
// of a column group are its A fragment of the next product over those 8
// depths.
using Blk = float[8][4];

__device__ __forceinline__ void zero_blk(Blk& x) {
#pragma unroll
  for (int i = 0; i < 32; ++i) (&x[0][0])[i] = 0.f;
}

// The A fragment of rows m0.. of a tile along the row, depths k.. (two
// 8-byte reads), split in TF32 hi + lo.
__device__ __forceinline__ void a_frag(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* tile, int m0, int k) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 x = *reinterpret_cast<const float2*>(
        tile + tile_at(m0 + g + 8 * h, k + 2 * t));
    split_tf32<false>(x.x, ah[h], al[h]);          // depth 2t
    split_tf32<false>(x.y, ah[h + 2], al[h + 2]);  // depth 2t+1
  }
}

// acc[ni] += A B for the column groups ni < nt at depth step k: B(x, c) is
// tile element (c, x) (kAlongRow: k for the scores, one 8-byte read) or
// (x, c) (S and v: rows 2t and 2t+1).  The products are interleaved so
// that no accumulator waits on its last product.
template <bool kAlongRow>
__device__ __forceinline__ void mma_step(Blk& acc, const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* tile, int k, int nt) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  uint32_t bh[8][2], bl[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
    if (ni < nt) {
      float2 x;
      if (kAlongRow) {
        x = *reinterpret_cast<const float2*>(
            tile + tile_at(8 * ni + g, k + 2 * t));
      } else {
        x = make_float2(tile[tile_at(k + 2 * t, 8 * ni + g)],
                        tile[tile_at(k + 2 * t + 1, 8 * ni + g)]);
      }
      split_tf32<false>(x.x, bh[ni][0], bl[ni][0]);
      split_tf32<false>(x.y, bh[ni][1], bl[ni][1]);
    }
  if (kSplit) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      if (ni < nt) mma_tf32(acc[ni], al, bh[ni]);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      if (ni < nt) mma_tf32(acc[ni], ah, bl[ni]);
  }
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
    if (ni < nt) mma_tf32(acc[ni], ah, bh[ni]);
}

// acc = A B over depth [0, K) (a multiple of 8), A rows m0.. of tile `a`,
// column groups < nt; summed from zero.
template <bool kAlongRow>
__device__ __forceinline__ void tile_product(Blk& acc, const float* a, int m0,
                                             const float* b, int K, int nt) {
  zero_blk(acc);
#pragma unroll 1
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    a_frag(ah, al, a, m0, k);
    mma_step<kAlongRow>(acc, ah, al, b, k, nt);
  }
}

// acc = Pm V: Pm the masked scores in registers (column groups < nt, the
// depth), V the rows of tile v; summed from zero.
__device__ __forceinline__ void score_product(Blk& acc, const Blk& pm,
                                              const float* v, int nt) {
  zero_blk(acc);
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
    if (ni < nt) {
      uint32_t ah[4], al[4];
      split_tf32<false>(pm[ni][0], ah[0], al[0]);   // row g, depth 2t
      split_tf32<false>(pm[ni][2], ah[1], al[1]);   // row g+8, depth 2t
      split_tf32<false>(pm[ni][1], ah[2], al[2]);   // row g, depth 2t+1
      split_tf32<false>(pm[ni][3], ah[3], al[3]);   // row g+8, depth 2t+1
      mma_step<false>(acc, ah, al, v, 8 * ni, 8);
    }
}

// Shared-memory tiles of the chunk kernel, each with its mbarrier: the
// entry state S_c (slot 0), then q_t, k_t, v_t of row tile t.
__device__ __forceinline__ int slot_q(int t) { return 1 + 3 * t; }
__device__ __forceinline__ int slot_k(int t) { return 2 + 3 * t; }
__device__ __forceinline__ int slot_v(int t) { return 3 + 3 * t; }
constexpr int kSlots = 1 + 3 * (kMaxQ / kT);

int chunk_smem_bytes(int Q) {
  const int tiles = 1 + 3 * ((Q + kT - 1) / kT);
  return 4 * tiles * kTile + 8 * (kMaxQ + 8 + kSlots) + 8 * kMaxQ;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_chunk_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  const int Qp = (a.Q + kT - 1) / kT * kT;
  float* tiles = reinterpret_cast<float*>(smem4);    // 1 + 3 Qp / 64 tiles
  double* cum2 = reinterpret_cast<double*>(tiles + (1 + 3 * Qp / kT) * kTile);
  double* scratch = cum2 + kMaxQ;                    // cum / ln 2, 8
  uint64_t* bar = reinterpret_cast<uint64_t*>(scratch + 8);   // kSlots
  float* ecum = reinterpret_cast<float*>(bar + kSlots);       // e^{cum_i}
  float* colf = ecum + kMaxQ;        // e^{cum_{j|15} - cum_j}, the note

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int p0 = blockIdx.y * kT, PT = min(kT, a.P - p0);
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  const int nT = (Qc + kT - 1) / kT;
  const int kN8 = (a.N + 7) & ~7;
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  const float* K = a.k + b * a.vk.b + h * a.vk.h + s0 * a.vk.s;
  const float* V = a.v + b * a.vv.b + h * a.vv.h + s0 * a.vv.s + p0;
  const float* Qm = a.q + b * a.vq.b + h * a.vq.h + s0 * a.vq.s;
  float* Y = a.y + b * a.vy.b + h * a.vy.h + s0 * a.vy.s + p0;

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) hopper::mbar_init(&bar[i], kThreads);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // every tile's copies issued now, in the order the warps first read
  // them: S, row tiles 0 and 1, the q of the later row tiles (each warp's
  // second slab opens with them), then their k and v
  auto copy = [&](int slot, const float* src, long long stride, int rows,
                  int cols, bool wide) {
    copy_tile(tiles + slot * kTile, src, stride, rows, cols, wide);
    hopper::cp_async_mbar_arrive(&bar[slot]);
  };
  auto rows_of = [&](int T) { return min(kT, Qc - T * kT); };
  copy(0, a.states + bhc * a.N * a.P + p0, a.P, a.N, PT, a.P % 4 == 0);
  for (int T = 0; T < min(nT, 2); ++T) {
    copy(slot_q(T), Qm + T * kT * a.vq.s, a.vq.s, rows_of(T), a.N, a.wq);
    copy(slot_k(T), K + T * kT * a.vk.s, a.vk.s, rows_of(T), a.N, a.wk);
    copy(slot_v(T), V + T * kT * a.vv.s, a.vv.s, rows_of(T), PT, a.wv);
  }
  for (int T = 2; T < nT; ++T)
    copy(slot_q(T), Qm + T * kT * a.vq.s, a.vq.s, rows_of(T), a.N, a.wq);
  for (int T = 2; T < nT; ++T) {
    copy(slot_k(T), K + T * kT * a.vk.s, a.vk.s, rows_of(T), a.N, a.wk);
    copy(slot_v(T), V + T * kT * a.vv.s, a.vv.s, rows_of(T), PT, a.wv);
  }

  // cum in double (kept as cum / ln 2 for exp2) and e^{cum_i}
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  cum2[tid] = cs * 1.4426950408889634;
  ecum[tid] = tid < Qc ? (float)exp(cs) : 0.f;
  __syncthreads();
  colf[tid] = (float)exp2(cum2[tid | 15] - cum2[tid]);
  __syncthreads();

  const float* S_ = tiles;
  const int nS = (Qc + 15) / 16;        // 16-row slabs of the chunk
  for (int pass = 0; pass < 2; ++pass) {
    const int s = pass == 0 ? warp : 2 * kWarps - 1 - warp;
    if (s >= nS) break;
    const int I = s >> 2, m0 = 16 * (s & 3), r0 = 16 * s;
    const float* q_ = tiles + slot_q(I) * kTile;
    const double cr[2] = {cum2[r0 + g], cum2[r0 + g + 8]};
    hopper::mbar_wait_bounded(&bar[0], 0);
    hopper::mbar_wait_bounded(&bar[slot_q(I)], 0);

    // the inter-chunk term e^{cum_i} q_i S_c
    Blk y;
    tile_product<false>(y, q_, m0, S_, kN8, 8);
#pragma unroll
    for (int no = 0; no < 8; ++no)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[no][e] *= ecum[r0 + g + 8 * (e >> 1)];

    for (int J = 0; J <= I; ++J) {
      const float* k_ = tiles + slot_k(J) * kTile;
      const float* v_ = tiles + slot_v(J) * kTile;
      hopper::mbar_wait_bounded(&bar[slot_k(J)], 0);
      hopper::mbar_wait_bounded(&bar[slot_v(J)], 0);
      // column groups at or below the diagonal
      const int nt = J < I ? 8 : 2 * (s & 3) + 2;
      Blk sc;
      tile_product<true>(sc, q_, m0, k_, kN8, nt);     // q_i . k_j
      // the decay mask: e^{cum_i - e_G} e^{e_G - cum_j} for a column j in
      // a 16-column group G before the slab's (e_G = cum at its last
      // column; both factors <= 1), e^{cum_i - cum_j} itself, for i >= j
      // only, in the slab's own group
      float rg[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          rg[m][hh] = 4 * J + m < s && r0 + g + 8 * hh < Qc
                      ? exp2f((float)(cr[hh] - cum2[64 * J + 16 * m + 15]))
                      : 0.f;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        if (ni < nt) {
          const int col0 = J * kT + 8 * ni + 2 * t;
          if (4 * J + (ni >> 1) < s) {
            const float2 cf = *reinterpret_cast<const float2*>(colf + col0);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[ni][e] *= rg[ni >> 1][e >> 1] * (e & 1 ? cf.y : cf.x);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = r0 + g + 8 * (e >> 1), col = col0 + (e & 1);
              sc[ni][e] = col <= r && r < Qc
                          ? sc[ni][e] * exp2f((float)(cr[e >> 1] - cum2[col]))
                          : 0.f;
            }
          }
        }
      Blk part;
      score_product(part, sc, v_, nt);
#pragma unroll
      for (int i = 0; i < 32; ++i) (&y[0][0])[i] += (&part[0][0])[i];
    }

#pragma unroll
    for (int no = 0; no < 8; ++no)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh, col = 8 * no + 2 * t;
        if (r >= Qc || col >= PT) continue;
        float* dst = Y + (long long)r * a.vy.s + col;
        if (a.wy) {
          *reinterpret_cast<float2*>(dst) =
              make_float2(y[no][2 * hh], y[no][2 * hh + 1]);
        } else {
          dst[0] = y[no][2 * hh];
          if (col + 1 < PT) dst[1] = y[no][2 * hh + 1];
        }
      }
  }
  // no thread leaves with copies in flight (each one's arrival is due)
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
}

// ---------------------------------------------------------------- wide
// The route for N > 64 (csrc/ssd_mma.cuh, "wide route").  One chunk's q
// and k no longer fit shared memory (a 64-row tile of q is 128 KB at N
// 512), so the chunk kernel's work is split in two launches:
// * ssd_fwd_scores_kernel, one block per (b, h, chunk, tile pair I >= J):
//   the masked scores M o (q_I k_J^T), summed over N in 64-wide slices,
//   into a Qp x Qp fp32 matrix a chunk (256 KB at Q 256);
// * ssd_fwd_wide_kernel, one block per (b, h, chunk, 64 columns of P, row
//   tile I): e^{cum_i} q_i S_c summed over N in slices, then the scores of
//   the pairs (I, J <= I) times v_J.
// Forming the scores once per chunk, rather than in each of the P tiles'
// blocks (9 at P 513), saves 8/9 of the scores' products -- at xLSTM's
// shape (N 512, P 513, Q 256) 2.1 of the forward's 21.5 GFLOP, recomputed
// 9 times they would be 19 GFLOP more -- for 16.8 MB of scores written
// and read back (B 2, H 4, S 2048).  Every product is 3xTF32, each 64-deep
// slice summed from zero and added in fp32.

// Shared memory of the wide route's kernels: the ring, then e^{cum} (or
// cum / ln 2) and a scan's scratch.
constexpr int kWideSmem = kRingSmem + 8 * (kMaxQ + 8);

__global__ void __launch_bounds__(kThreads)
ssd_fwd_scores_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* at = reinterpret_cast<float*>(smem4);   // q_I slices, ring stages
  float* bt = at + 2 * kTile;                    // k_J slices
  double* cum2 = reinterpret_cast<double*>(bt + 2 * kTile);  // cum / ln 2
  double* scratch = cum2 + kMaxQ;

  const int tid = threadIdx.x, m0 = wide_m0(), n0 = wide_n0();
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  int I, J;
  tile_pair(blockIdx.y, I, J);
  if (I * kT >= Qc) return;            // a ragged last chunk has fewer tiles
  const int rI = min(kT, Qc - I * kT), rJ = min(kT, Qc - J * kT);
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  const float* Qi = a.q + b * a.vq.b + h * a.vq.h + (s0 + I * kT) * a.vq.s;
  const float* Kj = a.k + b * a.vk.b + h * a.vk.h + (s0 + J * kT) * a.vk.s;
  auto issue = [&](int s) {
    const int n = s * kT, cols = min(kT, a.N - n);
    copy_tile<true>(at + (s & 1) * kTile, Qi + n, a.vq.s, rI, cols, a.wq);
    copy_tile<true>(bt + (s & 1) * kTile, Kj + n, a.vk.s, rJ, cols, a.wk);
    hopper::cp_async_commit();
  };
  issue(0);
  cum2[tid] = block_scan(log_decay(A, a.va.s, tid, Qc), scratch)
              * 1.4426950408889634;
  Acc<2, 2> sc;
  zero_acc(sc);
  ring((a.N + kT - 1) / kT, issue, [&](int s) {      // q_I k_J^T
    mm3<kSplit>(sc, Rows{at + (s & 1) * kTile}, Cols{bt + (s & 1) * kTile},
                m0, n0, 0, kT);
  });
  // the decay mask e^{cum_i - cum_j}, formed where i >= j only
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = I * kT + frag_row(m0, mi, e);
        const int col = J * kT + frag_col(n0, ni, e);
        sc[mi][ni][e] = col <= r && r < Qc
            ? sc[mi][ni][e] * exp2f((float)(cum2[r] - cum2[col])) : 0.f;
      }
  store_block(a.scores + bhc * a.Qp * a.Qp + (long long)I * kT * a.Qp
              + J * kT, sc, a.Qp, m0, n0, kT, kT);
}

__global__ void __launch_bounds__(kThreads) ssd_fwd_wide_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* at = reinterpret_cast<float*>(smem4);   // q_I slices, then scores
  float* bt = at + 2 * kTile;                    // S_c slices, then v_J
  double* scratch = reinterpret_cast<double*>(bt + 2 * kTile);
  float* ecum = reinterpret_cast<float*>(scratch + 8);   // e^{cum_i}

  const int tid = threadIdx.x, m0 = wide_m0(), n0 = wide_n0();
  const long long bhc = blockIdx.x, bh = bhc / a.nc;
  const int c = (int)(bhc % a.nc), b = (int)(bh / a.H), h = (int)(bh % a.H);
  const int p0 = blockIdx.y * kT, PT = min(kT, a.P - p0), I = blockIdx.z;
  const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
  if (I * kT >= Qc) return;
  const int rI = min(kT, Qc - I * kT), nN = (a.N + kT - 1) / kT;
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  const float* Qi = a.q + b * a.vq.b + h * a.vq.h + (s0 + I * kT) * a.vq.s;
  const float* V = a.v + b * a.vv.b + h * a.vv.h + s0 * a.vv.s + p0;
  const float* St = a.states + bhc * a.N * a.P + p0;
  const float* Sc = a.scores + bhc * a.Qp * a.Qp + (long long)I * kT * a.Qp;
  // steps [0, nN): q_I and S_c over a slice of N; then [nN, nN + I]: the
  // scores of (I, J) and v_J, J = step - nN
  auto issue = [&](int s) {
    float* x = at + (s & 1) * kTile;
    float* z = bt + (s & 1) * kTile;
    if (s < nN) {
      const int n = s * kT, rows = min(kT, a.N - n);
      copy_tile<true>(x, Qi + n, a.vq.s, rI, rows, a.wq);
      copy_tile<true>(z, St + (long long)n * a.P, a.P, rows, PT, a.wS);
    } else {
      const int J = s - nN;
      copy_tile<true>(x, Sc + J * kT, a.Qp, kT, kT, true);
      copy_tile<true>(z, V + (long long)J * kT * a.vv.s, a.vv.s,
                min(kT, Qc - J * kT), PT, a.wv);
    }
    hopper::cp_async_commit();
  };
  issue(0);
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  ecum[tid] = tid < Qc ? (float)exp(cs) : 0.f;
  Acc<2, 2> y;
  zero_acc(y);
  ring(nN + I + 1, issue, [&](int s) {
    mm3<kSplit>(y, Rows{at + (s & 1) * kTile}, Rows{bt + (s & 1) * kTile},
                m0, n0, 0, kT);
    if (s == nN - 1) {                 // e^{cum_i} q_i S_c
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[mi][ni][e] *= ecum[I * kT + frag_row(m0, mi, e)];
    }
  });
  store_block(a.y + b * a.vy.b + h * a.vy.h + (s0 + I * kT) * a.vy.s + p0, y,
              (int)a.vy.s, m0, n0, rI, PT);
}

bool aligned(const float* p, long long sb, long long sh, long long ss,
             int cols, int elems) {
  return reinterpret_cast<uintptr_t>(p) % (4 * elems) == 0
         && sb % elems == 0 && sh % elems == 0 && ss % elems == 0
         && cols % elems == 0;
}

// Doubles of the `work` buffer ssd_scan_fwd_launch needs: each chunk's
// sum dS_c and e^{cum_L}, and for N > 64 (the wide route) each chunk's
// Qp x Qp fp32 scores after them, 16-byte aligned.
long long fwd_work(long long chunks, int N, int P, int Q) {
  const long long sums = chunks * ((long long)N * P + 1);
  if (N <= kT) return sums;
  const long long Qp = (Q + kT - 1) / kT * kT;
  return (sums + 1) / 2 * 2 + chunks * Qp * Qp / 2;
}

}  // namespace

extern "C" long long ssd_scan_fwd_work(int B, int H, int S, int N, int P,
                                       int Q) {
  return fwd_work((long long)B * H * ((S + Q - 1) / Q), N, P, Q);
}

// Strides are element strides of the (B, H, S) axes of a, k, v, q and y;
// the last axis of k, v, q, y has unit stride.  init (B,H,N,P) may be
// null; final_state (B,H,N,P) and states (B,H,nc,N,P) are contiguous and
// both written; work holds ssd_scan_fwd_work(B, H, S, N, P, Q) doubles.
// Any N and P, 1 <= Q <= 256: N <= 64 takes the chunk kernel, N > 64 the
// wide route.  Three launches on `stream` (four on the wide route).
// Returns a CUDA error code (0 on success).
extern "C" int ssd_scan_fwd_launch(
    const float* a, const float* k, const float* v, const float* q,
    const float* init, float* y, float* final_state, float* states,
    double* work,
    long long ab, long long ah, long long as,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long qb, long long qh, long long qs,
    long long yb, long long yh, long long ys,
    int B, int H, int S, int N, int P, int Q, void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || P < 1 || Q < 1 || Q > kMaxQ
      || states == nullptr || work == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const long long chunks = (long long)B * H * nc;
  const bool wide = N > kT;
  const int nT = (Q + kT - 1) / kT;
  float* scores = wide ? reinterpret_cast<float*>(
      work + (chunks * ((long long)N * P + 1) + 1) / 2 * 2) : nullptr;
  // the wide route's own kernels copy a ragged last group of columns 16
  // bytes at a time too (copy_tile<true>), so only the rows' alignment
  // counts there; the sums kernel copies a ragged tile 4 bytes at a time
  FwdArgs args{a, k, v, q, init, y, final_state, states,
               work, work + chunks * N * P,
               {ab, ah, as}, {kb, kh, ks}, {vb, vh, vs}, {qb, qh, qs},
               {yb, yh, ys}, H, S, N, P, Q, nc,
               aligned(k, kb, kh, ks, wide ? 0 : N, 4),
               aligned(v, vb, vh, vs, wide ? 0 : P, 4),
               aligned(q, qb, qh, qs, wide ? 0 : N, 4),
               aligned(y, yb, yh, ys, P, 2),
               scores, nT * kT, P % 4 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = chunk_smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSumsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_fwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_fwd_scores_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWideSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_fwd_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWideSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N * P + kThreads - 1) / kThreads;
  const int ptiles = (P + kT - 1) / kT, ntiles = (N + kT - 1) / kT;
  if (chunks > 0x7fffffffLL || (long long)B * H * blocks > 0x7fffffffLL
      || ptiles > 65535 || ntiles > 65535)
    return (int)cudaErrorInvalidValue;
  ssd_fwd_sums_kernel<<<dim3((unsigned)chunks, ptiles, ntiles), kThreads,
                        kSumsSmem, st>>>(args);
  ssd_fwd_carry_kernel<<<(unsigned)(B * H * blocks), kThreads, 0, st>>>(
      args, blocks);
  if (!wide) {
    ssd_fwd_chunk_kernel<<<dim3((unsigned)chunks, ptiles), kThreads, smem,
                           st>>>(args);
  } else {
    ssd_fwd_scores_kernel<<<dim3((unsigned)chunks, nT * (nT + 1) / 2),
                            kThreads, kWideSmem, st>>>(args);
    ssd_fwd_wide_kernel<<<dim3((unsigned)chunks, ptiles, nT), kThreads,
                          kWideSmem, st>>>(args);
  }
  return (int)cudaGetLastError();
}
