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
//
// A state wider than one tile (N or P > 64: xLSTM's mLSTM, N 512, P 513 at
// B 2, H 4, S 2048, Q 256) takes the wide route: the sums kernel gains
// grid axes over tiles of P and N, and the chunk kernel's work goes to
// five launches (the "wide" section below).  45.2 GFLOP of useful work
// there: 0.675 ms at the fp32 FMA rate, 0.274 ms at the 3xTF32 tensor
// rate, against 0.093 ms to move its bytes.

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
  // the wide route only: Z's row sums rz (B, H, nc, nT, Qp) by column tile
  // and column sums cz by row tile, X's and Y's partials xp, yp (B, H, nc,
  // nN, Qp) by tile of N, and M o (dy v^T), M o (q k^T) (B, H, nc, Qp, Qp)
  double* rz; double* cz; double* xp; double* yp;
  float* md; float* ms;
  int Qp, nN;              // Q rounded up to a whole tile; tiles of N
  bool wS;                 // 16-byte copies of the states (P % 4 == 0)
};

// ---------------------------------------------------------------- sums
// U_c = sum_i e^{cum_i} q_i dy_i^T (64 rows of N x 64 columns of P) in fp64
// on DMMA, and e^{cum_L}, for one (b, h, chunk, column tile, row tile).
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
  const int p0 = blockIdx.y * kT, PT = min(kT, a.P - p0);
  const int n0 = blockIdx.z * kT, NT = min(kT, a.N - n0);
  const float* A = a.a + b * a.va.b + h * a.va.h + s0 * a.va.s;
  // 16-byte copies of a tile whose width is a multiple of 4 (on the wide
  // route the flags check only the rows' alignment)
  const Rows64 x{a.q + b * a.vq.b + h * a.vq.h + s0 * a.vq.s + n0, a.vq.s,
                 NT, a.wq && NT % 4 == 0};
  const Rows64 y{a.dy + b * a.vdy.b + h * a.vdy.h + s0 * a.vdy.s + p0,
                 a.vdy.s, PT, a.wdy && PT % 4 == 0};
  issue_rows(qt, yt, x, y, 0, Qc);
  const double cs = block_scan(log_decay(A, a.va.s, tid, Qc), scratch);
  e[tid] = tid < Qc ? exp(cs) : 0.0;
  if (tid == Qc - 1 && blockIdx.y == 0 && blockIdx.z == 0)
    a.decay[bhc] = exp(cs);
  outer_sum_f64(qt, yt, yd, e, x, y, Qc,
                a.carry + bhc * a.N * a.P + (long long)n0 * a.P + p0, a.P, NT,
                PT);
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
        mm3_exact<kSplit>(g, Rows{v_}, Cols{dst}, qm, qn, kP8);  // v_J dS^T
        row_dots(ypart + (qn >> 5) * kT, Rows{k_}, g, qm, qn);
      } else {
        zero_acc(g);
        mm3<kSplit>(g, Rows{k_}, Rows{dst}, qm, qn, 0, kN8);     // k_J dS
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
      mm3_exact<kSplit>(tq, Rows{y_}, Cols{st}, hm, hn, kP8);  // dy_I S^T
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
        if (grp == 0) mm3_exact<kSplit>(sc, Rows{y_}, Cols{v_}, qm, qn, kP8);
        else mm3_exact<kSplit>(sc, Rows{q_}, Cols{k_}, qm, qn, kN8);
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
    if (grp == 0)
      mm3<kSplit>(g, Cols{md}, Rows{q_}, qm, qn, diag ? qm : 0, kT);
    else
      mm3<kSplit>(g, Cols{ms}, Rows{y_}, qm, qn, diag ? qm : 0, kT);
    {
      Acc<2, 2> gq;
      load_block(gq, DQ + I * kT * a.N, a.N, hm, hn, rI, a.N);
      mm3<kSplit>(gq, Rows{md}, Rows{k_}, hm, hn, 0, diag ? hm + 32 : kT);
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

// ---------------------------------------------------------------- wide
// The route for N or P above 64 (csrc/ssd_mma.cuh, "wide route"): one
// chunk's tiles no longer fit shared memory, and each score sums over a
// whole axis (q_i . k_j over N, dy_i . v_j over P), so the chunk kernel's
// work is split by what each output needs, five launches after the sums
// and the carry:
// * ssd_bwd_scores_kernel, one block per (b, h, chunk, tile pair I >= J):
//   both raw scores, dy_I v_J^T over P and q_I k_J^T over N in 64-wide
//   slices, masked into M o D and M o Sc (Qp x Qp fp32 a chunk), and Z's
//   row and column sums over the pair, in double;
// * ssd_bwd_dq_kernel, one block per (b, h, chunk, row tile I, tile of N):
//   e^{cum_i} S dy_i summed over P in slices (X's partial over the tile of
//   N from it), then (M o D)_IJ k_J for J <= I;
// * ssd_bwd_dk_kernel, per (b, h, chunk, column tile J, tile of N): w_j dS
//   v_j over P in slices (Y's partial), then (M o D)_IJ^T q_I for I >= J;
// * ssd_bwd_dv_kernel, per (b, h, chunk, column tile J, tile of P): w_j
//   dS^T k_j over N in slices, then (M o Sc)_IJ^T dy_I for I >= J;
// * ssd_bwd_dla_kernel, one block per (b, h, chunk): <dS, S>, then R, C, X
//   and Y summed from their partials and d(log a)'s two scans, as the
//   chunk kernel's end.
// Every partial is written by one block to a place of its own and summed
// by another in a fixed order: no atomics, the same bits on every run.
// The products whose roundings reach d(log a) -- both scores (Z), S dy (X)
// and dS v (Y, from the fp64 dS) -- run in fp64 on DMMA (mm_f64), with the
// decay mask in double: summed 512 and 513 deep, and then over a chunk's
// 256 positions by d(log a)'s scans, fp32 products left d(log a) 5e-4
// from float64 with decays near 1 (H100, xLSTM's shape).  dq, dk and dv
// take those in fp32; their other products are 3xTF32, each 64-deep slice
// summed from zero and added in fp32.

// Shared memory of the wide route's kernels: the ring, one more tile, e^{cum}
// and w, cum, a scan's scratch and the per-warp partials; the dk kernel's
// also a two-stage ring of fp64 dS tiles.
constexpr int kWideSmem = kRingSmem + 4 * kTile + 4 * 2 * kMaxQ
                          + 8 * (kMaxQ + 8 + 6 * kT);
constexpr int kWideDkSmem = kWideSmem + 8 * 2 * kT * kLdD;

struct WideSmem {
  float* at; float* bt;    // the ring's A and B tiles, two stages each
  float* xt;               // one more tile
  float* ecum; float* wdec;
  double* cum; double* scratch; double* part;   // part: [6][64]
  double* dd;              // the dk kernel's fp64 ring (two kT x kLdD)
};

__device__ __forceinline__ WideSmem wide_smem(float4* smem4) {
  WideSmem s;
  s.at = reinterpret_cast<float*>(smem4);
  s.bt = s.at + 2 * kTile;
  s.xt = s.bt + 2 * kTile;
  s.ecum = s.xt + kTile;
  s.wdec = s.ecum + kMaxQ;
  s.cum = reinterpret_cast<double*>(s.wdec + kMaxQ);
  s.scratch = s.cum + kMaxQ;
  s.part = s.scratch + 8;
  s.dd = s.part + 6 * kT;
  return s;
}

// cum (double), e^{cum} and w = e^{cum_L - cum} (fp32, 0 past the chunk)
// of the chunk at A, into shared memory; returns cum_L.  Every thread.
__device__ __forceinline__ double chunk_decays(const WideSmem& s,
                                               const float* A, long long st,
                                               int Qc) {
  const int tid = threadIdx.x;
  const double cs = block_scan(log_decay(A, st, tid, Qc), s.scratch);
  s.cum[tid] = cs;
  __syncthreads();
  const double cL = s.cum[Qc - 1];
  s.ecum[tid] = tid < Qc ? expf((float)cs) : 0.f;
  s.wdec[tid] = tid < Qc ? expf((float)(cL - cs)) : 0.f;
  return cL;
}

// x = u rounded to fp32 (scaled by f[row], if given).
template <int MT, int NT>
__device__ __forceinline__ void to_f32(Acc<MT, NT>& x,
                                       const double (&u)[MT][NT][4],
                                       const float* f, int m0) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[mi][ni][e] = (float)(f == nullptr ? u[mi][ni][e]
                               : u[mi][ni][e] * f[frag_row(m0, mi, e)]);
}

// Rows [0, rows) and columns [0, cols) of an fp64 matrix (row stride
// `stride`) into an fp64 tile (row r at r * kLdD), zeros elsewhere; plain
// loads and stores by the whole block.
__device__ __forceinline__ void load_tile_d(double* dst, const double* src,
                                            long long stride, int rows,
                                            int cols) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int r = i >> 6, c = i & 63;
    dst[r * kLdD + c] = r < rows && c < cols ? src[r * stride + c] : 0.0;
  }
}

// The block's (b, h, chunk) and where its chunk starts.
struct ChunkAt {
  long long bhc, bh;
  int b, h, s0, Qc;
};

__device__ __forceinline__ ChunkAt chunk_at(const BwdArgs& a) {
  ChunkAt c;
  c.bhc = blockIdx.x;
  c.bh = c.bhc / a.nc;
  const int ch = (int)(c.bhc % a.nc);
  c.b = (int)(c.bh / a.H);
  c.h = (int)(c.bh % a.H);
  c.s0 = ch * a.Q;
  c.Qc = min(a.Q, a.S - c.s0);
  return c;
}

// Row t (of the chunk) of a (B, H, S, .) input.
__device__ __forceinline__ const float* row_of(const float* p, View v,
                                               const ChunkAt& c, int t) {
  return p + c.b * v.b + c.h * v.h + (c.s0 + t) * v.s;
}

__global__ void __launch_bounds__(kThreads)
ssd_bwd_scores_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const WideSmem sm = wide_smem(smem4);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = wide_m0(), n0 = wide_n0();
  const ChunkAt ch = chunk_at(a);
  int I, J;
  tile_pair(blockIdx.y, I, J);
  if (I * kT >= ch.Qc) return;         // a ragged last chunk has fewer tiles
  const int rI = min(kT, ch.Qc - I * kT), rJ = min(kT, ch.Qc - J * kT);
  const int nP = (a.P + kT - 1) / kT;
  const float* DYi = row_of(a.dy, a.vdy, ch, I * kT);
  const float* Vj = row_of(a.v, a.vv, ch, J * kT);
  const float* Qi = row_of(a.q, a.vq, ch, I * kT);
  const float* Kj = row_of(a.k, a.vk, ch, J * kT);
  // steps [0, nP): dy_I and v_J over a slice of P; then q_I and k_J over
  // the slices of N
  auto issue = [&](int s) {
    float* x = sm.at + (s & 1) * kTile;
    float* z = sm.bt + (s & 1) * kTile;
    if (s < nP) {
      const int p = s * kT, cols = min(kT, a.P - p);
      copy_tile<true>(x, DYi + p, a.vdy.s, rI, cols, a.wdy);
      copy_tile<true>(z, Vj + p, a.vv.s, rJ, cols, a.wv);
    } else {
      const int n = (s - nP) * kT, cols = min(kT, a.N - n);
      copy_tile<true>(x, Qi + n, a.vq.s, rI, cols, a.wq);
      copy_tile<true>(z, Kj + n, a.vk.s, rJ, cols, a.wk);
    }
    hopper::cp_async_commit();
  };
  issue(0);
  chunk_decays(sm, row_of(a.a, a.va, ch, 0), a.va.s, ch.Qc);
  double d[2][2][4] = {}, sc[2][2][4] = {};        // dy_I v_J^T, q_I k_J^T
  ring(nP + a.nN, issue, [&](int s) {
    const Rows x{sm.at + (s & 1) * kTile};
    const Cols z{sm.bt + (s & 1) * kTile};
    if (s < nP) mm_f64(d, x, z, m0, n0, kT);
    else mm_f64(sc, x, z, m0, n0, kT);
  });
  // M o D and M o Sc (rounded to fp32 for dq, dk, dv) and Z = M D Sc, in
  // double; M = e^{cum_i - cum_j}, formed where i >= j only
  Acc<2, 2> md, ms;
  double zr[2][2] = {}, zc[2][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = I * kT + frag_row(m0, mi, e);
        const int cc = J * kT + frag_col(n0, ni, e);
        const double m = cc <= r && r < ch.Qc
                         ? exp(sm.cum[r] - sm.cum[cc]) : 0.0;
        const double dm = d[mi][ni][e] * m, s = sc[mi][ni][e];
        const double z = dm * s;
        zr[mi][e >> 1] += z;
        zc[ni][e & 1] += z;
        md[mi][ni][e] = (float)dm;
        ms[mi][ni][e] = (float)(s * m);
      }
  const long long tile = ch.bhc * a.Qp * a.Qp + (long long)I * kT * a.Qp
                         + J * kT;
  store_block(a.md + tile, md, a.Qp, m0, n0, kT, kT);
  store_block(a.ms + tile, ms, a.Qp, m0, n0, kT, kT);
  double* rpart = sm.part;             // [4][64]: by warp column quarter
  double* cpart = sm.part + 4 * kT;    // [2][64]: by warp row half
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      double x = zr[mi][hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (t == 0) rpart[(warp & 3) * kT + frag_row(m0, mi, 2 * hh)] = x;
    }
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      double x = zc[ni][j];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) cpart[(warp >> 2) * kT + frag_col(n0, ni, j)] = x;
    }
  __syncthreads();
  const int nT = a.Qp / kT;
  sum_parts(a.rz + (ch.bhc * nT + J) * a.Qp + I * kT, rpart, 4, rI);
  sum_parts(a.cz + (ch.bhc * nT + I) * a.Qp + J * kT, cpart, 2, rJ);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const WideSmem sm = wide_smem(smem4);
  const int warp = threadIdx.x >> 5, m0 = wide_m0(), n0 = wide_n0();
  const ChunkAt ch = chunk_at(a);
  const int I = blockIdx.y, nt = blockIdx.z;
  if (I * kT >= ch.Qc) return;
  const int rI = min(kT, ch.Qc - I * kT), nP = (a.P + kT - 1) / kT;
  const int c0 = nt * kT, NT = min(kT, a.N - c0);
  const float* DYi = row_of(a.dy, a.vdy, ch, I * kT);
  const float* St = a.states + ch.bhc * a.N * a.P + (long long)c0 * a.P;
  const float* K = row_of(a.k, a.vk, ch, 0) + c0;
  const float* MD = a.md + ch.bhc * a.Qp * a.Qp + (long long)I * kT * a.Qp;
  // steps [0, nP): dy_I and S over a slice of P; then (M o D)_IJ and k_J,
  // J = step - nP
  auto issue = [&](int s) {
    float* x = sm.at + (s & 1) * kTile;
    float* z = sm.bt + (s & 1) * kTile;
    if (s < nP) {
      const int p = s * kT, cols = min(kT, a.P - p);
      copy_tile<true>(x, DYi + p, a.vdy.s, rI, cols, a.wdy);
      copy_tile<true>(z, St + p, a.P, NT, cols, a.wS);
    } else {
      const int J = s - nP;
      copy_tile<true>(x, MD + J * kT, a.Qp, kT, kT, true);
      copy_tile<true>(z, K + (long long)J * kT * a.vk.s, a.vk.s,
                min(kT, ch.Qc - J * kT), NT, a.wk);
    }
    hopper::cp_async_commit();
  };
  copy_tile<true>(sm.xt, row_of(a.q, a.vq, ch, I * kT) + c0, a.vq.s, rI,
                  NT, a.wq);
  issue(0);
  chunk_decays(sm, row_of(a.a, a.va, ch, 0), a.va.s, ch.Qc);
  Acc<2, 2> x;
  double u[2][2][4] = {};              // dy_I S^T, in fp64
  ring(nP + I + 1, issue, [&](int s) {
    const float* A_ = sm.at + (s & 1) * kTile;
    const float* B_ = sm.bt + (s & 1) * kTile;
    if (s < nP) {
      mm_f64(u, Rows{A_}, Cols{B_}, m0, n0, kT);
      if (s == nP - 1) {               // X's partial, then e^{cum_i} S dy_i
        row_dots(sm.part + (warp & 3) * kT, Rows{sm.xt}, u, m0, n0);
        to_f32(x, u, sm.ecum + I * kT, m0);
      }
    } else {                           // (M o D)_IJ k_J
      mm3<kSplit>(x, Rows{A_}, Rows{B_}, m0, n0, 0, kT);
    }
  });
  sum_parts(a.xp + (ch.bhc * a.nN + nt) * a.Qp + I * kT, sm.part, 4, rI);
  store_block(a.dq + (ch.bh * a.S + ch.s0 + I * kT) * a.N + c0, x, a.N, m0,
              n0, rI, NT);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_dk_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const WideSmem sm = wide_smem(smem4);
  const int warp = threadIdx.x >> 5, m0 = wide_m0(), n0 = wide_n0();
  const ChunkAt ch = chunk_at(a);
  const int J = blockIdx.y, nt = blockIdx.z;
  if (J * kT >= ch.Qc) return;
  const int rJ = min(kT, ch.Qc - J * kT), nP = (a.P + kT - 1) / kT;
  const int nTc = (ch.Qc + kT - 1) / kT;
  const int c0 = nt * kT, NT = min(kT, a.N - c0);
  const float* Vj = row_of(a.v, a.vv, ch, J * kT);
  const double* dS = a.carry + ch.bhc * a.N * a.P + (long long)c0 * a.P;
  const float* Qm = row_of(a.q, a.vq, ch, 0) + c0;
  const float* MD = a.md + ch.bhc * a.Qp * a.Qp + J * kT;
  // steps [0, nP): v_J and dS over a slice of P; then (M o D)_IJ and q_I,
  // I = J + step - nP
  auto issue = [&](int s) {
    float* x = sm.at + (s & 1) * kTile;
    float* z = sm.bt + (s & 1) * kTile;
    if (s < nP) {
      const int p = s * kT, cols = min(kT, a.P - p);
      copy_tile<true>(x, Vj + p, a.vv.s, rJ, cols, a.wv);
      load_tile_d(sm.dd + (s & 1) * kT * kLdD, dS + p, a.P, NT, cols);
    } else {
      const int I = J + s - nP;
      copy_tile<true>(x, MD + (long long)I * kT * a.Qp, a.Qp, kT, kT, true);
      copy_tile<true>(z, Qm + (long long)I * kT * a.vq.s, a.vq.s,
                min(kT, ch.Qc - I * kT), NT, a.wq);
    }
    hopper::cp_async_commit();
  };
  copy_tile<true>(sm.xt, row_of(a.k, a.vk, ch, J * kT) + c0, a.vk.s, rJ,
                  NT, a.wk);
  issue(0);
  chunk_decays(sm, row_of(a.a, a.va, ch, 0), a.va.s, ch.Qc);
  Acc<2, 2> x;
  double u[2][2][4] = {};              // v_J dS^T, in fp64
  ring(nP + nTc - J, issue, [&](int s) {
    const float* A_ = sm.at + (s & 1) * kTile;
    const float* B_ = sm.bt + (s & 1) * kTile;
    if (s < nP) {
      mm_f64(u, Rows{A_}, ColsD{sm.dd + (s & 1) * kT * kLdD}, m0, n0, kT);
      if (s == nP - 1) {               // Y's partial, then w_j dS v_j
        row_dots(sm.part + (warp & 3) * kT, Rows{sm.xt}, u, m0, n0);
        to_f32(x, u, sm.wdec + J * kT, m0);
      }
    } else {                           // (M o D)_IJ^T q_I
      mm3<kSplit>(x, Cols{A_}, Rows{B_}, m0, n0, 0, kT);
    }
  });
  sum_parts(a.yp + (ch.bhc * a.nN + nt) * a.Qp + J * kT, sm.part, 4, rJ);
  store_block(a.dk + (ch.bh * a.S + ch.s0 + J * kT) * a.N + c0, x, a.N, m0,
              n0, rJ, NT);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_dv_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const WideSmem sm = wide_smem(smem4);
  const int m0 = wide_m0(), n0 = wide_n0();
  const ChunkAt ch = chunk_at(a);
  const int J = blockIdx.y, p0 = blockIdx.z * kT, PT = min(kT, a.P - p0);
  if (J * kT >= ch.Qc) return;
  const int rJ = min(kT, ch.Qc - J * kT), nTc = (ch.Qc + kT - 1) / kT;
  const float* Kj = row_of(a.k, a.vk, ch, J * kT);
  const double* dS = a.carry + ch.bhc * a.N * a.P + p0;
  const float* DY = row_of(a.dy, a.vdy, ch, 0) + p0;
  const float* MS = a.ms + ch.bhc * a.Qp * a.Qp + J * kT;
  // steps [0, nN): k_J and dS over a slice of N; then (M o Sc)_IJ and
  // dy_I, I = J + step - nN
  auto issue = [&](int s) {
    float* x = sm.at + (s & 1) * kTile;
    float* z = sm.bt + (s & 1) * kTile;
    if (s < a.nN) {
      const int n = s * kT, rows = min(kT, a.N - n);
      copy_tile<true>(x, Kj + n, a.vk.s, rJ, rows, a.wk);
      load_tile_f64(z, dS + (long long)n * a.P, a.P, rows, PT);
    } else {
      const int I = J + s - a.nN;
      copy_tile<true>(x, MS + (long long)I * kT * a.Qp, a.Qp, kT, kT, true);
      copy_tile<true>(z, DY + (long long)I * kT * a.vdy.s, a.vdy.s,
                min(kT, ch.Qc - I * kT), PT, a.wdy);
    }
    hopper::cp_async_commit();
  };
  issue(0);
  chunk_decays(sm, row_of(a.a, a.va, ch, 0), a.va.s, ch.Qc);
  Acc<2, 2> x;
  zero_acc(x);
  ring(a.nN + nTc - J, issue, [&](int s) {
    const float* A_ = sm.at + (s & 1) * kTile;
    const float* B_ = sm.bt + (s & 1) * kTile;
    if (s < a.nN) {                    // k_J dS, then w_j dS^T k_j
      mm3<kSplit>(x, Rows{A_}, Rows{B_}, m0, n0, 0, kT);
      if (s == a.nN - 1) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x[mi][ni][e] *= sm.wdec[J * kT + frag_row(m0, mi, e)];
      }
    } else {                           // (M o Sc)_IJ^T dy_I
      mm3<kSplit>(x, Cols{A_}, Rows{B_}, m0, n0, 0, kT);
    }
  });
  store_block(a.dv + (ch.bh * a.S + ch.s0 + J * kT) * a.P + p0, x, a.P, m0,
              n0, rJ, PT);
}

__global__ void __launch_bounds__(kThreads) ssd_bwd_dla_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  const WideSmem sm = wide_smem(smem4);
  double* fsum = reinterpret_cast<double*>(sm.at);   // R_i - C_i + X_i
  double* ysum = fsum + kMaxQ;                       // Y_j
  const int tid = threadIdx.x;
  const ChunkAt ch = chunk_at(a);
  const float* A = row_of(a.a, a.va, ch, 0);
  const double cL = chunk_decays(sm, A, a.va.s, ch.Qc);
  // <dS, S>
  const long long NP = (long long)a.N * a.P;
  const float* S_ = a.states + ch.bhc * NP;
  const double* dS = a.carry + ch.bhc * NP;
  double part = 0.0;
  for (long long i = tid; i < NP; i += kThreads)
    part = fma(dS[i], (double)S_[i], part);
  const double ds_prev = block_sum(part, sm.scratch);   // syncs
  // position t's terms from their partials, in a fixed order
  const int nT = a.Qp / kT, nTc = (ch.Qc + kT - 1) / kT;
  double f = 0.0, y = 0.0;
  if (tid < ch.Qc) {
    const int T = tid / kT;
    for (int J = 0; J <= T; ++J) f += a.rz[(ch.bhc * nT + J) * a.Qp + tid];
    for (int I = T; I < nTc; ++I) f -= a.cz[(ch.bhc * nT + I) * a.Qp + tid];
    double xs = 0.0, ys = 0.0;
    for (int n = 0; n < a.nN; ++n) {
      xs += a.xp[(ch.bhc * a.nN + n) * a.Qp + tid];
      ys += a.yp[(ch.bhc * a.nN + n) * a.Qp + tid];
    }
    f += (double)sm.ecum[tid] * xs;
    y = (double)sm.wdec[tid] * ys;
  }
  fsum[tid] = f;
  __syncthreads();
  // as the chunk kernel's end: thread t scans position Qc-1-t for the
  // first sum and position t for the second
  const int idx = ch.Qc - 1 - tid;
  const double after = block_scan(idx >= 0 ? fsum[idx] : 0.0, sm.scratch);
  const double before = block_scan(y, sm.scratch) - y;
  ysum[tid] = before;
  const double dec = exp(cL);
  __syncthreads();
  if (idx >= 0) {
    const double dla = after + dec * ds_prev + ysum[idx];
    const float av = A[idx * a.va.s];
    a.da[ch.bh * a.S + ch.s0 + idx] = av > kMinA ? (float)(dla / av) : 0.f;
  }
}

bool aligned(const float* p, long long sb, long long sh, long long ss,
             int cols) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0
         && sh % 4 == 0 && ss % 4 == 0 && cols % 4 == 0;
}

// The parts of the `work` buffer (in doubles, after the U_c / dS_c carry
// and e^{cum_L}): the wide route's partials and scores, each 16-byte
// aligned.
struct WorkParts {
  long long rz, cz, xp, yp, md, ms, total;
};

WorkParts work_parts(long long chunks, int N, int P, int Q) {
  WorkParts w{};
  long long at = chunks * ((long long)N * P + 1);
  if (N > kT || P > kT) {
    const long long Qp = (Q + kT - 1) / kT * kT, nN = (N + kT - 1) / kT;
    at = (at + 1) / 2 * 2;
    w.rz = at;  at += chunks * (Qp / kT) * Qp;
    w.cz = at;  at += chunks * (Qp / kT) * Qp;
    w.xp = at;  at += chunks * nN * Qp;
    w.yp = at;  at += chunks * nN * Qp;
    w.md = at;  at += chunks * Qp * Qp / 2;
    w.ms = at;  at += chunks * Qp * Qp / 2;
  }
  w.total = at;
  return w;
}

}  // namespace

extern "C" long long ssd_scan_bwd_work(int B, int H, int S, int N, int P,
                                       int Q) {
  return work_parts((long long)B * H * ((S + Q - 1) / Q), N, P, Q).total;
}

// Strides as in ssd_scan_fwd_launch, for a, k, v, q and dy; states
// (B,H,nc,N,P), dfinal (B,H,N,P) and the outputs da (B,H,S),
// dk, dq (B,H,S,N), dv (B,H,S,P) and dinit (B,H,N,P) contiguous; work
// holds ssd_scan_bwd_work(B, H, S, N, P, Q) doubles.  Any N and P, 1 <= Q
// <= 256: N, P <= 64 take the chunk kernel, the rest the wide route.
// dfinal and dinit may be null.  Three launches on `stream` (seven on the
// wide route).  Returns a CUDA error code (0 on success).
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
  if (B < 1 || H < 1 || S < 1 || N < 1 || P < 1 || Q < 1 || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + Q - 1) / Q;
  const long long chunks = (long long)B * H * nc;
  const bool wide = N > kT || P > kT;
  const int nT = (Q + kT - 1) / kT;
  const int ptiles = (P + kT - 1) / kT, ntiles = (N + kT - 1) / kT;
  const WorkParts w = work_parts(chunks, N, P, Q);
  // the wide route's own kernels copy a ragged last group of columns 16
  // bytes at a time too (copy_tile<true>), so only the rows' alignment
  // counts there; the sums kernel copies a ragged tile 4 bytes at a time
  BwdArgs args{a, k, v, q, dy, states, dfinal, da, dk, dv, dq, dinit,
               work, work + chunks * N * P,
               {ab, ah, as}, {kb, kh, ks}, {vb, vh, vs}, {qb, qh, qs},
               {yb, yh, ys}, H, S, N, P, Q, nc,
               aligned(k, kb, kh, ks, wide ? 0 : N),
               aligned(v, vb, vh, vs, wide ? 0 : P),
               aligned(q, qb, qh, qs, wide ? 0 : N),
               aligned(dy, yb, yh, ys, wide ? 0 : P),
               work + w.rz, work + w.cz, work + w.xp, work + w.yp,
               reinterpret_cast<float*>(work + w.md),
               reinterpret_cast<float*>(work + w.ms), nT * kT, ntiles,
               P % 4 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSumsSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kChunkSmem);
  for (const void* fn : {(const void*)ssd_bwd_scores_kernel,
                         (const void*)ssd_bwd_dq_kernel,
                         (const void*)ssd_bwd_dk_kernel,
                         (const void*)ssd_bwd_dv_kernel,
                         (const void*)ssd_bwd_dla_kernel})
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          fn == (const void*)ssd_bwd_dk_kernel ? kWideDkSmem : kWideSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N * P + kThreads - 1) / kThreads;
  if (chunks > 0x7fffffffLL || (long long)B * H * blocks > 0x7fffffffLL
      || ptiles > 65535 || ntiles > 65535)
    return (int)cudaErrorInvalidValue;
  const unsigned cg = (unsigned)chunks;
  ssd_bwd_sums_kernel<<<dim3(cg, ptiles, ntiles), kThreads, kSumsSmem,
                        st>>>(args);
  ssd_bwd_carry_kernel<<<(unsigned)(B * H * blocks), kThreads, 0, st>>>(
      args, blocks);
  if (!wide) {
    ssd_bwd_chunk_kernel<<<cg, kThreads, kChunkSmem, st>>>(args);
  } else {
    ssd_bwd_scores_kernel<<<dim3(cg, nT * (nT + 1) / 2), kThreads, kWideSmem,
                            st>>>(args);
    ssd_bwd_dq_kernel<<<dim3(cg, nT, ntiles), kThreads, kWideSmem, st>>>(
        args);
    ssd_bwd_dk_kernel<<<dim3(cg, nT, ntiles), kThreads, kWideDkSmem, st>>>(
        args);
    ssd_bwd_dv_kernel<<<dim3(cg, nT, ptiles), kThreads, kWideSmem, st>>>(
        args);
    ssd_bwd_dla_kernel<<<cg, kThreads, kWideSmem, st>>>(args);
  }
  return (int)cudaGetLastError();
}
