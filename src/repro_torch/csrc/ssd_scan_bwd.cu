// Gradient of the SSD chunked scan (csrc/ssd_scan.cu), for sm_90a: da, dk,
// dv, dq and d(initial state) from a, k, v, q, dy, the chunk-entry states
// the forward saved (not recomputed) and d(final state).
//
// The TPU kernel it mirrors, src/repro/kernels/ssd_scan.py (`_ssd_kernel`),
// has no backward kernel: the JAX package differentiates its pure-JAX twin
// (`models/mamba2.py`, `chunked_linear_scan`) by autodiff.  So this kernel
// is held against the gradient of the plain version.
//
// Per chunk, in reverse, with M_ij = e^{cum_i - cum_j} (i >= j, else 0),
// w_j = e^{cum_L - cum_j}, S the chunk's entry state and dS the gradient of
// its exit state:
//   dq_i = sum_j M_ij (dy_i . v_j) k_j + e^{cum_i} S dy_i
//   dk_j = sum_i M_ij (dy_i . v_j) q_i + w_j dS v_j
//   dv_j = sum_i M_ij (q_i . k_j) dy_i + w_j dS^T k_j
//   dS <- e^{cum_L} dS + sum_i e^{cum_i} q_i dy_i^T
// and d(log a) at position t, from terms that are each formed once:
//   dlog a_t = sum_{i>=t} (R_i - C_i + X_i) + e^{cum_L} <dS, S>
//              + sum_{j<t} Y_j
//   R_i = sum_j Z_ij,  C_j = sum_i Z_ij,  Z_ij = M_ij (q_i . k_j)(dy_i . v_j)
//   X_i = e^{cum_i} q_i . (S dy_i),  Y_j = w_j k_j . (dS v_j)
//   da = dlog a / a where a > 1e-37, else 0.
// (The reference differentiates q_i . dq_i - k_i . dk_i + <dS, S_exit> at
// the last position; the same sum, rearranged: the pairs i, j >= t and the
// terms in S_exit - e^{cum_L} S cancel exactly, so they are never formed.)
//
// What bounds it on this card: operations, about 2.3x the forward's:
// B*H*S*(Q*(2P + 3N) + 8*N*P) useful flops, 60.1 GFLOP at the zamba2
// training shape, 0.90 ms at the fp32 FMA rate.
//
// What the design does about it:
// * One block per (b, h), P <= 64 and N <= 64: every sum over P (dy . v,
//   S dy, dS v) and over N stays inside the block, so dq, dk, da and the
//   scalar <dS, S> need no reduction across blocks and no atomics; the
//   result is the same bits on every run.  128 blocks at the training
//   shape.
// * Two passes per chunk over 64 x 64 sub-tiles, each skipping the tiles
//   above the diagonal: a row pass (dq, X, and dS's update) and a column
//   pass (dk, dv, Y, and the row and column sums of Z from the products it
//   already forms).  Each recomputes the masked products it needs from
//   tiles re-read from L2; only dS, its update and one output tile per
//   pass live in registers.
// * k and q may be broadcast over H (stride 0): each head writes its own dk
//   and dq into (B, H, S, N) outputs, and autograd sums them over H.
// * fp32 FFMA for dq, dk, dv, as in the forward.  d(log a) is built in
//   double from fp32 dots: with decays near 1 its terms reach |400| and
//   cancel to as little as 0.03, so every rounding of a large term shows.
//   In double: log a and its running sum cum (an fp32 cum near -200 rounds
//   cum_i - cum_j to 1.5e-5), Z, R, C, X, Y, the dS carry and its update,
//   <dS, S> and both scans.  Formed from dq and dk instead, d(log a) lay
//   2.2e-4 from float64 at the training shape, 1.5x the plain version.
// Simple first: no tensor cores, no TMA.

#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

struct BwdArgs {
  const float* a; const float* k; const float* v; const float* q;
  const float* dy;
  const float* states;     // (B, H, nc, N, P): each chunk's entry state
  const float* dfinal;     // (B, H, N, P), or null for zeros
  float* da; float* dk; float* dv; float* dq;   // contiguous (B, H, S, .)
  float* dinit;            // (B, H, N, P), or null
  View va, vk, vv, vq, vdy;
  int H, S, N, P, Q, nc;
};

constexpr int kSmemBytes = 4 * (8 * kT * kLd + 2 * kMaxQ)
                           + 8 * (3 * kMaxQ + 8);

__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qi = smem;                  // row tile of q
  float* dyi = qi + kT * kLd;        // row tile of dy
  float* kj = dyi + kT * kLd;        // column tile of k
  float* vj = kj + kT * kLd;         // column tile of v
  float* dm = vj + kT * kLd;         // M o (dy v^T)
  float* sm = dm + kT * kLd;         // M o (q k^T)
  float* sp = sm + kT * kLd;         // entry state (N x P)
  float* dss = sp + kT * kLd;        // dS (N x P), rounded to fp32
  float* ecum = dss + kT * kLd;      // kMaxQ each: e^{cum_i}
  float* wdec = ecum + kMaxQ;        //   e^{cum_L - cum_j}
  double* cum = reinterpret_cast<double*>(wdec + kMaxQ);   // kMaxQ each
  double* fsum = cum + kMaxQ;        // R_i - C_i + X_i
  double* ysum = fsum + kMaxQ;       // Y_j, then sum_{j<t} Y_j
  double* scratch = ysum + kMaxQ;    // 8
  double* csum = reinterpret_cast<double*>(dm);   // 16 x 64, column pass

  const int tid = threadIdx.x, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const float* A = a.a + b * a.va.b + h * a.va.h;
  const float* K = a.k + b * a.vk.b + h * a.vk.h;
  const float* V = a.v + b * a.vv.b + h * a.vv.h;
  const float* Qm = a.q + b * a.vq.b + h * a.vq.h;
  const float* DY = a.dy + b * a.vdy.b + h * a.vdy.h;
  const long long S = a.S, NP = (long long)a.N * a.P;
  float* DA = a.da + bh * S;
  float* DK = a.dk + bh * S * a.N;
  float* DQ = a.dq + bh * S * a.N;
  float* DV = a.dv + bh * S * a.P;

  // dS: this thread's dS[n = row_of(i)][p = col_of(j)], in double
  double ds[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = row_of(i), p = col_of(j);
      ds[i][j] = (a.dfinal != nullptr && n < a.N && p < a.P)
                 ? a.dfinal[bh * NP + (long long)n * a.P + p] : 0.0;
    }

  for (int c = a.nc - 1; c >= 0; --c) {
    const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
    const int n_tiles = (Qc + kT - 1) / kT;
    const double cs = block_scan(
        tid < Qc ? log(fmax((double)A[(s0 + tid) * a.va.s], (double)kMinA))
                 : 0.0, scratch);
    cum[tid] = cs;
    const float* s_prev = a.states + (bh * (long long)a.nc + c) * NP;
    double part = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = row_of(i), p = col_of(j);
        dss[n * kLd + p] = (float)ds[i][j];
        if (n < a.N && p < a.P)
          part = fma(ds[i][j], (double)s_prev[(long long)n * a.P + p], part);
      }
    load_rows(sp, s_prev, a.P, kT, a.N, a.P);
    const double ds_prev = block_sum(part, scratch);  // <dS, S>
    const double cL = cum[Qc - 1];
    if (tid < Qc) {
      ecum[tid] = expf((float)cs);
      wdec[tid] = expf((float)(cL - cs));
    }
    __syncthreads();

    // ---- row pass: dq, X, and dS's update sum_i e^{cum_i} q_i dy_i^T
    double dsu[4][4];
    zero(dsu);
    for (int I = 0; I < n_tiles; ++I) {
      const int rows = min(kT, Qc - I * kT);
      load_rows(qi, Qm + (s0 + I * kT) * a.vq.s, a.vq.s, kT, rows, a.N);
      load_rows(dyi, DY + (s0 + I * kT) * a.vdy.s, a.vdy.s, kT, rows, a.P);
      float acc[4][4];
      zero(acc);
      for (int J = 0; J <= I; ++J) {
        load_rows(kj, K + (s0 + J * kT) * a.vk.s, a.vk.s, kT,
                  min(kT, Qc - J * kT), a.N);
        load_rows(vj, V + (s0 + J * kT) * a.vv.s, a.vv.s, kT,
                  min(kT, Qc - J * kT), a.P);
        __syncthreads();
        float d[4][4];
        zero(d);
        mm_nt(d, dyi, vj, kT);                         // dy_I v_J^T over p
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = I * kT + row_of(i), col = J * kT + col_of(j);
            dm[row_of(i) * kLd + col_of(j)] =
                (col <= r && r < Qc)
                ? d[i][j] * expf((float)(cum[r] - cum[col])) : 0.f;
          }
        __syncthreads();
        mm_nn(acc, dm, kj, kT);                         // (M o D) @ k_J
        __syncthreads();
      }
      float t[4][4];
      zero(t);
      mm_nt(t, dyi, sp, kT);                            // dy_I S^T over p
      double qt[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = I * kT + row_of(i);
        if (r >= Qc) continue;
        const float e = ecum[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = col_of(j);
          if (n < a.N) {
            DQ[(s0 + r) * (long long)a.N + n] = fmaf(e, t[i][j], acc[i][j]);
            qt[i] = fma((double)qi[row_of(i) * kLd + n], (double)t[i][j],
                        qt[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = I * kT + row_of(i);
        const double qts = sum16(qt[i]);                // every lane
        const double x = r < Qc ? (double)ecum[r] * qts : 0.0;
        if (tx == 0) fsum[r] = x;                       // X_r
      }
      mm_tn_scaled_d(dsu, qi, dyi, ecum + I * kT, rows);  // (q e^cum)^T dy
      __syncthreads();
    }

    // ---- column pass: dk, dv, Y, and the row and column sums of Z
    for (int J = 0; J < n_tiles; ++J) {
      const int cols = min(kT, Qc - J * kT);
      load_rows(kj, K + (s0 + J * kT) * a.vk.s, a.vk.s, kT, cols, a.N);
      load_rows(vj, V + (s0 + J * kT) * a.vv.s, a.vv.s, kT, cols, a.P);
      float gk[4][4], gv[4][4];
      zero(gk);
      zero(gv);
      double zc[4] = {0.0, 0.0, 0.0, 0.0};              // column sums of Z
      for (int I = J; I < n_tiles; ++I) {
        const int rows = min(kT, Qc - I * kT);
        load_rows(qi, Qm + (s0 + I * kT) * a.vq.s, a.vq.s, kT, rows, a.N);
        load_rows(dyi, DY + (s0 + I * kT) * a.vdy.s, a.vdy.s, kT, rows, a.P);
        __syncthreads();
        float d[4][4], s[4][4];
        zero(d);
        zero(s);
        mm_nt(d, dyi, vj, kT);                         // dy_I v_J^T
        mm_nt(s, qi, kj, kT);                          // q_I k_J^T
        double zr[4] = {0.0, 0.0, 0.0, 0.0};            // row sums of Z
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = I * kT + row_of(i), col = J * kT + col_of(j);
            const float m = (col <= r && r < Qc)
                            ? expf((float)(cum[r] - cum[col])) : 0.f;
            dm[row_of(i) * kLd + col_of(j)] = d[i][j] * m;
            sm[row_of(i) * kLd + col_of(j)] = s[i][j] * m;
            const double z = (double)d[i][j] * (double)s[i][j] * (double)m;
            zr[i] += z;
            zc[j] += z;
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double z = sum16(zr[i]);
          if (tx == 0) fsum[I * kT + row_of(i)] += z;   // R_r
        }
        __syncthreads();
        mm_tn(gk, dm, qi, kT);                          // (M o D)^T q_I
        mm_tn(gv, sm, dyi, kT);                         // (M o Sc)^T dy_I
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) csum[(tid >> 4) * kT + col_of(j)] = zc[j];
      float tk[4][4], tv[4][4];
      zero(tk);
      zero(tv);
      mm_nt(tk, vj, dss, kT);                           // v_J dS^T over p
      mm_nn(tv, kj, dss, kT);                           // k_J dS over n
      double kt[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = J * kT + row_of(i);
        if (r >= Qc) continue;
        const float w = wdec[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col_of(j);
          if (col < a.N) {
            DK[(s0 + r) * (long long)a.N + col] = fmaf(w, tk[i][j], gk[i][j]);
            kt[i] = fma((double)kj[row_of(i) * kLd + col], (double)tk[i][j],
                        kt[i]);
          }
          if (col < a.P)
            DV[(s0 + r) * (long long)a.P + col] = fmaf(w, tv[i][j], gv[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = J * kT + row_of(i);
        const double kts = sum16(kt[i]);                // every lane
        const double y = r < Qc ? (double)wdec[r] * kts : 0.0;
        if (tx == 0) ysum[r] = y;                       // Y_r
      }
      __syncthreads();
      if (tid < kT) {                                   // C_c, rows in order
        double z = 0.0;
        for (int ty = 0; ty < kThreads / 16; ++ty) z += csum[ty * kT + tid];
        fsum[J * kT + tid] -= z;
      }
      __syncthreads();
    }

    // ---- dlog a_t = sum_{i>=t} fsum_i + e^{cum_L} <dS, S> + sum_{j<t} Y_j;
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
      const float av = A[(s0 + idx) * a.va.s];
      DA[s0 + idx] = av > kMinA ? (float)(dla / av) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds[i][j] = fma(dec, ds[i][j], dsu[i][j]);
    __syncthreads();
  }

  if (a.dinit != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = row_of(i), p = col_of(j);
        if (n < a.N && p < a.P)
          a.dinit[bh * NP + (long long)n * a.P + p] = (float)ds[i][j];
      }
  }
}

}  // namespace

// Strides as in ssd_scan_fwd_launch, for a, k, v, q and dy; states
// (B,H,nc,N,P), dfinal (B,H,N,P) and the outputs da (B,H,S),
// dk, dq (B,H,S,N), dv (B,H,S,P) and dinit (B,H,N,P) contiguous.  N, P <=
// 64, 1 <= Q <= 256.  dfinal and dinit may be null.  Returns a CUDA error
// code (0 on success).
extern "C" int ssd_scan_bwd_launch(
    const float* a, const float* k, const float* v, const float* q,
    const float* dy, const float* states, const float* dfinal, float* da,
    float* dk, float* dv, float* dq, float* dinit,
    long long ab, long long ah, long long as,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long qb, long long qh, long long qs,
    long long yb, long long yh, long long ys,
    int B, int H, int S, int N, int P, int Q, void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || N > kT || P < 1 || P > kT
      || Q < 1 || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  BwdArgs args{a, k, v, q, dy, states, dfinal, da, dk, dv, dq,
               dinit, {ab, ah, as}, {kb, kh, ks}, {vb, vh, vs},
               {qb, qh, qs}, {yb, yh, ys}, H, S, N, P, Q, (S + Q - 1) / Q};
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_kernel<<<B * H, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
