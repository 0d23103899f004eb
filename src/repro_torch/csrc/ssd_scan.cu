// Mamba-2 SSD chunked scan, forward, for sm_90a:
//   S_t = a_t S_{t-1} + k_t v_t^T ,  y_t = S_t^T q_t
// a (B,H,S) decays in (0,1]; k, q (B,H,S,N); v, y (B,H,S,P); fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (`ssd_scan`, :60;
// `_ssd_kernel`, :23).  There one grid step is one (batch, head, chunk) and
// the chunk axis runs in order with the (N, P) state in VMEM scratch.  Per
// chunk of Q positions, with cum = cumsum(log a):
//   y_i   = sum_{j<=i} (q_i . k_j) e^{cum_i - cum_j} v_j + e^{cum_i} q_i S
//   S_new = e^{cum_L} S + sum_j e^{cum_L - cum_j} k_j v_j^T
//
// What bounds it on this card: operations.  B*H*S*(Q*(N+P) + 4*N*P) useful
// flops (the causal half of the two Q x Q products, the inter-chunk term
// and the state update): 25.8 GFLOP at the zamba2 training shape (B 2,
// H 64, S 4096, N = P = 64, Q 256), 0.385 ms at the fp32 FMA rate, against
// ~0.16 ms to move its bytes.
//
// What the design does about it:
// * One block per (b, h, 64-column tile of P).  The columns of S are
//   independent (S[:, p] depends only on v[:, p]), so P splits across
//   blocks with no reduction: B*H*ceil(P/64) blocks, 128 at the training
//   shape.  A loop inside the block walks the chunks in order; it takes the
//   place of the TPU's sequential grid axis.  The state tile stays in
//   registers (and a shared-memory copy for the inter-chunk product).
// * The chunk's k and v stay in shared memory; the Q x Q intra-chunk term
//   is cut into 64 x 64 sub-tiles (an fp32 Q x Q tile at Q = 256 would be
//   256 KB, over the 227 KB a block may use), and sub-tiles above the
//   diagonal are skipped.
// * e^{cum_i - cum_j} is computed only where i >= j (the reference forms it
//   everywhere and masks after, which overflows where decays are strong);
//   every decay factor is <= 1.
// * A ragged last chunk is masked in the kernel; nothing is padded.  The
//   final state equals the padded reference's (padding has a = 1, k = 0).
// * fp32 FFMA throughout (no TF32), so fp32 meets the reference's 1e-4.
// * Inputs are read through element strides, so the model's k and q, one
//   (B, S, N) tensor broadcast over H (stride 0), and its (B, S, H, .)
//   layout need no copy; y is written in v's layout.
// * With `states` non-null the entry state of every chunk is written,
//   (B, H, nc, N, P), for the backward kernel (csrc/ssd_scan_bwd.cu).
// Simple first: no tensor cores, no TMA, one block per SM.

#include "ssd_tiles.cuh"

namespace {

using namespace ssd;

struct FwdArgs {
  const float* a; const float* k; const float* v; const float* q;
  const float* init;       // (B, H, N, P) contiguous, or null for zeros
  float* y;
  float* final_state;      // (B, H, N, P) contiguous
  float* states;           // (B, H, nc, N, P) contiguous, or null
  View va, vk, vv, vq, vy;
  int H, S, N, P, Q, nc;
};

int fwd_smem_bytes(int Q) {
  const int Qp = (Q + kT - 1) / kT * kT;
  return 4 * (2 * Qp * kLd + 3 * kT * kLd + 2 * kMaxQ + 8);
}

__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Qp = (a.Q + kT - 1) / kT * kT;
  float* ks = smem;                  // Qp x kLd: the chunk's k (then k * w)
  float* vs = ks + Qp * kLd;         // Qp x kLd: its v, this block's columns
  float* qs = vs + Qp * kLd;         // 64 x kLd: one row tile of q
  float* ps = qs + kT * kLd;         // 64 x kLd: decay-masked scores
  float* ss = ps + kT * kLd;         // 64 x kLd: the entry state (N x PT)
  float* cum = ss + kT * kLd;        // kMaxQ
  float* wdec = cum + kMaxQ;         // kMaxQ: e^{cum_L - cum_j}
  float* scratch = wdec + kMaxQ;     // 8

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int p0 = blockIdx.y * kT, PT = min(kT, a.P - p0);
  const float* A = a.a + b * a.va.b + h * a.va.h;
  const float* K = a.k + b * a.vk.b + h * a.vk.h;
  const float* V = a.v + b * a.vv.b + h * a.vv.h + p0;
  const float* Qm = a.q + b * a.vq.b + h * a.vq.h;
  float* Y = a.y + b * a.vy.b + h * a.vy.h + p0;
  const long long NP = (long long)a.N * a.P;

  // the state: this thread's S[n = row_of(i)][p = col_of(j)]
  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = row_of(i), p = col_of(j);
      st[i][j] = (a.init != nullptr && n < a.N && p < PT)
                 ? a.init[bh * NP + (long long)n * a.P + p0 + p] : 0.f;
    }

  for (int c = 0; c < a.nc; ++c) {
    const int s0 = c * a.Q, Qc = min(a.Q, a.S - s0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = row_of(i), p = col_of(j);
        ss[n * kLd + p] = st[i][j];
        if (a.states != nullptr && n < a.N && p < PT)
          a.states[(bh * (long long)a.nc + c) * NP + (long long)n * a.P
                   + p0 + p] = st[i][j];
      }
    // cumulative log-decays; positions past Qc keep cum_L (a = 1)
    const float cs = block_scan(log_decay(A + s0 * a.va.s, a.va.s, tid, Qc),
                                scratch);
    cum[tid] = cs;
    load_rows(ks, K + s0 * a.vk.s, a.vk.s, Qp, Qc, a.N);
    load_rows(vs, V + s0 * a.vv.s, a.vv.s, Qp, Qc, PT);
    __syncthreads();
    const float cL = cum[Qc - 1];
    if (tid < Qc) wdec[tid] = expf(cL - cum[tid]);

    const int n_tiles = (Qc + kT - 1) / kT;
    for (int I = 0; I < n_tiles; ++I) {
      load_rows(qs, Qm + (s0 + I * kT) * a.vq.s, a.vq.s, kT,
                min(kT, Qc - I * kT), a.N);
      __syncthreads();
      float y[4][4], t[4][4];
      zero(y);
      zero(t);
      for (int J = 0; J <= I; ++J) {
        float sc[4][4];
        zero(sc);
        mm_nt(sc, qs, ks + J * kT * kLd, kT);          // q_I k_J^T over n
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = I * kT + row_of(i), col = J * kT + col_of(j);
            ps[row_of(i) * kLd + col_of(j)] =
                (col <= r && r < Qc) ? sc[i][j] * expf(cum[r] - cum[col])
                                     : 0.f;
          }
        __syncthreads();
        mm_nn(y, ps, vs + J * kT * kLd, kT);            // scores @ v_J
        __syncthreads();
      }
      mm_nn(t, qs, ss, kT);                               // q_I @ S
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = I * kT + row_of(i);
        if (r >= Qc) continue;
        const float e = expf(cum[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col_of(j) < PT)
            Y[(s0 + r) * a.vy.s + col_of(j)] = y[i][j] + e * t[i][j];
      }
      __syncthreads();
    }

    // S <- e^{cum_L} S + (k * w)^T v over the chunk's rows
    for (int idx = tid; idx < Qc * kT; idx += kThreads)
      ks[(idx >> 6) * kLd + (idx & 63)] *= wdec[idx >> 6];
    __syncthreads();
    float upd[4][4];
    zero(upd);
    mm_tn(upd, ks, vs, Qc);
    const float dec = expf(cL);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = st[i][j] * dec + upd[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = row_of(i), p = col_of(j);
      if (n < a.N && p < PT)
        a.final_state[bh * NP + (long long)n * a.P + p0 + p] = st[i][j];
    }
}

}  // namespace

// Strides are element strides of the (B, H, S) axes of a, k, v, q and y;
// the last axis of k, v, q, y has unit stride.  N <= 64, any P, 1 <= Q <=
// 256.  Returns a CUDA error code (0 on success).
extern "C" int ssd_scan_fwd_launch(
    const float* a, const float* k, const float* v, const float* q,
    const float* init, float* y, float* final_state, float* states,
    long long ab, long long ah, long long as,
    long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs,
    long long qb, long long qh, long long qs,
    long long yb, long long yh, long long ys,
    int B, int H, int S, int N, int P, int Q, void* stream) {
  if (B < 1 || H < 1 || S < 1 || N < 1 || N > kT || P < 1 || Q < 1
      || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  FwdArgs args{a, k, v, q, init, y, final_state, states,
               {ab, ah, as}, {kb, kh, ks}, {vb, vh, vs}, {qb, qh, qs},
               {yb, yh, ys}, H, S, N, P, Q, (S + Q - 1) / Q};
  const int smem = fwd_smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (P + kT - 1) / kT);
  ssd_fwd_kernel<<<grid, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
