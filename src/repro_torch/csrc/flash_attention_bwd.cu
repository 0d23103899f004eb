// Gradient of the flash-attention forward (csrc/flash_attention.cu), for
// sm_90a: dq, dk, dv from q, k, v, the forward's output and its fp32
// log-sum-exp, recomputing the probabilities tile by tile as
// FlashAttention-2 does.
//
// The TPU kernel it mirrors, src/repro/kernels/flash_attention.py
// (`_flash_kernel`), has no backward kernel: the JAX package
// differentiates its pure-JAX twin (`models/attention.py`,
// `chunked_attention`) by autodiff.  So this kernel is held against the
// gradient of the plain version, not against a TPU kernel.
//
// With s = (q * scale) . k, p = exp(s - lse), delta = rowsum(dout * out):
//   dv = p^T dout,  dp = dout v^T,  ds = p * (dp - delta),
//   dq = scale * ds k,  dk = scale * ds^T q,
// where dk and dv sum over the G heads that share a KV head.
//
// What bounds it on this card: operations.  Five products of the
// forward's size, 2.5x its flops: 86 GFLOP at gemma-2b's training shape
// (87 us at the bf16 tensor-core rate), 344 GFLOP at zamba2-1.2b's
// (348 us).  The bf16 design runs eleven products' worth: S and dP in
// both kernels and twice in dq (a pass for delta), dV's and dK's in two
// parts each.
//
// The shared structure, for both dtypes: no atomics, so the result does
// not depend on timing.  A dk/dv kernel (a block per key tile walks the
// stacked query rows that see it: under the causal mask a key tile
// starting at k0 meets only rows from k0 * G on) and a dq kernel (a block
// per row tile walks the key tiles up to its last position).  The stacked
// rows (row = s * G + g) let one K/V tile serve all G heads and make the
// GQA sum over heads part of the row loop.  gemma-2b has B * K = 2 slabs,
// so few key tiles (64 of 64 keys at T = 2048) for 132 SMs: each key
// tile's rows are split over `n_split` blocks (5 there), which write fp32
// partial dk and dv (n_split x 2 x B*K*T*D x 4 bytes, 42 MB at that shape,
// written and read once); `split_sum_kernel` adds them in split order.
//
// bf16 (the training path): all five products on wgmma (bf16 in, fp32
// accumulators), operands bf16 in shared memory in the 128-byte swizzle.
// * `dq_wgmma` runs first, shaped as the forward: consumer warpgroups of 64
//   stacked rows (two, or one at D = 256) and a producer warp keeping a
//   TMA ring of K/V tiles full under mbarriers.  S = Q K^T and dP = dO V^T
//   are wgmma from shared memory; dS goes back to bf16 in registers as the
//   A operand of dQ += dS K (K MN-major).  The ring runs twice over the
//   key tiles: the first pass sums delta = rowsum(P o dP) in fp32 and
//   writes it for the dk/dv kernel.  rowsum(dout o out) would carry out's
//   bf16 rounding, which peaked rows (dP - delta cancelling) turn into
//   errors of several percent in dk.
// * `dkdv_wgmma` (D = 128, 256): two warpgroups own 64 keys.  Each forms
//   S^T = K Q^T and dP^T = V dO^T for all keys and half the step's 64
//   rows, and stores P^T and dS^T to shared memory as bf16; then each
//   accumulates dV += P^T dO and dK += dS^T Q for all keys and half of D,
//   which keeps dV and dK of D = 256 within a thread's registers.
// * `dkdv_wgmma64` (D <= 64): one warpgroup owns 64 keys; P^T and dS^T
//   stay in registers as the A operands of dV and dK.
// * P^T and dS^T enter dV and dK each as a high and a low bf16 part.
//   Rounded once, peaked scores (q x 8) put dk 0.25 from the plain
//   version at D = 256 (dS), and one element of dv 0.021 (P).
// * The dk/dv kernels fill a ring of Q, dO, lse and delta stages by
//   16-byte cp.async (the stacked rows are not one box of a tensor map).
//   All three mask only the steps that cross the diagonal, T or S * G.
//
// fp32 (`delta_kernel`, `dkdv_kernel`, `dq_kernel`): FFMA from fp32 shared
// memory (flash_tiles.cuh), exact fp32 for the fp32 tolerance; delta from
// the fp32 output; 32 keys x 64 rows a step, no tensor cores, no
// pipelining.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kKeys = 32;   // keys per tile

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout; const float* lse; float* delta;
  void* dq; void* dk; void* dv;
  float* part;     // (n_split, 2, B*K, T, D): partial dk, dv
  int BK, G, S, T, D, causal, n_split;
  float scale;
};

template <int kD>
constexpr int dkdv_smem_bytes() {
  return 4 * (2 * kKeys * (kD + 4) + 2 * kRows * (kD + 4)
              + 2 * kRows * (kKeys + 4) + 2 * kRows);
}

template <int kD>
constexpr int dq_smem_bytes() {
  return 4 * (2 * kRows * (kD + 4) + 2 * kKeys * (kD + 4)
              + kRows * (kKeys + 4) + 2 * kRows);
}

// delta[row] = sum_d dout[row, d] * out[row, d], fp32; one warp per row.
template <typename E>
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdArgs a,
                                                         long long n_rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const E* o = static_cast<const E*>(a.o) + row * a.D;
  const E* g = static_cast<const E*>(a.dout) + row * a.D;
  float acc = 0.f;
  for (int d = lane; d < a.D; d += 32) acc = fmaf(to_f(g[d]), to_f(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// Scores and dP of one (64 rows x 32 keys) tile: thread (ty, tx) owns rows
// ty*4+i and keys tx+16j.  Returns p and ds = p * (dp - delta) in
// registers; masked entries are 0.
template <int kD>
__device__ __forceinline__ void probs_and_ds(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* del_s, int r0, int k0, const BwdArgs& a,
    float p[4][2], float ds[4][2]) {
  constexpr int ld = kD + 4;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float s[4][2], dp[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 qv[4], ov[4], kv[2], vv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = ld4(Qs + (ty * 4 + i) * ld + d);
      ov[i] = ld4(dOs + (ty * 4 + i) * ld + d);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kv[j] = ld4(Ks + (tx + 16 * j) * ld + d);
      vv[j] = ld4(Vs + (tx + 16 * j) * ld + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = dot4(qv[i], kv[j], s[i][j]);
        dp[i][j] = dot4(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = r0 + r, qpos = row / a.G;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool bad = row >= a.S * a.G || kp >= a.T
                       || (a.causal && kp > qpos);
      p[i][j] = bad ? 0.f : expf(s[i][j] - lse_s[r]);
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[r]);
    }
  }
}

// Stages 64 stacked rows of q (times scale) and dout, and their lse and
// delta, for row tile r0 of slab bk.
template <typename E, int kD>
__device__ __forceinline__ void stage_rows(float* Qs, float* dOs,
                                           float* lse_s, float* del_s,
                                           int r0, int bk, const BwdArgs& a) {
  constexpr int ld = kD + 4;
  const int G = a.G, S = a.S, D = a.D;
  const long long slab = (long long)bk * G * S * D;
  const E* qb = static_cast<const E*>(a.q) + slab;
  const E* gb = static_cast<const E*>(a.dout) + slab;
  stage<kRows, kD, ld, E>(
      Qs, [&](int r) { return stacked_row(qb, r0 + r, G, S, D); }, D,
      a.scale);
  stage<kRows, kD, ld, E>(
      dOs, [&](int r) { return stacked_row(gb, r0 + r, G, S, D); }, D, 1.f);
  if (threadIdx.x < kRows) {
    const int row = r0 + threadIdx.x;
    float lv = 0.f, dv = 0.f;
    if (row < S * G) {
      const long long idx = ((long long)bk * G + row % G) * S + row / G;
      lv = a.lse[idx];
      dv = a.delta[idx];
    }
    lse_s[threadIdx.x] = lv;
    del_s[threadIdx.x] = dv;
  }
}

template <typename E, int kD>
__device__ __forceinline__ void stage_keys(float* Ks, float* Vs, int k0,
                                           int bk, const BwdArgs& a) {
  constexpr int ld = kD + 4;
  const int T = a.T, D = a.D;
  const E* kb = static_cast<const E*>(a.k) + (long long)bk * T * D;
  const E* vb = static_cast<const E*>(a.v) + (long long)bk * T * D;
  stage<kKeys, kD, ld, E>(
      Ks, [&](int r) -> const E* {
        return k0 + r < T ? kb + (long long)(k0 + r) * D : nullptr; },
      D, 1.f);
  stage<kKeys, kD, ld, E>(
      Vs, [&](int r) -> const E* {
        return k0 + r < T ? vb + (long long)(k0 + r) * D : nullptr; },
      D, 1.f);
}

// grid (key tiles, n_split, B*K): dk, dv of 32 keys over one share of the
// row tiles that see them.
template <typename E, int kD>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(BwdArgs a) {
  constexpr int ld = kD + 4, ldp = kKeys + 4;
  constexpr int kDc = kD / 4;                  // float4 columns
  constexpr int kGroups = kThreads / kDc;      // key groups
  constexpr int kKpt = kKeys / kGroups;        // keys per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kKeys * ld;
  float* Qs = Vs + kKeys * ld;
  float* dOs = Qs + kRows * ld;
  float* Ps = dOs + kRows * ld;
  float* dSs = Ps + kRows * ldp;
  float* lse_s = dSs + kRows * ldp;
  float* del_s = lse_s + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = tid / kDc, dc = tid % kDc;
  const int k0 = blockIdx.x * kKeys, split = blockIdx.y, bk = blockIdx.z;
  const int G = a.G, S = a.S, T = a.T, D = a.D;

  stage_keys<E, kD>(Ks, Vs, k0, bk, a);

  const int n_tiles = (S * G + kRows - 1) / kRows;
  const int first = a.causal ? min(n_tiles, (k0 * G) / kRows) : 0;
  const int per = (n_tiles - first + a.n_split - 1) / a.n_split;
  const int t_begin = first + split * per;
  const int t_end = min(n_tiles, t_begin + per);

  float dk[kKpt][4], dv[kKpt][4];
#pragma unroll
  for (int i = 0; i < kKpt; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int r0 = t * kRows;
    __syncthreads();   // the last tile's readers are done
    stage_rows<E, kD>(Qs, dOs, lse_s, del_s, r0, bk, a);
    __syncthreads();
    float p[4][2], ds[4][2];
    probs_and_ds<kD>(Qs, dOs, Ks, Vs, lse_s, del_s, r0, k0, a, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Ps[(ty * 4 + i) * ldp + tx + 16 * j] = p[i][j];
        dSs[(ty * 4 + i) * ldp + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dv += p^T dout, dk += ds^T (q * scale): keys grp*kKpt+i, columns 4*dc..
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 o4 = ld4(dOs + r * ld + 4 * dc);
      const float4 q4 = ld4(Qs + r * ld + 4 * dc);
#pragma unroll
      for (int i = 0; i < kKpt; ++i) {
        const float pv = Ps[r * ldp + grp * kKpt + i];
        const float sv = dSs[r * ldp + grp * kKpt + i];
        fma4(dv[i][0], dv[i][1], dv[i][2], dv[i][3], pv, o4);
        fma4(dk[i][0], dk[i][1], dk[i][2], dk[i][3], sv, q4);
      }
    }
  }

  const long long n = (long long)a.BK * T * D;
#pragma unroll
  for (int i = 0; i < kKpt; ++i) {
    const int key = k0 + grp * kKpt + i;
    if (key >= T) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * dc + e;
      if (d >= D) continue;
      const long long idx = ((long long)bk * T + key) * D + d;
      if (a.n_split == 1) {
        store_f(dk[i][e], static_cast<E*>(a.dk) + idx);
        store_f(dv[i][e], static_cast<E*>(a.dv) + idx);
      } else {
        a.part[(2LL * split) * n + idx] = dk[i][e];
        a.part[(2LL * split + 1) * n + idx] = dv[i][e];
      }
    }
  }
}

// dk, dv = the sum of the n_split partials, in split order.
template <typename E>
__global__ void __launch_bounds__(kThreads) split_sum_kernel(BwdArgs a) {
  const long long n = (long long)a.BK * a.T * a.D;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * kThreads) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      sk += a.part[(2LL * s) * n + idx];
      sv += a.part[(2LL * s + 1) * n + idx];
    }
    store_f(sk, static_cast<E*>(a.dk) + idx);
    store_f(sv, static_cast<E*>(a.dv) + idx);
  }
}

template <typename E>
void split_sum(const BwdArgs& a, cudaStream_t stream) {
  const long long n = (long long)a.BK * a.T * a.D;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  split_sum_kernel<E><<<blocks, kThreads, 0, stream>>>(a);
}

// grid (row tiles, B*K): dq of 64 stacked rows over the key tiles they see.
template <typename E, int kD>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(BwdArgs a) {
  constexpr int ld = kD + 4, ldp = kKeys + 4;
  constexpr int kCols = kD / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRows * ld;
  float* Ks = dOs + kRows * ld;
  float* Vs = Ks + kKeys * ld;
  float* dSs = Vs + kKeys * ld;
  float* lse_s = dSs + kRows * ldp;
  float* del_s = lse_s + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bk = blockIdx.y;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const int r0 = tile * kRows;

  stage_rows<E, kD>(Qs, dOs, lse_s, del_s, r0, bk, a);
  const int q_last = min(S - 1, (r0 + kRows - 1) / G);
  const int k_end = a.causal ? min(T, q_last + 1) : T;

  float acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the last tile's readers are done with Ks, Vs, dSs
    stage_keys<E, kD>(Ks, Vs, k0, bk, a);
    __syncthreads();
    float p[4][2], ds[4][2];
    probs_and_ds<kD>(Qs, dOs, Ks, Vs, lse_s, del_s, r0, k0, a, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) dSs[(ty * 4 + i) * ldp + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq += ds k: rows ty*4+i, columns 64*c + 4*tx + (0..3)
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty * 4 + i) * ldp + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 kk = ld4(Ks + key * ld + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
               acc[i][4 * c + 3], sv[i], kk);
      }
    }
  }

  E* qg = static_cast<E*>(a.dq) + (long long)bk * G * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= S * G) continue;
    E* out = qg + ((long long)(row % G) * S + row / G) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * tx + e;
        if (d < D) store_f(acc[i][4 * c + e] * a.scale, out + d);
      }
  }
}


// ------------------------------------------------------------------ bf16
using bf16 = __nv_bfloat16;
using hopper::smem_addr;

// lse and (unless del_s is null) delta of `n` stacked rows from r0 (0 past
// S * G), by cp.async from a block of kThreadsIn threads.
template <int kThreadsIn = 256>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s,
                                               int r0, int n, int bk,
                                               const BwdArgs& a) {
  for (int r = threadIdx.x; r < n; r += kThreadsIn) {
    const int row = r0 + r;
    const bool ok = row < a.S * a.G;
    const long long idx =
        ok ? ((long long)bk * a.G + row % a.G) * a.S + row / a.G : 0;
    hopper::cp_async4(lse_s + r, a.lse + idx, ok ? 4 : 0);
    if (del_s != nullptr)
      hopper::cp_async4(del_s + r, a.delta + idx, ok ? 4 : 0);
  }
}

// Q and dO stacked rows r0 + row0 .. r0 + row0 + 63 of a slab into rows
// row0 .. of swizzled panels of kPanelRows rows (zeros past S * G or D),
// by 16-byte cp.async from kThr threads (t: this thread's index among
// them); each row's address is computed once for both tensors.
template <int kD, int kThr, int kPanelRows>
__device__ __forceinline__ void load_q_do(uint8_t* q_dst, uint8_t* o_dst,
                                          const bf16* qb, const bf16* gb,
                                          int r0, int row0, int t,
                                          const BwdArgs& a) {
  constexpr int kChunks = kD / 8;
  static_assert(64 * kChunks % kThr == 0, "tile split");
#pragma unroll
  for (int i = 0; i < 64 * kChunks / kThr; ++i) {
    const int idx = t + i * kThr;
    const int r = row0 + idx / kChunks, ch = idx % kChunks, row = r0 + r;
    const bool ok = row < a.S * a.G && ch * 8 < a.D;
    const long long off =
        ok ? ((long long)(row % a.G) * a.S + row / a.G) * a.D + ch * 8 : 0;
    const uint32_t dst =
        (ch / 8) * (kPanelRows * 128) + hopper::swizzle128(r, ch % 8);
    hopper::cp_async16(q_dst + dst, qb + off, ok ? 16 : 0);
    hopper::cp_async16(o_dst + dst, gb + off, ok ? 16 : 0);
  }
}

// Key rows k0 .. k0 + 63 of k and v (slab bases kb, vb) into swizzled
// panels of 64 rows (zeros past T or D), by 16-byte cp.async from kThr
// threads.
template <int kD, int kThr>
__device__ __forceinline__ void load_k_v(uint8_t* k_dst, uint8_t* v_dst,
                                         const bf16* kb, const bf16* vb,
                                         int k0, const BwdArgs& a) {
  constexpr int kChunks = kD / 8;
  for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThr) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const bool ok = k0 + r < a.T && ch * 8 < a.D;
    const long long off = ok ? (long long)(k0 + r) * a.D + ch * 8 : 0;
    const uint32_t dst = (ch / 8) * (64 * 128) + hopper::swizzle128(r, ch % 8);
    hopper::cp_async16(k_dst + dst, kb + off, ok ? 16 : 0);
    hopper::cp_async16(v_dst + dst, vb + off, ok ? 16 : 0);
  }
}

// dq on wgmma: as the forward (csrc/flash_attention.cu), a block of kWgs
// consumer warpgroups of 64 stacked rows and one producer warp that keeps
// a TMA ring of K/V tiles full; the ring runs twice over the key tiles
// (delta, then dQ).
template <int kD>
struct DqCfg {
  static constexpr int kWgs = kD == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kWgs;
  static constexpr int kN = 64;                         // keys per tile
  static constexpr int kPanels = kD / 64;
  static constexpr int kStages = kD == 256 ? 2 : kD == 128 ? 3 : 4;
  static constexpr int kRowBytes = kPanels * kRows * 128;   // Q or dO
  static constexpr int kTileBytes = kPanels * kN * 128;     // K or V
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kSmem = 1024 + 2 * kRowBytes
                               + 2 * kStages * kTileBytes + 2 * kStages * 8;
};

template <int kD>
__global__ void __launch_bounds__(DqCfg<kD>::kThreads, 1)
dq_wgmma(const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v, BwdArgs a) {
  using C = DqCfg<kD>;
  constexpr int kN = C::kN, kStages = C::kStages, kWgs = C::kWgs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* dOs = Qs + C::kRowBytes;
  uint8_t* Ks = dOs + C::kRowBytes;
  uint8_t* Vs = Ks + kStages * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * C::kTileBytes);
  uint64_t* empty = full + kStages;

  const int bk = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const int q_last = min(S - 1, (r0 + C::kRows - 1) / G);
  const int k_end = a.causal ? min(T, q_last + 1) : T;
  const int n_tiles = (k_end + kN - 1) / kN;
  const int n_steps = 2 * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kWgs * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWgs) {
    // ---- producer: K/V tiles of both passes.  With two consumer
    // warpgroups (384 threads, 168 registers each at launch) the producer
    // gives registers up and the consumers take them.
    if constexpr (kWgs == 2) hopper::regs_dealloc<24>();
    if (threadIdx.x == kWgs * 128) {
      for (int j = 0; j < n_steps; ++j) {
        const int st = j % kStages, k0 = (j % n_tiles) * kN;
        hopper::mbar_wait(&empty[st], ((j / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          const int off = st * C::kTileBytes + p * kN * 128;
          hopper::tma_load_3d(Ks + off, &tm_k, &full[st], p * 64, k0, bk);
          hopper::tma_load_3d(Vs + off, &tm_v, &full[st], p * 64, k0, bk);
        }
      }
    }
  } else {
    if constexpr (kWgs == 2) hopper::regs_alloc<240>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const long long slab = (long long)bk * G * S * D;
    load_q_do<kD, 128, C::kRows>(
        Qs, dOs, static_cast<const bf16*>(a.q) + slab,
        static_cast<const bf16*>(a.dout) + slab, r0, wg * 64, t, a);
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);

    const int ra = wg * 64 + warp * 16 + (lane >> 2);
    const int c2 = 2 * (lane & 3);
    const float sl2 = a.scale * 1.4426950408889634f;
    float lse2[2], del[2] = {0.f, 0.f};
    int qpos[2];
    bool row_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + ra + 8 * h;
      row_ok[h] = row < S * G;
      qpos[h] = row / G;
      lse2[h] = row_ok[h] ? a.lse[((long long)bk * G + row % G) * S + row / G]
                                * 1.4426950408889634f
                          : 0.f;
    }
    // this warpgroup's last stacked row and its first row's position
    const int wg_last = r0 + wg * 64 + 63, wg_first_pos = (r0 + wg * 64) / G;
    float dq[kD / 2];
#pragma unroll
    for (int v = 0; v < kD / 2; ++v) dq[v] = 0.f;
    const uint32_t q_base = smem_addr(Qs) + wg * 64 * 128;
    const uint32_t o_base = smem_addr(dOs) + wg * 64 * 128;

    for (int j = 0; j < n_steps; ++j) {
      const int st = j % kStages, k0 = (j % n_tiles) * kN;
      hopper::mbar_wait(&full[st], (j / kStages) & 1);
      const uint32_t k_base = smem_addr(Ks + st * C::kTileBytes);
      const uint32_t v_base = smem_addr(Vs + st * C::kTileBytes);
      // S = Q K^T and dP = dO V^T over D
      float s[kN / 2], dp[kN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * C::kRows * 128 + off;
        const uint32_t ko = (kk / 4) * kN * 128 + off;
        hopper::wgmma_ss<kN>(s, hopper::gmma_desc(q_base + qo, 0, 1024),
                             hopper::gmma_desc(k_base + ko, 0, 1024), kk > 0);
        hopper::wgmma_ss<kN>(dp, hopper::gmma_desc(o_base + qo, 0, 1024),
                             hopper::gmma_desc(v_base + ko, 0, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P, masked only where the step crosses the diagonal, T or S * G;
      // then delta (first pass) or dS (second pass), in s
      const bool second = j >= n_tiles;
      const bool edge = k0 + kN > T || wg_last >= S * G
                        || (a.causal && k0 + kN - 1 > wg_first_pos);
#pragma unroll
      for (int v = 0; v < kN / 2; ++v) {
        const int h = (v >> 1) & 1;
        const int kp = k0 + 8 * (v >> 2) + c2 + (v & 1);
        float p = exp2f(fmaf(s[v], sl2, -lse2[h]));
        if (edge && (!row_ok[h] || kp >= T || (a.causal && kp > qpos[h])))
          p = 0.f;
        if (second) s[v] = p * (dp[v] - del[h]);
        else del[h] = fmaf(p, dp[v], del[h]);
      }
      if (j == n_tiles - 1) {           // delta complete: the row's 4 lanes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          del[h] += __shfl_xor_sync(0xffffffffu, del[h], 1);
          del[h] += __shfl_xor_sync(0xffffffffu, del[h], 2);
          const int row = r0 + ra + 8 * h;
          if ((lane & 3) == 0 && row_ok[h])
            a.delta[((long long)bk * G + row % G) * S + row / G] = del[h];
        }
      }
      if (second) {
        // dQ += dS K: dS as bf16 A operand, K as an MN-major B operand
        uint32_t pa[kN / 16][4];
#pragma unroll
        for (int kt = 0; kt < kN / 16; ++kt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kt][r] = hopper::pack_bf16(s[8 * kt + 2 * r],
                                          s[8 * kt + 2 * r + 1]);
        hopper::wgmma_fence();
        hopper::fence_regs(dq);
#pragma unroll
        for (int kt = 0; kt < kN / 16; ++kt)
          hopper::wgmma_rs<kD>(dq, pa[kt],
                               hopper::gmma_desc(k_base + kt * 16 * 128,
                                                 kN * 128, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
      }
      hopper::mbar_arrive(&empty[st]);
    }

    bf16* qg = static_cast<bf16*>(a.dq) + slab;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + ra + 8 * h;
      if (!row_ok[h]) continue;
      bf16* out = qg + ((long long)(row % G) * S + row / G) * D;
#pragma unroll
      for (int jd = 0; jd < kD / 8; ++jd) {
        const int d = 8 * jd + c2;
        if (d < D)
          *reinterpret_cast<uint32_t*>(out + d) = hopper::pack_bf16(
              dq[4 * jd + 2 * h] * a.scale, dq[4 * jd + 2 * h + 1] * a.scale);
      }
    }
  }
}

// dk, dv on wgmma at D <= 64: a block of one warpgroup owns 64 keys and
// walks the stacked query rows that see them 64 at a time (two blocks an
// SM).  Q, dO and the rows' lse and delta come by cp.async into a ring of
// swizzled stages; S^T = K Q^T and dP^T = V dO^T are wgmma with both
// operands in shared memory; P^T and dS^T stay in registers as the A
// operands of dV += P^T dO and dK += dS^T Q (dS^T as a high and a low
// bf16 part), with dO and Q read as MN-major B operands.
constexpr int kKvwKeys = 64, kKvwRows = 64, kKvwStages = 3;
constexpr int kKvwTile = kKvwRows * 128;          // one swizzled 64 x 64 tile
constexpr int kKvwSmem = 1024 + 2 * kKvwKeys * 128 + 2 * kKvwStages * kKvwTile
                         + 2 * kKvwStages * kKvwRows * 4;

__global__ void __launch_bounds__(128, 2) dkdv_wgmma64(BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Vs = Ks + kKvwKeys * 128;
  uint8_t* Qs = Vs + kKvwKeys * 128;                      // stages
  uint8_t* dOs = Qs + kKvwStages * kKvwTile;              // stages
  float* lse_s = reinterpret_cast<float*>(dOs + kKvwStages * kKvwTile);
  float* del_s = lse_s + kKvwStages * kKvwRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // grid (n_split * B*K, key tiles): the first key tiles, which see the
  // most rows under the causal mask, are issued first
  const int k0 = blockIdx.y * kKvwKeys, split = blockIdx.x % a.n_split,
            bk = blockIdx.x / a.n_split;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const long long slab = (long long)bk * G * S * D;
  const bf16* qb = static_cast<const bf16*>(a.q) + slab;
  const bf16* gb = static_cast<const bf16*>(a.dout) + slab;
  const bf16* kb = static_cast<const bf16*>(a.k) + (long long)bk * T * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (long long)bk * T * D;

  const int n_tiles = (S * G + kKvwRows - 1) / kKvwRows;
  const int first = a.causal ? min(n_tiles, (k0 * G) / kKvwRows) : 0;
  const int per = (n_tiles - first + a.n_split - 1) / a.n_split;
  const int t_begin = first + split * per;
  const int t_end = min(n_tiles, t_begin + per);

  auto load_rows = [&](int tile, int st) {
    const int r0 = tile * kKvwRows;
    load_q_do<64, 128, 64>(Qs + st * kKvwTile, dOs + st * kKvwTile, qb, gb,
                           r0, 0, threadIdx.x, a);
    load_row_stats<128>(lse_s + st * kKvwRows, del_s + st * kKvwRows, r0,
                        kKvwRows, bk, a);
  };
  load_k_v<64, 128>(Ks, Vs, kb, vb, k0, a);
#pragma unroll
  for (int s = 0; s < kKvwStages - 1; ++s) {
    if (t_begin + s < t_end) load_rows(t_begin + s, s);
    hopper::cp_async_commit();
  }

  // this thread's keys: ka and ka + 8 of the block; its accumulator
  // columns 2 (lane % 4) + {0, 1} of each 8-wide group are rows of the step
  const int ka = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const float sl2 = a.scale * 1.4426950408889634f;
  float dv[32], dk[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) dv[v] = dk[v] = 0.f;
  const uint32_t k_base = smem_addr(Ks);
  const uint32_t v_base = smem_addr(Vs);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) % kKvwStages, r0 = tile * kKvwRows;
    if (tile + kKvwStages - 1 < t_end)
      load_rows(tile + kKvwStages - 1,
                (tile - t_begin + kKvwStages - 1) % kKvwStages);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kKvwStages - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t q_base = smem_addr(Qs + st * kKvwTile);
    const uint32_t o_base = smem_addr(dOs + st * kKvwTile);
    const float* lse_t = lse_s + st * kKvwRows;
    const float* del_t = del_s + st * kKvwRows;

    float sT[32], dpT[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::wgmma_ss<64>(sT, hopper::gmma_desc(k_base + kk * 32, 0, 1024),
                           hopper::gmma_desc(q_base + kk * 32, 0, 1024),
                           kk > 0);
      hopper::wgmma_ss<64>(dpT, hopper::gmma_desc(v_base + kk * 32, 0, 1024),
                           hopper::gmma_desc(o_base + kk * 32, 0, 1024),
                           kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sT);
    hopper::fence_regs(dpT);

    // P^T and dS^T as bf16 A operands over the step's rows; masked only
    // where the step crosses the diagonal, T or S * G
    const bool edge = r0 + kKvwRows > S * G || k0 + kKvwKeys > T
                      || (a.causal && k0 + kKvwKeys - 1 > r0 / G);
    uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int kp = k0 + ka + 8 * ((v >> 1) & 1);
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * (v >> 2) + c2 + e, row = r0 + r;
        p[e] = exp2f(fmaf(sT[v + e], sl2, -lse_t[r] * 1.4426950408889634f));
        if (edge && (row >= S * G || kp >= T || (a.causal && kp > row / G)))
          p[e] = 0.f;
        ds[e] = p[e] * (dpT[v + e] - del_t[r]);
      }
      const int kt = v >> 3, reg = (v >> 1) & 3;
      ph[kt][reg] = hopper::split_bf16(p, pl[kt][reg]);
      sh[kt][reg] = hopper::split_bf16(ds, sl[kt][reg]);
    }
    hopper::wgmma_fence();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint64_t dod = hopper::gmma_desc(o_base + kt * 16 * 128,
                                             kKvwRows * 128, 1024);
      const uint64_t qd = hopper::gmma_desc(q_base + kt * 16 * 128,
                                            kKvwRows * 128, 1024);
      hopper::wgmma_rs<64>(dv, ph[kt], dod);
      hopper::wgmma_rs<64>(dv, pl[kt], dod);
      hopper::wgmma_rs<64>(dk, sh[kt], qd);
      hopper::wgmma_rs<64>(dk, sl[kt], qd);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    __syncthreads();      // the stage is refilled next step
  }
  hopper::cp_async_wait<0>();

  const long long n = (long long)a.BK * T * D;
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    const int key = k0 + ka + 8 * ((v >> 1) & 1);
    const int d = 8 * (v >> 2) + c2;
    if (key >= T || d >= D) continue;
    const long long idx = ((long long)bk * T + key) * D + d;
    const float k0v = dk[v] * a.scale, k1v = dk[v + 1] * a.scale;
    if (a.n_split == 1) {
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + idx) =
          hopper::pack_bf16(k0v, k1v);
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + idx) =
          hopper::pack_bf16(dv[v], dv[v + 1]);
    } else {
      *reinterpret_cast<float2*>(a.part + (2LL * split) * n + idx) =
          make_float2(k0v, k1v);
      *reinterpret_cast<float2*>(a.part + (2LL * split + 1) * n + idx) =
          make_float2(dv[v], dv[v + 1]);
    }
  }
}

// dk, dv on wgmma at D = 128 and 256: a block of two warpgroups owns 64
// keys and walks the stacked query rows that see them 64 at a time.
// Warpgroup w computes S^T = K Q^T and dP^T = V dO^T for all 64 keys and
// rows 32 w .. 32 w + 31 (m64n32), and writes P^T and dS^T (high and low
// bf16 parts) to shared memory in the swizzled layout; then it accumulates
// dV += P^T dO and dK += dS^T Q for all 64 keys and columns w D/2 ..
// (m64n(D/2), A from shared memory, dO and Q MN-major).  Split so, a
// thread holds D/2 fp32 accumulators of dV and dK together, which D = 256
// needs; Q, dO and the rows' lse and delta come by cp.async into a ring.
template <int kD>
struct KvCfg {
  static constexpr int kKeys = 64, kRows = 64;
  static constexpr int kPanels = kD / 64;
  static constexpr int kStages = kD == 256 ? 2 : 3;
  static constexpr int kTile = kPanels * 64 * 128;     // 64 rows, bf16
  static constexpr int kPTile = 64 * 128;              // 64 keys x 64 rows
  static constexpr int kNB = kD / 2;                   // columns a warpgroup
  static constexpr int kSmem = 1024 + (2 + 2 * kStages) * kTile + 4 * kPTile
                               + 2 * kStages * kRows * 4;
};

template <int kD>
__global__ void __launch_bounds__(256, 1) dkdv_wgmma(BwdArgs a) {
  using C = KvCfg<kD>;
  constexpr int kSt = C::kStages, kNB = C::kNB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Vs = Ks + C::kTile;
  uint8_t* Qs = Vs + C::kTile;                 // kSt stages
  uint8_t* dOs = Qs + kSt * C::kTile;          // kSt stages
  uint8_t* Ph = dOs + kSt * C::kTile;          // P^T high  [key][row]
  uint8_t* Pl = Ph + C::kPTile;                // P^T low   [key][row]
  uint8_t* dSh = Pl + C::kPTile;               // dS^T high [key][row]
  uint8_t* dSl = dSh + C::kPTile;              // dS^T low  [key][row]
  float* lse_s = reinterpret_cast<float*>(dSl + C::kPTile);
  float* del_s = lse_s + kSt * C::kRows;

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  // grid (n_split * B*K, key tiles), longest first as in dkdv_wgmma64
  const int k0 = blockIdx.y * C::kKeys, split = blockIdx.x % a.n_split,
            bk = blockIdx.x / a.n_split;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const long long slab = (long long)bk * G * S * D;
  const bf16* qb = static_cast<const bf16*>(a.q) + slab;
  const bf16* gb = static_cast<const bf16*>(a.dout) + slab;
  const bf16* kb = static_cast<const bf16*>(a.k) + (long long)bk * T * D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (long long)bk * T * D;

  const int n_tiles = (S * G + C::kRows - 1) / C::kRows;
  const int first = a.causal ? min(n_tiles, (k0 * G) / C::kRows) : 0;
  const int per = (n_tiles - first + a.n_split - 1) / a.n_split;
  const int t_begin = first + split * per;
  const int t_end = min(n_tiles, t_begin + per);

  auto load_rows = [&](int tile, int st) {
    const int r0 = tile * C::kRows;
    load_q_do<kD, 256, 64>(Qs + st * C::kTile, dOs + st * C::kTile, qb, gb,
                           r0, 0, threadIdx.x, a);
    load_row_stats(lse_s + st * C::kRows, del_s + st * C::kRows, r0,
                   C::kRows, bk, a);
  };
  load_k_v<kD, 256>(Ks, Vs, kb, vb, k0, a);
#pragma unroll
  for (int s = 0; s < kSt - 1; ++s) {
    if (t_begin + s < t_end) load_rows(t_begin + s, s);
    hopper::cp_async_commit();
  }

  // this thread's keys ka and ka + 8; its accumulator columns 2 (lane % 4)
  // + {0, 1} of each 8-wide group: rows 32 wg + .. of S^T, or columns
  // wg D/2 + .. of dV and dK
  const int ka = warp * 16 + (lane >> 2);
  const int c2 = 2 * (lane & 3);
  const float sl2 = a.scale * 1.4426950408889634f;
  float dv[kNB / 2], dk[kNB / 2];
#pragma unroll
  for (int v = 0; v < kNB / 2; ++v) dv[v] = dk[v] = 0.f;
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  const uint32_t ph_base = smem_addr(Ph), pl_base = smem_addr(Pl),
                 sh_base = smem_addr(dSh), sl_base = smem_addr(dSl);
  const uint32_t nb_off = (wg * kNB / 64) * (64 * 128);   // first D panel

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) % kSt, r0 = tile * C::kRows;
    if (tile + kSt - 1 < t_end)
      load_rows(tile + kSt - 1, (tile - t_begin + kSt - 1) % kSt);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kSt - 1>();
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t q_base = smem_addr(Qs + st * C::kTile);
    const uint32_t o_base = smem_addr(dOs + st * C::kTile);
    const float* lse_t = lse_s + st * C::kRows;
    const float* del_t = del_s + st * C::kRows;

    // S^T and dP^T: all 64 keys x rows 32 wg .. 32 wg + 31, over D
    float sT[16], dpT[16];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t ka_off = (kk / 4) * (64 * 128) + (kk % 4) * 32;
      const uint32_t rb_off = ka_off + wg * 32 * 128;
      hopper::wgmma_ss<32>(sT, hopper::gmma_desc(k_base + ka_off, 0, 1024),
                           hopper::gmma_desc(q_base + rb_off, 0, 1024),
                           kk > 0);
      hopper::wgmma_ss<32>(dpT, hopper::gmma_desc(v_base + ka_off, 0, 1024),
                           hopper::gmma_desc(o_base + rb_off, 0, 1024),
                           kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sT);
    hopper::fence_regs(dpT);

    // P^T and dS^T = P^T (dP^T - delta) to shared memory as bf16, each in
    // a high and a low part, masked only where the step crosses the
    // diagonal, T or S * G
    const bool edge = r0 + C::kRows > S * G || k0 + C::kKeys > T
                      || (a.causal && k0 + C::kKeys - 1 > r0 / G);
#pragma unroll
    for (int v = 0; v < 16; v += 2) {
      const int key = ka + 8 * ((v >> 1) & 1), kp = k0 + key;
      const int r = wg * 32 + 8 * (v >> 2) + c2;
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = r0 + r + e;
        p[e] = exp2f(fmaf(sT[v + e], sl2,
                          -lse_t[r + e] * 1.4426950408889634f));
        if (edge && (row >= S * G || kp >= T
                     || (a.causal && kp > row / G)))
          p[e] = 0.f;
        ds[e] = p[e] * (dpT[v + e] - del_t[r + e]);
      }
      const uint32_t off = key * 128 + (((r >> 3) ^ (key & 7)) << 4)
                           + (r & 7) * 2;
      uint32_t lo;
      *reinterpret_cast<uint32_t*>(Ph + off) = hopper::split_bf16(p, lo);
      *reinterpret_cast<uint32_t*>(Pl + off) = lo;
      *reinterpret_cast<uint32_t*>(dSh + off) = hopper::split_bf16(ds, lo);
      *reinterpret_cast<uint32_t*>(dSl + off) = lo;
    }
    hopper::fence_proxy_async();
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the step's rows, 16 at a time,
    // for columns wg D/2 ..
    hopper::wgmma_fence();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint32_t bo = nb_off + kt * 16 * 128;
      const uint64_t dod = hopper::gmma_desc(o_base + bo, 64 * 128, 1024);
      const uint64_t qd = hopper::gmma_desc(q_base + bo, 64 * 128, 1024);
      hopper::wgmma_sst<kNB>(dv, hopper::gmma_desc(ph_base + kt * 32, 0,
                                                   1024), dod, 1);
      hopper::wgmma_sst<kNB>(dv, hopper::gmma_desc(pl_base + kt * 32, 0,
                                                   1024), dod, 1);
      hopper::wgmma_sst<kNB>(dk, hopper::gmma_desc(sh_base + kt * 32, 0,
                                                   1024), qd, 1);
      hopper::wgmma_sst<kNB>(dk, hopper::gmma_desc(sl_base + kt * 32, 0,
                                                   1024), qd, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv);
    hopper::fence_regs(dk);
    __syncthreads();      // the stage, P^T and dS^T are rewritten next step
  }
  hopper::cp_async_wait<0>();

  const long long n = (long long)a.BK * T * D;
#pragma unroll
  for (int v = 0; v < kNB / 2; v += 2) {
    const int key = k0 + ka + 8 * ((v >> 1) & 1);
    const int d = wg * kNB + 8 * (v >> 2) + c2;
    if (key >= T || d >= D) continue;
    const long long idx = ((long long)bk * T + key) * D + d;
    const float k0v = dk[v] * a.scale, k1v = dk[v + 1] * a.scale;
    if (a.n_split == 1) {
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dk) + idx) =
          hopper::pack_bf16(k0v, k1v);
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(a.dv) + idx) =
          hopper::pack_bf16(dv[v], dv[v + 1]);
    } else {
      *reinterpret_cast<float2*>(a.part + (2LL * split) * n + idx) =
          make_float2(k0v, k1v);
      *reinterpret_cast<float2*>(a.part + (2LL * split + 1) * n + idx) =
          make_float2(dv[v], dv[v + 1]);
    }
  }
}

template <int kD>
int launch_wgmma(const BwdArgs& a, cudaStream_t stream) {
  // dq first: it writes delta, which the dk/dv kernel reads
  using Q = DqCfg<kD>;
  CUtensorMap tm_k, tm_v;
  int e = hopper::kv_map(&tm_k, a.k, a.D, a.T, a.BK, Q::kN);
  if (e == 0) e = hopper::kv_map(&tm_v, a.v, a.D, a.T, a.BK, Q::kN);
  if (e != 0) return e;
  auto qk = dq_wgmma<kD>;
  cudaError_t err = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.S * a.G + Q::kRows - 1) / Q::kRows;
  qk<<<dim3(a.BK, row_tiles), Q::kThreads, Q::kSmem, stream>>>(tm_k, tm_v,
                                                               a);
  if constexpr (kD == 64) {
    err = cudaFuncSetAttribute(dkdv_wgmma64,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kKvwSmem);
    if (err != cudaSuccess) return (int)err;
    const int key_tiles = (a.T + kKvwKeys - 1) / kKvwKeys;
    dkdv_wgmma64<<<dim3(a.n_split * a.BK, key_tiles), 128, kKvwSmem,
                   stream>>>(a);
  } else {
    using C = KvCfg<kD>;
    auto kv = dkdv_wgmma<kD>;
    err = cudaFuncSetAttribute(
        kv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    const int key_tiles = (a.T + C::kKeys - 1) / C::kKeys;
    kv<<<dim3(a.n_split * a.BK, key_tiles), 256, C::kSmem, stream>>>(a);
  }
  if (a.n_split > 1) split_sum<bf16>(a, stream);
  return (int)cudaGetLastError();
}

template <int kD>
int launch(const BwdArgs& a, cudaStream_t stream) {
  using E = float;
  const long long n_rows = (long long)a.BK * a.G * a.S;
  delta_kernel<E><<<(unsigned)((n_rows + 7) / 8), kThreads, 0, stream>>>(
      a, n_rows);

  constexpr int smem_kv = dkdv_smem_bytes<kD>();
  auto kv = dkdv_kernel<E, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const int key_tiles = (a.T + kKeys - 1) / kKeys;
  kv<<<dim3(key_tiles, a.n_split, a.BK), kThreads, smem_kv, stream>>>(a);
  if (a.n_split > 1) split_sum<E>(a, stream);

  constexpr int smem_q = dq_smem_bytes<kD>();
  auto qk = dq_kernel<E, kD>;
  err = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.S * a.G + kRows - 1) / kRows;
  qk<<<dim3(row_tiles, a.BK), kThreads, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq (B,K,G,S,D); k, v, dk, dv (B,K,T,D); all contiguous and
// of one dtype (0 = float32, 1 = bfloat16).  lse and delta (B,K,G,S)
// float32 (delta is scratch, written here); part: n_split * 2 * B*K*T*D
// float32 scratch when n_split > 1.  D a multiple of 8, at most 256.
// Returns a CUDA error code (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int B, int K, int G, int S, int T, int D,
    int causal, float scale, int n_split, int dtype, void* stream) {
  if (B < 1 || K < 1 || G < 1 || S < 1 || T < 1 || D < 8 || D > 256
      || D % 8 != 0 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv,
            static_cast<float*>(part), B * K, G, S, T, D, causal, n_split,
            scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 64) return launch<64>(a, s);
    if (D <= 128) return launch<128>(a, s);
    return launch<256>(a, s);
  }
  if (dtype == 1) {
    if (D <= 64) return launch_wgmma<64>(a, s);
    if (D <= 128) return launch_wgmma<128>(a, s);
    return launch_wgmma<256>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
