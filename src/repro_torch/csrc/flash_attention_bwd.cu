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
//   dq = scale * ds k,  dk = ds^T (q * scale),
// where dk and dv sum over the G heads that share a KV head.
//
// What bounds it on this card: operations (about 2.5x the forward's flops
// on about twice its bytes).
//
// What the design does about it:
// * Three kernels, no atomics, so the result does not depend on timing:
//   `delta_kernel` (one warp per row), `dkdv_kernel` (a block per 32 keys
//   walks the stacked query rows that see them) and `dq_kernel` (a block
//   per 64 stacked rows walks the key tiles they see).  Each recomputes the
//   scores it needs.
// * The stacked rows (row = s * G + g) let one K/V tile serve all G heads
//   and make the GQA sum over heads part of the row loop.  Under the causal
//   mask a key tile starting at k0 meets only rows from k0 * G on, and a
//   row tile only keys up to its last position.
// * With K = 1 and B = 2 there are only 2 * T / 32 key tiles (128 at
//   T = 2048), and the first one walks every row tile.  So each key tile's
//   rows are split across `n_split` blocks, which write fp32 partial dk and
//   dv; `split_sum_kernel` adds the partials in split order.
// * FFMA from fp32 shared memory (flash_tiles.cuh), as in the forward.
// Simple first: no tensor cores, no TMA, no pipelining.

#include "flash_tiles.cuh"

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

template <typename E, int kD>
int launch(const BwdArgs& a, cudaStream_t stream) {
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
  if (a.n_split > 1) {
    const long long n = (long long)a.BK * a.T * a.D;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    split_sum_kernel<E><<<blocks, kThreads, 0, stream>>>(a);
  }

  constexpr int smem_q = dq_smem_bytes<kD>();
  auto qk = dq_kernel<E, kD>;
  err = cudaFuncSetAttribute(
      qk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.S * a.G + kRows - 1) / kRows;
  qk<<<dim3(row_tiles, a.BK), kThreads, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<E, 64>(a, stream);
  if (a.D <= 128) return launch<E, 128>(a, stream);
  return launch<E, 256>(a, stream);
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
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}
