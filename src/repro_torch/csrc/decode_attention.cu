// Single-token (decode) attention over a KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`): one query token per group of
// G query heads sharing a KV head attends over the first `length` rows of a
// (T, D) K/V cache, with an fp32 running softmax (m, l, acc).  The output
// is in q's dtype.
//
// What bounds it on this card: bytes.  Each K and V row is read once and
// used for G dot products, so the kernel does about 4*G flops per cache
// element -- far below the ~295 flops/byte an H100 needs before compute
// matters.  The time is HBM traffic over the valid rows, plus launch cost
// when the cache is short.
//
// What the design does about it:
// * The TPU grid walks the cache sequentially on one core and carries
//   (m, l, acc) in scratch.  Here B*K (4 at gemma-2b batch 4) blocks would
//   leave most of the 132 SMs idle, so the valid rows are split across
//   `n_split` blocks per (b, k) (flash-decoding).  Each block keeps its own
//   (m, l, acc) and writes them unnormalised to fp32 scratch; a second
//   kernel merges the partials.  Results match the sequential reference
//   to rounding, not bit for bit.
// * Rows at or past `length` are never read, so a ragged cache needs no
//   padding, and a split that owns no rows writes an empty partial.  With
//   length == 0 the output is zero, as the TPU kernel returns.
// * K and V are read through element strides, so the serving cache
//   (B, S_max, K, D) is read in place with no transposed copy.  D must have
//   unit stride.
// * Scores: each warp owns rows of the tile; its lanes split D, load the
//   whole row at once and reduce the G dot products with shuffles.
//   Values: each thread owns up to two columns of D for all G heads, so V
//   rows are read coalesced, kRowsInFlight rows in flight at a time.  (The
//   first version waited for each load before the next, and its time grew
//   with one HBM latency per element a thread read.)
// Simple first: no TMA, no cp.async pipeline, scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;              // cache rows per tile
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kDPerThread = kMaxD / kThreads;   // 2
constexpr int kRowsInFlight = 8;      // V rows loaded before their FMAs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

struct Args {
  const void* q; const void* k; const void* v; void* out;
  float* part_acc;   // (B*K, n_split, G, D)
  float* part_ml;    // (B*K, n_split, G, 2): m, l
  int B, K, G, D, length, n_split, rows_per_split;
  float scale;                         // 1/sqrt(D), from the host
  long long qs_b, qs_k, qs_g;          // q strides (elements), d stride 1
  long long ks_b, ks_k, ks_t;          // k strides
  long long vs_b, vs_k, vs_t;          // v strides
  long long os_b, os_k, os_g;          // out strides
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
split_kernel(Args a) {
  const int bk = blockIdx.y;           // b * K + k
  const int split = blockIdx.x;
  const int b = bk / a.K, kh = bk % a.K;
  const int G = a.G, D = a.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float sc[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const TQ* q = static_cast<const TQ*>(a.q) + b * a.qs_b + kh * a.qs_k;
  const TKV* kp = static_cast<const TKV*>(a.k) + b * a.ks_b + kh * a.ks_k;
  const TKV* vp = static_cast<const TKV*>(a.v) + b * a.vs_b + kh * a.vs_k;
  const float scale = a.scale;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_f(q[g * a.qs_g + d]) * scale;
  }
  if (tid < G) { m_s[tid] = -INFINITY; l_s[tid] = 0.f; }

  float acc[kMaxG][kDPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) acc[g][j] = 0.f;

  const int t_begin = split * a.rows_per_split;
  const int t_end = min(a.length, t_begin + a.rows_per_split);
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    // scores for the tile's rows: warp w takes rows w, w+4, ...
    for (int r = warp; r < kTile; r += kWarps) {
      const int t = t0 + r;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (t < t_end) {
        // all of the row's loads first, so they are in flight together
        const TKV* krow = kp + (long long)t * a.ks_t;
        float kv[kMaxD / 32];
#pragma unroll
        for (int j = 0; j < kMaxD / 32; ++j) {
          const int d = lane + 32 * j;
          kv[j] = (d < D) ? to_f(krow[d]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kMaxD / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) {
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) part[g] = fmaf(qs[g][d], kv[j], part[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = part[g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) sc[g][r] = (t < t_end) ? s : -INFINITY;
        }
      }
    }
    __syncthreads();
    // online softmax update, one thread per head
    if (tid < G) {
      const int g = tid;
      float mx = m_s[g];
      for (int r = 0; r < kTile; ++r) mx = fmaxf(mx, sc[g][r]);
      const float corr = expf(m_s[g] - mx);   // m_s = -inf first: corr = 0
      float sum = 0.f;
      for (int r = 0; r < kTile; ++r) {
        const float p = expf(sc[g][r] - mx);  // masked rows: exp(-inf) = 0
        sc[g][r] = p;
        sum += p;
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      corr_s[g] = corr;
    }
    __syncthreads();
    // acc = acc * corr + p @ V over the tile
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int j = 0; j < kDPerThread; ++j)
        if (g < G) acc[g][j] *= corr_s[g];
    // kRowsInFlight V rows loaded together, then their products (rows past
    // the tile's end read as 0 and carry p = 0)
    const int rows = min(kTile, t_end - t0);
    for (int r0 = 0; r0 < rows; r0 += kRowsInFlight) {
      float vv[kRowsInFlight][kDPerThread];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const TKV* vrow = vp + (long long)(t0 + r0 + u) * a.vs_t;
#pragma unroll
        for (int j = 0; j < kDPerThread; ++j) {
          const int d = tid + j * kThreads;
          vv[u][j] = (r0 + u < rows && d < D) ? to_f(vrow[d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
#pragma unroll
        for (int j = 0; j < kDPerThread; ++j)
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][j] = fmaf(sc[g][r0 + u], vv[u][j], acc[g][j]);
    }
    __syncthreads();
  }

  const long long base = ((long long)bk * a.n_split + split) * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kDPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (g < G && d < D) a.part_acc[(base + g) * D + d] = acc[g][j];
    }
  if (tid < G) {
    a.part_ml[(base + tid) * 2 + 0] = m_s[tid];
    a.part_ml[(base + tid) * 2 + 1] = l_s[tid];
  }
}

// One block per (b*K + k, g), one thread per column d: every output reads
// the n_split partials of its column, loads unrolled so they overlap.
template <typename TQ>
__global__ void __launch_bounds__(kMaxD)
merge_kernel(Args a) {
  const int bk = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const int b = bk / a.K, kh = bk % a.K;
  const int G = a.G, D = a.D, S = a.n_split;
  if (d >= D) return;
  const float* ml = a.part_ml + ((long long)bk * S * G + g) * 2;
  const float* pa = a.part_acc + ((long long)bk * S * G + g) * D + d;
  float mx = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, ml[(long long)s * G * 2]);
  float l = 0.f, acc = 0.f;
  if (mx != -INFINITY) {
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float w = expf(ml[(long long)s * G * 2] - mx);   // empty split: 0
      l = fmaf(ml[(long long)s * G * 2 + 1], w, l);
      acc = fmaf(pa[(long long)s * G * D], w, acc);
    }
  }
  TQ* out = static_cast<TQ*>(a.out) + b * a.os_b + kh * a.os_k;
  from_f(acc / fmaxf(l, 1e-30f), out + g * a.os_g + d);
}

template <typename TQ, typename TKV>
void launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.n_split, a.B * a.K);
  split_kernel<TQ, TKV><<<grid, kThreads, 0, stream>>>(a);
  merge_kernel<TQ><<<dim3(a.B * a.K, a.G), kMaxD, 0, stream>>>(a);
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16; q and the output share dtype_q, k and
// v share dtype_kv (an fp32 model may read a bf16 cache).  Returns
// cudaGetLastError().
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    void* part_acc, void* part_ml,
    int B, int K, int G, int D, int length, int n_split, int rows_per_split,
    float scale,
    long long qs_b, long long qs_k, long long qs_g,
    long long ks_b, long long ks_k, long long ks_t,
    long long vs_b, long long vs_k, long long vs_t,
    long long os_b, long long os_k, long long os_g,
    int dtype_q, int dtype_kv, void* stream) {
  if (G > kMaxG || D > kMaxD || G < 1 || D < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), B, K, G, D, length, n_split,
         rows_per_split, scale, qs_b, qs_k, qs_g, ks_b, ks_k, ks_t,
         vs_b, vs_k, vs_t, os_b, os_k, os_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_q == 0 && dtype_kv == 0) launch<float, float>(a, s);
  else if (dtype_q == 1 && dtype_kv == 1) launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  else if (dtype_q == 0 && dtype_kv == 1) launch<float, __nv_bfloat16>(a, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
