// Single-token (decode) attention over a KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention`, body `_decode_kernel`): one query token per group of
// G query heads sharing a KV head attends over the first `length` rows of a
// (T, D) K/V cache, with an fp32 running softmax (m, l, acc).  The output
// is in q's dtype.
//
// What bounds it on this card: latency, far above bytes.  Each K and V row
// is read once and used for G dot products, about 4*G flops per cache
// element, far below the ~295 flops/byte an H100 needs before compute
// matters; at the serving shapes the bytes take 0.2-1.6 us, under the cost
// of one launch.  So the design counts dependent steps: one launch a call,
// every load of a block in flight at once, no barrier between a load and
// its use.
//
// What the design does about it:
// * One launch a call.  Each (b, k) and group of `heads` query heads gets
//   its valid rows split across `n_split` <= 8 blocks (flash-decoding),
//   and those blocks form one thread-block cluster.  Each block leaves its
//   (m, l, acc) in its own shared memory; after a cluster barrier every
//   block merges a share of the outputs, reading the others' partials
//   through distributed shared memory, and a second barrier keeps each
//   block's shared memory alive until all have read it.  A cluster, and
//   not a last-arriving block over global scratch: no scratch tensor, no
//   arrival counter to reset, no round trip to L2 between a block's result
//   and the merge.  8 is the portable cluster size, so every cluster can be
//   scheduled.  A split alone (n_split == 1) writes its output directly.
// * A block takes all G query heads of its KV head (`heads` = G rounded up
//   to 1, 2, 4 or 8), so each K and V row it loads serves every one of
//   them.  At G = 16 two head groups of 8 read each row once apiece (the
//   second read hits L2): 16 heads' q and acc would not fit a lane's
//   registers.  q is loaded once a block, in 16-byte pieces, through
//   shared memory; the merges and the output move 16 bytes a thread.
// * Inside a block each warp works alone.  A step is the R = 32 / lanes
//   rows that one warp covers at once, `lanes` lanes a row, each lane one
//   16-byte chunk of D (two for fp32 at D > 128).  Each warp's own 8-stage
//   ring in shared memory receives its steps by 16-byte cp.async, up to 7
//   ahead; a lane reads back only the chunks it copied itself, so a wait on
//   its own cp.async groups is all the synchronisation a step needs.  Rows
//   at or past `length` are never read (zero-filled, weight 0); a lane's
//   chunks past D (fp32 at D <= 128, or D / kVec not a power of 2) are
//   never copied and are taken as 0, not read from the ring.  K and V
//   are read through element strides, so the serving cache (B, S_max, K,
//   D) is read in place with no copy.  The four warps take interleaved
//   steps; their partials are merged in the block before the cluster
//   merge.
// * The heads of a block are a template parameter (kGw), so the per-head
//   loops unroll into independent chains; q (scaled by log2(e) / sqrt(D))
//   and acc live in registers.
// * The split count (kernels/decode_attention.py) comes from B*K, the head
//   groups, D and the length: enough blocks to cover the SMs twice, no
//   split longer than its warps hold in flight at once when the length
//   allows it, at least 2 * heads rows a split, at most 8.
// * The math is FFMA in fp32: at G <= 16 one query row a head would fill
//   at most 16 of the 64 rows of a wgmma tile, and the work is latency, not
//   flops.
// * With length == 0 the output is zero, as the TPU kernel returns.  q may
//   be fp32 over a bf16 cache.
// * An fp8 (e4m3) cache, q fp32 or bf16 (the reference's serving cache
//   with kv_dtype=float8_e4m3fn, which its Pallas kernel casts to fp32 as
//   it does bf16): a 16-byte chunk holds 16 values, decoded into fp32 in
//   registers by `unpack16` from their bits (`e4m3_to_f`: exact for
//   normals and subnormals, the encoding's NaN S.1111.111 decoded to NaN,
//   as the reference's astype(float32) does).  The rings, the softmax and
//   the merges are the bf16 route's.  A chunk's 16 values make a lane's q
//   and acc twice the bf16 route's, so a block takes at most 4 heads
//   (G 8: two blocks read each row, the second from L2).  The route reads
//   half the bf16 route's bytes for the same FFMA work, and each head
//   group decodes every value again (~6 integer ops a value): on an H100
//   at gemma-2b's decode_32k shape (B 128, 32,768 rows, G 8) a call takes
//   4.89 ms against its 0.641 ms bytes bound, bound by that work, not by
//   bytes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 8;            // steps in each warp's cp.async ring
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
constexpr int kMaxSplit = 8;          // blocks of a cluster (portable)
constexpr float kLog2e = 1.4426950408889634f;

// An fp8 e4m3 cache element (1 sign, 4 exponent bits of bias 7, 3
// mantissa bits; no infinities, S.1111.111 is NaN): the bits only.
struct e4m3 {
  uint8_t bits;
};
constexpr uint32_t kE4m3Bias = 7;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// e4m3 bits (in the low byte of b) as fp32: the exponent and mantissa
// placed under fp32's (bias 127) and scaled by 2^(127 - kE4m3Bias), exact
// for normals and subnormals alike (an fp32 subnormal times 2^120 is
// exact: nvcc keeps fp32 subnormals unless -ftz); the NaN encoding to NaN.
__device__ __forceinline__ float e4m3_to_f(uint32_t b) {
  const float scale = __uint_as_float((254u - kE4m3Bias) << 23);
  const float x = __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20))
                  * scale;
  return (b & 0x7Fu) == 0x7Fu ? __uint_as_float(0x7FC00000u) : x;
}

// 16 bytes as fp32
__device__ __forceinline__ void unpack16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const e4m3* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[4 * i + j] = e4m3_to_f(w[i] >> (8 * j));
}

// Cluster barriers: the first publishes each block's partials in its
// shared memory (release / acquire); the last only keeps that memory alive
// until every block has read it, so it orders nothing and does not wait
// for the output's stores.
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16-byte chunks of D a lane owns: two for fp32 (D up to 64 chunks)
template <typename TKV>
__host__ __device__ constexpr int chunks_per_lane() {
  return sizeof(TKV) == 4 ? 2 : 1;
}
// one step of one warp in its ring: K then V, 32 lanes x chunks x 16 bytes
template <typename TKV>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * chunks_per_lane<TKV>() * 32 * 16;
}
// Dynamic shared memory: the warps' rings (reused for the warps' partial
// acc, kWarps x 8 x D fp32, after the loop), then the block's partial acc
// and its q, kGw x D fp32 each.
template <typename TKV>
__host__ __device__ constexpr int ring_bytes() {
  return kWarps * kStages * stage_bytes<TKV>();
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int K, G, D, length, rows_per_split;
  int q_vec;                           // q rows 16-byte aligned: vector loads
  float scale;                         // 1/sqrt(D), from the host
  long long qs_b, qs_k, qs_g;          // q strides (elements), d stride 1
  long long ks_b, ks_k, ks_t;          // k strides
  long long vs_b, vs_k, vs_t;          // v strides
  long long os_b, os_k, os_g;          // out strides
};

// kVec outputs from fp32, by 16-byte stores
__device__ __forceinline__ void store_out(float* p, const float* x, int n) {
  for (int e = 0; e < n; e += 4)
    *reinterpret_cast<float4*>(p + e) = make_float4(x[e], x[e + 1], x[e + 2],
                                                    x[e + 3]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* x,
                                          int n) {
  for (int e = 0; e < n; e += 8) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[e + 2 * i],
                                                     x[e + 2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p + e) = v;
  }
}

// kVec elements of q at p as fp32, by 16-byte loads when `vec`
template <typename TQ, int kVec>
__device__ __forceinline__ void load_q(const TQ* p, bool vec, float* x) {
  constexpr int kPer = 16 / sizeof(TQ);
  if (vec) {
#pragma unroll
    for (int e = 0; e < kVec; e += kPer) unpack16(p + e, x + e);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = to_f(p[e]);
  }
}

// Grid (n_split, B*K*ceil(G/kGw)): one cluster of n_split blocks per (b,
// k, group of kGw heads).
template <typename TQ, typename TKV, int kGw>
__global__ void __launch_bounds__(kThreads)
decode_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(TKV);
  constexpr int kJ = chunks_per_lane<TKV>();
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G, D = a.D, tid = threadIdx.x;
  const int n_hb = (G + kGw - 1) / kGw;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int bk = blockIdx.y / n_hb, g0 = blockIdx.y % n_hb * kGw;
  const int b = bk / a.K, kh = bk % a.K;
  const int n_g = min(kGw, G - g0);    // heads of this block
  const int warp = tid >> 5, lane = tid & 31;
  const int c16 = D / kVec;
  int lanes = 1;                       // lanes a row: a power of 2, <= 32
  while (lanes < c16 && lanes < 32) lanes *= 2;
  const int R = 32 / lanes;            // rows a step
  const int li = lane % lanes, rp = lane / lanes;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* part = reinterpret_cast<float*>(smem);     // kWarps x kGw x D
  float* red = reinterpret_cast<float*>(smem + ring_bytes<TKV>());  // kGw x D
  float* qs = red + kGw * D;           // kGw x D: q, scaled
  __shared__ float wm[kWarps][kGw], wl[kWarps][kGw], bw[kWarps][kGw];
  __shared__ float m_s[kGw], l_s[kGw];
  __shared__ float wgt[kMaxSplit][kGw], lrem[kMaxSplit][kGw], lsum[kGw];

  const TKV* kp = static_cast<const TKV*>(a.k) + b * a.ks_b + kh * a.ks_k;
  const TKV* vp = static_cast<const TKV*>(a.v) + b * a.vs_b + kh * a.vs_k;
  const int t_begin = split * a.rows_per_split;
  const int n_rows = max(0, min(a.length, t_begin + a.rows_per_split)
                                - t_begin);
  const int n_steps = (n_rows + R - 1) / R;
  // warp w takes steps w, w + kWarps, ...
  const int my_steps =
      n_steps > warp ? (n_steps - warp + kWarps - 1) / kWarps : 0;

  // this lane's K and V chunks of its step i, into ring stage i % kStages
  char* ring = smem + warp * kStages * stage_bytes<TKV>();
  auto issue = [&](int i) {
    const int r = (warp + kWarps * i) * R + rp;
    const bool valid = r < n_rows;
    const long long t = t_begin + (valid ? r : 0);
    char* st = ring + (i % kStages) * stage_bytes<TKV>();
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = li + lanes * j;
      if (c < c16) {
        hopper::cp_async16(st + (j * 32 + lane) * 16,
                           kp + t * a.ks_t + c * kVec, valid ? 16 : 0);
        hopper::cp_async16(st + ((kJ + j) * 32 + lane) * 16,
                           vp + t * a.vs_t + c * kVec, valid ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_steps) issue(s);
    hopper::cp_async_commit();
  }

  // the block's q (heads g0 + g), scaled, loaded once by all threads in
  // 16-byte pieces where q allows it, all loads in flight; then each lane
  // keeps its chunks of every head in registers
  {
    constexpr int kPer = (kGw * kMaxD / kVec + kThreads - 1) / kThreads;
    const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qs_b + kh * a.qs_k
                   + g0 * a.qs_g;
    const float qscale = a.scale * kLog2e;
    float qv[kPer][kVec];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * kThreads, g = t / c16, c = t - g * c16;
      if (g < n_g) load_q<TQ, kVec>(qp + g * a.qs_g + c * kVec, a.q_vec, qv[u]);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = tid + u * kThreads, g = t / c16, c = t - g * c16;
      if (g < n_g) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) qv[u][e] *= qscale;
        store_out(qs + g * D + c * kVec, qv[u], kVec);
      }
    }
  }
  __syncthreads();
  float qr[kGw][kJ][kVec];
#pragma unroll
  for (int g = 0; g < kGw; ++g)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int c = li + lanes * j;
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 v = g < n_g && c < c16
            ? *reinterpret_cast<const float4*>(qs + g * D + c * kVec + e)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[g][j][e] = v.x;
        qr[g][j][e + 1] = v.y;
        qr[g][j][e + 2] = v.z;
        qr[g][j][e + 3] = v.w;
      }
    }

  float m[kGw], l[kGw], acc[kGw][kJ][kVec];
#pragma unroll
  for (int g = 0; g < kGw; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][j][e] = 0.f;
  }

  for (int i = 0; i < my_steps; ++i) {
    hopper::cp_async_wait<kStages - 2>();   // this lane's step i landed
    if (i + kStages - 1 < my_steps) issue(i + kStages - 1);
    hopper::cp_async_commit();
    const TKV* st = reinterpret_cast<const TKV*>(
        ring + (i % kStages) * stage_bytes<TKV>());
    const bool valid = (warp + kWarps * i) * R + rp < n_rows;
    float kv[kJ][kVec], vv[kJ][kVec], s[kGw];
    // a chunk past D was never copied: its stage slot holds whatever an
    // earlier kernel left (NaN or inf, too), so it is taken as 0, never read
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (li + lanes * j < c16) {
        unpack16(st + (j * 32 + lane) * kVec, kv[j]);
        unpack16(st + ((kJ + j) * 32 + lane) * kVec, vv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kv[j][e] = vv[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      s[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) s[g] = fmaf(qr[g][j][e], kv[j][e], s[g]);
    }
    // the row's score: a sum over its lanes
    for (int off = lanes / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < kGw; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    // the step's max over its rows, the same in every lane
    float mx[kGw];
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      s[g] = valid ? s[g] : -INFINITY;
      mx[g] = s[g];
    }
    for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < kGw; ++g)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    // online softmax; the step's first row is valid, so m_new is finite
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      const float corr = exp2f(m[g] - m_new);      // first step: 0
      const float p = exp2f(s[g] - m_new);         // rows past the end: 0
      m[g] = m_new;
      l[g] = fmaf(l[g], corr, p);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[g][j][e] = fmaf(acc[g][j][e], corr, p * vv[j][e]);
    }
  }
  hopper::cp_async_wait<0>();

  // the warp's (l, acc): sums over its row positions (m is common)
  for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[g][j][e] += __shfl_xor_sync(0xffffffffu, acc[g][j][e], off);
    }
  __syncthreads();                     // every ring drained: reuse it
  if (rp == 0) {
#pragma unroll
    for (int g = 0; g < kGw; ++g)
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = li + lanes * j;
        float4* dst = reinterpret_cast<float4*>(
            part + (warp * kGw + g) * D + c * kVec);
        if (c < c16)
#pragma unroll
          for (int e = 0; e < kVec; e += 4)
            dst[e / 4] = make_float4(acc[g][j][e], acc[g][j][e + 1],
                                     acc[g][j][e + 2], acc[g][j][e + 3]);
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kGw; ++g) {
      wm[warp][g] = m[g];
      wl[warp][g] = l[g];
    }
  }
  __syncthreads();

  // the block's partial: its warps' partials, merged
  if (tid < n_g) {
    const int g = tid;
    float mb = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w][g]);
    float lb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      bw[w][g] = mb == -INFINITY ? 0.f : exp2f(wm[w][g] - mb);
      lb = fmaf(wl[w][g], bw[w][g], lb);
    }
    m_s[g] = mb;
    l_s[g] = lb;
  }
  __syncthreads();
  // a split alone (n_split == 1) writes the output here; a thread takes
  // kVec consecutive outputs of one head
  const bool alone = n_split == 1;
  TQ* out = static_cast<TQ*>(a.out) + b * a.os_b + kh * a.os_k
            + g0 * a.os_g;
  for (int t = tid; t < n_g * c16; t += kThreads) {
    const int g = t / c16, d = (t - g * c16) * kVec;
    float o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      float x[kVec];
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            part + (w * kGw + g) * D + d + e);
        x[e] = v.x; x[e + 1] = v.y; x[e + 2] = v.z; x[e + 3] = v.w;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = fmaf(bw[w][g], x[e], o[e]);
    }
    if (alone) {
      const float inv = l_s[g] > 0.f ? 1.f / l_s[g] : 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] *= inv;
      store_out(out + g * a.os_g + d, o, kVec);
    } else {
      store_out(red + g * D + d, o, kVec);
    }
  }
  if (alone) return;

  // merge the cluster's partials: weights from every block's (m, l)
  cluster_sync_acq_rel();
  if (tid < n_split * n_g) {
    const int s = tid / n_g, g = tid % n_g;
    wgt[s][g] = *cluster.map_shared_rank(m_s + g, s);
    lrem[s][g] = *cluster.map_shared_rank(l_s + g, s);
  }
  __syncthreads();
  if (tid < n_g) {
    const int g = tid;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, wgt[s][g]);
    float lt = 0.f;
    for (int s = 0; s < n_split; ++s) {
      // an empty split (m = -inf) weighs 0; all empty: length 0, output 0
      const float w = mx == -INFINITY ? 0.f : exp2f(wgt[s][g] - mx);
      wgt[s][g] = w;
      lt = fmaf(lrem[s][g], w, lt);
    }
    lsum[g] = lt > 0.f ? 1.f / lt : 0.f;
  }
  __syncthreads();
  // this block's share of the outputs, kVec consecutive ones a thread
  for (int t = split * kThreads + tid; t < n_g * c16;
       t += n_split * kThreads) {
    const int g = t / c16, d = (t - g * c16) * kVec;
    float o[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      if (s < n_split) {
        const float* src = cluster.map_shared_rank(red + g * D + d, s);
        float x[kVec];
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 v = *reinterpret_cast<const float4*>(src + e);
          x[e] = v.x; x[e + 1] = v.y; x[e + 2] = v.z; x[e + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) o[e] = fmaf(wgt[s][g], x[e], o[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] *= lsum[g];
    store_out(out + g * a.os_g + d, o, kVec);
  }
  cluster_sync_relaxed();              // partials stay until all have read
}

template <typename TQ, typename TKV, int kGw>
int launch(const Args& a, int B, int n_split, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<TQ, TKV, kGw>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring_bytes<TKV>() + 2 * kGw * kMaxD * 4);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * a.K * ((a.G + kGw - 1) / kGw), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = ring_bytes<TKV>() + 2 * kGw * a.D * 4;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_kernel<TQ, TKV, kGw>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// heads a block owns (1, 2, 4 or 8; an e4m3 cache 1, 2 or 4), chosen by
// the caller
template <typename TQ, typename TKV>
int launch_g(const Args& a, int B, int n_split, int heads,
             cudaStream_t stream) {
  switch (heads) {
    case 1: return launch<TQ, TKV, 1>(a, B, n_split, stream);
    case 2: return launch<TQ, TKV, 2>(a, B, n_split, stream);
    case 4: return launch<TQ, TKV, 4>(a, B, n_split, stream);
    case 8:
      if constexpr (sizeof(TKV) > 1)
        return launch<TQ, TKV, 8>(a, B, n_split, stream);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// bytes of a cache element of dtype code `dtype_kv`, 0 for a code the
// kernel does not take
int kv_element_bytes(int dtype_kv) {
  switch (dtype_kv) {
    case 0: return 4;
    case 1: return 2;
    case 2: return 1;
    default: return 0;
  }
}

}  // namespace

// dtypes: 0 = float32, 1 = bfloat16, 2 = float8 e4m3 (the cache only); q
// and the output share dtype_q, k and v share dtype_kv (an fp32 model may
// read a bf16 cache; either reads an e4m3 one).  k and v rows are read in
// 16-byte pieces: D * element size a multiple of 16, k and v 16-byte
// aligned, their strides multiples of 16 bytes; q_vec says the same of q.
// `heads` (1, 2, 4 or 8; 1, 2 or 4 over e4m3) query heads a block; 1 <=
// n_split <= 8 blocks of `rows_per_split` rows each per (b, k, group of
// heads).  Returns a CUDA error code (0 on success; cudaErrorInvalidValue,
// with nothing launched, for arguments it does not take).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    int B, int K, int G, int D, int length, int n_split, int rows_per_split,
    int heads, int q_vec, float scale,
    long long qs_b, long long qs_k, long long qs_g,
    long long ks_b, long long ks_k, long long ks_t,
    long long vs_b, long long vs_k, long long vs_t,
    long long os_b, long long os_k, long long os_g,
    int dtype_q, int dtype_kv, void* stream) {
  const long long elsize = kv_element_bytes(dtype_kv);
  if (elsize == 0 || G > kMaxG || D > kMaxD || G < 1 || D < 1
      || (D * elsize) % 16 != 0 || n_split < 1 || n_split > kMaxSplit
      || rows_per_split < 1 || B < 1 || K < 1
      || reinterpret_cast<uintptr_t>(k) % 16 != 0
      || reinterpret_cast<uintptr_t>(v) % 16 != 0
      || (ks_b * elsize) % 16 || (ks_k * elsize) % 16 || (ks_t * elsize) % 16
      || (vs_b * elsize) % 16 || (vs_k * elsize) % 16 || (vs_t * elsize) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, K, G, D, length, rows_per_split, q_vec, scale,
         qs_b, qs_k, qs_g, ks_b, ks_k, ks_t, vs_b, vs_k, vs_t,
         os_b, os_k, os_g};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_q == 0 && dtype_kv == 0)
    return launch_g<float, float>(a, B, n_split, heads, s);
  if (dtype_q == 1 && dtype_kv == 1)
    return launch_g<__nv_bfloat16, __nv_bfloat16>(a, B, n_split, heads, s);
  if (dtype_q == 0 && dtype_kv == 1)
    return launch_g<float, __nv_bfloat16>(a, B, n_split, heads, s);
  if (dtype_q == 0 && dtype_kv == 2)
    return launch_g<float, e4m3>(a, B, n_split, heads, s);
  if (dtype_q == 1 && dtype_kv == 2)
    return launch_g<__nv_bfloat16, e4m3>(a, B, n_split, heads, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// Every word of the block's dynamic shared memory set to all ones (NaN in
// fp32 and bf16); volatile, so the stores that nothing reads stay.
__global__ void fill_shared_nan_kernel(int words) {
  extern __shared__ uint32_t fill_words[];
  volatile uint32_t* w = fill_words;
  for (int i = threadIdx.x; i < words; i += blockDim.x) w[i] = 0xffffffffu;
}

}  // namespace

// A check's aid, on no serving path: fills the shared memory of every SM
// of the current device with NaN (4 blocks an SM, each with the most
// dynamic shared memory a block may have), so that a kernel launched next
// on `stream` gives NaN where it reads shared memory it did not write.
// Returns a CUDA error code (0 on success).
extern "C" int decode_attention_fill_shared_nan(void* stream) {
  int dev = 0, bytes = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fill_shared_nan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  fill_shared_nan_kernel<<<4 * sms, 1024, bytes,
                           static_cast<cudaStream_t>(stream)>>>(bytes / 4);
  return (int)cudaGetLastError();
}
