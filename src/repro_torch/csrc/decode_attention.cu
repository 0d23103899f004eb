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
//   it does bf16) runs its own kernel, `decode_e4m3_kernel`, below.
//
// The e4m3 route.  It reads half the bf16 route's bytes for the same
// products, so the work per cache byte doubles: on an H100 the FFMA design
// above, run over e4m3 (16 values a lane, so at most 4 heads a block, each
// value decoded again by every head group, 2 G FMAs a cache element), took
// 4.9 ms at gemma-2b's decode_32k shape (B 128, 32,768 rows, G 8, D 256)
// and 9.6 ms at chatglm3-6b's (B 128, K 2, G 16, D 128) against a 0.641 ms
// bytes bound: bound by its arithmetic, and at G 16 the FMAs alone (34 G)
// take longer than the bytes.  So the route puts the products on the tensor
// cores and decodes each value once.  It is then bound by the bytes and by
// each warp's chain of dependent steps a tile (with the loads taken out it
// runs nearly as long as whole: the chains, not the tensor cores' rate).
// * One block per (b, k, split) takes all G <= 16 heads of its KV head (8
//   or 16 head slots, G < 8 zero-padded), so each K and V row leaves HBM
//   once and is decoded once.  Splits and their cluster merge are the bf16
//   route's (a split a 64 rows, up to 8).
// * Loads: TMA, one box a tile per e4_box(D)-byte panel of K and of V (the
//   cache read in place through its strides, rows at or past `length`
//   outside the map: zeros), into a ring of 3-8 stages, completion on an
//   mbarrier per stage.  The last of the 8 warps to release a stage loads
//   the tile S ahead into it (a count in shared memory), so no warp waits
//   to produce.  The panels land in the TMA swizzle, so the 8 rows an
//   ldmatrix reads meet no bank conflict.
// * Decode once: ldmatrix brings K (plain) and V (transposed) bytes into
//   the operand layout of mma.sync m16n8k16, and `e4m3x4_to_f16` turns 4
//   values into two f16x2 words with the card's conversion (cvt.rn.f16x2.
//   e4m3x2: fp16 holds every e4m3 value exactly, the NaN encoding S.1111.
//   111 to NaN as the reference's astype(float32) gives).  Bit operations
//   do the same in ~10 integer operations a 4-value word, enough to make
//   the integer pipe the bound.
// * Scores^T (16 rows x 8 heads) = K q^T with q as the B operand (heads in
//   the n = 8 slot, G 16 two n-tiles), out^T (D x heads) += V^T P^T; both
//   accumulate in fp32 and the online softmax stays fp32 per head column.
//   Within a product the order of the k index is free, so a lane's 4 K
//   bytes of a row serve two k pairs as they lie; q's fragments are laid
//   out to match, and V's bytes are paired by row with one byte_perm.  P
//   goes from the scores' C layout to the B layout by movmatrix.trans.
//   mma.sync rather than wgmma: a warp owns 16 rows, and 64-row wgmma tiles
//   at 8-16 heads would tie 4 warps to each step for a small share of the
//   work.
// * Warps: 8 a block, one an SM (registers: up to ~190 a thread).  At D <=
//   128 a warp takes two slices of 16 rows a tile and one softmax step for
//   both (chatglm3's 16 heads: half the shuffles and rescales a row).  Two
//   warps share each 16 rows, half of D each (scores' halves swapped
//   through shared memory), over 16 heads at D > 128, where one warp's
//   accumulators would need 128 values a lane, and in splits of <= 64
//   rows, where the shorter chains end a short call sooner.  In a split's
//   last tile the rows past its end get score -inf and V rows of 0, so the
//   next split's rows (NaN too) weigh nothing.
// * q: each head's largest |q| is taken to [2^13, 2^14) by a power of two
//   (put back on its fp32 scores): bf16 q is then exact in fp16 (8
//   significant bits) down to 2^-30 of that largest value; fp32 q goes in
//   as three fp16 terms and P as two, so with the cache's 4 significant
//   bits each product is exact and the fp32 sums meet the fp32 tolerance.
// * Each warp keeps its own (m, l, acc) over its rows; the warps and then
//   the cluster's blocks merge as in the bf16 route.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// heads a block owns (1, 2, 4 or 8), chosen by the caller
template <typename TQ, typename TKV>
int launch_g(const Args& a, int B, int n_split, int heads,
             cudaStream_t stream) {
  switch (heads) {
    case 1: return launch<TQ, TKV, 1>(a, B, n_split, stream);
    case 2: return launch<TQ, TKV, 2>(a, B, n_split, stream);
    case 4: return launch<TQ, TKV, 4>(a, B, n_split, stream);
    case 8: return launch<TQ, TKV, 8>(a, B, n_split, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
// ------------------------------------------------------- the e4m3 route
// One block per (b, k, split): all G <= 16 heads of a KV head (see the note
// at the top).

constexpr int kE4Warps = 8;            // a block's warps, 16 rows each
constexpr int kE4Threads = kE4Warps * 32;
constexpr int kE4MaxStages = 8;

// rows of a ring stage: `sl` slices of 16 rows a warp, or a pair of warps
// that split D
__host__ __device__ constexpr int e4_tile(int pair, int sl) {
  return 16 * sl * kE4Warps / pair;
}
// bytes the ring may take: room left for q's fragments (and the pairs'
// exchange) in one block an SM
__host__ __device__ constexpr int e4_ring_budget(int pair) {
  return pair == 1 ? 192 * 1024 : 160 * 1024;
}
// ring stages (a K and a V tile each): as many as the budget holds, <= 8;
// >= 3 at every D <= 256 (two slices a warp only at D <= 128), and the
// ring holds the merge's partials
__host__ __device__ constexpr int e4_stages(int D, int pair, int sl) {
  return e4_ring_budget(pair) / (2 * e4_tile(pair, sl) * D) < kE4MaxStages
             ? e4_ring_budget(pair) / (2 * e4_tile(pair, sl) * D)
             : kE4MaxStages;
}
__host__ __device__ constexpr int e4_ring_bytes(int D, int pair, int sl) {
  return e4_stages(D, pair, sl) * 2 * e4_tile(pair, sl) * D;
}
// bytes of a row a TMA box takes: the largest power of 2 dividing D, at
// most 128; a tile is D / W panels of rows x W bytes, each in the W-byte
// swizzle (none at W 16), so the 8 rows an ldmatrix reads meet no bank
// conflict
__host__ __device__ constexpr int e4_box(int D) {
  return (D & -D) < 128 ? (D & -D) : 128;
}
// fp16 terms of q (fp32 q: three; bf16 q: one, exact) and of P (two, one)
template <typename TQ>
__host__ __device__ constexpr int q_terms() { return sizeof(TQ) == 4 ? 3 : 1; }
template <typename TQ>
__host__ __device__ constexpr int p_terms() { return sizeof(TQ) == 4 ? 2 : 1; }
// q's B fragments: a uint2 a lane for each term, 16-wide k step and n-tile
template <typename TQ>
__host__ __device__ constexpr int qfrag_bytes(int D, int n_tiles) {
  return q_terms<TQ>() * (D / 16) * n_tiles * 32 * 8;
}

// Four e4m3 values (the bytes of w) as two f16x2 words, exactly (fp16 holds
// every e4m3 value), the NaN encoding S.1111.111 as NaN: lo holds bytes 0
// and 1 (byte 0 in its low half), hi bytes 2 and 3.
__device__ __forceinline__ void e4m3x4_to_f16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, l;\ncvt.rn.f16x2.e4m3x2 %1, h;\n}\n"
      : "=r"(lo), "=r"(hi) : "r"(w));
}

__device__ __forceinline__ uint32_t h2_bits(__half2 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d (16 x 8, fp32) += A (16 x 16, fp16, row) B (16 x 8, fp16, col)
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of 8 x 8 b16 matrices (16-byte rows) at the address each lane
// gives: x4 (lanes 0-31), x2 (lanes 0-15), plain or transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// an 8 x 8 b16 matrix in a warp's fragment layout, transposed
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// One box of a 4-D tensor map at element coordinates (c0, c1, c2, c3) into
// shared memory at dst, under an L2 cache policy; completion counted on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n"
      :: "r"(hopper::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(hopper::smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "l"(policy)
      : "memory");
}

// The caches' tensor maps (e4m3_map) and where their row (bits 0-3), KV
// head (4-7) and batch (8-11) coordinates go.
struct E4Maps {
  CUtensorMap k, v;
  int kord, vord;
};

// Grid (n_split, B*K): one cluster of n_split blocks per (b, k).  kPair 1:
// warp w takes kSL slices of 16 rows (rows 16 kSL w ..) of each tile over
// all of D, one softmax step for them all; kPair 2 (kSL 1): warps w and
// w + 4 take rows 16 w .. 16 w + 15 of each 64-row tile, each the scores'
// partial over its half of D (summed between the two) and out^T over its
// half.  kNT: head tiles of 8 (G <= 8: 1, G <= 16: 2); kDC: the 16-wide
// slices of D a warp's accumulators hold.
template <typename TQ, int kNT, int kDC, int kPair, int kSL>
__global__ void __launch_bounds__(kE4Threads, 1)
decode_e4m3_kernel(const __grid_constant__ Args a,
                   const __grid_constant__ E4Maps maps) {
  constexpr int kGw = 8 * kNT;         // head slots of the block
  constexpr int kQT = q_terms<TQ>(), kPT = p_terms<TQ>();
  constexpr int kTile = e4_tile(kPair, kSL), kUnits = kE4Warps / kPair;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G, D = a.D, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int b = blockIdx.y / a.K, kh = blockIdx.y % a.K;
  const int nch = D / 16;              // 16-byte chunks of a row
  const int S = e4_stages(D, kPair, kSL), W = e4_box(D);
  const int tile_bytes = kTile * D;    // the K (or V) tile of a stage

  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned, as the 128-byte swizzle's atoms must be
  char* ring = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint2* qf = reinterpret_cast<uint2*>(ring + e4_ring_bytes(D, kPair, kSL));
  // after the loop the ring holds the units' partial acc, then the block's
  float* part = reinterpret_cast<float*>(ring);      // kUnits x kGw x D
  float* red = part + kUnits * kGw * D;               // kGw x D
  __shared__ __align__(8) uint64_t full[kE4MaxStages];
  __shared__ int released[kE4MaxStages];
  __shared__ float qmul[kGw];
  __shared__ float wm[kUnits][kGw], wl[kUnits][kGw];
  __shared__ float bw[kUnits][kGw], m_s[kGw], l_s[kGw];
  __shared__ float wgt[kMaxSplit][kGw], lrem[kMaxSplit][kGw], lsum[kGw];
  // kPair 2: the two warps of a pair swap their halves of the scores (two
  // buffers, by tile parity)
  __shared__ float xch[2][kPair == 2 ? kE4Warps : 1][kNT * 4][32];

  const int t_first = split * a.rows_per_split;
  const int n_rows = max(0, min(a.length, t_first + a.rows_per_split)
                                - t_first);
  const int n_tiles = (n_rows + kTile - 1) / kTile;
  // tile i into stage i % S: D / W boxes of K and of V; rows at or past
  // `length` lie outside the maps and arrive as zeros
  auto load_tile = [&](int i) {
    const int s = i % S;
    char* kt = ring + s * 2 * tile_bytes;
    int ck[4] = {0, 0, 0, 0}, cv[4] = {0, 0, 0, 0};
    ck[maps.kord & 3] = cv[maps.vord & 3] = t_first + i * kTile;
    ck[(maps.kord >> 4) & 3] = cv[(maps.vord >> 4) & 3] = kh;
    ck[(maps.kord >> 8) & 3] = cv[(maps.vord >> 8) & 3] = b;
    const uint64_t policy = hopper::policy_evict_first();
    hopper::mbar_expect_tx(&full[s], 2 * tile_bytes);
    for (int p = 0; p * W < D; ++p) {
      ck[0] = cv[0] = p * W;
      tma_load_4d(kt + p * kTile * W, &maps.k, &full[s], ck[0], ck[1],
                  ck[2], ck[3], policy);
      tma_load_4d(kt + tile_bytes + p * kTile * W, &maps.v, &full[s], cv[0],
                  cv[1], cv[2], cv[3], policy);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      released[s] = 0;
    }
    hopper::mbar_fence_init();
    for (int i = 0; i < min(S, n_tiles); ++i) load_tile(i);
  }

  // q, read once, a warp a head (heads w and w + 8): lane l holds d = 4 l
  // + 128 v .. + 3, the K operand's chunk 8 v + l / 4 at slot l % 4.  The
  // head's largest |q| is taken to [2^13, 2^14) by a power of two (its
  // inverse, 1/sqrt(D) and log2(e) in qmul, on the fp32 scores), then the
  // fp16 fragments: lane (g, c) of k step kc holds head 8 nt + g at d = 16
  // kc + 4 c + {0, 1} (first word) and {2, 3} (second)
  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qs_b + kh * a.qs_k;
  for (int h = warp; h < kGw; h += kE4Warps) {
    float x[2][4], mx = 0.f;
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * lane + 128 * v + e;
        x[v][e] = h < G && d < D ? to_f(qp[h * a.qs_g + d]) : 0.f;
        mx = fmaxf(mx, fabsf(x[v][e]));
      }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const int sh = mx > 0.f && isfinite(mx)
                   ? min(max(13 - ilogbf(mx), -120), 120) : 0;
    const float pw = ldexpf(1.f, sh);
    if (lane == 0) qmul[h] = ldexpf(a.scale * kLog2e, -sh);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int kc = 8 * v + lane / 4;
      if (kc < nch) {
        const int slot = ((h & 7) * 4 + (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e) x[v][e] *= pw;
#pragma unroll
        for (int t = 0; t < kQT; ++t) {
          const __half2 h01 = __floats2half2_rn(x[v][0], x[v][1]);
          const __half2 h23 = __floats2half2_rn(x[v][2], x[v][3]);
          qf[((t * nch + kc) * kNT + h / 8) * 32 + slot] =
              make_uint2(h2_bits(h01), h2_bits(h23));
          x[v][0] -= __low2float(h01);
          x[v][1] -= __high2float(h01);
          x[v][2] -= __low2float(h23);
          x[v][3] -= __high2float(h23);
        }
      }
    }
  }
  __syncthreads();

  const int unit = warp % kUnits, half = warp / kUnits;
  const int g = lane >> 2, c = lane & 3;
  // this warp's 16-byte chunks of D: [c_lo, c_hi)
  const int c_half = (nch + kPair - 1) / kPair;
  const int c_lo = half * c_half, c_hi = min(nch, c_lo + c_half);
  float acc[kDC][kNT][4], mrun[kNT][2], lrun[kNT][2], cs[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mrun[nt][j] = -INFINITY;
      lrun[nt][j] = 0.f;
      cs[nt][j] = qmul[nt * 8 + 2 * c + j];   // heads 2c, 2c + 1
    }
#pragma unroll
    for (int mt = 0; mt < kDC; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  // this lane's ldmatrix row r of a stage's K (or V) tile: row (lane & 7)
  // + 8 ((lane >> 3) & 1) of the unit's first 16 (slice sl: + 16 sl),
  // chunk + (lane >> 4) (x4: the matrices rows 0-7 and 8-15 of chunk ch,
  // then of chunk ch + 1); chunk ch of row r lies in panel ch / (W / 16),
  // at 16-byte slot (ch % (W / 16)) ^ xr of the row, the TMA swizzle (the
  // same for r + 16 sl)
  const int r = 16 * kSL * unit + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int wsh = 31 - __clz(W / 16);
  const int xr = (r >> (3 - wsh)) & ((1 << wsh) - 1);
  const uint32_t ring_s = hopper::smem_addr(ring) + r * W;
  auto chunk = [&](int ch) -> uint32_t {
    ch += lane >> 4;
    return (ch >> wsh) * (kTile * W) + (((ch & ((1 << wsh) - 1)) ^ xr) << 4);
  };
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % S;
    hopper::mbar_wait_bounded(&full[s], (i / S) & 1);
    // valid rows of the unit; rows past the split's end get weight 0
    const int nv = n_rows - i * kTile - 16 * kSL * unit;
    if (nv > 0) {
      const uint32_t kb = ring_s + s * 2 * tile_bytes;
      const uint32_t vb = kb + tile_bytes;
      // scores^T (rows g, g + 8 of each slice x heads 2c, 2c + 1 of each
      // head tile), as two sums (even and odd chunks): independent chains
      float sc[kSL][2][kNT][4];
#pragma unroll
      for (int sl = 0; sl < kSL; ++sl)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[sl][u][nt][e] = 0.f;
      for (int kc = c_lo; kc < c_hi; kc += 2) {
        const bool two = kc + 1 < c_hi;
#pragma unroll
        for (int sl = 0; sl < kSL; ++sl) {
          if (sl * 16 >= nv) break;
          uint32_t rk[4];
          if (two) ldsm_x4(rk, kb + 16 * sl * W + chunk(kc));
          else ldsm_x2(rk, kb + 16 * sl * W + chunk(kc));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && !two) break;
            // A: rows g, g + 8; k 2c, 2c + 1 are d 4c, 4c + 1 of chunk
            // kc + u (lo), k 2c + 8, 2c + 9 are d 4c + 2, 4c + 3 (hi)
            uint32_t ak[4];
            e4m3x4_to_f16(rk[2 * u], ak[0], ak[2]);
            e4m3x4_to_f16(rk[2 * u + 1], ak[1], ak[3]);
#pragma unroll
            for (int t = 0; t < kQT; ++t)
#pragma unroll
              for (int nt = 0; nt < kNT; ++nt) {
                const uint2 bq =
                    qf[((t * nch + kc + u) * kNT + nt) * 32 + lane];
                mma_f16(sc[sl][u][nt], ak, bq.x, bq.y);
              }
          }
        }
      }
#pragma unroll
      for (int sl = 0; sl < kSL; ++sl)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[sl][0][nt][e] += sc[sl][1][nt][e];
      if constexpr (kPair == 2) {
        // the other half of D, from the pair's other warp
        float (*mine)[32] = xch[i & 1][warp];
        const float (*theirs)[32] = xch[i & 1][warp ^ kUnits];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[nt * 4 + e][lane] = sc[0][0][nt][e];
        hopper::named_sync(1 + unit, 64);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[0][0][nt][e] += theirs[nt * 4 + e][lane];
      }
      // online softmax per head column over the unit's rows, base 2; rows
      // past the end -inf (kPair 2: both warps of a pair keep the same m, l
      // and P)
      float pr[kSL][kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float top = -INFINITY;
#pragma unroll
          for (int sl = 0; sl < kSL; ++sl) {
            const bool v0 = 16 * sl + g < nv, v1 = 16 * sl + g + 8 < nv;
            pr[sl][nt][j] = v0 ? sc[sl][0][nt][j] * cs[nt][j] : -INFINITY;
            pr[sl][nt][2 + j] =
                v1 ? sc[sl][0][nt][2 + j] * cs[nt][j] : -INFINITY;
            top = fmaxf(top, fmaxf(pr[sl][nt][j], pr[sl][nt][2 + j]));
          }
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 4));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 8));
          top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 16));
          // the unit's first row is valid, so mnew is finite
          const float mnew = fmaxf(mrun[nt][j], top);
          const float rescale = exp2f(mrun[nt][j] - mnew);   // first: 0
          mrun[nt][j] = mnew;
          float sum = 0.f;
#pragma unroll
          for (int sl = 0; sl < kSL; ++sl) {
            pr[sl][nt][j] = exp2f(pr[sl][nt][j] - mnew);
            pr[sl][nt][2 + j] = exp2f(pr[sl][nt][2 + j] - mnew);
            sum += pr[sl][nt][j] + pr[sl][nt][2 + j];
          }
          lrun[nt][j] = fmaf(lrun[nt][j], rescale, sum);
#pragma unroll
          for (int mt = 0; mt < kDC; ++mt) {
            acc[mt][nt][j] *= rescale;
            acc[mt][nt][2 + j] *= rescale;
          }
        }
      // P^T as the B operand: rows 2c, 2c + 1 (and + 8) of head g, by
      // transposing the C layout's 8 x 8 blocks; fp32 q: P in two terms
      uint32_t pb[kSL][kPT][kNT][2];
#pragma unroll
      for (int sl = 0; sl < kSL; ++sl)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          float x[4] = {pr[sl][nt][0], pr[sl][nt][1], pr[sl][nt][2],
                        pr[sl][nt][3]};
#pragma unroll
          for (int t = 0; t < kPT; ++t) {
            const __half2 h01 = __floats2half2_rn(x[0], x[1]);
            const __half2 h23 = __floats2half2_rn(x[2], x[3]);
            pb[sl][t][nt][0] = movtrans(h2_bits(h01));
            pb[sl][t][nt][1] = movtrans(h2_bits(h23));
            x[0] -= __low2float(h01);
            x[1] -= __high2float(h01);
            x[2] -= __low2float(h23);
            x[3] -= __high2float(h23);
          }
        }
      // out^T += V^T P^T over this warp's chunks: slice mt of acc is chunk
      // c_lo + mt, A from ldmatrix.trans: a word holds rows 2c and 2c + 1
      // at d 2g and 2g + 1 of the chunk, its bytes reordered to pair the
      // rows (lo: d 2g, hi: d 2g + 1); then rows + 8.  In a ragged slice
      // the rows past the end are zeroed (V there may be another split's,
      // NaN too)
#pragma unroll
      for (int sl = 0; sl < kSL; ++sl) {
        const int left = nv - 16 * sl;
        if (left <= 0) break;
        const uint32_t keep01 = (2 * c < left ? 0x0000FFFFu : 0u)
                                | (2 * c + 1 < left ? 0xFFFF0000u : 0u);
        const uint32_t keep89 = (2 * c + 8 < left ? 0x0000FFFFu : 0u)
                                | (2 * c + 9 < left ? 0xFFFF0000u : 0u);
#pragma unroll
        for (int mt = 0; mt < kDC; mt += 2) {
          if (c_lo + mt < c_hi) {
            uint32_t rv[4];
            const bool two = c_lo + mt + 1 < c_hi;
            if (two) ldsm_x4_t(rv, vb + 16 * sl * W + chunk(c_lo + mt));
            else ldsm_x2_t(rv, vb + 16 * sl * W + chunk(c_lo + mt));
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u == 0 || two) {
                uint32_t av[4];
                e4m3x4_to_f16(__byte_perm(rv[2 * u], 0, 0x3120), av[0],
                              av[1]);
                e4m3x4_to_f16(__byte_perm(rv[2 * u + 1], 0, 0x3120), av[2],
                              av[3]);
                if (left < 16) {
                  av[0] &= keep01;
                  av[1] &= keep01;
                  av[2] &= keep89;
                  av[3] &= keep89;
                }
#pragma unroll
                for (int t = 0; t < kPT; ++t)
#pragma unroll
                  for (int nt = 0; nt < kNT; ++nt)   // every head tile
                    mma_f16(acc[mt + u][nt], av, pb[sl][t][nt][0],
                            pb[sl][t][nt][1]);
              }
            }
          }
        }
      }
    }
    // release the stage; the last warp to release it loads tile i + S
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const int before = atomicAdd(&released[s], 1);
      if (before == kE4Warps - 1) {
        released[s] = 0;
        if (i + S < n_tiles) load_tile(i + S);
      }
    }
  }
  // the warp's l: sums over its rows (m is common to them)
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      for (int off = 4; off < 32; off <<= 1)
        lrun[nt][j] += __shfl_xor_sync(0xffffffffu, lrun[nt][j], off);
  __syncthreads();                     // every stage consumed: reuse the ring
  // lane (g, c) holds heads 8 nt + 2c + j at d 16 (c_lo + mt) + 2g, + 1
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = nt * 8 + 2 * c + j;
      float* dst = part + (unit * kGw + h) * D + 16 * c_lo + 2 * g;
#pragma unroll
      for (int mt = 0; mt < kDC; ++mt)
        if (c_lo + mt < c_hi)
          *reinterpret_cast<float2*>(dst + 16 * mt) =
              make_float2(acc[mt][nt][j], acc[mt][nt][2 + j]);
      if (g == 0 && half == 0) {
        wm[unit][h] = mrun[nt][j];
        wl[unit][h] = lrun[nt][j];
      }
    }
  __syncthreads();

  // the block's partial: its units' partials, merged
  if (tid < G) {
    const int h = tid;
    float mb = -INFINITY;
    for (int w = 0; w < kUnits; ++w) mb = fmaxf(mb, wm[w][h]);
    float lb = 0.f;
    for (int w = 0; w < kUnits; ++w) {
      bw[w][h] = mb == -INFINITY ? 0.f : exp2f(wm[w][h] - mb);
      lb = fmaf(wl[w][h], bw[w][h], lb);
    }
    m_s[h] = mb;
    l_s[h] = lb;
  }
  __syncthreads();
  // a split alone (n_split == 1) writes the output here; a thread takes 16
  // consecutive outputs of one head
  const bool alone = n_split == 1;
  TQ* out = static_cast<TQ*>(a.out) + b * a.os_b + kh * a.os_k;
  for (int t = tid; t < G * nch; t += kE4Threads) {
    const int h = t / nch, d = (t - h * nch) * 16;
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kUnits; ++w) {
      const float4* src = reinterpret_cast<const float4*>(
          part + (w * kGw + h) * D + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 x = src[e];
        o[4 * e] = fmaf(bw[w][h], x.x, o[4 * e]);
        o[4 * e + 1] = fmaf(bw[w][h], x.y, o[4 * e + 1]);
        o[4 * e + 2] = fmaf(bw[w][h], x.z, o[4 * e + 2]);
        o[4 * e + 3] = fmaf(bw[w][h], x.w, o[4 * e + 3]);
      }
    }
    if (alone) {
      const float inv = l_s[h] > 0.f ? 1.f / l_s[h] : 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] *= inv;
      store_out(out + h * a.os_g + d, o, 16);
    } else {
      store_out(red + h * D + d, o, 16);
    }
  }
  if (alone) return;

  // merge the cluster's partials: weights from every block's (m, l)
  cluster_sync_acq_rel();
  if (tid < n_split * G) {
    const int rk = tid / G, h = tid % G;
    wgt[rk][h] = *cluster.map_shared_rank(m_s + h, rk);
    lrem[rk][h] = *cluster.map_shared_rank(l_s + h, rk);
  }
  __syncthreads();
  if (tid < G) {
    const int h = tid;
    float top = -INFINITY;
    for (int rk = 0; rk < n_split; ++rk) top = fmaxf(top, wgt[rk][h]);
    float lt = 0.f;
    for (int rk = 0; rk < n_split; ++rk) {
      // an empty split (m = -inf) weighs 0; all empty: length 0, output 0
      const float wr = top == -INFINITY ? 0.f : exp2f(wgt[rk][h] - top);
      wgt[rk][h] = wr;
      lt = fmaf(lrem[rk][h], wr, lt);
    }
    lsum[h] = lt > 0.f ? 1.f / lt : 0.f;
  }
  __syncthreads();
  // this block's share of the outputs, 16 consecutive ones a thread
  for (int t = split * kE4Threads + tid; t < G * nch;
       t += n_split * kE4Threads) {
    const int h = t / nch, d = (t - h * nch) * 16;
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = 0.f;
#pragma unroll
    for (int rk = 0; rk < kMaxSplit; ++rk) {
      if (rk < n_split) {
        const float4* src = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red + h * D + d, rk));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 x = src[e];
          o[4 * e] = fmaf(wgt[rk][h], x.x, o[4 * e]);
          o[4 * e + 1] = fmaf(wgt[rk][h], x.y, o[4 * e + 1]);
          o[4 * e + 2] = fmaf(wgt[rk][h], x.z, o[4 * e + 2]);
          o[4 * e + 3] = fmaf(wgt[rk][h], x.w, o[4 * e + 3]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] *= lsum[h];
    store_out(out + h * a.os_g + d, o, 16);
  }
  cluster_sync_relaxed();              // partials stay until all have read
}

// A cache (k or v, e4m3) as a 4-D tensor map: a row's D elements of
// `elsize` bytes, then its rows (the first `length`), KV heads and batch in
// the order of their strides (elements; at equal strides the shorter
// first), boxes of e4_box(D) bytes x `rows` rows in the matching swizzle;
// rows at or past `length` read as zeros.  *order: the map dimension of the
// row (bits 0-3), KV head (4-7) and batch (8-11) coordinates.
int e4m3_map(CUtensorMap* map, const void* base, const Args& a, int B,
             int rows, long long elsize, long long s_t, long long s_k,
             long long s_b, int* order) {
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int W = e4_box(a.D);
  struct Dim { cuuint64_t n, stride; int which; };
  Dim d[3] = {{(cuuint64_t)a.length, (cuuint64_t)(s_t * elsize), 0},
              {(cuuint64_t)a.K, (cuuint64_t)(s_k * elsize), 1},
              {(cuuint64_t)B, (cuuint64_t)(s_b * elsize), 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && (d[j].stride < d[j - 1].stride
                              || (d[j].stride == d[j - 1].stride
                                  && d[j].n < d[j - 1].n)); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  const cuuint64_t dims[4] = {(cuuint64_t)(a.D * elsize), d[0].n, d[1].n,
                              d[2].n};
  const cuuint64_t strides[3] = {d[0].stride, d[1].stride, d[2].stride};
  cuuint32_t box[4] = {(cuuint32_t)W, 1, 1, 1};
  *order = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].which == 0) box[1 + i] = rows;
    *order |= (1 + i) << (4 * d[i].which);
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : W == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename TQ, int kNT, int kDC, int kPair, int kSL>
int launch_e4m3(const Args& a, int B, int n_split, int elsize,
                cudaStream_t stream) {
  constexpr int kD = 16 * kDC * kPair;     // the largest D it takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_e4m3_kernel<TQ, kNT, kDC, kPair, kSL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      1024 + e4_ring_budget(kPair) + qfrag_bytes<TQ>(kD, kNT));
  if (attr != cudaSuccess) return (int)attr;
  // length 0: no tile is read, the maps stay unencoded
  E4Maps maps = {};
  if (a.length > 0) {
    const int rows = e4_tile(kPair, kSL);
    int err = e4m3_map(&maps.k, a.k, a, B, rows, elsize, a.ks_t, a.ks_k,
                       a.ks_b, &maps.kord);
    if (err == 0)
      err = e4m3_map(&maps.v, a.v, a, B, rows, elsize, a.vs_t, a.vs_k,
                     a.vs_b, &maps.vord);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * a.K, 1);
  cfg.blockDim = dim3(kE4Threads, 1, 1);
  cfg.dynamicSmemBytes =
      1024 + e4_ring_bytes(a.D, kPair, kSL) + qfrag_bytes<TQ>(a.D, kNT);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_e4m3_kernel<TQ, kNT, kDC, kPair, kSL>, a, maps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// the e4m3 route: `heads` 8 (G <= 8) or 16 (G <= 16) head slots a block.
// At D <= 128 a warp takes two slices of 16 rows.  Two warps share each 16
// rows, half of D each, over 16 heads at D > 128 (one warp's accumulators
// would hold 128 values a lane) and in splits of <= 64 rows (one tile: the
// shorter chains a warp runs, the sooner it ends).
template <typename TQ>
int launch_e4m3_g(const Args& a, int B, int n, int heads, int elsize,
                  cudaStream_t st) {
  if (heads < a.G || (heads != 8 && heads != 16))
    return (int)cudaErrorInvalidValue;
  const bool wide = a.D > 128, few = a.rows_per_split <= e4_tile(2, 1);
  if (heads == 8) {
    if (few)
      return wide ? launch_e4m3<TQ, 1, 8, 2, 1>(a, B, n, elsize, st)
                  : launch_e4m3<TQ, 1, 4, 2, 1>(a, B, n, elsize, st);
    return wide ? launch_e4m3<TQ, 1, 16, 1, 1>(a, B, n, elsize, st)
                : launch_e4m3<TQ, 1, 8, 1, 2>(a, B, n, elsize, st);
  }
  if (few || wide)
    return wide ? launch_e4m3<TQ, 2, 8, 2, 1>(a, B, n, elsize, st)
                : launch_e4m3<TQ, 2, 4, 2, 1>(a, B, n, elsize, st);
  return launch_e4m3<TQ, 2, 8, 1, 2>(a, B, n, elsize, st);
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
// `heads` (1, 2, 4 or 8; over e4m3 8 or 16, at least G) query heads a
// block; 1 <= n_split <= 8 blocks of `rows_per_split` rows each per (b, k,
// group of heads).  Returns a CUDA error code (0 on success;
// cudaErrorInvalidValue, with nothing launched, for arguments it does not
// take).
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
    return launch_e4m3_g<float>(a, B, n_split, heads, (int)elsize, s);
  if (dtype_q == 1 && dtype_kv == 2)
    return launch_e4m3_g<__nv_bfloat16>(a, B, n_split, heads, (int)elsize,
                                        s);
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
