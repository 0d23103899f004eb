// y = x @ w with an fp32 accumulator, for sm_90a, shaped for small M.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiered_matmul.py
// (`tiered_matmul`, body `_mm_kernel`): both inputs are cast to fp32, the
// products are summed in fp32 across K, and the result is written in x's
// dtype.  Any M, N, K: every edge is masked here, the wrapper pads nothing.
//
// What bounds it on this card: bytes.  The serving paths call it at M = 4
// (batch 4) in bf16: each weight element is used for 4 multiply-adds, about
// 4 flops per weight byte against the ~295 an H100 needs before the tensor
// cores matter.  So the kernel is a weight stream and its floor is
// K * N * 2 bytes over HBM bandwidth (20 us for gemma-2b's 2048 x 16384
// w_gate); what costs time is bytes not in flight, a second launch, a grid
// that leaves SMs idle in a last partial wave, and any step of a block
// that waits on a round trip to memory.
//
// What the design does about it (bf16 with rows of w TMA can describe,
// `tiered_mma_kernel`; the route and the grid are chosen by
// kernels/tiered_matmul.py):
// * Weight tiles of 64 rows of K by 128 columns (16 KB, two 64-column TMA
//   boxes) stream by TMA (a 2-D tensor map, 128-byte swizzle, zeros past K
//   and N) into a ring of kStages = 4 under full/empty mbarriers, from one
//   producer thread, while 4 consumer warps work on the stages that have
//   landed; a stage is refilled only after every consumer warp has
//   released it.  The ring holds 64 KB, and two blocks fit an SM, so an SM
//   keeps 64 to 128 KB in flight: Little's law asks ~25 KB an SM for
//   3.35 TB/s at ~1 us.  On the H100 3 or 4 stages streamed as fast as 6
//   or 8 (more requests in flight only queue), and 4 leaves room for the
//   second block.  The loads carry an evict-first L2 policy: the weights
//   are read once a step, and a stream that evicts only its own lines
//   leaves the rest of the cache (and other data's dirty lines) alone.
//   The tensor map of a weight is encoded once and cached by (address, N,
//   K): weights do not move between steps, so a call costs a hash lookup,
//   not an encoding.  It is passed as a __grid_constant__ parameter.
// * The math is on the tensor cores: y^T = w^T x^T with mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate).  The weight tile is the 16-row A
//   operand, loaded from the [k][n] stage by ldmatrix.trans (conflict-free
//   under the swizzle); the block's <= 8 rows of x, zero-padded to 8, are
//   the n = 8 B operand, staged once in shared memory (a window of 2048 k's,
//   rows padded by 16 bytes so ldmatrix meets no bank conflict) before the
//   stream starts.  Loaded from L2 a stage ahead instead, x made every
//   stage wait a round trip: a block's time grew with its stage count, not
//   its bytes.  bf16 x bf16 products are exact in fp32, so this is the
//   reference's function summed in another order.  One warp instruction
//   takes 256 weight elements.  M > 8 takes more blocks along y, each
//   re-reading w (only the reference tests' shapes do that).
// * One launch a call.  K is split across n_split <= 8 blocks that form
//   one thread-block cluster; each leaves its fp32 partial (8 x 128) in its
//   shared memory, and after a cluster barrier every block sums a share of
//   the outputs over the partials of the whole cluster, read through
//   distributed shared memory in rank order: the same inputs give the same
//   bits on every run, with no workspace and no second kernel.  8 is the
//   portable cluster size.
// * The grid is sized to the card by the wrapper: enough K splits that
//   95 % of the SMs get a block, more while each split keeps 16 stages and
//   the grid stays one wave, so no partial wave runs on a mostly idle card.
// * A wait on an mbarrier that has not completed after ~4 s traps (the
//   launch fails) instead of spinning forever.
//
// fp32, and bf16 whose rows of w are not 16-byte multiples or whose base
// is not 16-byte aligned (TMA cannot describe them; no serving shape), take
// `tiered_ffma_kernel`: FFMA (no TF32, so fp32 meets the reference's 2e-5),
// each thread 8 adjacent columns of a weight row by 16-byte loads where
// the row allows it, x staged in shared memory as fp32, and the same
// cluster split-K merge.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplit = 8;            // blocks of a cluster (portable)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Cluster barriers: the first publishes each block's partial in its shared
// memory (release / acquire); the last only keeps that memory alive until
// every block of the cluster has read it.
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster's K split, merged: each block holds a rows x cols fp32
// partial (row stride ld) at `part` in its shared memory; the outputs are
// the sums over the blocks in rank order, written to y at (m0, n0), each
// block taking every n_split-th share.  Called between the two barriers.
template <typename T>
__device__ __forceinline__ void merge_partials(const float* part, int ld,
                                               int rows, int cols, T* y,
                                               long long ldy, int m0,
                                               int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * blockDim.x + threadIdx.x; i < rows * cols;
       i += n_split * blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    float v[kMaxSplit];                 // every rank's load in flight at once
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p)
      v[p] = p < n_split ? *cluster.map_shared_rank(part + r * ld + c, p)
                         : 0.f;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplit; ++p) s += v[p];
    from_f(s, y + (long long)(m0 + r) * ldy + n0 + c);
  }
}

// ------------------------------------------------- tensor cores (bf16, TMA)
constexpr int kBK = 64;                 // rows of K a ring stage
constexpr int kStages = 4;
constexpr int kConsumers = 4;           // consumer warps
constexpr int kTcThreads = (kConsumers + 1) * 32;   // + the producer warp
constexpr int kMRows = 8;               // rows of x a block (mma's n)
constexpr int kXWin = 2048;             // k's of x staged at once
constexpr int kXLd = kXWin + 8;         // its row stride: 16 bytes past 128s

constexpr int kBoxes = 2;               // 64-column TMA boxes a stage
constexpr int kBN = 64 * kBoxes;        // columns of a tile
constexpr int kBoxBytes = kBK * 128;
constexpr int kStageBytes = kBoxes * kBoxBytes;
// alignment, the ring, x's window, the partial, the mbarriers
constexpr int kTcSmem = 1024 + kStages * kStageBytes + kMRows * kXLd * 2
                        + kMRows * kBN * 4 + 2 * kStages * 8;

struct TcArgs {
  const __nv_bfloat16* x; __nv_bfloat16* y;
  int M, N, K, k_chunk;                 // k_chunk: rows of K a split, % kBK
  int x_vec;                            // x rows read 16 bytes at a time
};

using hopper::mbar_wait_bounded;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, fp32) += A (16 x 16, bf16, row) B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows m0 .. m0 + 7 of x, columns k0 .. k0 + n - 1 (n a multiple of 64),
// into xs (row stride kXLd), zero past M and K; by the consumer threads.
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const TcArgs& a,
                                        int m0, int k0, int n) {
  const int chunks = n / 8;
  for (int i = threadIdx.x; i < kMRows * chunks; i += kConsumers * 32) {
    const int r = i / chunks, k = k0 + 8 * (i - r * chunks);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < a.M) {
      const __nv_bfloat16* p = a.x + (long long)(m0 + r) * a.K + k;
      if (a.x_vec && k + 8 <= a.K) {
        v = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = k + j < a.K
                 ? __ldg(reinterpret_cast<const unsigned short*>(p) + j) : 0;
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(xs + r * kXLd + (k - k0)) = v;
  }
}

// Grid (tiles of BN columns x n_split, ceil(M / 8)); clusters of the
// n_split K-split blocks of one tile, along x.
__global__ void __launch_bounds__(kTcThreads)
tiered_mma_kernel(const __grid_constant__ CUtensorMap tm_w, TcArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + kStages * kStageBytes);
  float* part = reinterpret_cast<float*>(xs + kMRows * kXLd);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kMRows * kBN);
  uint64_t* empty = full + kStages;

  const int n_split = (int)cg::this_cluster().num_blocks();
  const int split = (int)cg::this_cluster().block_rank();
  const int n0 = (int)blockIdx.x / n_split * kBN;
  const int m0 = (int)blockIdx.y * kMRows;
  const int kt0 = split * (a.k_chunk / kBK);
  const int kt_total = (a.K + kBK - 1) / kBK;
  const int nt = min(a.k_chunk / kBK, kt_total - kt0);   // stages to run
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  } else if (threadIdx.x == kConsumers * 32) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: one thread keeps the ring full, read once (evict
    // first); boxes wholly past N are not loaded (no consumer reads them)
    if (lane == 0) {
      const uint64_t policy = hopper::policy_evict_first();
      const int boxes = min(kBoxes, (a.N - n0 + 63) / 64);
      for (int i = 0; i < nt; ++i) {
        const int st = i % kStages;
        mbar_wait_bounded(&empty[st], ((i / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b)
          hopper::tma_load_2d(ring + st * kStageBytes + b * kBoxBytes,
                              &tm_w, &full[st], n0 + 64 * b,
                              (kt0 + i) * kBK, policy);
      }
    }
  } else {
    // ---- consumers: warp w owns columns nw .. nw + 16 kBoxes - 1 of the
    // tile, kBoxes 16-column blocks; a lane holds y^T rows nw + 16 j + g
    // and + 8, x rows m0 + 2 t and + 1 (g = lane / 4, t = lane % 4)
    const int nw = warp * 16 * kBoxes;
    const bool active = n0 + nw < a.N;
    const int g = lane >> 2, t = lane & 3;
    float acc[kBoxes][4];
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    // ldmatrix.x4.trans (w): lanes 0-7, 8-15, 16-23, 24-31 address the
    // rows of the 8 x 8 blocks (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15,
    // n 0-7), (k 8-15, n 8-15) of a 16 x 16 block: A's a0..a3 of mma
    // m16n8k16.  Column c of the tile is 16-byte chunk (c % 64) / 8 of box
    // c / 64.  ldmatrix.x4 (x): lane l addresses row l % 8, k's 8 (l / 8)
    // on of a 32-k step: B's b0, b1 of two k16 steps.
    const int lrow = (lane & 7) + ((lane >> 4) << 3);
    const int lhalf = (lane >> 3) & 1;
    const uint32_t xaddr = hopper::smem_addr(xs)
                           + ((lane & 7) * kXLd + (lane >> 3) * 8) * 2;
    // x is staged a window of kXWin k's at a time
    for (int w0 = 0; w0 < nt; w0 += kXWin / kBK) {
      const int wn = min(kXWin / kBK, nt - w0);
      if (w0 > 0) hopper::named_sync(1, kConsumers * 32);  // window used
      stage_x(xs, a, m0, (kt0 + w0) * kBK, wn * kBK);
      hopper::named_sync(1, kConsumers * 32);
      for (int i = w0; i < w0 + wn; ++i) {
        const int st = i % kStages;
        mbar_wait_bounded(&full[st], (i / kStages) & 1);
        if (active) {
          const uint32_t base = hopper::smem_addr(ring + st * kStageBytes);
#pragma unroll
          for (int kp = 0; kp < kBK / 32; ++kp) {
            uint32_t xb[4];
            ldmatrix_x4(xb, xaddr + ((i - w0) * kBK + 32 * kp) * 2);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = 32 * kp + 16 * h + lrow;
#pragma unroll
              for (int j = 0; j < kBoxes; ++j) {
                const int c = nw + 16 * j;
                const int chunk = ((c & 63) >> 3) + lhalf;
                uint32_t af[4];
                ldmatrix_x4_trans(af, base + (c >> 6) * kBoxBytes
                                      + row * 128
                                      + ((chunk ^ (row & 7)) << 4));
                mma_16816(acc[j], af, xb[2 * h], xb[2 * h + 1]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[st]);
      }
    }
    // the partial, [m][n] of the tile
#pragma unroll
    for (int j = 0; j < kBoxes; ++j) {
      const int n = nw + 16 * j + g;
      part[(2 * t) * kBN + n] = acc[j][0];
      part[(2 * t + 1) * kBN + n] = acc[j][1];
      part[(2 * t) * kBN + n + 8] = acc[j][2];
      part[(2 * t + 1) * kBN + n + 8] = acc[j][3];
    }
  }
  __syncwarp();                         // the barriers below are .aligned
  cluster_sync_acq_rel();
  merge_partials(part, kBN, min(kMRows, a.M - m0), min(kBN, a.N - n0), a.y,
                 a.N, m0, n0);
  cluster_sync_relaxed();
}

// The tensor map of each weight, encoded at its first call: the map holds
// only the address, shape and strides, so the key says everything it
// encodes, and a weight freed and another placed at the same address with
// the same shape gets the same map.  Calls from Python threads may run at
// once (ctypes releases the GIL), so the cache is locked.
struct MapKey {
  const void* w; int N, K;
  bool operator==(const MapKey& o) const {
    return w == o.w && N == o.N && K == o.K;
  }
};
struct MapHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.w) ^ ((size_t)k.N << 32)
           ^ ((size_t)k.K << 1);
  }
};

int weight_map(const void* w, int N, int K, CUtensorMap* out) {
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapHash> cache;
  const MapKey key{w, N, K};
  std::lock_guard<std::mutex> guard(lock);
  auto it = cache.find(key);
  if (it == cache.end()) {
    if (cache.size() >= 4096) cache.clear();
    CUtensorMap map;
    const int err = hopper::matrix_map(&map, w, N, K, kBK);
    if (err != 0) return err;
    it = cache.emplace(key, map).first;
  }
  *out = it->second;
  return 0;
}

int launch_tc(const TcArgs& a, const CUtensorMap& map, int n_split,
              cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      tiered_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kBN - 1) / kBN * n_split,
                     (a.M + kMRows - 1) / kMRows, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = kTcSmem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = n_split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tiered_mma_kernel, map, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ------------------------------------------------------------ FFMA route
constexpr int kTx = 32;                 // threads across columns
constexpr int kTy = 8;                  // threads across k
constexpr int kThreads = kTx * kTy;
constexpr int kVec = 8;                 // columns per thread
constexpr int kCols = kTx * kVec;       // 256 columns per block
constexpr int kRows = 4;                // rows of x per block
constexpr int kStage = 512;             // k's of x staged in shared memory
constexpr int kUnroll = 4;              // weight rows in flight per thread

// 8 consecutive elements of a weight row as floats.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x; o[2 * i + 1] = f.y;
  }
}

// One weight row's 8 columns from n0 on; `left` columns exist past n0.
template <typename T>
__device__ __forceinline__ void load_row(const T* p, bool full, int left,
                                         float* o) {
  if (full) {
    load8(p, o);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) o[c] = (c < left) ? to_f(p[c]) : 0.f;
  }
}

struct FfmaArgs {
  const void* x; const void* w; void* y;
  int M, N, K, k_chunk, vec;
};

// Grid (ceil(N / 256), ceil(M / 4), n_split); clusters of the n_split
// K-split blocks of one tile, along z.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tiered_ffma_kernel(FfmaArgs a) {
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kCols + tx * kVec;
  const int m0 = blockIdx.y * kRows;
  const int k_begin = blockIdx.z * a.k_chunk;
  const int k_end = min(a.K, k_begin + a.k_chunk);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int rows = min(kRows, a.M - m0);
  const bool full = a.vec && (n0 + kVec <= a.N);

  __shared__ float xs[kRows][kStage];
  float acc[kRows][kVec];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[r][c] = 0.f;

  for (int ks = k_begin; ks < k_end; ks += kStage) {
    const int kn = min(kStage, k_end - ks);
    __syncthreads();                    // the previous stage is consumed
    for (int i = threadIdx.x; i < kRows * kStage; i += kThreads) {
      const int r = i / kStage, kk = i % kStage;
      xs[r][kk] = (r < rows && kk < kn)
                      ? to_f(x[(long long)(m0 + r) * a.K + ks + kk]) : 0.f;
    }
    __syncthreads();
    // kUnroll weight rows in flight per thread, then their products; each
    // thread still adds its k's in increasing order
    int kk = ty;
    for (; kk + (kUnroll - 1) * kTy < kn; kk += kUnroll * kTy) {
      float wv[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_row(w + (long long)(ks + kk + u * kTy) * a.N + n0, full,
                 a.N - n0, wv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r][kk + u * kTy];
#pragma unroll
          for (int c = 0; c < kVec; ++c)
            acc[r][c] = fmaf(xv, wv[u][c], acc[r][c]);
        }
    }
    for (; kk < kn; kk += kTy) {
      float wv[kVec];
      load_row(w + (long long)(ks + kk) * a.N + n0, full, a.N - n0, wv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = xs[r][kk];
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[r][c] = fmaf(xv, wv[c], acc[r][c]);
      }
    }
  }

  // add the kTy thread-rows' sums in ty order: the block's partial
  __shared__ float red[kRows][kCols];
  for (int t = 0; t < kTy; ++t) {
    if (ty == t) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          float* slot = &red[r][tx * kVec + c];
          *slot = (t == 0) ? acc[r][c] : *slot + acc[r][c];
        }
    }
    __syncthreads();
  }
  cluster_sync_acq_rel();
  const int c0 = (int)blockIdx.x * kCols;
  merge_partials(&red[0][0], kCols, rows, min(kCols, a.N - c0),
                 static_cast<T*>(a.y), a.N, m0, c0);
  cluster_sync_relaxed();
}

template <typename T>
int launch_ffma(const FfmaArgs& a, int n_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, (a.M + kRows - 1) / kRows,
                     n_split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = n_split;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tiered_ffma_kernel<T>, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// y = x @ w.  x (M, K) and w (K, N) row-major and contiguous, y (M, N)
// contiguous; dtype 0 = float32, 1 = bfloat16.  route 1 (bf16 only, N a
// multiple of 8, w 16-byte aligned): the tensor-core kernel, K split in
// k_chunk rows, a multiple of 64; route 0: the FFMA kernel, k_chunk any
// multiple of 8.  1 <= n_split <= 8 blocks of k_chunk rows cover K, none
// empty.  vec: route 1, x rows can be read 16 bytes at a time (K a
// multiple of 8, x 16-byte aligned); route 0, w rows can be read 8
// elements at a time (N a multiple of 8, w 16-byte aligned).  Returns a
// CUDA error code (0 on success).
extern "C" int tiered_matmul_launch(
    const void* x, const void* w, void* y, int M, int N, int K, int route,
    int n_split, int k_chunk, int vec, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || n_split < 1
      || n_split > kMaxSplit || (long long)(n_split - 1) * k_chunk >= K
      || (long long)n_split * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    FfmaArgs a{x, w, y, M, N, K, k_chunk, vec};
    if (dtype == 0) return launch_ffma<float>(a, n_split, s);
    if (dtype == 1) return launch_ffma<__nv_bfloat16>(a, n_split, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route != 1 || dtype != 1 || N % 8 != 0 || k_chunk % kBK != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0
      || (M + kMRows - 1) / kMRows > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const int err = weight_map(w, N, K, &map);
  if (err != 0) return err;
  TcArgs a{static_cast<const __nv_bfloat16*>(x),
           static_cast<__nv_bfloat16*>(y), M, N, K, k_chunk, vec};
  return launch_tc(a, map, n_split, s);
}
