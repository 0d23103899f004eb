// Causal or non-causal GQA flash attention, forward, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): q (B,K,G,S,D) attends to
// k, v (B,K,T,D) with an fp32 running softmax (m, l, acc), scale 1/sqrt(D),
// the causal mask kpos > qpos (top-left aligned) and fully masked key
// tiles skipped.  It also writes the log-sum-exp of each row's scaled
// scores (fp32, (B,K,G,S)), which the backward kernels
// (csrc/flash_attention_bwd.cu) recompute the probabilities from.
//
// What bounds it on this card: operations.  The causal forward does
// 4 * D * (visible pairs) flops: 34.4 GFLOP on 25 MB at gemma-2b's
// training shape (B=2, K=1, G=8, S=T=2048, D=256), 34.8 us at the bf16
// tensor-core rate; 137 GFLOP on 134 MB at zamba2-1.2b's (B=2, K=32, G=1,
// S=T=4096, D=64), 139 us.  Both are far above the ~295 flops a byte an
// H100 needs before compute matters.
//
// Two kernels, chosen by dtype:
//
// bf16 (`flash_fwd_wgmma`, the training path): tensor cores fed by TMA.
// * A block owns 128 stacked query rows (row = s * G + g, as on the TPU,
//   so that each K/V tile serves all G heads) in two consumer warpgroups
//   of 64 rows, plus one producer warp.  Q is read once, by 16-byte loads
//   into the 128-byte-swizzled layout wgmma reads.
// * K and V arrive by TMA into a ring of 2-4 stages under mbarriers (full:
//   the bytes landed; empty: both consumer warpgroups are done with the
//   stage).  k, v are described as 3-D tensors (D, T, B*K), so a box past
//   T is zero-filled instead of reading the next slab; keys at or past T
//   are still masked here (reference defect R1).  The 128-byte swizzle
//   caps a box at 64 bf16 wide: a tile of D = 256 is four boxes a tensor.
// * S = Q K^T is wgmma m64nNk16 with both operands in shared memory
//   (K-major); the online softmax runs on the fp32 accumulators, with the
//   scale applied to the fp32 scores; P goes back to bf16 in registers,
//   already in the layout of wgmma's A operand, and O += P V is wgmma with
//   A from registers and V as an MN-major (transposed) B operand.
// * The producer drops to 24 registers and the consumers rise to 240
//   (setmaxnreg): a consumer thread holds D/2 fp32 accumulators of O.
// * Key tiles past the block's last position are never loaded; only tiles
//   that cross the diagonal or T are masked, by position (row / G).
//   Blocks are issued longest first (all slabs' last row tiles first).
//
// fp32 (`flash_fwd_kernel`): FFMA from fp32 shared memory
// (flash_tiles.cuh), exact fp32 as the reference's 2e-5 tolerance needs
// (it rules out TF32).  One block owns 64 stacked rows and walks 64-key
// tiles; each thread owns 4 rows x 4 keys of a score tile and 4 rows x
// D/16 columns of the output, read as float4.  No tensor cores, no
// pipeline between the loads of one tile and the arithmetic of the last.

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int kKeys = 64;   // keys per tile

struct FwdArgs {
  const void* q; const void* k; const void* v; void* o; float* lse;
  int G, S, T, D, causal;
  float scale;
};

template <int kD>
constexpr int fwd_smem_bytes() {
  return 4 * (kRows * (kD + 4) + kKeys * (kD + 4) + kKeys * kD
              + kRows * (kKeys + 1));
}

template <typename E, int kD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(FwdArgs a) {
  constexpr int ldq = kD + 4, ldk = kD + 4, ldv = kD, ldp = kKeys + 1;
  constexpr int kCols = kD / 64;      // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * ldq;
  float* Vs = Ks + kKeys * ldk;
  float* Ps = Vs + kKeys * ldv;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int bk = blockIdx.y;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const int r0 = tile * kRows;
  const long long slab_q = (long long)bk * G * S * D;
  const E* qb = static_cast<const E*>(a.q) + slab_q;
  const E* kb = static_cast<const E*>(a.k) + (long long)bk * T * D;
  const E* vb = static_cast<const E*>(a.v) + (long long)bk * T * D;

  stage<kRows, kD, ldq, E>(
      Qs, [&](int r) { return stacked_row(qb, r0 + r, G, S, D); }, D,
      a.scale);

  const int q_last = min(S - 1, (r0 + kRows - 1) / G);
  const int k_end = a.causal ? min(T, q_last + 1) : T;

  float acc[4][4 * kCols];
  float m[4], l[4];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qpos[i] = (r0 + ty * 4 + i) / G;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();   // the last tile's readers are done with Ks, Vs, Ps
    auto key_row = [&](const E* base) {
      return [=](int r) -> const E* {
        return k0 + r < T ? base + (long long)(k0 + r) * D : nullptr;
      };
    };
    stage<kKeys, kD, ldk, E>(Ks, key_row(kb), D, 1.f);
    stage<kKeys, kD, ldv, E>(Vs, key_row(vb), D, 1.f);
    __syncthreads();

    // scores: rows ty*4+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = ld4(Qs + (ty * 4 + i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(Ks + (tx + 16 * j) * ldk + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    // mask and online softmax; the 16 lanes of a row reduce by shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= T || (a.causal && kp > qpos[i])) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * ldp + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P @ V: rows ty*4+i, columns 64*c + 4*tx + (0..3)
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * ldp + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = ld4(Vs + key * ldv + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fma4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
               acc[i][4 * c + 3], p[i], vv);
      }
    }
  }

  E* ob = static_cast<E*>(a.o) + slab_q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= S * G) continue;
    const int g = row % G, sp = row / G;
    const float denom = fmaxf(l[i], 1e-30f);
    E* orow = ob + ((long long)g * S + sp) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * tx + e;
        if (d < D) store_f(acc[i][4 * c + e] / denom, orow + d);
      }
    if (tx == 0)
      a.lse[((long long)bk * G + g) * S + sp] = m[i] + logf(denom);
  }
}


// ------------------------------------------------------------------ bf16
using hopper::smem_addr;

constexpr int kBlockRows = 128;        // two consumer warpgroups of 64
constexpr int kWgThreads = 384;        // + one producer warpgroup

template <int kD>
struct WgCfg {
  static constexpr int kN = kD == 256 ? 64 : 128;       // keys per tile
  static constexpr int kPanels = kD / 64;               // 64-wide boxes
  static constexpr int kStages = kD == 64 ? 4 : 2;
  static constexpr int kQBytes = kPanels * kBlockRows * 128;
  static constexpr int kTileBytes = kPanels * kN * 128;  // K or V
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + 2 * kStages * 8;
};

template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, FwdArgs a) {
  using C = WgCfg<kD>;
  constexpr int kN = C::kN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + C::kQBytes;
  uint8_t* Vs = Ks + kStages * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kStages * C::kTileBytes);
  uint64_t* empty = full + kStages;

  const int bk = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const int G = a.G, S = a.S, T = a.T, D = a.D;
  const int q_first = r0 / G;
  const int q_last = min(S - 1, (r0 + kBlockRows - 1) / G);
  const int k_end = a.causal ? min(T, q_last + 1) : T;
  const int n_tiles = (k_end + kN - 1) / kN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        hopper::mbar_wait(&empty[st], ph ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * C::kTileBytes);
        for (int p = 0; p < C::kPanels; ++p) {
          const int off = st * C::kTileBytes + p * kN * 128;
          hopper::tma_load_3d(Ks + off, &tm_k, &full[st], p * 64, i * kN, bk);
          hopper::tma_load_3d(Vs + off, &tm_v, &full[st], p * 64, i * kN, bk);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns block rows 64 wg .. 64 wg + 63
    hopper::regs_alloc<240>();
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
    const long long slab_q = (long long)bk * G * S * D;
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + slab_q;
    constexpr int kChunks = kD / 8;
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int row = wg * 64 + idx / kChunks, ch = idx % kChunks;
      const __nv_bfloat16* src = stacked_row(qb, r0 + row, G, S, D);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src != nullptr && ch * 8 < D)
        v = *reinterpret_cast<const uint4*>(src + ch * 8);
      *reinterpret_cast<uint4*>(Qs + (ch / 8) * (kBlockRows * 128)
                                + hopper::swizzle128(row, ch % 8)) = v;
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);

    // this thread's rows: ra and ra + 8 of the block, columns 2 (lane % 4)
    // + {0, 1} of each 8-wide group of an accumulator
    const int ra = wg * 64 + warp * 16 + (lane >> 2);
    const int qpos[2] = {(r0 + ra) / G, (r0 + ra + 8) / G};
    const int c2 = 2 * (lane & 3);
    const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
    float o[kD / 2];
#pragma unroll
    for (int v = 0; v < kD / 2; ++v) o[v] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_addr(Qs) + wg * 64 * 128;

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, k0 = i * kN;
      hopper::mbar_wait(&full[st], (i / kStages) & 1);
      const uint32_t k_base = smem_addr(Ks + st * C::kTileBytes);
      const uint32_t v_base = smem_addr(Vs + st * C::kTileBytes);

      // S = Q K^T over D, 16 at a time (32 bytes inside a 128-byte row)
      float s[kN / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        hopper::wgmma_ss<kN>(
            s,
            hopper::gmma_desc(q_base + (kk / 4) * kBlockRows * 128 + off, 0,
                              1024),
            hopper::gmma_desc(k_base + (kk / 4) * kN * 128 + off, 0, 1024),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // mask the tiles that cross T or the diagonal, by position
      if (k0 + kN > T || (a.causal && k0 + kN - 1 > q_first)) {
#pragma unroll
        for (int v = 0; v < kN / 2; ++v) {
          const int kp = k0 + 8 * (v >> 2) + c2 + (v & 1);
          if (kp >= T || (a.causal && kp > qpos[(v >> 1) & 1]))
            s[v] = -INFINITY;
        }
      }
      // online softmax on the fp32 scores
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int v = 0; v < kN / 2; ++v)
        mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], s[v]);
      float base[2], corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        base[h] = mx[h] == -INFINITY ? 0.f : mx[h] * sl2;
        corr[h] = exp2f(m[h] * sl2 - base[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int v = 0; v < kN / 2; ++v) {
        const int h = (v >> 1) & 1;
        s[v] = exp2f(fmaf(s[v], sl2, -base[h]));
        l[h] += s[v];
      }
#pragma unroll
      for (int v = 0; v < kD / 2; ++v) o[v] *= corr[(v >> 1) & 1];
      uint32_t pa[kN / 16][4];
#pragma unroll
      for (int kt = 0; kt < kN / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kt][r] = hopper::pack_bf16(s[8 * kt + 2 * r],
                                        s[8 * kt + 2 * r + 1]);

      // O += P V over the tile's keys, 16 at a time; V is MN-major: the
      // leading offset steps 64 columns of D (one box), the stride 8 keys
      hopper::wgmma_fence();
      hopper::fence_regs(o);
#pragma unroll
      for (int kt = 0; kt < kN / 16; ++kt)
        hopper::wgmma_rs<kD>(o, pa[kt],
                     hopper::gmma_desc(v_base + kt * 16 * 128, kN * 128,
                                       1024));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[st]);
    }

    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + slab_q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int row = r0 + ra + 8 * h;
      if (row >= S * G) continue;
      const int g = row % G, sp = row / G;
      const float denom = fmaxf(l[h], 1e-30f), inv = 1.f / denom;
      __nv_bfloat16* orow = ob + ((long long)g * S + sp) * D;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int d = 8 * j + c2;
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) = hopper::pack_bf16(
              o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
      if ((lane & 3) == 0)
        a.lse[((long long)bk * G + g) * S + sp] =
            m[h] * a.scale + logf(denom);
    }
  }
}

template <int kD>
int launch_wgmma(const FwdArgs& a, int BK, cudaStream_t stream) {
  using C = WgCfg<kD>;
  CUtensorMap tm_k, tm_v;
  int err = hopper::kv_map(&tm_k, a.k, a.D, a.T, BK, C::kN);
  if (err == 0) err = hopper::kv_map(&tm_v, a.v, a.D, a.T, BK, C::kN);
  if (err != 0) return err;
  auto kernel = flash_fwd_wgmma<kD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (a.S * a.G + kBlockRows - 1) / kBlockRows;
  kernel<<<dim3(BK, row_tiles), kWgThreads, C::kSmem, stream>>>(tm_k, tm_v,
                                                               a);
  return (int)cudaGetLastError();
}

template <int kD>
int launch(const FwdArgs& a, int BK, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<kD>();
  auto kernel = flash_fwd_kernel<float, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.S * a.G + kRows - 1) / kRows;
  kernel<<<dim3(row_tiles, BK), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,K,G,S,D), k and v (B,K,T,D), out like q, all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); lse (B,K,G,S) float32.  D must be a
// multiple of 8, at most 256.  Returns a CUDA error code (0 on success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int K, int G, int S, int T, int D, int causal, float scale,
    int dtype, void* stream) {
  if (B < 1 || K < 1 || G < 1 || S < 1 || T < 1 || D < 8 || D > 256
      || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  FwdArgs a{q, k, v, out, static_cast<float*>(lse), G, S, T, D, causal,
            scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BK = B * K;
  if (dtype == 0) {
    if (D <= 64) return launch<64>(a, BK, s);
    if (D <= 128) return launch<128>(a, BK, s);
    return launch<256>(a, BK, s);
  }
  if (dtype == 1) {
    if (D <= 64) return launch_wgmma<64>(a, BK, s);
    if (D <= 128) return launch_wgmma<128>(a, BK, s);
    return launch_wgmma<256>(a, BK, s);
  }
  return (int)cudaErrorInvalidValue;
}
