// Causal or non-causal GQA flash attention, forward, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_flash_kernel`): q (B,K,G,S,D) attends to
// k, v (B,K,T,D) with an fp32 running softmax (m, l, acc), scale 1/sqrt(D)
// applied to q in fp32 before the dot products, the causal mask
// kpos > qpos (top-left aligned) and fully masked key tiles skipped.  It
// also writes the log-sum-exp of each row's scaled scores (fp32,
// (B,K,G,S)), which the backward kernel (csrc/flash_attention_bwd.cu)
// recomputes the probabilities from.
//
// What bounds it on this card: operations.  At the training shape
// (B=2, K=1, G=8, S=T=2048, D=256) the causal forward does about 34 GFLOP
// on 25 MB of inputs and outputs -- ~1,400 flops per byte, far above the
// ~295 an H100 needs before compute matters.
//
// What the design does about it:
// * The G heads of a group stay stacked, as on the TPU: one block owns 64
//   stacked rows, row = s * G + g (8 positions x 8 heads for gemma-2b), so
//   each K/V tile loaded into shared memory serves all G heads.  The TPU
//   tile (G*128, D) = (1024, 256) in fp32 is 1 MB, far beyond the 227 KB a
//   block may use; 64 rows x 64 keys x D <= 256 in fp32 is 215 KB.
// * The TPU grid walks the key tiles in order on one core; here one block
//   walks them in a loop for its row tile, and the row tiles of all (b, k)
//   run in parallel (512 blocks at the training shape).  Blocks take the
//   last row tiles first: under the causal mask they have the most keys.
// * A row's position is row / G, not its stacked index; key tiles past the
//   tile's last position are never loaded, and keys at or past T are
//   masked in the kernel, so nothing is padded (reference defect R1).
// * Arithmetic is FFMA from fp32 shared memory (flash_tiles.cuh): exact
//   fp32 for fp32 inputs, as the reference's 2e-5 tolerance needs.  Each
//   thread owns 4 rows x 4 keys of a score tile and 4 rows x D/16 columns
//   of the output accumulator, and reads its operands as float4.
// Simple first: no tensor cores (mma.sync / wgmma), no TMA, no pipeline
// between the loads of one tile and the arithmetic of the last.

#include "flash_tiles.cuh"

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

template <typename E, int kD>
int launch(const FwdArgs& a, int BK, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<kD>();
  auto kernel = flash_fwd_kernel<E, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.S * a.G + kRows - 1) / kRows;
  kernel<<<dim3(row_tiles, BK), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const FwdArgs& a, int BK, cudaStream_t stream) {
  if (a.D <= 64) return launch<E, 64>(a, BK, stream);
  if (a.D <= 128) return launch<E, 128>(a, BK, stream);
  return launch<E, 256>(a, BK, stream);
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
  if (dtype == 0) return dispatch<float>(a, B * K, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B * K, s);
  return (int)cudaErrorInvalidValue;
}
