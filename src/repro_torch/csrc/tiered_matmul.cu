// y = x @ w with an fp32 accumulator, for sm_90a, shaped for small M.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiered_matmul.py
// (`tiered_matmul`, body `_mm_kernel`): both inputs are cast to fp32, the
// products are summed in fp32 across K, and the result is written in x's
// dtype.  fp32 inputs run on plain FFMA (no TF32), so they meet the
// reference's 2e-5 tolerance.
//
// What bounds it on this card: bytes, at the decode shapes it serves.  At
// M = 4 (gemma-2b batch 4) each weight element is used for 4 multiply-adds,
// about 4 flops per bf16 byte of w against the ~295 an H100 needs before
// the tensor cores matter: the kernel is a weight stream, and its floor is
// K*N*sizeof(w) over HBM bandwidth.
//
// What the design does about it:
// * The TPU kernel's 256-row tiles would be 98 % padding at M = 4, so they
//   are not carried over.  A block owns kRows rows of x and a stripe of
//   kCols columns of w; each of its threads streams 8 adjacent columns of a
//   weight row (one 16-byte load in bf16) and keeps kRows x 8 fp32 sums.
// * The block's rows of x are staged in shared memory as fp32, kStage k's
//   at a time.  The 8 thread-rows of a block walk interleaved k's of the
//   block's K range with kUnroll weight rows in flight per thread (one
//   load in flight per thread left HBM mostly idle), and their sums are
//   added in a fixed order through shared memory.
// * When the (M, N) tiles alone cannot fill the 132 SMs, K is split across
//   `n_split` blocks; each writes an fp32 partial and a second kernel adds
//   the partials in split order, so the result does not depend on timing.
// * Every edge (M, N, K) is masked in the kernel, so the wrapper pads
//   nothing.  Vector loads are used only when the row stride and base
//   pointer allow them (`vec`), else scalar loads.
// Simple first: no wgmma, no TMA ring, no persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 32;                 // threads across columns
constexpr int kTy = 8;                  // threads across k
constexpr int kThreads = kTx * kTy;
constexpr int kVec = 8;                 // columns per thread
constexpr int kCols = kTx * kVec;       // 256 columns per block
constexpr int kRows = 4;                // rows of x per block (decode: batch)
constexpr int kStage = 512;             // k's of x staged in shared memory
constexpr int kUnroll = 4;              // weight rows in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

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

struct Args {
  const void* x; const void* w; void* y;
  float* work;                  // (n_split, M, N) fp32 partials
  int M, N, K, k_chunk, n_split, vec;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
mm_kernel(Args a) {
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int n0 = blockIdx.x * kCols + tx * kVec;
  const int m0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int k_begin = split * a.k_chunk;
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

  // add the kTy thread-rows' sums in ty order
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
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int m = m0 + r, n = blockIdx.x * kCols + c;
    if (m < a.M && n < a.N) {
      const long long idx = (long long)m * a.N + n;
      if (a.n_split == 1) from_f(red[r][c], static_cast<T*>(a.y) + idx);
      else a.work[(long long)split * a.M * a.N + idx] = red[r][c];
    }
  }
}

template <typename T>
__global__ void splitk_sum_kernel(Args a) {
  const long long total = (long long)a.M * a.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < a.n_split; ++p) s += a.work[p * total + i];
    from_f(s, static_cast<T*>(a.y) + i);
  }
}

template <typename T>
void launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.N + kCols - 1) / kCols, (a.M + kRows - 1) / kRows, a.n_split);
  mm_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  if (a.n_split > 1) {
    const long long total = (long long)a.M * a.N;
    const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
    splitk_sum_kernel<T><<<blocks, 256, 0, stream>>>(a);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K) and w (K, N) row-major and
// contiguous; y (M, N) contiguous.  Returns cudaGetLastError().
extern "C" int tiered_matmul_launch(
    const void* x, const void* w, void* y, void* work,
    int M, int N, int K, int k_chunk, int n_split, int vec, int dtype,
    void* stream) {
  if (M < 1 || N < 1 || K < 1 || k_chunk < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x, w, y, static_cast<float*>(work), M, N, K, k_chunk, n_split, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch<float>(a, s);
  else if (dtype == 1) launch<__nv_bfloat16>(a, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
