// Tile staging shared by the fp32 flash-attention kernels
// (`flash_fwd_kernel` in csrc/flash_attention.cu; `dkdv_kernel`, `dq_kernel`
// in csrc/flash_attention_bwd.cu), and the stacked-row addressing that the
// bf16 tensor-core kernels use as well (their primitives are in
// csrc/hopper.cuh).
//
// The fp32 kernels run on 256 threads and keep every tile in shared memory
// as fp32: the arithmetic is FFMA throughout, so fp32 inputs keep full
// fp32 precision, as the reference's 2e-5 tolerance needs (it rules out
// TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // stacked query rows per tile: row = s * G + g

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Copies kTileRows rows of kD columns into shared memory (row stride ld
// floats), multiplied by `mul`.  row_ptr(r) is the global address of tile
// row r, or nullptr past the end; columns at or past D (a multiple of 8)
// read as 0.  Every load of the tile is issued before the first store, 32
// bytes each.
template <int kTileRows, int kD, int ld, typename T, typename RowPtr>
__device__ __forceinline__ void stage(float* dst, RowPtr row_ptr, int D,
                                      float mul) {
  constexpr int kChunks = kD / 8;
  constexpr int kPer = kTileRows * kChunks / kThreads;
  static_assert(kTileRows * kChunks % kThreads == 0, "tile split");
  static_assert(ld % 4 == 0, "rows 16-byte aligned");
  float v[kPer][8];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / kChunks, d = (idx % kChunks) * 8;
    const T* src = row_ptr(r);
    if (src != nullptr && d < D) {
      load8(src + d, v[u]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[u][e] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int idx = threadIdx.x + u * kThreads;
    const int r = idx / kChunks, d = (idx % kChunks) * 8;
    float4* o = reinterpret_cast<float4*>(dst + r * ld + d);
    o[0] = make_float4(v[u][0] * mul, v[u][1] * mul, v[u][2] * mul,
                       v[u][3] * mul);
    o[1] = make_float4(v[u][4] * mul, v[u][5] * mul, v[u][6] * mul,
                       v[u][7] * mul);
  }
}

// Max and sum over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void fma4(float& acc0, float& acc1, float& acc2,
                                     float& acc3, float a, float4 b) {
  acc0 = fmaf(a, b.x, acc0);
  acc1 = fmaf(a, b.y, acc1);
  acc2 = fmaf(a, b.z, acc2);
  acc3 = fmaf(a, b.w, acc3);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Global row of stacked row `row` (s = row / G, g = row % G) of one
// (b, k) slab of a (B, K, G, S, D) tensor, or nullptr past S * G.
template <typename T>
__device__ __forceinline__ const T* stacked_row(const T* slab, int row,
                                                int G, int S, int D) {
  if (row >= S * G) return nullptr;
  return slab + ((long long)(row % G) * S + row / G) * D;
}

}  // namespace flash
