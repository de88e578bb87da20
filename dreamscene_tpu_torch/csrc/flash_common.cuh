// Shared pieces of the K4 flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu).
//
// Replaces the Pallas TPU flash attention the JAX package calls through
// dreamscene_tpu/guidance/sd_flax.py:120 (jax/experimental/pallas/ops/
// tpu/flash_attention.py: forward kernel, _flash_attention_bwd_dkv,
// _flash_attention_bwd_dq). Operands are [b*h, n, d] heads, row stride d,
// in float32 or bfloat16. Every kernel computes in float32 and rounds
// through the operand type exactly where the JAX kernels cast: p before
// P.V, p^T and ds^T before the dK/dV products, ds before the dQ product,
// and the outputs.
//
// Layout: one CTA owns a block of query rows (forward, dQ) or key rows
// (dK/dV) and loops over the other axis. Tiles are staged in shared
// memory as float32 with an odd row stride (D + 1), zero-padded from the
// true head dim d up to the compile-time bucket D, so any d <= D works.
// Products are scalar FMAs over register micro-tiles: thread (ty, tx)
// owns rows ty + TY*i and columns tx + TX*j of each result.
//
// What bounds it: at the main path's shapes the work is operations
// (4*b*h*n^2*d FLOPs forward), far above the bytes. This first version
// uses the CUDA cores' float32 FMA (67 TFLOP/s peak), not the tensor
// cores, and reads every operand from shared memory once per FMA pair:
// shared-memory bandwidth, not FLOPs, limits it. wgmma/mma.sync tiles
// are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int TX = 16;   // threads along a result row

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded through T (the JAX kernels' .astype(operand dtype))
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// rows x d block of a head (row stride d) -> shared [rows][D + 1] float32,
// columns d..D-1 zero
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int d,
                                          int tid) {
  constexpr int S = D + 1;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, c = i - r * D;
    dst[r * S + c] = c < d ? to_f<T>(src[(size_t)r * d + c]) : 0.f;
  }
}

// acc[i][j] += sum_k A(ty + TY*i, k) * B(k, tx + TX*j), with
// A(r, k) = A[r*ars + k*acs] and B(k, c) = B[k*brs + c*bcs]
template <int MI, int NJ, int TY, int K>
__device__ __forceinline__ void mm_acc(float (&acc)[MI][NJ], const float* A, int ars,
                                       int acs, const float* B, int brs, int bcs,
                                       int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[MI], b[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + TY * i) * ars + k * acs];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = B[k * brs + (tx + TX * j) * bcs];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

template <int MI, int NJ>
__device__ __forceinline__ void add_to(float (&acc)[MI][NJ], const float (&part)[MI][NJ]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] += part[i][j];
}

// acc rows x D -> head rows (row stride d), columns < d only
template <typename T, int MI, int NJ, int TY>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[MI][NJ], int d,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = ty + TY * i, c = tx + TX * j;
      if (c < d) dst[(size_t)r * d + c] = from_f<T>(acc[i][j]);
    }
}

// one kernel instance: set its dynamic shared memory and launch
template <typename Kern, typename... Args>
__host__ int launch(Kern kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
