// Shared pieces of the K4 flash-attention kernels (flash_fwd.cu,
// flash_bwd_dkv.cu, flash_bwd_dq.cu).
//
// Replaces the Pallas TPU flash attention the JAX package calls through
// dreamscene_tpu/guidance/sd_flax.py:120 (jax/experimental/pallas/ops/
// tpu/flash_attention.py: forward kernel, _flash_attention_bwd_dkv,
// _flash_attention_bwd_dq). Every kernel accumulates in float32 and
// rounds through the operand type exactly where the JAX kernels cast: p
// before P.V, p^T and ds^T before the dK/dV products, ds before the dQ
// product, and the outputs.
//
// What bounds them: at the main path's shapes the work is operations
// (4*b*h*n^2*d FLOPs forward, 8x backward dK/dV), far above the bytes, so
// the products belong on the tensor cores. Two families of helpers live
// here:
//
//  * bfloat16 operands, tensor cores (forward and dK/dV): tiles stay
//    bfloat16 in shared memory, rows of D elements with their 16-byte
//    chunks XOR-swizzled by the row (chunk ^ (row & 7); at D = 64 a row is
//    128 bytes and this is the hardware's 128-byte swizzle), filled by
//    16-byte cp.async copies in two stages (zero-filled from the true head
//    dim d up to the compile-time bucket D). Products accumulate in
//    float32 registers (bf16 x bf16 is exact in float32). Two instruction
//    families: wgmma (m64n64k16, one warpgroup per 64 rows, B read from
//    shared memory through a descriptor, A from registers) where a tile
//    row is exactly one 128-byte swizzle row, i.e. the forward at D = 64
//    (the UNet's self-attention, most of the main path's K4 launches); and
//    ldmatrix +
//    mma.sync.m16n8k16 for the wider buckets and the dK/dV kernel, whose
//    tiles split over warps in ways a 64-row warpgroup product does not
//    fit without a slab layout per 64 columns. Both leave the accumulator
//    in the same fragment layout (a row lives in the 4 threads of a quad),
//    so the softmax code and the register hand-over of P are shared.
//  * float32 operands (and bfloat16 head dims that are no multiple of 16),
//    CUDA cores: tensor cores have no float32 product at float32
//    accuracy. Tiles are staged as float32 with an odd row stride (D + 1),
//    products are scalar FMAs over register micro-tiles: thread (ty, tx)
//    owns rows ty + TY*i and columns tx + TX*j of each result.
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

// rows x d block of a head (row stride ld elements) -> shared
// [rows][D + 1] float32, columns d..D-1 zero
template <typename T, int D, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int d,
                                          size_t ld, int tid) {
  constexpr int S = D + 1;
  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D, c = i - r * D;
    dst[r * S + c] = c < d ? to_f<T>(src[r * ld + c]) : 0.f;
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

// acc rows x D -> head rows (row stride ld elements), columns < d only
template <typename T, int MI, int NJ, int TY>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[MI][NJ], int d,
                                           size_t ld, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = ty + TY * i, c = tx + TX * j;
      if (c < d) dst[r * ld + c] = from_f<T>(acc[i][j]);
    }
}

// ---------------------------------------------------------------------
// bfloat16 tensor-core pieces
// ---------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// element strides of a [b, h, n, d] tensor whose d stride is 1
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile with
// rows of D bfloat16 (D >= 64)
template <int D> __device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * (D * 2) + ((chunk ^ (row & 7)) << 4));
}

// ROWS x d block (row stride ld elements, d a multiple of 8) -> swizzled
// shared tile [ROWS][D], columns d..D-1 zero. Asynchronous: the caller
// commits and waits.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src, long long ld,
                                                int d, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const bool in = c * 8 < d;
    cp_async16(dst + swz<D>(r, c), in ? (const void*)(src + r * ld + c * 8) : (const void*)src,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row-major fragment) . b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bfloat16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma (warpgroup products, B from shared memory) ----

// Descriptor of a bfloat16 tile in shared memory, 1024-byte aligned, rows
// of 128 bytes under the 128-byte swizzle, groups of 8 rows 1024 bytes
// apart. As [n][k] (K-major) a k-step of 16 advances the address by 32
// bytes (descriptor + 2); as [k][n] (MN-major, with the transpose flag) by
// 16 rows (descriptor + 128).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// makes this thread's shared-memory writes (cp.async included) visible to
// wgmma's reads; goes between the wait for the copies and the barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// d (64 x 64 over the warpgroup, 16 rows a warp, the mma.sync accumulator
// layout per 8-column tile) += a (this warp's 16 x 16 A fragment) . b (16 x
// 64 from shared memory); TB = 1: b is stored [k][n]
template <int TB>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[8][4], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// ldmatrix.x4 lane addresses into a swizzled tile [rows][D]. Lane L names
// row L % 8 of matrix L / 8.
//  frag_a:  A fragment of rows row0..+15, k = 16*ks..+15 (tile is [m][k])
//  frag_b2: B fragments of the n-tiles at n0 and n0 + 8, k = 16*ks..+15
//           (tile is [n][k]); registers {0,1} are the first tile's
//  frag_b1: B fragments of the n-tile at n0, k = 32*ks2..+31 (tile is
//           [n][k]); registers {0,1} are k-step 2*ks2, {2,3} k-step 2*ks2+1
//  frag_bt: (with ldsm_x4_t) B fragments of the n-tiles at n0 and n0 + 8,
//           k = k0..+15, from a tile stored [k][n]
template <int D> __device__ __forceinline__ uint32_t frag_a(int row0, int ks, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return swz<D>(row0 + (mi & 1) * 8 + r, 2 * ks + (mi >> 1));
}
template <int D> __device__ __forceinline__ uint32_t frag_b2(int n0, int ks, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return swz<D>(n0 + (mi >> 1) * 8 + r, 2 * ks + (mi & 1));
}
template <int D> __device__ __forceinline__ uint32_t frag_b1(int n0, int ks2, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return swz<D>(n0 + r, 4 * ks2 + mi);
}
template <int D> __device__ __forceinline__ uint32_t frag_bt(int k0, int n0, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return swz<D>(k0 + (mi & 1) * 8 + r, (n0 >> 3) + (mi >> 1));
}
// A fragment of rows row0..+15, columns col0..+15 of a padded (unswizzled)
// tile with a row stride of `stride` bfloat16 (stride * 2 bytes = 16 mod
// 128 keeps ldmatrix free of bank conflicts)
__device__ __forceinline__ uint32_t frag_a_pad(int row0, int col0, int stride, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  return (uint32_t)(((row0 + (mi & 1) * 8 + r) * stride + col0 + (mi >> 1) * 8) * 2);
}

// 2^x on the special-function unit (relative error 2^-22, far inside the
// bfloat16 rounding of p; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
