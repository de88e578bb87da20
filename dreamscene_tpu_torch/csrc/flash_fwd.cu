// K4 forward: flash attention with an online softmax.
//
// Replaces: the forward pallas_call of jax/experimental/pallas/ops/tpu/
// flash_attention.py (_flash_attention_kernel_single_batch), which the
// JAX package reaches through dreamscene_tpu/guidance/sd_flax.py:120
// `_flash_attention`.
//
// What it computes, per head and query row (the JAX kernel's contract):
// s = (q . k) in float32, then s *= scale; running max m and sum l;
// p = exp(s - m_next) in float32, rounded to the operand type before P.V
// (float32 accumulation); acc = acc * (l_corr / l_next) + (P.V) / l_next
// with the l_next == 0 guard; o = acc rounded to the operand type. Also
// writes the final l and m (float32 [b*h, n]) for the backward kernels.
//
// Design: one CTA per block of BQ query rows, looping over blocks of BK
// keys; Q, K, V and P tiles in shared memory (flash_common.cuh). The row
// statistics are reduced by NT / BQ adjacent threads per row with warp
// shuffles; the BQ x D accumulator stays in registers.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D> struct Cfg;
template <> struct Cfg<64> { static constexpr int NT = 128, BQ = 64, BK = 64; };
template <> struct Cfg<128> { static constexpr int NT = 128, BQ = 32, BK = 64; };
template <> struct Cfg<256> { static constexpr int NT = 256, BQ = 32, BK = 32; };
template <> struct Cfg<512> { static constexpr int NT = 256, BQ = 16, BK = 32; };

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int n,
    int d, float scale) {
  constexpr int NT = Cfg<D>::NT, BQ = Cfg<D>::BQ, BK = Cfg<D>::BK;
  constexpr int S = D + 1, PS = BK + 1, TY = NT / TX;
  constexpr int SI = BQ / TY, SJ = BK / TX, OJ = D / TX;
  constexpr int G = NT / BQ;  // threads per row in the softmax
  extern __shared__ float smem[];
  float* sq = smem;             // [BQ][S]
  float* sk = sq + BQ * S;      // [BK][S]
  float* sv = sk + BK * S;      // [BK][S]
  float* sp = sv + BK * S;      // [BQ][PS] scores, then p
  float* rscale = sp + BQ * PS; // [BQ] l_corr / l_next
  float* rinv = rscale + BQ;    // [BQ] 1 / l_next
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int row = tid / G, g = tid % G;
  const size_t head = (size_t)blockIdx.y * n * d;
  const int q0 = blockIdx.x * BQ;

  load_tile<T, D, NT>(sq, q + head + (size_t)q0 * d, BQ, d, tid);
  float acc[SI][OJ];
  zero(acc);
  float m_prev = -INFINITY, l_prev = 0.f;
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();
    load_tile<T, D, NT>(sk, k + head + (size_t)k0 * d, BK, d, tid);
    load_tile<T, D, NT>(sv, v + head + (size_t)k0 * d, BK, d, tid);
    __syncthreads();
    float s[SI][SJ];
    zero(s);
    mm_acc<SI, SJ, TY, D>(s, sq, S, 1, sk, 1, S, ty, tx);
#pragma unroll
    for (int i = 0; i < SI; ++i)
#pragma unroll
      for (int j = 0; j < SJ; ++j) sp[(ty + TY * i) * PS + tx + TX * j] = s[i][j] * scale;
    __syncthreads();

    float* pr = sp + row * PS;
    float mc = -INFINITY;
    for (int j = g; j < BK; j += G) mc = fmaxf(mc, pr[j]);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
    const float mn = fmaxf(m_prev, mc);
    float sum = 0.f;
    for (int j = g; j < BK; j += G) {
      const float p = expf(pr[j] - mn);
      sum += p;
      pr[j] = round_t<T>(p);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float lc = expf(m_prev - mn) * l_prev;
    const float ln = sum + lc;
    const float inv = ln == 0.f ? 1.f : 1.f / ln;
    if (g == 0) {
      rscale[row] = lc * inv;
      rinv[row] = inv;
    }
    m_prev = mn;
    l_prev = ln;
    __syncthreads();

    float pv[SI][OJ];
    zero(pv);
    mm_acc<SI, OJ, TY, BK>(pv, sp, PS, 1, sv, S, 1, ty, tx);
#pragma unroll
    for (int i = 0; i < SI; ++i) {
      const float a = rscale[ty + TY * i], b = rinv[ty + TY * i];
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] = acc[i][j] * a + pv[i][j] * b;
    }
  }
  store_rows<T, SI, OJ, TY>(o + head + (size_t)q0 * d, acc, d, ty, tx);
  if (g == 0) {
    l_out[(size_t)blockIdx.y * n + q0 + row] = l_prev;
    m_out[(size_t)blockIdx.y * n + q0 + row] = m_prev;
  }
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, void* o, void* l, void* m, int bh,
        int n, int d, float scale, cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem =
      sizeof(float) * ((size_t)(C::BQ + 2 * C::BK) * (D + 1) + C::BQ * (C::BK + 1) + 2 * C::BQ);
  return launch(flash_fwd_kernel<T, D>, dim3(n / C::BQ, bh), C::NT, smem, st,
                (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)l, (float*)m, n, d,
                scale);
}

template <typename T>
int run_d(const void* q, const void* k, const void* v, void* o, void* l, void* m, int bh,
          int n, int d, float scale, cudaStream_t st) {
  if (d <= 64) return run<T, 64>(q, k, v, o, l, m, bh, n, d, scale, st);
  if (d <= 128) return run<T, 128>(q, k, v, o, l, m, bh, n, d, scale, st);
  if (d <= 256) return run<T, 256>(q, k, v, o, l, m, bh, n, d, scale, st);
  return run<T, 512>(q, k, v, o, l, m, bh, n, d, scale, st);
}

}  // namespace

// q, k, v, o: [bh, n, d] (bf16 != 0: bfloat16, else float32); l, m: [bh, n]
// float32. n a multiple of 128, 1 <= d <= 512.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* l, void* m, int bh, int n, int d, float scale, int bf16,
                            void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run_d<__nv_bfloat16>(q, k, v, o, l, m, bh, n, d, scale, st)
              : run_d<float>(q, k, v, o, l, m, bh, n, d, scale, st);
}
