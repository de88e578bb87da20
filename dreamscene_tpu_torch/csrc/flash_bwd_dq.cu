// K4 backward, dQ.
//
// Replaces: the _flash_attention_bwd_dq pallas_call of
// jax/experimental/pallas/ops/tpu/flash_attention.py (kernel
// _flash_attention_dq_kernel), reached through
// dreamscene_tpu/guidance/sd_flax.py:120 `_flash_attention`'s VJP.
//
// What it computes, per head, for a block of query rows, summed over all
// keys (the JAX kernel's contract): s = (q . k) * scale in float32;
// p = exp(s - m) * (1 / l); dp = dO . v; ds = (dp - di) * p, ds *= scale;
// dQ += ds (rounded to k's type) . k with float32 accumulation; dQ rounded
// to the operand type at the end.
//
// Design: one CTA per block of BQ query rows (Q, dO, m, 1/l, di resident
// in shared memory), looping over blocks of BK keys (K, V staged per
// block); the BQ x D accumulator stays in registers.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D> struct Cfg;
template <> struct Cfg<64> { static constexpr int NT = 128, BQ = 64, BK = 64; };
template <> struct Cfg<128> { static constexpr int NT = 128, BQ = 32, BK = 32; };
template <> struct Cfg<256> { static constexpr int NT = 256, BQ = 32, BK = 32; };
template <> struct Cfg<512> { static constexpr int NT = 256, BQ = 16, BK = 16; };

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ l, const float* __restrict__ m, const T* __restrict__ dout,
    const float* __restrict__ di, T* __restrict__ dq, int n, int d, float scale) {
  constexpr int NT = Cfg<D>::NT, BQ = Cfg<D>::BQ, BK = Cfg<D>::BK;
  constexpr int S = D + 1, PS = BK + 1, TY = NT / TX;
  constexpr int SI = BQ / TY, SJ = BK / TX, OJ = D / TX;
  extern __shared__ float smem[];
  float* sq = smem;              // [BQ][S]
  float* sdo = sq + BQ * S;      // [BQ][S]
  float* sk = sdo + BQ * S;      // [BK][S]
  float* sv = sk + BK * S;       // [BK][S]
  float* sds = sv + BK * S;      // [BQ][PS] ds rounded to T
  float* sm = sds + BQ * PS;     // [BQ]
  float* sil = sm + BQ;          // [BQ] 1 / l
  float* sdi = sil + BQ;         // [BQ]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const size_t head = (size_t)blockIdx.y * n * d;
  const size_t hrow = (size_t)blockIdx.y * n;
  const int q0 = blockIdx.x * BQ;

  load_tile<T, D, NT>(sq, q + head + (size_t)q0 * d, BQ, d, tid);
  load_tile<T, D, NT>(sdo, dout + head + (size_t)q0 * d, BQ, d, tid);
  if (tid < BQ) {
    sm[tid] = m[hrow + q0 + tid];
    sil[tid] = 1.f / l[hrow + q0 + tid];
    sdi[tid] = di[hrow + q0 + tid];
  }
  float gq[SI][OJ];
  zero(gq);
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();
    load_tile<T, D, NT>(sk, k + head + (size_t)k0 * d, BK, d, tid);
    load_tile<T, D, NT>(sv, v + head + (size_t)k0 * d, BK, d, tid);
    __syncthreads();
    float s[SI][SJ], dp[SI][SJ];
    zero(s);
    zero(dp);
    mm_acc<SI, SJ, TY, D>(s, sq, S, 1, sk, 1, S, ty, tx);
    mm_acc<SI, SJ, TY, D>(dp, sdo, S, 1, sv, 1, S, ty, tx);
#pragma unroll
    for (int i = 0; i < SI; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        const float p = expf(s[i][j] * scale - sm[r]) * sil[r];
        sds[r * PS + tx + TX * j] = round_t<T>((dp[i][j] - sdi[r]) * p * scale);
      }
    }
    __syncthreads();
    // each key block's sum is formed apart and then added (blocked summation)
    float pq[SI][OJ];
    zero(pq);
    mm_acc<SI, OJ, TY, BK>(pq, sds, PS, 1, sk, S, 1, ty, tx);
    add_to(gq, pq);
  }
  store_rows<T, SI, OJ, TY>(dq + head + (size_t)q0 * d, gq, d, ty, tx);
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* l, const void* m,
        const void* dout, const void* di, void* dq, int bh, int n, int d, float scale,
        cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem = sizeof(float) * ((size_t)(2 * C::BQ + 2 * C::BK) * (D + 1) +
                                       C::BQ * (C::BK + 1) + 3 * C::BQ);
  return launch(flash_bwd_dq_kernel<T, D>, dim3(n / C::BQ, bh), C::NT, smem, st,
                (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,
                (const T*)dout, (const float*)di, (T*)dq, n, d, scale);
}

template <typename T>
int run_d(const void* q, const void* k, const void* v, const void* l, const void* m,
          const void* dout, const void* di, void* dq, int bh, int n, int d, float scale,
          cudaStream_t st) {
  if (d <= 64) return run<T, 64>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
  if (d <= 128) return run<T, 128>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
  if (d <= 256) return run<T, 256>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
  return run<T, 512>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
}

}  // namespace

// q, k, v, dout, dq: [bh, n, d] (bf16 != 0: bfloat16, else float32);
// l, m, di: [bh, n] float32. n a multiple of 128, 1 <= d <= 512.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* l, const void* m, const void* dout,
                               const void* di, void* dq, int bh, int n, int d, float scale,
                               int bf16, void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run_d<__nv_bfloat16>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st)
              : run_d<float>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
}
