// K4 backward, dK and dV.
//
// Replaces: the _flash_attention_bwd_dkv pallas_call of
// jax/experimental/pallas/ops/tpu/flash_attention.py (kernel
// _flash_attention_dkv_kernel), reached through
// dreamscene_tpu/guidance/sd_flax.py:120 `_flash_attention`'s VJP.
//
// What it computes, per head, for a block of keys, summed over all query
// rows (the JAX kernel's contract): s = (q . k) * scale in float32;
// p = exp(s - m) * (1 / l) with the forward's m and l;
// dV += p^T (rounded to dO's type) . dO; dp = dO . v; ds = (dp - di) * p,
// ds *= scale; dK += ds^T (rounded to dO's type) . q; float32
// accumulation, dK / dV rounded to the operand type at the end. di =
// sum(o * dO) over the head dim is computed by the caller from the
// stored (operand-type) output, as the JAX VJP does.
//
// Design: one CTA per block of BK keys (K, V resident in shared memory),
// looping over blocks of BQ query rows (Q, dO, m, 1/l, di staged per
// block); the BK x D dK and dV accumulators stay in registers. No
// atomics: each CTA owns its rows of dK and dV.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D> struct Cfg;
template <> struct Cfg<64> { static constexpr int NT = 128, BK = 64, BQ = 64; };
template <> struct Cfg<128> { static constexpr int NT = 128, BK = 32, BQ = 32; };
template <> struct Cfg<256> { static constexpr int NT = 256, BK = 32, BQ = 32; };
template <> struct Cfg<512> { static constexpr int NT = 256, BK = 16, BQ = 16; };

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ l, const float* __restrict__ m, const T* __restrict__ dout,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv, int n, int d,
    float scale) {
  constexpr int NT = Cfg<D>::NT, BK = Cfg<D>::BK, BQ = Cfg<D>::BQ;
  constexpr int S = D + 1, PS = BK + 1, TY = NT / TX;
  constexpr int SI = BQ / TY, SJ = BK / TX;  // score micro-tile [BQ][BK]
  constexpr int KI = BK / TY, OJ = D / TX;   // dK / dV micro-tile [BK][D]
  extern __shared__ float smem[];
  float* sk = smem;              // [BK][S]
  float* sv = sk + BK * S;       // [BK][S]
  float* sq = sv + BK * S;       // [BQ][S]
  float* sdo = sq + BQ * S;      // [BQ][S]
  float* sp = sdo + BQ * S;      // [BQ][PS] p rounded to T
  float* sds = sp + BQ * PS;     // [BQ][PS] ds rounded to T
  float* sm = sds + BQ * PS;     // [BQ]
  float* sil = sm + BQ;          // [BQ] 1 / l
  float* sdi = sil + BQ;         // [BQ]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const size_t head = (size_t)blockIdx.y * n * d;
  const size_t hrow = (size_t)blockIdx.y * n;
  const int k0 = blockIdx.x * BK;

  load_tile<T, D, NT>(sk, k + head + (size_t)k0 * d, BK, d, tid);
  load_tile<T, D, NT>(sv, v + head + (size_t)k0 * d, BK, d, tid);
  float gk[KI][OJ], gv[KI][OJ];
  zero(gk);
  zero(gv);
  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();
    load_tile<T, D, NT>(sq, q + head + (size_t)q0 * d, BQ, d, tid);
    load_tile<T, D, NT>(sdo, dout + head + (size_t)q0 * d, BQ, d, tid);
    if (tid < BQ) {
      sm[tid] = m[hrow + q0 + tid];
      sil[tid] = 1.f / l[hrow + q0 + tid];
      sdi[tid] = di[hrow + q0 + tid];
    }
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
        const int c = tx + TX * j;
        const float p = expf(s[i][j] * scale - sm[r]) * sil[r];
        const float ds = (dp[i][j] - sdi[r]) * p * scale;
        sp[r * PS + c] = round_t<T>(p);
        sds[r * PS + c] = round_t<T>(ds);
      }
    }
    __syncthreads();
    // dV[j][c] += sum_r p[r][j] dO[r][c];  dK[j][c] += sum_r ds[r][j] q[r][c].
    // Each query block's sum is formed apart and then added (blocked
    // summation, as the JAX kernel's per-block products are)
    float pv[KI][OJ], pk[KI][OJ];
    zero(pv);
    zero(pk);
    mm_acc<KI, OJ, TY, BQ>(pv, sp, 1, PS, sdo, S, 1, ty, tx);
    mm_acc<KI, OJ, TY, BQ>(pk, sds, 1, PS, sq, S, 1, ty, tx);
    add_to(gv, pv);
    add_to(gk, pk);
  }
  store_rows<T, KI, OJ, TY>(dk + head + (size_t)k0 * d, gk, d, ty, tx);
  store_rows<T, KI, OJ, TY>(dv + head + (size_t)k0 * d, gv, d, ty, tx);
}

template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* l, const void* m,
        const void* dout, const void* di, void* dk, void* dv, int bh, int n, int d,
        float scale, cudaStream_t st) {
  using C = Cfg<D>;
  const size_t smem = sizeof(float) * ((size_t)(2 * C::BK + 2 * C::BQ) * (D + 1) +
                                       2 * C::BQ * (C::BK + 1) + 3 * C::BQ);
  return launch(flash_bwd_dkv_kernel<T, D>, dim3(n / C::BK, bh), C::NT, smem, st,
                (const T*)q, (const T*)k, (const T*)v, (const float*)l, (const float*)m,
                (const T*)dout, (const float*)di, (T*)dk, (T*)dv, n, d, scale);
}

template <typename T>
int run_d(const void* q, const void* k, const void* v, const void* l, const void* m,
          const void* dout, const void* di, void* dk, void* dv, int bh, int n, int d,
          float scale, cudaStream_t st) {
  if (d <= 64) return run<T, 64>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
  if (d <= 128) return run<T, 128>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
  if (d <= 256) return run<T, 256>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
  return run<T, 512>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
}

}  // namespace

// q, k, v, dout, dk, dv: [bh, n, d] (bf16 != 0: bfloat16, else float32);
// l, m, di: [bh, n] float32. n a multiple of 128, 1 <= d <= 512.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* l, const void* m, const void* dout,
                                const void* di, void* dk, void* dv, int bh, int n, int d,
                                float scale, int bf16, void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? run_d<__nv_bfloat16>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st)
              : run_d<float>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
}
