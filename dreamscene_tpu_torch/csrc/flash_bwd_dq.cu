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
// What bounds it: operations (6*b*h*n^2*d FLOPs; at the VAE encoder's
// [4, 1, 4096, 512] that is 2.06e11 against 29 MB), so the products belong
// on the tensor cores. dQ has one float32 accumulator where dK/dV has two,
// so at d = 512 a CTA can own 64 query rows (64 x 512 float32 over 256
// threads, 128 registers each) and re-read K and V half as often as dK/dV
// re-reads Q and dO.
//
// Design, both variants: one CTA owns a block of BQ query rows (Q, dO and
// the rows' m, 1/l, di resident) and loops over blocks of BK keys; the
// BQ x D accumulator stays in registers until the end. No atomics and no
// cross-CTA state: each CTA owns its rows of dQ, so the result is
// bit-reproducible.
//
//  * bfloat16, d a multiple of 16 (flash_bwd_dq_tc_kernel), the mirror
//    image of flash_bwd_dkv_tc_kernel: all tiles are bfloat16, swizzled;
//    the K and V blocks arrive by cp.async in two stages. Phase A (warps
//    tile rows x keys): S = Q.K^T and dP = dO.V^T by mma.sync over the full
//    d with query rows as accumulator rows, so m, 1/l and di index rows (g
//    and g + 8 of each 16-row tile) and are loaded once; ds is formed on
//    the accumulator fragments, rounded to bfloat16 once and written to a
//    padded shared tile. Phase B (warps split the D columns): dQ[:, cols]
//    += ds . K[:, cols], the [keys][d] K tile read with ldmatrix.trans.
//    At D = 512 the 227 KB of shared memory hold Q + dO for 64 rows
//    (128 KB) and two stages of 16-key K/V blocks (64 KB). The other
//    tiling that fits (32 rows, 32-key blocks) re-reads K and V twice as
//    often and is slower at the batch of 4 every backward launch of the
//    training path has (PERF.md; the script that timed both is in commit
//    e119691).
//  * float32, or bfloat16 with d no multiple of 16 (flash_bwd_dq_kernel):
//    scalar FMAs on the CUDA cores over float32 tiles (flash_common.cuh).

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------
// float32 operands: CUDA cores
// ---------------------------------------------------------------------

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

  load_tile<T, D, NT>(sq, q + head + (size_t)q0 * d, BQ, d, (size_t)d, tid);
  load_tile<T, D, NT>(sdo, dout + head + (size_t)q0 * d, BQ, d, (size_t)d, tid);
  if (tid < BQ) {
    sm[tid] = m[hrow + q0 + tid];
    sil[tid] = 1.f / l[hrow + q0 + tid];
    sdi[tid] = di[hrow + q0 + tid];
  }
  float gq[SI][OJ];
  zero(gq);
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();
    load_tile<T, D, NT>(sk, k + head + (size_t)k0 * d, BK, d, (size_t)d, tid);
    load_tile<T, D, NT>(sv, v + head + (size_t)k0 * d, BK, d, (size_t)d, tid);
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
  store_rows<T, SI, OJ, TY>(dq + head + (size_t)q0 * d, gq, d, (size_t)d, ty, tx);
}

// ---------------------------------------------------------------------
// bfloat16 operands: tensor cores
// ---------------------------------------------------------------------

// NW warps; phase A tiles the BQ x BK scores as WM x (NW / WM) warps.
template <int D> struct TcCfg;
template <> struct TcCfg<64> { static constexpr int NW = 4, BQ = 64, BK = 64, WM = 4; };
template <> struct TcCfg<128> { static constexpr int NW = 8, BQ = 64, BK = 64, WM = 4; };
template <> struct TcCfg<256> { static constexpr int NW = 8, BQ = 64, BK = 32, WM = 4; };
template <> struct TcCfg<512> { static constexpr int NW = 8, BQ = 64, BK = 16, WM = 4; };

template <int D> constexpr size_t tc_smem() {
  using C = TcCfg<D>;
  return (size_t)(2 * C::BQ + 4 * C::BK) * D * 2 + (size_t)C::BQ * (C::BK + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(TcCfg<D>::NW * 32, 1) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ l, const float* __restrict__ m, const bf16* __restrict__ dout,
    const float* __restrict__ di, bf16* __restrict__ dq, int n, int d, float scale) {
  using C = TcCfg<D>;
  constexpr int NW = C::NW, NT = NW * 32, BQ = C::BQ, BK = C::BK;
  constexpr int WM = C::WM, WN = NW / WM;
  constexpr int MT_A = BQ / 16 / WM, NT_A = BK / 8 / WN;   // phase A tiles per warp
  constexpr int MT = BQ / 16, CW = D / NW, NB = CW / 8;    // phase B: all rows x CW columns
  constexpr int PST = BK + 8;
  constexpr uint32_t QT = BQ * D * 2, KV = BK * D * 2;
  static_assert(MT_A >= 1 && NT_A >= 1 && CW % 16 == 0 && D % 32 == 0 && BK % 16 == 0,
                "tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);   // [BQ][D]
  const uint32_t sDO = sQ + QT;             // [BQ][D]
  const uint32_t sK = sDO + QT;             // 2 x [BK][D]
  const uint32_t sV = sK + 2 * KV;          // 2 x [BK][D]
  const uint32_t sDS = sV + 2 * KV;         // [BQ][PST] ds (bfloat16)
  bf16* ds_tile = reinterpret_cast<bf16*>(smem_raw + 2 * (size_t)QT + 4 * (size_t)KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const size_t head = (size_t)blockIdx.y * n * d;
  const size_t hrow = (size_t)blockIdx.y * n;
  const int q0 = blockIdx.x * BQ;

  load_tile_async<D, BQ, NT>(sQ, q + head + (size_t)q0 * d, d, d, tid);
  load_tile_async<D, BQ, NT>(sDO, dout + head + (size_t)q0 * d, d, d, tid);
  load_tile_async<D, BK, NT>(sK, k + head, d, d, tid);
  load_tile_async<D, BK, NT>(sV, v + head, d, d, tid);
  cp_async_commit();

  // the statistics of this thread's query rows in phase A (2 per m-tile)
  float qm[MT_A][2], qil[MT_A][2], qdi[MT_A][2];
#pragma unroll
  for (int mt = 0; mt < MT_A; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const size_t at = hrow + q0 + (wm * MT_A + mt) * 16 + g + 8 * e;
      qm[mt][e] = m[at];
      qil[mt][e] = 1.f / l[at];
      qdi[mt][e] = di[at];
    }

  float gq[MT][NB][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gq[i][j][e] = 0.f;

  const int nblk = n / BK;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // block j has landed; everyone is done with block j - 1
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * KV;
      load_tile_async<D, BK, NT>(sK + st, k + head + (size_t)(j + 1) * BK * d, d, d, tid);
      load_tile_async<D, BK, NT>(sV + st, v + head + (size_t)(j + 1) * BK * d, d, d, tid);
      cp_async_commit();
    }
    const uint32_t kb = sK + (j & 1) * KV, vb = sV + (j & 1) * KV;

    // phase A: this warp's MT_A x NT_A tiles of S = Q.K^T and dP = dO.V^T
    float s[MT_A][NT_A][4], dp[MT_A][NT_A][4];
#pragma unroll
    for (int i = 0; i < MT_A; ++i)
#pragma unroll
      for (int jj = 0; jj < NT_A; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][jj][e] = dp[i][jj][e] = 0.f;
#pragma unroll 2
    for (int ks2 = 0; ks2 < D / 32; ++ks2) {
      uint32_t aq[MT_A][2][4], ao[MT_A][2][4];
#pragma unroll
      for (int mt = 0; mt < MT_A; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          ldsm_x4(aq[mt][u], sQ + frag_a<D>((wm * MT_A + mt) * 16, 2 * ks2 + u, lane));
          ldsm_x4(ao[mt][u], sDO + frag_a<D>((wm * MT_A + mt) * 16, 2 * ks2 + u, lane));
        }
#pragma unroll
      for (int nt = 0; nt < NT_A; ++nt) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kb + frag_b1<D>((wn * NT_A + nt) * 8, ks2, lane));
        ldsm_x4(bv, vb + frag_b1<D>((wn * NT_A + nt) * 8, ks2, lane));
#pragma unroll
        for (int mt = 0; mt < MT_A; ++mt) {
          mma16816(s[mt][nt], aq[mt][0], bk[0], bk[1]);
          mma16816(s[mt][nt], aq[mt][1], bk[2], bk[3]);
          mma16816(dp[mt][nt], ao[mt][0], bv[0], bv[1]);
          mma16816(dp[mt][nt], ao[mt][1], bv[2], bv[3]);
        }
      }
    }
    // ds, rounded once, to shared memory as [query][key]
#pragma unroll
    for (int mt = 0; mt < MT_A; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT_A; ++nt) {
        float de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = expf(s[mt][nt][e] * scale - qm[mt][r]) * qil[mt][r];
          de[e] = (dp[mt][nt][e] - qdi[mt][r]) * p * scale;
        }
        const int row = (wm * MT_A + mt) * 16 + g, col = (wn * NT_A + nt) * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ds_tile + row * PST + col) = pack_bf16(de[0], de[1]);
        *reinterpret_cast<uint32_t*>(ds_tile + (row + 8) * PST + col) = pack_bf16(de[2], de[3]);
      }
    __syncthreads();

    // phase B: dQ[:, cols] += ds . K[:, cols]
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ad[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(ad[mt], sDS + frag_a_pad(mt * 16, kk * 16, PST, lane));
#pragma unroll
      for (int pp = 0; pp < CW / 16; ++pp) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kb + frag_bt<D>(kk * 16, warp * CW + pp * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(gq[mt][2 * pp], ad[mt], bk[0], bk[1]);
          mma16816(gq[mt][2 * pp + 1], ad[mt], bk[2], bk[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = warp * CW + nb * 8 + 2 * t;
      if (col < d) {
        const size_t at = head + (size_t)(q0 + mt * 16 + g) * d + col;
        *reinterpret_cast<__nv_bfloat162*>(dq + at) =
            __floats2bfloat162_rn(gq[mt][nb][0], gq[mt][nb][1]);
        *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * (size_t)d) =
            __floats2bfloat162_rn(gq[mt][nb][2], gq[mt][nb][3]);
      }
    }
}

template <int D>
int run_tc(const void* q, const void* k, const void* v, const void* l, const void* m,
           const void* dout, const void* di, void* dq, int bh, int n, int d, float scale,
           cudaStream_t st) {
  using C = TcCfg<D>;
  return launch(flash_bwd_dq_tc_kernel<D>, dim3(n / C::BQ, bh), C::NW * 32,
                tc_smem<D>(), st, (const bf16*)q, (const bf16*)k, (const bf16*)v,
                (const float*)l, (const float*)m, (const bf16*)dout, (const float*)di,
                (bf16*)dq, n, d, scale);
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

// q, k, v, dout, dq: [bh, n, d] contiguous (bf16 != 0: bfloat16, else
// float32); l, m, di: [bh, n] float32. n a multiple of 128, 1 <= d <= 512.
// tc != 0 takes the tensor-core kernel: bfloat16, d a multiple of 16.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* l, const void* m, const void* dout,
                               const void* di, void* dq, int bh, int n, int d, float scale,
                               int bf16_, int tc, void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
    if (!bf16_ || d % 16 != 0) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (d <= 64) return run_tc<64>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
    if (d <= 128) return run_tc<128>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
    if (d <= 256) return run_tc<256>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
    return run_tc<512>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
  }
  return bf16_ ? run_d<__nv_bfloat16>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st)
               : run_d<float>(q, k, v, l, m, dout, di, dq, bh, n, d, scale, st);
}
