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
// What bounds it: operations (8*b*h*n^2*d FLOPs; at the VAE encoder's
// [4, 1, 4096, 512] that is 2.75e11 against 34 MB), so the products belong
// on the tensor cores, and at d = 512 the two float32 accumulators decide
// the tiling: dK and dV for 64 keys would be 2 x 128 KB, the SM's whole
// register file.
//
// Design, both variants: one CTA owns a block of BK keys (K, V resident in
// shared memory) and loops over blocks of BQ query rows; dK and dV for its
// keys stay in registers until the end. No atomics and no cross-CTA
// state: each CTA owns its rows of dK and dV, so the result is
// bit-reproducible.
//
//  * bfloat16, d a multiple of 16 (flash_bwd_dkv_tc_kernel): 32 keys per
//    CTA at D = 512, so both accumulators fit (2 x 64 KB over 256 threads,
//    128 registers each; 64 keys at the smaller buckets). All tiles are
//    bfloat16, swizzled; the Q and dO tiles arrive by cp.async in two
//    stages. Phase A (warps tile keys x queries): S^T = K.Q^T and
//    dP^T = V.dO^T by mma.sync with keys as rows, so l, m and di index
//    columns; p^T and ds^T are formed on the accumulator fragments,
//    rounded to bfloat16 once and written to shared memory. Phase B (warps
//    split the D columns): dV += p^T . dO and dK += ds^T . Q, the Q / dO
//    tiles read with ldmatrix.trans.
//  * float32, or bfloat16 with d no multiple of 16
//    (flash_bwd_dkv_kernel): scalar FMAs on the CUDA cores over float32
//    tiles (flash_common.cuh).

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------
// float32 operands: CUDA cores
// ---------------------------------------------------------------------

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

  load_tile<T, D, NT>(sk, k + head + (size_t)k0 * d, BK, d, (size_t)d, tid);
  load_tile<T, D, NT>(sv, v + head + (size_t)k0 * d, BK, d, (size_t)d, tid);
  float gk[KI][OJ], gv[KI][OJ];
  zero(gk);
  zero(gv);
  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();
    load_tile<T, D, NT>(sq, q + head + (size_t)q0 * d, BQ, d, (size_t)d, tid);
    load_tile<T, D, NT>(sdo, dout + head + (size_t)q0 * d, BQ, d, (size_t)d, tid);
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
  store_rows<T, KI, OJ, TY>(dk + head + (size_t)k0 * d, gk, d, (size_t)d, ty, tx);
  store_rows<T, KI, OJ, TY>(dv + head + (size_t)k0 * d, gv, d, (size_t)d, ty, tx);
}

// ---------------------------------------------------------------------
// bfloat16 operands: tensor cores
// ---------------------------------------------------------------------

// NW warps; phase A tiles the BK x BQ scores as WM x (NW / WM) warps
template <int D> struct TcCfg;
template <> struct TcCfg<64> { static constexpr int NW = 4, BK = 64, BQ = 64, WM = 4; };
template <> struct TcCfg<128> { static constexpr int NW = 8, BK = 64, BQ = 64, WM = 4; };
template <> struct TcCfg<256> { static constexpr int NW = 8, BK = 64, BQ = 32, WM = 4; };
template <> struct TcCfg<512> { static constexpr int NW = 8, BK = 32, BQ = 32, WM = 2; };

template <int D> constexpr size_t tc_smem() {
  using C = TcCfg<D>;
  return (size_t)(2 * C::BK + 4 * C::BQ) * D * 2 + 2 * (size_t)C::BK * (C::BQ + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(TcCfg<D>::NW * 32, 1) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ l, const float* __restrict__ m, const bf16* __restrict__ dout,
    const float* __restrict__ di, bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int d,
    float scale) {
  using C = TcCfg<D>;
  constexpr int NW = C::NW, NT = NW * 32, BK = C::BK, BQ = C::BQ;
  constexpr int WM = C::WM, WN = NW / WM;
  constexpr int MT_A = BK / 16 / WM, NT_A = BQ / 8 / WN;   // phase A tiles per warp
  constexpr int MT = BK / 16, CW = D / NW, NB = CW / 8;    // phase B: all keys x CW columns
  constexpr int PST = BQ + 8;
  constexpr uint32_t KV = BK * D * 2, QT = BQ * D * 2;
  static_assert(MT_A >= 1 && NT_A >= 1 && CW % 16 == 0 && D % 32 == 0, "tiling");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sK = smem_u32(smem_raw);   // [BK][D]
  const uint32_t sV = sK + KV;              // [BK][D]
  const uint32_t sQ = sV + KV;              // 2 x [BQ][D]
  const uint32_t sDO = sQ + 2 * QT;         // 2 x [BQ][D]
  const uint32_t sP = sDO + 2 * QT;         // [BK][PST] p^T (bfloat16)
  const uint32_t sDS = sP + BK * PST * 2;   // [BK][PST] ds^T (bfloat16)
  bf16* p_tile = reinterpret_cast<bf16*>(smem_raw + 2 * (size_t)KV + 4 * (size_t)QT);
  bf16* ds_tile = p_tile + BK * PST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const size_t head = (size_t)blockIdx.y * n * d;
  const size_t hrow = (size_t)blockIdx.y * n;
  const int k0 = blockIdx.x * BK;

  load_tile_async<D, BK, NT>(sK, k + head + (size_t)k0 * d, d, d, tid);
  load_tile_async<D, BK, NT>(sV, v + head + (size_t)k0 * d, d, d, tid);
  load_tile_async<D, BQ, NT>(sQ, q + head, d, d, tid);
  load_tile_async<D, BQ, NT>(sDO, dout + head, d, d, tid);
  cp_async_commit();

  float gk[MT][NB][4], gv[MT][NB][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gk[i][j][e] = gv[i][j][e] = 0.f;

  const int nblk = n / BQ;
  for (int j = 0; j < nblk; ++j) {
    const int q0 = j * BQ;
    cp_async_wait<0>();
    __syncthreads();   // block j has landed; everyone is done with block j - 1
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * QT;
      load_tile_async<D, BQ, NT>(sQ + st, q + head + (size_t)(q0 + BQ) * d, d, d, tid);
      load_tile_async<D, BQ, NT>(sDO + st, dout + head + (size_t)(q0 + BQ) * d, d, d, tid);
      cp_async_commit();
    }
    const uint32_t qb = sQ + (j & 1) * QT, dob = sDO + (j & 1) * QT;

    // phase A: this warp's MT_A x NT_A tiles of S^T = K.Q^T and dP^T = V.dO^T
    // the statistics of this thread's query columns (2 per n-tile)
    float qm[NT_A][2], qil[NT_A][2], qdi[NT_A][2];
#pragma unroll
    for (int nt = 0; nt < NT_A; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const size_t at = hrow + q0 + (wn * NT_A + nt) * 8 + 2 * t + e;
        qm[nt][e] = m[at];
        qil[nt][e] = 1.f / l[at];
        qdi[nt][e] = di[at];
      }
    float s[MT_A][NT_A][4], dp[MT_A][NT_A][4];
#pragma unroll
    for (int i = 0; i < MT_A; ++i)
#pragma unroll
      for (int jj = 0; jj < NT_A; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][jj][e] = dp[i][jj][e] = 0.f;
#pragma unroll 2
    for (int ks2 = 0; ks2 < D / 32; ++ks2) {
      uint32_t ak[MT_A][2][4], av[MT_A][2][4];
#pragma unroll
      for (int mt = 0; mt < MT_A; ++mt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          ldsm_x4(ak[mt][u], sK + frag_a<D>((wm * MT_A + mt) * 16, 2 * ks2 + u, lane));
          ldsm_x4(av[mt][u], sV + frag_a<D>((wm * MT_A + mt) * 16, 2 * ks2 + u, lane));
        }
#pragma unroll
      for (int nt = 0; nt < NT_A; ++nt) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, qb + frag_b1<D>((wn * NT_A + nt) * 8, ks2, lane));
        ldsm_x4(bo, dob + frag_b1<D>((wn * NT_A + nt) * 8, ks2, lane));
#pragma unroll
        for (int mt = 0; mt < MT_A; ++mt) {
          mma16816(s[mt][nt], ak[mt][0], bq[0], bq[1]);
          mma16816(s[mt][nt], ak[mt][1], bq[2], bq[3]);
          mma16816(dp[mt][nt], av[mt][0], bo[0], bo[1]);
          mma16816(dp[mt][nt], av[mt][1], bo[2], bo[3]);
        }
      }
    }
    // p^T and ds^T, rounded once, to shared memory as [key][query]
#pragma unroll
    for (int mt = 0; mt < MT_A; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT_A; ++nt) {
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          pe[e] = expf(s[mt][nt][e] * scale - qm[nt][c]) * qil[nt][c];
          de[e] = (dp[mt][nt][e] - qdi[nt][c]) * pe[e] * scale;
        }
        const int row = (wm * MT_A + mt) * 16 + g, col = (wn * NT_A + nt) * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p_tile + row * PST + col) = pack_bf16(pe[0], pe[1]);
        *reinterpret_cast<uint32_t*>(p_tile + (row + 8) * PST + col) = pack_bf16(pe[2], pe[3]);
        *reinterpret_cast<uint32_t*>(ds_tile + row * PST + col) = pack_bf16(de[0], de[1]);
        *reinterpret_cast<uint32_t*>(ds_tile + (row + 8) * PST + col) = pack_bf16(de[2], de[3]);
      }
    __syncthreads();

    // phase B: dV[:, cols] += p^T . dO[:, cols]; dK[:, cols] += ds^T . Q[:, cols]
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[MT][4], ad[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4(ap[mt], sP + frag_a_pad(mt * 16, kk * 16, PST, lane));
        ldsm_x4(ad[mt], sDS + frag_a_pad(mt * 16, kk * 16, PST, lane));
      }
#pragma unroll
      for (int pp = 0; pp < CW / 16; ++pp) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dob + frag_bt<D>(kk * 16, warp * CW + pp * 16, lane));
        ldsm_x4_t(bq, qb + frag_bt<D>(kk * 16, warp * CW + pp * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(gv[mt][2 * pp], ap[mt], bo[0], bo[1]);
          mma16816(gv[mt][2 * pp + 1], ap[mt], bo[2], bo[3]);
          mma16816(gk[mt][2 * pp], ad[mt], bq[0], bq[1]);
          mma16816(gk[mt][2 * pp + 1], ad[mt], bq[2], bq[3]);
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
        const size_t at = head + (size_t)(k0 + mt * 16 + g) * d + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(gk[mt][nb][0], gk[mt][nb][1]);
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * (size_t)d) =
            __floats2bfloat162_rn(gk[mt][nb][2], gk[mt][nb][3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(gv[mt][nb][0], gv[mt][nb][1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * (size_t)d) =
            __floats2bfloat162_rn(gv[mt][nb][2], gv[mt][nb][3]);
      }
    }
}

template <int D>
int run_tc(const void* q, const void* k, const void* v, const void* l, const void* m,
           const void* dout, const void* di, void* dk, void* dv, int bh, int n, int d,
           float scale, cudaStream_t st) {
  using C = TcCfg<D>;
  return launch(flash_bwd_dkv_tc_kernel<D>, dim3(n / C::BK, bh), C::NW * 32, tc_smem<D>(), st,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)l,
                (const float*)m, (const bf16*)dout, (const float*)di, (bf16*)dk, (bf16*)dv, n,
                d, scale);
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

// q, k, v, dout, dk, dv: [bh, n, d] contiguous (bf16 != 0: bfloat16, else
// float32); l, m, di: [bh, n] float32. n a multiple of 128, 1 <= d <= 512.
// tc != 0 takes the tensor-core kernel: bfloat16, d a multiple of 16.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* l, const void* m, const void* dout,
                                const void* di, void* dk, void* dv, int bh, int n, int d,
                                float scale, int bf16_, int tc, void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || bh < 1 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (tc) {
    if (!bf16_ || d % 16 != 0) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dk |
         (uintptr_t)dv) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (d <= 64) return run_tc<64>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
    if (d <= 128) return run_tc<128>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
    if (d <= 256) return run_tc<256>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
    return run_tc<512>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
  }
  return bf16_ ? run_d<__nv_bfloat16>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st)
               : run_d<float>(q, k, v, l, m, dout, di, dk, dv, bh, n, d, scale, st);
}
