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
// (float32 accumulation); o = (sum of P.V, rescaled as m moves) / l,
// rounded to the operand type. Also writes the final l and m (float32
// [b*h, n]) for the backward kernels. q, k, v and o are [b, h, n, d] with
// batch, head and row strides of their own (d stride 1), so transposed
// views of [b, n, h*d] projections need no copy.
//
// What bounds it: operations (4*b*h*n^2*d FLOPs against a few MB), so the
// design is about feeding the tensor cores. Three kernels, chosen by
// operand type and head-dim bucket D (the choice is made by
// ops/flash_attention.py):
//
//  * bfloat16, D = 64 (flash_fwd_wgmma_kernel; the UNet's self-attention):
//    one CTA per 128 query rows = two warpgroups of 64 rows. K and V
//    blocks of 64 keys arrive by cp.async in two stages, so block j + 1 is
//    in flight during block j's products. S = Q.K^T is four
//    wgmma.m64n64k16: Q fragments live in registers for the whole kernel
//    (the A operand), the K tile [keys][d] is the K-major B operand read
//    straight from shared memory, so no K or V fragment passes through
//    registers and one tile read serves 64 rows. The softmax runs on the
//    accumulator fragment (a row lives in the 4 threads of a quad: two
//    shuffles for the max); P is rounded to bfloat16 in registers and is
//    the A operand of P.V directly, V [keys][d] being the MN-major B
//    operand (transpose flag). The accumulator is rescaled by
//    exp(m_prev - m_next) per block and divided by l once at the end. exp
//    is one ex2.approx on an argument pre-scaled by log2(e) with one fused
//    multiply-add: once the products no longer take the warps'
//    instruction slots, the softmax arithmetic is what they wait on. Two CTAs per SM (4 warpgroups)
//    keep the tensor cores busy while other warpgroups are in their
//    softmax.
//  * bfloat16, D = 128, 256 or 512 (flash_fwd_tc_split_kernel; the VAE's
//    d = 512): a 64 x 512 float32 accumulator is 128 KB, every register
//    of 128 threads, so the output's columns are split over the warps: 8
//    warps = 4 groups of 16 query rows x 2 column halves (128 accumulator
//    registers a thread at D = 512). Per block of 32 keys each warp of a
//    pair computes S for 16 of the keys over the full d (ldmatrix +
//    mma.sync.m16n8k16), the pair exchanges row maxima through shared
//    memory, both write their half of P (bfloat16) to shared memory, and
//    each does O_half += P . V[:, its columns]. Row sums stay per warp and
//    are added once at the end. Q (64 KB at D = 512) is resident, K/V
//    tiles of 32 keys in two stages (128 KB).
//  * float32, or bfloat16 with d no multiple of 16 (flash_fwd_kernel):
//    scalar FMAs on the CUDA cores over float32 tiles (flash_common.cuh);
//    rescales per block as the JAX kernel does:
//    acc = acc * (l_corr / l_next) + (P.V) / l_next.

#include "flash_common.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------------
// float32 operands: CUDA cores
// ---------------------------------------------------------------------

template <int D> struct Cfg;
template <> struct Cfg<64> { static constexpr int NT = 128, BQ = 64, BK = 64; };
template <> struct Cfg<128> { static constexpr int NT = 128, BQ = 32, BK = 64; };
template <> struct Cfg<256> { static constexpr int NT = 256, BQ = 32, BK = 32; };
template <> struct Cfg<512> { static constexpr int NT = 256, BQ = 16, BK = 32; };

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int h, int n,
    int d, Strides sq_, Strides sk_, Strides sv_, Strides so_, float scale) {
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
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const T* kh = k + bi * sk_.b + hi * sk_.h;
  const T* vh = v + bi * sv_.b + hi * sv_.h;

  load_tile<T, D, NT>(sq, q + bi * sq_.b + hi * sq_.h + q0 * sq_.n, BQ, d, (size_t)sq_.n,
                      tid);
  float acc[SI][OJ];
  zero(acc);
  float m_prev = -INFINITY, l_prev = 0.f;
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();
    load_tile<T, D, NT>(sk, kh + k0 * sk_.n, BK, d, (size_t)sk_.n, tid);
    load_tile<T, D, NT>(sv, vh + k0 * sv_.n, BK, d, (size_t)sv_.n, tid);
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
  store_rows<T, SI, OJ, TY>(o + bi * so_.b + hi * so_.h + q0 * so_.n, acc, d, (size_t)so_.n,
                            ty, tx);
  if (g == 0) {
    l_out[(size_t)blockIdx.y * n + q0 + row] = l_prev;
    m_out[(size_t)blockIdx.y * n + q0 + row] = m_prev;
  }
}

// ---------------------------------------------------------------------
// bfloat16 operands: tensor cores
// ---------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// One block's softmax on a score fragment of NS n-tiles (rows g and g + 8
// of the warp's 16): s (raw q.k) becomes p = exp(scale*s - m_next); the
// running maxima (raw units) and this thread's partial row sums are
// updated. Returns the accumulator's rescale factors in alpha. mx holds
// the block's row maxima, already reduced over everything that shares the
// row.
template <int NS>
__device__ __forceinline__ void softmax_block(float (&s)[NS][4], const float (&mx)[2],
                                              float (&m_run)[2], float (&l_run)[2],
                                              float (&alpha)[2], float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m_run[r], mx[r]);
    alpha[r] = exp2_approx((m_run[r] - mn) * c);
    const float mc = mn * c;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const float p0 = exp2_approx(fmaf(s[nt][2 * r], c, -mc));
      const float p1 = exp2_approx(fmaf(s[nt][2 * r + 1], c, -mc));
      s[nt][2 * r] = p0;
      s[nt][2 * r + 1] = p1;
      sum += p0 + p1;
    }
    l_run[r] = l_run[r] * alpha[r] + sum;
    m_run[r] = mn;
  }
}

template <int NS>
__device__ __forceinline__ void frag_row_max(const float (&s)[NS][4], float (&mx)[2]) {
  mx[0] = -INFINITY;
  mx[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// rows g and g + 8 of a warp's 16 x (NO*8) accumulator -> o (bfloat16),
// scaled by inv[0] / inv[1], columns col0 + .. < d only
template <int NO>
__device__ __forceinline__ void store_frag(bf16* orow, long long ld, const float (&acc)[NO][4],
                                           const float (&inv)[2], int col0, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int no = 0; no < NO; ++no) {
    const int col = col0 + no * 8 + 2 * t;
    if (col < d) {
      *reinterpret_cast<__nv_bfloat162*>(orow + g * ld + col) =
          __floats2bfloat162_rn(acc[no][0] * inv[0], acc[no][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(orow + (g + 8) * ld + col) =
          __floats2bfloat162_rn(acc[no][2] * inv[1], acc[no][3] * inv[1]);
    }
  }
}

constexpr int WG_BQ = 128, WG_BK = 64;    // D = 64: two warpgroups of 64 rows
constexpr int SP_BQ = 64, SP_BK = 32;     // D = 128, 256, 512
// + 1024: the tiles are aligned to the 128-byte swizzle's 1024-byte period
constexpr size_t WG_SMEM = (size_t)(WG_BQ + 4 * WG_BK) * 64 * 2 + 1024;

__global__ void __launch_bounds__(WG_BQ * 2, 2) flash_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int h, int n,
    int d, Strides sq_, Strides sk_, Strides sv_, Strides so_, float scale) {
  constexpr int D = 64, BQ = WG_BQ, BK = WG_BK, NT = BQ * 2;
  constexpr int KS = D / 16, NS = BK / 8, NO = D / 8;
  constexpr uint32_t TILE = BK * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;   // [BQ][D]
  const uint32_t sK = sQ + BQ * D * 2;                         // 2 x [BK][D]
  const uint32_t sV = sK + 2 * TILE;                           // 2 x [BK][D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const bf16* kh = k + bi * sk_.b + hi * sk_.h;
  const bf16* vh = v + bi * sv_.b + hi * sv_.h;

  load_tile_async<D, BQ, NT>(sQ, q + bi * sq_.b + hi * sq_.h + q0 * sq_.n, sq_.n, d, tid);
  load_tile_async<D, BK, NT>(sK, kh, sk_.n, d, tid);
  load_tile_async<D, BK, NT>(sV, vh, sv_.n, d, tid);
  cp_async_commit();

  uint32_t qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
  const int nblk = n / BK;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();   // block j has landed; everyone is done with block j - 1
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * TILE;
      load_tile_async<D, BK, NT>(sK + st, kh + (j + 1) * BK * sk_.n, sk_.n, d, tid);
      load_tile_async<D, BK, NT>(sV + st, vh + (j + 1) * BK * sv_.n, sv_.n, d, tid);
      cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], sQ + frag_a<D>(warp * 16, ks, lane));
    }
    const uint64_t kd = wgmma_desc(sK + (j & 1) * TILE), vd = wgmma_desc(sV + (j & 1) * TILE);
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) wgmma_64x64x16<0>(s, qf[ks], kd + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
    float mx[2], alpha[2];
    frag_row_max<NS>(s, mx);
    softmax_block<NS>(s, mx, m_run, l_run, alpha, c);
#pragma unroll
    for (int no = 0; no < NO; ++no) {
      acc[no][0] *= alpha[0];
      acc[no][1] *= alpha[0];
      acc[no][2] *= alpha[1];
      acc[no][3] *= alpha[1];
    }
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_64x64x16<1>(acc, a[kk], vd + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = quad_sum(l_run[r]);
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
  }
  const int row0 = q0 + warp * 16;
  store_frag<NO>(o + bi * so_.b + hi * so_.h + row0 * so_.n, so_.n, acc, inv, 0, d, lane);
  if ((lane & 3) == 0) {
    const size_t at = (size_t)blockIdx.y * n + row0 + (lane >> 2);
    l_out[at] = l_run[0];
    m_out[at] = m_run[0] * scale;
    l_out[at + 8] = l_run[1];
    m_out[at + 8] = m_run[1] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1) flash_fwd_tc_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int h, int n,
    int d, Strides sq_, Strides sk_, Strides sv_, Strides so_, float scale) {
  constexpr int BQ = SP_BQ, BK = SP_BK, NT = 256;
  constexpr int KS = D / 16, HC = D / 2, NO = HC / 8, PST = BK + 8;
  constexpr uint32_t TILE = BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw);   // [BQ][D]
  const uint32_t sK = sQ + BQ * D * 2;      // 2 x [BK][D]
  const uint32_t sV = sK + 2 * TILE;        // 2 x [BK][D]
  const uint32_t sP = sV + 2 * TILE;        // [BQ][PST] p (bfloat16)
  bf16* p_tile = reinterpret_cast<bf16*>(smem_raw + (size_t)BQ * D * 2 + 4 * (size_t)TILE);
  float* smax = reinterpret_cast<float*>(p_tile + BQ * PST);   // [2][BQ]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp >> 1, ch = warp & 1;   // row group, column / key half
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * BQ;
  const bf16* kh = k + bi * sk_.b + hi * sk_.h;
  const bf16* vh = v + bi * sv_.b + hi * sv_.h;

  load_tile_async<D, BQ, NT>(sQ, q + bi * sq_.b + hi * sq_.h + q0 * sq_.n, sq_.n, d, tid);
  load_tile_async<D, BK, NT>(sK, kh, sk_.n, d, tid);
  load_tile_async<D, BK, NT>(sV, vh, sv_.n, d, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float c = scale * LOG2E;
  const int r0 = rg * 16 + g;   // this thread's rows of the CTA's 64: r0, r0 + 8
  const int nblk = n / BK;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait<0>();
    __syncthreads();   // block j has landed; everyone is done with block j - 1
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * TILE;
      load_tile_async<D, BK, NT>(sK + st, kh + (j + 1) * BK * sk_.n, sk_.n, d, tid);
      load_tile_async<D, BK, NT>(sV + st, vh + (j + 1) * BK * sv_.n, sv_.n, d, tid);
      cp_async_commit();
    }
    const uint32_t kb = sK + (j & 1) * TILE, vb = sV + (j & 1) * TILE;
    // S for this warp's 16 rows x 16 keys (key half ch) over the full d
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4(a, sQ + frag_a<D>(rg * 16, ks, lane));
      ldsm_x4(b, kb + frag_b2<D>(ch * 16, ks, lane));
      mma16816(s[0], a, b[0], b[1]);
      mma16816(s[1], a, b[2], b[3]);
    }
    float mx[2], alpha[2];
    frag_row_max<2>(s, mx);
    if (t == 0) {
      smax[ch * BQ + r0] = mx[0];
      smax[ch * BQ + r0 + 8] = mx[1];
    }
    __syncthreads();
    mx[0] = fmaxf(smax[r0], smax[BQ + r0]);
    mx[1] = fmaxf(smax[r0 + 8], smax[BQ + r0 + 8]);
    softmax_block<2>(s, mx, m_run, l_run, alpha, c);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = ch * 16 + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(p_tile + r0 * PST + col) = pack_bf16(s[nt][0], s[nt][1]);
      *reinterpret_cast<uint32_t*>(p_tile + (r0 + 8) * PST + col) =
          pack_bf16(s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int no = 0; no < NO; ++no) {
      acc[no][0] *= alpha[0];
      acc[no][1] *= alpha[0];
      acc[no][2] *= alpha[1];
      acc[no][3] *= alpha[1];
    }
    __syncthreads();
    // O[:, this warp's HC columns] += P (16 x 32) . V (32 x HC)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sP + frag_a_pad(rg * 16, kk * 16, PST, lane));
#pragma unroll
      for (int p = 0; p < HC / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, vb + frag_bt<D>(kk * 16, ch * HC + p * 16, lane));
        mma16816(acc[2 * p], a, b[0], b[1]);
        mma16816(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  // row sums: quad, then the pair of warps through shared memory
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = quad_sum(l_run[r]);
  if (t == 0) {
    smax[ch * BQ + r0] = l_run[0];
    smax[ch * BQ + r0 + 8] = l_run[1];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] = smax[r0 + 8 * r] + smax[BQ + r0 + 8 * r];
    inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r];
  }
  const int row0 = q0 + rg * 16;
  store_frag<NO>(o + bi * so_.b + hi * so_.h + row0 * so_.n, so_.n, acc, inv, ch * HC, d, lane);
  if (ch == 0 && t == 0) {
    const size_t at = (size_t)blockIdx.y * n + row0 + g;
    l_out[at] = l_run[0];
    m_out[at] = m_run[0] * scale;
    l_out[at + 8] = l_run[1];
    m_out[at + 8] = m_run[1] * scale;
  }
}

template <int D> constexpr size_t split_smem() {
  return (size_t)(SP_BQ + 4 * SP_BK) * D * 2 + (size_t)SP_BQ * (SP_BK + 8) * 2 +
         2 * SP_BQ * sizeof(float);
}

struct Args {
  const void *q, *k, *v;
  void *o, *l, *m;
  int b, h, n, d;
  Strides sq, sk, sv, so;
  float scale;
  cudaStream_t st;
};

template <typename T, int D> int run(const Args& a) {
  using C = Cfg<D>;
  const size_t smem =
      sizeof(float) * ((size_t)(C::BQ + 2 * C::BK) * (D + 1) + C::BQ * (C::BK + 1) + 2 * C::BQ);
  return launch(flash_fwd_kernel<T, D>, dim3(a.n / C::BQ, a.b * a.h), C::NT, smem, a.st,
                (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, (float*)a.l,
                (float*)a.m, a.h, a.n, a.d, a.sq, a.sk, a.sv, a.so, a.scale);
}

template <typename T> int run_d(const Args& a) {
  if (a.d <= 64) return run<T, 64>(a);
  if (a.d <= 128) return run<T, 128>(a);
  if (a.d <= 256) return run<T, 256>(a);
  return run<T, 512>(a);
}

int run_wgmma(const Args& a) {
  return launch(flash_fwd_wgmma_kernel, dim3(a.n / WG_BQ, a.b * a.h), WG_BQ * 2, WG_SMEM, a.st,
                (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.o, (float*)a.l,
                (float*)a.m, a.h, a.n, a.d, a.sq, a.sk, a.sv, a.so, a.scale);
}

template <int D> int run_split(const Args& a) {
  return launch(flash_fwd_tc_split_kernel<D>, dim3(a.n / SP_BQ, a.b * a.h), 256,
                split_smem<D>(), a.st, (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
                (bf16*)a.o, (float*)a.l, (float*)a.m, a.h, a.n, a.d, a.sq, a.sk, a.sv, a.so,
                a.scale);
}

bool aligned(const void* p, const Strides& s) {
  return (uintptr_t)p % 16 == 0 && s.b % 8 == 0 && s.h % 8 == 0 && s.n % 8 == 0;
}

}  // namespace

// q, k, v, o: [b, h, n, d] with element strides *_s = {batch, head, row}
// and d stride 1 (bf16 != 0: bfloat16, else float32); l, m: [b*h, n]
// float32. n a multiple of 128, 1 <= d <= 512. tc != 0 takes the
// tensor-core kernels: bfloat16, d a multiple of 16, 16-byte aligned rows.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, void* o, void* l,
                            void* m, int b, int h, int n, int d, const long long* q_s,
                            const long long* k_s, const long long* v_s, const long long* o_s,
                            float scale, int bf16_, int tc, void* stream) {
  if (n % 128 != 0 || d < 1 || d > 512 || b < 1 || h < 1 || (long long)b * h > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, l, m, b, h, n, d,
         {q_s[0], q_s[1], q_s[2]}, {k_s[0], k_s[1], k_s[2]}, {v_s[0], v_s[1], v_s[2]},
         {o_s[0], o_s[1], o_s[2]}, scale, (cudaStream_t)stream};
  if (tc) {
    if (!bf16_ || d % 16 != 0 || !aligned(q, a.sq) || !aligned(k, a.sk) || !aligned(v, a.sv) ||
        !aligned(o, a.so))
      return (int)cudaErrorInvalidValue;
    if (d <= 64) return run_wgmma(a);
    if (d <= 128) return run_split<128>(a);
    if (d <= 256) return run_split<256>(a);
    return run_split<512>(a);
  }
  return bf16_ ? run_d<__nv_bfloat16>(a) : run_d<float>(a);
}
