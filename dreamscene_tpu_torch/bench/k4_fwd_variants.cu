// Variants of the K4 forward kernel at d = 64, for timing on the card:
// which instruction family and tiling is fastest, and which part of the
// loop the time goes to. Two kernels: the same loop with ldmatrix +
// mma.sync products (fwd_kernel, tiling as template parameters) and with
// wgmma products (fwd_wgmma_kernel, the one csrc/flash_fwd.cu ships as
// flash_fwd_wgmma_kernel). Built and run by k4_fwd_variants.py; not part
// of the kernel library. Contiguous [bh, n, 64] bfloat16 heads only.
//
// MODE bits: 1 = ex2.approx instead of exp2f; 2 = no exp at all; 4 = no
// softmax at all (2 and 4 give wrong values: they show what the exp and
// the whole softmax cost). MT = 16-row tiles per warp in the mma.sync
// kernel: with MT = 2 every K / V fragment read from shared memory feeds
// two mma.sync.
#include "flash_common.cuh"
using namespace flash;
constexpr float LOG2E = 1.4426950408889634f;

template <int MODE> __device__ __forceinline__ float ex2(float x) {
  if (MODE & 1) return exp2_approx(x);
  if (MODE & 2) return x;
  return exp2f(x);
}

template <int D, int BQ, int BK, int MINB, int MODE, int MT>
__global__ void __launch_bounds__(BQ * 2 / MT, MINB) fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int n, float scale) {
  constexpr int NT = BQ * 2 / MT, KS = D / 16, NS = BK / 8, NO = D / 8;
  constexpr uint32_t TILE = BK * D * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(smem_raw), sK = sQ + BQ * D * 2, sV = sK + 2 * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * n * D;
  const bf16* kh = k + head; const bf16* vh = v + head;
  load_tile_async<D, BQ, NT>(sQ, q + head + (size_t)q0 * D, D, D, tid);
  load_tile_async<D, BK, NT>(sK, kh, D, D, tid);
  load_tile_async<D, BK, NT>(sV, vh, D, D, tid);
  cp_async_commit();
  uint32_t qf[MT][KS][4];
  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][i][j] = 0.f;
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) { m_run[mt][0] = m_run[mt][1] = -INFINITY; l_run[mt][0] = l_run[mt][1] = 0.f; }
  const float c = scale * LOG2E;
  const int nblk = n / BK;
  for (int j = 0; j < nblk; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * TILE;
      load_tile_async<D, BK, NT>(sK + st, kh + (size_t)(j + 1) * BK * D, D, D, tid);
      load_tile_async<D, BK, NT>(sV + st, vh + (size_t)(j + 1) * BK * D, D, D, tid);
      cp_async_commit();
    }
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[mt][ks], sQ + frag_a<D>((warp * MT + mt) * 16, ks, lane));
    }
    const uint32_t kb = sK + (j & 1) * TILE, vb = sV + (j & 1) * TILE;
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[mt][i][jj] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int p = 0; p < BK / 16; ++p) {
        uint32_t b[4];
        ldsm_x4(b, kb + frag_b2<D>(p * 16, ks, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][2 * p], qf[mt][ks], b[0], b[1]);
          mma16816(s[mt][2 * p + 1], qf[mt][ks], b[2], b[3]);
        }
      }
    }
    if (!(MODE & 4)) {
#pragma unroll
     for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
      mx[0] = quad_max(mx[0]); mx[1] = quad_max(mx[1]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m_run[mt][r], mx[r]);
        alpha[r] = ex2<MODE>((m_run[mt][r] - mn) * c);
        const float mc = mn * c;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const float p0 = ex2<MODE>(fmaf(s[mt][nt][2 * r], c, -mc));
          const float p1 = ex2<MODE>(fmaf(s[mt][nt][2 * r + 1], c, -mc));
          s[mt][nt][2 * r] = p0; s[mt][nt][2 * r + 1] = p1; sum += p0 + p1;
        }
        l_run[mt][r] = l_run[mt][r] * alpha[r] + sum;
        m_run[mt][r] = mn;
      }
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        acc[mt][no][0] *= alpha[0]; acc[mt][no][1] *= alpha[0]; acc[mt][no][2] *= alpha[1]; acc[mt][no][3] *= alpha[1];
      }
     }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int p = 0; p < D / 16; ++p) {
        uint32_t b[4];
        ldsm_x4_t(b, vb + frag_bt<D>(kk * 16, p * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma16816(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) { l_run[mt][r] = quad_sum(l_run[mt][r]); inv[r] = l_run[mt][r] == 0.f ? 1.f : 1.f / l_run[mt][r]; }
    const int row0 = q0 + (warp * MT + mt) * 16;
    bf16* orow = o + head + (size_t)row0 * D;
#pragma unroll
    for (int no = 0; no < NO; ++no) {
      const int col = no * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(orow + g * D + col) = __floats2bfloat162_rn(acc[mt][no][0] * inv[0], acc[mt][no][1] * inv[0]);
      *reinterpret_cast<__nv_bfloat162*>(orow + (g + 8) * D + col) = __floats2bfloat162_rn(acc[mt][no][2] * inv[1], acc[mt][no][3] * inv[1]);
    }
    if (t == 0) {
      const size_t at = (size_t)blockIdx.y * n + row0 + g;
      l_out[at] = l_run[mt][0]; m_out[at] = m_run[mt][0] * scale; l_out[at + 8] = l_run[mt][1]; m_out[at + 8] = m_run[mt][1] * scale;
    }
  }
}

template <int D, int BQ, int BK, int MINB, int MODE, int MT = 1>
int go(const void* q, const void* k, const void* v, void* o, void* l, void* m, int bh, int n, float scale, cudaStream_t st) {
  return launch(fwd_kernel<D, BQ, BK, MINB, MODE, MT>, dim3(n / BQ, bh), BQ * 2 / MT, (size_t)(BQ + 4 * BK) * D * 2, st,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)l, (float*)m, n, scale);
}


// the wgmma kernel (csrc/flash_fwd.cu, flash_fwd_wgmma_kernel) on contiguous heads
template <int MINB, int MODE>
__global__ void __launch_bounds__(256, MINB) fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out, int n, float scale) {
  constexpr int D = 64, BQ = 128, BK = 64, NT = 256, KS = D / 16, NS = BK / 8, NO = D / 8;
  constexpr uint32_t TILE = BK * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = sQ + BQ * D * 2, sV = sK + 2 * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * n * D;
  const bf16* kh = k + head; const bf16* vh = v + head;
  load_tile_async<D, BQ, NT>(sQ, q + head + (size_t)q0 * D, D, D, tid);
  load_tile_async<D, BK, NT>(sK, kh, D, D, tid);
  load_tile_async<D, BK, NT>(sV, vh, D, D, tid);
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
    __syncthreads();
    if (j + 1 < nblk) {
      const uint32_t st = ((j + 1) & 1) * TILE;
      load_tile_async<D, BK, NT>(sK + st, kh + (size_t)(j + 1) * BK * D, D, D, tid);
      load_tile_async<D, BK, NT>(sV + st, vh + (size_t)(j + 1) * BK * D, D, D, tid);
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
    if (!(MODE & 4)) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
      }
      mx[0] = quad_max(mx[0]); mx[1] = quad_max(mx[1]);
      float alpha[2];
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
          s[nt][2 * r] = p0; s[nt][2 * r + 1] = p1; sum += p0 + p1;
        }
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = mn;
      }
#pragma unroll
      for (int no = 0; no < NO; ++no) {
        acc[no][0] *= alpha[0]; acc[no][1] *= alpha[0]; acc[no][2] *= alpha[1]; acc[no][3] *= alpha[1];
      }
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
  for (int r = 0; r < 2; ++r) { l_run[r] = quad_sum(l_run[r]); inv[r] = l_run[r] == 0.f ? 1.f : 1.f / l_run[r]; }
  const int row0 = q0 + warp * 16, g = lane >> 2, t = lane & 3;
  bf16* orow = o + head + (size_t)row0 * D;
#pragma unroll
  for (int no = 0; no < NO; ++no) {
    const int col = no * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(orow + g * D + col) = __floats2bfloat162_rn(acc[no][0] * inv[0], acc[no][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(orow + (g + 8) * D + col) = __floats2bfloat162_rn(acc[no][2] * inv[1], acc[no][3] * inv[1]);
  }
  if (t == 0) {
    const size_t at = (size_t)blockIdx.y * n + row0 + g;
    l_out[at] = l_run[0]; m_out[at] = m_run[0] * scale; l_out[at + 8] = l_run[1]; m_out[at + 8] = m_run[1] * scale;
  }
}

template <int MINB, int MODE>
int go_wgmma(const void* q, const void* k, const void* v, void* o, void* l, void* m, int bh, int n, float scale, cudaStream_t st) {
  return launch(fwd_wgmma_kernel<MINB, MODE>, dim3(n / 128, bh), 256, (size_t)(128 + 4 * 64) * 64 * 2 + 1024, st,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)l, (float*)m, n, scale);
}


extern "C" int k4_fwd_variant(const void* q, const void* k, const void* v, void* o, void* l, void* m, int bh, int n,
                       float scale, int variant, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: return go<64, 128, 64, 2, 0>(q, k, v, o, l, m, bh, n, scale, st);      // exp2f
    case 1: return go<64, 128, 64, 2, 1>(q, k, v, o, l, m, bh, n, scale, st);      // ex2.approx
    case 2: return go<64, 128, 64, 2, 2>(q, k, v, o, l, m, bh, n, scale, st);      // no exp
    case 3: return go<64, 128, 64, 2, 4>(q, k, v, o, l, m, bh, n, scale, st);      // no softmax
    case 4: return go<64, 128, 64, 2, 1, 2>(q, k, v, o, l, m, bh, n, scale, st);   // 4 warps x 32 rows
    case 5: return go<64, 128, 64, 2, 4, 2>(q, k, v, o, l, m, bh, n, scale, st);   // same, no softmax
    case 6: return go<64, 128, 128, 1, 1>(q, k, v, o, l, m, bh, n, scale, st);     // 128 keys a block
    case 7: return go<64, 64, 64, 4, 1>(q, k, v, o, l, m, bh, n, scale, st);       // 64 query rows a CTA
    case 8: return go<64, 128, 32, 2, 1>(q, k, v, o, l, m, bh, n, scale, st);      // 32 keys a block
    case 9: return go_wgmma<2, 0>(q, k, v, o, l, m, bh, n, scale, st);             // wgmma, as shipped
    case 10: return go_wgmma<2, 4>(q, k, v, o, l, m, bh, n, scale, st);            // wgmma, no softmax
  }
  return 1;
}
