// The one-CTA-per-tile K2 that csrc/composite_bwd.cu replaced, kept for
// bench/k2_variants.py: it times the old design beside the new one on the
// same scene and shows what set the old launch's time. Two additions: every
// tile CTA writes its start and end on the card's nanosecond timer, and
// tiles with more than `skip_chunks` chunks return at once (their columns
// stay unwritten: values are wrong on purpose, the time says what the
// busiest tiles cost).

#include "composite_common.cuh"

namespace {

constexpr int BATCH = 32;
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void composite_bwd_kernel(
    const float* __restrict__ rec, int cap_pad,
    const int* __restrict__ chunk_tile, const int* __restrict__ s0,
    const int* __restrict__ lo, const int* __restrict__ hi, int n_chunks,
    const int* __restrict__ n_used_ptr, const float* __restrict__ final_acc,
    const float* __restrict__ g_out, float* __restrict__ grec,
    int n_tiles, int tiles_x, int tile_w, int tile_h, int chunk,
    unsigned long long* __restrict__ cta_ns, int skip_chunks) {
  const size_t ncols = (size_t)n_chunks * chunk;

  if ((int)blockIdx.x >= n_tiles) {
    // zero every column from chunk n_chunks_used on, all 16 rows
    const size_t start = (size_t)(*n_used_ptr) * chunk;
    const size_t width = ncols - start;
    const size_t total = width * ds::REC_WIDTH;
    const size_t stride = (size_t)(gridDim.x - n_tiles) * blockDim.x;
    for (size_t i = (blockIdx.x - n_tiles) * (size_t)blockDim.x + threadIdx.x;
         i < total; i += stride) {
      const size_t row = i / width, col = start + i % width;
      grec[row * ncols + col] = 0.0f;
    }
    return;
  }

  unsigned long long t_start;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_start));
  __shared__ float srec[ds::N_LIVE][BATCH];
  __shared__ float red[MAX_WARPS][BATCH][ds::N_LIVE];
  __shared__ int range[2];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tile_pix = blockDim.x;
  const int warp = p >> 5, lane = p & 31, n_warps = tile_pix >> 5;

  if (p == 0) {
    range[0] = ds::lower_bound_i32(chunk_tile, n_chunks, t);
    range[1] = ds::lower_bound_i32(chunk_tile, n_chunks, t + 1);
  }
  const float* gp = g_out + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  const float* fp = final_acc + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  const float g0 = gp[0], g1 = gp[tile_pix], g2 = gp[2 * tile_pix], g3 = gp[3 * tile_pix];
  const float g_t = gp[4 * tile_pix];
  const float ccar = (fp[0] * g0 + fp[tile_pix] * g1 + fp[2 * tile_pix] * g2
                      + fp[3 * tile_pix] * g3) + g_t * fp[4 * tile_pix];
  const float px = (float)((t % tiles_x) * tile_w + p % tile_w);
  const float py = (float)((t / tiles_x) * tile_h + p / tile_w);
  __syncthreads();
  if (range[1] - range[0] > skip_chunks) return;

  float T = 1.0f;
  float run = 0.0f;    // running inclusive prefix of w * (c . g)
  for (int u = range[0]; u < range[1]; ++u) {
    const int l = lo[u], h = hi[u];
    const size_t colbase = (size_t)u * chunk;
    for (int i = p; i < chunk * ds::REC_WIDTH; i += tile_pix) {
      const int row = i / chunk, k = i - row * chunk;
      if (row >= ds::N_LIVE || k < l || k >= h) grec[row * ncols + colbase + k] = 0.0f;
    }
    if (h <= l) continue;                 // uniform across the CTA
    const int base = s0[u];
    bool stopped = false;                 // the stop rule is chunk-local
    for (int j0 = l; j0 < h; j0 += BATCH) {
      const int nb = min(BATCH, h - j0);
      __syncthreads();
      for (int i = p; i < nb * ds::N_LIVE; i += tile_pix) {
        const int f = i / nb, k = i - f * nb;
        srec[f][k] = rec[(size_t)f * cap_pad + base + j0 + k];
      }
      __syncthreads();
      for (int k = 0; k < nb; ++k) {
        float v[ds::N_LIVE];
#pragma unroll
        for (int f = 0; f < ds::N_LIVE; ++f) v[f] = 0.0f;
        bool hit = false;
        if (!stopped) {
          ds::Rec e{srec[0][k], srec[1][k], srec[2][k], srec[3][k], srec[4][k],
                    srec[5][k], srec[6][k], srec[7][k], srec[8][k], srec[9][k]};
          float power, raw, ex;
          const float alpha = ds::entry_alpha(e, px, py, &power, &raw, &ex);
          const float t_next = T * (1.0f - alpha);
          if (t_next < ds::T_EPS) {
            stopped = true;
          } else {
            const float w = T * alpha;
            const float cg = g0 * e.r + g1 * e.g + g2 * e.b + g3 * e.depth;
            run += w * cg;
            if (alpha > 0.0f) {
              const float suffix = ccar - run;
              const float galpha = T * cg - suffix / (1.0f - alpha);
              const bool unclamped = raw < ds::ALPHA_MAX;
              const float gpower = unclamped ? galpha * raw : 0.0f;
              const float dx = e.mx - px, dy = e.my - py;
              v[0] = -gpower * (e.ca * dx + e.cb * dy);
              v[1] = -gpower * (e.cc * dy + e.cb * dx);
              v[2] = -0.5f * gpower * dx * dx;
              v[3] = -gpower * dx * dy;
              v[4] = -0.5f * gpower * dy * dy;
              v[5] = unclamped ? galpha * ex : 0.0f;
              v[6] = w * g0;
              v[7] = w * g1;
              v[8] = w * g2;
              v[9] = w * g3;
              hit = true;
            }
            T = t_next;
          }
        }
        if (__any_sync(FULL, hit)) {
#pragma unroll
          for (int f = 0; f < ds::N_LIVE; ++f) {
            float s = v[f];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
            v[f] = s;
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < ds::N_LIVE; ++f) red[warp][k][f] = v[f];
        }
      }
      __syncthreads();
      for (int i = p; i < nb * ds::N_LIVE; i += tile_pix) {
        const int f = i / nb, k = i - f * nb;
        float s = 0.0f;
        for (int w = 0; w < n_warps; ++w) s += red[w][k][f];
        grec[(size_t)f * ncols + colbase + j0 + k] = s;
      }
    }
  }
  __syncthreads();
  if (p == 0) {
    unsigned long long t_end;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_end));
    cta_ns[2 * t] = t_start;
    cta_ns[2 * t + 1] = t_end;
  }
}

}  // namespace

extern "C" int k2_per_tile(
    const void* rec, int cap_pad, const void* chunk_tile, const void* s0,
    const void* lo, const void* hi, int n_chunks, const void* n_used,
    const void* final_acc, const void* g_out, void* grec,
    int n_tiles, int tiles_x, int tile_w, int tile_h, int chunk, void* cta_ns,
    int skip_chunks, void* stream) {
  const int tile_pix = tile_w * tile_h;
  if (tile_pix % 32 != 0 || tile_pix > 32 * MAX_WARPS) return (int)cudaErrorInvalidValue;
  const int zero_blocks = 64;
  composite_bwd_kernel<<<n_tiles + zero_blocks, tile_pix, 0, (cudaStream_t)stream>>>(
      (const float*)rec, cap_pad, (const int*)chunk_tile, (const int*)s0,
      (const int*)lo, (const int*)hi, n_chunks, (const int*)n_used,
      (const float*)final_acc, (const float*)g_out, (float*)grec, n_tiles,
      tiles_x, tile_w, tile_h, chunk, (unsigned long long*)cta_ns, skip_chunks);
  return (int)cudaGetLastError();
}
