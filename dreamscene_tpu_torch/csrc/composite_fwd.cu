// Front-to-back alpha compositing of each tile's depth-sorted entries
// (kernel K1).
//
// Replaces: dreamscene_tpu/ops/composite.py, `_fwd_kernel` (host function
// `composite_forward`), a Pallas TPU kernel that walks all chunks in one
// sequential grid step and forms transmittance prefixes with triangular
// bf16 hi/lo split matmuls on the MXU.
//
// What it computes: for tile t, its chunks are the run of `chunk_tile == t`
// (sorted); chunk u holds entries at record columns s0[u] + [lo[u], hi[u]).
// Each pixel composites them in order (see composite_common.cuh for the
// chunk-local stop rule) and writes [rgb, depth, T, live-chunk count, 0, 0]
// into out[t, :, pixel]. Row n_tiles (trash) and tiles without entries get
// the background state (zeros, T = 1). It also writes each live chunk's row
// of the carry table (composite_common.cuh): the accumulators and T its
// pixels have when the chunk starts, from which K2 walks every chunk on its
// own.
//
// Bound on this card: operations on the entry-pixel pairs. Every pixel of a
// tile evaluates every entry of the tile (an exp and ~20 FLOPs each), while
// the bytes are the record table (40 B per entry, read once per tile) and
// the 8 x 4 B accumulator per pixel. Design: one CTA per tile, one thread
// per pixel, records staged through shared memory in batches and read as
// broadcasts; no atomics, no cross-CTA state.

#include "composite_common.cuh"

namespace {

constexpr int BATCH = 256;

__global__ void composite_fwd_kernel(
    const float* __restrict__ rec, int cap_pad,
    const int* __restrict__ chunk_tile, const int* __restrict__ s0,
    const int* __restrict__ lo, const int* __restrict__ hi, int n_chunks,
    float* __restrict__ out, float* __restrict__ carry, int n_tiles, int tiles_x,
    int tile_w, int tile_h) {
  __shared__ float srec[ds::N_LIVE][BATCH];
  __shared__ int range[2];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tile_pix = blockDim.x;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float T = 1.0f;
  float live = 0.0f;

  if (t < n_tiles) {
    if (p == 0) {
      range[0] = ds::lower_bound_i32(chunk_tile, n_chunks, t);
      range[1] = ds::lower_bound_i32(chunk_tile, n_chunks, t + 1);
    }
    __syncthreads();
    const float px = (float)((t % tiles_x) * tile_w + p % tile_w);
    const float py = (float)((t / tiles_x) * tile_h + p / tile_w);
    for (int u = range[0]; u < range[1]; ++u) {
      const int l = lo[u], h = hi[u];
      if (h <= l) continue;               // uniform across the CTA
      live += 1.0f;
      float* c = carry + (size_t)u * ds::CARRY_ROWS * tile_pix + p;
      c[0 * tile_pix] = acc[0];
      c[1 * tile_pix] = acc[1];
      c[2 * tile_pix] = acc[2];
      c[3 * tile_pix] = acc[3];
      c[4 * tile_pix] = T;
      const int base = s0[u];
      bool stopped = false;               // the stop rule is chunk-local
      for (int j0 = l; j0 < h; j0 += BATCH) {
        const int nb = min(BATCH, h - j0);
        __syncthreads();
        for (int i = p; i < nb * ds::N_LIVE; i += tile_pix) {
          const int f = i / nb, k = i - f * nb;
          srec[f][k] = rec[(size_t)f * cap_pad + base + j0 + k];
        }
        __syncthreads();
        if (stopped) continue;
        for (int k = 0; k < nb; ++k) {
          ds::Rec e{srec[0][k], srec[1][k], srec[2][k], srec[3][k], srec[4][k],
                    srec[5][k], srec[6][k], srec[7][k], srec[8][k], srec[9][k]};
          float power, raw, ex;
          const float alpha = ds::entry_alpha(e, px, py, &power, &raw, &ex);
          const float t_next = T * (1.0f - alpha);
          if (t_next < ds::T_EPS) { stopped = true; break; }
          const float w = T * alpha;
          acc[0] += w * e.r;
          acc[1] += w * e.g;
          acc[2] += w * e.b;
          acc[3] += w * e.depth;
          T = t_next;
        }
      }
    }
  }
  float* o = out + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  o[0 * tile_pix] = acc[0];
  o[1 * tile_pix] = acc[1];
  o[2 * tile_pix] = acc[2];
  o[3 * tile_pix] = acc[3];
  o[4 * tile_pix] = T;
  o[5 * tile_pix] = live;
  o[6 * tile_pix] = 0.0f;
  o[7 * tile_pix] = 0.0f;
}

}  // namespace

extern "C" int ds_composite_fwd(
    const void* rec, int cap_pad, const void* chunk_tile, const void* s0,
    const void* lo, const void* hi, int n_chunks, void* out, void* carry,
    int n_tiles, int tiles_x, int tile_w, int tile_h, void* stream) {
  const int tile_pix = tile_w * tile_h;
  if (tile_pix % 32 != 0 || tile_pix > 1024) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<n_tiles + 1, tile_pix, 0, (cudaStream_t)stream>>>(
      (const float*)rec, cap_pad, (const int*)chunk_tile, (const int*)s0,
      (const int*)lo, (const int*)hi, n_chunks, (float*)out, (float*)carry, n_tiles,
      tiles_x, tile_w, tile_h);
  return (int)cudaGetLastError();
}
