// Per-entry gradients of the compositing (kernel K2).
//
// Replaces: dreamscene_tpu/ops/composite.py, `_bwd_kernel` (host function
// `composite_backward`), a Pallas TPU kernel that replays each tile's chunks
// and reduces pixel gradients to per-entry ones through bf16 split matmuls
// against pixel-moment rows.
//
// What it computes: for every live entry, the gradient of the loss with
// respect to its 10 record fields (mean xy, conic abc, opacity, rgb,
// depth), from the output cotangents g_out and the forward's final state.
// Each pixel replays T front to back (same decisions as K1) and uses the
// closed form dL/dalpha = T c.g - S / (1 - alpha), where the suffix
// S = (c_final.g + g_T T_final) - prefix(w c.g). The grad table has the
// layout of the JAX kernel: [16, n_chunks * chunk], chunk u at columns
// u * chunk + lane, lanes outside the chunk's live window and rows 10-15
// zero, and every chunk from n_chunks_used on zero (the VJP redirects
// masked entries to chunk n_chunks_used).
//
// Bound on this card: operations. Per entry-pixel pair it does the forward
// math plus ~30 FLOPs, and every entry needs a sum of 10 values over the
// tile's pixels. What a launch really waits for is its longest serial
// chain: a pixel's T and prefix run through its tile's entries in order,
// and the object fills a few tiles with thousands of entries while most
// tiles hold none.
//
// Design: one CTA per CHUNK, not per tile, one thread per pixel. K1 leaves
// every live chunk's starting state in the carry table
// (composite_common.cuh): T as K1 had it, bit for bit, so the stop decisions
// replay exactly, and the accumulated rgb/depth, from which the prefix at
// the chunk's start is g . accumulated (the prefix is linear in g_out). A
// tile's chunks then run side by side and the longest chain is one chunk
// (<= `chunk` entries) instead of the busiest tile. Inside the CTA:
//  * the chunk's records are staged in shared memory once, entry-major as
//    three float4, so an entry costs two broadcast loads before it is known
//    to matter;
//  * most entries miss most warps (a warp is 32 neighbouring pixels): when
//    every pixel of a warp has stopped or has an exponent that makes alpha
//    exactly 0 (power > 0, or below FAR_POWER, where opa * exp(power) is
//    under 1/255 for any opacity below 1e8), the warp skips the entry before
//    the exp: alpha == 0 changes neither T nor the prefix;
//  * an entry's 10 sums over a warp's pixels fold in 12 shuffles instead of
//    50: each step halves the number of values while it halves the lanes
//    that carry them (`fold`), and ten lanes end with one field each;
//  * a warp whose pixels have all stopped leaves the chunk; when every warp
//    has, the rest of the chunk's columns are zero-filled;
//  * per batch of 32 entries each warp leaves its partial sums and a mask
//    of the entries it hit in shared memory (two buffers, one barrier per
//    batch); the sums over warps run in warp order over the masked
//    partials.
// No float atomics: every entry belongs to one chunk and every sum has a
// fixed order, so the table is bit-reproducible run to run. Chunks that are
// empty or past n_chunks_used zero their own columns, so the launch needs
// no separate zeroing blocks.

#include "composite_common.cuh"

namespace {

constexpr int BATCH = 32;
constexpr int REC_F4 = 3;                 // float4 per staged record
constexpr float FAR_POWER = -24.0f;       // exp(-24) = 3.8e-11
constexpr unsigned FULL = 0xffffffffu;

// One step of the warp sum of N values per lane: N -> ceil(N / 2) values.
// Lanes with bit OFF set keep the upper half of the values and send the
// lower, the others the reverse, so after the step value i of a lane is the
// sum over the lane pair of value i (lower lanes) or i + H (upper lanes).
template <int N, int OFF>
__device__ __forceinline__ void fold(float (&v)[ds::N_LIVE], int lane) {
  constexpr int H = (N + 1) / 2;
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i], hi = (i + H < N) ? v[i + H] : 0.0f;
    const float keep = up ? hi : lo, send = up ? lo : hi;
    v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// The field whose warp sum ends in v[0] of this lane after the folds
// 10 -> 5 -> 3 -> 2 -> 1 over lane bits 4, 3, 2, 1 and a last exchange over
// bit 0; -1 for lanes that end with no field (or a copy).
__device__ __forceinline__ int field_of_lane(int lane) {
  const int d = (lane >> 1) & 1;
  const int c = d + 2 * ((lane >> 2) & 1);
  const int b = c + 3 * ((lane >> 3) & 1);
  const int f = b + 5 * ((lane >> 4) & 1);
  return ((lane & 1) == 0 && c < 3 && b < 5) ? f : -1;
}

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float* __restrict__ rec, int cap_pad,
    const int* __restrict__ chunk_tile, const int* __restrict__ s0,
    const int* __restrict__ lo, const int* __restrict__ hi, int n_chunks,
    const int* __restrict__ n_used_ptr, const float* __restrict__ carry,
    const float* __restrict__ final_acc, const float* __restrict__ g_out,
    float* __restrict__ grec, int tiles_x, int tile_w, int tile_h, int chunk) {
  extern __shared__ float4 smem4[];
  const int tile_pix = blockDim.x, p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31, n_warps = tile_pix >> 5;
  float4* srec = smem4;                                            // [chunk][REC_F4]
  float* red = reinterpret_cast<float*>(srec + chunk * REC_F4);    // [2][n_warps][N_LIVE][BATCH]
  unsigned* wmask = reinterpret_cast<unsigned*>(red + 2 * n_warps * ds::N_LIVE * BATCH);  // [2][n_warps]

  const int u = blockIdx.x;
  const size_t ncols = (size_t)n_chunks * chunk;
  const size_t colbase = (size_t)u * chunk;
  const int l = lo[u], h = hi[u];
  const bool live_chunk = u < *n_used_ptr && h > l;
  for (int i = p; i < chunk * ds::REC_WIDTH; i += tile_pix) {
    const int row = i / chunk, k = i - row * chunk;
    if (!live_chunk || row >= ds::N_LIVE || k < l || k >= h)
      grec[row * ncols + colbase + k] = 0.0f;
  }
  if (!live_chunk) return;                          // uniform across the CTA

  const int t = chunk_tile[u];
  const int cnt = h - l;
  const int base = s0[u] + l;
  {
    float* srec_f = reinterpret_cast<float*>(srec);
    for (int i = p; i < cnt * ds::N_LIVE; i += tile_pix) {
      const int f = i / cnt, k = i - f * cnt;
      srec_f[k * (4 * REC_F4) + f] = rec[(size_t)f * cap_pad + base + k];
    }
  }

  const float* gp = g_out + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  const float* fp = final_acc + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  const float* cp = carry + (size_t)u * ds::CARRY_ROWS * tile_pix + p;
  const float g0 = gp[0], g1 = gp[tile_pix], g2 = gp[2 * tile_pix], g3 = gp[3 * tile_pix];
  const float g_t = gp[4 * tile_pix];
  const float ccar = (fp[0] * g0 + fp[tile_pix] * g1 + fp[2 * tile_pix] * g2
                      + fp[3 * tile_pix] * g3) + g_t * fp[4 * tile_pix];
  // inclusive prefix of w * (c . g), from the chunks before this one on
  float run = cp[0] * g0 + cp[tile_pix] * g1 + cp[2 * tile_pix] * g2 + cp[3 * tile_pix] * g3;
  float T = cp[4 * tile_pix];
  const float px = (float)((t % tiles_x) * tile_w + p % tile_w);
  const float py = (float)((t / tiles_x) * tile_h + p / tile_w);
  const int my_field = field_of_lane(lane);
  bool stopped = false;                             // the stop rule is chunk-local
  __syncthreads();

  for (int j0 = 0, b = 0; j0 < cnt; j0 += BATCH, ++b) {
    const int nb = min(BATCH, cnt - j0);
    float* rbuf = red + (size_t)(b & 1) * n_warps * ds::N_LIVE * BATCH;
    unsigned* mbuf = wmask + (b & 1) * n_warps;
    unsigned hits = 0;                              // entries of the batch this warp hit
    if (!__all_sync(FULL, stopped)) {
      for (int k = 0; k < nb; ++k) {
        const float4 ea = srec[(j0 + k) * REC_F4];        // mx my ca cb
        const float4 eb = srec[(j0 + k) * REC_F4 + 1];    // cc opa r g
        const float power = ds::entry_power(ea.x, ea.y, ea.z, ea.w, eb.x, px, py);
        const bool far = stopped || power > 0.0f || power < FAR_POWER;
        if (__all_sync(FULL, far)) continue;        // alpha == 0 for the whole warp
        float v[ds::N_LIVE];
#pragma unroll
        for (int f = 0; f < ds::N_LIVE; ++f) v[f] = 0.0f;
        bool hit = false;
        if (!far) {
          float raw, ex;
          const float alpha = ds::alpha_of(eb.y, power, &raw, &ex);
          if (alpha > 0.0f) {                       // alpha == 0 changes nothing
            const float t_next = T * (1.0f - alpha);
            if (t_next < ds::T_EPS) {
              stopped = true;
            } else {
              const float4 ec = srec[(j0 + k) * REC_F4 + 2];   // b depth - -
              const float w = T * alpha;
              const float cg = g0 * eb.z + g1 * eb.w + g2 * ec.x + g3 * ec.y;
              run += w * cg;
              const float suffix = ccar - run;
              const float galpha = T * cg - suffix / (1.0f - alpha);
              const bool unclamped = raw < ds::ALPHA_MAX;
              const float gpower = unclamped ? galpha * raw : 0.0f;
              const float dx = ea.x - px, dy = ea.y - py;
              v[0] = -gpower * (ea.z * dx + ea.w * dy);
              v[1] = -gpower * (eb.x * dy + ea.w * dx);
              v[2] = -0.5f * gpower * dx * dx;
              v[3] = -gpower * dx * dy;
              v[4] = -0.5f * gpower * dy * dy;
              v[5] = unclamped ? galpha * ex : 0.0f;
              v[6] = w * g0;
              v[7] = w * g1;
              v[8] = w * g2;
              v[9] = w * g3;
              hit = true;
              T = t_next;
            }
          }
        }
        if (__any_sync(FULL, hit)) {
          fold<10, 16>(v, lane);
          fold<5, 8>(v, lane);
          fold<3, 4>(v, lane);
          fold<2, 2>(v, lane);
          const float s = v[0] + __shfl_xor_sync(FULL, v[0], 1);
          if (my_field >= 0) rbuf[(warp * ds::N_LIVE + my_field) * BATCH + k] = s;
          hits |= 1u << k;
        }
        if (__all_sync(FULL, stopped)) break;
      }
    }
    if (lane == 0) mbuf[warp] = hits;
    const int any_live = __syncthreads_or(!stopped);
    for (int i = p; i < nb * ds::N_LIVE; i += tile_pix) {
      const int f = i / nb, k = i - f * nb;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w)
        if ((mbuf[w] >> k) & 1u) s += rbuf[(w * ds::N_LIVE + f) * BATCH + k];
      grec[(size_t)f * ncols + colbase + l + j0 + k] = s;
    }
    if (!any_live) {                                // every pixel has stopped
      const int rest = cnt - (j0 + nb);
      for (int i = p; i < rest * ds::N_LIVE; i += tile_pix) {
        const int f = i / rest, k = i - f * rest;
        grec[(size_t)f * ncols + colbase + l + j0 + nb + k] = 0.0f;
      }
      break;
    }
  }
}

}  // namespace

// carry: the table K1 wrote for these chunks. tile_w * tile_h a multiple of
// 32 up to 1024, chunk up to 1024.
extern "C" int ds_composite_bwd(
    const void* rec, int cap_pad, const void* chunk_tile, const void* s0,
    const void* lo, const void* hi, int n_chunks, const void* n_used,
    const void* carry, const void* final_acc, const void* g_out, void* grec,
    int n_tiles, int tiles_x, int tile_w, int tile_h, int chunk, void* stream) {
  const int tile_pix = tile_w * tile_h;
  if (tile_pix % 32 != 0 || tile_pix > 1024 || n_chunks < 1 || chunk < 1 || chunk > 1024 ||
      n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const int n_warps = tile_pix / 32;
  const size_t smem = sizeof(float4) * REC_F4 * chunk
                      + sizeof(float) * (2 * (size_t)n_warps * ds::N_LIVE * BATCH + 2 * n_warps);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<<<n_chunks, tile_pix, smem, (cudaStream_t)stream>>>(
      (const float*)rec, cap_pad, (const int*)chunk_tile, (const int*)s0,
      (const int*)lo, (const int*)hi, n_chunks, (const int*)n_used, (const float*)carry,
      (const float*)final_acc, (const float*)g_out, (float*)grec, tiles_x, tile_w, tile_h,
      chunk);
  return (int)cudaGetLastError();
}
