// Ragged entry expansion for tile binning (kernel K3).
//
// Replaces: dreamscene_tpu/ops/expand.py, `_expand_kernel` (host function
// `expand_entries`), a Pallas TPU kernel that recovers each entry's owner
// with windowed f32 step-function matmuls on the MXU.
//
// What it computes: for every entry slot e < capacity, the owning splat d
// (depth-rank order) is the last rank whose exclusive offset is <= e, limited
// to the window the TPU kernel scans for e's block (`wend`, computed by the
// wrapper). The slot emits key = tile << shift | (d >> rank_drop) and
// gid = perm[d]; slots at or past n_entries, or whose tile the splat's
// capsule cannot reach at alpha >= 1/255, get the trash tile n_tiles.
//
// Bound on this card: bytes. Each slot writes 8 bytes and reads a handful of
// per-splat words; the per-slot binary search over `offs_c` (n <= 60K rows,
// 240 KB) stays in L2, so the kernel is bounded by the writes and a few
// gathered reads. Design: one thread per entry slot, no shared memory; the
// gathers of neighbouring slots hit the same splat rows (runs are
// contiguous), so they coalesce in L1/L2.
//
// Exactness: the output must be bit-equal to the plain PyTorch version and
// to the JAX kernel. Tile arithmetic is integer; the cull follows the JAX
// f32 expression order operation by operation, and the library is built
// with -fmad=false and IEEE division so no product is contracted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float emin_edge_x(float cst, float ea, float eb, float ec,
                                             float lye, float uye) {
  float dye = clipf((-eb * cst) / fmaxf(ec, 1e-30f), lye, uye);
  return ea * cst * cst + 2.0f * eb * cst * dye + ec * dye * dye;
}

__device__ __forceinline__ float emin_edge_y(float cst, float ea, float eb, float ec,
                                             float lxe, float uxe) {
  float dxe = clipf((-eb * cst) / fmaxf(ea, 1e-30f), lxe, uxe);
  return ea * dxe * dxe + 2.0f * eb * dxe * cst + ec * cst * cst;
}

__global__ void expand_kernel(
    const int* __restrict__ offs_c, const int* __restrict__ basenx,
    const int* __restrict__ offsets, const int* __restrict__ perm,
    const int* __restrict__ caps0, const int* __restrict__ caps1,
    const int* __restrict__ caps2, const int* __restrict__ wend,
    const int* __restrict__ n_entries,
    int* __restrict__ key_out, int* __restrict__ gid_out,
    int capacity, int n, int n_tiles, int tiles_x, int shift, int rank_drop,
    int block, int use_cull, int tile_w, int tile_h, float cxo, float cyo,
    float hwx, float hwy, float inv_tiles_x) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= capacity) return;

  // owner: # of offs_c <= e (upper bound), limited to the block's window
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (offs_c[mid] <= e) lo = mid + 1; else hi = mid;
  }
  int d = min(lo, wend[e / block]) - 1;
  d = max(d, 0);

  int bn = basenx[d];
  int slot_e = e - offsets[d];
  int base_t = bn >> 8;
  int gnx = max(bn & 255, 1);
  int qy = slot_e / gnx;
  int tile = base_t + qy * tiles_x + (slot_e - qy * gnx);
  bool valid = e < *n_entries;

  if (use_cull && valid) {
    int ch0 = caps0[d], ch1 = caps1[d], ch2 = caps2[d];
    float midx = (float)((ch0 >> 12) - 2048) * 0.5f;
    float midy = (float)((ch0 & 4095) - 2048) * 0.5f;
    float vx = (float)((ch1 >> 12) - 2048) * 0.5f;
    float vy = (float)((ch1 & 4095) - 2048) * 0.5f;
    float big_b = (float)(ch2 >> 12) * 0.5f;
    bool no_cull = (ch2 & 4095) > 0;
    float tilef = (float)tile;
    float ty = floorf(tilef * inv_tiles_x);
    float tx = tilef - ty * (float)tiles_x;
    float dx = tx * (float)tile_w + cxo - midx;
    float dy = ty * (float)tile_h + cyo - midy;
    float v2 = vx * vx + vy * vy;
    float v2g = fmaxf(v2, 0.25f);
    float iv2 = 1.0f / v2g;
    float ib2 = 1.0f / fmaxf(big_b * big_b, 0.25f);
    float ea = (vx * vx * iv2 + vy * vy * ib2) * iv2;
    float eb = (vx * vy * iv2 - vx * vy * ib2) * iv2;
    float ec = (vy * vy * iv2 + vx * vx * ib2) * iv2;
    float lxe = dx - hwx, uxe = dx + hwx;
    float lye = dy - hwy, uye = dy + hwy;
    bool inside = (lxe <= 0.0f) && (uxe >= 0.0f) && (lye <= 0.0f) && (uye >= 0.0f);
    float emin = fminf(
        fminf(emin_edge_x(lxe, ea, eb, ec, lye, uye), emin_edge_x(uxe, ea, eb, ec, lye, uye)),
        fminf(emin_edge_y(lye, ea, eb, ec, lxe, uxe), emin_edge_y(uye, ea, eb, ec, lxe, uxe)));
    if (inside) emin = 0.0f;
    float thresh = 1.001f + 0.55f * ib2;
    valid = no_cull || (emin <= thresh);
  }

  uint32_t tile_u = valid ? (uint32_t)tile : (uint32_t)n_tiles;
  uint32_t key = (tile_u << shift) | ((uint32_t)d >> rank_drop);
  key_out[e] = (int)key;
  gid_out[e] = min(max(perm[d], 0), n - 1);
}

}  // namespace

extern "C" int ds_expand_entries(
    const void* offs_c, const void* basenx, const void* offsets, const void* perm,
    const void* caps0, const void* caps1, const void* caps2, const void* wend,
    const void* n_entries, void* key_out, void* gid_out,
    int capacity, int n, int n_tiles, int tiles_x, int shift, int rank_drop,
    int block, int use_cull, int tile_w, int tile_h, float cxo, float cyo,
    float hwx, float hwy, float inv_tiles_x, void* stream) {
  const int threads = 256;
  int blocks = (capacity + threads - 1) / threads;
  if (blocks > 0) {
    expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)offs_c, (const int*)basenx, (const int*)offsets, (const int*)perm,
        (const int*)caps0, (const int*)caps1, (const int*)caps2, (const int*)wend,
        (const int*)n_entries, (int*)key_out, (int*)gid_out, capacity, n, n_tiles,
        tiles_x, shift, rank_drop, block, use_cull, tile_w, tile_h, cxo, cyo, hwx, hwy,
        inv_tiles_x);
  }
  return (int)cudaGetLastError();
}
