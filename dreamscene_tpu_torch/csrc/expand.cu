// Ragged entry expansion for tile binning (kernel K3).
//
// Replaces: dreamscene_tpu/ops/expand.py, `_expand_kernel` (host function
// `expand_entries`), a Pallas TPU kernel that recovers each entry's owner
// with windowed f32 step-function matmuls on the MXU.
//
// What it computes: for every entry slot e < capacity, the owning splat d
// (depth-rank order) is the last rank whose exclusive offset (clamped to
// capacity) is <= e, limited to the window of splat rows the TPU kernel
// scans for e's block of `block` slots (`wend`). The slot emits
// key = tile << shift | (d >> rank_drop) and gid = perm[d]; slots at or past
// n_entries, or whose tile the splat's capsule cannot reach at
// alpha >= 1/255, get the trash tile n_tiles.
//
// Bound on this card: bytes. Each slot writes 8 bytes and reads a handful
// of per-splat words. The device work is small next to what a call costs
// the host: the launch and whatever torch ops prepare it.
//
// Design: one launch per call, nothing computed on the host but the
// per-geometry constants (ExpandGeo, passed by value). One thread per slot,
// SLOTS slots per CUDA block (128 when the window block is an odd multiple
// of 128 slots), all inside one window block:
//  * the window end: the block's first warps run the two binary searches
//    over the unclamped offsets that give its window block's end (as
//    ops/expand.py::_window_ends does for all blocks at once; the
//    rounded-up division is written for C's truncating `/` on a
//    non-negative numerator);
//  * the owner: owners are non-decreasing in e, so two more searches give
//    the owner range [r0, r1] of the block's first and last slot, and every
//    slot's owner is r0 plus a search inside it. The range's clamped offsets
//    are staged in shared memory when they fit (OWNERS rows; a few dozen at
//    ~4-8 entries per splat) and searched in device memory when they do not
//    (the slots past the last entry, where every empty splat's offset is
//    n_entries);
//  * the tile, the cull and the outputs as before: gathers of neighbouring
//    slots hit the same splat rows and coalesce in L1/L2.
//
// Exactness: the output must be bit-equal to the plain PyTorch version and
// to the JAX kernel. Tile arithmetic is integer; the cull follows the JAX
// f32 expression order operation by operation, and the library is built
// with -fmad=false and IEEE division so no product is contracted.

#include <climits>
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

// the per-geometry scalars of a launch (ops/expand.py builds it once per
// geometry as a ctypes.Structure with the same fields in the same order)
struct ExpandGeo {
  int capacity, n, n_tiles, tiles_x, shift, rank_drop, block, use_cull, tile_w, tile_h;
  float cxo, cyo, hwx, hwy, inv_tiles_x;
};

constexpr int SLOTS = 256;                // entry slots (threads) per CUDA block, at most
constexpr int MIN_SLOTS = 128;            // the window block's granularity (the JAX kernel's)
constexpr int OWNERS = 1024;              // owner offsets a block stages in shared memory

// # of i in [lo, hi) with min(a[i], cap) <= v (a sorted); cap = INT_MAX reads a as it is
__device__ __forceinline__ int upper_bound(const int* __restrict__ a, int lo, int hi, int v,
                                           int cap) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (min(a[mid], cap) <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(SLOTS) expand_kernel(
    const int* __restrict__ offsets, const int* __restrict__ basenx,
    const int* __restrict__ perm, const int* __restrict__ caps0,
    const int* __restrict__ caps1, const int* __restrict__ caps2,
    const int* __restrict__ n_entries, int* __restrict__ key_out,
    int* __restrict__ gid_out, const ExpandGeo g) {
  __shared__ int s_offs[OWNERS];
  __shared__ int s_bound[4];
  const int slots = blockDim.x;           // SLOTS, or MIN_SLOTS: divides g.block
  const int e0 = blockIdx.x * slots;
  const int e_last = min(e0 + slots, g.capacity) - 1;
  if ((threadIdx.x & 31) == 0 && threadIdx.x < 128) {
    // four searches, one per warp: the window block's two (unclamped
    // offsets) and the owners of the first and last slot (clamped)
    const int w = threadIdx.x >> 5;
    const int bstart = e0 / g.block * g.block;
    const int v = w == 0 ? bstart : w == 1 ? bstart + g.block - 1 : w == 2 ? e0 : e_last;
    s_bound[w] = upper_bound(offsets, 0, g.n, v, w < 2 ? INT_MAX : g.capacity);
  }
  __syncthreads();
  const int ws0 = max(s_bound[0] - 1, 0);
  const int w0a = ws0 / 128 * 128;
  const int ws_end = s_bound[1];                           // >= s_bound[0] >= w0a
  const int wlive = min(max((ws_end - w0a + 127) / 128, 1), (g.block + 256) / 128);
  const int wend = w0a + 128 * wlive;
  const int r0 = s_bound[2], m = s_bound[3] - r0;
  const bool staged = m <= OWNERS;
  if (staged) {
    for (int i = threadIdx.x; i < m; i += slots) s_offs[i] = min(offsets[r0 + i], g.capacity);
  }
  __syncthreads();
  const int e = e0 + threadIdx.x;
  if (e > e_last) return;

  // owner: r0 + # of the range's clamped offsets <= e, limited to the window
  int lo = 0;
  if (staged) {
    int hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_offs[mid] <= e) lo = mid + 1; else hi = mid;
    }
    lo += r0;
  } else {
    lo = upper_bound(offsets, r0, r0 + m, e, g.capacity);
  }
  int d = min(lo, wend) - 1;
  d = max(d, 0);

  int bn = basenx[d];
  int slot_e = e - offsets[d];
  int base_t = bn >> 8;
  int gnx = max(bn & 255, 1);
  int qy = slot_e / gnx;
  int tile = base_t + qy * g.tiles_x + (slot_e - qy * gnx);
  bool valid = e < *n_entries;

  if (g.use_cull && valid) {
    int ch0 = caps0[d], ch1 = caps1[d], ch2 = caps2[d];
    float midx = (float)((ch0 >> 12) - 2048) * 0.5f;
    float midy = (float)((ch0 & 4095) - 2048) * 0.5f;
    float vx = (float)((ch1 >> 12) - 2048) * 0.5f;
    float vy = (float)((ch1 & 4095) - 2048) * 0.5f;
    float big_b = (float)(ch2 >> 12) * 0.5f;
    bool no_cull = (ch2 & 4095) > 0;
    float tilef = (float)tile;
    float ty = floorf(tilef * g.inv_tiles_x);
    float tx = tilef - ty * (float)g.tiles_x;
    float dx = tx * (float)g.tile_w + g.cxo - midx;
    float dy = ty * (float)g.tile_h + g.cyo - midy;
    float v2 = vx * vx + vy * vy;
    float v2g = fmaxf(v2, 0.25f);
    float iv2 = 1.0f / v2g;
    float ib2 = 1.0f / fmaxf(big_b * big_b, 0.25f);
    float ea = (vx * vx * iv2 + vy * vy * ib2) * iv2;
    float eb = (vx * vy * iv2 - vx * vy * ib2) * iv2;
    float ec = (vy * vy * iv2 + vx * vx * ib2) * iv2;
    float lxe = dx - g.hwx, uxe = dx + g.hwx;
    float lye = dy - g.hwy, uye = dy + g.hwy;
    bool inside = (lxe <= 0.0f) && (uxe >= 0.0f) && (lye <= 0.0f) && (uye >= 0.0f);
    float emin = fminf(
        fminf(emin_edge_x(lxe, ea, eb, ec, lye, uye), emin_edge_x(uxe, ea, eb, ec, lye, uye)),
        fminf(emin_edge_y(lye, ea, eb, ec, lxe, uxe), emin_edge_y(uye, ea, eb, ec, lxe, uxe)));
    if (inside) emin = 0.0f;
    float thresh = 1.001f + 0.55f * ib2;
    valid = no_cull || (emin <= thresh);
  }

  uint32_t tile_u = valid ? (uint32_t)tile : (uint32_t)g.n_tiles;
  uint32_t key = (tile_u << g.shift) | ((uint32_t)d >> g.rank_drop);
  key_out[e] = (int)key;
  gid_out[e] = min(max(perm[d], 0), g.n - 1);
}

}  // namespace

// geo: a host pointer to the launch's ExpandGeo. block a positive multiple
// of MIN_SLOTS; a CUDA block holds SLOTS slots where that divides block and
// MIN_SLOTS where it does not, so that it lies in one window block.
extern "C" int ds_expand_entries(
    const void* offsets, const void* basenx, const void* perm, const void* caps0,
    const void* caps1, const void* caps2, const void* n_entries, void* key_out,
    void* gid_out, const void* geo, void* stream) {
  const ExpandGeo g = *(const ExpandGeo*)geo;
  if (g.block < MIN_SLOTS || g.block % MIN_SLOTS != 0 || g.n < 1 || g.capacity < 0)
    return (int)cudaErrorInvalidValue;
  const int slots = g.block % SLOTS == 0 ? SLOTS : MIN_SLOTS;
  const int blocks = (g.capacity + slots - 1) / slots;
  if (blocks > 0) {
    expand_kernel<<<blocks, slots, 0, (cudaStream_t)stream>>>(
        (const int*)offsets, (const int*)basenx, (const int*)perm, (const int*)caps0,
        (const int*)caps1, (const int*)caps2, (const int*)n_entries, (int*)key_out,
        (int*)gid_out, g);
  }
  return (int)cudaGetLastError();
}
