// Shared per-(pixel, entry) compositing math of kernels K1 and K2.
//
// Record layout (field-major rows of the sorted record table, one column per
// entry): 0 mx, 1 my, 2-4 conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth,
// 10-15 padding. Accumulator rows: 0-2 rgb, 3 depth, 4 T, 5 live chunks.
//
// Compositing semantics follow the JAX kernels chunk by chunk: within each
// chunk a pixel applies the prefix of entries that keeps T >= 1e-4 and skips
// the rest of that chunk; the next chunk starts again from the T reached so
// far. Both kernels evaluate alpha with the same operations (`entry_power`
// then `alpha_of`; `entry_alpha` is the two together), so K2 replays exactly
// the decisions K1 made.
//
// Carry table (K1 writes it, K2 reads it): [n_chunks, 5, tile_pix], for each
// live chunk the state of each pixel of its tile when the chunk starts:
// rows 0-3 the accumulated rgb and depth, row 4 T. With it every chunk's
// backward is independent of the chunks before it.

#pragma once

#include <cuda_runtime.h>

namespace ds {

constexpr int REC_WIDTH = 16;
constexpr int N_LIVE = 10;
constexpr int ACC_ROWS = 8;
constexpr int CARRY_ROWS = 5;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;

struct Rec {
  float mx, my, ca, cb, cc, opa, r, g, b, depth;
};

// exponent of one entry's Gaussian at one pixel
__device__ __forceinline__ float entry_power(float mx, float my, float ca, float cb, float cc,
                                             float px, float py) {
  float dx = mx - px;
  float dy = my - py;
  return -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
}

// alpha from the exponent; also returns raw = opa*exp(power) and exp(power)
__device__ __forceinline__ float alpha_of(float opa, float power, float* raw_out,
                                          float* ex_out) {
  float ex = expf(power);
  float raw = opa * ex;
  float alpha = fminf(ALPHA_MAX, raw);
  if (power > 0.0f || raw < ALPHA_MIN) alpha = 0.0f;
  *raw_out = raw;
  *ex_out = ex;
  return alpha;
}

// alpha of one entry at one pixel; also returns power, raw and exp(power)
__device__ __forceinline__ float entry_alpha(const Rec& e, float px, float py,
                                             float* power_out, float* raw_out,
                                             float* ex_out) {
  float power = entry_power(e.mx, e.my, e.ca, e.cb, e.cc, px, py);
  *power_out = power;
  return alpha_of(e.opa, power, raw_out, ex_out);
}

// first chunk of tile t in the sorted chunk_tile array (lower bound)
__device__ __forceinline__ int lower_bound_i32(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace ds
