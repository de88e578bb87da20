// Shared per-(pixel, entry) compositing math of kernels K1 and K2.
//
// Record layout (field-major rows of the sorted record table, one column per
// entry): 0 mx, 1 my, 2-4 conic (a, b, c), 5 opacity, 6-8 rgb, 9 depth,
// 10-15 padding. Accumulator rows: 0-2 rgb, 3 depth, 4 T, 5 live chunks.
//
// Compositing semantics follow the JAX kernels chunk by chunk: within each
// chunk a pixel applies the prefix of entries that keeps T >= 1e-4 and skips
// the rest of that chunk; the next chunk starts again from the T reached so
// far. Both kernels evaluate `entry_alpha` with the same operations, so K2
// replays exactly the decisions K1 made.

#pragma once

#include <cuda_runtime.h>

namespace ds {

constexpr int REC_WIDTH = 16;
constexpr int N_LIVE = 10;
constexpr int ACC_ROWS = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float T_EPS = 1e-4f;

struct Rec {
  float mx, my, ca, cb, cc, opa, r, g, b, depth;
};

// alpha of one entry at one pixel; also returns power, raw = opa*exp(power)
// and exp(power) for K2
__device__ __forceinline__ float entry_alpha(const Rec& e, float px, float py,
                                             float* power_out, float* raw_out,
                                             float* ex_out) {
  float dx = e.mx - px;
  float dy = e.my - py;
  float power = -0.5f * (e.ca * dx * dx + e.cc * dy * dy) - e.cb * dx * dy;
  float ex = expf(power);
  float raw = e.opa * ex;
  float alpha = fminf(ALPHA_MAX, raw);
  if (power > 0.0f || raw < ALPHA_MIN) alpha = 0.0f;
  *power_out = power;
  *raw_out = raw;
  *ex_out = ex;
  return alpha;
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
