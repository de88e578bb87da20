// Grid-hash k-nearest-neighbour mean squared distance (k=3), float32.
//
// Native replacement for the reference's CUDA `simple-knn` package
// (distCUDA2, reference: gs_renderer.py:9, 590-594): used once per model
// initialization to set isotropic log-scales from the mean squared
// distance to the 3 nearest neighbours. Runs on host (init-time, up to
// ~2M env points) with a uniform-grid spatial hash + expanding ring
// search, OpenMP-parallel over points.
//
// Exposed C ABI:
//   void knn3_mean_sq_dist(const float* pts, long n, float* out)
//
// Build: models/gaussians.py builds it at first use with g++ and the flags
// of the JAX package's native/build.sh (-O3 -march=native -fopenmp -shared
// -fPIC), so its float arithmetic, multiply-adds contracted, is the same.
// Host code: the CUDA build (kernels.py, csrc/*.cu) does not compile it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Grid {
  float mn[3], inv_cell;
  int dims[3];
  std::vector<int32_t> cell_start;   // [ncells+1]
  std::vector<int32_t> order;        // point ids sorted by cell
};

inline int64_t cell_of(const Grid& g, const float* p) {
  int c[3];
  for (int d = 0; d < 3; ++d) {
    int v = (int)((p[d] - g.mn[d]) * g.inv_cell);
    c[d] = std::min(std::max(v, 0), g.dims[d] - 1);
  }
  return ((int64_t)c[2] * g.dims[1] + c[1]) * g.dims[0] + c[0];
}

void build_grid(const float* pts, int64_t n, Grid& g) {
  float mx[3];
  for (int d = 0; d < 3; ++d) { g.mn[d] = pts[d]; mx[d] = pts[d]; }
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      g.mn[d] = std::min(g.mn[d], pts[i * 3 + d]);
      mx[d] = std::max(mx[d], pts[i * 3 + d]);
    }
  float extent = 0.f;
  for (int d = 0; d < 3; ++d) extent = std::max(extent, mx[d] - g.mn[d]);
  // aim for ~4 points per cell
  double target_cells = std::max((double)n / 4.0, 1.0);
  int side = (int)std::ceil(std::cbrt(target_cells));
  side = std::max(1, std::min(side, 512));
  float cell = std::max(extent / side, 1e-12f);
  g.inv_cell = 1.0f / cell;
  for (int d = 0; d < 3; ++d) {
    g.dims[d] = std::max(1, std::min((int)((mx[d] - g.mn[d]) * g.inv_cell) + 1,
                                     side));
  }
  int64_t ncells = (int64_t)g.dims[0] * g.dims[1] * g.dims[2];
  std::vector<int32_t> counts(ncells + 1, 0);
  std::vector<int64_t> cid(n);
  for (int64_t i = 0; i < n; ++i) {
    cid[i] = cell_of(g, pts + i * 3);
    counts[cid[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) counts[c + 1] += counts[c];
  g.cell_start.assign(counts.begin(), counts.end());
  g.order.resize(n);
  std::vector<int32_t> cursor(g.cell_start.begin(), g.cell_start.end() - 1);
  for (int64_t i = 0; i < n; ++i) g.order[cursor[cid[i]]++] = (int32_t)i;
}

inline void consider(float d2, float* best) {
  // keep 3 smallest (insertion into sorted triple)
  if (d2 < best[2]) {
    if (d2 < best[1]) {
      best[2] = best[1];
      if (d2 < best[0]) { best[1] = best[0]; best[0] = d2; }
      else best[1] = d2;
    } else best[2] = d2;
  }
}

}  // namespace

extern "C" void knn3_mean_sq_dist(const float* pts, int64_t n, float* out) {
  if (n <= 1) { for (int64_t i = 0; i < n; ++i) out[i] = 1e-6f; return; }
  if (n <= 64) {  // brute force for tiny inputs
    for (int64_t i = 0; i < n; ++i) {
      float best[3] = {1e30f, 1e30f, 1e30f};
      for (int64_t j = 0; j < n; ++j) {
        if (i == j) continue;
        float dx = pts[i*3]-pts[j*3], dy = pts[i*3+1]-pts[j*3+1],
              dz = pts[i*3+2]-pts[j*3+2];
        consider(dx*dx + dy*dy + dz*dz, best);
      }
      int k = (int)std::min<int64_t>(3, n - 1);
      float s = 0; for (int q = 0; q < k; ++q) s += best[q];
      out[i] = s / k;
    }
    return;
  }

  Grid g;
  build_grid(pts, n, g);
  const float cell = 1.0f / g.inv_cell;

#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * 3;
    int ci[3];
    for (int d = 0; d < 3; ++d) {
      int v = (int)((p[d] - g.mn[d]) * g.inv_cell);
      ci[d] = std::min(std::max(v, 0), g.dims[d] - 1);
    }
    float best[3] = {1e30f, 1e30f, 1e30f};
    int found = 0;
    int max_ring = std::max(g.dims[0], std::max(g.dims[1], g.dims[2]));
    for (int ring = 0; ring <= max_ring; ++ring) {
      // prune: if we already have 3 and the closest possible point in this
      // ring is farther than our current worst, stop.
      if (found >= 3) {
        float ring_min = (ring - 1) * cell;
        if (ring_min > 0 && ring_min * ring_min > best[2]) break;
      }
      int x0 = std::max(ci[0] - ring, 0), x1 = std::min(ci[0] + ring, g.dims[0] - 1);
      int y0 = std::max(ci[1] - ring, 0), y1 = std::min(ci[1] + ring, g.dims[1] - 1);
      int z0 = std::max(ci[2] - ring, 0), z1 = std::min(ci[2] + ring, g.dims[2] - 1);
      for (int z = z0; z <= z1; ++z)
        for (int y = y0; y <= y1; ++y)
          for (int x = x0; x <= x1; ++x) {
            // shell only (skip interior already scanned)
            if (ring > 0 && x != x0 && x != x1 && y != y0 && y != y1 &&
                z != z0 && z != z1)
              continue;
            if (std::max({std::abs(x - ci[0]), std::abs(y - ci[1]),
                          std::abs(z - ci[2])}) != ring)
              continue;
            int64_t c = ((int64_t)z * g.dims[1] + y) * g.dims[0] + x;
            for (int32_t s = g.cell_start[c]; s < g.cell_start[c + 1]; ++s) {
              int32_t j = g.order[s];
              if (j == (int32_t)i) continue;
              float dx = p[0]-pts[j*3], dy = p[1]-pts[j*3+1],
                    dz = p[2]-pts[j*3+2];
              consider(dx*dx + dy*dy + dz*dz, best);
              ++found;
            }
          }
      if (ring == max_ring) break;
    }
    out[i] = (best[0] + best[1] + best[2]) / 3.0f;
  }
}
