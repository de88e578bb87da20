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
// Bound on this card: operations on the entry-pixel pairs (an exp and ~20
// FLOPs each); the bytes are the record table (40 B per entry) and the
// accumulator and carry rows. What a launch really waits for is its longest
// serial chain: a pixel's T runs through its tile's entries in order, and
// the object crowds thousands of entries into a few tiles while most tiles
// hold none. One CTA per tile put the busiest tile's 512 pixel walks on one
// SM, and that CTA was the whole launch.
//
// Design: pixels do not read each other's state, so a tile is split into
// warps of 32 pixels (a warp_w x 32/warp_w block of the tile; 8 x 4 where
// the tile allows it), four warps to a CTA, each warp on its own, and the
// launch lasts as long as the busiest warp and the warps that share its SM.
// Two kernels per call:
//  * a first kernel ranks the tiles by live entries, most first (one
//    thread a tile, in shared memory that does not grow with the tile
//    count: any tile count the binning takes); the main kernel dispatches
//    the tiles' warps in that order, so the busiest tiles start at once,
//    about one CTA to an SM, and the cheap ones fill in behind them (in
//    plain tile order the busy middle of the image shared SMs: 0.21 against
//    0.176 ms at the path's scene on an NVIDIA H100 80GB HBM3 at a 700 W
//    power limit; PERF.md, measured with a script of commit e119691);
// then per warp:
//  * the tile's chunk metadata is read once, 32 chunks to a load, and
//    passed around by shuffles;
//  * records come in batches of 32 entries, one entry per lane, copied by
//    cp.async STAGES - 1 batches ahead (across chunk ends too) into the
//    warp's shared memory as three float4 per entry;
//  * K2's far-entry skip, first per warp box: each lane tests its entry
//    against the warp's pixel box (the quadratic form of the conic has its
//    minimum over the box on an edge, or is 0 inside); where the exponent is
//    below FAR_POWER over the whole box, no pixel of the warp can get
//    alpha > 0 and the entry is left out. The entries that may reach the box
//    are packed in order into the warp's walk list (the busiest warp at the
//    path's scene walks 1,616 of its tile's 2,932 entries). Then per pixel,
//    as K2 does: four entries at a time, their exps are skipped when every
//    pixel is stopped or has power > 0 or < FAR_POWER;
//  * T and the accumulators run through the four in order without a branch
//    (a stopped pixel or alpha == 0 adds 0 and keeps T).
// Every pixel performs the same operations, in the same order, whatever the
// order of the tiles and the warp it falls in: it walks its tile's entries
// one by one and stops as the chunk-local rule says. No float atomics, no
// shared state between warps.

#include <climits>

#include "composite_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;                  // warps per CTA
constexpr int BATCH = 32;                 // entries per staged batch, one per lane
constexpr int REC_F4 = 3;                 // float4 per staged record
constexpr int GROUP = 4;                  // entries whose alphas are formed together
constexpr int STAGES = 4;                 // batches per warp in shared memory
constexpr float FAR_POWER = -24.0f;       // exp(-24) = 3.8e-11, as in K2

// The minimum over the box dx in [x0, x1], dy in [y0, y1] of the quadratic
// form a dx^2 + 2 b dx dy + c dy^2 (power = -0.5 of it), for a > 0, c > 0:
// 0 when the box holds the origin, else the least of the four edges' minima
// (each edge a 1-D convex quadratic, minimised by clamping its vertex).
__device__ __forceinline__ float box_min_form(float a, float b, float c, float x0, float x1,
                                              float y0, float y1) {
  const bool inside = x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f && y1 >= 0.0f;
  const float ia = 1.0f / a, ic = 1.0f / c;
  const float ya = fminf(fmaxf(-b * x0 * ic, y0), y1);
  const float yb = fminf(fmaxf(-b * x1 * ic, y0), y1);
  const float xa = fminf(fmaxf(-b * y0 * ia, x0), x1);
  const float xb = fminf(fmaxf(-b * y1 * ia, x0), x1);
  const float ea = a * x0 * x0 + 2.0f * b * x0 * ya + c * ya * ya;
  const float eb = a * x1 * x1 + 2.0f * b * x1 * yb + c * yb * yb;
  const float ec = a * xa * xa + 2.0f * b * xa * y0 + c * y0 * y0;
  const float ed = a * xb * xb + 2.0f * b * xb * y1 + c * y1 * y1;
  return inside ? 0.0f : fminf(fminf(ea, eb), fminf(ec, ed));
}

// Whether an entry (mean mx, my, conic a, b, c) can reach the pixel box
// [bx0, bx1] x [by0, by1] with an exponent of FAR_POWER or more. Only a
// finite positive-definite conic whose form exceeds -2 FAR_POWER on the
// whole box is ruled out; anything else is walked pixel by pixel. The
// margin is wide: with opacity <= 1 alpha is already 0 where the form
// exceeds 2 ln 255 = 11.1, so the rounding of the box minimum (and of the
// vertices it clamps) cannot matter.
__device__ __forceinline__ bool may_reach(float mx, float my, float a, float b, float c,
                                          float bx0, float bx1, float by0, float by1) {
  const bool tested = isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
                      isfinite(c) && a > 0.0f && c > 0.0f && a * c - b * b > 0.0f;
  const float q = box_min_form(a, b, c, mx - bx1, mx - bx0, my - by1, my - by0);
  return !(tested && q > -2.0f * FAR_POWER);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One batch of a warp's walk: chunk c0 + i of the current window of 32
// chunks (live entries [l, h) at record columns col + [l, h)), entries
// [j0, min(j0 + BATCH, h)); i < 0 past the window's last live chunk. Lane u
// of the warp holds chunk c0 + u's (lo, hi, s0) in my_l, my_h, my_s.
struct Cursor {
  int i, l, h, col, j0;
};

__device__ __forceinline__ Cursor chunk_cursor(int i, int my_l, int my_h, int my_s) {
  Cursor c{i, 0, 0, 0, 0};
  if (i >= 0) {                                            // uniform across the warp
    c.l = __shfl_sync(FULL, my_l, i);
    c.h = __shfl_sync(FULL, my_h, i);
    c.col = __shfl_sync(FULL, my_s, i);
    c.j0 = c.l;
  }
  return c;
}

// the batch after c: the rest of its chunk, else the next live chunk's first
__device__ __forceinline__ Cursor advance(Cursor c, unsigned live_mask, int my_l, int my_h,
                                          int my_s) {
  if (c.i < 0) return c;
  c.j0 += BATCH;
  if (c.j0 < c.h) return c;
  const unsigned rest = live_mask & ~((2u << c.i) - 1u);  // i = 31: 2u << 31 == 0
  return chunk_cursor(rest ? __ffs(rest) - 1 : -1, my_l, my_h, my_s);
}

// Copy the batch at c (one entry per lane, its 10 fields from the
// field-major table) into a stage, entry-major as three float4, and close
// the group of copies (an empty group past the end keeps the count).
__device__ __forceinline__ void issue(const Cursor& c, float4* stage,
                                      const float* __restrict__ rec, int cap_pad, int lane) {
  if (c.i >= 0 && lane < min(BATCH, c.h - c.j0)) {
    const float* src = rec + c.col + c.j0 + lane;
    float* dst = reinterpret_cast<float*>(stage + lane * REC_F4);
#pragma unroll
    for (int f = 0; f < ds::N_LIVE; ++f) cp_async4(dst + f, src + (size_t)f * cap_pad);
  }
  cp_async_commit();
}

// The tiles ordered by live entries, most first, ties by tile index, into
// order[0 .. n_tiles] (the trash tile n_tiles has none). Each tile's key is
// (INT_MAX - its live entries) << 32 | its index, all keys distinct, and its
// rank is the number of keys below its own. Each CTA ranks ORDER_THREADS
// tiles, one a thread, against every key: the keys pass through a fixed
// window of ORDER_WINDOW in shared memory, each window's live-entry sums
// formed there from the chunks of its tiles (a contiguous run, the chunks
// being sorted by tile) with integer atomics, so the sums are exact. Shared
// memory does not grow with the tile count, and the n^2 comparisons spread
// over n / ORDER_THREADS CTAs. The CTA's own window comes first, so each
// thread holds its key before it counts.
constexpr int ORDER_THREADS = 256;
constexpr int ORDER_WINDOW = 4096;                         // 32 KB of keys

// the first chunk whose tile (clamped to [0, n_tiles]) is v or later
__device__ __forceinline__ int first_chunk_of(const int* __restrict__ chunk_tile,
                                              int n_chunks, int n_tiles, int v) {
  if (v <= 0) return 0;
  if (v > n_tiles) return n_chunks;
  return ds::lower_bound_i32(chunk_tile, n_chunks, v);
}

__global__ void __launch_bounds__(ORDER_THREADS) tile_order_kernel(
    const int* __restrict__ chunk_tile, const int* __restrict__ lo,
    const int* __restrict__ hi, int n_chunks, int n_tiles, int* __restrict__ order) {
  static_assert(ORDER_WINDOW % ORDER_THREADS == 0, "a CTA's tiles lie in one window");
  __shared__ unsigned long long key[ORDER_WINDOW];          // the sums, then the keys
  __shared__ int run[2];
  const int n = n_tiles + 1;
  const int n_win = (n + ORDER_WINDOW - 1) / ORDER_WINDOW;
  const int t = blockIdx.x * ORDER_THREADS + threadIdx.x;
  const int own = blockIdx.x * ORDER_THREADS / ORDER_WINDOW;
  unsigned long long k = 0ull;
  int r = 0;
  for (int i = 0; i < n_win; ++i) {
    const int w0 = ((own + i) % n_win) * ORDER_WINDOW;
    const int nw = min(ORDER_WINDOW, n - w0);
    __syncthreads();                                       // the last window is read
    for (int v = threadIdx.x; v < nw; v += ORDER_THREADS) key[v] = 0ull;
    if (threadIdx.x < 2)
      run[threadIdx.x] = first_chunk_of(chunk_tile, n_chunks, n_tiles, w0 + threadIdx.x * nw);
    __syncthreads();
    for (int u = run[0] + threadIdx.x; u < run[1]; u += ORDER_THREADS) {
      const int live = hi[u] - lo[u];
      if (live > 0)
        atomicAdd(&key[min(max(chunk_tile[u], 0), n_tiles) - w0], (unsigned long long)live);
    }
    __syncthreads();
    // ascending keys: cost descending, then tile ascending
    for (int v = threadIdx.x; v < nw; v += ORDER_THREADS)
      key[v] = ((unsigned long long)(unsigned)(INT_MAX - (int)key[v]) << 32) |
               (unsigned)(w0 + v);
    __syncthreads();
    if (i == 0 && t < n) k = key[t - w0];
    if (t < n) {
#pragma unroll 8
      for (int v = 0; v < nw; ++v) r += key[v] < k;
    }
  }
  if (t < n) order[r] = t;
}

void launch_tile_order(const void* chunk_tile, const void* lo, const void* hi, int n_chunks,
                       int n_tiles, void* order, void* stream) {
  tile_order_kernel<<<(n_tiles + ORDER_THREADS) / ORDER_THREADS, ORDER_THREADS, 0,
                      (cudaStream_t)stream>>>((const int*)chunk_tile, (const int*)lo,
                                              (const int*)hi, n_chunks, n_tiles, (int*)order);
}

// GROUP consecutive walked entries: their alphas at this lane's pixel and
// their colours
struct Group {
  float alpha[GROUP], r[GROUP], g[GROUP], b[GROUP], depth[GROUP];
};

// T and the accumulators through a group's entries, in order, as a walk of
// one entry at a time does, without a branch: a stopped pixel or an entry
// with alpha == 0 leaves T as it is (T * (1 - 0) == T >= T_EPS) and adds
// 0 * colour to each accumulator (acc + 0 == acc: an accumulator that
// starts at +0 is never -0); an entry that would take T under T_EPS stops
// the pixel and changes nothing, as a `break` out of that walk would.
__device__ __forceinline__ void composite(const Group& gr, float& T, float& acc0, float& acc1,
                                          float& acc2, float& acc3, bool& stopped) {
#pragma unroll
  for (int q = 0; q < GROUP; ++q) {
    const float a = stopped ? 0.0f : gr.alpha[q];
    const float t_next = T * (1.0f - a);
    const bool stop = t_next < ds::T_EPS;
    const float w = stop ? 0.0f : T * a;
    acc0 += w * gr.r[q];
    acc1 += w * gr.g[q];
    acc2 += w * gr.b[q];
    acc3 += w * gr.depth[q];
    T = stop ? T : t_next;
    stopped = stopped || stop;
  }
}

__global__ void __launch_bounds__(WARPS * 32) composite_fwd_kernel(
    const float* __restrict__ rec, int cap_pad,
    const int* __restrict__ chunk_tile, const int* __restrict__ s0,
    const int* __restrict__ lo, const int* __restrict__ hi, int n_chunks,
    float* __restrict__ out, float* __restrict__ carry, int n_tiles, int tiles_x,
    int tile_w, int tile_h, int warp_w, const int* __restrict__ tile_order) {
  __shared__ float4 srec_all[WARPS][STAGES][BATCH * REC_F4];
  __shared__ float4 walk_all[WARPS][BATCH * REC_F4];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int tile_pix = tile_w * tile_h, wpt = tile_pix >> 5;
  const int gw = blockIdx.x * WARPS + wib;
  if (gw >= (n_tiles + 1) * wpt) return;                  // a whole warp
  // a tile's warps are consecutive, the tiles in tile_order (most live
  // entries first, from tile_order_kernel)
  const int rank = gw / wpt, sub = gw - rank * wpt;
  const int t = tile_order[rank];
  float4* walk = walk_all[wib];
  const int warp_h = 32 / warp_w, per_row = tile_w / warp_w;
  const int bx = (sub % per_row) * warp_w, by = (sub / per_row) * warp_h;
  const int p = (by + lane / warp_w) * tile_w + bx + lane % warp_w;

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  float T = 1.0f;
  float live = 0.0f;

  if (t < n_tiles) {
    const int r = lane < 2 ? ds::lower_bound_i32(chunk_tile, n_chunks, t + lane) : 0;
    const int u0 = __shfl_sync(FULL, r, 0);
    const int u1 = __shfl_sync(FULL, r, 1);
    const int tx0 = (t % tiles_x) * tile_w, ty0 = (t / tiles_x) * tile_h;
    const float px = (float)(tx0 + p % tile_w);
    const float py = (float)(ty0 + p / tile_w);
    // the warp's pixel box
    const float bx0 = (float)(tx0 + bx), bx1 = (float)(tx0 + bx + warp_w - 1);
    const float by0 = (float)(ty0 + by), by1 = (float)(ty0 + by + warp_h - 1);
    bool stopped = false;                                  // the stop rule is chunk-local

    for (int c0 = u0; c0 < u1; c0 += 32) {
      const int nc = min(32, u1 - c0);
      int my_l = 0, my_h = 0, my_s = 0;
      if (lane < nc) {
        my_l = lo[c0 + lane];
        my_h = hi[c0 + lane];
        my_s = s0[c0 + lane];
      }
      const unsigned live_mask = __ballot_sync(FULL, my_h > my_l);
      if (live_mask == 0) continue;
      // STAGES - 1 batches in flight ahead of the one being walked
      Cursor cons = chunk_cursor(__ffs(live_mask) - 1, my_l, my_h, my_s), prod = cons;
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        issue(prod, srec_all[wib][s], rec, cap_pad, lane);
        prod = advance(prod, live_mask, my_l, my_h, my_s);
      }
      for (int b = 0; cons.i >= 0; ++b) {
        issue(prod, srec_all[wib][(b + STAGES - 1) % STAGES], rec, cap_pad, lane);
        prod = advance(prod, live_mask, my_l, my_h, my_s);
        cp_async_wait<STAGES - 1>();                       // batch b has landed
        __syncwarp();
        const float4* srec = srec_all[wib][b % STAGES];
        if (cons.j0 == cons.l) {                           // a chunk starts
          float* c = carry + (size_t)(c0 + cons.i) * ds::CARRY_ROWS * tile_pix + p;
          c[0 * tile_pix] = acc0;
          c[1 * tile_pix] = acc1;
          c[2 * tile_pix] = acc2;
          c[3 * tile_pix] = acc3;
          c[4 * tile_pix] = T;
          live += 1.0f;
          stopped = false;
        }
        // the entries that may reach the warp's box, in order, packed at the
        // front of `walk`
        int n_walk = 0;
        if (!__all_sync(FULL, stopped)) {
          bool reach = false;
          float4 ea, eb;
          if (lane < min(BATCH, cons.h - cons.j0)) {
            ea = srec[lane * REC_F4];
            eb = srec[lane * REC_F4 + 1];
            reach = may_reach(ea.x, ea.y, ea.z, ea.w, eb.x, bx0, bx1, by0, by1);
          }
          const unsigned todo = __ballot_sync(FULL, reach);
          if (reach) {
            const int rank = __popc(todo & ((1u << lane) - 1u));
            walk[rank * REC_F4] = ea;
            walk[rank * REC_F4 + 1] = eb;
            walk[rank * REC_F4 + 2] = srec[lane * REC_F4 + 2];
          }
          n_walk = __popc(todo);
          __syncwarp();
        }
        // GROUP entries at a time: their exponents, then (unless alpha is 0
        // for every pixel of the warp and all GROUP entries, K2's far-entry
        // skip) their exps and alphas, then T and the accumulators through
        // them in order
        for (int j = 0; j < n_walk; j += GROUP) {
          Group cur;
          float power[GROUP], opa[GROUP];
          bool far[GROUP], all_far = true;
#pragma unroll
          for (int q = 0; q < GROUP; ++q) {
            const bool has = j + q < n_walk;
            const int k = has ? j + q : 0;
            const float4 ea = walk[k * REC_F4];          // mx my ca cb
            const float4 eb = walk[k * REC_F4 + 1];      // cc opa r g
            const float4 ec = walk[k * REC_F4 + 2];      // b depth - -
            power[q] = ds::entry_power(ea.x, ea.y, ea.z, ea.w, eb.x, px, py);
            far[q] = !has || stopped || power[q] > 0.0f || power[q] < FAR_POWER;
            all_far = all_far && far[q];
            opa[q] = eb.y;
            cur.r[q] = eb.z;
            cur.g[q] = eb.w;
            cur.b[q] = ec.x;
            cur.depth[q] = ec.y;
          }
          if (__all_sync(FULL, all_far)) continue;
#pragma unroll
          for (int q = 0; q < GROUP; ++q) {
            float raw, ex;
            const float a = ds::alpha_of(opa[q], power[q], &raw, &ex);
            cur.alpha[q] = far[q] ? 0.0f : a;            // alpha_of gives 0 there too
          }
          composite(cur, T, acc0, acc1, acc2, acc3, stopped);
          if (__all_sync(FULL, stopped)) break;
        }
        __syncwarp();                                      // the stages are refilled next
        cons = advance(cons, live_mask, my_l, my_h, my_s);
      }
    }
  }
  float* o = out + (size_t)t * ds::ACC_ROWS * tile_pix + p;
  o[0 * tile_pix] = acc0;
  o[1 * tile_pix] = acc1;
  o[2 * tile_pix] = acc2;
  o[3 * tile_pix] = acc3;
  o[4 * tile_pix] = T;
  o[5 * tile_pix] = live;
  o[6 * tile_pix] = 0.0f;
  o[7 * tile_pix] = 0.0f;
}

// The width of a warp's pixel block: 8 x 4 where the tile allows it (the
// most compact block, which the fewest entries reach), else the closest
// power-of-two shape that divides the tile.
int pick_warp_w(int tile_w, int tile_h) {
  const int widths[] = {8, 16, 4, 32, 2, 1};
  for (int w : widths)
    if (tile_w % w == 0 && tile_h % (32 / w) == 0) return w;
  return 0;
}

}  // namespace

// tile_order: scratch for n_tiles + 1 ints, where a first kernel puts the
// tiles in the order the main kernel dispatches them (most live entries
// first); null is refused.
extern "C" int ds_composite_fwd(
    const void* rec, int cap_pad, const void* chunk_tile, const void* s0,
    const void* lo, const void* hi, int n_chunks, void* out, void* carry,
    int n_tiles, int tiles_x, int tile_w, int tile_h, void* tile_order, void* stream) {
  const int tile_pix = tile_w * tile_h;
  const int warp_w = pick_warp_w(tile_w, tile_h);
  if (tile_pix % 32 != 0 || tile_pix > 1024 || n_tiles < 1 || tile_order == nullptr ||
      warp_w <= 0)
    return (int)cudaErrorInvalidValue;
  launch_tile_order(chunk_tile, lo, hi, n_chunks, n_tiles, tile_order, stream);
  const int warps = (n_tiles + 1) * (tile_pix / 32);
  composite_fwd_kernel<<<(warps + WARPS - 1) / WARPS, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)rec, cap_pad, (const int*)chunk_tile, (const int*)s0,
      (const int*)lo, (const int*)hi, n_chunks, (float*)out, (float*)carry, n_tiles,
      tiles_x, tile_w, tile_h, warp_w, (const int*)tile_order);
  return (int)cudaGetLastError();
}

// The first kernel alone, the tile order into order[0 .. n_tiles]
// (chip_smoke.py times it beside K1).
extern "C" int ds_tile_order(const void* chunk_tile, const void* lo, const void* hi,
                             int n_chunks, int n_tiles, void* order, void* stream) {
  if (n_tiles < 1) return (int)cudaErrorInvalidValue;
  launch_tile_order(chunk_tile, lo, hi, n_chunks, n_tiles, order, stream);
  return (int)cudaGetLastError();
}
