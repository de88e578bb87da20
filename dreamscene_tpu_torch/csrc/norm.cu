// Group norm (optionally followed by SiLU) and layer norm, forward only, for
// the SD modules (guidance/sd_modules.py, through ops/norms.py). Each also
// writes the float32 mean and rstd of its slabs or rows, from which
// ops/norms.py's backward computes the gradients where autograd records.
//
// Replaces no Pallas kernel. The JAX package leaves Flax's nn.GroupNorm and
// nn.LayerNorm (dreamscene_tpu/guidance/sd_flax.py:89-95, 195-201, 218, 310)
// to XLA, which fuses the cast to float32, the moments, the normalisation
// and the SiLU that follows. Eager PyTorch on the card fuses nothing: the
// modules' float32 chain (cast up, moments, normalise, SiLU, cast down, and
// the permute before an attention block's projection) moves ~20-32 bytes an
// element where one read and one write move 4-6.
//
// Bound on this card: bytes. A norm does ~10 float operations an element
// against 4-6 bytes moved; the least time is (bytes read + written) /
// 3.35 TB/s.
//
// Numbers: moments in float32 (group norm: Welford per batch of loaded
// values, merged by Chan's formula across threads, warps and CTAs in a fixed
// order; layer norm: the mean, then the squared deviations from it, summed
// over the row held in registers), the biased variance, eps inside the
// square root; group norm y = x * a + b with a = rstd * gamma and
// b = beta - mean * a (as PyTorch's CUDA group norm forms it), then SiLU
// x / (1 + exp(-x)) when asked; layer norm y = gamma * ((x - mean) * rstd) +
// beta; all in float32, and one rounding to the output type. Only the order
// of the float32 sums differs from F.group_norm / F.layer_norm.
//
// Group norm design. A (batch, group) slab, cpg = C / G channels by HW
// tokens, is split by tokens over a thread-block cluster of 1-8 CTAs (one
// more CTA per CHUNK elements, so the ladder's 384 slabs at batch 12 give
// 384-3,072 CTAs for 132 SMs). Each CTA reads its part once, along the
// input's contiguous rows (tokens in NCHW; a group's channels in
// channels-last, the residual stream after an attention block) with loads of
// up to 16 bytes, keeps it in shared memory in the input's order when it fits
// in KEEP_BYTES (every ladder slab: at most 15,360 bf16 values a CTA) and
// folds it into its moments. The CTAs exchange their partial moments through
// distributed shared memory, so every CTA of the cluster holds the slab's
// mean and rstd, and writes its part from shared memory: in the input's
// layout (NCHW from NCHW, token-major [n, HW, C] from channels-last) with the
// loads' width, or transposed: NCHW from channels-last (a conv's input) in
// 16-byte stores of consecutive tokens gathered from shared memory,
// token-major from NCHW (an attention block's projection) element by element
// in the output's order. x is read from device memory once; a part too large for
// shared memory (the VAE's 256^2 and 512^2 levels) is read a second time for
// the output.
//
// Layer norm design: one warp per row of C values, each lane holding its
// 16-byte vectors of the row in registers (up to LN_MAX_HOLD: C <= 2048 in
// bf16, 1024 in float32), so a row is read once and written once; longer or
// unaligned rows are read a second time for the output.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int CHUNK = 16384;            // elements a CTA takes before its slab takes another CTA
constexpr int KEEP_BYTES = 48 * 1024;   // a CTA's part stays in shared memory up to this size
constexpr int STATIC_SMEM = 48 * 1024;  // dynamic shared memory a launch takes without opting in
constexpr int THREADS = 256;            // group norm: threads a CTA
constexpr int MIN_CTAS = 4;             // group norm: CTAs an SM holds at least (registers)
constexpr int LN_ROWS = 8;              // layer norm: rows (one per warp) a CTA
constexpr int LN_MAX_HOLD = 8;          // layer norm: 16-byte vectors a lane holds at most

struct Moments {
  float n, mean, m2;   // count, mean, sum of squared deviations from the mean
};

// Chan et al.'s merge of two partial moments
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean, wb = b.n / n;
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb};
}

// fold the first k of K values into m (one division for the batch)
template <int K>
__device__ __forceinline__ void fold(Moments& m, const float* v, int k) {
  if (k == 0) return;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < k) s += v[j];
  const float mean = s / (float)k;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < k) q = fmaf(v[j] - mean, v[j] - mean, q);
  m = merge(m, {(float)k, mean, q});
}

// the warp's moments, merged in a fixed tree, in lane 0
__device__ __forceinline__ Moments warp_merge(Moments m) {
  for (int off = 16; off > 0; off >>= 1) {
    const Moments o = {__shfl_down_sync(0xffffffffu, m.n, off),
                       __shfl_down_sync(0xffffffffu, m.mean, off),
                       __shfl_down_sync(0xffffffffu, m.m2, off)};
    m = merge(m, o);
  }
  return m;
}

// the warp's sum, added in a fixed tree, in every lane
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V consecutive values as one access of up to 16 bytes (wider ones split)
template <typename T, int V>
struct alignas(sizeof(T) * V > 16 ? 16 : sizeof(T) * V) Pack {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ void unpack(const Pack<T, V>& p, float* v) {
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = to_f(p.e[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const float* v) {
  Pack<T, V> p;
#pragma unroll
  for (int j = 0; j < V; ++j) p.e[j] = from_f<T>(v[j]);
  *reinterpret_cast<Pack<T, V>*>(dst) = p;
}

// divmod(i, n) of a thread's index i, advanced by a fixed stride without a
// division an element
struct DivMod {
  int hi, lo, dhi, dlo, n;
  __device__ DivMod(int i, int stride, int n_)
      : hi(i / n_), lo(i % n_), dhi(stride / n_), dlo(stride % n_), n(n_) {}
  __device__ __forceinline__ void next() {
    hi += dhi;
    lo += dlo;
    if (lo >= n) {
      lo -= n;
      ++hi;
    }
  }
};

// the cluster barrier in two halves: arrive once this CTA reads no other
// CTA's shared memory, wait before its own may go
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float act(float v, int silu) {
  return silu ? v / (1.0f + expf(-v)) : v;
}

// One (batch, group) slab per cluster, split by tokens: CTA r of the
// cluster takes tokens [r * T, min(HW, (r + 1) * T)) of all cpg channels.
// In the input the part is `outer` rows of `inner` contiguous values: cpg
// rows of nt tokens (NCHW) or nt rows of cpg channels (channels-last); V is
// the width of a load along a row (16 bytes where the rows allow).
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) group_norm_kernel(
    const Tin* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    Tout* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out, int C,
    int HW, int G, int T, float eps, int silu, int in_cl, int out_tok, int keep) {
  constexpr int VB = V >= 2 ? 4 : 8;   // loads in flight a thread
  constexpr int VO = 16 / sizeof(Tout);   // a 16-byte store
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Moments warp_part[THREADS / 32];
  __shared__ Moments part;
  __shared__ float stat[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int cpg = C / G, n = blockIdx.y / G, c0 = (blockIdx.y % G) * cpg;
  const int t0 = (int)cluster.block_rank() * T;
  const int nt = min(T, HW - t0);
  const int m = cpg * nt;
  const int tid = threadIdx.x, nthr = THREADS, lane = tid & 31, warp = tid >> 5;
  // element (cl, t): channel c0 + cl, token t0 + t
  const Tin* xs = x + (in_cl ? ((size_t)n * HW + t0) * C + c0 : ((size_t)n * C + c0) * HW + t0);
  const size_t in_c = in_cl ? 1 : HW, in_t = in_cl ? C : 1;
  Tout* ys = y + (out_tok ? ((size_t)n * HW + t0) * C + c0 : ((size_t)n * C + c0) * HW + t0);
  const size_t out_c = out_tok ? 1 : HW, out_t = out_tok ? C : 1;
  const size_t row = in_cl ? C : HW;   // elements between the input's rows (and the output's
                                       // in the same layout)
  const int nvr = (in_cl ? cpg : nt) / V, total = (in_cl ? nt : cpg) * nvr;   // vectors
  Tin* buf = reinterpret_cast<Tin*>(smem);   // the part in the input's order
  float* coef = reinterpret_cast<float*>(   // gamma and beta, then a and b
      smem + (keep ? ((size_t)cpg * T * sizeof(Tin) + 15) / 16 * 16 : 0));
  for (int cl = tid; cl < cpg; cl += nthr) {
    coef[cl] = gamma[c0 + cl];
    coef[cpg + cl] = beta[c0 + cl];
  }

  Moments mo = {0.f, 0.f, 0.f};
  DivMod w(tid, nthr, nvr);   // vector i: row w.hi, column w.lo * V
  for (int i0 = tid; i0 < total; i0 += nthr * VB) {
    Pack<Tin, V> p[VB];
    int k = 0;
#pragma unroll
    for (int j = 0; j < VB; ++j, w.next()) {
      if (i0 + j * nthr < total) {
        p[j] = *reinterpret_cast<const Pack<Tin, V>*>(xs + w.hi * row + w.lo * V);
        k = j + 1;
      }
    }
    if (keep) {
#pragma unroll
      for (int j = 0; j < VB; ++j)
        if (j < k) *reinterpret_cast<Pack<Tin, V>*>(buf + (size_t)(i0 + j * nthr) * V) = p[j];
    }
    if constexpr (V >= 4) {   // one fold a vector
#pragma unroll
      for (int j = 0; j < VB; ++j) {
        if (j < k) {
          float v[V];
          unpack(p[j], v);
          fold<V>(mo, v, V);
        }
      }
    } else {   // one fold a batch
      float v[V * VB];
#pragma unroll
      for (int j = 0; j < VB; ++j)
        if (j < k) unpack(p[j], v + j * V);
      fold<V * VB>(mo, v, k * V);
    }
  }

  // the warps' moments, the CTA's in warp 0, then the cluster's: lane r of
  // warp 0 reads CTA r's through distributed shared memory, and every CTA
  // merges them in the same order
  const Moments none = {0.f, 0.f, 0.f};
  mo = warp_merge(mo);
  if (lane == 0) warp_part[warp] = mo;
  __syncthreads();
  if (warp == 0) {
    mo = warp_merge(lane < nthr / 32 ? warp_part[lane] : none);
    if (lane == 0) part = mo;
  }
  cluster.sync();   // every CTA's part is written
  if (warp == 0) {
    mo = warp_merge(lane < (int)cluster.num_blocks() ? *cluster.map_shared_rank(&part, lane)
                                                      : none);
    if (lane == 0) {
      stat[0] = mo.mean;
      stat[1] = 1.0f / sqrtf(mo.m2 / mo.n + eps);
      if (cluster.block_rank() == 0) {
        mean_out[blockIdx.y] = stat[0];
        rstd_out[blockIdx.y] = stat[1];
      }
    }
  }
  __syncwarp();
  cluster_arrive();
  __syncthreads();   // stat is written
  const float mean = stat[0], rstd = stat[1];
  for (int cl = tid; cl < cpg; cl += nthr) {
    const float a = rstd * coef[cl];
    coef[cpg + cl] -= mean * a;
    coef[cl] = a;
  }
  __syncthreads();

  if (in_cl == out_tok) {   // the output in the input's layout: V wide
    DivMod o(tid, nthr, nvr);
    for (int i = tid; i < total; i += nthr, o.next()) {
      const Pack<Tin, V> p =
          keep ? *reinterpret_cast<const Pack<Tin, V>*>(buf + (size_t)i * V)
               : *reinterpret_cast<const Pack<Tin, V>*>(xs + o.hi * row + o.lo * V);
      float v[V];
      unpack(p, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int cl = in_cl ? o.lo * V + j : o.hi;
        v[j] = act(fmaf(v[j], coef[cl], coef[cpg + cl]), silu);
      }
      store<Tout, V>(ys + o.hi * row + o.lo * V, v);
    }
  } else if (!out_tok && keep && HW % VO == 0 && T % VO == 0) {   // channels-last to NCHW:
                                                                   // VO tokens a store
    DivMod o(tid, nthr, cpg);   // neighbouring threads on neighbouring channels in
                                // shared memory
    for (int i = tid; i < cpg * (nt / VO); i += nthr, o.next()) {
      const int cl = o.lo, t = o.hi * VO;
      const float a = coef[cl], b = coef[cpg + cl];
      float v[VO];
#pragma unroll
      for (int j = 0; j < VO; ++j) v[j] = act(fmaf(to_f(buf[(t + j) * cpg + cl]), a, b), silu);
      store<Tout, VO>(ys + cl * out_c + t, v);
    }
  } else {   // transposed: element by element in the output's order, (t, cl) or (cl, t)
    DivMod o(tid, nthr, out_tok ? cpg : nt);
    for (int i = tid; i < m; i += nthr, o.next()) {
      const int t = out_tok ? o.hi : o.lo, cl = out_tok ? o.lo : o.hi;
      const Tin e = keep ? buf[in_cl ? t * cpg + cl : cl * nt + t] : xs[cl * in_c + t * in_t];
      ys[cl * out_c + t * out_t] =
          from_f<Tout>(act(fmaf(to_f(e), coef[cl], coef[cpg + cl]), silu));
    }
  }
  cluster_wait();   // every CTA has read this one's part
}

// One warp per row of C values. V > 1: rows of whole 16-byte vectors.
// HOLD > 0: a lane holds its HOLD vectors of the row in registers (HOLD is
// the least power of two that holds the row, so short rows leave registers
// for more warps); HOLD = 0: the row is read once for the moments and once
// for the output.
template <typename Tin, typename Tout, int V, int HOLD>
__global__ void __launch_bounds__(LN_ROWS * 32) layer_norm_kernel(
    const Tin* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    Tout* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
    int C, float eps) {
  extern __shared__ __align__(16) float affine[];   // HOLD > 0: gamma, then beta
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  const float* gs = gamma;
  const float* bs = beta;
  if constexpr (HOLD > 0) {
    for (int c = threadIdx.x; c < C; c += LN_ROWS * 32) {
      affine[c] = gamma[c];
      affine[C + c] = beta[c];
    }
    __syncthreads();
    gs = affine;
    bs = affine + C;
  }
  if (row >= rows) return;   // the whole warp
  const Tin* xr = x + (size_t)row * C;
  Tout* yr = y + (size_t)row * C;
  const int nv = C / V;
  Pack<Tin, V> held[HOLD > 0 ? HOLD : 1];
  float mean, rstd;
  if constexpr (HOLD > 0) {   // two passes over the registers: the mean, then the deviations
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      const int j = lane + 32 * k;
      if (j < nv) held[k] = *reinterpret_cast<const Pack<Tin, V>*>(xr + j * V);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      if (lane + 32 * k < nv) {
        float v[V];
        unpack(held[k], v);
#pragma unroll
        for (int e = 0; e < V; ++e) s += v[e];
      }
    }
    mean = warp_sum(s) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < HOLD; ++k) {
      if (lane + 32 * k < nv) {
        float v[V];
        unpack(held[k], v);
#pragma unroll
        for (int e = 0; e < V; ++e) q = fmaf(v[e] - mean, v[e] - mean, q);
      }
    }
    rstd = 1.0f / sqrtf(warp_sum(q) / (float)C + eps);
  } else {   // Welford over one read, the output from a second
    Moments mo = {0.f, 0.f, 0.f};
    for (int j = lane; j < nv; j += 32) {
      float v[V];
      unpack(*reinterpret_cast<const Pack<Tin, V>*>(xr + j * V), v);
      fold<V>(mo, v, V);
    }
    mo = warp_merge(mo);
    mean = __shfl_sync(0xffffffffu, mo.mean, 0);
    rstd = 1.0f / sqrtf(__shfl_sync(0xffffffffu, mo.m2, 0) / (float)C + eps);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  auto emit = [&](int j, const Pack<Tin, V>& p) {
    float v[V], g[V], b[V];
    unpack(p, v);
    unpack(*reinterpret_cast<const Pack<float, V>*>(gs + j * V), g);
    unpack(*reinterpret_cast<const Pack<float, V>*>(bs + j * V), b);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = fmaf(g[e], (v[e] - mean) * rstd, b[e]);
    store<Tout, V>(yr + j * V, v);
  };
  if constexpr (HOLD > 0) {
#pragma unroll
    for (int k = 0; k < HOLD; ++k)
      if (lane + 32 * k < nv) emit(lane + 32 * k, held[k]);
  } else {
    for (int j = lane; j < nv; j += 32)
      emit(j, *reinterpret_cast<const Pack<Tin, V>*>(xr + j * V));
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Tin, typename Tout, int V>
cudaError_t launch_group_norm_v(const cudaLaunchConfig_t& cfg, const void* x, const void* gamma,
                                const void* beta, void* y, void* mean, void* rstd, int c, int hw,
                                int groups, int t, float eps, int silu, int in_cl, int out_tok,
                                int keep) {
  return cudaLaunchKernelEx(&cfg, group_norm_kernel<Tin, Tout, V>, (const Tin*)x,
                            (const float*)gamma, (const float*)beta, (Tout*)y, (float*)mean,
                            (float*)rstd, c, hw, groups, t, eps, silu, in_cl, out_tok, keep);
}

template <typename Tin, typename Tout>
int launch_group_norm(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                      void* rstd, int n, int c, int hw, int groups, float eps, int silu,
                      int in_cl, int out_tok, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(Tin);
  if (n < 1 || c < 1 || hw < 1 || groups < 1 || c % groups != 0 || (long)n * groups > 65535)
    return (int)cudaErrorInvalidValue;
  const int cpg = c / groups;
  // the load width: 16 bytes, or the widest power of two that divides the
  // rows (a channels-last group's cpg channels; NCHW rows of hw tokens)
  int v = aligned16(x) && aligned16(y) ? VV : 1;
  while (v > 1 && (in_cl ? cpg : hw) % v != 0) v /= 2;
  const long slab = (long)cpg * hw;
  int cs = (int)((slab + CHUNK - 1) / CHUNK);
  cs = cs < 1 ? 1 : (cs > MAX_CLUSTER ? MAX_CLUSTER : cs);
  int t = (hw + cs - 1) / cs;
  if (!in_cl) t = (t + v - 1) / v * v;   // NCHW parts of whole vectors
  else if (hw % 8 == 0) t = (t + 7) / 8 * 8;   // NCHW output in 16-byte stores
  cs = (hw + t - 1) / t;   // every CTA has tokens
  const long part = (long)cpg * t;
  const size_t coef = 2 * (size_t)cpg * sizeof(float);
  const size_t kept = ((size_t)part * sizeof(Tin) + 15) / 16 * 16;
  const int keep = part * (long)sizeof(Tin) <= KEEP_BYTES && kept + coef <= STATIC_SMEM;
  const size_t smem = (keep ? kept : 0) + coef;
  if (smem > STATIC_SMEM) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, n * groups, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (v) {
    case 8:   // bf16 only
      err = launch_group_norm_v<Tin, Tout, (VV >= 8 ? 8 : 1)>(
          cfg, x, gamma, beta, y, mean, rstd, c, hw, groups, t, eps, silu, in_cl, out_tok, keep);
      break;
    case 4:
      err = launch_group_norm_v<Tin, Tout, 4>(cfg, x, gamma, beta, y, mean, rstd, c, hw, groups,
                                              t, eps, silu, in_cl, out_tok, keep);
      break;
    case 2:
      err = launch_group_norm_v<Tin, Tout, 2>(cfg, x, gamma, beta, y, mean, rstd, c, hw, groups,
                                              t, eps, silu, in_cl, out_tok, keep);
      break;
    default:
      err = launch_group_norm_v<Tin, Tout, 1>(cfg, x, gamma, beta, y, mean, rstd, c, hw, groups,
                                              t, eps, silu, in_cl, out_tok, keep);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch_layer_norm(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                      void* rstd, int rows, int c, float eps, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(Tin);
  if (rows < 0 || c < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const bool vec = c % VV == 0 && aligned16(x) && aligned16(y) && aligned16(gamma) &&
                   aligned16(beta);
  const int per_lane = (c / VV + 31) / 32;   // vectors a lane takes
  const size_t affine = 2 * (size_t)c * sizeof(float);   // held rows: gamma and beta shared
  const dim3 grid((rows + LN_ROWS - 1) / LN_ROWS), block(LN_ROWS * 32);
  const Tin* xp = (const Tin*)x;
  const float *gp = (const float*)gamma, *bp = (const float*)beta;
  Tout* yp = (Tout*)y;
  float *mp = (float*)mean, *rp = (float*)rstd;
  if (!vec)
    layer_norm_kernel<Tin, Tout, 1, 0><<<grid, block, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                                   c, eps);
  else if (per_lane <= 1)
    layer_norm_kernel<Tin, Tout, VV, 1><<<grid, block, affine, stream>>>(xp, gp, bp, yp, mp, rp,
                                                                          rows, c, eps);
  else if (per_lane <= 2)
    layer_norm_kernel<Tin, Tout, VV, 2><<<grid, block, affine, stream>>>(xp, gp, bp, yp, mp, rp,
                                                                          rows, c, eps);
  else if (per_lane <= 4)
    layer_norm_kernel<Tin, Tout, VV, 4><<<grid, block, affine, stream>>>(xp, gp, bp, yp, mp, rp,
                                                                          rows, c, eps);
  else if (per_lane <= LN_MAX_HOLD)
    layer_norm_kernel<Tin, Tout, VV, LN_MAX_HOLD>
        <<<grid, block, affine, stream>>>(xp, gp, bp, yp, mp, rp, rows, c, eps);
  else
    layer_norm_kernel<Tin, Tout, VV, 0><<<grid, block, 0, stream>>>(xp, gp, bp, yp, mp, rp, rows,
                                                                    c, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, c, hw] (NCHW) or [n, hw, c] (in_cl: channels-last) -> y [n, c, hw] or
// [n, hw, c] (out_tok: token-major); gamma, beta float32 [c]; bf16 or float32
// in and out; mean and rstd: float32 [n, groups], the moments a backward needs
extern "C" int ds_group_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 void* mean, void* rstd, int n, int c, int hw, int groups,
                                 float eps, int silu, int in_cl, int out_tok, int in_bf16,
                                 int out_bf16, void* stream) {
  using bf = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return out_bf16 ? launch_group_norm<bf, bf>(x, gamma, beta, y, mean, rstd, n, c, hw, groups,
                                                eps, silu, in_cl, out_tok, s)
                    : launch_group_norm<bf, float>(x, gamma, beta, y, mean, rstd, n, c, hw,
                                                   groups, eps, silu, in_cl, out_tok, s);
  return out_bf16 ? launch_group_norm<float, bf>(x, gamma, beta, y, mean, rstd, n, c, hw, groups,
                                                 eps, silu, in_cl, out_tok, s)
                  : launch_group_norm<float, float>(x, gamma, beta, y, mean, rstd, n, c, hw,
                                                    groups, eps, silu, in_cl, out_tok, s);
}

// x [rows, c] -> y [rows, c]; gamma, beta float32 [c]; bf16 or float32 in and
// out; mean and rstd: float32 [rows]
extern "C" int ds_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                 void* mean, void* rstd, int rows, int c, float eps, int in_bf16,
                                 int out_bf16, void* stream) {
  using bf = __nv_bfloat16;
  const cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return out_bf16 ? launch_layer_norm<bf, bf>(x, gamma, beta, y, mean, rstd, rows, c, eps, s)
                    : launch_layer_norm<bf, float>(x, gamma, beta, y, mean, rstd, rows, c, eps,
                                                   s);
  return out_bf16 ? launch_layer_norm<float, bf>(x, gamma, beta, y, mean, rstd, rows, c, eps, s)
                  : launch_layer_norm<float, float>(x, gamma, beta, y, mean, rstd, rows, c, eps,
                                                    s);
}
