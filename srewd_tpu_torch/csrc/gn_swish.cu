// GroupNorm + affine (+ Swish) over NHWC [B, HW, C], forward and backward,
// for Hopper (sm_90a) on thread-block clusters.
//
// Replaces the TPU kernel `_pallas_gn_swish` in srewd_tpu/ops/pallas_fused.py
// (body `_kernel`) and, for the gradient, that package's recompute VJP `_bwd`
// (jax.vjp of `_pure_gn_swish`). Semantics as there: float32 statistics
// E[x^2] - E[x]^2 per (sample, group), affine in float32, the result cast to
// the storage dtype BEFORE the optional Swish y * sigmoid(y).
//
// What bounds it: a few flops per element against each element read once and
// written once (forward; the backward reads x and dy and writes dx), far
// below the card's ~295 flop/byte balance point: bytes. The TPU kernel kept a
// whole sample in VMEM and read it once; a Hopper block has at most 227 KB of
// shared memory, so here one THREAD-BLOCK CLUSTER holds the work item
// instead, and the input is still read from device memory once:
//   * A work item is one sample x one channel slice: S channels, a run of
//     whole groups whose row segment is a multiple of 16 bytes (gn_plan in
//     ops/fused_groupnorm.py chooses S, the cluster size, the rows per block
//     and the threads; this file checks the shared-memory size it derives).
//     Each of the cluster's blocks copies its run of rows x S channels into
//     shared memory with 16-byte cp.async.
//   * Each thread sums a fixed channel (threads % S == 0) over its rows in
//     float32; a block folds its threads' sums per channel in thread order.
//   * Cluster barrier; then every block reads all blocks' per-channel sums
//     through distributed shared memory (map_shared_rank) and adds them in
//     rank order, and folds channels into groups in channel order. Every
//     block, and every run, gets the same statistics: deterministic, no
//     atomics.
//   * Each block normalises its rows from shared memory and writes them with
//     16-byte stores. A second cluster barrier (arrive after the remote reads,
//     wait before exit) keeps every block's shared memory alive while others
//     read it.
//
// Forward numerics: y = (x - mean) * (rstd * w) + b in float32, rounded to the
// storage dtype; the Swish runs on that rounded value in float32 and is
// rounded once. With non-null `mean_out`/`rstd_out` the kernel also writes
// the statistics, float32 [B, G], for the backward; y does not change.
//
// Backward: x and dy both stay resident. Per element, from the saved mean and
// rstd: xh = (x - mean) * rstd, the Swish's gradient taken at the rounded
// y = T(xh * w + b) with the roundings of PyTorch's autograd of
// y * sigmoid(y) in the storage dtype (T = float32 rounds nothing), giving
// dyp, the gradient of the float32 affine output, a value of T that takes
// dy's place in shared memory for the dx pass. Per channel the cluster sums
// dyp and dyp * xh (as above: thread, block, rank order); per group
//   dx = rstd * (dyp * w - mean_g(dyp * w) - xh * mean_g(dyp * w * xh)).
// Rank 0 of each cluster writes its per-channel sums to a float32 workspace
// [B, 2, C]; a second small launch adds them over B in order into dbias and
// dweight (float32). No float atomics anywhere.

#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using srewd::cp_async16;
using srewd::cp_async_commit;
using srewd::cp_async_wait;

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

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

// v rounded to T and back: what an op of PyTorch in dtype T leaves.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// 1 / x by the special-function unit (rcp.approx: about one float32 ulp;
// 1 / inf = 0).
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// sigmoid by the fast exponential and reciprocal (a few float32 ulps; at
// y < -88 the exponential is inf and the result 0, as it should be).
__device__ __forceinline__ float sigmoid(float y) { return rcp_approx(1.0f + __expf(-y)); }

__device__ __forceinline__ float swish(float y) { return y * sigmoid(y); }

// The gradient of the float32 affine output y_pre = xh * w + b, given the
// output gradient g: without the Swish it is g; with it, autograd's chain
// through y = T(y_pre), s = sigmoid(y), out = y * s in dtype T:
//   g * s + sigmoid_backward(g * y, s), each op rounded to T.
template <typename T>
__device__ __forceinline__ float affine_grad(float xh, float w, float b, float g, bool sw) {
  if (!sw) return g;
  const float y = round_to<T>(xh * w + b);
  const float s = round_to<T>(sigmoid(y));
  const float through_s = round_to<T>(round_to<T>(g * y) * (1.0f - s) * s);
  return round_to<T>(round_to<T>(g * s) + through_s);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__host__ __device__ inline int slab_bytes(int rows, int s, int isz) {
  return (rows * s * isz + 15) / 16 * 16;
}

// Shared memory of one block, as gn_plan computes it: `slabs` slabs of
// rows x S values (x; the backward also dy), then 2 * threads + 10 * S floats.
__host__ __device__ inline int smem_bytes(int rows, int s, int threads, int isz, int slabs) {
  return slabs * slab_bytes(rows, s, isz) + 4 * (2 * threads + 10 * s);
}

// Position of channel c in a per-channel array laid out for the 16-byte
// passes: chunk column k = c / V, element j = c % V at [j * cpr + k], so the
// lanes of a warp (consecutive k) read consecutive banks.
__device__ __forceinline__ int chunk_major(int c, int cpr, int v) {
  return (c % v) * cpr + c / v;
}

// Where this block sits: sample, first channel of the slice, first row and
// number of rows, and the element offset of (sample, row0, c0).
struct Item {
  int bi, c0, row0, nrows;
  long long base;
};

__device__ __forceinline__ Item locate(const cg::cluster_group& cluster, int item, int hw, int c,
                                       int s, int rows) {
  const int slices = c / s;
  Item it;
  it.bi = item / slices;
  it.c0 = (item - it.bi * slices) * s;
  it.row0 = (int)cluster.block_rank() * rows;
  it.nrows = max(0, min(rows, hw - it.row0));
  it.base = ((long long)it.bi * hw + it.row0) * c + it.c0;
  return it;
}

// Rows x S values of src (row stride C) into dst, 16 bytes per cp.async.
// The block's threads are a multiple of the row's cpr = S / V chunks, so a
// thread keeps one chunk column k and steps over rows: no division.
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* src, const Item& it, int c, int s) {
  constexpr int V = 16 / (int)sizeof(T);
  const int cpr = s / V, k = threadIdx.x % cpr, step = blockDim.x / cpr;
  const T* from = src + it.base + (long long)(threadIdx.x / cpr) * c + k * V;
  for (int r = threadIdx.x / cpr; r < it.nrows; r += step, from += (long long)step * c)
    cp_async16(dst + r * s + k * V, from, true);
}

// Per-channel sums over the cluster. Each thread passes its two sums for
// channel threadIdx.x % S; thread c < S gets the cluster's totals in
// tot[c], tot[S + c] (threads' sums in thread order, then blocks' in rank
// order). Other blocks read `part` after the cluster barrier; the caller
// arrives at the exit barrier once this returns and waits on it at the end.
__device__ void cluster_channel_sums(const cg::cluster_group& cluster, float a, float b,
                                     float* red, float* part, float* tot, int s) {
  const int t = threadIdx.x, nt = blockDim.x;
  red[t] = a;
  red[nt + t] = b;
  __syncthreads();
  if (t < s) {
    float sa = 0.f, sb = 0.f;
    for (int l = t; l < nt; l += s) {
      sa += red[l];
      sb += red[nt + l];
    }
    part[t] = sa;
    part[s + t] = sb;
  }
  cluster.sync();
  if (t < s) {
    // four ranks' remote loads in flight together, then their sums in order
    const int cs = (int)cluster.num_blocks();
    float sa = 0.f, sb = 0.f;
    for (int r0 = 0; r0 < cs; r0 += 4) {
      float va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < cs) {
          const float* rp = cluster.map_shared_rank(part, r0 + j);
          va[j] = rp[t];
          vb[j] = rp[s + t];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < cs) {
          sa += va[j];
          sb += vb[j];
        }
      }
    }
    tot[t] = sa;
    tot[s + t] = sb;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
              T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int hw, int c, int g, int s, int rows, float eps, int apply_swish) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, nt = blockDim.x;
  const Item it = locate(cluster, blockIdx.x / (int)cluster.num_blocks(), hw, c, s, rows);
  T* slab = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + slab_bytes(rows, s, (int)sizeof(T)));
  float* part = red + 2 * nt;
  float* tot = part + 2 * s;
  float* p_mean = tot + 2 * s;  // chunk-major per-channel mean, rstd * w, b
  float* p_scale = p_mean + s;
  float* p_shift = p_scale + s;

  load_slab(slab, x, it, c, s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float sx = 0.f, sxx = 0.f;
  for (int i = t; i < it.nrows * s; i += nt) {
    const float v = to_f(slab[i]);
    sx += v;
    sxx += v * v;
  }
  cluster_channel_sums(cluster, sx, sxx, red, part, tot, s);
  cluster_arrive();  // no remote read of `part` follows; wait before exit

  const int cg_ = c / g, cpr = s / V;
  if (t < s) {
    const int first = t - t % cg_;
    float gx = 0.f, gxx = 0.f;
    for (int j = first; j < first + cg_; ++j) {
      gx += tot[j];
      gxx += tot[s + j];
    }
    const float n = (float)hw * (float)cg_;
    const float mean = gx / n;
    const float rstd = rsqrtf(gxx / n - mean * mean + eps);
    const int at = chunk_major(t, cpr, V);
    p_mean[at] = mean;
    p_scale[at] = rstd * to_f(w[it.c0 + t]);
    p_shift[at] = to_f(bias[it.c0 + t]);
    if (mean_out != nullptr && cluster.block_rank() == 0 && t == first) {
      const int gi = it.bi * g + (it.c0 + t) / cg_;
      mean_out[gi] = mean;
      rstd_out[gi] = rstd;
    }
  }
  __syncthreads();

  // 16-byte chunks; threads % cpr == 0, so each thread keeps one column k
  // and steps over rows.
  const int k = t % cpr, step = nt / cpr;
  float m[V], sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = p_mean[j * cpr + k];
    sc[j] = p_scale[j * cpr + k];
    sh[j] = p_shift[j * cpr + k];
  }
  T* to = y + it.base + (long long)(t / cpr) * c + k * V;
  for (int r = t / cpr; r < it.nrows; r += step, to += (long long)step * c) {
    const uint4 in = *reinterpret_cast<const uint4*>(slab + r * s + k * V);
    uint4 out;
    const T* xe = reinterpret_cast<const T*>(&in);
    T* ye = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      T v = from_f<T>((to_f(xe[j]) - m[j]) * sc[j] + sh[j]);
      if (apply_swish) v = from_f<T>(swish(to_f(v)));
      ye[j] = v;
    }
    *reinterpret_cast<uint4*>(to) = out;
  }
  cluster_wait();
}

// Two blocks an SM: at most 64 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w,
              const T* __restrict__ bias, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ ws,
              int hw, int c, int g, int s, int rows, int apply_swish) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, nt = blockDim.x;
  const bool sw = apply_swish != 0;
  const Item it = locate(cluster, blockIdx.x / (int)cluster.num_blocks(), hw, c, s, rows);
  const int slab = slab_bytes(rows, s, (int)sizeof(T));
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + slab);
  float* red = reinterpret_cast<float*>(smem + 2 * slab);
  float* part = red + 2 * nt;
  float* tot = part + 2 * s;
  float* p_mean = tot + 2 * s;  // chunk-major per-channel mean, rstd, w, k1, k2
  float* p_rstd = p_mean + s;
  float* p_w = p_rstd + s;
  float* p_k1 = p_w + s;
  float* p_k2 = p_k1 + s;

  load_slab(xs, x, it, c, s);
  load_slab(gs, dy, it, c, s);
  cp_async_commit();
  const int cg_ = c / g, cpr = s / V;
  // this thread's channel in the sums below (threads % S == 0)
  const int ch = t % s;
  const int gi = it.bi * g + (it.c0 + ch) / cg_;
  const float mu = mean[gi], rs = rstd[gi];
  const float wc = to_f(w[it.c0 + ch]), bc = to_f(bias[it.c0 + ch]);
  cp_async_wait<0>();
  __syncthreads();

  // dyp is a value of T (the Swish's chain ends rounded to T; without it
  // dyp = dy), so it replaces dy in place: the dx pass reads it back.
  float sa = 0.f, sb = 0.f;
  for (int i = t; i < it.nrows * s; i += nt) {
    const float xh = (to_f(xs[i]) - mu) * rs;
    const float d = affine_grad<T>(xh, wc, bc, to_f(gs[i]), sw);
    if (sw) gs[i] = from_f<T>(d);
    sa += d;
    sb += d * xh;
  }
  cluster_channel_sums(cluster, sa, sb, red, part, tot, s);
  cluster_arrive();  // no remote read of `part` follows; wait before exit

  if (t < s) {
    if (cluster.block_rank() == 0) {
      ws[(2LL * it.bi) * c + it.c0 + t] = tot[t];
      ws[(2LL * it.bi + 1) * c + it.c0 + t] = tot[s + t];
    }
    const int first = t - t % cg_;
    float k1 = 0.f, k2 = 0.f;
    for (int j = first; j < first + cg_; ++j) {
      const float wj = to_f(w[it.c0 + j]);
      k1 += wj * tot[j];
      k2 += wj * tot[s + j];
    }
    const float n = (float)hw * (float)cg_;
    const int at = chunk_major(t, cpr, V);
    p_mean[at] = mu;
    p_rstd[at] = rs;
    p_w[at] = wc;
    p_k1[at] = k1 / n;
    p_k2[at] = k2 / n;
  }
  __syncthreads();

  const int k = t % cpr, step = nt / cpr;
  T* to = dx + it.base + (long long)(t / cpr) * c + k * V;
  for (int r = t / cpr; r < it.nrows; r += step, to += (long long)step * c) {
    const uint4 xin = *reinterpret_cast<const uint4*>(xs + r * s + k * V);
    const uint4 gin = *reinterpret_cast<const uint4*>(gs + r * s + k * V);
    uint4 out;
    const T* xe = reinterpret_cast<const T*>(&xin);
    const T* ge = reinterpret_cast<const T*>(&gin);
    T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int at = j * cpr + k;
      const float r_ = p_rstd[at], w_ = p_w[at];
      const float xh = (to_f(xe[j]) - p_mean[at]) * r_;
      const float dxh = to_f(ge[j]) * w_;  // dyp, from the sums' pass
      oe[j] = from_f<T>(r_ * (dxh - p_k1[at] - xh * p_k2[at]));
    }
    *reinterpret_cast<uint4*>(to) = out;
  }
  cluster_wait();
}

// dbias[c] = sum_b ws[b, 0, c], dweight[c] = sum_b ws[b, 1, c], b in order.
__global__ void gn_wb_kernel(const float* __restrict__ ws, float* __restrict__ dweight,
                             float* __restrict__ dbias, int nb, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float sa = 0.f, sb = 0.f;
  for (int b = 0; b < nb; ++b) {
    sa += ws[(2LL * b) * c + ch];
    sb += ws[(2LL * b + 1) * c + ch];
  }
  dbias[ch] = sa;
  dweight[ch] = sb;
}

// Clusters of up to 16 blocks (16 is non-portable) and up to kSmemLimit
// bytes of dynamic shared memory; set once per kernel.
template <typename K>
cudaError_t prepare(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemLimit);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel,
                                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <typename T>
void* kernel_of(int backward) {
  return backward ? (void*)gn_bwd_kernel<T> : (void*)gn_fwd_kernel<T>;
}

template <typename T>
cudaError_t prepare_all() {
  static cudaError_t state = [] {
    cudaError_t e = prepare(gn_fwd_kernel<T>);
    return e == cudaSuccess ? prepare(gn_bwd_kernel<T>) : e;
  }();
  return state;
}

struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Launch(int blocks, int cs, int threads, int smem, cudaStream_t stream) : cfg{}, attr{} {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The plan's arguments, checked against what the kernels assume.
bool plan_ok(int c, int g, int s, int cs, int rows, int hw, int threads, int smem, int isz,
             int slabs) {
  const int v = 16 / isz;
  return g > 0 && c % g == 0 && s > 0 && c % s == 0 && s % (c / g) == 0 && s % v == 0 &&
         cs >= 1 && cs <= kMaxCluster && rows > 0 && (long long)rows * cs >= hw && threads > 0 &&
         threads <= kMaxThreads && threads % s == 0 &&
         smem == smem_bytes(rows, s, threads, isz, slabs) && smem <= kSmemLimit;
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const void* b, void* y, float* mean, float* rstd,
                int nb, int hw, int c, int g, int s, int cs, int rows, int threads, int smem,
                float eps, int sw, cudaStream_t stream) {
  if (!plan_ok(c, g, s, cs, rows, hw, threads, smem, (int)sizeof(T), 1))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare_all<T>();
  if (e != cudaSuccess) return e;
  Launch l(nb * (c / s) * cs, cs, threads, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, gn_fwd_kernel<T>, static_cast<const T*>(x),
                         static_cast<const T*>(w), static_cast<const T*>(b), static_cast<T*>(y),
                         mean, rstd, hw, c, g, s, rows, eps, sw);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* dy, const void* w, const void* b, const float* mean,
                const float* rstd, void* dx, float* ws, float* dweight, float* dbias, int nb,
                int hw, int c, int g, int s, int cs, int rows, int threads, int smem, int sw,
                cudaStream_t stream) {
  if (!plan_ok(c, g, s, cs, rows, hw, threads, smem, (int)sizeof(T), 2))
    return cudaErrorInvalidValue;
  cudaError_t e = prepare_all<T>();
  if (e != cudaSuccess) return e;
  Launch l(nb * (c / s) * cs, cs, threads, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, gn_bwd_kernel<T>, static_cast<const T*>(x),
                         static_cast<const T*>(dy), static_cast<const T*>(w),
                         static_cast<const T*>(b), mean, rstd, static_cast<T*>(dx), ws, hw, c,
                         g, s, rows, sw);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_wb_kernel<<<(c + 255) / 256, 256, 0, stream>>>(ws, dweight, dbias, nb, c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t max_clusters(int backward, int cs, int threads, int smem, int* out) {
  cudaError_t e = prepare_all<T>();
  if (e != cudaSuccess) return e;
  Launch l(cs, cs, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(out, kernel_of<T>(backward), &l.cfg);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x, y: [B, HW, C] contiguous; w, b: [C]
// in x's dtype; mean, rstd: null, or float32 [B, G] to receive the
// statistics. s, cs, rows, threads, smem: the plan (gn_plan); one cluster per
// (sample, slice). Returns the cudaError_t of the launch, 0 on success. Does
// not synchronise.
int srewd_gn_swish_fwd(const void* x, const void* w, const void* b, void* y, float* mean,
                       float* rstd, int nb, int hw, int c, int g, int s, int cs, int rows,
                       int threads, int smem, float eps, int apply_swish, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(x, w, b, y, mean, rstd, nb, hw, c, g, s, cs, rows, threads, smem,
                           eps, apply_swish, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(x, w, b, y, mean, rstd, nb, hw, c, g, s, cs, rows, threads,
                                   smem, eps, apply_swish, st);
  return (int)cudaErrorInvalidValue;
}

// dx [B, HW, C] in x's dtype; ws float32 [B, 2, C] scratch; dweight, dbias
// float32 [C]. mean, rstd: the forward's statistics. Two launches.
int srewd_gn_swish_bwd(const void* x, const void* dy, const void* w, const void* b,
                       const float* mean, const float* rstd, void* dx, float* ws,
                       float* dweight, float* dbias, int nb, int hw, int c, int g, int s,
                       int cs, int rows, int threads, int smem, int apply_swish, int dtype,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd<float>(x, dy, w, b, mean, rstd, dx, ws, dweight, dbias, nb, hw, c, g, s,
                           cs, rows, threads, smem, apply_swish, st);
  if (dtype == 1)
    return (int)bwd<__nv_bfloat16>(x, dy, w, b, mean, rstd, dx, ws, dweight, dbias, nb, hw, c,
                                   g, s, cs, rows, threads, smem, apply_swish, st);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cs` blocks (threads, smem bytes each) the card can
// hold at once (cudaOccupancyMaxActiveClusters) into *out.
int srewd_gn_max_clusters(int backward, int dtype, int cs, int threads, int smem, int* out) {
  if (dtype == 0) return (int)max_clusters<float>(backward, cs, threads, smem, out);
  if (dtype == 1) return (int)max_clusters<__nv_bfloat16>(backward, cs, threads, smem, out);
  return (int)cudaErrorInvalidValue;
}

const char* srewd_gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
