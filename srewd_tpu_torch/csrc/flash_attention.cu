// Exact single-head attention O = softmax(scale * Q K^T) V for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` in srewd_tpu/ops/flash_attention.py
// (body `_kernel`). That kernel keeps the whole K and V of a sample in VMEM
// and takes a full-row softmax; at the largest phydiff map (N=8192, D=64) K
// and V are 2 MB in float32, far beyond the 227 KB of shared memory a block
// may use here. So this kernel tiles K and V and keeps an online softmax:
// per query row a running max m and sum l, and a float32 output accumulator
// rescaled by exp(m_old - m_new) whenever the max moves, normalised by l at
// the end. One block per (query tile, batch element) loops over the K/V
// tiles; that loop replaces the TPU's sequential grid dimension.
//
// What bounds it on the card: this first version multiplies on the CUDA
// cores in float32 (no tensor cores), so it is bound by shared-memory loads
// feeding the FMAs, not by device memory (Q, K, V are read once per query
// tile and O written once). Each thread keeps a small register tile (R rows
// x 1 key for Q K^T, R rows x DC columns for P V) so that one shared-memory
// load feeds several FMAs; K rows are padded by one float so the threads of
// a warp, each on its own key, hit distinct banks. wgmma, TMA and warp
// specialisation are later work.
//
// Numerics: scores, softmax and the P V sums are float32; inputs float32 or
// bfloat16; the output is written in Q's dtype. The TPU kernel casts the
// NORMALISED probabilities to V's dtype before P V; an online softmax has no
// normalised P before the end, so here P stays float32. In float32 the two
// agree to rounding; in bfloat16 this kernel is the more exact one.
//
// Layout: q, k, v are [B, N, D] with unit stride along D and arbitrary batch
// and row strides (in elements), so the wrapper passes the strided views the
// 1x1 qkv / kv convolutions produce (row stride 3C or 2C) without a copy. The
// output is a contiguous [B, N, D] tensor the wrapper allocates.
//
// Training: with a non-null `lse` the kernel also writes each query row's
// log-sum-exp m + log(l) of the scaled scores, float32 [B, N], which the
// backward (flash_attention_bwd.cu) uses to recompute P. The sampling path
// passes null and nothing else changes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long q_b, q_r, k_b, k_r, v_b, v_r;
};

// Shared memory (floats): Qs[BQ][D] | Ks[BK][D+1] | Vs[BK][D] | S[BQ][BK] | m, l, alpha [BQ]
template <int D, int BQ, int BK>
struct Smem {
  static constexpr int kQ = BQ * D;
  static constexpr int kK = BK * (D + 1);
  static constexpr int kV = BK * D;
  static constexpr int kS = BQ * BK;
  static constexpr int kFloats = kQ + kK + kV + kS + 3 * BQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, Strides st, float scale) {
  static_assert(kThreads % BK == 0, "BK must divide the block");
  static_assert((BQ * BK) % kThreads == 0, "score tile must split evenly");
  constexpr int TD = D < kThreads ? D : kThreads;  // threads along D in P V
  constexpr int TR = kThreads / TD;                 // threads along rows in P V
  constexpr int DC = D / TD;                        // columns per thread
  constexpr int RO = BQ / TR;                       // output rows per thread
  constexpr int RS = BQ * BK / kThreads;            // score rows per thread
  constexpr int SR = kThreads / BK;                 // row step in the score tile
  constexpr int kWarps = kThreads / 32;
  static_assert(BQ % TR == 0 && BQ % kWarps == 0, "bad tile");

  extern __shared__ float smem[];
  using S_ = Smem<D, BQ, BK>;
  float* Qs = smem;
  float* Ks = Qs + S_::kQ;
  float* Vs = Ks + S_::kK;
  float* Ss = Vs + S_::kV;
  float* row_m = Ss + S_::kS;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + b * st.q_b;
  const T* kb = k + b * st.k_b;
  const T* vb = v + b * st.v_b;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = q0 + r;
    Qs[idx] = row < n ? to_f32(qb[row * st.q_r + c]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[RO][DC];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  const int o_col = tid % TD;  // first output column of this thread
  const int o_row = tid / TD;  // first output row of this thread
  const int s_col = tid % BK;  // key of this thread in the score tile
  const int s_row = tid / BK;  // first query row of this thread in the score tile

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile's P V done (and Q / stats loaded)
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int key = k0 + r;
      const bool ok = key < n;
      Ks[r * (D + 1) + c] = ok ? to_f32(kb[key * st.k_r + c]) : 0.f;
      Vs[idx] = ok ? to_f32(vb[key * st.v_r + c]) : 0.f;
    }
    __syncthreads();

    // S = scale * Q K^T for this tile, RS rows x 1 key per thread
    {
      float s[RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) s[r] = 0.f;
      const float* kr = Ks + s_col * (D + 1);
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float kv = kr[c];
#pragma unroll
        for (int r = 0; r < RS; ++r) s[r] = fmaf(Qs[(s_row + r * SR) * D + c], kv, s[r]);
      }
      const bool valid = k0 + s_col < n;
#pragma unroll
      for (int r = 0; r < RS; ++r)
        Ss[(s_row + r * SR) * BK + s_col] = valid ? s[r] * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp per row, lanes across the tile's keys
    for (int r = warp; r < BQ; r += kWarps) {
      float* sr = Ss + r * BK;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V, RO rows x DC columns per thread
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float a = row_a[o_row + r * TR];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= a;
    }
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * D + o_col + c * TD];
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float p = Ss[(o_row + r * TR) * BK + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = q0 + o_row + r * TR;
    if (row >= n) continue;
    const float inv_l = 1.f / row_l[o_row + r * TR];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_as(o + ((long long)b * n + row) * D + o_col + c * TD, acc[r][c] * inv_l);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < n)
    lse[(long long)b * n + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, int n, Strides st, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, BQ, BK>;
  const size_t bytes = Smem<D, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BQ - 1) / BQ, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, st, scale);
  return cudaGetLastError();
}

// Tile sizes per head width, chosen so Q, K, V, the score tile and the row
// statistics fit the dynamic shared-memory limit (largest: D=512, 166 KB).
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int n, Strides st, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, 64, 64>(q, k, v, o, lse, b, n, st, scale, stream);
    case 128: return launch<T, 128, 32, 64>(q, k, v, o, lse, b, n, st, scale, stream);
    case 256: return launch<T, 256, 32, 32>(q, k, v, o, lse, b, n, st, scale, stream);
    case 512: return launch<T, 512, 16, 32>(q, k, v, o, lse, b, n, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `lse`: null, or float32 [B, N] for the
// rows' log-sum-exp. Returns the cudaError_t of the launch
// (cudaGetLastError() right after it), 0 on success. Does not synchronise.
int srewd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, int b, int n, int d, long long q_b, long long q_r,
                              long long k_b, long long k_r, long long v_b,
                              long long v_r, float scale, int dtype, void* stream) {
  Strides st{q_b, q_r, k_b, k_r, v_b, v_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(d, q, k, v, o, lse, b, n, st, scale, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(d, q, k, v, o, lse, b, n, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* srewd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
