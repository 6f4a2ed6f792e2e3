// Backward of exact single-head attention O = softmax(scale * Q K^T) V, for
// Hopper (sm_90a): dQ, dK and dV from Q, K, V, O, dO and the forward's row
// log-sum-exp.
//
// Replaces the TPU kernel `_flash_bwd` in srewd_tpu/ops/flash_attention.py
// (:173, body `_bwd_kernel` :131), which keeps the whole K and V of a sample
// and three [QB, N] float32 slabs (P, dP, dS) in VMEM and carries dK / dV
// from one query block to the next along a sequential grid axis. Hopper
// blocks run in no order and a block has 227 KB of shared memory, so this
// is the FA2 layout instead:
//   * the forward (flash_attention.cu) saves LSE = m + log(l) per query row,
//     so P = exp(scale * Q K^T - LSE) is recomputed tile by tile with no
//     row-wide softmax;
//   * Δ_i = rowsum(dO_i ∘ O_i), one warp per row, before the two main
//     kernels. The TPU kernel takes rowsum(P ∘ dP) over the whole key row;
//     the two are equal in exact arithmetic. In float32 they agree to
//     rounding; in bfloat16 O is the stored (rounded) output, so Δ carries
//     O's rounding (chip_smoke.py's bf16 tolerance says so);
//   * dK / dV: one block per (key tile, sample) loops over all query tiles
//     and keeps its dK and dV tile in float32 registers: the loop replaces
//     the TPU's sequential grid axis, and no two blocks write one row;
//   * dQ: a second kernel, one block per (query tile, sample), loops over
//     all key tiles and keeps its dQ tile in registers. It recomputes P and
//     dS rather than adding into dQ with float32 atomics from the dK / dV
//     kernel: the result is deterministic, needs no zeroed scratch buffer,
//     and this first version trades the extra work for that.
//
// What bounds it: counted for this design, 14 * B * N^2 * D flops (the
// dK / dV kernel does Q K^T, dO V^T, P^T dO and dS^T Q; the dQ kernel Q K^T,
// dO V^T and dS K, 2 * N^2 * D each), 240 GFLOP at N=8192, D=64, B=4, against
// 5 * B * N * D * bytes of device traffic: it is bound by operations. This
// version multiplies on the CUDA cores in float32, like the forward. The
// products read their operands from shared memory, so each thread keeps a
// register tile (4 x 4 scores per thread at D=64; 4 columns of D times 4-8
// rows in the products) so that one shared-memory load feeds 2 FMAs; all
// tiles are padded by one float so that a warp's loads hit distinct banks.
// Tensor cores (mma.sync / wgmma) are later work.
//
// Numerics: all sums are float32, inputs float32 or bfloat16, dQ / dK / dV
// are written in the inputs' dtype, as `_flash_bwd` casts its float32
// results. Layout: q, k, v are [B, N, D] with unit stride along D and any
// batch and row stride (the 1x1 qkv / kv convolutions' slabs); o and dO are
// contiguous [B, N, D]; lse and the Δ scratch are float32 [B, N]; the
// outputs are contiguous [B, N, D]. The wrapper allocates every buffer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTK = 16;              // threads across keys in a score tile
constexpr int kTQ = kThreads / kTK;  // threads across query rows in a score tile
constexpr int kDC = 4;               // columns of D per thread in the products

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Strides {
  long long q_b, q_r, k_b, k_r, v_b, v_r;
};

// Shared memory (floats): Qs, dOs [BQ][D+1] | Ks, Vs [BK][D+1] |
// Ps, dSs [BQ][BK+1] | lse, delta [BQ]
template <int D, int BQ, int BK>
struct Tiles {
  static constexpr int LD = D + 1;
  static constexpr int LS = BK + 1;
  static constexpr int kQ = BQ * LD;
  static constexpr int kK = BK * LD;
  static constexpr int kS = BQ * LS;
  static constexpr int kFloats = 2 * kQ + 2 * kK + 2 * kS + 2 * BQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// rows [row0, row0 + rows) of a [N, D] matrix with unit column stride into a
// padded float32 tile; rows past n read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int row0, int rows, int n) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] = row < n ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

// For the (query tile, key tile) in shared memory, writes
//   P  = exp(scale * Q K^T - lse)          to Ps,
//   dS = P * (dO V^T - delta) * scale       to dSs.
// Each thread owns RQ query rows x RK keys of the tile (rows ty + r*kTQ,
// keys tx + k*kTK). Rows past n carry lse = +inf (P = 0); keys at or past
// `keys_left` get P = 0.
template <int D, int BQ, int BK>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs, const float* Ks,
                                            const float* Vs, const float* lse_s,
                                            const float* delta_s, float* Ps, float* dSs,
                                            int keys_left, float scale) {
  constexpr int RK = BK / kTK;
  constexpr int RQ = BQ / kTQ;
  constexpr int LD = D + 1, LS = BK + 1;
  static_assert(BK % kTK == 0 && BQ % kTQ == 0, "score tile must split evenly");
  const int tx = threadIdx.x % kTK, ty = threadIdx.x / kTK;
  float s[RQ][RK], dp[RQ][RK];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int k = 0; k < RK; ++k) s[r][k] = dp[r][k] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float kk[RK], vv[RK], qq[RQ], gg[RQ];
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      kk[k] = Ks[(tx + k * kTK) * LD + c];
      vv[k] = Vs[(tx + k * kTK) * LD + c];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      qq[r] = Qs[(ty + r * kTQ) * LD + c];
      gg[r] = dOs[(ty + r * kTQ) * LD + c];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        s[r][k] = fmaf(qq[r], kk[k], s[r][k]);
        dp[r][k] = fmaf(gg[r], vv[k], dp[r][k]);
      }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = ty + r * kTQ;
    const float l = lse_s[i], dl = delta_s[i];
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const int j = tx + k * kTK;
      const float p = j < keys_left ? expf(s[r][k] * scale - l) : 0.f;
      Ps[i * LS + j] = p;
      dSs[i * LS + j] = p * (dp[r][k] - dl) * scale;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (long long)row * d;
  const T* grow = dout + (long long)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(orow[c]), to_f32(grow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int n, Strides st, float scale) {
  using S_ = Tiles<D, BQ, BK>;
  constexpr int LD = S_::LD, LS = S_::LS;
  constexpr int TD = D / kDC;        // threads along D
  constexpr int TR = kThreads / TD;  // threads along keys
  constexpr int RO = BK / TR;        // keys per thread
  static_assert(BK % TR == 0, "bad key tile");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + S_::kQ;
  float* Ks = dOs + S_::kQ;
  float* Vs = Ks + S_::kK;
  float* Ps = Vs + S_::kK;
  float* dSs = Ps + S_::kS;
  float* lse_s = dSs + S_::kS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const T* qb = q + b * st.q_b;
  const T* dob = dout + (long long)b * n * D;
  const float* lseb = lse + (long long)b * n;
  const float* deltab = delta + (long long)b * n;

  load_tile<T, D>(Ks, k + b * st.k_b + (long long)k0 * st.k_r, st.k_r, 0, BK, n - k0);
  load_tile<T, D>(Vs, v + b * st.v_b + (long long)k0 * st.v_r, st.v_r, 0, BK, n - k0);

  const int cx = tid % TD;  // first column of this thread
  const int kr = tid / TD;  // first key row of this thread
  float acc_k[RO][kDC], acc_v[RO][kDC];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int m = 0; m < kDC; ++m) acc_k[r][m] = acc_v[r][m] = 0.f;

  for (int q0 = 0; q0 < n; q0 += BQ) {
    __syncthreads();  // the previous query tile's products are done
    load_tile<T, D>(Qs, qb, st.q_r, q0, BQ, n);
    load_tile<T, D>(dOs, dob, D, q0, BQ, n);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < n ? lseb[row] : INFINITY;
      delta_s[tid] = row < n ? deltab[row] : 0.f;
    }
    __syncthreads();
    score_tiles<D, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, n - k0, scale);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over this tile's query rows
    for (int i = 0; i < BQ; ++i) {
      float g[kDC], x[kDC];
#pragma unroll
      for (int m = 0; m < kDC; ++m) {
        g[m] = dOs[i * LD + cx + m * TD];
        x[m] = Qs[i * LD + cx + m * TD];
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const int j = kr + r * TR;
        const float p = Ps[i * LS + j];
        const float ds = dSs[i * LS + j];
#pragma unroll
        for (int m = 0; m < kDC; ++m) {
          acc_v[r][m] = fmaf(p, g[m], acc_v[r][m]);
          acc_k[r][m] = fmaf(ds, x[m], acc_k[r][m]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int key = k0 + kr + r * TR;
    if (key >= n) continue;
    const long long base = ((long long)b * n + key) * D + cx;
#pragma unroll
    for (int m = 0; m < kDC; ++m) {
      store_as(dk + base + m * TD, acc_k[r][m]);
      store_as(dv + base + m * TD, acc_v[r][m]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n, Strides st, float scale) {
  using S_ = Tiles<D, BQ, BK>;
  constexpr int LD = S_::LD, LS = S_::LS;
  constexpr int TD = D / kDC;        // threads along D
  constexpr int TR = kThreads / TD;  // threads along query rows
  constexpr int RO = BQ / TR;        // query rows per thread
  static_assert(BQ % TR == 0, "bad query tile");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + S_::kQ;
  float* Ks = dOs + S_::kQ;
  float* Vs = Ks + S_::kK;
  float* Ps = Vs + S_::kK;
  float* dSs = Ps + S_::kS;
  float* lse_s = dSs + S_::kS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + b * st.k_b;
  const T* vb = v + b * st.v_b;

  load_tile<T, D>(Qs, q + b * st.q_b, st.q_r, q0, BQ, n);
  load_tile<T, D>(dOs, dout + (long long)b * n * D, D, q0, BQ, n);
  if (tid < BQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < n ? lse[(long long)b * n + row] : INFINITY;
    delta_s[tid] = row < n ? delta[(long long)b * n + row] : 0.f;
  }

  const int cx = tid % TD;  // first column of this thread
  const int qr = tid / TD;  // first query row of this thread
  float acc[RO][kDC];
#pragma unroll
  for (int r = 0; r < RO; ++r)
#pragma unroll
    for (int m = 0; m < kDC; ++m) acc[r][m] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous key tile's products are done
    load_tile<T, D>(Ks, kb, st.k_r, k0, BK, n);
    load_tile<T, D>(Vs, vb, st.v_r, k0, BK, n);
    __syncthreads();
    score_tiles<D, BQ, BK>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, n - k0, scale);
    __syncthreads();
    // dQ += dS K over this tile's keys
    for (int j = 0; j < BK; ++j) {
      float kk[kDC];
#pragma unroll
      for (int m = 0; m < kDC; ++m) kk[m] = Ks[j * LD + cx + m * TD];
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float ds = dSs[(qr + r * TR) * LS + j];
#pragma unroll
        for (int m = 0; m < kDC; ++m) acc[r][m] = fmaf(ds, kk[m], acc[r][m]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = q0 + qr + r * TR;
    if (row >= n) continue;
    const long long base = ((long long)b * n + row) * D + cx;
#pragma unroll
    for (int m = 0; m < kDC; ++m) store_as(dq + base + m * TD, acc[r][m]);
  }
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int n, Strides st, float scale, cudaStream_t stream) {
  const int rows = b * n;
  flash_bwd_delta_kernel<T><<<(rows * 32 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t bytes = Tiles<D, BQ, BK>::kBytes;
  auto dkdv = flash_bwd_dkdv_kernel<T, D, BQ, BK>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((n + BK - 1) / BK, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n,
      st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D, BQ, BK>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((n + BQ - 1) / BQ, b), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), n, st, scale);
  return cudaGetLastError();
}

// Tile sizes per head width, so that the padded Q, dO, K, V, P and dS tiles
// fit the dynamic shared-memory limit (D=64: 100 KB, two blocks per SM;
// D=128: 116 KB; D=256: 140 KB; D=512: 134 KB).
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int b, int n, Strides st, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st, scale,
                                   stream);
    case 128:
      return launch<T, 128, 32, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st, scale,
                                    stream);
    case 256:
      return launch<T, 256, 32, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st, scale,
                                    stream);
    case 512:
      return launch<T, 512, 16, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `delta` is float32 [B, N] scratch.
// Returns the cudaError_t of the launches (cudaGetLastError() after each),
// 0 on success. Does not synchronise.
int srewd_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int b, int n, int d, long long q_b,
                              long long q_r, long long k_b, long long k_r, long long v_b,
                              long long v_r, float scale, int dtype, void* stream) {
  Strides st{q_b, q_r, k_b, k_r, v_b, v_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, o, dout, lse, delta, dq, dk, dv, b, n, st,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* srewd_cuda_error_string_bwd(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
