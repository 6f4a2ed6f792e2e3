// Backward of exact single-head attention O = softmax(scale * Q K^T) V, for
// Hopper (sm_90a), on the tensor cores: dQ, dK and dV from Q, K, V, O, dO
// and the forward's row log-sum-exp.
//
// Replaces the TPU kernel `_flash_bwd` in srewd_tpu/ops/flash_attention.py
// (:173, body `_bwd_kernel` :131), which keeps the whole K and V of a sample
// and three [QB, N] float32 slabs (P, dP, dS) in VMEM and carries dK / dV
// from one query block to the next along a sequential grid axis. Hopper
// blocks run in no order and a block has 227 KB of shared memory, so this
// is the FA2 layout instead, in three launches:
//   * Δ_i = rowsum(dO_i ∘ O_i), one warp per row. The TPU kernel takes
//     rowsum(P ∘ dP) over the whole key row; the two are equal in exact
//     arithmetic and agree to float32 rounding, because O is the forward's
//     float32 O also in bfloat16 (K1's `o32`, before its rounding: from the
//     rounded O, Δ's error carried dQ beyond two bf16 ulps at D=512);
//   * dK / dV: one block per (key tile, sample) loops over all query tiles
//     and keeps its dK and dV tile in float32 registers. With the keys as
//     the rows, S^T = K Q^T and dP^T = V dO^T come out in the accumulator
//     layout, P^T = exp(scale S^T - LSE) and dS^T = P^T ∘ (dP^T - Δ) * scale
//     are formed there, and they are the A operands of dV += P^T dO and
//     dK += dS^T Q without passing through shared memory;
//   * dQ: one block per (query tile, sample) loops over all key tiles,
//     recomputes P and dS the same way and adds dS K into its dQ tile.
//     Recomputing instead of adding into dQ with float32 atomics from the
//     dK / dV kernel keeps the result deterministic (the trainer asks for
//     determinism, and a resumed run must repeat the first one's losses) and
//     needs no zeroed scratch buffer, at 14 instead of 10 B * N^2 * D flops.
//
// What bounds it: 10 * B * N^2 * D flops of the TPU's algorithm (14 in this
// design) against 8 * B * N * D elements of device traffic (q, k, v, o, dO
// read, dq, dk, dv written): operations at the tensor cores' rates, but for
// the N=128 shapes, which are bound by the bytes.
// Both main kernels use the building blocks of attention_mma.cuh: 3xTF32
// mma for float32 (float32-accurate), bf16 mma for bfloat16 (P and dS
// rounded to bf16 as the A operands, float32 sums), cp.async double
// buffering of the tiles they stream (Q, dO, LSE, Δ in the dK / dV kernel;
// K and V in the dQ kernel), and D split over WD warps at D >= 128 (dK/dV)
// or D >= 256 (dQ), whose partial S and dP tiles are summed through shared
// memory in a fixed order.
//
// Numerics: all sums are float32, inputs float32 or bfloat16, dQ / dK / dV
// are written in the inputs' dtype, as `_flash_bwd` casts its float32
// results. Layout: q, k, v are [B, N, D] with unit stride along D and any
// batch and row stride, 16-byte aligned (the 1x1 qkv / kv convolutions'
// slabs); o (float32) and dO are contiguous [B, N, D]; lse and the Δ scratch are
// float32 [B, N]; the outputs are contiguous [B, N, D]. The wrapper
// allocates every buffer and checks the alignment.

#include "attention_mma.cuh"

namespace {

using namespace srewd;

constexpr int kDeltaThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Strides {
  long long q_b, q_r, k_b, k_r, v_b, v_r;
};

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const float* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = (blockIdx.x * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + (long long)row * d;
  const T* grow = dout + (long long)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(orow[c], to_f32(grow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// A block: WM warps along its own rows (16 WM keys for dK/dV, queries for
// dQ), WD warps along D, and BS rows of the other side per streamed tile.
template <typename T, int D, int WM, int WD, int BS>
struct Bwd {
  static constexpr int kWarps = WM * WD;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BR = 16 * WM;  // own rows
  static constexpr int DW = D / WD;   // output columns of a warp
  static constexpr int NS = BS / 8;   // score tiles of a warp
  static constexpr int NO = DW / 8;   // output tiles of a warp
  static constexpr int LD = Pitch<T, D>::value;
  // shared memory: two own tiles [BR][LD] | two streamed tiles, double
  // buffered, [2][BS][LD] each | row statistics | slice sums of S and dP
  static constexpr size_t kOwn = sizeof(T) * BR * LD;
  static constexpr size_t kStream = sizeof(T) * BS * LD;
  static constexpr size_t kStats = sizeof(float) * 4 * (BR > BS ? BR : BS);
  static constexpr size_t kRed = WD > 1 ? sizeof(float) * kWarps * 2 * NS * 4 * 32 : 0;
  static constexpr size_t kBytes = 2 * kOwn + 4 * kStream + kStats + kRed;
};

template <typename T, int D, int WM, int WD, int BS>
__global__ void __launch_bounds__(Bwd<T, D, WM, WD, BS>::kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int n, Strides st, float scale) {
  using C = Bwd<T, D, WM, WD, BS>;
  constexpr int LD = C::LD, NS = C::NS, NO = C::NO, DW = C::DW, NT = C::kThreads;

  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + C::kOwn);
  T* Qs = reinterpret_cast<T*>(smem + 2 * C::kOwn);               // [2][BS][LD]
  T* dOs = reinterpret_cast<T*>(smem + 2 * C::kOwn + 2 * C::kStream);
  float* lse_s = reinterpret_cast<float*>(smem + 2 * C::kOwn + 4 * C::kStream);  // [2][BS]
  float* dl_s = lse_s + 2 * BS;                                                  // [2][BS]
  float* red = reinterpret_cast<float*>(smem + 2 * C::kOwn + 4 * C::kStream + C::kStats);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WD, wd = warp % WD;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * C::BR;
  const T* qb = q + b * st.q_b;
  const T* dob = dout + (long long)b * n * D;
  const float* lseb = lse + (long long)b * n;
  const float* deltab = delta + (long long)b * n;
  const int tiles = (n + BS - 1) / BS;

  load_tile_async<T, D, C::BR, NT>(Ks, k + b * st.k_b, st.k_r, k0, n);
  load_tile_async<T, D, C::BR, NT>(Vs, v + b * st.v_b, st.v_r, k0, n);
  load_tile_async<T, D, BS, NT>(Qs, qb, st.q_r, 0, n);
  load_tile_async<T, D, BS, NT>(dOs, dob, D, 0, n);
  load_rows_async<BS>(lse_s, lseb, 0, n);
  load_rows_async<BS>(dl_s, deltab, 0, n);
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
  zero(acc_k);
  zero(acc_v);
  const float sl2 = scale * kLog2e;
  const T* kw = Ks + wm * 16 * LD + wd * DW;
  const T* vw = Vs + wm * 16 * LD + wd * DW;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int s = (it + 1) & 1, r0 = (it + 1) * BS;
      load_tile_async<T, D, BS, NT>(Qs + s * BS * LD, qb, st.q_r, r0, n);
      load_tile_async<T, D, BS, NT>(dOs + s * BS * LD, dob, D, r0, n);
      load_rows_async<BS>(lse_s + s * BS, lseb, r0, n);
      load_rows_async<BS>(dl_s + s * BS, deltab, r0, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = it & 1;
    const T* qs = Qs + s * BS * LD;
    const T* dos = dOs + s * BS * LD;

    // S^T and dP^T: 16 keys x BS queries per warp
    float p[NS][4], ds[NS][4];
    zero(p);
    zero(ds);
    gemm_nk<T, NS, DW>(p, kw, LD, qs + wd * DW, LD);
    gemm_nk<T, NS, DW>(ds, vw, LD, dos + wd * DW, LD);
    sum_over_slices<NS, WD>(p, ds, red);

    const int q0 = it * BS;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * j + 2 * t + (i & 1);  // query of this column in the tile
        const float pv = q0 + c < n
                             ? exp2f(p[j][i] * sl2 - lse_s[s * BS + c] * kLog2e) : 0.f;
        p[j][i] = pv;
        ds[j][i] = pv * (ds[j][i] - dl_s[s * BS + c]) * scale;
      }

    gemm_acc_kn<T, NO, NS>(acc_v, p, dos + wd * DW, LD);   // dV += P^T dO
    gemm_acc_kn<T, NO, NS>(acc_k, ds, qs + wd * DW, LD);   // dK += dS^T Q
    __syncthreads();
  }

  const int row0 = k0 + wm * 16;
  store_rows<T, NO>(dk + (long long)b * n * D, acc_k, D, row0, wd * DW, n, 1.f, 1.f);
  store_rows<T, NO>(dv + (long long)b * n * D, acc_v, D, row0, wd * DW, n, 1.f, 1.f);
}

template <typename T, int D, int WM, int WD, int BS>
__global__ void __launch_bounds__(Bwd<T, D, WM, WD, BS>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n, Strides st, float scale) {
  using C = Bwd<T, D, WM, WD, BS>;
  constexpr int LD = C::LD, NS = C::NS, NO = C::NO, DW = C::DW, NT = C::kThreads;

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + C::kOwn);
  T* Ks = reinterpret_cast<T*>(smem + 2 * C::kOwn);                  // [2][BS][LD]
  T* Vs = reinterpret_cast<T*>(smem + 2 * C::kOwn + 2 * C::kStream);
  float* lse_s = reinterpret_cast<float*>(smem + 2 * C::kOwn + 4 * C::kStream);  // [BR]
  float* dl_s = lse_s + C::BR;                                                   // [BR]
  float* red = reinterpret_cast<float*>(smem + 2 * C::kOwn + 4 * C::kStream + C::kStats);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WD, wd = warp % WD;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * C::BR;
  const T* kb = k + b * st.k_b;
  const T* vb = v + b * st.v_b;
  const int tiles = (n + BS - 1) / BS;

  load_tile_async<T, D, C::BR, NT>(Qs, q + b * st.q_b, st.q_r, q0, n);
  load_tile_async<T, D, C::BR, NT>(dOs, dout + (long long)b * n * D, D, q0, n);
  load_rows_async<C::BR>(lse_s, lse + (long long)b * n, q0, n);
  load_rows_async<C::BR>(dl_s, delta + (long long)b * n, q0, n);
  load_tile_async<T, D, BS, NT>(Ks, kb, st.k_r, 0, n);
  load_tile_async<T, D, BS, NT>(Vs, vb, st.v_r, 0, n);
  cp_async_commit();

  float acc[NO][4];
  zero(acc);
  const float sl2 = scale * kLog2e;
  const T* qw = Qs + wm * 16 * LD + wd * DW;
  const T* dow = dOs + wm * 16 * LD + wd * DW;
  float row_lse[2] = {0.f, 0.f}, row_dl[2] = {0.f, 0.f};  // rows g, g + 8: after the first wait

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int s = (it + 1) & 1;
      load_tile_async<T, D, BS, NT>(Ks + s * BS * LD, kb, st.k_r, (it + 1) * BS, n);
      load_tile_async<T, D, BS, NT>(Vs + s * BS * LD, vb, st.v_r, (it + 1) * BS, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_lse[h] = lse_s[wm * 16 + g + 8 * h] * kLog2e;
        row_dl[h] = dl_s[wm * 16 + g + 8 * h];
      }
    }
    const T* ks = Ks + (it & 1) * BS * LD;
    const T* vs = Vs + (it & 1) * BS * LD;

    // S and dP: 16 queries x BS keys per warp
    float p[NS][4], ds[NS][4];
    zero(p);
    zero(ds);
    gemm_nk<T, NS, DW>(p, qw, LD, ks + wd * DW, LD);
    gemm_nk<T, NS, DW>(ds, dow, LD, vs + wd * DW, LD);
    sum_over_slices<NS, WD>(p, ds, red);

    const int k0 = it * BS;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const float pv = k0 + 8 * j + 2 * t + (i & 1) < n
                             ? exp2f(p[j][i] * sl2 - row_lse[h]) : 0.f;
        ds[j][i] = pv * (ds[j][i] - row_dl[h]) * scale;
      }

    gemm_acc_kn<T, NO, NS>(acc, ds, ks + wd * DW, LD);  // dQ += dS K
    __syncthreads();
  }

  store_rows<T, NO>(dq + (long long)b * n * D, acc, D, q0 + wm * 16, wd * DW, n, 1.f, 1.f);
}

// dK/dV tiles (WM, WD, BS = queries per streamed tile) and dQ tiles (WM, WD,
// BS = keys per streamed tile) of one head width.
template <typename T, int D, int KM, int KD, int KS, int QM, int QD, int QS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int n, Strides st, float scale, cudaStream_t stream) {
  const int rows = b * n;
  flash_bwd_delta_kernel<T><<<(rows * 32 + kDeltaThreads - 1) / kDeltaThreads, kDeltaThreads,
                              0, stream>>>(static_cast<const float*>(o),
                                           static_cast<const T*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using CK = Bwd<T, D, KM, KD, KS>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D, KM, KD, KS>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CK::kBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((n + CK::BR - 1) / CK::BR, b), CK::kThreads, CK::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), n,
      st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using CQ = Bwd<T, D, QM, QD, QS>;
  auto dqk = flash_bwd_dq_kernel<T, D, QM, QD, QS>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CQ::kBytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((n + CQ::BR - 1) / CQ::BR, b), CQ::kThreads, CQ::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), n, st, scale);
  return cudaGetLastError();
}

// Tiles per head width, the same for both dtypes; float32 shared memory in
// brackets. A warp holds at most 64 columns of dK and of dV (128 float32
// registers a thread, plus a fresh 64-column tile sum in gemm_acc_kn), so
// the dK/dV kernel splits D into D / 64 slices; the dQ kernel holds one
// 16 x DW dQ tile and splits from D=256 on.
//   D=64:  dK/dV 4 x 1, 32 queries a tile (69 KB); dQ 4 x 1, 32 keys (70 KB):
//          two or three blocks per SM, N=8192 gives 128 blocks per sample.
//          (dQ with 64 keys a tile spilled 12 bytes of registers and was
//          no faster.)
//   D=128: dK/dV 2 x 2, 32 queries (116 KB, one block per SM); dQ 2 x 1,
//          32 keys (99 KB): N=2048 at B=4 gives 256 blocks for each.
//   D=256: dK/dV 1 x 4, 32 queries (179 KB); dQ 1 x 4, 32 keys (179 KB):
//          16 own rows a block, so N=512 at B=4 gives 128 blocks.
//   D=512: dK/dV 1 x 8, 16 queries (210 KB); dQ 1 x 8, 16 keys (210 KB):
//          N=512 at B=4 gives 128 blocks, one per SM; double-buffered
//          16-row tiles of two operands already take 129 KB.
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int b, int n, Strides st, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 4, 1, 32, 4, 1, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n,
                                               st, scale, stream);
    case 128:
      return launch<T, 128, 2, 2, 32, 2, 1, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n,
                                                st, scale, stream);
    case 256:
      return launch<T, 256, 1, 4, 32, 1, 4, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n,
                                                st, scale, stream);
    case 512:
      return launch<T, 512, 1, 8, 16, 1, 8, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, n,
                                                st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of q, k, v, dout, dq, dk and dv; `o` is
// the forward's O in float32 [B, N, D] (bfloat16: K1's `o32`, before its
// rounding). `delta` is float32 [B, N] scratch.
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
