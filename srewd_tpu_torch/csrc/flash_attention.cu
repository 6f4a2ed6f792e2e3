// Exact single-head attention O = softmax(scale * Q K^T) V for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel `flash_attention` in srewd_tpu/ops/flash_attention.py
// (body `_kernel`). That kernel keeps the whole K and V of a sample in VMEM
// and takes a full-row softmax; at the largest phydiff map (N=8192, D=64) K
// and V are 2 MB in float32, far beyond the 227 KB of shared memory a block
// may use here. So this kernel tiles K and V and keeps an online softmax
// (FA2): per query row a running max m and sum l, and a float32 output
// accumulator rescaled by exp(m_old - m_new) whenever the max moves,
// normalised by l at the end. One block per (query tile, batch element)
// loops over the K/V tiles; that loop replaces the TPU's sequential grid
// dimension.
//
// What bounds it: 4 * B * N^2 * D flops against 4 * B * N * D elements of
// device traffic. At the tensor cores' rates (float32 as 3xTF32, 495 / 3
// TFLOP/s; bfloat16 989) that is operations at the N >= 512 float32 shapes
// and at N=2048 and 8192 in bfloat16, bytes at the others. The design, with
// the building blocks of attention_mma.cuh:
//   * each warp owns 16 query rows; S = Q K^T of a key tile stays in
//     registers in the mma accumulator layout, the online softmax runs there
//     (quad shuffles for the row max and sum), and P goes straight back as
//     the A operand of O += P V: no score tile in shared memory;
//   * float32 multiplies by 3xTF32 on the tensor cores (float32-accurate);
//     bfloat16 by bf16 mma with P rounded to bf16 before P V, as the TPU
//     kernel rounds its probabilities to V's dtype;
//   * the K and V tiles are double buffered with cp.async: tile j + 1 is in
//     flight while tile j is multiplied;
//   * at D >= 256 a 16 x D float32 output tile does not fit one warp's
//     registers, so D is split across WD warps that share the 16 rows: each
//     takes the Q K^T reduction over its D / WD slice, the slices are summed
//     through shared memory (sum_over_slices, a fixed order, so every warp
//     of the group gets the same S and the same softmax), and each warp then
//     owns D / WD output columns of P V.
// wgmma, TMA and warp specialisation are later work.
//
// Numerics: scores, softmax and the P V sums are float32; inputs float32 or
// bfloat16; the output is written in Q's dtype. Exponentials are exp2 of
// scores pre-multiplied by scale * log2(e).
//
// Layout: q, k, v are [B, N, D] with unit stride along D and any batch and
// row strides (in elements) whose byte sizes, and the base pointers, are
// multiples of 16 (cp.async copies 16 bytes); the wrapper checks that. The
// 1x1 qkv / kv convolutions' slabs (row stride 3C or 2C) pass without a
// copy. The output is a contiguous [B, N, D] tensor the wrapper allocates.
//
// Training: with a non-null `lse` the kernel also writes each query row's
// log-sum-exp m + log(l) of the scaled scores, float32 [B, N], which the
// backward (flash_attention_bwd.cu) uses to recompute P; with a non-null
// `o32` (bfloat16 inputs) also O in float32, before its rounding, from which
// the backward takes Δ = rowsum(dO ∘ O) as accurately as the TPU kernel's
// float32 rowsum(P ∘ dP) (from the rounded O, Δ is off by up to a bf16 ulp
// of |dO||O|, which dS = P (dP - Δ) carries into dQ, beyond two bf16 ulps
// at D=512 with a training step's gradients).
// Nothing else changes, so O is the same bit for bit with and without them.

#include "attention_mma.cuh"

namespace {

using namespace srewd;

constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long q_b, q_r, k_b, k_r, v_b, v_r;
};

// WM warps along query rows (BQ = 16 WM), WD warps along D, BK keys a tile.
template <typename T, int D, int WM, int WD, int BK>
struct Fwd {
  static constexpr int kWarps = WM * WD;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int BQ = 16 * WM;
  static constexpr int DW = D / WD;  // output columns of a warp
  static constexpr int NS = BK / 8;  // score tiles of a warp
  static constexpr int NO = DW / 8;  // output tiles of a warp
  static constexpr int LD = Pitch<T, D>::value;
  // shared memory: Q [BQ][LD] | K [2][BK][LD] | V [2][BK][LD] | slice sums
  static constexpr size_t kQ = sizeof(T) * BQ * LD;
  static constexpr size_t kKV = sizeof(T) * BK * LD;
  static constexpr size_t kRed = WD > 1 ? sizeof(float) * kWarps * NS * 4 * 32 : 0;
  static constexpr size_t kBytes = kQ + 4 * kKV + kRed;
};

template <typename T, int D, int WM, int WD, int BK>
__global__ void __launch_bounds__(Fwd<T, D, WM, WD, BK>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, float* __restrict__ o32, int n,
                 Strides st, float scale) {
  using C = Fwd<T, D, WM, WD, BK>;
  constexpr int LD = C::LD, NS = C::NS, NO = C::NO, DW = C::DW, NT = C::kThreads;

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::kQ);
  T* Vs = reinterpret_cast<T*>(smem + C::kQ + 2 * C::kKV);
  float* red = reinterpret_cast<float*>(smem + C::kQ + 4 * C::kKV);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WD, wd = warp % WD;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const T* kb = k + b * st.k_b;
  const T* vb = v + b * st.v_b;
  const int tiles = (n + BK - 1) / BK;

  load_tile_async<T, D, C::BQ, NT>(Qs, q + b * st.q_b, st.q_r, q0, n);
  load_tile_async<T, D, BK, NT>(Ks, kb, st.k_r, 0, n);
  load_tile_async<T, D, BK, NT>(Vs, vb, st.v_r, 0, n);
  cp_async_commit();

  float acc[NO][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled log2 scores
  float l[2] = {0.f, 0.f};              // this thread's part of the running sum
  const float sl2 = scale * kLog2e;
  const T* qw = Qs + wm * 16 * LD + wd * DW;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      const int s = (it + 1) & 1;
      load_tile_async<T, D, BK, NT>(Ks + s * BK * LD, kb, st.k_r, (it + 1) * BK, n);
      load_tile_async<T, D, BK, NT>(Vs + s * BK * LD, vb, st.v_r, (it + 1) * BK, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile `it` have landed
    __syncthreads();
    const T* ks = Ks + (it & 1) * BK * LD;
    const T* vs = Vs + (it & 1) * BK * LD;

    float s[NS][4];
    zero(s);
    gemm_nk<T, NS, DW>(s, qw, LD, ks + wd * DW, LD);
    sum_over_slices<NS, WD>(s, red);

    // online softmax on the registers: rows g (i = 0, 1) and g + 8 (i = 2, 3)
    const int k0 = it * BK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * t + (i & 1);
        s[j][i] = key < n ? s[j][i] * sl2 : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2f(m[h] - mx[h]);  // 0 on the first tile
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(s[j][i] - m[i >> 1]);
        sum[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];

    gemm_acc_kn<T, NO, NS>(acc, s, vs + wd * DW, LD, alpha[0], alpha[1]);  // O = alpha O + P V
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const int row0 = q0 + wm * 16;
  store_rows<T, NO>(o + (long long)b * n * D, acc, D, row0, wd * DW, n, 1.f / l0, 1.f / l1);
  if (o32 != nullptr)
    store_rows<float, NO>(o32 + (long long)b * n * D, acc, D, row0, wd * DW, n, 1.f / l0,
                          1.f / l1);
  if (lse != nullptr && wd == 0 && t == 0) {
    const int g = lane >> 2;
    if (row0 + g < n) lse[(long long)b * n + row0 + g] = (m[0] + log2f(l0)) * kLn2;
    if (row0 + g + 8 < n) lse[(long long)b * n + row0 + g + 8] = (m[1] + log2f(l1)) * kLn2;
  }
}

template <typename T, int D, int WM, int WD, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, float* o32,
                   int b, int n, Strides st, float scale, cudaStream_t stream) {
  using C = Fwd<T, D, WM, WD, BK>;
  auto kernel = flash_fwd_kernel<T, D, WM, WD, BK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + C::BQ - 1) / C::BQ, b);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, o32, n, st, scale);
  return cudaGetLastError();
}

// Tiles per head width (warps along rows WM, along D WD, keys a tile BK),
// the same for both dtypes. Float32 shared memory in brackets.
//   D=64:  4 x 1, BK 64 (85 KB): a warp holds 16 x 64 of O and of S, two
//          blocks per SM; N=8192 gives 128 blocks per sample.
//   D=128: 4 x 1, BK 32 (99 KB): 16 x 128 of O in a warp's registers, two
//          blocks per SM; N=2048 at B=8 gives 256 blocks.
//   D=256: 1 x 4, BK 32 (154 KB): O split 4 ways (64 columns a warp), 16
//          query rows a block so N=512 at B=8 gives 256 blocks.
//   D=512: 1 x 8, BK 16 (169 KB): O split 8 ways; double-buffered K and V
//          at 16 keys already take 129 KB. N=512 at B=8 gives 256 blocks.
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                     float* o32, int b, int n, Strides st, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64, 4, 1, 64>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 128: return launch<T, 128, 4, 1, 32>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 256: return launch<T, 256, 1, 4, 32>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 512: return launch<T, 512, 1, 8, 16>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `lse`: null, or float32 [B, N] for the
// rows' log-sum-exp. `o32`: null, or float32 [B, N, D] for O before its
// rounding (bfloat16). Returns the cudaError_t of the launch
// (cudaGetLastError() right after it), 0 on success. Does not synchronise.
int srewd_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, float* o32, int b, int n, int d, long long q_b,
                              long long q_r, long long k_b, long long k_r, long long v_b,
                              long long v_r, float scale, int dtype, void* stream) {
  Strides st{q_b, q_r, k_b, k_r, v_b, v_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(d, q, k, v, o, lse, o32, b, n, st, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(d, q, k, v, o, lse, o32, b, n, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* srewd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
