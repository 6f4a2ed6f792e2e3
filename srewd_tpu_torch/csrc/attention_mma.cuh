// Tensor-core building blocks shared by the attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), for Hopper (sm_90a) through
// the sm_80 warp-level instruction mma.sync.
//
// A warp multiplies a 16-row A tile by 8-column B tiles into float32
// accumulators in the m16n8 layout: lane = 4 * g + t holds
//   c[0] = C[g][2t], c[1] = C[g][2t+1], c[2] = C[g+8][2t], c[3] = C[g+8][2t+1].
// Each attention kernel keeps its score tiles in this layout and feeds them
// straight back as the A operand of the next product (FA2), so scores and
// probabilities never pass through shared memory.
//
// Two operand types, one interface (`Mma<T>`):
//   * bfloat16: m16n8k16 with float32 accumulation. Two adjacent m16n8
//     accumulator tiles are exactly one m16k16 A fragment, so P is rounded
//     to bf16 pairs in place. B tiles come from shared memory by ldmatrix
//     (.trans for a B stored k-major, such as V[key][d]).
//   * float32: m16n8k8 TF32 with the 3xTF32 split of CUTLASS's
//     OpMultiplyAddFastF32: x = hi + lo with hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi), and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,
//     the small terms first, into one float32 accumulator. The dropped
//     a_lo*b_lo is ~2^-22 of the product, so results stay float32-accurate
//     (plain one-pass TF32 keeps ~2^-11). The m16n8k8 A fragment wants
//     columns t and t+4 of its k8 tile where the accumulator holds columns
//     2t and 2t+1, so an A taken from an accumulator relabels the tile's k
//     index (k = t <-> 2t, k = t + 4 <-> 2t + 1) and the matching B loads
//     (`load_b_kn`) read rows 2t and 2t + 1: no shuffle is needed.
//
// Shared-memory tiles are row-major with a row pitch of D + 16 bytes of
// padding, which keeps rows 16-byte aligned for cp.async and ldmatrix and
// spreads the fragment loads of a warp over all 32 banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srewd {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async

// 16-byte copy global -> shared; `valid` false fills the 16 bytes with 0
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4-byte copy global -> shared, zero-filled when not `valid`.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Row pitch, in elements, of a shared tile of D columns of T.
template <typename T, int D>
struct Pitch {
  static constexpr int value = D + 16 / (int)sizeof(T);
};

// Rows [row0, row0 + ROWS) of a [n, D] matrix (unit column stride, row
// stride `ld` elements) into a padded shared tile; rows at or past n read as
// 0. Every thread of the block (NT threads) takes its share of 16-byte
// chunks. The wrapper checks that the base and strides are 16-byte aligned.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long ld, int row0,
                                                int n) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per chunk
  constexpr int kChunksRow = D / kPer;
  constexpr int kLd = Pitch<T, D>::value;
  for (int idx = threadIdx.x; idx < ROWS * kChunksRow; idx += NT) {
    const int r = idx / kChunksRow, c = (idx % kChunksRow) * kPer;
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * kLd + c, ok ? src + (long long)row * ld + c : src, ok);
  }
}

// ROWS float32 values src[row0 ...] into dst, rows at or past n read as 0.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int row0, int n) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const bool ok = row0 + r < n;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// ---------------------------------------------------------------- bf16 helpers

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------- tf32 helpers

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, keeping 10 of
// float32's 23 mantissa bits) by integer ops: adding half of the dropped
// 13 bits' range to the magnitude bits carries into the kept ones. ptxas
// expands the cvt instruction into a longer compare-and-select sequence,
// which made the float32 kernels issue-bound on the splits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32; x - hi is exact in float32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------- Mma<T>
//
// Per operand type: the k depth of one instruction (kK), the fragments, and
//   load_a(A, s, ld, k0)        A[m][k] = s[m * ld + k0 + k], m < 16
//   load_b_nk(B0, B1, s, ld, n0, k0)
//                               two n8 tiles n0, n0 + 8 of B[k][n] = s[n * ld + k]
//   load_b_kn(B0, B1, s, ld, k0, n0)
//                               two n8 tiles of B[k][n] = s[k * ld + n], for an A
//                               made by a_from_acc (TF32: k relabelled as above)
//   a_from_acc(A, p, kt)        the k-step's A from accumulator tiles kt .. kt + kK/8 - 1
//   mma(c, A, B)                c += A B, float32-accurate for float32 inputs

template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  static __device__ __forceinline__ void split_a(A& a, float x0, float x1, float x2, float x3) {
    split_tf32(x0, a.hi[0], a.lo[0]);
    split_tf32(x1, a.hi[1], a.lo[1]);
    split_tf32(x2, a.hi[2], a.lo[2]);
    split_tf32(x3, a.hi[3], a.lo[3]);
  }

  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + g * ld + k0 + t;
    split_a(a, p[0], p[8 * ld], p[4], p[8 * ld + 4]);
  }

  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const float* s, int ld, int n0,
                                                   int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + (n0 + g) * ld + k0 + t;
    split_tf32(p[0], b0.hi[0], b0.lo[0]);
    split_tf32(p[4], b0.hi[1], b0.lo[1]);
    split_tf32(p[8 * ld], b1.hi[0], b1.lo[0]);
    split_tf32(p[8 * ld + 4], b1.hi[1], b1.lo[1]);
  }

  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const float* s, int ld, int k0,
                                                   int n0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const float* p = s + (k0 + 2 * t) * ld + n0 + g;
    split_tf32(p[0], b0.hi[0], b0.lo[0]);
    split_tf32(p[ld], b0.hi[1], b0.lo[1]);
    split_tf32(p[8], b1.hi[0], b1.lo[0]);
    split_tf32(p[ld + 8], b1.hi[1], b1.lo[1]);
  }

  // the k8 step from accumulator tile kt: k = t is column 2t, k = t + 4 is 2t + 1
  template <int KT>
  static __device__ __forceinline__ void a_from_acc(A& a, const float (&p)[KT][4], int kt) {
    split_a(a, p[kt][0], p[kt][2], p[kt][1], p[kt][3]);
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

template <>
struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  static __device__ __forceinline__ void load_a(A& a, const __nv_bfloat16* s, int ld, int k0) {
    const int lane = threadIdx.x & 31, mi = lane >> 3;
    ldmatrix_x4(a.r, s + ((mi & 1) * 8 + (lane & 7)) * ld + k0 + (mi >> 1) * 8);
  }

  static __device__ __forceinline__ void load_b_nk(B& b0, B& b1, const __nv_bfloat16* s, int ld,
                                                   int n0, int k0) {
    const int lane = threadIdx.x & 31, mi = lane >> 3;
    uint32_t r[4];
    ldmatrix_x4(r, s + (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + k0 + (mi & 1) * 8);
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }

  static __device__ __forceinline__ void load_b_kn(B& b0, B& b1, const __nv_bfloat16* s, int ld,
                                                   int k0, int n0) {
    const int lane = threadIdx.x & 31, mi = lane >> 3;
    uint32_t r[4];
    ldmatrix_x4_trans(r, s + (k0 + (mi & 1) * 8 + (lane & 7)) * ld + n0 + (mi >> 1) * 8);
    b0.r[0] = r[0]; b0.r[1] = r[1]; b1.r[0] = r[2]; b1.r[1] = r[3];
  }

  // the k16 step from accumulator tiles kt and kt + 1, rounded to bf16 pairs
  template <int KT>
  static __device__ __forceinline__ void a_from_acc(A& a, const float (&p)[KT][4], int kt) {
    a.r[0] = pack_bf16(p[kt][0], p[kt][1]);
    a.r[1] = pack_bf16(p[kt][2], p[kt][3]);
    a.r[2] = pack_bf16(p[kt + 1][0], p[kt + 1][1]);
    a.r[3] = pack_bf16(p[kt + 1][2], p[kt + 1][3]);
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

// ---------------------------------------------------------------- warp GEMMs

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// c[j] += A B_j over k in [0, KD): A[m][k] = a[m * lda + k] (16 rows),
// B_j[k][n] = b[(8 j + n) * ldb + k] (NT n8 tiles), e.g. S = Q K^T.
template <typename T, int NT, int KD>
__device__ __forceinline__ void gemm_nk(float (&c)[NT][4], const T* a, int lda, const T* b,
                                        int ldb) {
  using M = Mma<T>;
  static_assert(NT % 2 == 0 && KD % M::kK == 0, "tile must split into instructions");
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += M::kK) {
    typename M::A fa;
    M::load_a(fa, a, lda, k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      typename M::B f0, f1;
      M::load_b_nk(f0, f1, b, ldb, 8 * j, k0);
      M::mma(c[j], fa, f0);
      M::mma(c[j + 1], fa, f1);
    }
  }
}

// c[j] = alpha c[j] + P B_j where P (16 x 8 KT) is the accumulator `p`,
// B_j[k][n] = b[k * ldb + 8 j + n] and alpha is a0 on rows g, a1 on rows
// g + 8, e.g. O = alpha O + P V. The tile's product goes into a fresh
// accumulator that is then added to c in float32: the tensor cores
// accumulate with truncation, so a running sum carried through the mma
// chain over all N keys or queries (thousands of steps at N=8192) drifts,
// while a fresh accumulator bounds each truncating chain to one tile.
template <typename T, int NT, int KT>
__device__ __forceinline__ void gemm_acc_kn(float (&c)[NT][4], const float (&p)[KT][4],
                                            const T* b, int ldb, float a0 = 1.f,
                                            float a1 = 1.f) {
  using M = Mma<T>;
  constexpr int kTiles = M::kK / 8;  // accumulator tiles per instruction
  static_assert(NT % 2 == 0 && KT % kTiles == 0, "tile must split into instructions");
  float d[NT][4];
  zero(d);
#pragma unroll
  for (int kt = 0; kt < KT; kt += kTiles) {
    typename M::A fa;
    M::a_from_acc(fa, p, kt);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      typename M::B f0, f1;
      M::load_b_kn(f0, f1, b, ldb, 8 * kt, 8 * j);
      M::mma(d[j], fa, f0);
      M::mma(d[j + 1], fa, f1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = fmaf(c[j][i], i < 2 ? a0 : a1, d[j][i]);
}

// With D split over WD warps that share 16 rows, each holds a partial sum
// over its slice of D; this adds the WD partials through shared memory
// (`red`: one [NT*4][32] float slot per warp of the block) in a fixed order,
// so every warp of the group ends with the same, deterministic sum.
// All threads of the block must call it.
template <int NT, int WD>
__device__ __forceinline__ void sum_over_slices(float (&c)[NT][4], float* red) {
  if constexpr (WD > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* mine = red + warp * NT * 4 * 32;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mine[(j * 4 + i) * 32 + lane] = c[j][i];
    __syncthreads();
    const float* first = red + (warp - warp % WD) * NT * 4 * 32;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WD; ++w) s += first[(w * NT * 4 + j * 4 + i) * 32 + lane];
        c[j][i] = s;
      }
  }
}

// The same for two accumulator sets at once, one barrier (`red`: two
// [NT*4][32] slots per warp).
template <int NT, int WD>
__device__ __forceinline__ void sum_over_slices(float (&c)[NT][4], float (&e)[NT][4],
                                                float* red) {
  if constexpr (WD > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kSlot = 2 * NT * 4 * 32;
    float* mine = red + warp * kSlot;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mine[(j * 4 + i) * 32 + lane] = c[j][i];
        mine[((NT + j) * 4 + i) * 32 + lane] = e[j][i];
      }
    __syncthreads();
    const float* first = red + (warp - warp % WD) * kSlot;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = 0.f, u = 0.f;
#pragma unroll
        for (int w = 0; w < WD; ++w) {
          s += first[w * kSlot + (j * 4 + i) * 32 + lane];
          u += first[w * kSlot + ((NT + j) * 4 + i) * 32 + lane];
        }
        c[j][i] = s;
        e[j][i] = u;
      }
  }
}

// max / sum over the 4 lanes of a quad (the threads that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows g and g + 8 of a 16-row accumulator tile set `c` (16 x 8 NT, columns
// [c0, c0 + 8 NT) of a [*, D] output) into out + row0 * D, as T; rows at or
// past n are skipped.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[NT][4], int D, int row0,
                                           int c0, int n, float s0, float s1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    const float s = h ? s1 : s0;
    T* p = out + (long long)row * D + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float x0 = c[j][2 * h] * s, x1 = c[j][2 * h + 1] * s;
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(p + 8 * j) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(x0, x1);
      }
    }
  }
}

}  // namespace srewd
