// Hopper building blocks of the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu), for sm_90a: TMA tile loads completed on
// mbarriers, warpgroup MMA (wgmma) with operands in shared memory or in
// registers, the 3xTF32 split of float32 operands, and the host-side
// encoding of the TMA tensor maps.
//
// Shared-memory tiles. Every tile is K-major with 128-byte swizzling (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with
// layout type B128): a [R rows x W bytes] tile is W / 128 "atom columns",
// each R rows of 128 bytes, one after the other, and the 16-byte chunk c of
// row r sits at chunk c ^ (r % 8) (`swz`, on offsets from a 1024-byte
// aligned base). A wgmma operand of 8-row groups is described by its start
// address and the stride between 8-row groups (SBO, 1024 bytes here); one
// k-step reads 32 bytes of every row (16 bf16 or 8 TF32 values), so step kk
// starts at atom column kk / 4, byte 32 * (kk % 4) of the row, the same
// arithmetic for both dtypes.
//
// Operand orders. wgmma reads A as [64 x K] and B as [K x N]. K-major means
// K contiguous: Q and K tiles for S = Q K^T, and (bf16 only) every A from
// shared memory. A B operand whose rows in device memory run along K (V in
// P V, dO in P^T dO, Q in dS^T Q, K in dS K) is MN-major: bf16 wgmma reads
// it so ("transpose" bit), 64 columns (one atom column) per instruction, the
// next 16 rows 2048 bytes on; TF32 wgmma reads only K-major operands, so
// the consumer warps write those B tiles transposed (`split_transposed`).
//
// Accumulators (m64nN): warp w of the warpgroup holds rows 16 w .. 16 w + 15;
// lane 4 g + t holds, for each 8-column tile j, d[4j] = C[g][8j + 2t],
// d[4j + 1] = C[g][8j + 2t + 1], d[4j + 2] = C[g + 8][8j + 2t],
// d[4j + 3] = C[g + 8][8j + 2t + 1] (the mma.sync m16n8 layout, per warp). A
// register A operand has the mma.sync A layout too, so a probability tile
// goes from the accumulator into the next product without passing through
// shared memory (FA3): for bf16, tiles j and j + 1 are one k16 step; for
// TF32 the k8 fragment wants columns t and t + 4 where the accumulator holds
// 2t and 2t + 1, so the fragment relabels its k index (k = t <-> 2t,
// k = t + 4 <-> 2t + 1) and the transposed B tile stores key 8 i + c at
// position 8 i + perm8(c) to match.
//
// Float32 (3xTF32, as CUTLASS's OpMultiplyAddFastF32): x = hi + lo with
// hi = rna(x), lo = rna(x - hi), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small terms first. Each operand's hi and lo parts are written once
// into shared memory (B tiles, resident A tiles) or split in registers (the
// probability A operands). The tensor cores add a k-step's products into
// the accumulator with truncation; a chain restarts (scale-d = 0) at every
// tile, and the running sums (O, dK, dV, dQ) are added in float32 outside
// the tensor cores, so no truncating chain is longer than one tile's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace srewd {
namespace wg {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// wait until the barrier has completed the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA

// box of a [B, N, D] tensor map at (c0 along D, c1 along N, c2 along B)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// box of a map_1d row at element c0
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
         "r"(0) : "memory");
}

// ---------------------------------------------------------------- fences

// generic-proxy writes (the split tiles) before async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1 ..) over `count` threads, e.g. one warpgroup
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are in flight
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (they are invisible to it)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(r[j][i]) :: "memory");
}

// the same for a register A operand, whose registers an in-flight product
// reads: fenced after the wait, they stay live (unreused) until then
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i]) :: "memory");
}

// Matrix descriptor of a B128-swizzled operand at shared address `addr`:
// 8-row groups 1024 bytes apart (SBO); LBO, the stride along the other
// dimension between swizzle atoms, is never crossed by these tiles' operands
// (K-major k-steps stay inside one atom; MN-major operands are 64 columns
// wide, one atom), and is set to 1024 as well.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// c = A B, m64nN, A and B from shared memory (both K-major)
template <typename T, int N>
struct SS;
// c = A B, m64nN, A from registers; B MN-major (bf16) or K-major (TF32)
template <typename T, int N = 64>
struct RS;

template <>
struct SS<__nv_bfloat16, 16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<__nv_bfloat16, 32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<float, 16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<float, 32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct SS<float, 64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct RS<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct RS<float, 32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct RS<float, 64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct RS<float, 128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// ---------------------------------------------------------------- tiles

// byte offset of the 16-byte chunk holding byte `off` of a B128 tile, from
// its 1024-byte aligned base (rows of 128 bytes, swizzle atoms of 8 rows)
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// offset of byte `b` of row `r` in a K-major tile of R rows
template <int R>
__device__ __forceinline__ uint32_t tile_off(int r, int b) {
  return swz((b >> 7) * R * 128 + r * 128 + (b & 127));
}

// address of k-step kk (32 bytes) of rows [r0, r0 + 64) of a K-major tile of
// R rows at shared address `base`
template <int R>
__device__ __forceinline__ uint32_t kstep_addr(uint32_t base, int r0, int kk) {
  return base + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // cvt.rna.tf32.f32
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The TF32 register A operand of k-step kk of this warp's 16 rows of a raw
// float32 K-major tile of R rows at `a` (rows 16 w + g and + 8, columns
// t and t + 4 of the step, whose 32 bytes start at byte `b0` of a row), hi
// and lo parts.
template <int R>
__device__ __forceinline__ void a_frag(const unsigned char* a, int b0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, r = 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  const int c = b0 + 4 * (lane & 3);
  split_tf32(*reinterpret_cast<const float*>(a + tile_off<R>(r, c)), hi[0], lo[0]);
  split_tf32(*reinterpret_cast<const float*>(a + tile_off<R>(r + 8, c)), hi[1], lo[1]);
  split_tf32(*reinterpret_cast<const float*>(a + tile_off<R>(r, c + 16)), hi[2], lo[2]);
  split_tf32(*reinterpret_cast<const float*>(a + tile_off<R>(r + 8, c + 16)), hi[3], lo[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// position of key c (within its group of 8) in a transposed TF32 B tile
__device__ __forceinline__ int perm8(int c) {
  return (c & ~7) | ((c & 1) << 2) | ((c & 7) >> 1);
}

// hi and lo parts of `bytes` bytes of float32 at `src` into `hi` and `lo`
// (the same layout), by NT threads (tid in [0, NT))
template <int BYTES, int NT = 128>
__device__ __forceinline__ void split_tile(const unsigned char* src, unsigned char* hi,
                                           unsigned char* lo, int tid) {
#pragma unroll 4
  for (int i = tid; i < BYTES / 16; i += NT) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// Columns [c0, c0 + NOUT) of a float32 K-major tile `src` of ROWS rows
// (row r, column c: byte 4c of row r) into rows [r0, r0 + NOUT) of `dst`,
// transposed and split: a K-major tile of NR rows whose K runs over the
// source rows, hi parts at bytes [0, 4 ROWS) and lo parts at [4 ROWS,
// 8 ROWS) of each row, source row r at position perm8(r). By NT threads
// (tid in [0, NT)).
template <int ROWS, int NOUT, int NT = 128, int NR = NOUT>
__device__ __forceinline__ void split_transposed(const unsigned char* src, unsigned char* dst,
                                                 int c0, int tid, int r0 = 0) {
  static_assert(ROWS % 16 == 0 && NOUT % 4 == 0, "tile shape");
#pragma unroll 2
  for (int i = tid; i < ROWS * NOUT / 4; i += NT) {
    const int r = i % ROWS, n = (i / ROWS) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + tile_off<ROWS>(r, 4 * (c0 + n)));
    const int k = 4 * perm8(r);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h, l;
      split_tf32(v[e], h, l);
      *reinterpret_cast<uint32_t*>(dst + tile_off<NR>(r0 + n + e, k)) = h;
      *reinterpret_cast<uint32_t*>(dst + tile_off<NR>(r0 + n + e, 4 * ROWS + k)) = l;
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

// Rows g and g + 8 of this warp's 16 rows of an accumulator `c` (columns
// [0, 8 NT) of a [*, ld] output starting at column c0) into out, as T,
// times s0 / s1; rows at or past n are skipped.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&c)[NT][4], int ld, int row0,
                                           int c0, int n, float s0, float s1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
    const float s = h ? s1 : s0;
    T* p = out + static_cast<long long>(row) * ld + c0 + 2 * t;
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

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// ---------------------------------------------------------------- products
//
// One warpgroup's products, issued (asynchronously) by its 128 threads;
// the caller fences, commits and waits.

// c = A B^T over k-steps [0, KSTEPS) with A rows [a_r0, a_r0 + 64) of a
// K-major tile of AR rows at `a` and B the NB rows of a K-major tile at `b`
// (S = Q K^T and the like). Float32: the hi and lo parts are tiles of the
// same layout at a + alo and b + blo.
template <typename T, int NB, int AR, int KSTEPS>
__device__ __forceinline__ void mma_abt(float (&c)[NB / 8][4], uint32_t a, int a_r0, uint32_t b,
                                        uint32_t alo = 0, uint32_t blo = 0) {
  float* d = &c[0][0];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t ak = kstep_addr<AR>(a, a_r0, kk), bk = kstep_addr<NB>(b, 0, kk);
    if constexpr (sizeof(T) == 4) {
      SS<float, NB>::mma(d, desc(ak + alo), desc(bk), kk > 0);
      SS<float, NB>::mma(d, desc(ak), desc(bk + blo), 1);
      SS<float, NB>::mma(d, desc(ak), desc(bk), 1);
    } else {
      SS<__nv_bfloat16, NB>::mma(d, desc(ak), desc(bk), kk > 0);
    }
  }
}

// The register A operand of a probability tile `p` (64 x 8 KT, accumulator
// layout): bf16, one k16 step per two tiles; TF32, one k8 step per tile,
// hi and lo.
template <typename T, int KT>
struct PFrag;

template <int KT>
struct PFrag<__nv_bfloat16, KT> {
  static constexpr int kSteps = KT / 2;
  uint32_t a[KT / 2][4];
  __device__ __forceinline__ void set(const float (&p)[KT][4]) {
#pragma unroll
    for (int s = 0; s < KT / 2; ++s) {
      a[s][0] = pack_bf16(p[2 * s][0], p[2 * s][1]);
      a[s][1] = pack_bf16(p[2 * s][2], p[2 * s][3]);
      a[s][2] = pack_bf16(p[2 * s + 1][0], p[2 * s + 1][1]);
      a[s][3] = pack_bf16(p[2 * s + 1][2], p[2 * s + 1][3]);
    }
  }
};

template <int KT>
struct PFrag<float, KT> {
  static constexpr int kSteps = KT;
  uint32_t hi[KT][4], lo[KT][4];
  __device__ __forceinline__ void set(const float (&p)[KT][4]) {
#pragma unroll
    for (int s = 0; s < KT; ++s) {
      split_tf32(p[s][0], hi[s][0], lo[s][0]);
      split_tf32(p[s][2], hi[s][1], lo[s][1]);
      split_tf32(p[s][1], hi[s][2], lo[s][2]);
      split_tf32(p[s][3], hi[s][3], lo[s][3]);
    }
  }
};

// c = P B over the KT * 8 rows of B, from a fresh accumulator: NCH column
// chunks of 64 from chunk ch0 of a B of NC columns. bf16: B is rows
// [.., + 8 KT) of an MN-major tile at `b` whose atom columns hold BROWS
// rows, its column 0 at atom column `col0`. TF32: B is a transposed split
// tile at `b` (NC rows, hi at bytes [0, 32 KT), lo at [32 KT, 64 KT) of
// each row).
template <typename T, int NC, int KT, int BROWS, int NCH = NC / 64>
__device__ __forceinline__ void mma_pv(float (&c)[NCH * 8][4], const PFrag<T, KT>& p, uint32_t b,
                                       int col0 = 0, int ch0 = 0) {
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    float* d = &c[8 * ch][0];
#pragma unroll
    for (int s = 0; s < PFrag<T, KT>::kSteps; ++s) {
      if constexpr (sizeof(T) == 4) {
        const uint32_t bh = kstep_addr<NC>(b, 64 * (ch0 + ch), s);
        const uint32_t bl = kstep_addr<NC>(b, 64 * (ch0 + ch), KT + s);
        RS<float>::mma(d, p.lo[s], desc(bh), s > 0);
        RS<float>::mma(d, p.hi[s], desc(bl), 1);
        RS<float>::mma(d, p.hi[s], desc(bh), 1);
      } else {
        const uint32_t bk = b + (col0 + ch0 + ch) * BROWS * 128 + s * 2048;
        RS<__nv_bfloat16>::mma(d, p.a[s], desc(bk), s > 0);
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------- host

// Tensor maps, encoded by the C entry points with cuTensorMapEncodeTiled,
// whose address the runtime's entry-point query returns (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a [b, n, d] view (unit stride along d, row and batch strides in
// elements) read in boxes of 128 bytes of a row x `rows` rows, B128
// swizzled; rows past n read as zeros.
inline cudaError_t map_3d(CUtensorMap* m, const void* ptr, bool f32, int d, int n, int b,
                          long long row_stride, long long batch_stride, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int esz = f32 ? 4 : 2;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n),
                        static_cast<cuuint64_t>(b)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_stride * esz),
                           static_cast<cuuint64_t>(batch_stride * esz)};
  cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / esz), static_cast<cuuint32_t>(rows), 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Map of `len` float32 values read in boxes of `box` values (no swizzle),
// as a [1, len] tensor: a row of any length, where a [B, N] map would need
// 16-byte rows (N a multiple of 4).
inline cudaError_t map_1d(CUtensorMap* m, const float* ptr, long long len, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(len), 1};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>((len * 4 + 15) / 16 * 16)};
  cuuint32_t boxd[2] = {static_cast<cuuint32_t>(box), 1};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
                  boxd, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// 1024-byte aligned start of the dynamic shared memory (B128 tiles and TMA
// destinations need it); launches ask for kAlignSlack bytes more
constexpr int kAlignSlack = 1024;

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = wg::smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

}  // namespace srewd
