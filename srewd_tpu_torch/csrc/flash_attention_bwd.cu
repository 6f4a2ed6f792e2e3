// Backward of exact single-head attention O = softmax(scale * Q K^T) V, for
// Hopper (sm_90a), on the tensor cores by warpgroup MMA (wgmma) with TMA
// loads and warp specialisation: dQ, dK and dV from Q, K, V, O, dO and the
// forward's row log-sum-exp.
//
// Replaces the TPU kernel `_flash_bwd` in srewd_tpu/ops/flash_attention.py
// (:173, body `_bwd_kernel` :131), which keeps the whole K and V of a sample
// and three [QB, N] float32 slabs (P, dP, dS) in VMEM and carries dK / dV
// from one query block to the next along a sequential grid axis. Hopper
// blocks run in no order and a block has 227 KB of shared memory, so this
// is the FA2/FA3 layout instead, in three launches:
//   * Δ_i = rowsum(dO_i ∘ O_i), one warp per row. The TPU kernel takes
//     rowsum(P ∘ dP) over the whole key row; the two are equal in exact
//     arithmetic and agree to float32 rounding, because O is the forward's
//     float32 O also in bfloat16 (K1's `o32`, before its rounding: from the
//     rounded O, Δ's error carried dQ beyond two bf16 ulps at D=512);
//   * dK / dV: one block per (key tile, sample, output slice) streams all
//     query tiles and keeps its dK and dV tile in float32 registers. With
//     the keys as the rows, S^T = K Q^T and dP^T = V dO^T are wgmma products
//     with K and V from shared memory, P^T = exp(scale S^T - LSE) and
//     dS^T = P^T ∘ (dP^T - Δ) * scale are formed on the accumulators, and
//     they are the register A operands of dV += P^T dO and dK += dS^T Q;
//   * dQ: one block per (query tile, sample, output slice) streams all key
//     tiles, recomputes P and dS the same way and adds dS K into its dQ
//     tile. Recomputing instead of adding into dQ with float32 atomics from
//     the dK / dV kernel keeps the result deterministic (the trainer asks
//     for determinism, and a resumed run must repeat the first one's losses)
//     and needs no zeroed scratch buffer, at 14 instead of 10 B * N^2 * D
//     flops.
//
// What bounds it: 10 * B * N^2 * D flops of the TPU's algorithm (14 in this
// design) against 8 * B * N * D elements of device traffic (q, k, v, o, dO
// read, dq, dk, dv written): operations at the tensor cores' rates, but for
// the N=128 shapes, which are bound by the bytes.
// Both main kernels are built as K1 (flash_attention.cu) is, from
// attention_wgmma.cuh: NW consumer warpgroups of 64 own rows and one
// producer warpgroup, one thread of which loads the own tiles once and
// streams the other side's tiles (Q, dO, LSE and Δ for dK / dV; K and V for
// dQ) by TMA into a ring of two stages on mbarriers. Float32 takes 3xTF32
// (float32-accurate): the own tiles are split into hi and lo parts once;
// each landed tile is split, and the B operand of the second product
// (dO and Q for dK / dV, K for dQ) also split and transposed, by the
// consumer warpgroup, which then hands the raw stage back. bfloat16 reads
// those B operands MN-major as they land and rounds P and dS to bf16 as the
// A operands. Each tile's product into dK, dV or dQ is a fresh wgmma chain
// added to the running sum in float32. Where a 64 x D float32 dK and dV
// would not fit a thread's registers, the output is split into slices of DS
// columns, one per block (blockIdx.z), each recomputing S and dP over the
// whole D. Float32 at D >= 256, where the own tiles with their lo parts do
// not fit shared memory, keeps the warp-level kernels on mma.sync
// (fa2): the wgmma design for those widths, flash_bwd_stream_kernel (both
// sides through the ring in 64-column chunks for every streamed tile, as
// K1's flash_fwd_stream_kernel streams Q and K), takes 1.6-2x their time
// on the card and is built only with SREWD_K2_WIDE_WGMMA defined
// (chip_smoke.py --k2-wide measures both).
//
// Numerics: all sums are float32, inputs float32 or bfloat16, dQ / dK / dV
// are written in the inputs' dtype, as `_flash_bwd` casts its float32
// results. Layout: q, k, v are [B, N, D] with unit stride along D and any
// batch and row stride, 16-byte aligned (the 1x1 qkv / kv convolutions'
// slabs); o (float32) and dO are contiguous [B, N, D]; lse and the Δ scratch
// are float32 [B, N]; the outputs are contiguous [B, N, D]. The wrapper
// allocates every buffer and checks the alignment; the C entry point
// encodes the tensor maps.

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace {

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

namespace fa3 {

using namespace srewd::wg;

// The shapes both main kernels share: NW consumer warpgroups of 64 own rows
// (BR), the other side streamed in tiles of BS rows, DS output columns a
// block. Shared memory, every region a multiple of 1024 bytes:
// own tiles A0, A1 [BR x D] (K and V, or Q and dO; float32: their hi parts
// in place, then their lo parts) | LSE and Δ: the own rows' (dQ), or each
// stage's (dK / dV) | ST stages of the streamed tiles S0, S1 [BS x D] (Q and
// dO, or K and V) | float32: S0's and S1's hi and lo parts, then the split
// and transposed B operands of the second product, [DS x 8 BS] each |
// mbarriers.
template <typename T, int D, int DS, int BS, int NW, bool DKDV, int ST>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kEsz = sizeof(T);
  static constexpr int kEpa = 128 / kEsz;
  static constexpr int BR = 64 * NW;
  static constexpr int kRows = BS;  // rows of a streamed tile
  static constexpr int kSlices = D / DS;
  static constexpr int kSSteps = D * kEsz / 32;
  static constexpr int kThreads = 128 * (NW + 1);
  static constexpr int kConsumers = 128 * NW;
  static constexpr int kStages = ST;
  static constexpr int kOwn = BR * D * kEsz;
  static constexpr int kTile = BS * D * kEsz;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSlot = 4 * BS > 128 ? 4 * BS : 128;  // a stage's LSE or Δ (dK / dV)
  static constexpr int kStats = DKDV ? (2 * ST * kSlot + 1023) / 1024 * 1024 : 1024;
  static constexpr int oA0lo = 2 * kOwn;  // float32
  static constexpr int oStats = (kF32 ? 4 : 2) * kOwn;
  static constexpr int oStage = oStats + kStats;
  static constexpr int oSplit = oStage + kStages * kStage;  // float32: S0 hi, S0 lo, S1 hi, S1 lo
  static constexpr int kT = DS * 8 * BS;                    // a transposed split operand
  static constexpr int oT = oSplit + (kF32 ? 4 * kTile : 0);
  static constexpr int oBar = oT + (kF32 ? (DKDV ? 2 : 1) * kT : 0);
  static constexpr int kBytes = oBar + 16 * ST + 8 + srewd::kAlignSlack;
  static_assert(D % DS == 0 && DS % 64 == 0 && BS % 16 == 0 && BR <= 128, "tile shape");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// The producer warpgroup's loads: the own tiles (and, for dQ, their LSE and
// Δ) once on `own`, then every streamed tile into the ring.
template <typename C, bool DKDV>
__device__ __forceinline__ void produce(unsigned char* sm, uint64_t* full, uint64_t* empty,
                                        uint64_t* own, const CUtensorMap* a0,
                                        const CUtensorMap* a1, const CUtensorMap* s0,
                                        const CUtensorMap* s1, const CUtensorMap* ml,
                                        const CUtensorMap* md, int r_blk, int b, int n,
                                        int tiles) {
  constexpr int kAtoms = C::kOwn / (C::BR * 128);
  mbar_expect_tx(own, 2 * C::kOwn + (DKDV ? 0 : 8 * C::BR));
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
    tma_load_3d(sm + a * C::BR * 128, a0, own, a * C::kEpa, r_blk, b);
    tma_load_3d(sm + C::kOwn + a * C::BR * 128, a1, own, a * C::kEpa, r_blk, b);
  }
  if constexpr (!DKDV) {
    tma_load_1d(sm + C::oStats, ml, own, b * n + r_blk);
    tma_load_1d(sm + C::oStats + 512, md, own, b * n + r_blk);
  }
  constexpr int BS = C::kRows;
  for (int it = 0; it < tiles; ++it) {
    const int s = it % C::kStages;
    if (it >= C::kStages) mbar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
    unsigned char* st = sm + C::oStage + s * C::kStage;
    mbar_expect_tx(&full[s], 2 * C::kTile + (DKDV ? 8 * BS : 0));
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      tma_load_3d(st + a * BS * 128, s0, &full[s], a * C::kEpa, it * BS, b);
      tma_load_3d(st + C::kTile + a * BS * 128, s1, &full[s], a * C::kEpa, it * BS, b);
    }
    if constexpr (DKDV) {
      tma_load_1d(sm + C::oStats + 2 * s * C::kSlot, ml, &full[s], b * n + it * BS);
      tma_load_1d(sm + C::oStats + (2 * s + 1) * C::kSlot, md, &full[s], b * n + it * BS);
    }
  }
}

// float32: the own tiles' hi parts in place and their lo parts beside them,
// by the consumer warpgroups together
template <typename C>
__device__ __forceinline__ void split_own(unsigned char* sm) {
  if constexpr (C::kF32) {
    split_tile<2 * C::kOwn, C::kConsumers>(sm, sm, sm + C::oA0lo, threadIdx.x);
    fence_proxy_async();
    bar_sync(1, C::kConsumers);
  }
}

// dK / dV: BR own keys, BS queries a streamed tile.
template <typename T, int D, int DS, int BS, int NW, int ST>
__global__ void __launch_bounds__(Cfg<T, D, DS, BS, NW, true, ST>::kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_lse,
                      const __grid_constant__ CUtensorMap tm_delta, T* __restrict__ dk,
                      T* __restrict__ dv, int n, float scale) {
  using C = Cfg<T, D, DS, BS, NW, true, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* empty = full + C::kStages;
  uint64_t* own = empty + C::kStages;
  const int b = blockIdx.y, slice = blockIdx.z;
  const int k_blk = blockIdx.x * C::BR;
  const int tiles = (n + BS - 1) / BS;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NW);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NW) {
    if constexpr (NW > 1) reg_dealloc<24>();
    if (threadIdx.x == 128 * NW)
      produce<C, true>(sm, full, empty, own, &tm_k, &tm_v, &tm_q, &tm_do, &tm_lse, &tm_delta,
                       k_blk, b, n, tiles);
  } else {
    if constexpr (NW > 1) reg_alloc<240>();
    const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int t = threadIdx.x & 3;
    const uint32_t base = smem_u32(sm);
    mbar_wait(own, 0);
    split_own<C>(sm);

    float acc_k[DS / 8][4], acc_v[DS / 8][4];
    zero(acc_k);
    zero(acc_v);
    const float sl2 = scale * kLog2e;
    constexpr int kLo = C::kF32 ? C::oA0lo : 0;  // own lo parts, from the hi parts

    for (int it = 0; it < tiles; ++it) {
      const int s = it % C::kStages;
      mbar_wait(&full[s], (it / C::kStages) & 1);
      unsigned char* raw = sm + C::oStage + s * C::kStage;
      // this thread's query columns' LSE (log2 units) and Δ
      const float* lse_s = reinterpret_cast<const float*>(sm + C::oStats + 2 * s * C::kSlot);
      const float* dl_s =
          reinterpret_cast<const float*>(sm + C::oStats + (2 * s + 1) * C::kSlot);
      float lse_c[BS / 8][2], dl_c[BS / 8][2];
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lse_c[j][e] = lse_s[8 * j + 2 * t + e] * kLog2e;
          dl_c[j][e] = dl_s[8 * j + 2 * t + e];
        }
      uint32_t qb = base + C::oStage + s * C::kStage, dob = qb + C::kTile;
      uint32_t qt = qb, dot = dob;  // B operands of dK += dS^T Q and dV += P^T dO
      if constexpr (C::kF32) {
        constexpr int NT = C::kConsumers;
        const int ct = threadIdx.x;  // of the consumer warpgroups
        if (it > 0) bar_sync(1, NT);  // the last tile's products are done with the splits
        unsigned char* sp = sm + C::oSplit;
        split_tile<C::kTile, NT>(raw, sp, sp + C::kTile, ct);
        split_tile<C::kTile, NT>(raw + C::kTile, sp + 2 * C::kTile, sp + 3 * C::kTile, ct);
        split_transposed<BS, DS, NT>(raw, sm + C::oT, slice * DS, ct);
        split_transposed<BS, DS, NT>(raw + C::kTile, sm + C::oT + C::kT, slice * DS, ct);
        fence_proxy_async();
        bar_sync(1, NT);
        mbar_arrive(&empty[s]);
        qb = base + C::oSplit;
        dob = qb + 2 * C::kTile;
        qt = base + C::oT;
        dot = qt + C::kT;
      }

      // S^T and dP^T: 64 keys x BS queries per warpgroup
      float p[BS / 8][4], ds[BS / 8][4];
      wgmma_fence();
      mma_abt<T, BS, C::BR, C::kSSteps>(p, base, 64 * wgi, qb, kLo, C::kTile);
      mma_abt<T, BS, C::BR, C::kSSteps>(ds, base + C::kOwn, 64 * wgi, dob, kLo, C::kTile);
      wgmma_commit();
      wgmma_wait();
      fence_regs(p);
      fence_regs(ds);

      const int q0 = it * BS;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = i & 1;
          const float pv =
              q0 + 8 * j + 2 * t + e < n ? exp2f(p[j][i] * sl2 - lse_c[j][e]) : 0.f;
          p[j][i] = pv;
          ds[j][i] = pv * (ds[j][i] - dl_c[j][e]) * scale;
        }
      PFrag<T, BS / 8> fp, fd;
      fp.set(p);
      fd.set(ds);

      const int col0 = C::kF32 ? 0 : slice * DS / 64;  // bf16: the slice's atom column
      if constexpr (DS == 64) {  // both products in flight at once
        float f[8][4], g[8][4];
        wgmma_fence();
        mma_pv<T, DS, BS / 8, BS>(f, fp, dot, col0);  // P^T dO
        mma_pv<T, DS, BS / 8, BS>(g, fd, qt, col0);   // dS^T Q
        wgmma_commit();
        wgmma_wait();
        fence_regs(f);
        fence_regs(g);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[j][i] += f[j][i];
            acc_k[j][i] += g[j][i];
          }
      } else {  // one after the other, through one fresh accumulator of DS columns
        float f2[DS / 8][4];
        wgmma_fence();
        mma_pv<T, DS, BS / 8, BS>(f2, fp, dot, col0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(f2);
#pragma unroll
        for (int j = 0; j < DS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_v[j][i] += f2[j][i];
        wgmma_fence();
        mma_pv<T, DS, BS / 8, BS>(f2, fd, qt, col0);
        wgmma_commit();
        wgmma_wait();
        fence_regs(f2);
#pragma unroll
        for (int j = 0; j < DS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_k[j][i] += f2[j][i];
      }
      if constexpr (!C::kF32) mbar_arrive(&empty[s]);
    }

    const int row0 = k_blk + 64 * wgi + 16 * (tid >> 5);
    const long long ob = static_cast<long long>(b) * n * D;
    store_rows<T, DS / 8>(dk + ob, acc_k, D, row0, slice * DS, n, 1.f, 1.f);
    store_rows<T, DS / 8>(dv + ob, acc_v, D, row0, slice * DS, n, 1.f, 1.f);
  }
}

// dQ: BR own queries, BS keys a streamed tile.
template <typename T, int D, int DS, int BS, int NW, int ST>
__global__ void __launch_bounds__(Cfg<T, D, DS, BS, NW, false, ST>::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta, T* __restrict__ dq, int n,
                    float scale) {
  using C = Cfg<T, D, DS, BS, NW, false, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* empty = full + C::kStages;
  uint64_t* own = empty + C::kStages;
  const int b = blockIdx.y, slice = blockIdx.z;
  const int q_blk = blockIdx.x * C::BR;
  const int tiles = (n + BS - 1) / BS;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NW);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NW) {
    if constexpr (NW > 1) reg_dealloc<24>();
    if (threadIdx.x == 128 * NW)
      produce<C, false>(sm, full, empty, own, &tm_q, &tm_do, &tm_k, &tm_v, &tm_lse, &tm_delta,
                        q_blk, b, n, tiles);
  } else {
    if constexpr (NW > 1) reg_alloc<240>();
    const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int t = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
    const uint32_t base = smem_u32(sm);
    mbar_wait(own, 0);
    // rows g and g + 8 of this warp: LSE (log2 units) and Δ
    const int r = 64 * wgi + 16 * (tid >> 5) + g;
    const float* stats = reinterpret_cast<const float*>(sm + C::oStats);
    const float row_lse[2] = {stats[r] * kLog2e, stats[r + 8] * kLog2e};
    const float row_dl[2] = {stats[128 + r], stats[128 + r + 8]};
    split_own<C>(sm);

    float acc[DS / 8][4];
    zero(acc);
    const float sl2 = scale * kLog2e;
    constexpr int kLo = C::kF32 ? C::oA0lo : 0;

    for (int it = 0; it < tiles; ++it) {
      const int s = it % C::kStages;
      mbar_wait(&full[s], (it / C::kStages) & 1);
      uint32_t kb = base + C::oStage + s * C::kStage, vb = kb + C::kTile;
      uint32_t kt = kb;  // B operand of dQ += dS K
      if constexpr (C::kF32) {
        unsigned char* raw = sm + C::oStage + s * C::kStage;
        constexpr int NT = C::kConsumers;
        const int ct = threadIdx.x;  // of the consumer warpgroups
        if (it > 0) bar_sync(1, NT);
        unsigned char* sp = sm + C::oSplit;
        split_tile<C::kTile, NT>(raw, sp, sp + C::kTile, ct);
        split_tile<C::kTile, NT>(raw + C::kTile, sp + 2 * C::kTile, sp + 3 * C::kTile, ct);
        split_transposed<BS, DS, NT>(raw, sm + C::oT, slice * DS, ct);
        fence_proxy_async();
        bar_sync(1, NT);
        mbar_arrive(&empty[s]);
        kb = base + C::oSplit;
        vb = kb + 2 * C::kTile;
        kt = base + C::oT;
      }

      // S and dP: 64 queries x BS keys per warpgroup
      float p[BS / 8][4], ds[BS / 8][4];
      wgmma_fence();
      mma_abt<T, BS, C::BR, C::kSSteps>(p, base, 64 * wgi, kb, kLo, C::kTile);
      mma_abt<T, BS, C::BR, C::kSSteps>(ds, base + C::kOwn, 64 * wgi, vb, kLo, C::kTile);
      wgmma_commit();
      wgmma_wait();
      fence_regs(p);
      fence_regs(ds);

      const int k0 = it * BS;
#pragma unroll
      for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const float pv =
              k0 + 8 * j + 2 * t + (i & 1) < n ? exp2f(p[j][i] * sl2 - row_lse[h]) : 0.f;
          ds[j][i] = pv * (ds[j][i] - row_dl[h]) * scale;
        }
      PFrag<T, BS / 8> fd;
      fd.set(ds);

      const int col0 = C::kF32 ? 0 : slice * DS / 64;
      float f[DS / 8][4];
      wgmma_fence();
      mma_pv<T, DS, BS / 8, BS>(f, fd, kt, col0);  // dS K, a fresh chain
      wgmma_commit();
      wgmma_wait();
      fence_regs(f);
      if constexpr (!C::kF32) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < DS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += f[j][i];
    }

    const int row0 = q_blk + 64 * wgi + 16 * (tid >> 5);
    store_rows<T, DS / 8>(dq + static_cast<long long>(b) * n * D, acc, D, row0, slice * DS, n,
                          1.f, 1.f);
  }
}

// The tensor maps of both main kernels: the dK / dV kernel's own K and V
// (boxes of KR rows) and streamed Q, dO, LSE and Δ (KB rows), the dQ
// kernel's own Q, dO, LSE and Δ (QR rows) and streamed K and V (QB rows).
struct Maps {
  CUtensorMap k_own, v_own, q_str, do_str, lse_str, dl_str;
  CUtensorMap q_own, do_own, k_str, v_str, lse_own, dl_own;
};

inline cudaError_t encode(Maps& m, bool f32, int d, const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* delta, int b, int n,
                          const Strides& st, int kr, int kb, int qr, int qb) {
  const long long rows = static_cast<long long>(b) * n;
  cudaError_t err = srewd::map_3d(&m.k_own, k, f32, d, n, b, st.k_r, st.k_b, kr);
  if (err == cudaSuccess) err = srewd::map_3d(&m.v_own, v, f32, d, n, b, st.v_r, st.v_b, kr);
  if (err == cudaSuccess) err = srewd::map_3d(&m.q_str, q, f32, d, n, b, st.q_r, st.q_b, kb);
  if (err == cudaSuccess) err = srewd::map_3d(&m.do_str, dout, f32, d, n, b, d, n * d, kb);
  if (err == cudaSuccess) err = srewd::map_1d(&m.lse_str, lse, rows, kb);
  if (err == cudaSuccess) err = srewd::map_1d(&m.dl_str, delta, rows, kb);
  if (err == cudaSuccess) err = srewd::map_3d(&m.q_own, q, f32, d, n, b, st.q_r, st.q_b, qr);
  if (err == cudaSuccess) err = srewd::map_3d(&m.do_own, dout, f32, d, n, b, d, n * d, qr);
  if (err == cudaSuccess) err = srewd::map_3d(&m.k_str, k, f32, d, n, b, st.k_r, st.k_b, qb);
  if (err == cudaSuccess) err = srewd::map_3d(&m.v_str, v, f32, d, n, b, st.v_r, st.v_b, qb);
  if (err == cudaSuccess) err = srewd::map_1d(&m.lse_own, lse, rows, qr);
  if (err == cudaSuccess) err = srewd::map_1d(&m.dl_own, delta, rows, qr);
  return err;
}

// dK/dV tiles <KS output columns, KB queries a tile, KW warpgroups> and dQ
// tiles <QS, QB keys a tile, QW> of one head width, each with ST stages.
template <typename T, int D, int KS, int KB, int KW, int QS, int QB, int QW, int ST>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int b,
                   int n, const Strides& st, float scale, cudaStream_t stream) {
  using CK = Cfg<T, D, KS, KB, KW, true, ST>;
  using CQ = Cfg<T, D, QS, QB, QW, false, ST>;
  Maps m;
  cudaError_t err = encode(m, CK::kF32, D, q, k, v, dout, lse, delta, b, n, st, CK::BR, KB,
                           CQ::BR, QB);
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, D, KS, KB, KW, ST>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, CK::kBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((n + CK::BR - 1) / CK::BR, b, CK::kSlices), CK::kThreads, CK::kBytes, stream>>>(
      m.k_own, m.v_own, m.q_str, m.do_str, m.lse_str, m.dl_str, static_cast<T*>(dk),
      static_cast<T*>(dv), n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D, QS, QB, QW, ST>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::kBytes);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((n + CQ::BR - 1) / CQ::BR, b, CQ::kSlices), CQ::kThreads, CQ::kBytes, stream>>>(
      m.q_own, m.do_own, m.k_str, m.v_str, m.lse_own, m.dl_own, static_cast<T*>(dq), n, scale);
  return cudaGetLastError();
}

// Float32 at D >= 256, where the own tiles with their lo parts (256 KB at
// D=256, 512 KB at D=512 for K and V of 64 rows) do not fit shared memory.
// The own tiles are the A operands of S and dP, so they are read from
// shared memory into registers, k-step by k-step, and split there (the
// TF32 register A operand): they need no lo parts and no split pass. With
// RES they stay in shared memory, raw, for the whole block (D=256: 128
// KB); else their chunks come through the ring with the streamed ones, for
// every streamed tile (again from L2). For every streamed tile of BS rows,
// its chunks of DC = 64 columns land in the ring; the consumers split each
// in place, its lo parts beside the ring, and add its S and dP (fresh
// 3xTF32 chains of 8 k-steps) into S and dP in float32, as
// flash_fwd_stream_kernel does for S. The chunks inside the block's output
// slice of DS columns are also split and transposed, before their in-place
// split, into the B operands of the second products (Q^T and dO^T for
// dK / dV, K^T for dQ), which run as in the kernels above, 64 output
// columns a chain. One consumer warpgroup of BR = 64 own rows. Shared
// memory: RES: the own tiles A0, A1 [BR x D] | ST stages of (not RES: the
// own chunks A0, A1 [BR x DC] and) the streamed chunks S0, S1 [BS x DC] |
// the streamed chunks' lo parts | the split, transposed S0 (dK / dV: and
// S1) of the slice, [DS x 8 BS] each | LSE and Δ: the own rows' (dQ), or
// two streamed tiles' (dK / dV) | mbarriers.
template <int D, int DS, int BS, bool DKDV, int ST, bool RES>
struct StreamCfg {
  static constexpr int DC = 64;
  static constexpr int kChunks = D / DC;
  static constexpr int BR = 64;
  static constexpr int kSlices = D / DS;
  static constexpr int kThreads = 256;
  static constexpr int kOwn = RES ? BR * D * 4 : 0;  // a resident own tile
  static constexpr int kA = RES ? 0 : BR * DC * 4;   // an own chunk in a stage
  static constexpr int kS = BS * DC * 4;             // a streamed chunk
  static constexpr int oS = 2 * kA;                  // the streamed chunks in a stage
  static constexpr int kStage = 2 * kA + 2 * kS;
  static constexpr int oStage = 2 * kOwn;
  static constexpr int oLo = oStage + ST * kStage;
  static constexpr int kT = DS * 8 * BS;
  static constexpr int oT = oLo + 2 * kS;
  static constexpr int kSlot = 4 * BS > 128 ? 4 * BS : 128;  // a tile's LSE or Δ (dK / dV)
  static constexpr int oStats = oT + (DKDV ? 2 : 1) * kT;
  static constexpr int oBar = oStats + 1024;
  static constexpr int kBytes = oBar + 16 * ST + 8 + srewd::kAlignSlack;
  static_assert(D % DS == 0 && DS % DC == 0 && BS == 32 && 4 * kSlot <= 1024, "tile shape");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// acc += P B over the 8 KT rows of a transposed split B tile `bt` of NC rows
// (TF32), 64 columns a fresh chain
template <int NC, int KT>
__device__ __forceinline__ void add_pv(float (&acc)[NC / 8][4], PFrag<float, KT>& p,
                                       uint32_t bt) {
#pragma unroll
  for (int ch = 0; ch < NC / 64; ++ch) {
    float f[8][4];
    wgmma_fence();
    mma_pv<float, NC, KT, 8 * KT, 1>(f, p, bt, 0, ch);
    wgmma_commit();
    wgmma_wait();
    fence_regs(f);
    fence_regs(p.hi);
    fence_regs(p.lo);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[8 * ch + j][i] += f[j][i];
  }
}

// ps = A0 S0^T and pd = A1 S1^T over one chunk (8 k-steps), fresh chains:
// A0, A1 raw K-major tiles of R rows at a0, a1 whose chunk starts at byte
// `b0` of a row, split in registers (two k-steps' parts in flight); S0, S1
// split K-major tiles of 32 rows at shared addresses s0, s1, lo parts `lo`
// bytes on.
template <int R>
__device__ __forceinline__ void chunk_products(float (&ps)[4][4], float (&pd)[4][4],
                                               const unsigned char* a0, const unsigned char* a1,
                                               int b0, uint32_t s0, uint32_t s1, uint32_t lo) {
  uint32_t h[2][2][4], l[2][2][4];  // [k-step parity][operand]
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int u = kk & 1;
    a_frag<R>(a0, b0 + 32 * kk, h[u][0], l[u][0]);
    a_frag<R>(a1, b0 + 32 * kk, h[u][1], l[u][1]);
    const uint32_t k0 = kstep_addr<32>(s0, 0, kk), k1 = kstep_addr<32>(s1, 0, kk);
    wgmma_fence();
    RS<float, 32>::mma(&ps[0][0], l[u][0], desc(k0), kk > 0);
    RS<float, 32>::mma(&ps[0][0], h[u][0], desc(k0 + lo), 1);
    RS<float, 32>::mma(&ps[0][0], h[u][0], desc(k0), 1);
    RS<float, 32>::mma(&pd[0][0], l[u][1], desc(k1), kk > 0);
    RS<float, 32>::mma(&pd[0][0], h[u][1], desc(k1 + lo), 1);
    RS<float, 32>::mma(&pd[0][0], h[u][1], desc(k1), 1);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(h[u ^ 1]);  // the last k-step's parts: its products are done
    fence_regs(l[u ^ 1]);
  }
  wgmma_wait();
  fence_regs(ps);
  fence_regs(pd);
  fence_regs(h[1]);
  fence_regs(l[1]);
}

// DKDV: own K and V (a0, a1), streamed Q and dO (s0, s1), outputs dK (g0)
// and dV (g1). Else: own Q and dO, streamed K and V, output dQ (g0).
template <int D, int DS, int BS, bool DKDV, int ST, bool RES>
__global__ void __launch_bounds__(256, 1)
flash_bwd_stream_kernel(const __grid_constant__ CUtensorMap tm_a0,
                        const __grid_constant__ CUtensorMap tm_a1,
                        const __grid_constant__ CUtensorMap tm_s0,
                        const __grid_constant__ CUtensorMap tm_s1,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta, float* __restrict__ g0,
                        float* __restrict__ g1, int n, float scale) {
  using C = StreamCfg<D, DS, BS, DKDV, ST, RES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* empty = full + ST;
  uint64_t* own = empty + ST;  // the resident own tiles; dQ: the own rows' LSE and Δ
  const int b = blockIdx.y, slice = blockIdx.z;
  const int r_blk = blockIdx.x * C::BR;
  const int tiles = (n + BS - 1) / BS;
  constexpr bool kOwnBar = RES || !DKDV;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(own, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {
      if constexpr (kOwnBar) {
        mbar_expect_tx(own, 2 * C::kOwn + (DKDV ? 0 : 8 * C::BR));
        if constexpr (RES) {
#pragma unroll
          for (int a = 0; a < D / 32; ++a) {
            tma_load_3d(sm + a * C::BR * 128, &tm_a0, own, 32 * a, r_blk, b);
            tma_load_3d(sm + C::kOwn + a * C::BR * 128, &tm_a1, own, 32 * a, r_blk, b);
          }
        }
        if constexpr (!DKDV) {
          tma_load_1d(sm + C::oStats, &tm_lse, own, b * n + r_blk);
          tma_load_1d(sm + C::oStats + 512, &tm_delta, own, b * n + r_blk);
        }
      }
      for (int job = 0; job < tiles * C::kChunks; ++job) {
        const int s = job % ST, it = job / C::kChunks, c = job % C::kChunks;
        if (job >= ST) mbar_wait(&empty[s], ((job / ST) - 1) & 1);
        unsigned char* st = sm + C::oStage + s * C::kStage;
        const bool stats = DKDV && c == 0;  // the tile's LSE and Δ come with its first chunk
        mbar_expect_tx(&full[s], C::kStage + (stats ? 8 * BS : 0));
#pragma unroll
        for (int a = 0; a < C::DC / 32; ++a) {
          const int col = c * C::DC + 32 * a;
          if constexpr (!RES) {
            tma_load_3d(st + a * C::BR * 128, &tm_a0, &full[s], col, r_blk, b);
            tma_load_3d(st + C::kA + a * C::BR * 128, &tm_a1, &full[s], col, r_blk, b);
          }
          tma_load_3d(st + C::oS + a * BS * 128, &tm_s0, &full[s], col, it * BS, b);
          tma_load_3d(st + C::oS + C::kS + a * BS * 128, &tm_s1, &full[s], col, it * BS, b);
        }
        if (stats) {
          const int slot = 2 * (it & 1) * C::kSlot;
          tma_load_1d(sm + C::oStats + slot, &tm_lse, &full[s], b * n + it * BS);
          tma_load_1d(sm + C::oStats + slot + C::kSlot, &tm_delta, &full[s], b * n + it * BS);
        }
      }
    }
  } else {
    const int tid = threadIdx.x, t = tid & 3, g = (tid & 31) >> 2;
    const uint32_t base = smem_u32(sm);
    const float sl2 = scale * kLog2e;
    const int cs = slice * (DS / C::DC);  // the slice's first chunk
    float row_lse[2] = {0.f, 0.f}, row_dl[2] = {0.f, 0.f};  // dQ: rows g and g + 8
    if constexpr (kOwnBar) mbar_wait(own, 0);
    if constexpr (!DKDV) {
      const int r = 16 * (tid >> 5) + g;
      const float* stats = reinterpret_cast<const float*>(sm + C::oStats);
      row_lse[0] = stats[r] * kLog2e;
      row_lse[1] = stats[r + 8] * kLog2e;
      row_dl[0] = stats[128 + r];
      row_dl[1] = stats[128 + r + 8];
    }

    float acc0[DS / 8][4], acc1[DKDV ? DS / 8 : 1][4];
    zero(acc0);
    zero(acc1);
    int job = 0;
    for (int it = 0; it < tiles; ++it) {
      // S and dP (dK / dV: S^T and dP^T), 64 own rows x BS, summed over the chunks
      float sc[BS / 8][4], dp[BS / 8][4];
      zero(sc);
      zero(dp);
      for (int c = 0; c < C::kChunks; ++c, ++job) {
        const int s = job % ST;
        mbar_wait(&full[s], (job / ST) & 1);
        unsigned char* st = sm + C::oStage + s * C::kStage;
        unsigned char* str = st + C::oS;  // the streamed chunks
        bar_sync(1, 128);  // the last products are done with the lo parts and the slice's B
        if (c >= cs && c < cs + DS / C::DC) {
          const int r0 = C::DC * (c - cs);
          split_transposed<BS, C::DC, 128, DS>(str, sm + C::oT, 0, tid, r0);
          if constexpr (DKDV)
            split_transposed<BS, C::DC, 128, DS>(str + C::kS, sm + C::oT + C::kT, 0, tid, r0);
          bar_sync(1, 128);  // read before the split below overwrites the chunk
        }
        split_tile<2 * C::kS, 128>(str, str, sm + C::oLo, tid);
        fence_proxy_async();
        bar_sync(1, 128);
        const uint32_t sb = smem_u32(str);
        float ps[BS / 8][4], pd[BS / 8][4];
        if constexpr (RES)
          chunk_products<C::BR>(ps, pd, sm, sm + C::kOwn, 256 * c, sb, sb + C::kS,
                                base + C::oLo - sb);
        else
          chunk_products<C::BR>(ps, pd, st, st + C::kA, 0, sb, sb + C::kS, base + C::oLo - sb);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int j = 0; j < BS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[j][i] += ps[j][i];
            dp[j][i] += pd[j][i];
          }
      }

      const int s0 = it * BS;
      const uint32_t bt = base + C::oT;
      if constexpr (DKDV) {
        const float* lse_s =
            reinterpret_cast<const float*>(sm + C::oStats + 2 * (it & 1) * C::kSlot);
        const float* dl_s = lse_s + C::kSlot / 4;
#pragma unroll
        for (int j = 0; j < BS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * j + 2 * t + (i & 1);  // query of this column in the tile
            const float pv =
                s0 + col < n ? exp2f(sc[j][i] * sl2 - lse_s[col] * kLog2e) : 0.f;
            sc[j][i] = pv;
            dp[j][i] = pv * (dp[j][i] - dl_s[col]) * scale;
          }
        PFrag<float, BS / 8> fp;
        fp.set(sc);
        add_pv<DS, BS / 8>(acc1, fp, bt + C::kT);  // dV += P^T dO
        PFrag<float, BS / 8> fd;
        fd.set(dp);
        add_pv<DS, BS / 8>(acc0, fd, bt);  // dK += dS^T Q
      } else {
#pragma unroll
        for (int j = 0; j < BS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1;
            const float pv = s0 + 8 * j + 2 * t + (i & 1) < n
                                 ? exp2f(sc[j][i] * sl2 - row_lse[h]) : 0.f;
            dp[j][i] = pv * (dp[j][i] - row_dl[h]) * scale;
          }
        PFrag<float, BS / 8> fd;
        fd.set(dp);
        add_pv<DS, BS / 8>(acc0, fd, bt);  // dQ += dS K
      }
    }

    const int row0 = r_blk + 16 * (tid >> 5);
    const long long ob = static_cast<long long>(b) * n * D;
    store_rows<float, DS / 8>(g0 + ob, acc0, D, row0, slice * DS, n, 1.f, 1.f);
    if constexpr (DKDV) store_rows<float, DS / 8>(g1 + ob, acc1, D, row0, slice * DS, n, 1.f, 1.f);
  }
}

// float32 at D >= 256: the dK / dV and dQ stream kernels, DS output columns
// a block, BS rows a streamed tile, ST stages, the own tiles resident (RES)
// or streamed.
template <int D, int DS, int BS, int ST, bool RES>
cudaError_t launch_stream(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, void* dk, void* dv,
                          int b, int n, const Strides& st, float scale, cudaStream_t stream) {
  using CK = StreamCfg<D, DS, BS, true, ST, RES>;
  using CQ = StreamCfg<D, DS, BS, false, ST, RES>;
  Maps m;
  cudaError_t err =
      encode(m, true, D, q, k, v, dout, lse, delta, b, n, st, CK::BR, BS, CQ::BR, BS);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + CK::BR - 1) / CK::BR, b, CK::kSlices);

  auto dkdv = flash_bwd_stream_kernel<D, DS, BS, true, ST, RES>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, CK::kBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<grid, CK::kThreads, CK::kBytes, stream>>>(m.k_own, m.v_own, m.q_str, m.do_str,
                                                   m.lse_str, m.dl_str, static_cast<float*>(dk),
                                                   static_cast<float*>(dv), n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_stream_kernel<D, DS, BS, false, ST, RES>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::kBytes);
  if (err != cudaSuccess) return err;
  dqk<<<grid, CQ::kThreads, CQ::kBytes, stream>>>(m.q_own, m.do_own, m.k_str, m.v_str,
                                                  m.lse_own, m.dl_own, static_cast<float*>(dq),
                                                  nullptr, n, scale);
  return cudaGetLastError();
}

}  // namespace fa3

// The warp-level design on mma.sync (attention_mma.cuh), kept for the widths that
// `dispatch` names below: float32 at D=256 and 512, where fa3's stream
// kernels take 1.6-2x its time (chip_smoke.py --k2-wide).
namespace fa2 {

using namespace srewd;

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

template <typename T, int D, int KM, int KD, int KS, int QM, int QD, int QS>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int b, int n, Strides st, float scale, cudaStream_t stream) {
  cudaError_t err;
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
}  // namespace fa2

// Tiles per head width: fa3::launch<T, D, dK/dV <DS, BS queries a tile, NW>,
// dQ <DS, BS keys a tile, NW>, ST stages>, shared memory in brackets (dK/dV;
// dQ).
//   bfloat16
//     D=64:  dK/dV 64, 64, 2; dQ 64, 64, 2; ST 4 (99 KB; 98 KB).
//     D=128: dK/dV 128, 32, 2; dQ 128, 64, 2; ST 3 (114 KB; 162 KB).
//     D=256: dK/dV 128, 32, 1; dQ 128, 32, 1; ST 2 (130 KB; 130 KB): two
//            slices.
//     D=512: dK/dV 128, 16, 1; dQ 128, 16, 1; ST 2 (194 KB; 194 KB): four
//            slices; the own K and V (Q and dO) alone are 128 KB.
//   float32 (the consumer warpgroups split the landed tiles together)
//     D=64:  dK/dV 64, 32, 2; dQ 64, 32, 2; ST 2 (226 KB; 210 KB): the own
//            tiles of 128 rows with their lo parts are 128 KB.
//     D=128: dK/dV 128, 16, 1; dQ 128, 16, 1; ST 2 (226 KB; 210 KB): one
//            warpgroup's own tiles with their lo parts are already 128 KB, so
//            the streamed tiles are 16 rows (n16 products).
//     D=256, D=512: the mma.sync kernels (fa2 above), unless
//            SREWD_K2_WIDE_WGMMA is defined: then fa3::launch_stream<D, DS,
//            BS 32, ST 3, RES>, D=256 DS 64 with the own tiles resident
//            (226 KB; 210 KB), D=512 DS 128 with them streamed (226 KB;
//            194 KB). On the card the stream kernels take 1.6-2x the
//            mma.sync kernels' time (chip_smoke.py --k2-wide): each block
//            runs every streamed tile through D / 64 chunks of small (n32)
//            products one after the other, and 64 own rows with output
//            slices leave 32-128 blocks at the main path's shapes.
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int b, int n, const Strides& st, float scale,
                     cudaStream_t stream) {
  const int rows = b * n;
  flash_bwd_delta_kernel<T><<<(rows * 32 + kDeltaThreads - 1) / kDeltaThreads, kDeltaThreads,
                              0, stream>>>(static_cast<const float*>(o),
                                           static_cast<const T*>(dout), delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr bool f32 = sizeof(T) == 4;
  switch (d) {
    case 64:
      if constexpr (f32)
        return fa3::launch<T, 64, 64, 32, 2, 64, 32, 2, 2>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                           b, n, st, scale, stream);
      else
        return fa3::launch<T, 64, 64, 64, 2, 64, 64, 2, 4>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                           b, n, st, scale, stream);
    case 128:
      if constexpr (f32)
        return fa3::launch<T, 128, 128, 16, 1, 128, 16, 1, 2>(q, k, v, dout, lse, delta, dq, dk,
                                                              dv, b, n, st, scale, stream);
      else
        return fa3::launch<T, 128, 128, 32, 2, 128, 64, 2, 3>(q, k, v, dout, lse, delta, dq, dk,
                                                              dv, b, n, st, scale, stream);
    case 256:
      if constexpr (f32)
#ifdef SREWD_K2_WIDE_WGMMA
        return fa3::launch_stream<256, 64, 32, 3, true>(q, k, v, dout, lse, delta, dq, dk, dv, b,
                                                        n, st, scale, stream);
#else
        return fa2::launch<T, 256, 1, 4, 32, 1, 4, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                       b, n, st, scale, stream);
#endif
      else
        return fa3::launch<T, 256, 128, 32, 1, 128, 32, 1, 2>(q, k, v, dout, lse, delta, dq, dk,
                                                           dv, b, n, st, scale, stream);
    case 512:
      if constexpr (f32)
#ifdef SREWD_K2_WIDE_WGMMA
        return fa3::launch_stream<512, 128, 32, 3, false>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                          b, n, st, scale, stream);
#else
        return fa2::launch<T, 512, 1, 8, 16, 1, 8, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                                       b, n, st, scale, stream);
#endif
      else
        return fa3::launch<T, 512, 128, 16, 1, 128, 16, 1, 2>(q, k, v, dout, lse, delta, dq, dk,
                                                           dv, b, n, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of q, k, v, dout, dq, dk and dv; `o` is
// the forward's O in float32 [B, N, D] (bfloat16: K1's `o32`, before its
// rounding). `delta` is float32 [B, N] scratch.
// Returns the cudaError_t of the tensor maps' encoding or of the launches
// (cudaGetLastError() after each), 0 on success. Does not synchronise.
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
