// Exact single-head attention O = softmax(scale * Q K^T) V for Hopper (sm_90a),
// on the tensor cores by warpgroup MMA (wgmma), with TMA loads and warp
// specialisation.
//
// Replaces the TPU kernel `flash_attention` in srewd_tpu/ops/flash_attention.py
// (body `_kernel`). That kernel keeps the whole K and V of a sample in VMEM
// and takes a full-row softmax; at the largest phydiff map (N=8192, D=64) K
// and V are 2 MB in float32, far beyond the 227 KB of shared memory a block
// may use here. So this kernel tiles K and V and keeps an online softmax
// (FA2/FA3): per query row a running max m and sum l, and a float32 output
// accumulator rescaled by exp(m_old - m_new) whenever the max moves,
// normalised by l at the end. The loop over K/V tiles inside a block
// replaces the TPU's sequential grid dimension.
//
// What bounds it: 4 * B * N^2 * D flops against 4 * B * N * D elements of
// device traffic. At the tensor cores' rates (float32 as 3xTF32, 495 / 3
// TFLOP/s; bfloat16 989) that is operations at the N >= 512 float32 shapes
// and at N=2048 and 8192 in bfloat16, bytes at the others. The design, with
// the building blocks of attention_wgmma.cuh:
//   * a block is NW consumer warpgroups of 64 query rows each and one
//     producer warpgroup, one thread of which issues every TMA load: Q once,
//     then each key tile's K and V into a ring of two stages, each completed
//     on its `full` mbarrier and handed back on its `empty` one;
//   * a consumer warpgroup takes S = Q K^T of a key tile by wgmma (Q and K
//     from shared memory), the online softmax on the accumulator registers,
//     and O += P V by wgmma with P as the register A operand: no score tile
//     passes through shared memory;
//   * float32 multiplies by 3xTF32 (float32-accurate): Q is split into hi
//     and lo parts once; each landed K tile is split, and each V tile split
//     and transposed (TF32 wgmma reads K-major B only), by the consumer
//     warpgroup, which then hands the raw stage back to the producer.
//     bfloat16 reads V as an MN-major B operand as it lands, and rounds P to
//     bf16 before P V, as the TPU kernel rounds its probabilities to V's
//     dtype;
//   * each key tile's P V is a fresh wgmma chain (scale-d = 0 at its start),
//     added to the running O in float32: the tensor cores add with
//     truncation, and a chain carried over all N keys would drift;
//   * the output is split into slices of DS columns, one per block
//     (blockIdx.z), where a 64 x D float32 accumulator would not fit a
//     thread's registers (D >= 256): each slice's block recomputes S over
//     the whole D;
//   * float32 at D >= 256 (flash_fwd_stream_kernel): Q's hi and lo parts
//     do not fit shared memory beside the tiles, so Q and K are streamed in
//     64-column chunks for every key tile and S is summed over the chunks.
// Keys at or past N (the tile TMA zero-fills) are masked to -inf before the
// softmax; query rows at or past N are not stored.
//
// Numerics: scores, softmax and the P V sums are float32; inputs float32 or
// bfloat16; the output is written in Q's dtype. Exponentials are exp2 of
// scores pre-multiplied by scale * log2(e).
//
// Layout: q, k, v are [B, N, D] with unit stride along D and any batch and
// row strides (in elements) whose byte sizes, and the base pointers, are
// multiples of 16, as TMA requires; the wrapper checks that. The 1x1 qkv /
// kv convolutions' slabs (row stride 3C or 2C) pass without a copy: the C
// entry point encodes one tensor map per operand ([B, N, D], boxes of 128
// bytes of a row) from the pointers and strides. The output is a contiguous
// [B, N, D] tensor the wrapper allocates.
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

#include "attention_wgmma.cuh"

namespace {

struct Strides {
  long long q_b, q_r, k_b, k_r, v_b, v_r;
};

namespace fa3 {

using namespace srewd::wg;

// NW consumer warpgroups (BQ = 64 NW query rows), BK keys a tile, DS output
// columns a block, ST stages. Shared memory, every region a multiple of
// 1024 bytes: Q [BQ x D] (float32: its hi part, in place) | Q's lo part
// (float32) | ST stages of K [BK x D] and V [BK x DS] | float32: K's hi and
// lo parts, V^T's split | the mbarriers.
template <typename T, int D, int DS, int BK, int NW, int ST>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kEsz = sizeof(T);
  static constexpr int kEpa = 128 / kEsz;       // elements in 128 bytes of a row
  static constexpr int BQ = 64 * NW;
  static constexpr int kSlices = D / DS;
  static constexpr int kSSteps = D * kEsz / 32;  // 32-byte k-steps of S over D
  static constexpr int kThreads = 128 * (NW + 1);
  static constexpr int kConsumers = 128 * NW;
  static constexpr int kStages = ST;
  static constexpr int kQ = BQ * D * kEsz;
  static constexpr int kK = BK * D * kEsz;
  static constexpr int kStage = kK + BK * DS * kEsz;
  static constexpr int kKsplit = kF32 ? kK : 0;  // each of K's hi and lo
  static constexpr int oQlo = kQ;
  static constexpr int oStage = oQlo + (kF32 ? kQ : 0);
  static constexpr int oKhi = oStage + kStages * kStage;
  static constexpr int oVt = oKhi + 2 * kKsplit;
  static constexpr int oBar = oVt + (kF32 ? DS * 8 * BK : 0);
  static constexpr int kBytes = oBar + 16 * ST + 8 + srewd::kAlignSlack;
  static_assert(D % DS == 0 && DS % 64 == 0 && BK % 16 == 0, "tile shape");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

// The online softmax of one key tile (keys k0 ..) on its score accumulator
// `sc`, rows g (i = 0, 1) and g + 8 (i = 2, 3) of this warp: keys at or past
// n are masked, the scores scaled by sl2 = scale * log2(e), the running max
// m and this thread's part of the running sum l updated; sc is left holding
// the unnormalised probabilities, alpha the rescale of the running O.
template <int KT>
__device__ __forceinline__ void online_softmax(float (&sc)[KT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int n, float sl2) {
  const int t = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * j + 2 * t + (i & 1);
      sc[j][i] = key < n ? sc[j][i] * sl2 : -INFINITY;
      mx[i >> 1] = fmaxf(mx[i >> 1], sc[j][i]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = quad_max(mx[h]);
    alpha[h] = exp2f(m[h] - mx[h]);  // 0 on the first tile
    m[h] = mx[h];
  }
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[j][i] = exp2f(sc[j][i] - m[i >> 1]);
      sum[i >> 1] += sc[j][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
}

// O / l of this warp's rows (from row0) into columns [slice DS, + DS) of o
// (and o32), and slice 0's row log-sum-exp into lse.
template <typename T, int D, int DS>
__device__ __forceinline__ void store_out(const float (&acc)[DS / 8][4], const float (&m)[2],
                                          const float (&l)[2], T* o, float* lse, float* o32,
                                          int b, int n, int row0, int slice) {
  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const long long ob = static_cast<long long>(b) * n * D;
  store_rows<T, DS / 8>(o + ob, acc, D, row0, slice * DS, n, 1.f / l0, 1.f / l1);
  if (o32 != nullptr)
    store_rows<float, DS / 8>(o32 + ob, acc, D, row0, slice * DS, n, 1.f / l0, 1.f / l1);
  if (lse != nullptr && slice == 0 && (threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2;
    float* lb = lse + static_cast<long long>(b) * n;
    if (row0 + g < n) lb[row0 + g] = (m[0] + log2f(l0)) * kLn2;
    if (row0 + g + 8 < n) lb[row0 + g + 8] = (m[1] + log2f(l1)) * kLn2;
  }
}

template <typename T, int D, int DS, int BK, int NW, int ST>
__global__ void __launch_bounds__(Cfg<T, D, DS, BK, NW, ST>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ o32, int n, float scale) {
  using C = Cfg<T, D, DS, BK, NW, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  const int b = blockIdx.y, slice = blockIdx.z;
  const int q_blk = blockIdx.x * C::BQ;
  const int tiles = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NW);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NW) {
    // producer warpgroup: one thread keeps the loads in flight
    if constexpr (NW > 1) reg_dealloc<24>();
    if (threadIdx.x == 128 * NW) {
      mbar_expect_tx(qbar, C::kQ);
#pragma unroll
      for (int a = 0; a < D / C::kEpa; ++a)
        tma_load_3d(sm + a * C::BQ * 128, &tm_q, qbar, a * C::kEpa, q_blk, b);
      for (int it = 0; it < tiles; ++it) {
        const int s = it % C::kStages;
        if (it >= C::kStages) mbar_wait(&empty[s], ((it / C::kStages) - 1) & 1);
        unsigned char* st = sm + C::oStage + s * C::kStage;
        mbar_expect_tx(&full[s], C::kStage);
#pragma unroll
        for (int a = 0; a < D / C::kEpa; ++a)
          tma_load_3d(st + a * BK * 128, &tm_k, &full[s], a * C::kEpa, it * BK, b);
#pragma unroll
        for (int a = 0; a < DS / C::kEpa; ++a)
          tma_load_3d(st + C::kK + a * BK * 128, &tm_v, &full[s], slice * DS + a * C::kEpa,
                      it * BK, b);
      }
    }
  } else {
    // consumer warpgroups
    if constexpr (NW > 1) reg_alloc<240>();
    const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const uint32_t base = smem_u32(sm);
    mbar_wait(qbar, 0);
    if constexpr (C::kF32) {
      // the consumer warpgroups split Q (its hi part in place) and then
      // every landed tile together
      split_tile<C::kQ, C::kConsumers>(sm, sm, sm + C::oQlo, threadIdx.x);
      fence_proxy_async();
      bar_sync(1, C::kConsumers);
    }

    float acc[DS / 8][4];
    zero(acc);
    float m[2] = {-INFINITY, -INFINITY};  // running max of the scaled log2 scores
    float l[2] = {0.f, 0.f};              // this thread's part of the running sum
    const float sl2 = scale * kLog2e;

    if constexpr (!C::kF32) {
      // bf16, pipelined within the warpgroup (FA3): tile it + 1's S and tile
      // it's P V are issued together, and tile it + 1's softmax runs while
      // P V does; two register sets hold P (the in-flight product's and the
      // next one's)
      auto stage = [&](int it) { return base + C::oStage + (it % C::kStages) * C::kStage; };
      float sc[BK / 8][4];
      mbar_wait(&full[0], 0);
      wgmma_fence();
      mma_abt<T, BK, C::BQ, C::kSSteps>(sc, base, 64 * wgi, stage(0));
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      float alpha[2], alpha_next[2] = {1.f, 1.f};
      online_softmax(sc, m, l, alpha, 0, n, sl2);
      PFrag<T, BK / 8> pf, pf_next;
      pf.set(sc);
      for (int it = 0; it < tiles; ++it) {
        const bool more = it + 1 < tiles;
        if (more) mbar_wait(&full[(it + 1) % C::kStages], ((it + 1) / C::kStages) & 1);
        wgmma_fence();
        if (more) {
          mma_abt<T, BK, C::BQ, C::kSSteps>(sc, base, 64 * wgi, stage(it + 1));
          wgmma_commit();
        }
        float f[DS / 8][4];
        mma_pv<T, DS, BK / 8, BK>(f, pf, stage(it) + C::kK);  // this tile's P V, a fresh chain
        wgmma_commit();
        if (more) {
          wgmma_wait<1>();
          fence_regs(sc);
          online_softmax(sc, m, l, alpha_next, (it + 1) * BK, n, sl2);
          pf_next.set(sc);
        }
        wgmma_wait();
        fence_regs(f);
        fence_regs(pf.a);
        mbar_arrive(&empty[it % C::kStages]);
#pragma unroll
        for (int j = 0; j < DS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(acc[j][i], alpha[i >> 1], f[j][i]);
        pf = pf_next;
        alpha[0] = alpha_next[0];
        alpha[1] = alpha_next[1];
      }
    } else {
      for (int it = 0; it < tiles; ++it) {
        const int s = it % C::kStages;
        mbar_wait(&full[s], (it / C::kStages) & 1);
        // float32: the consumers split K and split and transpose V, then
        // hand the raw stage back to the producer
        unsigned char* raw = sm + C::oStage + s * C::kStage;
        if (it > 0) bar_sync(1, C::kConsumers);  // the last tile's products are done with them
        split_tile<C::kK, C::kConsumers>(raw, sm + C::oKhi, sm + C::oKhi + C::kKsplit,
                                         threadIdx.x);
        split_transposed<BK, DS, C::kConsumers>(raw + C::kK, sm + C::oVt, 0, threadIdx.x);
        fence_proxy_async();
        bar_sync(1, C::kConsumers);
        mbar_arrive(&empty[s]);
        const uint32_t kb = base + C::oKhi, vb = base + C::oVt;

        float sc[BK / 8][4];
        wgmma_fence();
        mma_abt<T, BK, C::BQ, C::kSSteps>(sc, base, 64 * wgi, kb, C::oQlo, C::kKsplit);
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);

        float alpha[2];
        online_softmax(sc, m, l, alpha, it * BK, n, sl2);

        PFrag<T, BK / 8> pf;
        pf.set(sc);
        float f[DS / 8][4];
        wgmma_fence();
        mma_pv<T, DS, BK / 8, BK>(f, pf, vb);  // this tile's P V, a fresh chain
        wgmma_commit();
        wgmma_wait();
        fence_regs(f);
#pragma unroll
        for (int j = 0; j < DS / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(acc[j][i], alpha[i >> 1], f[j][i]);
      }
    }

    store_out<T, D, DS>(acc, m, l, o, lse, o32, b, n, q_blk + 64 * wgi + 16 * (tid >> 5), slice);
  }
}

template <typename T, int D, int DS, int BK, int NW, int ST>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, float* o32,
                   int b, int n, const Strides& st, float scale, cudaStream_t stream) {
  using C = Cfg<T, D, DS, BK, NW, ST>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = srewd::map_3d(&mq, q, C::kF32, D, n, b, st.q_r, st.q_b, C::BQ);
  if (err == cudaSuccess) err = srewd::map_3d(&mk, k, C::kF32, D, n, b, st.k_r, st.k_b, BK);
  if (err == cudaSuccess) err = srewd::map_3d(&mv, v, C::kF32, D, n, b, st.v_r, st.v_b, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_kernel<T, D, DS, BK, NW, ST>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + C::BQ - 1) / C::BQ, b, C::kSlices);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(mq, mk, mv, static_cast<T*>(o), lse, o32, n,
                                                   scale);
  return cudaGetLastError();
}

// Float32 at D >= 256, where Q split into its hi and lo parts (128 KB at
// D=256, 256 KB at D=512 for 64 rows) does not stay in shared memory: each
// key tile streams Q and K in chunks of DC = 64 columns through the ring (Q
// again from L2 for every key tile); the consumers split each chunk and add
// its S = Q_c K_c^T (a fresh 3xTF32 chain of 8 k-steps) into S in float32.
// Then V's slice lands, is split and transposed into the region the split
// chunk used, and P V follows as in flash_fwd_kernel. (Splitting the next
// chunk into a second buffer while this one's S runs measured no faster:
// the per-chunk barriers cost what the overlap gains.) Shared memory: ST
// stages of max(Q chunk [BQ x DC] + K chunk [BK x DC], V [BK x DS]) | the
// split chunk (Q_c hi, lo, K_c hi, lo), or V^T | the mbarriers.
template <int D, int DS, int BK, int NW, int ST>
struct StreamCfg {
  static constexpr int DC = 64;
  static constexpr int kChunks = D / DC;
  static constexpr int BQ = 64 * NW;
  static constexpr int kSlices = D / DS;
  static constexpr int kThreads = 128 * (NW + 1);
  static constexpr int kConsumers = 128 * NW;
  static constexpr int kQc = BQ * DC * 4;
  static constexpr int kKc = BK * DC * 4;
  static constexpr int kV = BK * DS * 4;
  static constexpr int kStage = kQc + kKc > kV ? kQc + kKc : kV;
  static constexpr int oSplit = ST * kStage;
  static constexpr int kSplit = 2 * (kQc + kKc) > DS * 8 * BK ? 2 * (kQc + kKc) : DS * 8 * BK;
  static constexpr int oBar = oSplit + kSplit;
  static constexpr int kBytes = oBar + 16 * ST + srewd::kAlignSlack;
  static_assert(D % DS == 0 && DS % 64 == 0 && D % DC == 0 && BK % 16 == 0, "tile shape");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

template <int D, int DS, int BK, int NW, int ST>
__global__ void __launch_bounds__(StreamCfg<D, DS, BK, NW, ST>::kThreads, 1)
flash_fwd_stream_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                        float* __restrict__ lse, int n, float scale) {
  using C = StreamCfg<D, DS, BK, NW, ST>;
  constexpr int kJobs = C::kChunks + 1;  // a key tile's loads: the chunks, then V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* empty = full + ST;
  const int b = blockIdx.y, slice = blockIdx.z;
  const int q_blk = blockIdx.x * C::BQ;
  const int tiles = (n + BK - 1) / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::kConsumers) {
    if constexpr (NW > 1) reg_dealloc<24>();
    if (threadIdx.x == C::kConsumers) {
      for (int job = 0; job < tiles * kJobs; ++job) {
        const int s = job % ST, it = job / kJobs, c = job % kJobs;
        if (job >= ST) mbar_wait(&empty[s], ((job / ST) - 1) & 1);
        unsigned char* st = sm + s * C::kStage;
        if (c < C::kChunks) {
          mbar_expect_tx(&full[s], C::kQc + C::kKc);
#pragma unroll
          for (int a = 0; a < C::DC / 32; ++a) {
            tma_load_3d(st + a * C::BQ * 128, &tm_q, &full[s], c * C::DC + 32 * a, q_blk, b);
            tma_load_3d(st + C::kQc + a * BK * 128, &tm_k, &full[s], c * C::DC + 32 * a,
                        it * BK, b);
          }
        } else {
          mbar_expect_tx(&full[s], C::kV);
#pragma unroll
          for (int a = 0; a < DS / 32; ++a)
            tma_load_3d(st + a * BK * 128, &tm_v, &full[s], slice * DS + 32 * a, it * BK, b);
        }
      }
    }
  } else {
    if constexpr (NW > 1) reg_alloc<240>();
    const int wgi = threadIdx.x >> 7;
    const uint32_t base = smem_u32(sm);
    unsigned char* sp = sm + C::oSplit;  // Q_c hi, lo | K_c hi, lo; or V^T
    const uint32_t qh = base + C::oSplit, kh = qh + 2 * C::kQc;

    float acc[DS / 8][4];
    zero(acc);
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    const float sl2 = scale * kLog2e;
    int job = 0;

    for (int it = 0; it < tiles; ++it) {
      float sc[BK / 8][4];
      zero(sc);
      for (int c = 0; c <= C::kChunks; ++c, ++job) {
        const int s = job % ST;
        mbar_wait(&full[s], (job / ST) & 1);
        unsigned char* raw = sm + s * C::kStage;
        bar_sync(1, C::kConsumers);  // every product that read the split region is done
        if (c < C::kChunks) {
          split_tile<C::kQc, C::kConsumers>(raw, sp, sp + C::kQc, threadIdx.x);
          split_tile<C::kKc, C::kConsumers>(raw + C::kQc, sp + 2 * C::kQc,
                                            sp + 2 * C::kQc + C::kKc, threadIdx.x);
        } else {
          split_transposed<BK, DS, C::kConsumers>(raw, sp, 0, threadIdx.x);
        }
        fence_proxy_async();
        bar_sync(1, C::kConsumers);
        mbar_arrive(&empty[s]);
        if (c == C::kChunks) break;
        float part[BK / 8][4];
        wgmma_fence();
        mma_abt<float, BK, C::BQ, C::DC / 8>(part, qh, 64 * wgi, kh, C::kQc, C::kKc);
        wgmma_commit();
        wgmma_wait();
        fence_regs(part);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] += part[j][i];
      }
      ++job;  // the V job, left by the break

      float alpha[2];
      online_softmax(sc, m, l, alpha, it * BK, n, sl2);
      PFrag<float, BK / 8> pf;
      pf.set(sc);
      float f[DS / 8][4];
      wgmma_fence();
      mma_pv<float, DS, BK / 8, BK>(f, pf, base + C::oSplit);
      wgmma_commit();
      wgmma_wait();
      fence_regs(f);
#pragma unroll
      for (int j = 0; j < DS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(acc[j][i], alpha[i >> 1], f[j][i]);
    }
    store_out<float, D, DS>(acc, m, l, o, lse, nullptr, b, n,
                            q_blk + 64 * wgi + 16 * ((threadIdx.x & 127) >> 5), slice);
  }
}

template <int D, int DS, int BK, int NW, int ST>
cudaError_t launch_stream(const void* q, const void* k, const void* v, void* o, float* lse,
                          int b, int n, const Strides& st, float scale, cudaStream_t stream) {
  using C = StreamCfg<D, DS, BK, NW, ST>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = srewd::map_3d(&mq, q, true, D, n, b, st.q_r, st.q_b, C::BQ);
  if (err == cudaSuccess) err = srewd::map_3d(&mk, k, true, D, n, b, st.k_r, st.k_b, BK);
  if (err == cudaSuccess) err = srewd::map_3d(&mv, v, true, D, n, b, st.v_r, st.v_b, BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_stream_kernel<D, DS, BK, NW, ST>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + C::BQ - 1) / C::BQ, b, C::kSlices);
  kernel<<<grid, C::kThreads, C::kBytes, stream>>>(mq, mk, mv, static_cast<float*>(o), lse, n,
                                                   scale);
  return cudaGetLastError();
}

}  // namespace fa3

// Tiles per head width: fa3::launch<T, D, DS, BK, NW, ST> (DS output columns
// a block, BK keys a tile, NW consumer warpgroups of 64 query rows, ST
// stages), shared memory in brackets.
//   bfloat16
//     D=64:  DS 64,  BK 128, NW 2, ST 4 (145 KB): S is 64 x 128 a warpgroup.
//     D=128: DS 128, BK 64,  NW 2, ST 4 (161 KB).
//     D=256: DS 128, BK 64,  NW 2, ST 3 (209 KB): two slices, S recomputed
//            in each.
//     D=512: DS 128, BK 32,  NW 1, ST 3 (185 KB): four slices; Q alone is
//            64 KB.
//   float32 (the consumer warpgroups split the landed tiles together)
//     D=64:  DS 64,  BK 64, NW 2, ST 2 (193 KB): Q hi/lo 64 KB, raw stages
//            64 KB, K hi/lo 32 KB, V^T hi/lo 32 KB.
//     D=128: DS 128, BK 32, NW 1, ST 2 (193 KB): Q hi/lo alone are 64 KB a
//            warpgroup.
//     D=256, D=512: fa3::launch_stream<D, DS 128, BK 64, NW, ST 2>: Q and K
//            streamed in 64-column chunks. D=256: NW 1 (129 KB): 128 blocks
//            at N=512, B=8, where NW 2 left half the SMs idle (chip_smoke
//            phase 3: 0.081 against 0.102 ms of device time). D=512: NW 2
//            (193 KB): four slices already make 128 blocks.
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, float* lse,
                     float* o32, int b, int n, const Strides& st, float scale,
                     cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  switch (d) {
    case 64:
      if constexpr (f32)
        return fa3::launch<T, 64, 64, 64, 2, 2>(q, k, v, o, lse, o32, b, n, st, scale, stream);
      else
        return fa3::launch<T, 64, 64, 128, 2, 4>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 128:
      if constexpr (f32)
        return fa3::launch<T, 128, 128, 32, 1, 2>(q, k, v, o, lse, o32, b, n, st, scale, stream);
      else
        return fa3::launch<T, 128, 128, 64, 2, 4>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 256:
      if constexpr (f32)
        return fa3::launch_stream<256, 128, 64, 1, 2>(q, k, v, o, lse, b, n, st, scale, stream);
      else
        return fa3::launch<T, 256, 128, 64, 2, 3>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    case 512:
      if constexpr (f32)
        return fa3::launch_stream<512, 128, 64, 2, 2>(q, k, v, o, lse, b, n, st, scale, stream);
      else
        return fa3::launch<T, 512, 128, 32, 1, 3>(q, k, v, o, lse, o32, b, n, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `lse`: null, or float32 [B, N] for the
// rows' log-sum-exp. `o32`: null, or float32 [B, N, D] for O before its
// rounding (bfloat16). Returns the cudaError_t of the tensor maps' encoding
// or of the launch (cudaGetLastError() right after it), 0 on success. Does
// not synchronise.
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
