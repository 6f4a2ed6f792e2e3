// K4: the forward of a float32 3x3 convolution (stride 1, padding 1, one
// group) as an implicit GEMM for Hopper (sm_90a): 3xTF32 on the tensor cores
// by warpgroup MMA (wgmma), with TMA loads and warp specialisation.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA. It
// was added because cuDNN's float32 convolutions, on the CUDA cores (FFMA
// implicit GEMM and FFT-tiled algorithms, with layout transforms around
// them), took 83 % of a float32 phydiff sampling chain: cuDNN has no
// float32-accurate tensor-core path, and plain TF32 misses the float32
// limits by an order of magnitude.
//
// What bounds it: 2 * N * H * W * Cout * 9 * Cin operations against the
// input, weights and output read or written once; at the UNet's and the
// RRDB's shapes that is operations, at 495 / 3 = 165 TFLOP/s (float32 as
// 3xTF32). The design, with the building blocks of attention_wgmma.cuh:
//   * the GEMM is M = output pixels, N = Cout, K = 9 taps x Cin. A block
//     computes a tile of 8 x 16 output pixels (BM = 128) of one sample by
//     BN output channels, over a K loop of input-channel chunks of 32
//     (CK) and, for each chunk, the nine taps;
//   * activations are NCHW tensors in channels_last memory (NHWC): one TMA
//     load per chunk brings the tile's 10 x 18 pixel halo, 128 bytes of
//     channels a pixel, into shared memory (B128 swizzled); TMA's
//     zero fill out of bounds is the padding. The nine taps read that one
//     resident tile, so each input element comes from device memory once
//     per block, not nine times;
//   * operand A (pixels x channels) comes from registers: for tap (dy, dx)
//     a thread's rows are pixels shifted inside the halo tile, which no
//     wgmma descriptor can express, so each consumer thread loads its
//     fragment (4 floats a k-step, conflict-free under the swizzle) and
//     splits it into TF32 hi and lo parts there;
//   * operand B (the weights) is [2][9][Cout][Cin] float32, hi and lo
//     parts split by conv3x3_split_kernel, in the same call, only for a new
//     weight or weight version (the wrapper keeps them), K-major, streamed
//     by TMA per (chunk, tap) into a ring of stages, each completed on its
//     `full` mbarrier and handed back on its `empty` one;
//   * one producer warpgroup (one thread issues every TMA load; the others
//     give their registers to the consumers) and two consumer warpgroups of
//     64 pixels each; the blocks are persistent (one per SM)
//     and walk the work items in order, so the producer loads the next
//     item's stages while the consumers store this one's;
//   * 3xTF32 (as K1 and K2): per k-step of 8 channels a_lo b_hi + a_hi b_lo
//     + a_hi b_hi, small terms first. The tensor cores add with truncation,
//     so each (chunk, tap) stage is a fresh chain of 12 products (scale-d =
//     0 at its start), added to the running sum in float32 registers;
//   * small grids (8 x 16 and 16 x 32 maps at batch 8 make fewer tiles than
//     SMs): the input-channel chunks are split over `splits` work items,
//     each writing its partial sum to a workspace, and conv3x3_reduce_kernel
//     adds them in a fixed order with the bias. No atomics: the result is
//     the same bit for bit on every run.
// The tile and split choices are `ops/conv3x3.py` `conv3x3_plan`.
//
// Layout: x is [N, H, W, Cin] float32 in memory (the NCHW channels_last view
// the UNet holds), Cin a multiple of 4 (TMA's 16-byte strides); the output
// is [N, H, W, Cout], Cout a multiple of BN. Numerics: float32 inputs,
// float32 sums, the bias added once at the end.

#include "attention_wgmma.cuh"

namespace {

namespace k4 {

using namespace srewd::wg;

constexpr int TH = 8, TW = 16;           // output pixels of a tile: 8 rows x 16 columns
constexpr int HH = TH + 2, HW = TW + 2;  // its halo: 10 x 18 pixels
constexpr int CK = 32;                   // input channels a chunk: 128 bytes a pixel
constexpr int IST = 2;                   // input stages
constexpr int kConsumers = 256;          // two warpgroups, 64 pixels each
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kInTx = HH * HW * 128;            // bytes a halo box lands
constexpr int kIn = (kInTx + 1023) / 1024 * 1024;  // its stage, 1024-byte aligned

// BN output channels a block; WST weight stages of one (chunk, tap): BN rows
// of 128 bytes, hi then lo. Shared memory: IST input stages | WST weight
// stages | the mbarriers.
template <int BN>
struct Cfg {
  static constexpr int WST = BN == 128 ? 4 : (BN == 64 ? 6 : 8);
  static constexpr int kW = 2 * BN * 128;
  static constexpr int oW = IST * kIn;
  static constexpr int oBar = oW + WST * kW;
  static constexpr int kBytes = oBar + 16 * (IST + WST) + srewd::kAlignSlack;
  static_assert(BN == 32 || BN == 64 || BN == 128, "BN");
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

struct Shape {
  int n, h, w, cin, cout;
  int tiles_y, tiles_x, tiles_n, chunks, splits;
};

// A work item: n fastest, then the pixel tile, then the split, so the
// blocks running at once share input tiles and weights in L2.
struct Item {
  int b, y0, x0, n0, s, c0, c1;
};

__device__ __forceinline__ Item decode(int item, const Shape& sh, int bn) {
  Item it;
  const int nt = item % sh.tiles_n;
  int rest = item / sh.tiles_n;
  const int tiles_m = sh.n * sh.tiles_y * sh.tiles_x;
  const int mt = rest % tiles_m;
  it.s = rest / tiles_m;
  it.b = mt / (sh.tiles_y * sh.tiles_x);
  it.y0 = (mt / sh.tiles_x) % sh.tiles_y * TH;
  it.x0 = mt % sh.tiles_x * TW;
  it.n0 = nt * bn;
  it.c0 = it.s * sh.chunks / sh.splits;
  it.c1 = (it.s + 1) * sh.chunks / sh.splits;
  return it;
}

// box of a [N, H, W, C] map at (c0 along C, c1 along W, c2 along H, c3 along N)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ bias,
                   float* __restrict__ out, const Shape sh) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = srewd::aligned_smem(smem_raw);
  uint64_t* in_full = reinterpret_cast<uint64_t*>(sm + C::oBar);
  uint64_t* in_empty = in_full + IST;
  uint64_t* w_full = in_empty + IST;
  uint64_t* w_empty = w_full + C::WST;
  const int items = sh.tiles_n * sh.n * sh.tiles_y * sh.tiles_x * sh.splits;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < IST; ++s) {
      mbar_init(&in_full[s], 1);
      mbar_init(&in_empty[s], kConsumers);
    }
#pragma unroll
    for (int s = 0; s < C::WST; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread keeps the loads in flight; its
    // registers go to the consumers (setmaxnreg, as K1 does)
    reg_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      int in_it = 0, w_it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item it = decode(item, sh, BN);
        for (int c = it.c0; c < it.c1; ++c, ++in_it) {
          const int is = in_it % IST;
          if (in_it >= IST) mbar_wait(&in_empty[is], ((in_it / IST) - 1) & 1);
          mbar_expect_tx(&in_full[is], kInTx);
          tma_load_4d(sm + is * kIn, &tm_x, &in_full[is], c * CK, it.x0 - 1, it.y0 - 1, it.b);
          for (int tap = 0; tap < 9; ++tap, ++w_it) {
            const int ws = w_it % C::WST;
            if (w_it >= C::WST) mbar_wait(&w_empty[ws], ((w_it / C::WST) - 1) & 1);
            unsigned char* st = sm + C::oW + ws * C::kW;
            mbar_expect_tx(&w_full[ws], C::kW);
            tma_load_3d(st, &tm_w, &w_full[ws], c * CK, it.n0, tap);
            tma_load_3d(st + BN * 128, &tm_w, &w_full[ws], c * CK, it.n0, 9 + tap);
          }
        }
      }
    }
    return;
  }

  reg_alloc<240>();
  // consumer warpgroups: warp w holds output row w of the tile, lane
  // 4 g + t pixels g and g + 8 of it (the wgmma fragment rows) and, in a
  // k-step, channels t and t + 4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t wbase = smem_u32(sm + C::oW);
  const long long total = static_cast<long long>(sh.n) * sh.h * sh.w * sh.cout;
  int in_it = 0, w_it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = decode(item, sh, BN);
    float acc[BN / 8][4];
    zero(acc);
    for (int c = it.c0; c < it.c1; ++c, ++in_it) {
      const int is = in_it % IST;
      mbar_wait(&in_full[is], (in_it / IST) & 1);
      const unsigned char* tile = sm + is * kIn + 4 * t;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++w_it) {
        const int ws = w_it % C::WST;
        // halo pixel of row g; row g + 8 is 8 pixels (1024 bytes) on, in the
        // same swizzle phase
        const int r = (warp + tap / 3) * HW + g + tap % 3;
        const unsigned char* row = tile + r * 128;
        const int sw = r & 7;
        uint32_t hi[4][4], lo[4][4];
        // k-step kk's fragment: channels 8 kk + t (chunk 2 kk) and + 4
        auto frag = [&](int kk) {
          const int o0 = ((2 * kk) ^ sw) << 4, o1 = ((2 * kk + 1) ^ sw) << 4;
          split_tf32(*reinterpret_cast<const float*>(row + o0), hi[kk][0], lo[kk][0]);
          split_tf32(*reinterpret_cast<const float*>(row + 1024 + o0), hi[kk][1], lo[kk][1]);
          split_tf32(*reinterpret_cast<const float*>(row + o1), hi[kk][2], lo[kk][2]);
          split_tf32(*reinterpret_cast<const float*>(row + 1024 + o1), hi[kk][3], lo[kk][3]);
        };
        frag(0);
        mbar_wait(&w_full[ws], (w_it / C::WST) & 1);
        const uint32_t wb = wbase + ws * C::kW;
        float f[BN / 8][4];
        // each k-step's fragment is loaded and split while the previous
        // k-step's products run
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > 0) frag(kk);
          wgmma_fence();
          const uint64_t bh = desc(wb + 32 * kk), bl = desc(wb + BN * 128 + 32 * kk);
          RS<float, BN>::mma(&f[0][0], lo[kk], bh, kk > 0);
          RS<float, BN>::mma(&f[0][0], hi[kk], bl, 1);
          RS<float, BN>::mma(&f[0][0], hi[kk], bh, 1);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(f);
        fence_regs(hi);
        fence_regs(lo);
        mbar_arrive(&w_empty[ws]);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += f[j][i];
      }
      mbar_arrive(&in_empty[is]);
    }

    // this thread's pixels (row y, columns x0 + g and + 8), channels
    // n0 + 8 j + 2 t and + 1: 32 contiguous bytes a pixel across a quad
    const bool with_bias = sh.splits == 1 && bias != nullptr;
    float* dst = out + (sh.splits > 1 ? it.s * total : 0);
    const int y = it.y0 + warp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = it.x0 + g + 8 * h;
      if (y >= sh.h || x >= sh.w) continue;
      float* p = dst + ((static_cast<long long>(it.b) * sh.h + y) * sh.w + x) * sh.cout + it.n0 +
                 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (with_bias) {
          v0 += bias[it.n0 + 8 * j + 2 * t];
          v1 += bias[it.n0 + 8 * j + 2 * t + 1];
        }
        *reinterpret_cast<float2*>(p + 8 * j) = make_float2(v0, v1);
      }
    }
  }
}

// out = bias + the splits' partial sums, added in split order (float4s;
// Cout is a multiple of 4)
__global__ void conv3x3_reduce_kernel(const float4* __restrict__ ws,
                                      const float* __restrict__ bias, float4* __restrict__ out,
                                      long long total4, int cout, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = ws[i];
    for (int s = 1; s < splits; ++s) {
      const float4 b = ws[s * total4 + i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    if (bias != nullptr) {
      const int co = static_cast<int>((4 * i) % cout);
      a.x += bias[co];
      a.y += bias[co + 1];
      a.z += bias[co + 2];
      a.w += bias[co + 3];
    }
    out[i] = a;
  }
}

// w [Cout, Cin, 3, 3] -> ws [2][9][Cout][Cin]: TF32 hi parts, then lo parts
__global__ void conv3x3_split_kernel(const float* __restrict__ w, uint32_t* __restrict__ ws,
                                     int cout, int cin) {
  const int per_tap = cout * cin, total = 9 * per_tap;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int tap = i / per_tap, rem = i % per_tap;
    uint32_t hi, lo;
    split_tf32(w[9 * rem + tap], hi, lo);
    ws[i] = hi;
    ws[total + i] = lo;
  }
}

// Map of x, [N, H, W, C] float32 in memory, read in halo boxes of 32
// channels x HW x HH pixels, B128 swizzled; outside the map reads as zeros.
inline cudaError_t map_input(CUtensorMap* m, const float* x, int n, int h, int w, int c) {
  srewd::EncodeTiledFn fn = srewd::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                        static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 4, static_cast<cuuint64_t>(w) * c * 4,
                           static_cast<cuuint64_t>(h) * w * c * 4};
  cuuint32_t box[4] = {CK, HW, HH, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims, strides,
                  box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN>
cudaError_t launch(const float* x, const float* wsplit, const float* bias, float* out,
                   float* ws, const Shape& sh, int grid, cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap mx, mw;
  cudaError_t err = map_input(&mx, x, sh.n, sh.h, sh.w, sh.cin);
  if (err == cudaSuccess)
    err = srewd::map_3d(&mw, wsplit, true, sh.cin, sh.cout, 18, sh.cin,
                        static_cast<long long>(sh.cout) * sh.cin, BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3x3_fwd_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kBytes);
  if (err != cudaSuccess) return err;
  conv3x3_fwd_kernel<BN><<<grid, kThreads, C::kBytes, stream>>>(
      mx, mw, bias, sh.splits > 1 ? ws : out, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.splits == 1) return err;
  const long long total4 = static_cast<long long>(sh.n) * sh.h * sh.w * sh.cout / 4;
  const int blocks = static_cast<int>((total4 + 255) / 256 < 4096 ? (total4 + 255) / 256 : 4096);
  conv3x3_reduce_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(ws), bias,
                                                    reinterpret_cast<float4*>(out), total4,
                                                    sh.cout, sh.splits);
  return cudaGetLastError();
}

}  // namespace k4

}  // namespace

extern "C" {

// w [Cout, Cin, 3, 3] -> wsplit [2][9][Cout][Cin], the TF32 hi and lo parts
// (srewd_conv3x3_fwd's first launch for a new weight; alone, for timing).
int srewd_conv3x3_split_weights(const float* w, float* wsplit, int cout, int cin, void* stream) {
  const int total = 9 * cout * cin;
  const int blocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  k4::conv3x3_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      w, reinterpret_cast<uint32_t*>(wsplit), cout, cin);
  return static_cast<int>(cudaGetLastError());
}

// y = conv3x3(x, w) + bias. x: [N, H, W, Cin] float32 in memory, 16-byte
// aligned, Cin a multiple of 4; wsplit: [2][9][Cout][Cin] float32, the TF32
// hi and lo parts of w [Cout, Cin, 3, 3], made first from w when w is not
// null (a new weight or version) and taken as they are otherwise; bias:
// float32 [Cout] or null; out: [N, H, W, Cout]; ws: splits x the output's
// size (splits > 1) or null. bn (32, 64 or 128, dividing Cout), splits and
// grid are conv3x3_plan's. Returns the cudaError_t of the tensor maps'
// encoding or of the launches, 0 on success. Does not synchronise.
int srewd_conv3x3_fwd(const float* x, const float* w, float* wsplit, const float* bias,
                      float* out, float* ws, int n, int h, int wd, int cin, int cout, int bn,
                      int splits, int grid, void* stream) {
  k4::Shape sh{n, h, wd, cin, cout, (h + k4::TH - 1) / k4::TH, (wd + k4::TW - 1) / k4::TW,
               cout / bn, (cin + k4::CK - 1) / k4::CK, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin % 4 || cout % bn || splits < 1 || splits > sh.chunks || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (w != nullptr) {
    const int err = srewd_conv3x3_split_weights(w, wsplit, cout, cin, stream);
    if (err != 0) return err;
  }
  switch (bn) {
    case 32: return static_cast<int>(k4::launch<32>(x, wsplit, bias, out, ws, sh, grid, s));
    case 64: return static_cast<int>(k4::launch<64>(x, wsplit, bias, out, ws, sh, grid, s));
    case 128: return static_cast<int>(k4::launch<128>(x, wsplit, bias, out, ws, sh, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* srewd_cuda_error_string_conv3x3(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
