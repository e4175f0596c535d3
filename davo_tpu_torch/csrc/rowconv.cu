// Fused conv chains of the serving path for Hopper (sm_90a).
//
// Replaces the TPU kernels of davo_tpu/kernels/rowconv.py:
//   conv_chain_strided (_strided_chain_kernel): SAME conv chain, any odd k,
//       stride 1 or 2, bias, ReLU per layer, taps of chosen layers;
//   conv_chain_nhwc (_chain_kernel): stride-1 3x3 SAME chain;
//   flow_level_fused (_flow_level_kernel): masked, ReLU'd cost volume ->
//       concat(cv, feat, flow_up) -> the 3x3 estimator chain.
// The TPU kernels keep a whole chain of one image in VMEM (rows layout,
// space-to-depth for stride 2, Mosaic-friendly masks). One image of a /4
// flow level is 3328 px x 96 ch, ~640 KB in bf16, well above the 227 KB
// a block can use, so here each TPU "kernel" is a chain of launches on one
// stream, one per layer, with the intermediates in device memory:
//
//   a layer kernel      one SAME conv layer (any odd k, stride 1 or 2, the
//                       Flax pads: low = total / 2), computing what a layer
//                       of the TPU kernels computes: operands rounded to the
//                       dot dtype, products summed in f32, + f32 bias, ONE
//                       rounding to the activation dtype, then ReLU;
//   flow_level_input_kernel  the estimator's input of a flow level, written
//                       straight into its buffer (no separate concat).
//
// Two layer kernels, chosen by mode (explicitly; neither stands in for
// the other), on one tile design:
//
// conv_mma_chunked_kernel / conv_mma_flat_kernel (bfloat16 and bf16_dot):
//   every product there has bf16 operands (activations bf16, or rounded
//   to bf16 as they are staged; weights packed as bf16), and a bf16 x
//   bf16 product is exact in f32, so the layer is an implicit GEMM on the
//   tensor cores, mma.sync m16n8k16 with f32 accumulators: M = a block's
//   tile of 16x8 or 8x16 output pixels (4 warps) or 16x16 (8 warps; each
//   warp two 16-pixel A tiles), N = its 8..96 output channels (NT
//   8-channel tiles; Cout padded to 8 with zero weights), K = k*k*Cin.
//   For Cin >= 16, K runs over chunks of 16 input channels: the tile's
//   input halo ((rows-1)*stride + k by (columns-1)*stride + k pixels;
//   stride 2 keeps even and odd columns apart) and
//   the chunk's weights are staged by cp.async, double-buffered where K
//   has two chunks or more and two stages fit, XOR-swizzled so that every ldmatrix is conflict-free, and
//   all k*k taps of the chunk are read from the staged halo (nothing is
//   re-read through L1). For Cin < 16 (images, the pose input), (tap,
//   channel) is flattened into K, padded to a multiple of 16 with zeros,
//   and the A fragments are gathered from the staged halo through a table
//   of offsets. The epilogue is the TPU kernel's: + f32 bias, ONE rounding
//   to the activation dtype, ReLU; the tile leaves through shared memory
//   as 16-byte stores. Chunking K lifts the old kernel's refusal of a
//   layer whose weights do not fit shared memory: only a tile's chunk is
//   staged. The tensor cores may round their f32 sums otherwise than IEEE
//   fma; chip_smoke.py holds every layer to phase 3d's limits.
//   Bound on this card: operations at 989 TFLOP/s bf16 for the wide
//   layers (the /4 estimator, 62.6 GFLOP at B=64: 0.063 ms), bytes for
//   the first layers of the strided chains. What limits it now: mma.sync
//   (not wgmma) issue and ldmatrix traffic, the staging of each chunk's
//   weights by every block (from L2), and, for Cin < 16, the scalar
//   gathers of A. The per-tile code and the layer's plan (tile, channel
//   tile, staging depth: `mma_plan`) are conv_mma.cuh's, which the
//   one-launch conv stack (conv_stack.cu) runs too.
//
// conv_tf32_chunked_kernel / conv_tf32_flat_kernel (float32): the same
//   tiles, K orders, staging and plan (`mma_plan`, NT up to 8) on
//   mma.sync m16n8k8 in split TF32 (conv_mma.cuh): float32 products and
//   sums within ~2^-22 of each product, as the FMA kernel it replaced
//   kept them. The weights come split from the host (`_pack_tf32`: hi and
//   lo planes of float32 in `_pack_mma`'s K order); the input is split
//   once, as it is staged (a bf16 input is exact in TF32: no lo, 2
//   products instead of 3); every 16 K's products go into a fresh
//   accumulator added to the running sum in float32. Bound on this card:
//   operations, the FLOPs as 3 TF32 passes at 494.7 TFLOP/s (the f32 FMA
//   rate, 67, bounded the FMA kernel); the /4 estimator at B=64, 62.6
//   GFLOP, 0.38 ms. What limits it: mma.sync issue (3 products for one),
//   the float32 staging (4x the bf16 bytes: hi and lo, 4 bytes each),
//   the FP32 adds of the fresh sums.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_mma.cuh"
#include "costvol_tile.cuh"

namespace {

using namespace davo;

// One element widened to float32: float32, or bf16 (as its bits).
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

// The estimator input of a flow level: out (B, H, W, cpad) channels
//   [0, D)          relu(sum_c f1[p, c] * f2[p + shift_k, c] / C), 0 outside the frame,
//   [D, D+Cf)       feat,
//   [D+Cf, D+Cf+Cu) flow_up,
//   [D+Cf+Cu, cpad) 0 (padding to a multiple of 4 channels),
// each rounded once to the activation dtype, as the TPU kernel's concat
// and cast. The training forward also keeps the unrounded values in a0
// (float32, same layout; null when serving): the reference's backward
// reads the float32 estimator input (layer 0's dW, the cost-volume gate).
//
// Bound on this card: bytes. Per pixel it reads f1, f2 and feat (C, C,
// Cf elements) and flow_up, and writes cpad activations (and cpad floats
// of a0); the 2*D*C FLOPs of the correlations take less time than those
// bytes at every level of the presets. The first design (one thread per
// output element, each re-reading a C-long dot product from device
// memory) read D*C*2 elements per pixel through the caches instead.
// Design: the cost volume's forward tile (costvol_tile.cuh, `cv_correlate`:
// the f1 tile and the f2 window staged by cp.async and read in place as
// bf16 or float32, 4 pixels x the shifts of a (tile row, dy) in
// registers; every sum runs over the channels ascending, fmaf, times 1/C
// last). The epilogue writes each tile row, one contiguous run of
// pixels x cpad channels, in groups of 4 channels a thread (cpad is a
// multiple of 4: a group never straddles a pixel): the staged
// correlations ReLU'd, feat and flow_up read as they come, zeros past
// them; 8-byte (bf16) or 16-byte (float32) stores, and a0's 16-byte ones.
// Where the tile plan refuses the search (above 43, whose smallest tile's
// window and outputs exceed a block's shared memory) the element kernel
// below computes the same values, one thread per output element.
template <typename T, int kS>
__global__ void __launch_bounds__(kS >= 0 ? 8 * kFwdRows * (2 * kS + 1) : kFwdGenericThreads,
                                  kS == 3 ? 3 : kS == 4 ? 2 : 1)
flow_level_input_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ feat,
                        const float* __restrict__ flow_up, void* __restrict__ out, int out_bf16,
                        float* __restrict__ a0, int H, int W, int C, int Cf, int Cu, int s_rt, int cpad, bool vec,
                        FwdPlan p) {
  extern __shared__ uint4 smem_u[];
  const int s = kS >= 0 ? kS : s_rt;
  const int D = (2 * s + 1) * (2 * s + 1);
  const CvTile ct = cv_tile_at(p, H);
  cv_correlate<T, kS>(f1, f2, H, W, C, s_rt, vec, p, ct, smem_u, [](int) { return 0; });
  const float* cv = reinterpret_cast<const float*>(smem_u);
  // Thread t takes groups t, t + blockDim, ... of a row's pixels x cpad/4
  // groups, its (pixel, group) advanced by a fixed step.
  const int groups = cpad / 4, n = min(p.tw, W - ct.x0) * groups;
  const int step_px = blockDim.x / groups, step_g = blockDim.x - step_px * groups;
  for (int r = 0; r < p.th && ct.y0 + r < H; ++r) {
    const long long pix0 = (ct.row0 + ct.y0 + r) * W + ct.x0;
    int px = threadIdx.x / groups, gi = threadIdx.x - px * groups;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int x = px, c0 = gi * 4;
      const long long pix = pix0 + x;
      px += step_px;
      gi += step_g;
      if (gi >= groups) {
        gi -= groups;
        ++px;
      }
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = c0 + j;
        if (ch < D) {
          v[j] = fmaxf(cv[r * p.row_stride + x * D + ch], 0.0f);
        } else if (ch < D + Cf) {
          v[j] = load1(feat + pix * Cf + (ch - D));
        } else if (ch < D + Cf + Cu) {
          v[j] = __ldg(flow_up + pix * Cu + (ch - D - Cf));
        } else {
          v[j] = 0.0f;
        }
      }
      const long long o = pix * cpad + c0;
      if (out_bf16) {
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = make_float4(v[0], v[1], v[2], v[3]);
      }
      if (a0 != nullptr) *reinterpret_cast<float4*>(a0 + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The same values one thread per output element, channels fastest: the
// searches the tile plan refuses.
template <typename T>
__global__ void __launch_bounds__(256)
flow_level_input_element_kernel(const T* __restrict__ f1, const T* __restrict__ f2, const T* __restrict__ feat,
                                const float* __restrict__ flow_up, void* __restrict__ out, int out_bf16,
                                float* __restrict__ a0, int H, int W, int C, int Cf, int Cu, int search, int cpad,
                                long long elements) {
  const int d = 2 * search + 1;
  const int D = d * d;
  const float inv_c = 1.0f / static_cast<float>(C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < elements; i += step) {
    const int ch = static_cast<int>(i % cpad);
    const long long p = i / cpad;
    float v = 0.0f;
    if (ch < D) {
      const int dy = ch / d - search, dx = ch % d - search;
      const int w = static_cast<int>(p % W);
      const int h = static_cast<int>((p / W) % H);
      if (h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W) {
        const T* a = f1 + p * C;
        const T* b = f2 + (p + static_cast<long long>(dy) * W + dx) * C;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc = fmaf(load1(a + c), load1(b + c), acc);
        v = fmaxf(acc * inv_c, 0.0f);
      }
    } else if (ch < D + Cf) {
      v = load1(feat + p * Cf + (ch - D));
    } else if (ch < D + Cf + Cu) {
      v = __ldg(flow_up + p * Cu + (ch - D - Cf));
    }
    store1(out, i, out_bf16 ? round_bf16(v) : v, out_bf16);
    if (a0 != nullptr) a0[i] = v;
  }
}

template <typename T, int kS>
cudaError_t launch_level_input(const void* f1, const void* f2, const void* feat, const float* flow_up, void* out,
                               int out_bf16, float* a0, int B, int H, int W, int C, int Cf, int Cu, int search,
                               int cpad, bool vec, const FwdPlan& p, int device, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(flow_level_input_kernel<T, kS>, device, p.smem, granted);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(B) * p.tiles_y * p.tiles_x;
  flow_level_input_kernel<T, kS><<<static_cast<unsigned>(tiles), p.threads, p.smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(feat), flow_up, out, out_bf16,
      a0, H, W, C, Cf, Cu, search, cpad, vec, p);
  return cudaGetLastError();
}

// The kernel the last flow-level input launch ran: the tile kernel's
// search instance (3, 4, or -1 for the run-time search), -2 the element
// kernel; 0 before any.
int last_level_input = 0;

template <typename T>
cudaError_t level_input(const void* f1, const void* f2, const void* feat, const float* flow_up, void* out,
                        int out_bf16, float* a0, int B, int H, int W, int C, int Cf, int Cu, int search, int cpad,
                        cudaStream_t stream) {
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  FwdPlan p{};
  if (!plan_forward(B, H, W, C, search, sizeof(T), smem_max, sms, &p)) {
    const long long elements = static_cast<long long>(B) * H * W * cpad;
    const int blocks = static_cast<int>((elements + 255) / 256 < 132 * 32 ? (elements + 255) / 256 : 132 * 32);
    last_level_input = -2;
    flow_level_input_element_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const T*>(feat), flow_up, out, out_bf16,
        a0, H, W, C, Cf, Cu, search, cpad, elements);
    return cudaGetLastError();
  }
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = (C * sizeof(T)) % 16 == 0 && aligned(f1) && aligned(f2);
  last_level_input = search == 3 || search == 4 ? search : -1;
  switch (search) {
    case 3:
      return launch_level_input<T, 3>(f1, f2, feat, flow_up, out, out_bf16, a0, B, H, W, C, Cf, Cu, search, cpad,
                                      vec, p, device, stream);
    case 4:
      return launch_level_input<T, 4>(f1, f2, feat, flow_up, out, out_bf16, a0, B, H, W, C, Cf, Cu, search, cpad,
                                      vec, p, device, stream);
    default:
      return launch_level_input<T, -1>(f1, f2, feat, flow_up, out, out_bf16, a0, B, H, W, C, Cf, Cu, search, cpad,
                                       vec, p, device, stream);
  }
}

// ------------------------------------------------------- tensor-core layer

// The bfloat16 and bf16_dot modes: one layer as an implicit GEMM on the
// tensor cores (conv_mma.cuh), one tile a block: tile blockIdx.x (image-
// major), channel block blockIdx.y.
template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_mma_chunked_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  conv_mma_chunked_tile<TIn, NT, L, false>(x, w, bias, out, g, tile_at(g, blockIdx.x, blockIdx.y), smem4);
}

// The same at NT=12 on a float32 input (bf16_dot), held to 128 registers
// a thread: left free it takes 156-161 and an SM holds one 8-warp block.
// (The smaller NT take fewer registers without the hint than with it.)
template <int NT, typename L>
__global__ void __launch_bounds__(L::kThreads, 512 / L::kThreads)
conv_mma_chunked_f32_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias, void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  conv_mma_chunked_tile<float, NT, L, false>(x, w, bias, out, g, tile_at(g, blockIdx.x, blockIdx.y), smem4);
}

template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_mma_flat_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  conv_mma_flat_tile<TIn, NT, L, false>(x, w, bias, out, g, tile_at(g, blockIdx.x, blockIdx.y), smem4);
}

// The float32 mode: the same tiles in split TF32 (conv_mma.cuh), weights
// as `_pack_tf32` packs them.
template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_tf32_chunked_kernel(const TIn* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                         void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  conv_tf32_chunked_tile<TIn, NT, L, false>(x, w, bias, out, g, tile_at(g, blockIdx.x, blockIdx.y), smem4);
}

template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_tf32_flat_kernel(const TIn* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                      void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  conv_tf32_flat_tile<TIn, NT, L, false>(x, w, bias, out, g, tile_at(g, blockIdx.x, blockIdx.y), smem4);
}

// One layer's kernel by precision, K order, input dtype, channel tile and
// tile layout.
template <bool kTf32, typename TIn, int NT, typename L, bool kFlat>
cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* out, int B, const MmaGeo& g,
                       size_t smem, int device, cudaStream_t stream) {
  using TW = typename std::conditional<kTf32, float, __nv_bfloat16>::type;
  void (*kernel)(const TIn*, const TW*, const float*, void*, MmaGeo);
  if constexpr (kTf32 && kFlat) {
    kernel = conv_tf32_flat_kernel<TIn, NT, L>;
  } else if constexpr (kTf32) {
    kernel = conv_tf32_chunked_kernel<TIn, NT, L>;
  } else if constexpr (kFlat) {
    kernel = conv_mma_flat_kernel<TIn, NT, L>;
  } else if constexpr (std::is_same<TIn, float>::value && NT == 12) {
    kernel = conv_mma_chunked_f32_kernel<NT, L>;
  } else {
    kernel = conv_mma_chunked_kernel<TIn, NT, L>;
  }
  static int granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, device, smem, granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * g.tiles), static_cast<unsigned>((g.npad + g.n_rows - 1) / g.n_rows));
  kernel<<<grid, L::kThreads, smem, stream>>>(static_cast<const TIn*>(x), static_cast<const TW*>(w), bias, out, g);
  return cudaGetLastError();
}

template <bool kTf32, typename TIn, typename L, bool kFlat>
cudaError_t dispatch_nt(int nt, const void* x, const void* w, const float* bias, void* out, int B,
                        const MmaGeo& g, size_t smem, int device, cudaStream_t stream) {
  switch (nt) {
    case 12:
      if constexpr (!kTf32) return launch_mma<kTf32, TIn, 12, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
      return cudaErrorInvalidValue;  // the split-TF32 plan stops at 8 (its registers)
    case 8: return launch_mma<kTf32, TIn, 8, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 4: return launch_mma<kTf32, TIn, 4, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 2: return launch_mma<kTf32, TIn, 2, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 1: return launch_mma<kTf32, TIn, 1, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tile layouts: 4 warps, 16x8 or 8x16 pixels; 8 warps, 16x16 (the
// chunked order only).
template <bool kTf32, typename TIn>
cudaError_t dispatch_mma(int nt, const void* x, const void* w, const float* bias, void* out, int B,
                         const MmaGeo& g, bool flat, size_t smem, int device, cudaStream_t stream) {
  if (flat) {
    if (g.tile_w == 16) {
      return dispatch_nt<kTf32, TIn, Layout<4, 16>, true>(nt, x, w, bias, out, B, g, smem, device, stream);
    }
    return dispatch_nt<kTf32, TIn, Layout<4, 8>, true>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  if (g.tile_h * g.tile_w == 256) {
    return dispatch_nt<kTf32, TIn, Layout<8, 16>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  if (g.tile_w == 16) {
    return dispatch_nt<kTf32, TIn, Layout<4, 16>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  return dispatch_nt<kTf32, TIn, Layout<4, 8>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
}

// One layer on the tensor cores: bf16 products (tf32 false) or float32
// ones in split TF32.
int conv_layer_mma(bool tf32, const void* x, int x_bf16, const void* w, const float* bias, void* out,
                   int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                   int pad_t, int pad_l, int round_out, int relu, cudaStream_t s) {
  const bool flat = mma_flat(cin);
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      k % 2 == 0 || (stride != 1 && stride != 2)) {
    return cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  MmaGeo g{};
  const MmaPrec prec = !tf32 ? MmaPrec::kBf16 : x_bf16 ? MmaPrec::kTf32NoALo : MmaPrec::kTf32;
  const size_t smem =
      mma_plan(g, B, H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l, sms, smem_max, true, !tf32, prec);
  if (smem == 0 || static_cast<long long>(B) * g.tiles > INT_MAX) return cudaErrorInvalidValue;
  g.round_out = round_out;
  g.relu = relu;
  g.out_bf16 = out_bf16;
  g.piece = mma_piece(x, x_bf16, cin);
  const int nt = g.n_rows / 8;
  if (tf32) {
    if (x_bf16) return dispatch_mma<true, __nv_bfloat16>(nt, x, w, bias, out, B, g, flat, smem, device, s);
    return dispatch_mma<true, float>(nt, x, w, bias, out, B, g, flat, smem, device, s);
  }
  if (x_bf16) return dispatch_mma<false, __nv_bfloat16>(nt, x, w, bias, out, B, g, flat, smem, device, s);
  return dispatch_mma<false, float>(nt, x, w, bias, out, B, g, flat, smem, device, s);
}

}  // namespace

extern "C" {

// One fused conv layer on the tensor cores in bf16 (the bfloat16 and
// bf16_dot modes: operands in bf16, a float32 input rounded to bf16 as it
// is staged). w: the layer's weights as `_pack_mma` packs them (bf16, the
// chunked order for cin >= 16, else the flat one). round_out: round the
// biased sum to bf16 (the activation dtype is bf16). Returns a
// cudaError_t (InvalidValue for sizes the kernel does not take).
int davo_conv_layer_mma(const void* x, int x_bf16, const void* w, const float* bias, void* out,
                        int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                        int stride, int pad_t, int pad_l, int round_out, int relu, void* stream) {
  return conv_layer_mma(false, x, x_bf16, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout, k, stride,
                        pad_t, pad_l, round_out, relu, static_cast<cudaStream_t>(stream));
}

// The same layer in float32 (the float32 mode: float32 products and
// sums, in split TF32 on the tensor cores). w: the weights as
// `_pack_tf32` packs them (float32 hi and lo planes, `_pack_mma`'s K
// order); x float32 or bf16.
int davo_conv_layer_tf32(const void* x, int x_bf16, const void* w, const float* bias, void* out,
                         int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                         int stride, int pad_t, int pad_l, int round_out, int relu, void* stream) {
  return conv_layer_mma(true, x, x_bf16, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout, k, stride,
                        pad_t, pad_l, round_out, relu, static_cast<cudaStream_t>(stream));
}

// The flow level's estimator input (see flow_level_input_kernel): f1,
// f2, feat (B, H, W, C / C / Cf) float32 or bf16 (in_bf16), flow_up
// (B, H, W, Cu) float32; out (B, H, W, cpad), cpad a multiple of 4,
// bf16 (out_bf16) or float32, 16-byte aligned; a0 the same in float32, or
// null. Returns a cudaError_t.
int davo_flow_level_input(const void* f1, const void* f2, const void* feat, int in_bf16,
                          const float* flow_up, void* out, int out_bf16, float* a0, int B, int H,
                          int W, int C, int Cf, int Cu, int search, int cpad, void* stream) {
  const long long pixels = static_cast<long long>(B) * H * W;
  const int D = (2 * search + 1) * (2 * search + 1);
  if (pixels <= 0 || pixels > INT_MAX / 2 || C <= 0 || Cf < 0 || Cu < 0 || search < 0 || search > 64 ||
      cpad % 4 != 0 || cpad < D + Cf + Cu || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a0) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return level_input<unsigned short>(f1, f2, feat, flow_up, out, out_bf16, a0, B, H, W, C, Cf, Cu, search,
                                       cpad, s);
  }
  return level_input<float>(f1, f2, feat, flow_up, out, out_bf16, a0, B, H, W, C, Cf, Cu, search, cpad, s);
}

// The kernel the last davo_flow_level_input call launched, into out[0]:
// 3 or 4, flow_level_input_kernel's instance for that search; -1 its
// run-time-search instance; -2 flow_level_input_element_kernel; 0 none
// yet.
int davo_flow_level_input_last(int* out) {
  out[0] = last_level_input;
  return 0;
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
