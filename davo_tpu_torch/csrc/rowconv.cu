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
// the other):
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
// conv_layer_kernel (float32): exact f32 products on the FMA units (67
//   TFLOP/s; no TF32, as the port runs exact f32). A block of 128 threads
//   shares one slice of CO output channels, whose k*k*Cin*CO weights it
//   stages in shared memory; each thread computes 4 consecutive output
//   pixels of a row x CO channels and reads the input through L1 (4
//   channels at a time when Cin % 4 == 0). What limits it: the f32 FMA
//   rate, and L1 traffic from input rows that neighbouring threads re-read.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_mma.cuh"

namespace {

using namespace davo;

constexpr int kThreads = 128;
constexpr int kPx = 4;                      // output pixels of one row per thread
constexpr size_t kMaxSmem = 227 * 1024;     // dynamic shared memory a block can use

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  // bf16 -> f32 is a 16-bit shift; element 0 sits in the low half.
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <int CO>
__device__ __forceinline__ void load_weights(const float* w, float wv[CO]) {
  if constexpr (CO % 4 == 0) {
#pragma unroll
    for (int o = 0; o < CO; o += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + o);
      wv[o] = q.x;
      wv[o + 1] = q.y;
      wv[o + 2] = q.z;
      wv[o + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int o = 0; o < CO; ++o) wv[o] = w[o];
  }
}

// x (B, H, W, cin) NHWC; w (k, k, cin, cout) f32 holding dot-dtype values;
// out (B, Ho, Wo, cout). Block (blockIdx.x, blockIdx.y): 128 pixel groups
// of kPx outputs x the output channels [CO*blockIdx.y, CO*blockIdx.y + CO).
template <typename TIn, int CO, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_layer_kernel(const TIn* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, void* __restrict__ out, int out_bf16,
                  int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                  int pad_t, int pad_l, int round_in, int round_out, int relu,
                  long long groups) {
  extern __shared__ __align__(16) float sw[];  // (k*k*cin, CO)
  const int co0 = blockIdx.y * CO;
  const int rows = k * k * cin;
  for (int i = threadIdx.x; i < rows * CO; i += blockDim.x) {
    sw[i] = w[static_cast<long long>(i / CO) * cout + co0 + i % CO];
  }
  __syncthreads();

  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int wgroups = (Wo + kPx - 1) / kPx;
  const int ox0 = static_cast<int>(g % wgroups) * kPx;
  const long long q = g / wgroups;  // b * Ho + oy
  const int oy = static_cast<int>(q % Ho);
  const long long b = q / Ho;

  float acc[kPx][CO];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.0f;
  }

  for (int ky = 0; ky < k; ++ky) {
    const int iy = oy * stride - pad_t + ky;
    if (iy < 0 || iy >= H) continue;  // SAME zero padding
    const TIn* row = x + (b * H + iy) * static_cast<long long>(W) * cin;
    for (int kx = 0; kx < k; ++kx) {
      const TIn* src[kPx];
      bool ok[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const int ix = (ox0 + p) * stride - pad_l + kx;
        ok[p] = ix >= 0 && ix < W && ox0 + p < Wo;
        src[p] = row + static_cast<long long>(ok[p] ? ix : 0) * cin;
      }
      const float* wt = sw + (ky * k + kx) * cin * CO;
      if constexpr (kVec) {
        for (int c = 0; c < cin; c += 4) {
          float v[kPx][4];
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            if (ok[p]) {
              load4(src[p] + c, v[p]);
              if (round_in) {
#pragma unroll
                for (int j = 0; j < 4; ++j) v[p][j] = round_bf16(v[p][j]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) v[p][j] = 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float wv[CO];
            load_weights<CO>(wt + (c + j) * CO, wv);
#pragma unroll
            for (int p = 0; p < kPx; ++p) {
#pragma unroll
              for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(v[p][j], wv[o], acc[p][o]);
            }
          }
        }
      } else {
        for (int c = 0; c < cin; ++c) {
          float v[kPx];
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            v[p] = ok[p] ? load1(src[p] + c) : 0.0f;
            if (round_in) v[p] = round_bf16(v[p]);
          }
          float wv[CO];
          load_weights<CO>(wt + c * CO, wv);
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
#pragma unroll
            for (int o = 0; o < CO; ++o) acc[p][o] = fmaf(v[p], wv[o], acc[p][o]);
          }
        }
      }
    }
  }

  float bv[CO];
#pragma unroll
  for (int o = 0; o < CO; ++o) bv[o] = __ldg(bias + co0 + o);
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    if (ox0 + p >= Wo) break;
    const long long base = (q * Wo + ox0 + p) * cout + co0;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      float v = acc[p][o] + bv[o];
      if (round_out) v = round_bf16(v);
      if (relu) v = fmaxf(v, 0.0f);
      store1(out, base + o, v, out_bf16);
    }
  }
}

template <typename TIn, int CO>
cudaError_t launch_conv(const void* x, const float* w, const float* bias, void* out, int out_bf16,
                        int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                        int stride, int pad_t, int pad_l, int round_in, int round_out,
                        int relu, cudaStream_t stream) {
  const bool vec = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TIn)) == 0;
  auto kernel = vec ? conv_layer_kernel<TIn, CO, true> : conv_layer_kernel<TIn, CO, false>;
  const size_t smem = static_cast<size_t>(k) * k * cin * CO * sizeof(float);
  static int granted[2][kMaxDevices] = {};
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = allow_smem(kernel, device, smem, granted[vec]);
  if (err != cudaSuccess) return err;
  const long long groups = static_cast<long long>(B) * Ho * ((Wo + kPx - 1) / kPx);
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads), cout / CO);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), w, bias, out, out_bf16, H, W, cin, Ho, Wo, cout, k, stride,
      pad_t, pad_l, round_in, round_out, relu, groups);
  return cudaGetLastError();
}

template <typename TIn>
cudaError_t dispatch_conv(int co, const void* x, const float* w, const float* bias, void* out,
                          int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout,
                          int k, int stride, int pad_t, int pad_l, int round_in, int round_out,
                          int relu, cudaStream_t stream) {
#define DAVO_CONV(N)                                                                       \
  case N:                                                                                  \
    return launch_conv<TIn, N>(x, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout, k,   \
                               stride, pad_t, pad_l, round_in, round_out, relu, stream);
  switch (co) {
    DAVO_CONV(16)
    DAVO_CONV(8)
    DAVO_CONV(4)
    DAVO_CONV(2)
    DAVO_CONV(1)
    default:
      return cudaErrorInvalidValue;
  }
#undef DAVO_CONV
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
// One thread per output element, channels fastest (coalesced stores; a
// warp's shift threads read the same f1 row).
template <typename TIn>
__global__ void __launch_bounds__(256)
flow_level_input_kernel(const TIn* __restrict__ f1, const TIn* __restrict__ f2,
                        const TIn* __restrict__ feat, const float* __restrict__ flow_up,
                        void* __restrict__ out, int out_bf16, float* __restrict__ a0, int H, int W,
                        int C, int Cf, int Cu, int search, int cpad, long long elements) {
  const int d = 2 * search + 1;
  const int D = d * d;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < elements;
       i += step) {
    const int ch = static_cast<int>(i % cpad);
    const long long p = i / cpad;
    float v = 0.0f;
    if (ch < D) {
      const int dy = ch / d - search, dx = ch % d - search;
      const int w = static_cast<int>(p % W);
      const int h = static_cast<int>((p / W) % H);
      if (h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W) {
        const TIn* a = f1 + p * C;
        const TIn* b = f2 + (p + static_cast<long long>(dy) * W + dx) * C;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc = fmaf(load1(a + c), load1(b + c), acc);
        v = fmaxf(acc / static_cast<float>(C), 0.0f);
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

template <typename TIn, int NT, typename L, bool kFlat>
cudaError_t launch_mma(const void* x, const __nv_bfloat16* w, const float* bias, void* out, int B,
                       const MmaGeo& g, size_t smem, int device, cudaStream_t stream) {
  void (*kernel)(const TIn*, const __nv_bfloat16*, const float*, void*, MmaGeo);
  if constexpr (kFlat) {
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
  kernel<<<grid, L::kThreads, smem, stream>>>(static_cast<const TIn*>(x), w, bias, out, g);
  return cudaGetLastError();
}

template <typename TIn, typename L, bool kFlat>
cudaError_t dispatch_nt(int nt, const void* x, const __nv_bfloat16* w, const float* bias, void* out,
                        int B, const MmaGeo& g, size_t smem, int device, cudaStream_t stream) {
  switch (nt) {
    case 12: return launch_mma<TIn, 12, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 8: return launch_mma<TIn, 8, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 4: return launch_mma<TIn, 4, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 2: return launch_mma<TIn, 2, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    case 1: return launch_mma<TIn, 1, L, kFlat>(x, w, bias, out, B, g, smem, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tile layouts: 4 warps, 16x8 or 8x16 pixels; 8 warps, 16x16 (the
// chunked order only).
template <typename TIn>
cudaError_t dispatch_mma(int nt, const void* x, const __nv_bfloat16* w, const float* bias, void* out,
                         int B, const MmaGeo& g, bool flat, size_t smem, int device, cudaStream_t stream) {
  if (flat) {
    if (g.tile_w == 16) {
      return dispatch_nt<TIn, Layout<4, 16>, true>(nt, x, w, bias, out, B, g, smem, device, stream);
    }
    return dispatch_nt<TIn, Layout<4, 8>, true>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  if (g.tile_h * g.tile_w == 256) {
    return dispatch_nt<TIn, Layout<8, 16>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  if (g.tile_w == 16) {
    return dispatch_nt<TIn, Layout<4, 16>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
  }
  return dispatch_nt<TIn, Layout<4, 8>, false>(nt, x, w, bias, out, B, g, smem, device, stream);
}

int conv_layer_mma(const void* x, int x_bf16, const void* w, const float* bias, void* out,
                   int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                   int stride, int pad_t, int pad_l, int round_out, int relu, cudaStream_t s) {
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
  const size_t smem = mma_plan(g, B, H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l, sms, smem_max, true, true);
  if (smem == 0 || static_cast<long long>(B) * g.tiles > INT_MAX) return cudaErrorInvalidValue;
  g.round_out = round_out;
  g.relu = relu;
  g.out_bf16 = out_bf16;
  g.piece = mma_piece(x, x_bf16, cin);
  const int nt = g.n_rows / 8;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  if (x_bf16) return dispatch_mma<__nv_bfloat16>(nt, x, wb, bias, out, B, g, flat, smem, device, s);
  return dispatch_mma<float>(nt, x, wb, bias, out, B, g, flat, smem, device, s);
}

}  // namespace

extern "C" {

// One fused conv layer. x_bf16 / out_bf16: bfloat16 (else float32)
// storage; round_in: round float32 input to bf16 before the products
// (the bf16_dot mode); round_out: round the biased sum to bf16 (the
// activation dtype is bf16). Returns a cudaError_t (InvalidValue when no
// channel slice of the weights fits shared memory).
int davo_conv_layer(const void* x, int x_bf16, const float* w, const float* bias, void* out,
                    int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                    int stride, int pad_t, int pad_l, int round_in, int round_out, int relu,
                    void* stream) {
  if (B <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cout <= 0 || k <= 0) return cudaErrorInvalidValue;
  int co = 16;  // the widest channel slice that divides cout and fits shared memory
  while (co > 1 && (cout % co != 0 || static_cast<size_t>(k) * k * cin * co * 4 > kMaxSmem)) co /= 2;
  if (static_cast<size_t>(k) * k * cin * co * 4 > kMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return dispatch_conv<__nv_bfloat16>(co, x, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout,
                                        k, stride, pad_t, pad_l, round_in, round_out, relu, s);
  }
  return dispatch_conv<float>(co, x, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout, k, stride,
                              pad_t, pad_l, round_in, round_out, relu, s);
}

// One fused conv layer on the tensor cores (the bfloat16 and bf16_dot
// modes: operands in bf16, a float32 input rounded to bf16 as it is
// staged). w: the layer's weights as `_pack_mma` packs them (bf16, the
// chunked order for cin >= 16, else the flat one). round_out: round the
// biased sum to bf16 (the activation dtype is bf16). Returns a
// cudaError_t (InvalidValue for sizes the kernel does not take).
int davo_conv_layer_mma(const void* x, int x_bf16, const void* w, const float* bias, void* out,
                        int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                        int stride, int pad_t, int pad_l, int round_out, int relu, void* stream) {
  return conv_layer_mma(x, x_bf16, w, bias, out, out_bf16, B, H, W, cin, Ho, Wo, cout, k, stride,
                        pad_t, pad_l, round_out, relu, static_cast<cudaStream_t>(stream));
}

int davo_flow_level_input(const void* f1, const void* f2, const void* feat, int in_bf16,
                          const float* flow_up, void* out, int out_bf16, float* a0, int B, int H,
                          int W, int C, int Cf, int Cu, int search, int cpad, void* stream) {
  const long long elements = static_cast<long long>(B) * H * W * cpad;
  if (elements <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((elements + 255) / 256 < 132 * 32 ? (elements + 255) / 256 : 132 * 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    flow_level_input_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
        static_cast<const __nv_bfloat16*>(feat), flow_up, out, out_bf16, a0, H, W, C, Cf, Cu,
        search, cpad, elements);
  } else {
    flow_level_input_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(f2),
        static_cast<const float*>(feat), flow_up, out, out_bf16, a0, H, W, C, Cf, Cu, search,
        cpad, elements);
  }
  return cudaGetLastError();
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
