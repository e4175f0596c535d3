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
//   the chunk's weights are staged by cp.async, double-buffered where two
//   stages fit, XOR-swizzled so that every ldmatrix is conflict-free, and
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
//   gathers of A.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace davo;

constexpr int kThreads = 128;
constexpr int kPx = 4;                      // output pixels of one row per thread
constexpr size_t kMaxSmem = 227 * 1024;     // dynamic shared memory a block can use

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

__device__ __forceinline__ void store1(void* out, long long i, float v, int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
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
// tensor cores (mma.sync m16n8k16, bf16 x bf16 -> f32). M = a block's
// 128 or 256 output pixels (a Layout), N = its NT*8 output
// channels, K = k*k*Cin in one of two orders (the weights' packing,
// `_pack_mma` in kernels/rowconv.py, follows it):
//   chunked (Cin >= 16): input channels in chunks of 16 (the last padded
//     with zeros), K = (chunk, tap, channel); weights [Np][chunks][k*k][16];
//   flat (Cin < 16): K = (tap, channel) flattened, padded to a multiple of
//     16 with zeros; weights [Np][Kp];
// Np = Cout padded to a multiple of 8. Zero weights add exact zeros, so
// the padding changes no sum.
// A block of WARPS warps owns WARPS*32 output pixels, a tile TW (8 or 16)
// columns wide, pixel r = y*TW + x; warp w the pixels [32w, 32w + 32),
// as two 16-pixel A tiles (2 rows x 8 columns, or 1 row x 16).
template <int WARPS, int TW>
struct Layout {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kTw = TW;
  static constexpr int kTh = WARPS * 32 / TW;
};

struct MmaGeo {
  int H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l;
  int taps;        // k*k
  int tile_h, tile_w;  // output rows and columns of a block's tile (the launch's Layout)
  int HH, HW;      // input halo of a tile: (tile_h-1)*stride + k rows, (tile_w-1)*stride + k columns
  int HWh, HWs;    // stride 2: columns stored by parity, HWh = ceil(HW/2) each; HWs columns in all
  int nchunks;     // chunked: ceil(cin/16)
  int kp;          // flat: k*k*cin padded to a multiple of 16
  int npad;        // rows of the packed weights: Cout padded to 8
  int n_rows;      // NT*8, a block's output channels
  int piece;       // input channels one staging copy moves (8, 4, 2, 1)
  int stages;      // chunked: 2 = double-buffered staging, 1 = single
  int round_out, relu, out_bf16;
  int tiles_x, tiles;  // tiles per image row of tiles, and per image
};

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the low half, first
  return *reinterpret_cast<const unsigned*>(&v);
}

// Up to 8 input channels (`avail` of them real, the rest zero) of one
// pixel into one 16-byte unit of shared memory, as bf16: copied as they
// are (cp.async, `piece` channels a copy) or rounded from float32.
__device__ __forceinline__ void stage_unit(uint4* dst, const __nv_bfloat16* src, int avail, int piece) {
  if (piece == 8) {
    copy_async16(dst, src);
  } else if (piece == 4) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (4 * j < avail) {
        copy_async8(d + 2 * j, src + 4 * j);
      } else {
        d[2 * j] = d[2 * j + 1] = 0u;
      }
    }
  } else if (piece == 2) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j < avail) {
        copy_async4(d + j, src + 2 * j);
      } else {
        d[j] = 0u;
      }
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned lo = 2 * j < avail ? __ldg(s + 2 * j) : 0u;
      const unsigned hi = 2 * j + 1 < avail ? __ldg(s + 2 * j + 1) : 0u;
      v[j] = lo | (hi << 16);
    }
    *dst = make_uint4(v[0], v[1], v[2], v[3]);
  }
}
__device__ __forceinline__ void stage_unit(uint4* dst, const float* src, int avail, int piece) {
  float v[8];
  if (piece == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 q = 4 * j < avail ? __ldg(reinterpret_cast<const float4*>(src) + j)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < avail ? __ldg(src + j) : 0.0f;
  }
  *dst = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// One element of the input as a bf16 bit pattern (flat staging).
__device__ __forceinline__ unsigned short bf16_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ unsigned short bf16_bits(const float* p) {
  const __nv_bfloat16 v = __float2bfloat16_rn(__ldg(p));
  return *reinterpret_cast<const unsigned short*>(&v);
}

// Halo column of input column offset hx within the tile's halo: stride 2
// stores even and odd columns apart, so that the 8 output columns of an
// ldmatrix read 8 neighbouring slots.
__device__ __forceinline__ int halo_col(const MmaGeo& g, int hx) {
  return g.stride == 2 ? (hx & 1) * g.HWh + (hx >> 1) : hx;
}

// A block's tile: image b, output rows [oy0, oy0 + tile_h), columns
// [ox0, ox0 + tile_w), channels [co0, co0 + n_rows).
struct Tile {
  int b, oy0, ox0, co0;
};

__device__ __forceinline__ Tile tile_of(const MmaGeo& g) {
  const int t = blockIdx.x % g.tiles;
  Tile tile;
  tile.b = blockIdx.x / g.tiles;
  tile.oy0 = (t / g.tiles_x) * g.tile_h;
  tile.ox0 = (t % g.tiles_x) * g.tile_w;
  tile.co0 = blockIdx.y * g.n_rows;
  return tile;
}

// Chunked order: K chunk `chunk` (input channels [16*chunk, 16*chunk+16))
// into shared memory. The halo holds 2 units (16 channels) a pixel at
// slot q = hy*HWs + halo_col(hx), unit 2q + (octet ^ bit 2 of q); the
// weights taps*2 units a row, unit u of row n at n*taps*2 + (u ^ bit 2
// of n). Each swizzle puts the 8 rows of every ldmatrix into 8 distinct
// 16-byte bank groups.
template <typename TIn>
__device__ __forceinline__ void stage_chunk(uint4* halo, uint4* wts, const TIn* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ w, const MmaGeo& g,
                                            const Tile& t, int chunk) {
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int units = g.HH * g.HW * 2;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    const int o = i & 1, p = i >> 1;
    const int hy = p / g.HW, hx = p - hy * g.HW;
    const int q = hy * g.HWs + halo_col(g, hx);
    uint4* dst = halo + 2 * q + (o ^ ((q >> 2) & 1));
    const int iy = iy0 + hy, ix = ix0 + hx, ch = chunk * 16 + o * 8;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W || ch >= g.cin) {
      *dst = make_uint4(0u, 0u, 0u, 0u);  // SAME zero padding, zero channels
    } else {
      stage_unit(dst, x + ((static_cast<size_t>(t.b) * g.H + iy) * g.W + ix) * g.cin + ch,
                 g.cin - ch, g.piece);
    }
  }
  const int row = g.taps * 2;
  const int wunits = g.n_rows * row;
  for (int i = threadIdx.x; i < wunits; i += blockDim.x) {
    const int n = i / row, u = i - n * row;
    uint4* dst = wts + n * row + (u ^ ((n >> 2) & 1));
    const int co = t.co0 + n;
    if (co < g.npad) {
      copy_async16(dst, w + (static_cast<size_t>(co) * g.nchunks + chunk) * g.taps * 16 + u * 8);
    } else {
      *dst = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Bias, ONE rounding to the activation dtype, ReLU, then the block's
// outputs leave through shared memory as 16-byte stores (8 channels of a
// pixel; element stores where Cout is not a multiple of 8).
template <int NT, typename L>
__device__ __forceinline__ void mma_epilogue(float (&acc)[2][NT][4], void* smem, const float* __restrict__ bias,
                                             void* __restrict__ out, const MmaGeo& g, const Tile& t) {
  constexpr int kStride = NT * 8 + 4;  // floats per pixel row of the staged tile
  float* ot = static_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tc = lane & 3;
  __syncthreads();  // every warp is done reading the staged operands
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * tc;
    const int co = t.co0 + col;
    const float b0 = co < g.cout ? __ldg(bias + co) : 0.0f;
    const float b1 = co + 1 < g.cout ? __ldg(bias + co + 1) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mt][nt][2 * h] + b0, v1 = acc[mt][nt][2 * h + 1] + b1;
        if (g.round_out) {
          v0 = round_bf16(v0);
          v1 = round_bf16(v1);
        }
        if (g.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const int r = warp * 32 + mt * 16 + h * 8 + gr;
        *reinterpret_cast<float2*>(ot + r * kStride + col) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();
  const int ncols = min(NT * 8, g.cout - t.co0);
  const bool vec = g.cout % 8 == 0;
  for (int i = threadIdx.x; i < L::kThreads * NT; i += L::kThreads) {
    const int r = i / NT, j = (i - r * NT) * 8;
    const int oy = t.oy0 + r / L::kTw, ox = t.ox0 + r % L::kTw;
    if (oy >= g.Ho || ox >= g.Wo || j >= ncols) continue;
    const float* src = ot + r * kStride + j;
    const size_t o = ((static_cast<size_t>(t.b) * g.Ho + oy) * g.Wo + ox) * g.cout + t.co0 + j;
    if (vec) {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      if (g.out_bf16) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
      } else {
        float* d = static_cast<float*>(out) + o;
        *reinterpret_cast<float4*>(d) = lo;
        *reinterpret_cast<float4*>(d + 4) = hi;
      }
    } else {
      for (int e = 0; e < 8 && j + e < ncols; ++e) store1(out, static_cast<long long>(o) + e, src[e], g.out_bf16);
    }
  }
}

// The chunked order (Cin >= 16): K chunks staged by cp.async, double-
// buffered where two stages fit; per chunk and tap, each warp loads its
// two 16-pixel A tiles and the chunk's B tiles with ldmatrix and issues
// 2*NT mma.sync.
template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_mma_chunked_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  const Tile t = tile_of(g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int halo_units = g.HH * g.HWs * 2, stage_units = halo_units + g.n_rows * g.taps * 2;
  // This lane's ldmatrix rows: pixel (lane & 15) of each of the warp's two
  // 16-pixel tiles, its octet lane >> 4.
  int hrow[2], hcol[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp * 32 + mt * 16 + (lane & 15);
    hrow[mt] = (r / L::kTw) * g.stride;
    hcol[mt] = r % L::kTw;
  }
  const int octet = lane >> 4;
  // B rows of this lane: channel (lane & 7) + 8 * (lane >> 4) of each pair of
  // 8-channel tiles, k half (lane >> 3) & 1.
  const int brow = (lane & 7) + ((lane >> 4) << 3), bhalf = (lane >> 3) & 1;
  const int wrow = g.taps * 2;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  stage_chunk(smem4, smem4 + halo_units, x, w, g, t, 0);
  copy_async_commit();
  for (int c = 0; c < g.nchunks; ++c) {
    const int buf = g.stages == 2 ? (c & 1) : 0;
    if (g.stages == 2 && c + 1 < g.nchunks) {
      uint4* next = smem4 + ((c + 1) & 1) * stage_units;
      stage_chunk(next, next + halo_units, x, w, g, t, c + 1);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    const uint4* halo = smem4 + buf * stage_units;
    const uint4* wts = halo + halo_units;
    for (int tap = 0; tap < g.taps; ++tap) {
      const int ky = tap / g.k, kx = tap - ky * g.k;
      const int kxs = halo_col(g, kx);  // the tap's column offset (hx = stride*col + kx)
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int q = (hrow[mt] + ky) * g.HWs + hcol[mt] + kxs;
        ldmatrix_x4(a[mt], halo + 2 * q + (octet ^ ((q >> 2) & 1)));
      }
      const int u = tap * 2 + bhalf;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int n = np * 16 + brow;
        unsigned b[4];
        ldmatrix_x4(b, wts + n * wrow + (u ^ ((n >> 2) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
      if constexpr (NT % 2 == 1) {
        const int n = (NT - 1) * 8 + (lane & 7);
        unsigned b[2];
        ldmatrix_x2(b, wts + n * wrow + (u ^ ((n >> 2) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
      }
    }
    if (g.stages == 1) {
      if (c + 1 < g.nchunks) {
        __syncthreads();
        stage_chunk(smem4, smem4 + halo_units, x, w, g, t, c + 1);
        copy_async_commit();
      }
    } else {
      __syncthreads();  // this buffer is staged again two chunks on
    }
  }
  mma_epilogue<NT, L>(acc, smem4, bias, out, g, t);
}

// The flat order (Cin < 16): the whole halo, all its channels, as bf16
// elements, and all of K's weight rows (Kp/8 + 1 units a row: odd, so
// ldmatrix rows fall in distinct bank groups) staged once; each k-step's
// A fragment is gathered from the halo through a table of the K index's
// offset (tap, channel), since consecutive K are not contiguous there.
template <typename TIn, int NT, typename L>
__global__ void __launch_bounds__(L::kThreads)
conv_mma_flat_kernel(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, void* __restrict__ out, const MmaGeo g) {
  extern __shared__ __align__(16) uint4 smem4[];
  const Tile t = tile_of(g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wrow = g.kp / 8 + 1;
  uint4* wts = smem4;
  int* koff = reinterpret_cast<int*>(wts + g.n_rows * wrow);
  unsigned short* hs = reinterpret_cast<unsigned short*>(koff + g.kp);

  const int wunits = g.n_rows * (g.kp / 8);
  for (int i = threadIdx.x; i < wunits; i += L::kThreads) {
    const int n = i / (g.kp / 8), u = i - n * (g.kp / 8);
    const int co = t.co0 + n;
    if (co < g.npad) {
      copy_async16(wts + n * wrow + u, w + static_cast<size_t>(co) * g.kp + u * 8);
    } else {
      wts[n * wrow + u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  copy_async_commit();
  const int K = g.taps * g.cin;
  for (int kk = threadIdx.x; kk < g.kp; kk += L::kThreads) {
    int off = 0;  // K padding: any finite element, times a zero weight
    if (kk < K) {
      const int tap = kk / g.cin, c = kk - tap * g.cin;
      const int ky = tap / g.k, kx = tap - ky * g.k;
      off = (ky * g.HW + kx) * g.cin + c;
    }
    koff[kk] = off;
  }
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int row_elems = g.HW * g.cin;
  for (int i = threadIdx.x; i < g.HH * row_elems; i += L::kThreads) {
    const int hy = i / row_elems, rem = i - hy * row_elems;
    const int hx = rem / g.cin, c = rem - hx * g.cin;
    const int iy = iy0 + hy, ix = ix0 + hx;
    hs[i] = (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W)
                ? static_cast<unsigned short>(0)
                : bf16_bits(x + ((static_cast<size_t>(t.b) * g.H + iy) * g.W + ix) * g.cin + c);
  }
  copy_async_wait_group<0>();
  __syncthreads();

  const int gr = lane >> 2, tc = lane & 3;
  int base[2][2];  // halo element of tap (0, 0), channel 0 for rows gr and gr + 8 of each A tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + h * 8 + gr;
      base[mt][h] = ((r / L::kTw) * g.stride * g.HW + (r % L::kTw) * g.stride) * g.cin;
    }
  }
  const int brow = (lane & 7) + ((lane >> 4) << 3), bhalf = (lane >> 3) & 1;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int ks = 0; ks < g.kp / 16; ++ks) {
    const int k0 = ks * 16 + 2 * tc;
    const int o0 = koff[k0], o1 = koff[k0 + 1], o8 = koff[k0 + 8], o9 = koff[k0 + 9];
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const unsigned short* r0 = hs + base[mt][0];
      const unsigned short* r1 = hs + base[mt][1];
      a[mt][0] = static_cast<unsigned>(r0[o0]) | (static_cast<unsigned>(r0[o1]) << 16);
      a[mt][1] = static_cast<unsigned>(r1[o0]) | (static_cast<unsigned>(r1[o1]) << 16);
      a[mt][2] = static_cast<unsigned>(r0[o8]) | (static_cast<unsigned>(r0[o9]) << 16);
      a[mt][3] = static_cast<unsigned>(r1[o8]) | (static_cast<unsigned>(r1[o9]) << 16);
    }
    const int u = ks * 2 + bhalf;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldmatrix_x4(b, wts + (np * 16 + brow) * wrow + u);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    if constexpr (NT % 2 == 1) {
      unsigned b[2];
      ldmatrix_x2(b, wts + ((NT - 1) * 8 + (lane & 7)) * wrow + u);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
    }
  }
  mma_epilogue<NT, L>(acc, smem4, bias, out, g, t);
}

// Shared memory of one launch: (operands, epilogue) bytes.
size_t mma_smem(const MmaGeo& g, bool flat) {
  const size_t epi = static_cast<size_t>(g.tile_h) * g.tile_w * (g.n_rows + 4) * sizeof(float);
  size_t ops;
  if (flat) {
    ops = static_cast<size_t>(g.n_rows) * (g.kp / 8 + 1) * 16 + g.kp * sizeof(int) +
          static_cast<size_t>(g.HH) * g.HW * g.cin * 2;
  } else {
    ops = static_cast<size_t>(g.stages) * (static_cast<size_t>(g.HH) * g.HWs * 2 + g.n_rows * g.taps * 2) * 16;
  }
  return ops > epi ? ops : epi;
}

template <typename TIn, int NT, typename L, bool kFlat>
cudaError_t launch_mma(const void* x, const __nv_bfloat16* w, const float* bias, void* out, int B,
                       const MmaGeo& g, size_t smem, int device, cudaStream_t stream) {
  void (*kernel)(const TIn*, const __nv_bfloat16*, const float*, void*, MmaGeo);
  if constexpr (kFlat) {
    kernel = conv_mma_flat_kernel<TIn, NT, L>;
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

// The tile layout of a layer: the one that computes the fewest pixels
// past the map's edge, except that the 16x16 tile (8 warps; half the
// weight staging per pixel) is taken while it computes at most 15 % more
// than that, the grid still gives every SM a block, and K has 16 taps'
// chunks or more (a single 3x3 chunk stages too little for the larger
// tile to gain); the flat order takes the 4-warp layouts only.
void choose_layout(MmaGeo& g, int B, bool flat, int sms) {
  static const int kShapes[3][2] = {{16, 8}, {8, 16}, {16, 16}};
  auto computed = [&](int s) {
    return static_cast<long long>((g.Ho + kShapes[s][0] - 1) / kShapes[s][0]) * kShapes[s][0] *
           ((g.Wo + kShapes[s][1] - 1) / kShapes[s][1]) * kShapes[s][1];
  };
  int pick = computed(1) < computed(0) ? 1 : 0;
  const long long blocks = static_cast<long long>(B) * computed(2) / 256;
  if (!flat && computed(2) * 100 <= computed(pick) * 115 && blocks >= sms &&
      (g.cin + 15) / 16 * g.k * g.k >= 16) {
    pick = 2;
  }
  g.tile_h = kShapes[pick][0];
  g.tile_w = kShapes[pick][1];
}

int conv_layer_mma(const void* x, int x_bf16, const void* w, const float* bias, void* out,
                   int out_bf16, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k,
                   int stride, int pad_t, int pad_l, int round_out, int relu, cudaStream_t s) {
  const bool flat = cin < 16;
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cout <= 0 || k <= 0 ||
      k % 2 == 0 || (stride != 1 && stride != 2)) {
    return cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  MmaGeo g{};
  g.H = H;
  g.W = W;
  g.cin = cin;
  g.Ho = Ho;
  g.Wo = Wo;
  g.cout = cout;
  g.k = k;
  g.stride = stride;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.taps = k * k;
  choose_layout(g, B, flat, sms);
  g.HH = (g.tile_h - 1) * stride + k;
  g.HW = (g.tile_w - 1) * stride + k;
  g.HWh = (g.HW + 1) / 2;
  g.HWs = stride == 2 ? 2 * g.HWh : g.HW;
  g.nchunks = (cin + 15) / 16;
  g.kp = (g.taps * cin + 15) / 16 * 16;
  g.npad = (cout + 7) / 8 * 8;
  g.round_out = round_out;
  g.relu = relu;
  g.out_bf16 = out_bf16;
  g.tiles_x = (Wo + g.tile_w - 1) / g.tile_w;
  g.tiles = g.tiles_x * ((Ho + g.tile_h - 1) / g.tile_h);
  if (static_cast<long long>(B) * g.tiles > INT_MAX) return cudaErrorInvalidValue;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (x_bf16) {
    g.piece = (cin % 8 == 0 && addr % 16 == 0) ? 8 : (cin % 4 == 0 && addr % 8 == 0) ? 4
              : (cin % 2 == 0 && addr % 4 == 0) ? 2 : 1;
  } else {
    g.piece = (cin % 4 == 0 && addr % 16 == 0) ? 4 : 1;
  }
  const int n8 = g.npad / 8;
  int nt = n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : n8 == 12 ? 12 : 8;
  size_t smem;
  for (;;) {  // the widest channel tile whose operands fit, double-buffered where they can be
    g.n_rows = nt * 8;
    g.stages = 2;
    smem = mma_smem(g, flat);
    if (!flat && smem > static_cast<size_t>(smem_max)) {
      g.stages = 1;
      smem = mma_smem(g, flat);
    }
    if (smem <= static_cast<size_t>(smem_max)) break;
    if (nt == 1) return cudaErrorInvalidValue;
    nt = nt == 12 ? 8 : nt / 2;
  }
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
