// A whole SAME conv stack in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel davo_tpu/kernels/conv_stack.py fused_conv_stack
// (_stack_kernel): every layer of a k x k SAME conv stack (strides 1 and 2,
// bias, optional ReLU per layer) in one kernel, the activations never
// handed back between layers. The TPU kernel runs one program per batch
// tile with the tile's whole stack in VMEM; copied here, B=64 would keep
// only 8 of the card's 132 SMs busy. Instead one persistent grid, sized
// to the card with the occupancy API and launched cooperatively, walks
// the layers in order: each layer's output tiles are spread over every
// block, and a grid-wide barrier (cooperative_groups grid sync) separates
// one layer from the next. Intermediates go to a workspace in device
// memory (one region per layer, written once; at the davo-fast pose
// prefix the largest, layer 0's output, is 27 MB in bf16 at B=64 and
// stays in the 50 MB L2 for the next layer).
//
// Each layer computes what a layer of the TPU kernel computes: operands in
// the compute dtype (the stack's float32 input rounded to bf16 as it is
// staged in bf16 mode; weights packed as bf16), products summed in f32,
// + f32 bias, ReLU; an intermediate is rounded once to the compute dtype,
// the last layer is written as float32, unrounded. Stride 2 is a direct
// strided read with Flax's low pad (total / 2), at any input size.
//
// Bound on this card: operations at the bf16 tensor-core rate, bytes
// close behind (the davo-fast pose prefix at B=64: 23.4 GFLOP against
// 77 MB in and out). Two kernels, one launched per call by mode:
//
// conv_stack_mma_kernel (bfloat16): every layer is the fused layer
//   kernel's implicit GEMM on the tensor cores, the same device code
//   (conv_mma.cuh: mma.sync m16n8k16, f32 accumulators; K in chunks of
//   16 channels staged by cp.async and swizzled for ldmatrix for Cin >=
//   16, flat with a K-offset table below; the epilogue through shared
//   memory as 16-byte stores). A bf16 x bf16 product is exact in f32,
//   so it sums what the TPU kernel sums, in another order. One block
//   shape for all layers: 4 warps, a tile of 128 output pixels (16x8 or
//   8x16) by NT*8 output channels; the tile width, NT and the staging
//   depth of each layer are the layer kernel's plan (conv_mma.cuh
//   `mma_plan`) for kStackSmem bytes of shared memory a block, the
//   weights packed once per parameter (`rowconv._packed`). Per layer each block walks its tiles (tile,
//   channel block; neighbouring blocks on neighbouring tiles) and the
//   grid syncs. The intermediates are read only through L2 (cp.async.cg
//   and ld.global.cg; kCoherent): other blocks wrote them in this launch;
//   layer 0 reads the stack's input through the read-only path.
//   What limits it: mma.sync (not wgmma) issue and ldmatrix traffic, the
//   staging of each chunk's weights by every tile, and the occupancy that
//   one register budget and the largest layer's shared memory allow.
//
// conv_stack_fma_kernel (float32): exact f32 products on the FMA units
//   (67 TFLOP/s). A block of 128 threads takes a tile of 128 x kPx output
//   pixels (kPx consecutive pixels of one row per thread) by CO output
//   channels; it stages that channel slice's k*k*Cin*CO weights in shared
//   memory, read from the OIHW float32 parameters, and keeps kPx*CO
//   accumulators per thread. Tiles are ordered slice-major, so a block
//   restages weights only when its slice changes. Activations are read
//   with plain loads. What limits it: the f32 FMA rate, and L1 traffic
//   from input rows that neighbouring threads re-read.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace davo;

constexpr int kThreads = 128;                // both kernels; the tensor-core one as Layout<4, *>
constexpr int kPx = 4;                       // FMA path: output pixels of one row per thread
constexpr int kMaxLayers = 16;               // kernels/conv_stack.py MAX_LAYERS
constexpr int kParams = 13;                  // ints per layer in davo_conv_stack's table
constexpr size_t kSliceSmem = 48 * 1024;     // FMA path: preferred weight slice per block
// Tensor-core path: shared memory a layer's plan may take. The largest
// layer sets it for the whole launch, and four blocks of this fit an SM
// (228 KB, 1 KB reserved per block), as the kernel's register budget (128
// a thread) does.
constexpr size_t kStackSmem = 56 * 1024;

struct Layer {
  const void* x;    // (B, H, W, cin), bf16 (layer 0 only) or f32
  float* out;       // (B, Ho, Wo, cout) float32
  const float* w;   // (cout, cin, k, k) OIHW float32
  const float* b;   // (cout,) float32
  int x_bf16, vec, H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l, relu, co;
  long long groups;  // B * Ho * ceil(Wo / kPx): one thread's pixel groups
  long long tiles;   // ceil(groups / kThreads) * (cout / co)
};

struct Stack {
  Layer layer[kMaxLayers];
  int n;
};

__device__ __forceinline__ float widen_bf16(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Activations may have been written by another block during this launch:
// plain (coherent) loads only.
__device__ __forceinline__ float load1(const void* base, long long i, int bf16) {
  if (bf16) return widen_bf16(static_cast<const unsigned short*>(base)[i]);
  return static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void load4(const void* base, long long i, int bf16, float v[4]) {
  if (bf16) {
    // bf16 -> f32 is a 16-bit shift; element 0 sits in the low half.
    const uint2 q = *reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(base) + i);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    const float4 q = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
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

// Output channels [co0, co0 + CO) of the layer into shared memory as
// (k*k*cin, CO): row (ky*k + kx)*cin + c, read from OIHW.
template <int CO>
__device__ void stage_weights(const Layer& L, int co0, float* sw) {
  const int kk = L.k * L.k;
  const int rows = kk * L.cin;
  for (int i = threadIdx.x; i < rows * CO; i += blockDim.x) {
    const int r = i / CO, o = i % CO;
    const int c = r % L.cin, tap = r / L.cin;
    sw[i] = __ldg(L.w + (static_cast<long long>(co0 + o) * L.cin + c) * kk + tap);
  }
}

// One thread's kPx output pixels (pixel group g) x CO channels from co0.
template <int CO, bool kVec>
__device__ __forceinline__ void conv_pixels(const Layer& L, const float* sw, long long g, int co0) {
  const int wgroups = (L.Wo + kPx - 1) / kPx;
  const int ox0 = static_cast<int>(g % wgroups) * kPx;
  const long long q = g / wgroups;  // b * Ho + oy
  const int oy = static_cast<int>(q % L.Ho);
  const long long b = q / L.Ho;
  const int cin = L.cin, k = L.k;

  float acc[kPx][CO];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[p][o] = 0.0f;
  }

  for (int ky = 0; ky < k; ++ky) {
    const int iy = oy * L.stride - L.pad_t + ky;
    if (iy < 0 || iy >= L.H) continue;  // SAME zero padding
    const long long row = (b * L.H + iy) * static_cast<long long>(L.W) * cin;
    for (int kx = 0; kx < k; ++kx) {
      long long src[kPx];
      bool ok[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const int ix = (ox0 + p) * L.stride - L.pad_l + kx;
        ok[p] = ix >= 0 && ix < L.W && ox0 + p < L.Wo;
        src[p] = row + static_cast<long long>(ok[p] ? ix : 0) * cin;
      }
      const float* wt = sw + (ky * k + kx) * cin * CO;
      if constexpr (kVec) {
        for (int c = 0; c < cin; c += 4) {
          float v[kPx][4];
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            if (ok[p]) {
              load4(L.x, src[p] + c, L.x_bf16, v[p]);
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
            v[p] = ok[p] ? load1(L.x, src[p] + c, L.x_bf16) : 0.0f;
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
  for (int o = 0; o < CO; ++o) bv[o] = __ldg(L.b + co0 + o);
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    if (ox0 + p >= L.Wo) break;
    const long long base = (q * L.Wo + ox0 + p) * L.cout + co0;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      L.out[base + o] = L.relu ? fmaxf(acc[p][o] + bv[o], 0.0f) : acc[p][o] + bv[o];
    }
  }
}

// This block's share of one layer: tiles blockIdx.x, + gridDim.x, ...;
// tile t covers channel slice t / px_tiles and pixel groups
// [(t % px_tiles) * kThreads, + kThreads).
template <int CO>
__device__ void run_layer(const Layer& L, float* sw) {
  const long long px_tiles = (L.groups + kThreads - 1) / kThreads;
  long long slice = -1;
  for (long long t = blockIdx.x; t < L.tiles; t += gridDim.x) {
    const long long s = t / px_tiles;
    if (s != slice) {
      __syncthreads();  // every thread is done with the previous slice
      stage_weights<CO>(L, static_cast<int>(s) * CO, sw);
      __syncthreads();
      slice = s;
    }
    const long long g = (t % px_tiles) * kThreads + threadIdx.x;
    if (g < L.groups) {
      if (L.vec) {
        conv_pixels<CO, true>(L, sw, g, static_cast<int>(s) * CO);
      } else {
        conv_pixels<CO, false>(L, sw, g, static_cast<int>(s) * CO);
      }
    }
  }
}

// The layer table stays in the launch's parameter space (__grid_constant__:
// no per-thread copy); each layer's fields are read once into registers.
__global__ void __launch_bounds__(kThreads) conv_stack_fma_kernel(const __grid_constant__ Stack stack) {
  extern __shared__ __align__(16) float sw[];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < stack.n; ++i) {
    const Layer L = stack.layer[i];
    switch (L.co) {
      case 16: run_layer<16>(L, sw); break;
      case 8: run_layer<8>(L, sw); break;
      case 4: run_layer<4>(L, sw); break;
      case 2: run_layer<2>(L, sw); break;
      default: run_layer<1>(L, sw); break;
    }
    if (i + 1 < stack.n) grid.sync();  // layer i's output is complete and visible
  }
}

// --------------------------------------------------------- tensor-core path

// One bf16 layer of the tensor-core kernel: its geometry (conv_mma.cuh)
// and its grid-stride walk over B * tiles * cblocks items.
struct MmaLayer {
  const void* x;              // (B, H, W, cin): bf16, or float32 for layer 0
  void* out;                  // (B, Ho, Wo, cout): bf16, float32 for the last layer
  const __nv_bfloat16* w;     // rowconv._pack_mma's (Np, K)
  const float* b;             // (cout,) float32
  MmaGeo g;
  int x_bf16, flat, nt, cblocks;
  long long items;
};

struct MmaStack {
  MmaLayer layer[kMaxLayers];
  int n;
};

// Item i is channel block i % cblocks of tile i / cblocks (image-major),
// so that neighbouring blocks read one input halo at the same time.
template <typename TIn, bool kCoherent, int NT, typename Lay, bool kFlat>
__device__ void mma_layer(const MmaLayer& L, uint4* smem) {
  const TIn* x = static_cast<const TIn*>(L.x);
  for (long long i = blockIdx.x; i < L.items; i += gridDim.x) {
    const Tile t = tile_at(L.g, static_cast<int>(i / L.cblocks), static_cast<int>(i % L.cblocks));
    __syncthreads();  // the previous tile's epilogue is done with shared memory
    if constexpr (kFlat) {
      conv_mma_flat_tile<TIn, NT, Lay, kCoherent>(x, L.w, L.b, L.out, L.g, t, smem);
    } else {
      conv_mma_chunked_tile<TIn, NT, Lay, kCoherent>(x, L.w, L.b, L.out, L.g, t, smem);
    }
  }
}

template <typename TIn, bool kCoherent, typename Lay, bool kFlat>
__device__ void mma_layer_nt(const MmaLayer& L, uint4* smem) {
  switch (L.nt) {
    case 8: mma_layer<TIn, kCoherent, 8, Lay, kFlat>(L, smem); break;
    case 4: mma_layer<TIn, kCoherent, 4, Lay, kFlat>(L, smem); break;
    case 2: mma_layer<TIn, kCoherent, 2, Lay, kFlat>(L, smem); break;
    default: mma_layer<TIn, kCoherent, 1, Lay, kFlat>(L, smem); break;
  }
}

template <typename TIn, bool kCoherent>
__device__ void mma_layer_any(const MmaLayer& L, uint4* smem) {
  if (L.flat) {
    if (L.g.tile_w == 16) {
      mma_layer_nt<TIn, kCoherent, Layout<4, 16>, true>(L, smem);
    } else {
      mma_layer_nt<TIn, kCoherent, Layout<4, 8>, true>(L, smem);
    }
  } else if (L.g.tile_w == 16) {
    mma_layer_nt<TIn, kCoherent, Layout<4, 16>, false>(L, smem);
  } else {
    mma_layer_nt<TIn, kCoherent, Layout<4, 8>, false>(L, smem);
  }
}

// At most 128 registers a thread: four blocks an SM, as kStackSmem plans.
// Layer 0 reads the stack's input, which no block writes, through the
// read-only path; the later layers read the intermediates through L2 only.
__global__ void __launch_bounds__(kThreads, 4) conv_stack_mma_kernel(const __grid_constant__ MmaStack stack) {
  extern __shared__ __align__(16) uint4 smem4[];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < stack.n; ++i) {
    const MmaLayer& L = stack.layer[i];
    if (i > 0) {
      mma_layer_any<__nv_bfloat16, true>(L, smem4);
    } else if (L.x_bf16) {
      mma_layer_any<__nv_bfloat16, false>(L, smem4);
    } else {
      mma_layer_any<float, false>(L, smem4);
    }
    if (i + 1 < stack.n) grid.sync();  // layer i's output is complete and visible
  }
}

// ------------------------------------------------------------------ host

size_t slice_bytes(const Layer& L, int co) {
  return static_cast<size_t>(L.k) * L.k * L.cin * co * sizeof(float);
}

// The last launch's grid (blocks, blocks per SM, dynamic shared memory,
// layers) and, in bf16 mode, each layer's plan (tile width, nt, stages).
int last_launch[4 + 3 * kMaxLayers] = {};

// As many blocks as the card holds at once (a grid barrier needs every
// block resident), but no more than the largest layer has items.
template <typename Arg>
cudaError_t launch_cooperative(void (*kernel)(Arg), const Arg& arg, size_t smem, long long max_items,
                               int device, int sms, int (&granted)[kMaxDevices], cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, device, smem, granted);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(resident < max_items ? resident : max_items);
  last_launch[0] = static_cast<int>(blocks);
  last_launch[1] = per_sm;
  last_launch[2] = static_cast<int>(smem);
  last_launch[3] = arg.n;
  void* args[] = {const_cast<Arg*>(&arg)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // leave no error behind for the next launch to report
    return err;
  }
  return cudaGetLastError();
}

cudaError_t launch_fma(int n, int B, const void* const* xs, void* const* outs, const void* const* ws,
                       const float* const* bs, const int* params, int device, int smem_max, int sms,
                       cudaStream_t stream) {
  Stack stack{};
  stack.n = n;
  size_t smem = 0;
  long long max_tiles = 1;
  for (int i = 0; i < n; ++i) {
    const int* p = params + i * kParams;
    Layer& L = stack.layer[i];
    L.x = xs[i];
    L.out = static_cast<float*>(outs[i]);
    L.w = static_cast<const float*>(ws[i]);
    L.b = bs[i];
    L.x_bf16 = p[0];
    L.H = p[2];
    L.W = p[3];
    L.cin = p[4];
    L.Ho = p[5];
    L.Wo = p[6];
    L.cout = p[7];
    L.k = p[8];
    L.stride = p[9];
    L.pad_t = p[10];
    L.pad_l = p[11];
    L.relu = p[12];
    if (i > 0 && L.x_bf16) return cudaErrorInvalidValue;  // float32 intermediates
    L.vec = p[1] && L.cin % 4 == 0;
    // The widest channel slice that divides cout and fits the preferred
    // shared memory; one channel at a time up to the block's limit.
    int co = 16;
    while (co > 1 && (L.cout % co != 0 || slice_bytes(L, co) > kSliceSmem)) co /= 2;
    if (slice_bytes(L, co) > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
    L.co = co;
    L.groups = static_cast<long long>(B) * L.Ho * ((L.Wo + kPx - 1) / kPx);
    L.tiles = (L.groups + kThreads - 1) / kThreads * (L.cout / co);
    if (slice_bytes(L, co) > smem) smem = slice_bytes(L, co);
    if (L.tiles > max_tiles) max_tiles = L.tiles;
  }
  static int granted[kMaxDevices] = {};
  return launch_cooperative(conv_stack_fma_kernel, stack, smem, max_tiles, device, sms, granted, stream);
}

cudaError_t launch_mma(int n, int B, const void* const* xs, void* const* outs, const void* const* ws,
                       const float* const* bs, const int* params, int device, int sms, cudaStream_t stream) {
  MmaStack stack{};
  stack.n = n;
  size_t smem = 0;
  long long max_items = 1;
  for (int i = 0; i < n; ++i) {
    const int* p = params + i * kParams;
    if (i > 0 && !p[0]) return cudaErrorInvalidValue;  // bf16 intermediates
    MmaLayer& L = stack.layer[i];
    L.flat = mma_flat(p[4]);
    L.x = xs[i];
    L.out = outs[i];
    L.w = static_cast<const __nv_bfloat16*>(ws[i]);
    L.b = bs[i];
    L.x_bf16 = p[0];
    MmaGeo& g = L.g;
    // The 4-warp tiles (one block shape for every layer) and NT up to 8.
    const size_t bytes =
        mma_plan(g, B, p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], sms, kStackSmem, false, false);
    if (bytes == 0) return cudaErrorInvalidValue;
    L.nt = g.n_rows / 8;
    last_launch[4 + 3 * i] = g.tile_w;
    last_launch[5 + 3 * i] = L.nt;
    last_launch[6 + 3 * i] = g.stages;
    g.piece = p[1] ? mma_piece(xs[i], p[0], g.cin) : 1;
    g.relu = p[12];
    g.round_out = g.out_bf16 = i + 1 < n;
    L.cblocks = (g.npad + g.n_rows - 1) / g.n_rows;
    const long long tiles = static_cast<long long>(B) * g.tiles;
    if (tiles > INT_MAX) return cudaErrorInvalidValue;
    L.items = tiles * L.cblocks;
    if (bytes > smem) smem = bytes;
    if (L.items > max_items) max_items = L.items;
  }
  static int granted[kMaxDevices] = {};
  return launch_cooperative(conv_stack_mma_kernel, stack, smem, max_items, device, sms, granted, stream);
}

}  // namespace

extern "C" {

// The stack x -> out, batch B, in one cooperative launch on `stream`.
// Layer i reads xs[i] and writes outs[i] (xs[i+1] == outs[i]: the
// caller's workspace), with weights ws[i] and bias bs[i] (float32).
// params holds kParams ints per layer: x_bf16, aligned (xs[i] is aligned
// for vector loads), H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l,
// relu. act_bf16: the bfloat16 mode, on the tensor cores: ws[i] as
// rowconv._pack_mma packs them, intermediates bf16. Else float32 on the
// FMA units: ws[i] OIHW float32, intermediates float32. The last layer is
// always float32. Returns a cudaError_t (InvalidValue for a table the
// kernel cannot take).
int davo_conv_stack(int n, int B, const void* const* xs, void* const* outs, const void* const* ws,
                    const float* const* bs, const int* params, int act_bf16, void* stream) {
  if (n <= 0 || n > kMaxLayers || B <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const int* p = params + i * kParams;
    if (p[2] <= 0 || p[3] <= 0 || p[4] <= 0 || p[5] <= 0 || p[6] <= 0 || p[7] <= 0 || p[8] <= 0 ||
        p[8] % 2 == 0 || (p[9] != 1 && p[9] != 2)) {
      return cudaErrorInvalidValue;
    }
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  for (int i = 4; i < 4 + 3 * kMaxLayers; ++i) last_launch[i] = 0;
  if (act_bf16) return launch_mma(n, B, xs, outs, ws, bs, params, device, sms, s);
  return launch_fma(n, B, xs, outs, ws, bs, params, device, smem_max, sms, s);
}

// The last launch: out[0] blocks, out[1] blocks per SM (the occupancy
// query's answer), out[2] dynamic shared memory in bytes, out[3] layers;
// in bf16 mode out[4 + 3i ..] layer i's tile width, nt and stages (else
// 0). out holds 4 + 3 * kMaxLayers ints.
int davo_conv_stack_last_launch(int* out) {
  for (int i = 0; i < 4 + 3 * kMaxLayers; ++i) out[i] = last_launch[i];
  return 0;
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
