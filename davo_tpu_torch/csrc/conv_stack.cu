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
// the compute dtype (bf16 mode: the stack's float32 input rounded to bf16
// as it is staged, weights packed as bf16; float32 mode: float32
// operands), products summed in f32, + f32 bias, ReLU; an intermediate is
// rounded once to the compute dtype, the last layer is written as
// float32, unrounded. Stride 2 is a direct strided read with Flax's low
// pad (total / 2), at any input size.
//
// Both modes run every layer as the fused layer kernel's implicit GEMM on
// the tensor cores, the same device code (conv_mma.cuh): one block shape
// for all layers, 4 warps, a tile of 128 output pixels (16x8 or 8x16) by
// NT*8 output channels; K in chunks of 16 channels staged by cp.async and
// swizzled for ldmatrix for Cin >= 16, flat with a K-offset table below;
// the epilogue through shared memory as 16-byte stores. The tile width,
// NT and the staging depth of each layer are the layer kernel's plan
// (conv_mma.cuh `mma_plan`) for the mode's shared memory a block, the
// weights packed once per parameter (`rowconv._packed`). Per layer each
// block walks its tiles (tile, channel block; neighbouring blocks on
// neighbouring tiles) and the grid syncs. The intermediates are read only
// through L2 (cp.async.cg and ld.global.cg; kCoherent): other blocks
// wrote them in this launch; layer 0 reads the stack's input through the
// read-only path. One kernel a mode, one launched per call:
//
// conv_stack_mma_kernel (bfloat16): mma.sync m16n8k16, bf16 x bf16 -> f32
//   (a bf16 product is exact in f32, so it sums what the TPU kernel sums,
//   in another order); kStackSmem a block, four blocks an SM, at most 128
//   registers a thread. Bound on this card: operations at the bf16
//   tensor-core rate, bytes close behind (the davo-fast pose prefix at
//   B=64: 23.4 GFLOP against 77 MB in and out).
//
// conv_stack_tf32_kernel (float32): mma.sync m16n8k8 in split TF32, the
//   layer kernel's float32 tiles (`conv_tf32_chunked_tile`,
//   `conv_tf32_flat_tile`): weights split by the host into TF32 hi and lo
//   planes (`rowconv._pack_tf32`), three products per term (two for a
//   bf16 stack input, exact in TF32), every 16 K's products in a fresh
//   accumulator added to the running float32 sum (a running mma sum
//   drifts past 1e-5 of the largest output over a deep K). Float32
//   intermediates, 4 bytes an element: at B=64 layer 0's output is 54.5
//   MB, past the 50 MB L2. Float32 operands take four times the bf16
//   tile's bytes, so the plan gets kStackSmemTf32, two blocks an SM, and
//   the tiles run with kSplitOnRead (MmaPrec::kTf32SplitOnRead): the
//   input's halo is one plane of float32, copied by cp.async (16-byte
//   units; 4-byte elements in the flat order's layer 0) and split into hi
//   and lo as each fragment is read, half the bytes of the two planes the
//   layer kernel stages (on the pose prefix NT 2, 2, 8, 8, 8 where two
//   planes would leave 2, 1, 4, 4, 4); and where the flat order or a
//   one-chunk K lets the epilogue stage in the halo's place, a block
//   keeps its channel block's weights in shared memory from one tile to
//   the next (layer 0, Cin 9, 7x7: all of K's 448 weight rows for its 16
//   channels in hi and lo, 57,856 bytes, staged once a block instead of
//   once a tile). Registers are not held to 128 as in the bf16 kernel:
//   two blocks an SM leave a thread 255. Bound on this card: the FLOPs
//   as 3 TF32 passes at 494.7 TFLOP/s (0.142 ms for the pose prefix at
//   B=64; 0.349 ms at the f32 FMA rate). What limits it: mma.sync issue
//   (3 products for one), the conversions that split the input as it is
//   read, the halo's staging, which each tile waits for, and the
//   occupancy that two blocks an SM give.

#include <climits>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "conv_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace davo;

constexpr int kThreads = 128;                // both kernels, as Layout<4, *>
constexpr int kMaxLayers = 16;               // kernels/conv_stack.py MAX_LAYERS
constexpr int kParams = 13;                  // ints per layer in davo_conv_stack's table
// Shared memory a layer's plan may take. The largest layer sets it for
// the whole launch, as many blocks of it must fit an SM (228 KB, 1 KB
// reserved per block) as the grid barrier keeps resident: bf16 four (as
// the kernel's register budget, 128 a thread, does), float32 two.
constexpr size_t kStackSmem = 56 * 1024;
constexpr size_t kStackSmemTf32 = 113 * 1024;

// One layer of either kernel: its geometry (conv_mma.cuh) and its
// grid-stride walk over B * tiles * cblocks items.
struct MmaLayer {
  const void* x;     // (B, H, W, cin) in the compute dtype; layer 0 the stack's input, float32 or bf16
  void* out;         // (B, Ho, Wo, cout) in the compute dtype, float32 for the last layer
  const void* w;     // rowconv._packed: _pack_mma's bf16 (Np, K), or _pack_tf32's float32 (2, Np, K)
  const float* b;    // (cout,) float32
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
// A float32 tile keeps its channel block's weights in shared memory for
// the block's next tile of the same channel block where it can (the flat
// order; the chunked one where K is one chunk).
template <bool kTf32, typename TIn, bool kCoherent, int NT, typename Lay, bool kFlat>
__device__ void mma_layer(const MmaLayer& L, uint4* smem) {
  const TIn* x = static_cast<const TIn*>(L.x);
  int staged = -1;  // the channel block whose weights shared memory holds
  for (long long i = blockIdx.x; i < L.items; i += gridDim.x) {
    const int cb = static_cast<int>(i % L.cblocks);
    const Tile t = tile_at(L.g, static_cast<int>(i / L.cblocks), cb);
    __syncthreads();  // the previous tile's epilogue is done with shared memory
    if constexpr (kTf32 && kFlat) {
      conv_tf32_flat_tile<TIn, NT, Lay, kCoherent, true>(x, static_cast<const float*>(L.w), L.b, L.out, L.g, t,
                                                         smem, cb != staged);
      staged = cb;
    } else if constexpr (kTf32) {
      conv_tf32_chunked_tile<TIn, NT, Lay, kCoherent, true>(x, static_cast<const float*>(L.w), L.b, L.out, L.g, t,
                                                            smem, cb != staged);
      staged = cb;
    } else if constexpr (kFlat) {
      conv_mma_flat_tile<TIn, NT, Lay, kCoherent>(x, static_cast<const __nv_bfloat16*>(L.w), L.b, L.out, L.g, t,
                                                  smem);
    } else {
      conv_mma_chunked_tile<TIn, NT, Lay, kCoherent>(x, static_cast<const __nv_bfloat16*>(L.w), L.b, L.out, L.g,
                                                     t, smem);
    }
  }
}

template <bool kTf32, typename TIn, bool kCoherent, typename Lay, bool kFlat>
__device__ void mma_layer_nt(const MmaLayer& L, uint4* smem) {
  switch (L.nt) {
    case 8: mma_layer<kTf32, TIn, kCoherent, 8, Lay, kFlat>(L, smem); break;
    case 4: mma_layer<kTf32, TIn, kCoherent, 4, Lay, kFlat>(L, smem); break;
    case 2: mma_layer<kTf32, TIn, kCoherent, 2, Lay, kFlat>(L, smem); break;
    default: mma_layer<kTf32, TIn, kCoherent, 1, Lay, kFlat>(L, smem); break;
  }
}

template <bool kTf32, typename TIn, bool kCoherent>
__device__ void mma_layer_any(const MmaLayer& L, uint4* smem) {
  if (L.flat) {
    if (L.g.tile_w == 16) {
      mma_layer_nt<kTf32, TIn, kCoherent, Layout<4, 16>, true>(L, smem);
    } else {
      mma_layer_nt<kTf32, TIn, kCoherent, Layout<4, 8>, true>(L, smem);
    }
  } else if (L.g.tile_w == 16) {
    mma_layer_nt<kTf32, TIn, kCoherent, Layout<4, 16>, false>(L, smem);
  } else {
    mma_layer_nt<kTf32, TIn, kCoherent, Layout<4, 8>, false>(L, smem);
  }
}

// The layers in order, a grid barrier between two. Layer 0 reads the
// stack's input, which no block writes, through the read-only path; the
// later layers read the intermediates (the compute dtype: bf16, or
// float32 with kTf32) through L2 only.
template <bool kTf32>
__device__ void run_stack(const MmaStack& stack, uint4* smem) {
  using TAct = typename std::conditional<kTf32, float, __nv_bfloat16>::type;
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < stack.n; ++i) {
    const MmaLayer& L = stack.layer[i];
    if (i > 0) {
      mma_layer_any<kTf32, TAct, true>(L, smem);
    } else if (L.x_bf16) {
      mma_layer_any<kTf32, __nv_bfloat16, false>(L, smem);
    } else {
      mma_layer_any<kTf32, float, false>(L, smem);
    }
    if (i + 1 < stack.n) grid.sync();  // layer i's output is complete and visible
  }
}

// The layer table stays in the launch's parameter space (__grid_constant__:
// no per-thread copy). bf16: at most 128 registers a thread, four blocks
// an SM, as kStackSmem plans.
__global__ void __launch_bounds__(kThreads, 4) conv_stack_mma_kernel(const __grid_constant__ MmaStack stack) {
  extern __shared__ __align__(16) uint4 smem4[];
  run_stack<false>(stack, smem4);
}

// float32: two blocks an SM, as kStackSmemTf32 plans.
__global__ void __launch_bounds__(kThreads, 2) conv_stack_tf32_kernel(const __grid_constant__ MmaStack stack) {
  extern __shared__ __align__(16) uint4 smem4[];
  run_stack<true>(stack, smem4);
}

// ------------------------------------------------------------------ host

// The last launch's grid (blocks, blocks per SM, dynamic shared memory,
// layers) and each layer's plan (tile width, nt, stages).
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

// The stack's table and plans for one kernel (tf32: the float32 one) and
// its launch; InvalidValue where an intermediate is not in the mode's
// dtype or a layer has no plan within the mode's shared memory.
cudaError_t launch_stack(bool tf32, int n, int B, const void* const* xs, void* const* outs, const void* const* ws,
                         const float* const* bs, const int* params, int device, int sms, cudaStream_t stream) {
  MmaStack stack{};
  stack.n = n;
  size_t smem = 0;
  long long max_items = 1;
  for (int i = 0; i < n; ++i) {
    const int* p = params + i * kParams;
    if (i > 0 && p[0] == static_cast<int>(tf32)) return cudaErrorInvalidValue;  // intermediates in the mode's dtype
    MmaLayer& L = stack.layer[i];
    L.flat = mma_flat(p[4]);
    L.x = xs[i];
    L.out = outs[i];
    L.w = ws[i];
    L.b = bs[i];
    L.x_bf16 = p[0];
    MmaGeo& g = L.g;
    // The 4-warp tiles (one block shape for every layer) and NT up to 8.
    // float32: the input's one plane, split as it is read (kSplitOnRead).
    const MmaPrec prec = tf32 ? MmaPrec::kTf32SplitOnRead : MmaPrec::kBf16;
    const size_t bytes = mma_plan(g, B, p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11], sms,
                                  tf32 ? kStackSmemTf32 : kStackSmem, false, false, prec);
    if (bytes == 0) return cudaErrorInvalidValue;
    L.nt = g.n_rows / 8;
    last_launch[4 + 3 * i] = g.tile_w;
    last_launch[5 + 3 * i] = L.nt;
    last_launch[6 + 3 * i] = g.stages;
    g.piece = p[1] ? mma_piece(xs[i], p[0], g.cin) : 1;
    g.relu = p[12];
    g.round_out = g.out_bf16 = !tf32 && i + 1 < n;
    L.cblocks = (g.npad + g.n_rows - 1) / g.n_rows;
    const long long tiles = static_cast<long long>(B) * g.tiles;
    if (tiles > INT_MAX) return cudaErrorInvalidValue;
    L.items = tiles * L.cblocks;
    if (bytes > smem) smem = bytes;
    if (L.items > max_items) max_items = L.items;
  }
  if (tf32) {
    static int granted[kMaxDevices] = {};
    return launch_cooperative(conv_stack_tf32_kernel, stack, smem, max_items, device, sms, granted, stream);
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
// relu. act_bf16: the bfloat16 mode (conv_stack_mma_kernel): ws[i] as
// rowconv._pack_mma packs them, intermediates bf16. Else float32
// (conv_stack_tf32_kernel): ws[i] as rowconv._pack_tf32 packs them (TF32
// hi and lo planes), intermediates float32. The last layer is always
// float32. Returns a cudaError_t (InvalidValue for a table the kernel
// cannot take).
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
  return launch_stack(!act_bf16, n, B, xs, outs, ws, bs, params, device, sms, s);
}

// The last launch: out[0] blocks, out[1] blocks per SM (the occupancy
// query's answer), out[2] dynamic shared memory in bytes, out[3] layers;
// out[4 + 3i ..] layer i's tile width, nt and stages. out holds 4 + 3 *
// kMaxLayers ints.
int davo_conv_stack_last_launch(int* out) {
  for (int i = 0; i < 4 + 3 * kMaxLayers; ++i) out[i] = last_launch[i];
  return 0;
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
