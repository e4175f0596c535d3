// A whole SAME conv stack in ONE launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel davo_tpu/kernels/conv_stack.py fused_conv_stack
// (_stack_kernel): every layer of a k x k SAME conv stack (strides 1 and 2,
// bias, optional ReLU per layer) in one kernel, the activations never
// handed back between layers. The TPU kernel runs one program per batch
// tile with the tile's whole stack in VMEM; copied here, B=64 would keep
// only 8 of the card's 132 SMs busy. Instead one persistent grid, sized
// to the card with the occupancy API and launched cooperatively, walks
// the layers in order: each layer's output pixels are spread over every
// block, and a grid-wide barrier (cooperative_groups grid sync) separates
// one layer from the next. Intermediates go to a workspace in device
// memory (one region per layer, written once; at the davo-fast pose
// prefix the largest, layer 0's output, is 27 MB in bf16 at B=64 and
// stays in the 50 MB L2 for the next layer). They are read with plain
// loads, not the read-only path: another block wrote them during this
// launch.
//
// Each layer computes what a layer of the TPU kernel computes: operands in
// the compute dtype (the stack's float32 input rounded to bf16 first in
// bf16 mode; weights rounded as they are staged), products summed in f32,
// + f32 bias, ReLU; an intermediate is rounded once to the compute dtype,
// the last layer is written as float32, unrounded. Stride 2 is a direct
// strided read with Flax's low pad (total / 2), at any input size.
//
// Bound on this card: operations at the bf16 tensor-core rate, bytes
// close behind (the davo-fast pose prefix at B=64: 23.4 GFLOP against
// 77 MB in and out). The products run on the f32 FMA units (67 TFLOP/s):
// a bf16 x bf16 product is exact in f32, so f32 FMAs give the same sums in
// both modes. A block of 128 threads takes a tile of 128 x kPx output
// pixels (kPx consecutive pixels of one row per thread) by CO output
// channels; it stages that channel slice's k*k*Cin*CO weights in shared
// memory, read straight from the OIHW float32 parameters (no repacking
// launch), and keeps kPx*CO accumulators per thread. Tiles are ordered
// slice-major, so a block restages weights only when its slice changes.
// What limits it: the f32 FMA rate, and L1 traffic from input rows that
// neighbouring threads re-read. Tensor-core products (wgmma), input tiles
// in shared memory and overlap across the barrier are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kPx = 4;                       // output pixels of one row per thread
constexpr int kMaxLayers = 16;               // kernels/conv_stack.py MAX_LAYERS
constexpr int kParams = 13;                  // ints per layer in davo_conv_stack's table
constexpr size_t kSliceSmem = 48 * 1024;     // preferred weight slice per block
constexpr size_t kMaxSmem = 227 * 1024;      // dynamic shared memory a block can use

struct Layer {
  const void* x;    // (B, H, W, cin), bf16 or f32
  void* out;        // (B, Ho, Wo, cout), bf16 or f32
  const float* w;   // (cout, cin, k, k) OIHW float32
  const float* b;   // (cout,) float32
  int x_bf16, vec, H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l, relu;
  int out_bf16, round_in, co;
  long long groups;  // B * Ho * ceil(Wo / kPx): one thread's pixel groups
  long long tiles;   // ceil(groups / kThreads) * (cout / co)
};

struct Stack {
  Layer layer[kMaxLayers];
  int n;
  int round_w;  // round weights to bf16 (bf16 mode)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

// Activations may have been written by another block during this launch:
// plain (coherent) loads only.
__device__ __forceinline__ float load1(const void* base, long long i, int bf16) {
  if (bf16) return bf16_bits(static_cast<const unsigned short*>(base)[i]);
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
__device__ void stage_weights(const Layer& L, int co0, int round_w, float* sw) {
  const int kk = L.k * L.k;
  const int rows = kk * L.cin;
  for (int i = threadIdx.x; i < rows * CO; i += blockDim.x) {
    const int r = i / CO, o = i % CO;
    const int c = r % L.cin, tap = r / L.cin;
    const float v = __ldg(L.w + (static_cast<long long>(co0 + o) * L.cin + c) * kk + tap);
    sw[i] = round_w ? round_bf16(v) : v;
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
              if (L.round_in) {
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
            v[p] = ok[p] ? load1(L.x, src[p] + c, L.x_bf16) : 0.0f;
            if (L.round_in) v[p] = round_bf16(v[p]);
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
      const float v = L.relu ? fmaxf(acc[p][o] + bv[o], 0.0f) : acc[p][o] + bv[o];
      if (L.out_bf16) {
        static_cast<__nv_bfloat16*>(L.out)[base + o] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(L.out)[base + o] = v;
      }
    }
  }
}

// This block's share of one layer: tiles blockIdx.x, + gridDim.x, ...;
// tile t covers channel slice t / px_tiles and pixel groups
// [(t % px_tiles) * kThreads, + kThreads).
template <int CO>
__device__ void run_layer(const Layer& L, int round_w, float* sw) {
  const long long px_tiles = (L.groups + kThreads - 1) / kThreads;
  long long slice = -1;
  for (long long t = blockIdx.x; t < L.tiles; t += gridDim.x) {
    const long long s = t / px_tiles;
    if (s != slice) {
      __syncthreads();  // every thread is done with the previous slice
      stage_weights<CO>(L, static_cast<int>(s) * CO, round_w, sw);
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
__global__ void __launch_bounds__(kThreads) conv_stack_kernel(const __grid_constant__ Stack stack) {
  extern __shared__ __align__(16) float sw[];
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < stack.n; ++i) {
    const Layer L = stack.layer[i];
    switch (L.co) {
      case 16: run_layer<16>(L, stack.round_w, sw); break;
      case 8: run_layer<8>(L, stack.round_w, sw); break;
      case 4: run_layer<4>(L, stack.round_w, sw); break;
      case 2: run_layer<2>(L, stack.round_w, sw); break;
      default: run_layer<1>(L, stack.round_w, sw); break;
    }
    if (i + 1 < stack.n) grid.sync();  // layer i's output is complete and visible
  }
}

size_t slice_bytes(const Layer& L, int co) {
  return static_cast<size_t>(L.k) * L.k * L.cin * co * sizeof(float);
}

}  // namespace

extern "C" {

// The stack x -> out, batch B, in one cooperative launch on `stream`.
// Layer i reads xs[i] and writes outs[i] (xs[i+1] == outs[i]: the
// caller's workspace), with weights ws[i] (OIHW float32) and bias bs[i].
// params holds kParams ints per layer: x_bf16, aligned (xs[i] is aligned
// for 4-channel loads), H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l,
// relu. act_bf16: the compute dtype is bf16 (intermediates stored as
// bf16, operands rounded to bf16); the last layer is always float32.
// Returns a cudaError_t (InvalidValue for a table the kernel cannot take).
int davo_conv_stack(int n, int B, const void* const* xs, void* const* outs,
                    const float* const* ws, const float* const* bs, const int* params,
                    int act_bf16, void* stream) {
  if (n <= 0 || n > kMaxLayers || B <= 0) return cudaErrorInvalidValue;
  Stack stack{};
  stack.n = n;
  stack.round_w = act_bf16;
  size_t smem = 0;
  long long max_tiles = 1;
  for (int i = 0; i < n; ++i) {
    const int* p = params + i * kParams;
    Layer& L = stack.layer[i];
    L.x = xs[i];
    L.out = outs[i];
    L.w = ws[i];
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
    if (L.H <= 0 || L.W <= 0 || L.cin <= 0 || L.Ho <= 0 || L.Wo <= 0 || L.cout <= 0 || L.k <= 0) {
      return cudaErrorInvalidValue;
    }
    L.vec = p[1] && L.cin % 4 == 0;
    L.out_bf16 = i + 1 < n ? act_bf16 : 0;
    L.round_in = act_bf16 && !L.x_bf16;
    // The widest channel slice that divides cout and fits the preferred
    // shared memory; one channel at a time up to the block's limit.
    int co = 16;
    while (co > 1 && (L.cout % co != 0 || slice_bytes(L, co) > kSliceSmem)) co /= 2;
    if (slice_bytes(L, co) > kMaxSmem) return cudaErrorInvalidValue;
    L.co = co;
    L.groups = static_cast<long long>(B) * L.Ho * ((L.Wo + kPx - 1) / kPx);
    L.tiles = (L.groups + kThreads - 1) / kThreads * (L.cout / co);
    if (slice_bytes(L, co) > smem) smem = slice_bytes(L, co);
    if (L.tiles > max_tiles) max_tiles = L.tiles;
  }

  const void* kernel = reinterpret_cast<const void*>(conv_stack_kernel);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(conv_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // As many blocks as the card holds at once (a grid barrier needs every
  // block resident), but no more than the largest layer has tiles.
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_stack_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const unsigned blocks = static_cast<unsigned>(resident < max_tiles ? resident : max_tiles);
  void* args[] = {&stack};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // leave no error behind for the next launch to report
    return err;
  }
  return cudaGetLastError();
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
