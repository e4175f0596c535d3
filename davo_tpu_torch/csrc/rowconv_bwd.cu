// Backward kernels of the fused training chains for Hopper (sm_90a).
//
// Replaces the backward halves of the TPU kernels of
// davo_tpu/kernels/rowconv.py:
//   conv_chain_nhwc_ad   (_chain_ad_bwd -> _chain_bwd_kernel),
//   flow_level_fused_ad  (_flow_level_ad_bwd -> _flow_level_bwd_kernel),
//   conv_chain_strided_ad (_strided_ad_bwd -> _strided_bwd_kernel).
// The TPU kernels run a whole chain's reverse sweep on one image in VMEM
// and accumulate dW/db across the sequential batch grid. Here the forward
// already keeps every layer's output in device memory (rowconv.cu, one
// launch per layer), so the reverse sweep is a chain of launches too, per
// layer from the last to the first:
//
//   conv_layer_dgrad   the input cotangent of one SAME conv layer (any odd
//                      k, stride 1 or 2, Flax's pads), as a gather: each
//                      input pixel sums over the outputs that read it;
//   conv_layer_wgrad   dW (k, k, Cin, Cout) and db (Cout) of the layer,
//                      summed over batch and pixels: per-chunk partial sums,
//                      then a fixed-order reduce over the chunks (two
//                      launches, no atomics: two runs give identical bits);
//   flow_level_input_bwd  the backward of rowconv.cu's flow_level_input_kernel:
//                      the cost-volume gate (cv > 0) / C, d f1 (taps of f2),
//                      d f2 (the transposed taps of f1, as a gather), and the
//                      feature and flow slices of the estimator input's
//                      cotangent.
//
// Both conv kernels read the layer's cotangent as the TPU kernel forms it,
// fused into their loads: dz = (dy + g) * (a_out > 0), with dy the float32
// cotangent from the layer above (absent for the last layer), g the
// cotangent of a tap output (float32 or bf16; absent for an inner layer)
// and the gate only for a ReLU layer, on the stored activation a_out.
// Products use the unrounded float32 weights and float32 operands, sums are
// float32, as the reference's backward (its dots take f32 operands); only
// the chain input's cotangent may be rounded, to the input's dtype.
//
// Bound on this card: operations. Each kernel does as many FLOPs as the
// layer's forward (2 k k Cin Cout per output pixel) on a few bytes per
// pixel, and they run on the f32 FMA units (67 TFLOP/s): the backward is
// float32 in every mode. Design: dgrad is the forward layer kernel with
// the roles of Cin and Cout swapped (a block stages the (k, k, Cout, CI)
// weights of CI input channels in shared memory; a thread sums 4 input
// pixels x CI channels); at stride 2 a thread takes 4 pixels of one
// column parity, so every tap it visits is a real one. wgrad is a
// (k k Cin + 1) x Cout product over pixels (the extra row of ones gives
// db): 64 x 64 tiles of 16 x 16 threads, 32 pixels per shared-memory stage.
// What limits them: f32 FMA rate, shared-memory traffic, and (wgrad) the
// im2col gather. Tensor-core products and fusing the layers come later.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPx = 4;                      // input pixels of one row per dgrad thread
constexpr size_t kMaxSmem = 227 * 1024;     // dynamic shared memory a block can use
constexpr int kTile = 64;                   // wgrad tile: 64 (k k Cin + 1) rows x 64 Cout
constexpr int kStage = 32;                  // wgrad pixels per shared-memory stage

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Element i of a float32 or bf16 array.
__device__ __forceinline__ float load_any(const void* p, int is_bf16, long long i) {
  if (is_bf16) return bf16_bits(__ldg(static_cast<const unsigned short*>(p) + i));
  return __ldg(static_cast<const float*>(p) + i);
}

// Elements i..i+3 (i a multiple of 4, the base aligned).
__device__ __forceinline__ void load_any4(const void* p, int is_bf16, long long i, float v[4]) {
  if (is_bf16) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(p) + i));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    const float4 q = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
}

__device__ __forceinline__ void store_any(void* out, int is_bf16, long long i, float v) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// The layer's output cotangent as the reference forms it.
struct Cotangent {
  const float* dy;  // (B, Ho, Wo, Cout) float32 from the layer above, or null
  const void* g;    // (B, Ho, Wo, Cout) tap cotangent, or null
  int g_bf16;
  const void* a;    // (B, Ho, Wo, Cout) the layer's stored output (ReLU layers)
  int a_bf16;
  int relu;

  __device__ __forceinline__ float at(long long i) const {
    float v = dy != nullptr ? __ldg(dy + i) : 0.0f;
    if (g != nullptr) v += load_any(g, g_bf16, i);
    if (relu) v *= load_any(a, a_bf16, i) > 0.0f ? 1.0f : 0.0f;
    return v;
  }

  __device__ __forceinline__ void at4(long long i, float v[4]) const {
    if (dy != nullptr) {
      load_any4(dy, 0, i, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = 0.0f;
    }
    if (g != nullptr) {
      float t[4];
      load_any4(g, g_bf16, i, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] += t[j];
    }
    if (relu) {
      float t[4];
      load_any4(a, a_bf16, i, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] *= t[j] > 0.0f ? 1.0f : 0.0f;
    }
  }
};

template <int CI>
__device__ __forceinline__ void load_row(const float* w, float wv[CI]) {
  if constexpr (CI % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CI; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + c);
      wv[c] = q.x;
      wv[c + 1] = q.y;
      wv[c + 2] = q.z;
      wv[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CI; ++c) wv[c] = w[c];
  }
}

// dx (B, H, W, dx_stride) <- the input cotangent of channels [CI*blockIdx.y,
// CI*blockIdx.y + CI) of a layer x (B, H, W, cin) -> (B, Ho, Wo, cout) with
// weights w (k, k, cin, cout) float32. Thread g: input row (b, iy), column
// parity r = ix % stride, and kPx pixels ix = (j0 + p) * stride + r.
template <int CI, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv_dgrad_kernel(Cotangent dz, const float* __restrict__ w, void* __restrict__ dx, int dx_bf16,
                  int dx_stride, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                  int pad_t, int pad_l, int wgroups, long long groups) {
  extern __shared__ __align__(16) float sw[];  // (k*k*cout, CI)
  const int ci0 = blockIdx.y * CI;
  const int rows = k * k * cout;
  for (int i = threadIdx.x; i < rows * CI; i += blockDim.x) {
    const int c = i / rows, rem = i % rows;  // rem = tap * cout + co
    const int tap = rem / cout, co = rem % cout;
    sw[rem * CI + c] = ci0 + c < cin ? w[(static_cast<long long>(tap) * cin + ci0 + c) * cout + co] : 0.0f;
  }
  __syncthreads();

  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= groups) return;
  const int gw = static_cast<int>(gid % wgroups);
  const long long q = gid / wgroups;  // b * H + iy
  const int iy = static_cast<int>(q % H);
  const long long b = q / H;
  const int r = gw % stride;
  const int j0 = (gw / stride) * kPx;

  float acc[kPx][CI];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
#pragma unroll
    for (int c = 0; c < CI; ++c) acc[p][c] = 0.0f;
  }

  for (int ky = 0; ky < k; ++ky) {
    const int t = iy + pad_t - ky;  // = oy * stride for the output that reads iy through ky
    if (t < 0 || t % stride != 0) continue;
    const int oy = t / stride;
    if (oy >= Ho) continue;
    const long long orow = (b * Ho + oy) * static_cast<long long>(Wo);
    for (int kx = 0; kx < k; ++kx) {
      const int u = r + pad_l - kx;  // ox * stride = (j0 + p) * stride + u
      if (((u % stride) + stride) % stride != 0) continue;
      const int dox = u / stride;  // exact: u is a multiple of stride
      long long src[kPx];
      bool ok[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const int ox = j0 + p + dox;
        ok[p] = ox >= 0 && ox < Wo && (j0 + p) * stride + r < W;
        src[p] = (orow + (ok[p] ? ox : 0)) * cout;
      }
      const float* wt = sw + (ky * k + kx) * cout * CI;
      if constexpr (kVec) {
        for (int co = 0; co < cout; co += 4) {
          float v[kPx][4];
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            if (ok[p]) {
              dz.at4(src[p] + co, v[p]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) v[p][j] = 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float wv[CI];
            load_row<CI>(wt + (co + j) * CI, wv);
#pragma unroll
            for (int p = 0; p < kPx; ++p) {
#pragma unroll
              for (int c = 0; c < CI; ++c) acc[p][c] = fmaf(v[p][j], wv[c], acc[p][c]);
            }
          }
        }
      } else {
        for (int co = 0; co < cout; ++co) {
          float v[kPx];
#pragma unroll
          for (int p = 0; p < kPx; ++p) v[p] = ok[p] ? dz.at(src[p] + co) : 0.0f;
          float wv[CI];
          load_row<CI>(wt + co * CI, wv);
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
#pragma unroll
            for (int c = 0; c < CI; ++c) acc[p][c] = fmaf(v[p], wv[c], acc[p][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int ix = (j0 + p) * stride + r;
    if (ix >= W) continue;
    const long long base = (q * W + ix) * dx_stride + ci0;
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      if (ci0 + c < cin) store_any(dx, dx_bf16, base + c, acc[p][c]);
    }
  }
}

template <int CI>
cudaError_t launch_dgrad(const Cotangent& dz, const float* w, void* dx, int dx_bf16, int dx_stride,
                         int B, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                         int pad_t, int pad_l, cudaStream_t s) {
  const bool vec = cout % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(dz.dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dz.g) % (dz.g_bf16 ? 8 : 16) == 0 &&
                   reinterpret_cast<uintptr_t>(dz.a) % (dz.a_bf16 ? 8 : 16) == 0;
  auto kernel = vec ? conv_dgrad_kernel<CI, true> : conv_dgrad_kernel<CI, false>;
  const size_t smem = static_cast<size_t>(k) * k * cout * CI * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int per_parity = (W + stride - 1) / stride;
  const int wgroups = stride * ((per_parity + kPx - 1) / kPx);
  const long long groups = static_cast<long long>(B) * H * wgroups;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads), (cin + CI - 1) / CI);
  kernel<<<grid, kThreads, smem, s>>>(dz, w, dx, dx_bf16, dx_stride, H, W, cin, Ho, Wo, cout, k,
                                      stride, pad_t, pad_l, wgroups, groups);
  return cudaGetLastError();
}

// partial (chunks, K + 1, cout): rows [0, K) are dW of this chunk's pixels
// in (k, k, cin) order, row K is db. x (B, H, W, x_stride), its first cin
// channels are the layer's input. Block (blockIdx.x, blockIdx.y,
// blockIdx.z): Cout tile, K tile, pixel chunk.
__global__ void __launch_bounds__(256)
conv_wgrad_partial_kernel(const void* __restrict__ x, int x_bf16, int x_stride, Cotangent dz,
                          float* __restrict__ partial, int H, int W, int cin, int Ho, int Wo,
                          int cout, int k, int stride, int pad_t, int pad_l, int pixels, int chunk) {
  __shared__ float xs[kStage][kTile];
  __shared__ float zs[kStage][kTile];
  const int K = k * k * cin;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int p_begin = static_cast<int>(blockIdx.z) * chunk;
  const int p_end = pixels - p_begin > chunk ? p_begin + chunk : pixels;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // This thread loads column lc (an im2col row kk and an output channel
  // co) of pixels lr, lr + 4, ..., lr + 28 of each stage.
  const int lc = tid % kTile, lr = tid / kTile;
  const int kk = k0 + lc;
  int ky = 0, kx = 0, ci = 0;
  if (kk < K) {
    ci = kk % cin;
    const int tap = kk / cin;
    ky = tap / k;
    kx = tap % k;
  }
  const int co = n0 + lc;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += kStage) {
#pragma unroll
    for (int i = 0; i < kStage / 4; ++i) {
      const int row = lr + 4 * i;
      const int p = p0 + row;  // pixel (b, oy, ox); 32-bit, checked by the caller
      float xv = 0.0f, zv = 0.0f;
      if (p < p_end) {
        const int ox = p % Wo;
        const int q = p / Wo;
        const int oy = q % Ho;
        const int b = q / Ho;
        if (kk < K) {
          const int iy = oy * stride - pad_t + ky, ix = ox * stride - pad_l + kx;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            xv = load_any(x, x_bf16, ((static_cast<long long>(b) * H + iy) * W + ix) * x_stride + ci);
          }
        } else if (kk == K) {
          xv = 1.0f;  // the row of ones: db
        }
        if (co < cout) zv = dz.at(static_cast<long long>(p) * cout + co);
      }
      xs[row][lc] = xv;
      zs[row][lc] = zv;
    }
    __syncthreads();
#pragma unroll 8
    for (int row = 0; row < kStage; ++row) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xs[row][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = zs[row][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* out = partial + static_cast<long long>(blockIdx.z) * (K + 1) * cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row > K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < cout) out[static_cast<long long>(row) * cout + col] = acc[i][j];
    }
  }
}

// out[i] = sum over chunks c, in order, of partial[c][i].
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ partial, int chunks, long long n, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += __ldg(partial + c * n + i);
  out[i] = s;
}

// The backward of flow_level_input_kernel. da0 (B, H, W, da_stride): the
// cotangent of the estimator input, channels [0, D) the cost volume's,
// then Cf of feat and Cu of flow_up; a0 (B, H, W, a0_stride) float32: the
// unrounded estimator input, whose channels [0, D) are the ReLU'd cost
// volume. Per shift t, g_t(p) = da0[p, t] * (cv[p, t] > 0) * (1 / C):
//   df1[p, c] = sum_t g_t(p) f2[p + s_t, c]
//   df2[p, c] = sum_t g_t(p - s_t) f1[p - s_t, c]
// in the order of t (the reference's), each rounded once to f1's dtype.
template <typename TIn>
__global__ void __launch_bounds__(256)
flow_level_input_bwd_kernel(const float* __restrict__ da0, int da_stride,
                            const float* __restrict__ a0, int a0_stride, const TIn* __restrict__ f1,
                            const TIn* __restrict__ f2, void* __restrict__ df1,
                            void* __restrict__ df2, int d_bf16, void* __restrict__ dfeat,
                            int dfeat_bf16, float* __restrict__ dflow, int H, int W, int C, int Cf,
                            int Cu, int search, long long pixels) {
  const int d = 2 * search + 1;
  const int D = d * d;
  const float inv_c = 1.0f / static_cast<float>(C);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = start; i < pixels * C; i += step) {
    const int c = static_cast<int>(i % C);
    const long long p = i / C;
    const int w = static_cast<int>(p % W);
    const int h = static_cast<int>((p / W) % H);
    float acc1 = 0.0f, acc2 = 0.0f;
    for (int t = 0; t < D; ++t) {
      const int dy = t / d - search, dx = t % d - search;
      if (h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W) {
        const float cv = __ldg(a0 + p * a0_stride + t);
        const float g = __ldg(da0 + p * da_stride + t) * (cv > 0.0f ? 1.0f : 0.0f) * inv_c;
        acc1 = fmaf(g, ld(f2 + (p + static_cast<long long>(dy) * W + dx) * C + c), acc1);
      }
      if (h - dy >= 0 && h - dy < H && w - dx >= 0 && w - dx < W) {
        const long long q = p - static_cast<long long>(dy) * W - dx;
        const float cv = __ldg(a0 + q * a0_stride + t);
        const float g = __ldg(da0 + q * da_stride + t) * (cv > 0.0f ? 1.0f : 0.0f) * inv_c;
        acc2 = fmaf(g, ld(f1 + q * C + c), acc2);
      }
    }
    store_any(df1, d_bf16, i, acc1);
    store_any(df2, d_bf16, i, acc2);
  }
  const int Ct = Cf + Cu;
  for (long long i = start; i < pixels * Ct; i += step) {
    const int ch = static_cast<int>(i % Ct);
    const long long p = i / Ct;
    const float v = __ldg(da0 + p * da_stride + D + ch);
    if (ch < Cf) {
      store_any(dfeat, dfeat_bf16, p * Cf + ch, v);
    } else {
      dflow[p * Cu + ch - Cf] = v;
    }
  }
}

int grid_for(long long work) {
  const long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

extern "C" {

// The input cotangent of one layer. dy: float32 cotangent from the layer
// above or null; g (g_bf16): tap cotangent or null; a (a_bf16): the
// layer's output, read when relu; all (B, Ho, Wo, cout). w: (k, k, cin,
// cout) float32. dx (B, H, W, dx_stride), channels [0, cin) written, in
// bf16 when dx_bf16. Returns a cudaError_t (InvalidValue when no channel
// slice of the weights fits shared memory).
int davo_conv_dgrad(const float* dy, const void* g, int g_bf16, const void* a, int a_bf16, int relu,
                    const float* w, void* dx, int dx_bf16, int dx_stride, int B, int H, int W,
                    int cin, int Ho, int Wo, int cout, int k, int stride, int pad_t, int pad_l,
                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cout <= 0 || k <= 0 || dx_stride < cin ||
      (stride != 1 && stride != 2) || (dy == nullptr && g == nullptr) || (relu && a == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int ci = 16;  // the narrowest power of two >= cin, at most 16, whose weights fit
  while (ci > 1 && ci / 2 >= cin) ci /= 2;
  while (ci > 1 && static_cast<size_t>(k) * k * cout * ci * 4 > kMaxSmem) ci /= 2;
  if (static_cast<size_t>(k) * k * cout * ci * 4 > kMaxSmem) return cudaErrorInvalidValue;
  const Cotangent dz{dy, g, g_bf16, a, a_bf16, relu};
  auto s = static_cast<cudaStream_t>(stream);
#define DAVO_DGRAD(N)                                                                        \
  case N:                                                                                    \
    return launch_dgrad<N>(dz, w, dx, dx_bf16, dx_stride, B, H, W, cin, Ho, Wo, cout, k,     \
                           stride, pad_t, pad_l, s);
  switch (ci) {
    DAVO_DGRAD(16)
    DAVO_DGRAD(8)
    DAVO_DGRAD(4)
    DAVO_DGRAD(2)
    DAVO_DGRAD(1)
    default:
      break;
  }
#undef DAVO_DGRAD
  return cudaErrorInvalidValue;
}

// dW and db of one layer: out (K + 1, cout) float32 with K = k*k*cin,
// rows [0, K) dW in (k, k, cin) order and row K db. x (x_bf16): the
// layer's input (B, H, W, x_stride), first cin channels. dz as for
// davo_conv_dgrad. partial: scratch of chunks * (K + 1) * cout floats;
// chunk: pixels per chunk, chunks = ceil(B*Ho*Wo / chunk).
int davo_conv_wgrad(const void* x, int x_bf16, int x_stride, const float* dy, const void* g,
                    int g_bf16, const void* a, int a_bf16, int relu, float* partial, int chunks,
                    int chunk, float* out, int B, int H, int W, int cin, int Ho, int Wo,
                    int cout, int k, int stride, int pad_t, int pad_l, void* stream) {
  const long long pixels = static_cast<long long>(B) * Ho * Wo;
  if (pixels <= 0 || pixels > INT_MAX - kStage || cin <= 0 || cout <= 0 || k <= 0 || x_stride < cin ||
      chunk <= 0 ||
      chunks != (pixels + chunk - 1) / chunk || chunks > 65535 || (dy == nullptr && g == nullptr) ||
      (relu && a == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int K = k * k * cin;
  const Cotangent dz{dy, g, g_bf16, a, a_bf16, relu};
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cout + kTile - 1) / kTile, (K + 1 + kTile - 1) / kTile, chunks);
  conv_wgrad_partial_kernel<<<grid, 256, 0, s>>>(x, x_bf16, x_stride, dz, partial, H, W, cin, Ho, Wo,
                                                 cout, k, stride, pad_t, pad_l, static_cast<int>(pixels),
                                                 chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(K + 1) * cout;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, chunks, n, out);
  return cudaGetLastError();
}

// The backward of davo_flow_level_input. f1, f2 (in_bf16): (B, H, W, C);
// da0: (B, H, W, da_stride) float32; a0: (B, H, W, a0_stride) float32.
// Writes df1, df2 (B, H, W, C) in f1's dtype, dfeat (B, H, W, Cf) in bf16
// when dfeat_bf16, dflow (B, H, W, Cu) float32.
int davo_flow_level_input_bwd(const float* da0, int da_stride, const float* a0, int a0_stride,
                              const void* f1, const void* f2, int in_bf16, void* df1, void* df2,
                              void* dfeat, int dfeat_bf16, float* dflow, int B, int H, int W,
                              int C, int Cf, int Cu, int search, void* stream) {
  const long long pixels = static_cast<long long>(B) * H * W;
  const int D = (2 * search + 1) * (2 * search + 1);
  if (pixels <= 0 || C <= 0 || search < 0 || a0_stride < D || da_stride < D + Cf + Cu) {
    return cudaErrorInvalidValue;
  }
  const long long work = pixels * (C > Cf + Cu ? C : Cf + Cu);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    flow_level_input_bwd_kernel<__nv_bfloat16><<<grid_for(work), 256, 0, s>>>(
        da0, da_stride, a0, a0_stride, static_cast<const __nv_bfloat16*>(f1),
        static_cast<const __nv_bfloat16*>(f2), df1, df2, 1, dfeat, dfeat_bf16, dflow, H, W, C, Cf,
        Cu, search, pixels);
  } else {
    flow_level_input_bwd_kernel<float><<<grid_for(work), 256, 0, s>>>(
        da0, da_stride, a0, a0_stride, static_cast<const float*>(f1), static_cast<const float*>(f2),
        df1, df2, 0, dfeat, dfeat_bf16, dflow, H, W, C, Cf, Cu, search, pixels);
  }
  return cudaGetLastError();
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
