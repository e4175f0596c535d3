// Correlation cost volume for Hopper (sm_90a), float32.
//
//   out[b, h, w, k] = (1/C) * sum_c f1[b, h, w, c] * f2[b, h+dy_k, w+dx_k, c]
//
// with k = (dy + s) * (2s+1) + (dx + s) over the (2s+1)^2 shifts, and 0
// where the shifted pixel leaves the frame. NHWC in, (B, H, W, D) out.
//
// Replaces the TPU kernels davo_tpu/kernels/costvol.py::cost_volume_pallas
// (_costvol_kernel) and ::cost_volume_pallas_rows (_costvol_rows_kernel;
// the rows layout (B, H*W, C) is the same memory, so one kernel serves
// both). The TPU kernel keeps one whole batch element in VMEM per grid
// step; that does not fit a 227 KB SM and would serialise the batch, so
// this is a different design.
//
// Bound on this card: memory. Each pixel reads 2C floats of input that
// its neighbours share and writes D = 49 or 81 floats, so the output
// dominates the bytes; at C <= 96 the 2*C*D flops per pixel stay under
// the f32 rate's share. Design: one warp per pixel (grid-stride), its
// lanes over the shifts. The warp writes the pixel's D outputs as
// consecutive floats (coalesced), reads the pixel's f1 row once as a
// broadcast, and its lanes read overlapping f2 rows of nearby pixels
// (served by L1). Pixel coordinates are decomposed once per pixel and
// the shift of each lane advances incrementally, so no integer division
// runs per output. The C loop reads 16-byte vectors when C % 4 == 0 and
// both maps are 16-byte aligned, else single floats.
//
// What limits this design: each output re-reads C floats of f2 through
// L1/L2, so a pixel moves D*C*4 bytes through the cache against
// 4*(2C+D) from DRAM, and the kernel runs well above its DRAM bound,
// the more so the larger C (PERF.md). Staging a tile's f2 window in
// shared memory, or keeping several outputs per thread in registers,
// is the next step.
//
// Backward (no TPU kernel: the JAX train step differentiates the XLA
// form, davo_tpu/models/flownet.py::cost_volume). Both gradients are
// gathers over the same shifts, so no atomics:
//   d f1[p, c] = (1/C) sum_k g[p, k] * f2[p + delta_k, c]
//   d f2[q, c] = (1/C) sum_k g[q - delta_k, k] * f1[q - delta_k, c]
// (terms whose shifted pixel leaves the frame drop out). One thread per
// (pixel, channel), channels fastest: a warp reads consecutive channels
// of f1/f2 (coalesced) and the same g[p, k] (a broadcast). Bound on
// this card: memory, 4*(4C+D) bytes per pixel read or written once; the
// D-fold re-reads of the other map come from L1/L2, as in the forward.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C, int search,
                   int pixels) {
  const int d = 2 * search + 1;
  const int D = d * d;
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const float inv_c = 1.0f / static_cast<float>(C);
  // Shift of this lane's first output, and the step for k += 32.
  const int dy0 = lane / d, dx0 = lane % d;
  const int step_dy = 32 / d, step_dx = 32 % d;
  for (int p = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; p < pixels; p += warps) {
    const int w = p % W;
    const int q = p / W;  // b*H + h
    const int h = q % H;
    const float* a = f1 + static_cast<long long>(p) * C;
    float* o = out + static_cast<long long>(p) * D;
    int dy = dy0, dx = dx0;
    for (int k = lane; k < D; k += 32) {
      const int y2 = h + dy - search;
      const int x2 = w + dx - search;
      float acc = 0.0f;
      if (y2 >= 0 && y2 < H && x2 >= 0 && x2 < W) {
        const float* b = f2 + (static_cast<long long>(q - h + y2) * W + x2) * C;
        if (kVec4) {
          const float4* a4 = reinterpret_cast<const float4*>(a);
          const float4* b4 = reinterpret_cast<const float4*>(b);
          for (int c = 0; c < C / 4; ++c) {
            const float4 x = __ldg(a4 + c);
            const float4 y = __ldg(b4 + c);
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
            acc = fmaf(x.z, y.z, acc);
            acc = fmaf(x.w, y.w, acc);
          }
        } else {
          for (int c = 0; c < C; ++c) acc = fmaf(__ldg(a + c), __ldg(b + c), acc);
        }
        acc *= inv_c;
      }
      o[k] = acc;
      dy += step_dy;
      dx += step_dx;
      if (dx >= d) {
        dx -= d;
        ++dy;
      }
    }
  }
}

// kDf1: out = d f1 from (f2, g); else out = d f2 from (f1, g).
template <bool kDf1>
__global__ void __launch_bounds__(kThreads)
cost_volume_bwd_kernel(const float* __restrict__ other, const float* __restrict__ g,
                       float* __restrict__ out, int H, int W, int C, int search,
                       long long elements) {
  const int d = 2 * search + 1;
  const int D = d * d;
  const float inv_c = 1.0f / static_cast<float>(C);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < elements;
       i += stride) {
    const int c = static_cast<int>(i % C);
    const long long p = i / C;
    const int w = static_cast<int>(p % W);
    const long long q = p / W;  // b*H + h
    const int h = static_cast<int>(q % H);
    float acc = 0.0f;
    for (int dy = 0; dy < d; ++dy) {
      // Shifted row: p + delta for d f1, p - delta for d f2.
      const int y2 = kDf1 ? h + dy - search : h - dy + search;
      if (y2 < 0 || y2 >= H) continue;
      const long long row = (q - h + y2) * W;
      for (int dx = 0; dx < d; ++dx) {
        const int x2 = kDf1 ? w + dx - search : w - dx + search;
        if (x2 < 0 || x2 >= W) continue;
        const long long p2 = row + x2;
        const int k = dy * d + dx;
        const float gk = kDf1 ? __ldg(g + p * D + k) : __ldg(g + p2 * D + k);
        acc = fmaf(gk, __ldg(other + p2 * C + c), acc);
      }
    }
    out[i] = acc * inv_c;
  }
}

}  // namespace

extern "C" {

// f1, f2: (B, H, W, C) float32, contiguous, on the current device.
// out: (B, H, W, (2*search+1)^2) float32, contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take.
int davo_cost_volume_f32(const void* f1, const void* f2, void* out, int B,
                         int H, int W, int C, int search, void* stream) {
  const long long pixels = static_cast<long long>(B) * H * W;
  if (B < 0 || H < 0 || W < 0 || C < 1 || search < 0 || pixels > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const int warps_per_block = kThreads / 32;
  const long long want = (pixels + warps_per_block - 1) / warps_per_block;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  const bool vec4 = C % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(f1) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(f2) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  float* o = static_cast<float*>(out);
  const int n = static_cast<int>(pixels);
  if (vec4) {
    cost_volume_kernel<true><<<blocks, kThreads, 0, s>>>(a, b, o, H, W, C, search, n);
  } else {
    cost_volume_kernel<false><<<blocks, kThreads, 0, s>>>(a, b, o, H, W, C, search, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (B, H, W, (2*search+1)^2) cotangent of the forward's output;
// df1, df2: (B, H, W, C) float32 or null for a map that needs no
// gradient. Launches one kernel per requested map on `stream`; same
// return contract as davo_cost_volume_f32.
int davo_cost_volume_bwd_f32(const void* f1, const void* f2, const void* g, void* df1,
                             void* df2, int B, int H, int W, int C, int search, void* stream) {
  const long long elements = static_cast<long long>(B) * H * W * C;
  if (B < 0 || H < 0 || W < 0 || C < 1 || search < 0 ||
      static_cast<long long>(B) * H * W > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (elements == 0) return static_cast<int>(cudaGetLastError());
  const long long want = (elements + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  if (df1 != nullptr) {
    cost_volume_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(f2), gp, static_cast<float*>(df1), H, W, C, search, elements);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (df2 != nullptr) {
    cost_volume_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(f1), gp, static_cast<float*>(df2), H, W, C, search, elements);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
