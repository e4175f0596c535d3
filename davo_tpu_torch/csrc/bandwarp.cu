// Banded bilinear warp for Hopper (sm_90a), float32: forward and backward.
//
// For each output pixel (x, y) with sample coordinates (u, v):
//   uc = clip(clip(u - x, -rh, rh) + x, 0, W-1)    (band, then frame)
//   vc = clip(clip(v - y, -rv, rv) + y, 0, H-1)
//   out[y, x, c] = sum over the taps (xt, yt) of the floor cell of (uc, vc)
//                  of hat(vc - yt) * hat(uc - xt) * img[yt, xt, c]
// with hat(t) = max(0, 1 - |t|); a tap past the last row or column
// (uc == W-1 or vc == H-1 exactly) has weight 0 and is not read.
// NHWC image (B, H, W, C), coordinates (B, H, W, 2) as (u, v).
//
// Replaces the TPU kernels davo_tpu/kernels/bandwarp.py::_core_fwd
// (_fwd_kernel) and ::_core_bwd (_bwd_kernel). The TPU kernel sums the
// whole (2rv+2) x (2rh+2) band of shifted planes because a gather is
// slow there; the hat weights leave exactly two nonzero taps per axis,
// so here each pixel reads only the four taps of its floor cell: the
// same function, and the same sums in the same order (ox outer, oy
// inner), so the kernel agrees with the plain version to fma rounding.
//
// Backward, one thread per output pixel: d/du and d/dv contract the
// cotangent over channels against the four taps, with the floor-cell
// subgradient of hat (t in [0, 1) -> -1, t in [-1, 0) -> +1), times
//   mask_u = |u - x| <= rh  and  0 <= ucp < W-1   (ucp = band-clamped u)
// and the same for v (band bound inclusive, low frame edge inclusive,
// high edge exclusive), as _bwd_kernel does. d/dimg, when asked for, is
// the transpose written as a GATHER: each source pixel visits the
// (2rh+2) x (2rv+2) output pixels whose floor cell can contain it, in the
// TPU kernel's order, and sums their weighted cotangents. No atomics, so
// the result is deterministic and equals the plain version's sum order.
//
// Bound on this card: memory. The forward reads 8 B of coordinates and
// 4C B of image per pixel and writes 4C B; the taps of neighbouring
// pixels overlap and come from L1/L2. The d/dimg gather re-reads the
// coordinates of its window (340 pixels at band (4, 16)) through L1,
// which the byte bound does not count; it runs only for the geometry
// term's C=1 warps.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float hat(float t) { return fmaxf(0.0f, 1.0f - fabsf(t)); }

__device__ __forceinline__ float dhat(float t) {
  return (t >= 0.0f && t < 1.0f) ? -1.0f : ((t >= -1.0f && t < 0.0f) ? 1.0f : 0.0f);
}

// Displacement clamped into [-r, r] around the pixel: jnp.clip(u - x, -r, r) + x.
__device__ __forceinline__ float band(float u, float x, float r) {
  return fminf(fmaxf(u - x, -r), r) + x;
}

__device__ __forceinline__ float frame(float u, float hi) { return fminf(fmaxf(u, 0.0f), hi); }

long long grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return want < (1LL << 20) ? want : (1LL << 20);
}

__global__ void __launch_bounds__(kThreads)
banded_warp_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                       float* __restrict__ out, int H, int W, int C, float rv, float rh,
                       long long pixels) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pixels;
       p += stride) {
    const int x = static_cast<int>(p % W);
    const long long q = p / W;  // b*H + y
    const int y = static_cast<int>(q % H);
    const float uc = frame(band(coords[2 * p], static_cast<float>(x), rh), W - 1.0f);
    const float vc = frame(band(coords[2 * p + 1], static_cast<float>(y), rv), H - 1.0f);
    const int x0 = static_cast<int>(floorf(uc));
    const int y0 = static_cast<int>(floorf(vc));
    const float wu0 = hat(uc - static_cast<float>(x0));
    const float wu1 = hat(uc - static_cast<float>(x0 + 1));
    const float wv0 = hat(vc - static_cast<float>(y0));
    const float wv1 = hat(vc - static_cast<float>(y0 + 1));
    const bool x1 = x0 + 1 < W, y1 = y0 + 1 < H;
    const float* t00 = img + ((q - y + y0) * W + x0) * C;
    const float* t01 = t00 + static_cast<long long>(W) * C;  // (y0+1, x0)
    float* o = out + p * C;
    for (int c = 0; c < C; ++c) {
      float acc = (wv0 * wu0) * __ldg(t00 + c);
      if (y1) acc += (wv1 * wu0) * __ldg(t01 + c);
      if (x1) acc += (wv0 * wu1) * __ldg(t00 + C + c);
      if (x1 && y1) acc += (wv1 * wu1) * __ldg(t01 + C + c);
      o[c] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
banded_warp_bwd_coords_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                              const float* __restrict__ g, float* __restrict__ dcoords, int H,
                              int W, int C, float rv, float rh, long long pixels) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; p < pixels;
       p += stride) {
    const int x = static_cast<int>(p % W);
    const long long q = p / W;
    const int y = static_cast<int>(q % H);
    const float fx = static_cast<float>(x), fy = static_cast<float>(y);
    const float u = coords[2 * p], v = coords[2 * p + 1];
    const float ucp = band(u, fx, rh), vcp = band(v, fy, rv);
    const float uc = frame(ucp, W - 1.0f), vc = frame(vcp, H - 1.0f);
    const float mask_u = (fabsf(u - fx) <= rh && ucp >= 0.0f && ucp < W - 1.0f) ? 1.0f : 0.0f;
    const float mask_v = (fabsf(v - fy) <= rv && vcp >= 0.0f && vcp < H - 1.0f) ? 1.0f : 0.0f;
    const int x0 = static_cast<int>(floorf(uc));
    const int y0 = static_cast<int>(floorf(vc));
    const float tu0 = uc - static_cast<float>(x0), tu1 = uc - static_cast<float>(x0 + 1);
    const float tv0 = vc - static_cast<float>(y0), tv1 = vc - static_cast<float>(y0 + 1);
    const float wu0 = hat(tu0), wu1 = hat(tu1), wv0 = hat(tv0), wv1 = hat(tv1);
    const float dwu0 = dhat(tu0), dwu1 = dhat(tu1), dwv0 = dhat(tv0), dwv1 = dhat(tv1);
    const bool x1 = x0 + 1 < W, y1 = y0 + 1 < H;
    const float* t00 = img + ((q - y + y0) * W + x0) * C;
    const float* t01 = t00 + static_cast<long long>(W) * C;
    const float* gp = g + p * C;
    // Channel-contracted cotangent against each tap (0 past the frame).
    float gc00 = 0.0f, gc01 = 0.0f, gc10 = 0.0f, gc11 = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float gv = __ldg(gp + c);
      gc00 += gv * __ldg(t00 + c);
      if (y1) gc01 += gv * __ldg(t01 + c);
      if (x1) gc10 += gv * __ldg(t00 + C + c);
      if (x1 && y1) gc11 += gv * __ldg(t01 + C + c);
    }
    // Taps in the TPU kernel's order: ox outer, oy inner.
    float du = (dwu0 * wv0) * gc00;
    du += (dwu0 * wv1) * gc01;
    du += (dwu1 * wv0) * gc10;
    du += (dwu1 * wv1) * gc11;
    float dv = (wu0 * dwv0) * gc00;
    dv += (wu0 * dwv1) * gc01;
    dv += (wu1 * dwv0) * gc10;
    dv += (wu1 * dwv1) * gc11;
    dcoords[2 * p] = du * mask_u;
    dcoords[2 * p + 1] = dv * mask_v;
  }
}

// One thread per (source pixel, channel) of d/dimg.
__global__ void __launch_bounds__(kThreads)
banded_warp_bwd_img_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                           float* __restrict__ dimg, int H, int W, int C, int rv, int rh,
                           long long elements) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float frv = static_cast<float>(rv), frh = static_cast<float>(rh);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < elements;
       i += stride) {
    const int c = static_cast<int>(i % C);
    const long long qp = i / C;  // source pixel
    const int xq = static_cast<int>(qp % W);
    const long long row = qp / W;  // b*H + yq
    const int yq = static_cast<int>(row % H);
    const long long base = row - yq;  // b*H
    const float fxq = static_cast<float>(xq), fyq = static_cast<float>(yq);
    float acc = 0.0f;
    for (int ox = -rh; ox <= rh + 1; ++ox) {
      const int xp = xq - ox;
      if (xp < 0 || xp >= W) continue;
      for (int oy = -rv; oy <= rv + 1; ++oy) {
        const int yp = yq - oy;
        if (yp < 0 || yp >= H) continue;
        const long long p = (base + yp) * W + xp;
        const float uc = frame(band(__ldg(coords + 2 * p), static_cast<float>(xp), frh), W - 1.0f);
        const float wu = hat(uc - fxq);
        if (wu == 0.0f) continue;
        const float vc =
            frame(band(__ldg(coords + 2 * p + 1), static_cast<float>(yp), frv), H - 1.0f);
        const float wv = hat(vc - fyq);
        if (wv == 0.0f) continue;
        acc += (wv * wu) * __ldg(g + p * C + c);
      }
    }
    dimg[i] = acc;
  }
}

bool bad_sizes(int B, int H, int W, int C, int rv, int rh) {
  return B < 0 || H < 1 || W < 1 || C < 1 || rv < 0 || rh < 0 ||
         static_cast<long long>(B) * H * W * (C > 2 ? C : 2) > LLONG_MAX / 8;
}

}  // namespace

extern "C" {

// img: (B, H, W, C) float32; coords: (B, H, W, 2) float32 (u, v); out:
// (B, H, W, C) float32; all contiguous on the current device. Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take.
int davo_banded_warp_f32(const void* img, const void* coords, void* out, int B, int H, int W,
                         int C, int rv, int rh, void* stream) {
  if (bad_sizes(B, H, W, C, rv, rh)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(B) * H * W;
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  banded_warp_fwd_kernel<<<static_cast<int>(grid_for(pixels)), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords),
      static_cast<float*>(out), H, W, C, static_cast<float>(rv), static_cast<float>(rh), pixels);
  return static_cast<int>(cudaGetLastError());
}

// g: (B, H, W, C) cotangent of out; dcoords: (B, H, W, 2); dimg:
// (B, H, W, C) or null when the image needs no gradient. Same contract.
int davo_banded_warp_bwd_f32(const void* img, const void* coords, const void* g, void* dcoords,
                             void* dimg, int B, int H, int W, int C, int rv, int rh,
                             void* stream) {
  if (bad_sizes(B, H, W, C, rv, rh)) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(B) * H * W;
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  banded_warp_bwd_coords_kernel<<<static_cast<int>(grid_for(pixels)), kThreads, 0, s>>>(
      static_cast<const float*>(img), static_cast<const float*>(coords),
      static_cast<const float*>(g), static_cast<float*>(dcoords), H, W, C,
      static_cast<float>(rv), static_cast<float>(rh), pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dimg == nullptr) return static_cast<int>(err);
  banded_warp_bwd_img_kernel<<<static_cast<int>(grid_for(pixels * C)), kThreads, 0, s>>>(
      static_cast<const float*>(coords), static_cast<const float*>(g),
      static_cast<float*>(dimg), H, W, C, rv, rh, pixels * C);
  return static_cast<int>(cudaGetLastError());
}

const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
