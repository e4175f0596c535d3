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
// Backward: d/du and d/dv, one thread per output pixel, contract the
// cotangent over channels against the four taps, with the floor-cell
// subgradient of hat (t in [0, 1) -> -1, t in [-1, 0) -> +1), times
//   mask_u = |u - x| <= rh  and  0 <= ucp < W-1   (ucp = band-clamped u)
// and the same for v (band bound inclusive, low frame edge inclusive,
// high edge exclusive), as _bwd_kernel does.
//
// d/dimg, when asked for, is the transpose: each output pixel's weighted
// cotangent goes to the four taps of its floor cell. The first design
// wrote it as a gather, one thread per (source pixel, channel) visiting
// the whole (2rh+2) x (2rv+2) window of output pixels that could reach it
// (340 at band (4, 16)), re-reading each one's coordinates through L1
// and recomputing its clamps: O(window) work per source element, 10x
// slower than grid_sample's backward at C=1. Now it is a tile-local
// scatter, as _bwd_kernel accumulates into its padded `dpad` plane: a
// block owns a 64x16 source tile (channels in chunks of 4) with its
// accumulator in shared memory. An output pixel's band-clamped floor
// cell lies in columns [x-rh, x+rh+1] and rows [y-rv, y+rv+1], so only
// the output pixels of the tile grown by rh+1 columns on the left, rh
// on the right, rv+1 rows above and rv below reach it (97x25 at band
// (4, 16)). The block stages that halo's coordinates and cotangents in
// shared memory with cp.async (every load in flight at once), then
// visits each halo pixel once: its cell and four weights computed
// exactly as in the forward, and the taps that fall inside the tile
// added to the accumulator (a tap past the last row or column is neither
// read nor added). The tile is then written once, coalesced: no global
// atomics, no second pass.
//
// The adds are integer atomics on a fixed-point accumulator. The card has
// no native shared-memory float add: atomicAdd on a float is a compare-
// and-swap loop, and where many pixels clamp to one frame edge it
// serialises (PERF.md compares the two on phase 3c's edge frames).
// Integer adds are native and associative, so the sum is also exact and
// bitwise reproducible. Each term w*g is scaled by a power of two chosen
// from the block's largest |g| and halo size, rounded to a 64-bit integer
// (relative precision 2^-38 of that |g| at band (4, 16)) and added as a
// signed high word and an unsigned low word, sized so that neither sum
// can overflow; the exact total is rounded to float32 once. The result
// differs from the plain version's float32 sums by their rounding only.
// A non-finite cotangent in a tile's halo makes that tile's d/dimg NaN.
// d/du and d/dv stay a separate launch of O(1) work per pixel.
//
// The forward, as redesigned for this card. A block of 8 warps owns a
// tile of 32 columns x 8*PY rows of one image (a 2-D grid: tiles x
// images, 32-bit offsets within an image); lane l of warp w takes column
// l of rows w, w + 8, ... (PY pixels), so every coordinate load is one
// coalesced float2 per lane, and all PY of them are issued before any is
// used. PY is 4 where the grid still gives every SM four blocks (B=64 at
// 128x416: 3,328 blocks), else 2 or 1 (the B=4 step's levels). The taps
// are __ldg gathers through L1: a step's flows are smooth, so a warp's
// taps fall on a few neighbouring rows. With C fixed (1, 3) every tap
// load of a thread is issued before its first sum is stored. C=1 stores
// one coalesced float a lane; C <= 16 passes each warp's output row
// through shared memory and leaves as 16-byte stores where the row is
// aligned. (Staging each block's box of floor cells in shared memory by
// cp.async was tried: faster on random per-pixel coordinates, 7 % slower
// over the 16 warps of a B=64 train step on its own coordinates; PERF.md
// §6.)
//
// Bound on this card: memory. The forward must read 8 B of coordinates
// and 4C B of image per pixel and write 4C B (B=64, 128x416: 109 MB for
// C=3, 0.0326 ms at 3.35 TB/s). The d/dimg scatter stages each output
// pixel's 8 + 4C bytes about 2.4 times (the halo; from L2) and runs only
// for the geometry term's C=1 warps on the train step.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace davo;

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

// Forward tiles: kFwdWarps warps, each a 32-pixel row segment in PY rows
// (warp, warp + kFwdWarps, ...), so a tile is 32 columns x kFwdWarps*PY
// rows. Output rows of at most kFwdStageC channels leave through shared
// memory.
constexpr int kFwdWarps = 8;
constexpr int kFwdStageC = 16;

// One pixel's floor cell and hat weights, band- then frame-clamped.
struct Cell {
  int x0, y0;
  float wu0, wu1, wv0, wv1;
};

__device__ __forceinline__ Cell cell_of(float2 uv, int x, int y, int H, int W, float rv, float rh) {
  const float uc = frame(band(uv.x, static_cast<float>(x), rh), W - 1.0f);
  const float vc = frame(band(uv.y, static_cast<float>(y), rv), H - 1.0f);
  Cell c;
  c.x0 = static_cast<int>(floorf(uc));
  c.y0 = static_cast<int>(floorf(vc));
  c.wu0 = hat(uc - static_cast<float>(c.x0));
  c.wu1 = hat(uc - static_cast<float>(c.x0 + 1));
  c.wv0 = hat(vc - static_cast<float>(c.y0));
  c.wv1 = hat(vc - static_cast<float>(c.y0 + 1));
  return c;
}

// The four taps of one channel, in the plain version's order (ox outer,
// oy inner); a tap past the last row or column is not read. t00 points at
// the channel of tap (x0, y0); `row` and `step` are the floats to the next
// row and column.
__device__ __forceinline__ float cell_sum(const float* t00, int row, int step, bool x1, bool y1,
                                          const Cell& k) {
  float s = (k.wv0 * k.wu0) * __ldg(t00);
  if (y1) s += (k.wv1 * k.wu0) * __ldg(t00 + row);
  if (x1) s += (k.wv0 * k.wu1) * __ldg(t00 + step);
  if (x1 && y1) s += (k.wv1 * k.wu1) * __ldg(t00 + row + step);
  return s;
}

// A warp's row segment of `count` floats from shared memory to `seg`:
// 16-byte stores when both allow it, else one float a lane (coalesced).
__device__ __forceinline__ void write_segment(float* seg, const float* src, int count, int lane) {
  if ((reinterpret_cast<uintptr_t>(seg) & 15) == 0 && (count & 3) == 0) {
    for (int i = lane; i < count / 4; i += 32) {
      reinterpret_cast<float4*>(seg)[i] = reinterpret_cast<const float4*>(src)[i];
    }
  } else {
    for (int i = lane; i < count; i += 32) seg[i] = src[i];
  }
}

// img (B, H, W, C), coords (B, H, W, 2), out (B, H, W, C). Block
// (blockIdx.x, blockIdx.y) = (tile, image). KC is C when fixed at compile
// time (every tap load of a thread is then issued before the first sum is
// stored), else 0.
template <int PY, int KC>
__global__ void __launch_bounds__(kFwdWarps * 32)
banded_warp_fwd_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                       float* __restrict__ out, int H, int W, int C, float rv, float rh, int tiles_x) {
  extern __shared__ __align__(16) float obufs[];  // kFwdWarps output rows of 32 pixels
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = blockIdx.x % tiles_x, ty = blockIdx.x / tiles_x;
  const int x = tx * 32 + lane, ybase = ty * (kFwdWarps * PY) + warp;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = img + blockIdx.y * plane * C;
  const float2* co = reinterpret_cast<const float2*>(coords) + blockIdx.y * plane;

  float2 uv[PY];
  bool live[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) {  // every coordinate load in flight before any is used
    const int y = ybase + j * kFwdWarps;
    live[j] = x < W && y < H;
    uv[j] = live[j] ? __ldg(co + y * W + x) : make_float2(0.0f, 0.0f);
  }
  Cell cell[PY];
#pragma unroll
  for (int j = 0; j < PY; ++j) cell[j] = cell_of(uv[j], x, ybase + j * kFwdWarps, H, W, rv, rh);

  float* seg0 = out + (blockIdx.y * plane + static_cast<size_t>(ybase) * W + tx * 32) * C;
  const size_t seg_row = static_cast<size_t>(kFwdWarps) * W * C;
  const int n = min(32, W - tx * 32), row = W * C;
  float* obuf = obufs + warp * 32 * C;
  if constexpr (KC > 0) {
    float acc[PY][KC];
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      const Cell& k = cell[j];
      const float* t = im + (k.y0 * W + k.x0) * KC;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        acc[j][c] = live[j] ? cell_sum(t + c, row, KC, k.x0 + 1 < W, k.y0 + 1 < H, k) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      if (ybase + j * kFwdWarps >= H) break;  // the same for the whole warp
      float* seg = seg0 + j * seg_row;
      if constexpr (KC == 1) {
        if (live[j]) seg[lane] = acc[j][0];
      } else {
        if (live[j]) {
#pragma unroll
          for (int c = 0; c < KC; ++c) obuf[lane * KC + c] = acc[j][c];
        }
        __syncwarp();
        write_segment(seg, obuf, n * KC, lane);
        __syncwarp();
      }
    }
  } else {
    const bool staged_out = C <= kFwdStageC;
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      if (ybase + j * kFwdWarps >= H) break;
      float* seg = seg0 + j * seg_row;
      if (live[j]) {
        const Cell& k = cell[j];
        const float* t = im + (k.y0 * W + k.x0) * C;
        float* o = staged_out ? obuf + lane * C : seg + lane * C;
        for (int c = 0; c < C; ++c) o[c] = cell_sum(t + c, row, C, k.x0 + 1 < W, k.y0 + 1 < H, k);
      }
      if (staged_out) {
        __syncwarp();
        write_segment(seg, obuf, n * C, lane);
        __syncwarp();
      }
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

// d/dimg tiles: kImgTileX x kImgTileY source pixels, channels in chunks
// of kImgChunk. A block's 48 KB of shared memory hold the tile's two
// integer accumulators, one word for the block's largest cotangent, then
// as much of its halo (coordinates and the chunk's cotangent channels) as
// fits: all of it at band (4, 16) for C=1.
constexpr int kImgTileX = 64, kImgTileY = 16, kImgChunk = 4;
constexpr int kImgSmemWords = 12288;

// The bits of the fixed-point terms of a tile whose halo has `halo`
// pixels: each source pixel sums at most `halo` terms, each split into a
// high part (a signed word) and `lo_bits` low bits (an unsigned word),
// and neither word's sum may overflow.
struct FixedPoint {
  int lo_bits, bits;
  __device__ explicit FixedPoint(int halo) {
    const int halo_bits = 32 - __clz(halo);  // halo < 2^halo_bits
    lo_bits = 32 - halo_bits;
    bits = 62 - 2 * halo_bits;  // |term| <= 2^bits, so each sum fits
  }
};

// One block per source tile, grid-stride.
__global__ void __launch_bounds__(kThreads)
banded_warp_bwd_img_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                           float* __restrict__ dimg, int H, int W, int C, int rv, int rh,
                           int tiles_x, int tiles_y, long long tiles) {
  __shared__ int smem[kImgSmemWords];
  const float frv = static_cast<float>(rv), frh = static_cast<float>(rh);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int x0 = static_cast<int>(t % tiles_x) * kImgTileX;
    const long long r = t / tiles_x;
    const int y0 = static_cast<int>(r % tiles_y) * kImgTileY;
    const long long row0 = (r / tiles_y) * H;  // b*H
    const int x1 = min(x0 + kImgTileX, W), y1 = min(y0 + kImgTileY, H);
    // Output pixels whose floor cell can reach the tile, clipped to the frame.
    const int hx0 = max(x0 - rh - 1, 0), hx1 = min(x1 + rh, W);
    const int hy0 = max(y0 - rv - 1, 0), hy1 = min(y1 + rv, H);
    const int hw = hx1 - hx0, halo = hw * (hy1 - hy0);
    const FixedPoint fix(halo);
    for (int c0 = 0; c0 < C; c0 += kImgChunk) {
      const int cc = min(kImgChunk, C - c0);
      const int tile = kImgTileX * kImgTileY * cc;
      int* acc_hi = smem;  // (kImgTileY, kImgTileX, cc) each
      unsigned* acc_lo = reinterpret_cast<unsigned*>(smem + tile);
      int* gmax_bits = smem + 2 * tile;
      const int cap = (kImgSmemWords - 2 * tile - 1) / (2 + cc);
      float* su = reinterpret_cast<float*>(smem + 2 * tile + 1);  // staged halo:
      float* sv = su + cap;  // u, v, then the chunk's cotangent channels,
      float* sg = sv + cap;  // cap pixels each
      __syncthreads();  // the previous chunk is written out
      for (int i = threadIdx.x; i < 2 * tile; i += kThreads) smem[i] = 0;
      if (threadIdx.x == 0) *gmax_bits = 0;
      __syncthreads();
      // The halo's largest |cotangent| sets the fixed-point scale: from the
      // staged halo when it fits at once, else from a pass over it.
      const bool one_part = halo <= cap;
      float gmax = 0.0f;
      if (one_part) {
        for (int i = threadIdx.x; i < halo; i += kThreads) {
          const long long p = (row0 + hy0 + i / hw) * W + hx0 + i % hw;
          copy_async4(su + i, coords + 2 * p);
          copy_async4(sv + i, coords + 2 * p + 1);
          for (int c = 0; c < cc; ++c) copy_async4(sg + c * cap + i, g + p * C + c0 + c);
        }
        copy_async_wait_all();
        __syncthreads();
        for (int i = threadIdx.x; i < halo * cc; i += kThreads) {
          gmax = fmaxf(gmax, fabsf(sg[(i / halo) * cap + i % halo]));
        }
      } else {
        for (int i = threadIdx.x; i < halo; i += kThreads) {
          const long long p = (row0 + hy0 + i / hw) * W + hx0 + i % hw;
          for (int c = 0; c < cc; ++c) gmax = fmaxf(gmax, fabsf(__ldg(g + p * C + c0 + c)));
        }
      }
      for (int o = 16; o > 0; o >>= 1) gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
      if ((threadIdx.x & 31) == 0) atomicMax(gmax_bits, __float_as_int(gmax));  // gmax >= 0
      __syncthreads();
      // A non-finite cotangent has no fixed-point scale: the chunk's
      // outputs are then NaN.
      const bool finite = isfinite(__int_as_float(*gmax_bits));
      int gmax_exp = 0;  // gmax < 2^gmax_exp
      if (finite) frexpf(__int_as_float(*gmax_bits), &gmax_exp);
      const double scale = ldexp(1.0, fix.bits - gmax_exp);
      const long long lo_mask = (1LL << fix.lo_bits) - 1;
      for (int h0 = 0; h0 < halo; h0 += cap) {
        const int n = min(cap, halo - h0);
        if (!one_part) {
          __syncthreads();  // the previous part of the halo is consumed
          for (int i = threadIdx.x; i < n; i += kThreads) {
            const int hi = h0 + i;
            const long long p = (row0 + hy0 + hi / hw) * W + hx0 + hi % hw;
            copy_async4(su + i, coords + 2 * p);
            copy_async4(sv + i, coords + 2 * p + 1);
            for (int c = 0; c < cc; ++c) copy_async4(sg + c * cap + i, g + p * C + c0 + c);
          }
          copy_async_wait_all();
          __syncthreads();
        }
        for (int i = threadIdx.x; i < n; i += kThreads) {
          const int hi = h0 + i;
          const int yp = hy0 + hi / hw, xp = hx0 + hi % hw;
          const float uc = frame(band(su[i], static_cast<float>(xp), frh), W - 1.0f);
          const float vc = frame(band(sv[i], static_cast<float>(yp), frv), H - 1.0f);
          const int xa = static_cast<int>(floorf(uc));
          const int ya = static_cast<int>(floorf(vc));
          // Which taps of the cell lie in the tile (and so in the frame).
          const bool ix0 = xa >= x0 && xa < x1, ix1 = xa + 1 >= x0 && xa + 1 < x1;
          const bool iy0 = ya >= y0 && ya < y1, iy1 = ya + 1 >= y0 && ya + 1 < y1;
          if (!((ix0 || ix1) && (iy0 || iy1))) continue;
          const float wu0 = hat(uc - static_cast<float>(xa));
          const float wu1 = hat(uc - static_cast<float>(xa + 1));
          const float wv0 = hat(vc - static_cast<float>(ya));
          const float wv1 = hat(vc - static_cast<float>(ya + 1));
          const float w[4] = {wv0 * wu0, wv0 * wu1, wv1 * wu0, wv1 * wu1};
          const bool in[4] = {iy0 && ix0, iy0 && ix1, iy1 && ix0, iy1 && ix1};
          const int o00 = ((ya - y0) * kImgTileX + (xa - x0)) * cc;
          const int off[4] = {o00, o00 + cc, o00 + kImgTileX * cc, o00 + (kImgTileX + 1) * cc};
          for (int c = 0; c < cc; ++c) {
            const float gv = sg[c * cap + i];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              // The term (w * g), in fixed point; zero terms add nothing.
              const long long q = __double2ll_rn(static_cast<double>(w[k] * gv) * scale);
              if (!in[k] || q == 0) continue;
              atomicAdd(acc_hi + off[k] + c, static_cast<int>(q >> fix.lo_bits));
              atomicAdd(acc_lo + off[k] + c, static_cast<unsigned>(q & lo_mask));
            }
          }
        }
      }
      __syncthreads();
      // Write the tile's chunk once: consecutive threads, consecutive
      // (pixel, channel) of a tile row.
      const double unscale = ldexp(1.0, gmax_exp - fix.bits);
      const int tw = x1 - x0;
      for (int i = threadIdx.x; i < (y1 - y0) * tw * cc; i += kThreads) {
        const int c = i % cc, pix = i / cc;
        const int ly = pix / tw, lx = pix % tw;
        const int a = (ly * kImgTileX + lx) * cc + c;
        const long long sum = static_cast<long long>(acc_hi[a]) * (1LL << fix.lo_bits) +
                              static_cast<long long>(acc_lo[a]);
        dimg[((row0 + y0 + ly) * W + x0 + lx) * C + c0 + c] =
            finite ? static_cast<float>(static_cast<double>(sum) * unscale) : nanf("");
      }
    }
  }
}

bool bad_sizes(int B, int H, int W, int C, int rv, int rh) {
  return B < 0 || H < 1 || W < 1 || C < 1 || rv < 0 || rh < 0 ||
         static_cast<long long>(B) * H * W * (C > 2 ? C : 2) > LLONG_MAX / 8;
}

template <int PY, int KC>
cudaError_t launch_fwd_tiles(const float* img, const float* coords, float* out, int B, int H, int W,
                             int C, int rv, int rh, cudaStream_t stream) {
  const int rows = kFwdWarps * PY;
  const int tiles_x = (W + 31) / 32, tiles_y = (H + rows - 1) / rows;
  const int out_floats = (KC != 1 && C <= kFwdStageC) ? kFwdWarps * 32 * C : 0;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(B));
  banded_warp_fwd_kernel<PY, KC><<<grid, kFwdWarps * 32, out_floats * sizeof(float), stream>>>(
      img, coords, out, H, W, C, static_cast<float>(rv), static_cast<float>(rh), tiles_x);
  return cudaGetLastError();
}

template <int PY>
cudaError_t launch_fwd_rows(const float* img, const float* coords, float* out, int B, int H, int W,
                            int C, int rv, int rh, cudaStream_t stream) {
  if (C == 1) return launch_fwd_tiles<PY, 1>(img, coords, out, B, H, W, C, rv, rh, stream);
  if (C == 3) return launch_fwd_tiles<PY, 3>(img, coords, out, B, H, W, C, rv, rh, stream);
  return launch_fwd_tiles<PY, 0>(img, coords, out, B, H, W, C, rv, rh, stream);
}

// Rows per warp: the most (4, 2, 1) that still gives every SM four
// blocks or more.
cudaError_t launch_fwd(const void* img, const void* coords, void* out, int B, int H, int W, int C,
                       int rv, int rh, cudaStream_t stream) {
  // One image's offsets are 32-bit; images are the grid's y axis.
  if (bad_sizes(B, H, W, C, rv, rh) || B > 65535 ||
      static_cast<long long>(H) * W * (C > 2 ? C : 2) > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaGetLastError();
  int device = 0, smem = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles_x = (W + 31) / 32;
  int py = 4;
  while (py > 1 && B * tiles_x * ((H + kFwdWarps * py - 1) / (kFwdWarps * py)) < 4LL * sms) py /= 2;
  const auto* i = static_cast<const float*>(img);
  const auto* c = static_cast<const float*>(coords);
  auto* o = static_cast<float*>(out);
  if (py == 4) return launch_fwd_rows<4>(i, c, o, B, H, W, C, rv, rh, stream);
  if (py == 2) return launch_fwd_rows<2>(i, c, o, B, H, W, C, rv, rh, stream);
  return launch_fwd_rows<1>(i, c, o, B, H, W, C, rv, rh, stream);
}

}  // namespace

extern "C" {

// img: (B, H, W, C) float32; coords: (B, H, W, 2) float32 (u, v); out:
// (B, H, W, C) float32; all contiguous on the current device. Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes the kernel does not take (B > 65535,
// or one image of 2^31 floats or more).
int davo_banded_warp_f32(const void* img, const void* coords, void* out, int B, int H, int W,
                         int C, int rv, int rh, void* stream) {
  return static_cast<int>(
      launch_fwd(img, coords, out, B, H, W, C, rv, rh, static_cast<cudaStream_t>(stream)));
}

// g: (B, H, W, C) cotangent of out; dcoords: (B, H, W, 2); dimg:
// (B, H, W, C) or null when the image needs no gradient. Same contract;
// with dimg, a band whose tile halo reaches 2^20 pixels is refused.
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
  // The fixed point keeps 2^-22 of a tile's largest cotangent or better
  // while a tile's halo stays under 2^20 pixels.
  if ((2LL * rh + kImgTileX + 1) * (2LL * rv + kImgTileY + 1) >= (1LL << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (W + kImgTileX - 1) / kImgTileX;
  const int tiles_y = (H + kImgTileY - 1) / kImgTileY;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x;
  const int grid = static_cast<int>(tiles < (1LL << 20) ? tiles : (1LL << 20));
  banded_warp_bwd_img_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(coords), static_cast<const float*>(g),
      static_cast<float*>(dimg), H, W, C, rv, rh, tiles_x, tiles_y, tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
