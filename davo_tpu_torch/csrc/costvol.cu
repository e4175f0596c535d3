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
// (terms whose shifted pixel leaves the frame drop out). Bound on this
// card: memory, 4*(4C+D) bytes per pixel read or written once. What held
// the first design (one thread per (pixel, channel), walking the D
// shifts through L1/L2) 17-31x above that bound: each pixel moved D*C*4
// bytes of the other map, and D cotangents, through the cache.
// Design: shared-memory tiles. A block owns an 8x16 tile of pixels, a
// 32-channel slice and one of the two gradients. It stages once, by
// asynchronous copies (cp.async: every load of the block in flight at
// once), the other map's window (the tile grown by `search` on every
// side, that slice, 16 bytes a lane when C % 4 == 0; 0 outside the frame
// or past C) and the tile's cotangents: for d f1 g[p, :], one contiguous
// run per tile row; for d f2 the |tile| x D values g[q - delta_k, k],
// one warp per (tile row, shift row), whose sources lie on one image
// row, read as runs of 2s+1 contiguous floats. Then each thread keeps
// 4 pixels x 4 channels in registers over the D shifts and reads shared
// memory only: per shift row it streams the 4 + 2s window pixels of its
// row once (float4 over its channels) and each cotangent once (a
// broadcast over the 8 lanes of a pixel). The staging, not this
// arithmetic, takes most of the kernel's time (PERF.md).
// Per output the sum runs in the first design's order (dy outer, dx
// inner, fmaf, times 1/C last), so it stays within 1e-5 of the plain
// version. One launch serves both gradients (the block index selects).
// Shared memory, 4*((8+2s)(16+2s)*32 + 128*D) bytes: 90.6 KB at s=4
// (two blocks per SM), more than a block may have beyond s=7.

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

// Backward tiles: kBwdTileH x kBwdTileW pixels (one row per warp, four
// groups of kBwdPix pixels per row), kBwdSlice channels (8 lanes x 4).
constexpr int kBwdTileH = 8, kBwdTileW = 16, kBwdSlice = 32, kBwdPix = 4;
constexpr int kBwdThreads = 32 * kBwdTileH;
static_assert(kBwdTileW == 4 * kBwdPix && kBwdSlice == 8 * 4, "lane layout");

__host__ __device__ constexpr long long bwd_smem_floats(int search) {
  return static_cast<long long>(kBwdTileH + 2 * search) * (kBwdTileW + 2 * search) * kBwdSlice +
         static_cast<long long>(kBwdTileH) * kBwdTileW * (2 * search + 1) * (2 * search + 1);
}

// acc[i][.] += sum over the shifts of gs[pixel i, k] * the window at
// pixel i shifted by +delta_k (d f1) or -delta_k (d f2), dy outer and dx
// inner per output. `ms` points at the window pixel of the group's first
// output pixel (its row, unshifted) and this thread's 4 channels, `gs` at
// the group's first cotangent row.
template <bool kDf1, int kS>
__device__ __forceinline__ void accumulate_shifts(float (&acc)[kBwdPix][4], const float* ms,
                                                  const float* gs, int s_rt) {
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, D = d * d, ww = kBwdTileW + 2 * s;
  const int span = kBwdPix + 2 * s;  // window pixels one row of shifts reaches
#pragma unroll
  for (int dy = 0; dy < d; ++dy) {
    // d f1 reads window row ly + dy; d f2 row ly + 2s - dy.
    const int wrow = kDf1 ? dy : 2 * s - dy;
    const float4* mrow = reinterpret_cast<const float4*>(ms + wrow * ww * kBwdSlice);
    const float* grow = gs + dy * d;
#pragma unroll
    for (int jj = 0; jj < span; ++jj) {
      // Output pixel i meets window pixel j at dx = j - i (d f1) or
      // dx = i + 2s - j (d f2); j runs so that dx rises for every i.
      const int j = kDf1 ? jj : span - 1 - jj;
      const float4 m = mrow[j * (kBwdSlice / 4)];
#pragma unroll
      for (int i = 0; i < kBwdPix; ++i) {
        const int dx = kDf1 ? j - i : i + 2 * s - j;
        if (dx >= 0 && dx < d) {
          const float gk = grow[i * D + dx];
          acc[i][0] = fmaf(gk, m.x, acc[i][0]);
          acc[i][1] = fmaf(gk, m.y, acc[i][1]);
          acc[i][2] = fmaf(gk, m.z, acc[i][2]);
          acc[i][3] = fmaf(gk, m.w, acc[i][3]);
        }
      }
    }
  }
}

// 4-byte asynchronous copy global -> shared (cp.async, no registers held
// while it is in flight); `valid` false writes 0 and reads nothing.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// The same for 16 bytes (L2 only); both addresses 16-byte aligned.
__device__ __forceinline__ void copy_async16(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One block per (image, tile, gradient, channel slice), grid-stride.
// kS is the search radius when known at compile time, else -1.
template <int kS>
__global__ void __launch_bounds__(kBwdThreads, 2)
cost_volume_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       const float* __restrict__ g, float* __restrict__ df1,
                       float* __restrict__ df2, int H, int W, int C, int s_rt, int tiles_x,
                       int tiles_y, int slices, int first_grad, int grads, bool vec,
                       long long blocks) {
  extern __shared__ float4 smem4[];
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, D = d * d;
  const int ww = kBwdTileW + 2 * s, wh = kBwdTileH + 2 * s;
  float* ms = reinterpret_cast<float*>(smem4);  // window: (wh*ww) x kBwdSlice
  float* gs = ms + wh * ww * kBwdSlice;          // cotangents: (tile pixels) x D
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_c = 1.0f / static_cast<float>(C);
  for (long long t = blockIdx.x; t < blocks; t += gridDim.x) {
    long long r = t;
    const int c0 = static_cast<int>(r % slices) * kBwdSlice;
    r /= slices;
    const bool is_df1 = first_grad + static_cast<int>(r % grads) == 0;
    r /= grads;
    const int x0 = static_cast<int>(r % tiles_x) * kBwdTileW;
    r /= tiles_x;
    const int y0 = static_cast<int>(r % tiles_y) * kBwdTileH;
    const long long row0 = (r / tiles_y) * H;  // b*H
    const float* other = is_df1 ? f2 : f1;
    float* out = is_df1 ? df1 : df2;

    __syncthreads();  // the previous block's reads of shared memory are done
    // Staging, all through cp.async so that every load of the block is in
    // flight at once. The other map's window, lanes over the slice's
    // channels: 16 bytes a lane, four window pixels a warp, when C % 4 == 0
    // (`vec`), else 4 bytes a lane, one pixel a warp.
    if (vec) {
      const int c = c0 + 4 * (lane & 7);
      for (int wp = (lane >> 3) + 4 * warp; wp < wh * ww; wp += 4 * kBwdTileH) {
        const int wy = wp / ww, wx = wp - (wp / ww) * ww;
        const int y = y0 - s + wy, x = x0 - s + wx;
        const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
        copy_async16(ms + wp * kBwdSlice + 4 * (lane & 7),
                     in ? other + ((row0 + y) * W + x) * C + c : other, in);
      }
    } else {
      for (int wp = warp; wp < wh * ww; wp += kBwdTileH) {
        const int wy = wp / ww, wx = wp - (wp / ww) * ww;
        const int y = y0 - s + wy, x = x0 - s + wx, c = c0 + lane;
        const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
        const float* src = in ? other + ((row0 + y) * W + x) * C + c : other;
        copy_async(ms + wp * kBwdSlice + lane, src, in);
      }
    }
    if (is_df1) {
      // g[p, :] of the tile's pixels: one warp per tile row, whose
      // cotangents are one contiguous run (16 bytes a lane when the run
      // starts 16-byte aligned, as it does for W % 4 == 0).
      for (int ty = warp; ty < kBwdTileH; ty += kBwdTileH) {
        const int y = y0 + ty, tw = min(kBwdTileW, W - x0);
        float* dst = gs + ty * kBwdTileW * D;
        if (y >= H) {
          for (int e = lane; e < kBwdTileW * D; e += 32) dst[e] = 0.0f;
          continue;
        }
        const float* src = g + ((row0 + y) * W + x0) * D;
        const int n = tw * D;  // floats of the run
        int e0 = 0;
        if (reinterpret_cast<unsigned long long>(src) % 16 == 0) {
          e0 = n / 4 * 4;
          for (int e = 4 * lane; e < e0; e += 128) copy_async16(dst + e, src + e, true);
        }
        for (int e = e0 + lane; e < n; e += 32) copy_async(dst + e, src + e, true);
        for (int e = n + lane; e < kBwdTileW * D; e += 32) dst[e] = 0.0f;  // past the frame
      }
    } else {
      // g[q - delta_k, k] for the tile's q. For a tile row qy and a shift
      // row dy the sources lie on one image row (y0 + qy + s - dy): one
      // warp per (qy, dy), lanes over (window column, dx), dx fastest, so
      // that a warp reads runs of d contiguous cotangents; each (q, k) of
      // the tile is written once, 0 where its source leaves the frame.
      for (int pair = warp; pair < kBwdTileH * d; pair += kBwdTileH) {
        const int qy = pair / d, dy = pair - (pair / d) * d;
        const int y = y0 + qy + s - dy;
        const bool row_in = y >= 0 && y < H && y0 + qy < H;
        for (int e = lane; e < ww * d; e += 32) {
          const int wx = e / d, dx = e - (e / d) * d;
          const int qx = wx - 2 * s + dx;
          if (qx < 0 || qx >= kBwdTileW) continue;
          const int x = x0 - s + wx;
          const bool in = row_in && x >= 0 && x < W;
          copy_async(gs + (qy * kBwdTileW + qx) * D + dy * d + dx,
                     in ? g + ((row0 + y) * W + x) * D + dy * d + dx : g, in);
        }
      }
    }
    copy_async_wait();
    __syncthreads();

    // Thread: tile row `warp`, pixels 4*grp .. 4*grp+3, channels
    // c0 + 4*c4 .. +3.
    const int c4 = lane & 7, grp = lane >> 3;
    const int lx0 = grp * kBwdPix;
    const float* mbase = ms + (warp * ww + lx0) * kBwdSlice + 4 * c4;
    const float* gbase = gs + (warp * kBwdTileW + lx0) * D;
    float acc[kBwdPix][4] = {};
    if (is_df1) {
      accumulate_shifts<true, kS>(acc, mbase, gbase, s);
    } else {
      accumulate_shifts<false, kS>(acc, mbase, gbase, s);
    }
    const int y = y0 + warp, c = c0 + 4 * c4;
    if (y < H && c < C) {
#pragma unroll
      for (int i = 0; i < kBwdPix; ++i) {
        const int x = x0 + lx0 + i;
        if (x >= W) break;
        float* o = out + ((row0 + y) * W + x) * C + c;
        if (vec) {
          *reinterpret_cast<float4*>(o) = make_float4(acc[i][0] * inv_c, acc[i][1] * inv_c,
                                                      acc[i][2] * inv_c, acc[i][3] * inv_c);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c + q < C) o[q] = acc[i][q] * inv_c;
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Raises the kernel's dynamic shared-memory limit once per device (not
// while a CUDA graph captures the launch: the first call is eager).
template <int kS>
cudaError_t launch_bwd(const float* f1, const float* f2, const float* g, float* df1, float* df2,
                       int H, int W, int C, int search, int tiles_x, int tiles_y, int slices,
                       int first_grad, int grads, bool vec, long long blocks,
                       int device, int smem, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  if (granted[device] < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        cost_volume_bwd_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    granted[device] = smem;
  }
  const int grid = static_cast<int>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  cost_volume_bwd_kernel<kS><<<grid, kBwdThreads, smem, stream>>>(
      f1, f2, g, df1, df2, H, W, C, search, tiles_x, tiles_y, slices, first_grad, grads, vec,
      blocks);
  return cudaGetLastError();
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
// gradient. One launch computes the requested maps on `stream`; same
// return contract as davo_cost_volume_f32 (cudaErrorInvalidValue also
// for a search whose tiles do not fit a block's shared memory, s > 7).
int davo_cost_volume_bwd_f32(const void* f1, const void* f2, const void* g, void* df1,
                             void* df2, int B, int H, int W, int C, int search, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 1 || search < 0 || search > 64 ||
      static_cast<long long>(B) * H * W > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_max[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem_max[device] == 0) {
    err = cudaDeviceGetAttribute(&smem_max[device], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long smem = static_cast<long long>(sizeof(float)) * bwd_smem_floats(search);
  if (smem > smem_max[device]) return static_cast<int>(cudaErrorInvalidValue);
  const int grads = (df1 != nullptr) + (df2 != nullptr);
  if (static_cast<long long>(B) * H * W == 0 || grads == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles_x = (W + kBwdTileW - 1) / kBwdTileW;
  const int tiles_y = (H + kBwdTileH - 1) / kBwdTileH;
  const int slices = (C + kBwdSlice - 1) / kBwdSlice;
  const long long blocks = static_cast<long long>(B) * tiles_y * tiles_x * grads * slices;
  const int first_grad = df1 != nullptr ? 0 : 1;
  // 16-byte window loads and output stores need C % 4 == 0 and aligned maps.
  const auto aligned = [](const void* ptr) {
    return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  };
  const bool vec = C % 4 == 0 && aligned(f1) && aligned(f2) && aligned(df1) && aligned(df2);
  const float* a = static_cast<const float*>(f1);
  const float* b = static_cast<const float*>(f2);
  const float* gp = static_cast<const float*>(g);
  float* o1 = static_cast<float*>(df1);
  float* o2 = static_cast<float*>(df2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (search) {
    case 2:
      err = launch_bwd<2>(a, b, gp, o1, o2, H, W, C, search, tiles_x, tiles_y, slices, first_grad,
                          grads, vec, blocks, device, static_cast<int>(smem), s);
      break;
    case 3:
      err = launch_bwd<3>(a, b, gp, o1, o2, H, W, C, search, tiles_x, tiles_y, slices, first_grad,
                          grads, vec, blocks, device, static_cast<int>(smem), s);
      break;
    case 4:
      err = launch_bwd<4>(a, b, gp, o1, o2, H, W, C, search, tiles_x, tiles_y, slices, first_grad,
                          grads, vec, blocks, device, static_cast<int>(smem), s);
      break;
    default:
      err = launch_bwd<-1>(a, b, gp, o1, o2, H, W, C, search, tiles_x, tiles_y, slices,
                           first_grad, grads, vec, blocks, device, static_cast<int>(smem), s);
  }
  return static_cast<int>(err);
}

const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
