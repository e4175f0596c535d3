// Correlation cost volume for Hopper (sm_90a): the forward for float32 or
// bfloat16 maps, the backward for float32 maps.
//
//   out[b, h, w, k] = (1/C) * sum_c f1[b, h, w, c] * f2[b, h+dy_k, w+dx_k, c]
//
// with k = (dy + s) * (2s+1) + (dx + s) over the D = (2s+1)^2 shifts, and
// 0 where the shifted pixel leaves the frame. NHWC in, (B, H, W, D)
// float32 out.
//
// Forward. Replaces the TPU kernels davo_tpu/kernels/costvol.py::
// cost_volume_pallas (_costvol_kernel) and ::cost_volume_pallas_rows
// (_costvol_rows_kernel; the rows layout (B, H*W, C) is the same memory,
// so one kernel serves both). As the TPU kernel does, it reads the maps
// in their own dtype and widens them to float32 in registers (exact for
// bf16). The TPU kernel holds a whole batch element in VMEM per grid
// step; a 227 KB SM cannot, so the design is another.
//
// What bounds it on this card: per pixel it reads 2C input elements (4 or
// 2 bytes) and writes D floats, and runs C*D FMAs. At C=8 (davo-fast,
// D=49) the output is 75 % (float32 maps) to 86 % (bf16) of the bytes:
// memory bounds it. At C=96 (davo /16, D=81) the FMAs take 71 % of the
// byte time with float32 maps (67 TFLOP/s against 3.35 TB/s), near
// balance, and bound it with bf16 maps (the bytes shrink by 35 %).
//
// Design. A block owns a tile of 4 image rows x 32 columns of one image
// (128 output pixels; 2 or 1 rows where 4 would leave most SMs without
// a block) and walks the channels in slices of at most 64 bytes
// per pixel. For each slice it stages the f1 tile and the f2 window (the
// tile grown by s on every side; 0 outside the frame and past C) in
// shared memory by 16-byte cp.async, each thread one 16-byte unit of
// every few pixels, its row and column advanced by addition; with more
// than one slice the next slice's copies are in flight while this one is
// computed (two buffers). Shared memory holds one plane per 16-byte unit
// of a pixel, with a unit of padding after every 4 pixels, so that the 8
// lanes of a quarter-warp, whose pixels lie 4 apart, hit 8 bank groups,
// and every load of the inner loop sits at a fixed offset. Each thread
// keeps a register block of 4 adjacent pixels x the 2s+1 dx of one
// (tile row, dy): 28 or 36 accumulators. Per 4 channels it reads its 4
// pixels' f1 once and streams the 4 + 2s window pixels of its row once
// (16-byte loads of float32, 8-byte loads of bf16 widened in registers),
// and runs all its FMAs from registers. The (tile row, dy) pairs are
// ordered by tile row + dy, so the pairs of a warp mostly read one window
// row. The epilogue writes the tile's outputs into shared memory (over
// the input buffers); each tile row's outputs, one contiguous run of
// 32*D floats, then leave by coalesced 16-byte streaming stores
// (st.global.cs), shifted in shared memory so that the stores are
// aligned whatever the run's offset.
// Per output the sum runs as before: channels ascending, fmaf, times 1/C
// last, so it stays within 1e-5 of the plain version.
// Other shapes: any C (the last slice ragged); frames that do not fill a
// tile (masked); maps that are not 16-byte aligned, or whose pixels are
// not a whole number of 16-byte units, staged by plain loads into the
// same layout; searches other than 3 and 4 through a generic
// instantiation that keeps dx in chunks of 8, one work item a thread.
// The host takes the largest tile whose work items fit 1024 threads and
// whose window and slice fit a block's shared memory (down to 1x4) and
// refuses the launch beyond that: above search 43 a 1x4 tile's window
// and staged outputs exceed 227 KB.
//
// What still holds it back (PERF.md): the staging, about half the time
// at the davo levels (the window is 3.75x the tile, and two 78 KB blocks
// per SM at s=4 overlap staging and arithmetic little); with float32
// maps the inner loop's shared-memory reads (16 bytes per lane and
// channel quad: 4 wavefronts a load), with bf16 maps its issue rate
// (an integer op per value widened) at 18 warps per SM. Tensor cores
// (the banded Gram product, davo_tpu/models/flownet.py::
// cost_volume_gram) are the next step at C >= 32.
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
// (two blocks per SM), more than a block may have beyond s=7. There
// (and wherever the host finds that the whole window and the D
// cotangent rows do not fit) a block walks the 2s+1 shift rows in
// passes of `rows`, as the flow level's input backward does
// (rowconv_bwd.cu): each pass stages the window rows and the
// cotangents that its shift rows read (the tile's 8 rows + rows - 1
// window rows, 128 x rows*(2s+1) cotangents); the accumulators carry
// over the passes, so every sum keeps its ascending shift order. One
// shift row a pass fits up to s = 64. s = 2, 3, 4 stay compile-time
// one-pass instances.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"
#include "costvol_tile.cuh"

namespace {

using namespace davo;

// ---------------------------------------------------------------- forward

// One block per tile of the volume (`cv_correlate`); each tile row's
// outputs then leave shared memory as one contiguous run of `out`.
template <typename T, int kS>
__global__ void __launch_bounds__(kS >= 0 ? 8 * kFwdRows * (2 * kS + 1) : kFwdGenericThreads,
                                  kS == 3 ? 3 : kS == 4 ? 2 : 1)
cost_volume_kernel(const T* __restrict__ f1, const T* __restrict__ f2, float* __restrict__ out,
                   int H, int W, int C, int s_rt, bool vec, FwdPlan p) {
  extern __shared__ uint4 smem_u[];
  const int s = kS >= 0 ? kS : s_rt;
  const int D = (2 * s + 1) * (2 * s + 1);
  const CvTile ct = cv_tile_at(p, H);
  const int x0 = ct.x0, y0 = ct.y0;
  const long long row0 = ct.row0;
  // Output elements of `out` before the next 16-byte boundary; row r's
  // run starts at the same offset mod 4 floats in shared memory.
  const int out_mis = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  cv_correlate<T, kS>(f1, f2, H, W, C, s_rt, vec, p, ct, smem_u, [&](int r) {
    return static_cast<int>((out_mis + ((row0 + y0 + r) * W + x0) * static_cast<long long>(D)) & 3);
  });
  const float* out_s = reinterpret_cast<const float*>(smem_u);
  // Each tile row's outputs are one contiguous run of `out`: scalar
  // stores up to a 16-byte boundary, then 16-byte streaming stores.
  const int n = min(p.tw, W - x0) * D;
  for (int r = 0; r < p.th && y0 + r < H; ++r) {
    const long long start = ((row0 + y0 + r) * W + x0) * static_cast<long long>(D);
    const int mis = static_cast<int>((out_mis + start) & 3);
    const int head = min((4 - mis) & 3, n);
    const int body = (n - head) >> 2;
    float* dst = out + start;
    const float* src = out_s + r * p.row_stride + mis;
    for (int e = threadIdx.x; e < head; e += blockDim.x) __stcs(dst + e, src[e]);
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    for (int e = threadIdx.x; e < body; e += blockDim.x) __stcs(dst4 + e, src4[e]);
    for (int e = head + 4 * body + threadIdx.x; e < n; e += blockDim.x) __stcs(dst + e, src[e]);
  }
}

// Raises the kernel's dynamic shared-memory limit once per device (not
// while a CUDA graph captures the launch: the first call is eager).
template <typename T, int kS>
cudaError_t launch_fwd(const void* f1, const void* f2, void* out, long long tiles, int H, int W,
                       int C, int search, bool vec, const FwdPlan& p, int device,
                       cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  if (granted[device] < p.smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        cost_volume_kernel<T, kS>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    granted[device] = p.smem;
  }
  cost_volume_kernel<T, kS><<<static_cast<unsigned>(tiles), p.threads, p.smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<float*>(out), H, W, C,
      search, vec, p);
  return cudaGetLastError();
}

// f1, f2: (B, H, W, C) of T (float, or bf16 as its bits), contiguous, on
// the current device; out: (B, H, W, (2*search+1)^2) float32.
template <typename T>
int cost_volume_forward(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                        int search, void* stream) {
  const long long pixels = static_cast<long long>(B) * H * W;
  if (B < 0 || H < 0 || W < 0 || C < 1 || search < 0 || pixels > INT_MAX / 2 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int smem_max = 0, sms = 0;
  err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdPlan p{};
  // Beyond search 64 not even a 1x4 tile's window fits 227 KB.
  if (search > 64 || !plan_forward(B, H, W, C, search, sizeof(T), smem_max, sms, &p)) {
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  const long long tiles = static_cast<long long>(B) * p.tiles_y * p.tiles_x;
  const auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec = (C * sizeof(T)) % 16 == 0 && aligned(f1) && aligned(f2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (search) {
    case 3:
      err = launch_fwd<T, 3>(f1, f2, out, tiles, H, W, C, search, vec, p, device, st);
      break;
    case 4:
      err = launch_fwd<T, 4>(f1, f2, out, tiles, H, W, C, search, vec, p, device, st);
      break;
    default:
      err = launch_fwd<T, -1>(f1, f2, out, tiles, H, W, C, search, vec, p, device, st);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------- backward

// Backward tiles: kBwdTileH x kBwdTileW pixels (one row per warp, four
// groups of kBwdPix pixels per row), kBwdSlice channels (8 lanes x 4).
constexpr int kBwdTileH = 8, kBwdTileW = 16, kBwdSlice = 32, kBwdPix = 4;
constexpr int kBwdThreads = 32 * kBwdTileH;
static_assert(kBwdTileW == 4 * kBwdPix && kBwdSlice == 8 * 4, "lane layout");

// Shared memory of a pass of `rows` shift rows: the window rows it reads
// and the tile's cotangents of those rows (rows = 2s+1: the one-pass plan).
__host__ __device__ constexpr long long bwd_smem_floats(int search, int rows) {
  return static_cast<long long>(kBwdTileH + rows - 1) * (kBwdTileW + 2 * search) * kBwdSlice +
         static_cast<long long>(kBwdTileH) * kBwdTileW * rows * (2 * search + 1);
}

// acc[i][.] += sum over one pass's nr shift rows of gs[pixel i, k] * the
// window at pixel i shifted by +delta_k (d f1) or -delta_k (d f2), dy
// outer and dx inner per output. `ms` points at the staged window pixel
// of the group's first output pixel (its row, the pass's first staged
// row) and this thread's 4 channels, `gs` at the group's first
// cotangent row (gd a pixel; shift row r of the pass at r * d). kS >= 0:
// one pass of all d rows.
template <bool kDf1, int kS>
__device__ __forceinline__ void accumulate_shifts(float (&acc)[kBwdPix][4], const float* ms,
                                                  const float* gs, int s_rt, int nr_rt, int gd_rt) {
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, ww = kBwdTileW + 2 * s;
  const int nr = kS >= 0 ? d : nr_rt, gd = kS >= 0 ? d * d : gd_rt;
  const int span = kBwdPix + 2 * s;  // window pixels one row of shifts reaches
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    // Staged from the pass's first window row: d f1 reads row ly + r,
    // d f2 row ly + nr - 1 - r.
    const int wrow = kDf1 ? r : nr - 1 - r;
    const float4* mrow = reinterpret_cast<const float4*>(ms + wrow * ww * kBwdSlice);
    const float* grow = gs + r * d;
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
          const float gk = grow[i * gd + dx];
          acc[i][0] = fmaf(gk, m.x, acc[i][0]);
          acc[i][1] = fmaf(gk, m.y, acc[i][1]);
          acc[i][2] = fmaf(gk, m.z, acc[i][2]);
          acc[i][3] = fmaf(gk, m.w, acc[i][3]);
        }
      }
    }
  }
}


// One block per (image, tile, gradient, channel slice), grid-stride.
// kS is the search radius when known at compile time (one pass of all
// 2s+1 shift rows), else -1 (passes of `rows` shift rows).
template <int kS>
__global__ void __launch_bounds__(kBwdThreads, 2)
cost_volume_bwd_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                       const float* __restrict__ g, float* __restrict__ df1,
                       float* __restrict__ df2, int H, int W, int C, int s_rt, int rows_rt,
                       int tiles_x, int tiles_y, int slices, int first_grad, int grads, bool vec,
                       long long blocks) {
  extern __shared__ float4 smem4[];
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, D = d * d;
  const int rows = kS >= 0 ? d : rows_rt, gd = rows * d;
  const int ww = kBwdTileW + 2 * s;
  float* ms = reinterpret_cast<float*>(smem4);         // window: (rows + 7) x ww pixels x kBwdSlice
  float* gs = ms + (kBwdTileH + rows - 1) * ww * kBwdSlice;  // cotangents: (tile pixels) x gd
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

    // Thread: tile row `warp`, pixels 4*grp .. 4*grp+3, channels
    // c0 + 4*c4 .. +3.
    const int c4 = lane & 7, grp = lane >> 3;
    const int lx0 = grp * kBwdPix;
    const float* mbase = ms + (warp * ww + lx0) * kBwdSlice + 4 * c4;
    const float* gbase = gs + (warp * kBwdTileW + lx0) * gd;
    float acc[kBwdPix][4] = {};
    for (int dy0 = 0; dy0 < d; dy0 += rows) {
      const int nr = min(rows, d - dy0);
      // The window rows the pass reads: d f1 dy0 .. dy0 + nr + 6; d f2
      // 2s - dy0 - nr + 1 .. 2s - dy0 + 7.
      const int wr0 = is_df1 ? dy0 : 2 * s - dy0 - nr + 1;
      const int wh = kBwdTileH + nr - 1;
      __syncthreads();  // every read of shared memory by the last pass or block is done
      // Staging, all through cp.async so that every load of the pass is
      // in flight at once. The other map's window rows, lanes over the
      // slice's channels: 16 bytes a lane, four window pixels a warp,
      // when C % 4 == 0 (`vec`), else 4 bytes a lane, one pixel a warp.
      if (vec) {
        const int c = c0 + 4 * (lane & 7);
        for (int wp = (lane >> 3) + 4 * warp; wp < wh * ww; wp += 4 * kBwdTileH) {
          const int wy = wp / ww, wx = wp - (wp / ww) * ww;
          const int y = y0 - s + wr0 + wy, x = x0 - s + wx;
          const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
          copy_async16(ms + wp * kBwdSlice + 4 * (lane & 7),
                       in ? other + ((row0 + y) * W + x) * C + c : other, in);
        }
      } else {
        for (int wp = warp; wp < wh * ww; wp += kBwdTileH) {
          const int wy = wp / ww, wx = wp - (wp / ww) * ww;
          const int y = y0 - s + wr0 + wy, x = x0 - s + wx, c = c0 + lane;
          const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
          const float* src = in ? other + ((row0 + y) * W + x) * C + c : other;
          copy_async4(ms + wp * kBwdSlice + lane, src, in);
        }
      }
      if (is_df1 && nr == d) {
        // g[p, :] of the tile's pixels: one warp per tile row, whose
        // cotangents are one contiguous run (16 bytes a lane when the run
        // starts 16-byte aligned, as it does for W % 4 == 0).
        const int y = y0 + warp, tw = min(kBwdTileW, W - x0);
        float* dst = gs + warp * kBwdTileW * D;
        if (y >= H) {
          for (int e = lane; e < kBwdTileW * D; e += 32) dst[e] = 0.0f;
        } else {
          const float* src = g + ((row0 + y) * W + x0) * D;
          const int n = tw * D;  // floats of the run
          int e0 = 0;
          if (reinterpret_cast<unsigned long long>(src) % 16 == 0) {
            e0 = n / 4 * 4;
            for (int e = 4 * lane; e < e0; e += 128) copy_async16(dst + e, src + e, true);
          }
          for (int e = e0 + lane; e < n; e += 32) copy_async4(dst + e, src + e, true);
          for (int e = n + lane; e < kBwdTileW * D; e += 32) dst[e] = 0.0f;  // past the frame
        }
      } else if (is_df1) {
        // A pass's shift rows of g[p, :]: per tile row, a run of nr*d
        // contiguous cotangents a pixel, lanes over (pixel, element).
        const int y = y0 + warp, gn = nr * d;
        for (int e = lane; e < kBwdTileW * gn; e += 32) {
          const int px = e / gn, k = e - px * gn, x = x0 + px;
          const bool in = y < H && x < W;
          copy_async4(gs + (warp * kBwdTileW + px) * gd + k,
                      in ? g + ((row0 + y) * W + x) * D + dy0 * d + k : g, in);
        }
      } else {
        // g[q - delta_k, k] for the tile's q. For a tile row qy and a
        // shift row dy the sources lie on one image row (y0 + qy + s -
        // dy): one warp per (qy, dy), lanes over (window column, dx), dx
        // fastest, so that a warp reads runs of d contiguous cotangents;
        // each (q, k) of the tile is written once, 0 where its source
        // leaves the frame.
        for (int pair = warp; pair < kBwdTileH * nr; pair += kBwdTileH) {
          const int qy = pair / nr, rr = pair - (pair / nr) * nr, dy = dy0 + rr;
          const int y = y0 + qy + s - dy;
          const bool row_in = y >= 0 && y < H && y0 + qy < H;
          for (int e = lane; e < ww * d; e += 32) {
            const int wx = e / d, dx = e - (e / d) * d;
            const int qx = wx - 2 * s + dx;
            if (qx < 0 || qx >= kBwdTileW) continue;
            const int x = x0 - s + wx;
            const bool in = row_in && x >= 0 && x < W;
            copy_async4(gs + (qy * kBwdTileW + qx) * gd + rr * d + dx,
                        in ? g + ((row0 + y) * W + x) * D + dy * d + dx : g, in);
          }
        }
      }
      copy_async_wait_all();
      __syncthreads();
      if (is_df1) {
        accumulate_shifts<true, kS>(acc, mbase, gbase, s, nr, gd);
      } else {
        accumulate_shifts<false, kS>(acc, mbase, gbase, s, nr, gd);
      }
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

// Raises the kernel's dynamic shared-memory limit once per device and
// size (not while a CUDA graph captures the launch: the first call is
// eager).
template <int kS>
cudaError_t launch_bwd(const float* f1, const float* f2, const float* g, float* df1, float* df2,
                       int H, int W, int C, int search, int rows, int tiles_x, int tiles_y,
                       int slices, int first_grad, int grads, bool vec, long long blocks,
                       int device, int smem, cudaStream_t stream) {
  static int granted[kMaxDevices] = {};
  const cudaError_t err = allow_smem(cost_volume_bwd_kernel<kS>, device, smem, granted);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(blocks < (1LL << 20) ? blocks : (1LL << 20));
  cost_volume_bwd_kernel<kS><<<grid, kBwdThreads, smem, stream>>>(
      f1, f2, g, df1, df2, H, W, C, search, rows, tiles_x, tiles_y, slices, first_grad, grads,
      vec, blocks);
  return cudaGetLastError();
}

// The most shift rows a pass whose window rows and cotangents fit `smem_max`
// bytes (2s+1: one pass); 0 where not even one row fits.
int bwd_rows(int search, int smem_max) {
  int rows = 2 * search + 1;
  while (rows > 0 && 4 * bwd_smem_floats(search, rows) > smem_max) --rows;
  return rows;
}

}  // namespace

extern "C" {

// f1, f2: (B, H, W, C) float32 (davo_cost_volume_f32) or bfloat16
// (davo_cost_volume_bf16), contiguous, on the current device; out:
// (B, H, W, (2*search+1)^2) float32, contiguous. Launches on `stream`,
// allocates nothing and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for sizes the kernel does not take, or
// cudaErrorLaunchOutOfResources for a search whose smallest tile's window
// and outputs do not fit a block's shared memory (search above 43).
int davo_cost_volume_f32(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                         int search, void* stream) {
  return cost_volume_forward<float>(f1, f2, out, B, H, W, C, search, stream);
}

int davo_cost_volume_bf16(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                          int search, void* stream) {
  return cost_volume_forward<unsigned short>(f1, f2, out, B, H, W, C, search, stream);
}

// g: (B, H, W, (2*search+1)^2) cotangent of the forward's output;
// df1, df2: (B, H, W, C) float32 or null for a map that needs no
// gradient. One launch computes the requested maps on `stream`, for any
// search up to 64 (wide searches walk the shift rows in passes); same
// return contract as davo_cost_volume_f32.
int davo_cost_volume_bwd_f32(const void* f1, const void* f2, const void* g, void* df1,
                             void* df2, int B, int H, int W, int C, int search, void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 1 || search < 0 || search > 64 ||
      static_cast<long long>(B) * H * W > INT_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = bwd_rows(search, smem_max);
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(4 * bwd_smem_floats(search, rows));
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
  const bool one_pass = rows == 2 * search + 1;
  switch (one_pass ? search : -1) {
    case 2:
      err = launch_bwd<2>(a, b, gp, o1, o2, H, W, C, search, rows, tiles_x, tiles_y, slices,
                          first_grad, grads, vec, blocks, device, smem, s);
      break;
    case 3:
      err = launch_bwd<3>(a, b, gp, o1, o2, H, W, C, search, rows, tiles_x, tiles_y, slices,
                          first_grad, grads, vec, blocks, device, smem, s);
      break;
    case 4:
      err = launch_bwd<4>(a, b, gp, o1, o2, H, W, C, search, rows, tiles_x, tiles_y, slices,
                          first_grad, grads, vec, blocks, device, smem, s);
      break;
    default:
      err = launch_bwd<-1>(a, b, gp, o1, o2, H, W, C, search, rows, tiles_x, tiles_y, slices,
                           first_grad, grads, vec, blocks, device, smem, s);
  }
  return static_cast<int>(err);
}

const char* davo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
