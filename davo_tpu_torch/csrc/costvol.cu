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
// (two blocks per SM), more than a block may have beyond s=7.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace davo;

// ---------------------------------------------------------------- forward

constexpr int kFwdPix = 4;        // adjacent output pixels per thread
constexpr int kFwdRows = 4;       // tile rows at s = 3, 4 (fewer on small grids)
constexpr int kFwdSliceBytes = 64;  // of each pixel, per channel slice
constexpr int kFwdChunk = 8;      // dx per thread in the generic instantiation
constexpr int kFwdGenericThreads = 1024;

// The forward's geometry, chosen on the host (plan_forward).
struct FwdPlan {
  int th, tw, groups;          // tile rows, columns; column groups of kFwdPix pixels
  int wh, ww;                  // window rows, columns (tile + 2s; columns padded to 4)
  int nq, nq_log2;             // 16-byte units per pixel of one slice (a power of 2)
  int cs, slices, stages;      // channels per slice; slices; 1 or 2 staging buffers
  int tile_plane, win_plane;   // 16-byte units of one plane (one unit of every pixel)
  int tile_units, win_units;   // 16-byte units of one buffer's f1 tile and f2 window
  int chunks, items;           // dx chunks per (row, dy); work items (one a thread)
  int row_stride;              // output staging: floats per tile row
  int threads, tiles_x, tiles_y;
  int smem;                    // dynamic shared memory, bytes
};

// Shared memory holds one plane per 16-byte unit of a pixel's slice
// (unit q of every pixel), row-major over the tile or window, with one
// unit of padding after every 4 pixels: the 8 lanes of a quarter-warp,
// whose pixels lie 4 apart, then land 5 units apart, in 8 bank groups,
// and a thread's loads sit at fixed offsets from one base.
__device__ __forceinline__ int padded(int pix) { return pix + (pix >> 2); }

// Four channels of unit `u` (of their quad `h` within it) widened to
// float32: 16 bytes of float, or 8 bytes of bf16 (the high half of a
// float32: exact).
__device__ __forceinline__ void load4(const uint4* units, int u, int, const float*,
                                      float (&v)[4]) {
  const uint4 x = units[u];
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void load4(const uint4* units, int u, int h, const unsigned short*,
                                      float (&v)[4]) {
  const uint2 x = reinterpret_cast<const uint2*>(units)[2 * u + h];
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

// Stages unit q (channels c .. c + 16 / sizeof(T) - 1) of the pixels
// p0, p0 + step, ... of a rows x cols region whose first pixel is image
// pixel (y_first, x_first), into plane q of `dst` (padded); 0 outside
// the frame and past C. The pixel's row and column advance by addition.
template <typename T>
__device__ __forceinline__ void stage_region(const T* __restrict__ map, uint4* dst, int rows,
                                             int cols, int y_first, int x_first, int H, int W,
                                             int C, long long row0, int c, int p0, int step,
                                             bool vec) {
  constexpr int kVE = 16 / sizeof(T);
  const int n = rows * cols, step_rows = step / cols, step_cols = step - step_rows * cols;
  int py = p0 / cols, px = p0 - py * cols;
  for (int pix = p0; pix < n; pix += step) {
    const int y = y_first + py, x = x_first + px;
    const bool in = y >= 0 && y < H && x >= 0 && x < W && c < C;
    const T* src = in ? map + ((row0 + y) * W + x) * C + c : map;
    uint4* to = dst + padded(pix);
    if (vec) {
      copy_async16(to, src, in);
    } else {
      T* e = reinterpret_cast<T*>(to);
#pragma unroll
      for (int j = 0; j < kVE; ++j) e[j] = in && c + j < C ? src[j] : T(0);
    }
    py += step_rows;
    px += step_cols;
    if (px >= cols) {
      px -= cols;
      ++py;
    }
  }
}

// Stages channels c0 .. c0 + cs - 1 of the f1 tile and the f2 window into
// `buf` (tile planes first); 0 outside the frame and past C. By cp.async
// when `vec`, else by plain loads. Thread t stages unit t % nq of every
// (blockDim / nq)-th pixel (blockDim is a multiple of nq).
template <typename T>
__device__ __forceinline__ void fwd_stage(const T* __restrict__ f1, const T* __restrict__ f2,
                                          uint4* buf, const FwdPlan& p, int H, int W, int C,
                                          int s, long long row0, int y0, int x0, int c0,
                                          bool vec) {
  constexpr int kVE = 16 / sizeof(T);
  const int q = threadIdx.x & (p.nq - 1), p0 = threadIdx.x >> p.nq_log2;
  const int step = blockDim.x >> p.nq_log2, c = c0 + q * kVE;
  stage_region(f1, buf + q * p.tile_plane, p.th, p.tw, y0, x0, H, W, C, row0, c, p0, step, vec);
  stage_region(f2, buf + p.tile_units + q * p.win_plane, p.wh, p.ww, y0 - s, x0 - s, H, W, C,
               row0, c, p0, step, vec);
}

// One block per tile of th x tw output pixels of one image, one thread
// per work item: (column group g, tile row r, dy, dx chunk); a thread
// accumulates the kFwdPix pixels of group g in row r over the chunk's
// dx. kS is the search when known at compile time (one chunk of all
// 2s+1 dx), else -1.
template <typename T, int kS>
__global__ void __launch_bounds__(kS >= 0 ? 8 * kFwdRows * (2 * kS + 1) : kFwdGenericThreads,
                                  kS == 3 ? 3 : kS == 4 ? 2 : 1)
cost_volume_kernel(const T* __restrict__ f1, const T* __restrict__ f2, float* __restrict__ out,
                   int H, int W, int C, int s_rt, bool vec, FwdPlan p) {
  constexpr int kVE = 16 / sizeof(T);
  constexpr int kD = kS >= 0 ? 2 * kS + 1 : kFwdChunk;
  extern __shared__ uint4 smem_u[];
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, D = d * d;
  int t = blockIdx.x;
  const int x0 = (t % p.tiles_x) * p.tw;
  t /= p.tiles_x;
  const int y0 = (t % p.tiles_y) * p.th;
  const long long row0 = static_cast<long long>(t / p.tiles_y) * H;  // b*H
  const int stage_units = p.tile_units + p.win_units;
  // Output elements of `out` before the next 16-byte boundary.
  const int out_mis = static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 3);
  const float inv_c = 1.0f / static_cast<float>(C);

  const bool active = static_cast<int>(threadIdx.x) < p.items;
  int g = 0, r = 0, dy = 0, dx0 = 0, nd = kD;
  if (active) {
    g = threadIdx.x % p.groups;
    const int slot = threadIdx.x / p.groups;
    dx0 = (slot % p.chunks) * kD;
    nd = min(kD, d - dx0);
    // The k-th (row, dy) pair in order of row + dy, then row.
    int k = slot / p.chunks;
    for (int wy = 0;; ++wy) {
      const int lo = max(0, wy - (d - 1)), hi = min(p.th - 1, wy);
      if (k <= hi - lo) {
        r = lo + k;
        dy = wy - r;
        break;
      }
      k -= hi - lo + 1;
    }
  }
  // Plane offsets of this thread's first f1 pixel and first window
  // pixel; tw, ww and dx0 are multiples of 4, so its f1 pixel i lies at
  // + i and its window pixel j at + j + j / 4.
  const int tbase = padded(r * p.tw + kFwdPix * g);
  const int wbase = padded((r + dy) * p.ww + kFwdPix * g + dx0);

  float acc[kFwdPix][kD];
#pragma unroll
  for (int i = 0; i < kFwdPix; ++i) {
#pragma unroll
    for (int j = 0; j < kD; ++j) acc[i][j] = 0.0f;
  }

  fwd_stage(f1, f2, smem_u, p, H, W, C, s, row0, y0, x0, 0, vec);
  copy_async_commit();
  for (int k = 0; k < p.slices; ++k) {
    const int c0 = k * p.cs;
    if (p.stages == 2 && k + 1 < p.slices) {
      fwd_stage(f1, f2, smem_u + ((k + 1) & 1) * stage_units, p, H, W, C, s, row0, y0, x0,
                c0 + p.cs, vec);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    if (active) {
      const uint4* tile = smem_u + (p.stages == 2 ? (k & 1) * stage_units : 0);
      const uint4* win = tile + p.tile_units;
      // Four channels at a time: a unit holds kVE / 4 such quads (past C
      // they hold zeros).
      const int units = min(p.nq, (C - c0 + kVE - 1) / kVE);
      for (int q = 0; q < units; ++q) {
        const uint4* tq = tile + q * p.tile_plane + tbase;
        const uint4* wq = win + q * p.win_plane + wbase;
#pragma unroll
        for (int h = 0; h < kVE / 4; ++h) {
          float a[kFwdPix][4];
#pragma unroll
          for (int i = 0; i < kFwdPix; ++i) load4(tq, i, h, f1, a[i]);
#pragma unroll
          for (int j = 0; j < kFwdPix + kD - 1; ++j) {
            if (kS < 0 && j >= kFwdPix - 1 + nd) break;  // a narrower last chunk
            float w[4];
            load4(wq, j + (j >> 2), h, f1, w);
#pragma unroll
            for (int i = 0; i < kFwdPix; ++i) {
              const int dx = j - i;  // pixel i meets window pixel j at dx0 + dx
              if (dx >= 0 && dx < kD) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][dx] = fmaf(a[i][e], w[e], acc[i][dx]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
    if (p.stages == 1 && k + 1 < p.slices) {
      fwd_stage(f1, f2, smem_u, p, H, W, C, s, row0, y0, x0, c0 + p.cs, vec);
      copy_async_commit();
    }
  }
  // The outputs into the staging rows (over the input buffers): row r's
  // run starts at the same offset mod 4 floats as its place in `out`.
  float* out_s = reinterpret_cast<float*>(smem_u);
  if (active) {
    const int mis = static_cast<int>(
        (out_mis + ((row0 + y0 + r) * W + x0) * static_cast<long long>(D)) & 3);
    float* o = out_s + r * p.row_stride + mis + (kFwdPix * g) * D + dy * d + dx0;
#pragma unroll
    for (int i = 0; i < kFwdPix; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (kS >= 0 || j < nd) o[i * D + j] = acc[i][j] * inv_c;
      }
    }
  }
  __syncthreads();
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

// The largest tile, then slice, then number of buffers whose shared
// memory fits `smem_max`; false if even a 1x4 tile with one 16-byte
// unit per pixel does not. At s = 3, 4 the tile is 32 wide, and has
// fewer than 4 rows while the tiles would number under half the SMs
// (`sms`): there each block's serial channel loop, not the halo, is the
// cost.
bool plan_forward(int B, int H, int W, int C, int s, int elem, int smem_max, int sms,
                  FwdPlan* p) {
  static const int kTiles[][2] = {{kFwdRows, 32}, {2, 32}, {1, 32}, {1, 16}, {1, 8}, {1, 4}};
  const int ve = 16 / elem, d = 2 * s + 1;
  const long long D = static_cast<long long>(d) * d;
  const bool fixed = s == 3 || s == 4;  // the instantiations with all dx in registers
  const int kd = fixed ? d : kFwdChunk;
  int cs_first = ve;
  while (cs_first < C && cs_first * elem < kFwdSliceBytes) cs_first *= 2;
  for (const auto& tile : kTiles) {
    const int th = tile[0], tw = tile[1];
    if (fixed && tw != 32) break;
    if (fixed && th > 1 &&
        2LL * B * ((H + th - 1) / th) * ((W + tw - 1) / tw) < sms) {
      continue;
    }
    const int chunks = (d + kd - 1) / kd, items = tw / kFwdPix * th * d * chunks;
    if (items > kFwdGenericThreads) continue;
    for (int cs = cs_first; cs >= ve; cs /= 2) {
      const int slices = (C + cs - 1) / cs;
      for (int stages = slices > 1 ? 2 : 1; stages >= 1; --stages) {
        FwdPlan q{};
        q.th = th;
        q.tw = tw;
        q.groups = tw / kFwdPix;
        q.wh = th + 2 * s;
        q.ww = (tw + 2 * s + 3) / 4 * 4;
        q.nq = cs / ve;
        while ((1 << q.nq_log2) < q.nq) ++q.nq_log2;
        q.cs = cs;
        q.slices = slices;
        q.stages = stages;
        q.tile_plane = th * tw + th * tw / 4;
        q.win_plane = q.wh * q.ww + q.wh * q.ww / 4;
        q.tile_units = q.nq * q.tile_plane;
        q.win_units = q.nq * q.win_plane;
        q.chunks = chunks;
        q.items = items;
        q.threads = (items + 31) / 32 * 32;
        const long long row_stride = (tw * D + 3 + 3) / 4 * 4;
        const long long in_bytes = 16LL * stages * (q.tile_units + q.win_units);
        const long long out_bytes = 4LL * th * row_stride;
        const long long smem = in_bytes > out_bytes ? in_bytes : out_bytes;
        if (smem > smem_max) continue;
        q.row_stride = static_cast<int>(row_stride);
        q.tiles_x = (W + tw - 1) / tw;
        q.tiles_y = (H + th - 1) / th;
        q.smem = static_cast<int>(smem);
        *p = q;
        return true;
      }
    }
  }
  return false;
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
        copy_async4(ms + wp * kBwdSlice + lane, src, in);
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
        for (int e = e0 + lane; e < n; e += 32) copy_async4(dst + e, src + e, true);
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
          copy_async4(gs + (qy * kBwdTileW + qx) * D + dy * d + dx,
                     in ? g + ((row0 + y) * W + x) * D + dy * d + dx : g, in);
        }
      }
    }
    copy_async_wait_all();
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
