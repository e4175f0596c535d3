// The correlation tile of the cost-volume forward (costvol.cu), shared by
// the cost volume and the flow level's input kernel of rowconv.cu:
// stage an f1 tile and its f2 window by cp.async, slice by slice of the
// channels, keep 4 pixels x the shifts of one (tile row, dy) in
// registers, and leave the tile's correlations, times 1/C, in shared
// memory (`cv_correlate`); the kernels then store them their own way. The
// design note is costvol.cu's.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace davo {

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

// A block's tile: image row b*H (row0), first row y0 and column x0.
struct CvTile {
  int x0, y0;
  long long row0;
};

__device__ __forceinline__ CvTile cv_tile_at(const FwdPlan& p, int H) {
  int t = blockIdx.x;
  CvTile c;
  c.x0 = (t % p.tiles_x) * p.tw;
  t /= p.tiles_x;
  c.y0 = (t % p.tiles_y) * p.th;
  c.row0 = static_cast<long long>(t / p.tiles_y) * H;
  return c;
}

// One block's tile of th x tw output pixels of one image, one thread per
// work item: (column group g, tile row r, dy, dx chunk); a thread
// accumulates the kFwdPix pixels of group g in row r over the chunk's
// dx. kS is the search when known at compile time (one chunk of all
// 2s+1 dx), else -1. Leaves the tile's correlations (times 1/C) in
// shared memory, row r's D values of pixel i at out_s[r * row_stride +
// lead(r) + i * D + k], where `lead(r)` (0-3) is the caller's offset of
// row r, and syncs the block.
template <typename T, int kS, typename Lead>
__device__ __forceinline__ void cv_correlate(const T* __restrict__ f1, const T* __restrict__ f2, int H, int W,
                                             int C, int s_rt, bool vec, const FwdPlan& p, const CvTile& ct,
                                             uint4* smem_u, Lead lead) {
  const int x0 = ct.x0, y0 = ct.y0;
  const long long row0 = ct.row0;
  constexpr int kVE = 16 / sizeof(T);
  constexpr int kD = kS >= 0 ? 2 * kS + 1 : kFwdChunk;
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1, D = d * d;
  const int stage_units = p.tile_units + p.win_units;
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
  // The outputs into the staging rows (over the input buffers), row r's
  // from the caller's lead(r).
  float* out_s = reinterpret_cast<float*>(smem_u);
  if (active) {
    float* o = out_s + r * p.row_stride + lead(r) + (kFwdPix * g) * D + dy * d + dx0;
#pragma unroll
    for (int i = 0; i < kFwdPix; ++i) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (kS >= 0 || j < nd) o[i * D + j] = acc[i][j] * inv_c;
      }
    }
  }
  __syncthreads();
}

// The largest tile, then slice, then number of buffers whose shared
// memory fits `smem_max`; false if even a 1x4 tile with one 16-byte
// unit per pixel does not. At s = 3, 4 the tile is 32 wide, and has
// fewer than 4 rows while the tiles would number under half the SMs
// (`sms`): there each block's serial channel loop, not the halo, is the
// cost.
inline bool plan_forward(int B, int H, int W, int C, int s, int elem, int smem_max, int sms, FwdPlan* p) {
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

}  // namespace davo
