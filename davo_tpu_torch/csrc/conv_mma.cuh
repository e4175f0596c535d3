// The tensor-core conv layer of davo_tpu_torch/csrc, shared by the
// stand-alone layer kernels of rowconv.cu and the one-launch conv stack of
// conv_stack.cu: one SAME conv layer (any odd k, stride 1 or 2, Flax's
// pads) as an implicit GEMM, in two precisions on the same tiles, K
// orders and plan (`mma_plan`):
//   bf16: mma.sync m16n8k16 (bf16 x bf16 -> f32), `conv_mma_chunked_tile`
//     and `conv_mma_flat_tile`;
//   float32: mma.sync m16n8k8 in split TF32 (common.cuh: each float32
//     operand hi + lo, three TF32 products), `conv_tf32_chunked_tile` and
//     `conv_tf32_flat_tile`. Each operand is split once: the weights by
//     the host (`_pack_tf32` in kernels/rowconv.py, hi and lo planes), the
//     input as it is staged (hi and lo planes in shared memory; a bf16
//     input is exact in TF32 and stages no lo, 2 products) or, with
//     kSplitOnRead (the conv stack), as each fragment is read from one
//     staged plane of the float32 input: half the halo's bytes, the same
//     hi and lo, more conversions per product; a halo kept as it is can
//     be copied by cp.async (16-byte units of float32 in the chunked
//     order; 4-byte elements of a read-only input in the flat one), so
//     its loads are in flight together; and where the epilogue can stage
//     in the halo's place (the flat order; a one-chunk K), the caller
//     keeps a channel block's weights staged from one tile to the next
//     (`stage_weights`). The products
//     of every 16 K (a tap of a chunk; two k-steps of the flat order) go
//     into a fresh accumulator that is added to the running sum on the
//     FP32 units: a running mma sum drifts past 1e-5 of the largest
//     output over a deep K (rowconv_bwd.cu's note), an FP32 add rounds as
//     an FMA loop's does.
// A block computes one tile at a time through one of them; the caller
// says which tile (a stand-alone kernel: its block index; the stack: each
// tile of its grid-stride walk).
//
// M = a tile's 128 or 256 output pixels (a Layout), N = its NT*8 output
// channels, K = k*k*Cin in one of two orders (the weights' packing,
// `_pack_mma` in kernels/rowconv.py, follows it):
//   chunked (Cin >= 16): input channels in chunks of 16 (the last padded
//     with zeros), K = (chunk, tap, channel); weights [Np][chunks][k*k][16];
//   flat (Cin < 16): K = (tap, channel) flattened, padded to a multiple of
//     16 with zeros; weights [Np][Kp];
// Np = Cout padded to a multiple of 8. Zero weights add exact zeros, so
// the padding changes no sum.
//
// Loads of the layer input: kCoherent false reads it through the read-only
// path (cp.async.ca for 4 and 8 bytes, __ldg), right for an input that no
// block of the launch writes; kCoherent true reads only through L2
// (cp.async.cg, ld.global.cg), as the conv stack must: its intermediates
// were written by other blocks of the same launch, before its grid-wide
// barrier, and L1 is not coherent across SMs.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace davo {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store1(void* out, long long i, float v, int out_bf16) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

template <bool kCoherent, typename T>
__device__ __forceinline__ T load_in(const T* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

// A block of WARPS warps owns WARPS*32 output pixels, a tile TW (8 or 16)
// columns wide, pixel r = y*TW + x; warp w the pixels [32w, 32w + 32),
// as two 16-pixel A tiles (2 rows x 8 columns, or 1 row x 16).
template <int WARPS, int TW>
struct Layout {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kTw = TW;
  static constexpr int kTh = WARPS * 32 / TW;
};

struct MmaGeo {
  int H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l;
  int taps;        // k*k
  int tile_h, tile_w;  // output rows and columns of a block's tile (the launch's Layout)
  int HH, HW;      // input halo of a tile: (tile_h-1)*stride + k rows, (tile_w-1)*stride + k columns
  int HWh, HWs;    // stride 2: columns stored by parity, HWh = ceil(HW/2) each; HWs columns in all
  int nchunks;     // chunked: ceil(cin/16)
  int kp;          // flat: k*k*cin padded to a multiple of 16
  int npad;        // rows of the packed weights: Cout padded to 8
  int n_rows;      // NT*8, a block's output channels
  int piece;       // input channels one staging copy moves (8, 4, 2, 1)
  int stages;      // chunked: 2 = double-buffered staging, 1 = single
  int round_out, relu, out_bf16;
  int tiles_x, tiles;  // tiles per image row of tiles, and per image
};

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the low half, first
  return *reinterpret_cast<const unsigned*>(&v);
}

// Up to 8 input channels (`avail` of them real, the rest zero) of one
// pixel into one 16-byte unit of shared memory, as bf16: copied as they
// are (cp.async, `piece` channels a copy; coherent: 16-byte copies only,
// else element loads through L2) or rounded from float32.
template <bool kCoherent>
__device__ __forceinline__ void stage_unit(uint4* dst, const __nv_bfloat16* src, int avail, int piece) {
  if (piece == 8) {
    copy_async16(dst, src);
  } else if (!kCoherent && piece == 4) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (4 * j < avail) {
        copy_async8(d + 2 * j, src + 4 * j);
      } else {
        d[2 * j] = d[2 * j + 1] = 0u;
      }
    }
  } else if (!kCoherent && piece == 2) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j < avail) {
        copy_async4(d + j, src + 2 * j);
      } else {
        d[j] = 0u;
      }
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned lo = 2 * j < avail ? load_in<kCoherent>(s + 2 * j) : 0u;
      const unsigned hi = 2 * j + 1 < avail ? load_in<kCoherent>(s + 2 * j + 1) : 0u;
      v[j] = lo | (hi << 16);
    }
    *dst = make_uint4(v[0], v[1], v[2], v[3]);
  }
}
template <bool kCoherent>
__device__ __forceinline__ void stage_unit(uint4* dst, const float* src, int avail, int piece) {
  float v[8];
  if (piece == 4) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 q = 4 * j < avail ? load_in<kCoherent>(reinterpret_cast<const float4*>(src) + j)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < avail ? load_in<kCoherent>(src + j) : 0.0f;
  }
  *dst = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// One element of the input as a bf16 bit pattern (flat staging).
template <bool kCoherent>
__device__ __forceinline__ unsigned short bf16_bits(const __nv_bfloat16* p) {
  return load_in<kCoherent>(reinterpret_cast<const unsigned short*>(p));
}
template <bool kCoherent>
__device__ __forceinline__ unsigned short bf16_bits(const float* p) {
  const __nv_bfloat16 v = __float2bfloat16_rn(load_in<kCoherent>(p));
  return *reinterpret_cast<const unsigned short*>(&v);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Halo column of input column offset hx within the tile's halo: stride 2
// stores even and odd columns apart, so that the 8 output columns of an
// ldmatrix read 8 neighbouring slots.
__device__ __forceinline__ int halo_col(const MmaGeo& g, int hx) {
  return g.stride == 2 ? (hx & 1) * g.HWh + (hx >> 1) : hx;
}

// A block's tile: image b, output rows [oy0, oy0 + tile_h), columns
// [ox0, ox0 + tile_w), channels [co0, co0 + n_rows).
struct Tile {
  int b, oy0, ox0, co0;
};

// Tile `bt` (image-major) of the layer, channel block `cb`.
__device__ __forceinline__ Tile tile_at(const MmaGeo& g, int bt, int cb) {
  const int t = bt % g.tiles;
  Tile tile;
  tile.b = bt / g.tiles;
  tile.oy0 = (t / g.tiles_x) * g.tile_h;
  tile.ox0 = (t % g.tiles_x) * g.tile_w;
  tile.co0 = cb * g.n_rows;
  return tile;
}

// Chunked order: K chunk `chunk` (input channels [16*chunk, 16*chunk+16))
// into shared memory. The halo holds 2 units (16 channels) a pixel at
// slot q = hy*HWs + halo_col(hx), unit 2q + (octet ^ bit 2 of q); the
// weights taps*2 units a row, unit u of row n at n*taps*2 + (u ^ bit 2
// of n). Each swizzle puts the 8 rows of every ldmatrix into 8 distinct
// 16-byte bank groups.
template <bool kCoherent, typename TIn>
__device__ __forceinline__ void stage_chunk(uint4* halo, uint4* wts, const TIn* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ w, const MmaGeo& g,
                                            const Tile& t, int chunk) {
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int units = g.HH * g.HW * 2;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    const int o = i & 1, p = i >> 1;
    const int hy = p / g.HW, hx = p - hy * g.HW;
    const int q = hy * g.HWs + halo_col(g, hx);
    uint4* dst = halo + 2 * q + (o ^ ((q >> 2) & 1));
    const int iy = iy0 + hy, ix = ix0 + hx, ch = chunk * 16 + o * 8;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W || ch >= g.cin) {
      *dst = make_uint4(0u, 0u, 0u, 0u);  // SAME zero padding, zero channels
    } else {
      stage_unit<kCoherent>(dst, x + ((static_cast<size_t>(t.b) * g.H + iy) * g.W + ix) * g.cin + ch,
                            g.cin - ch, g.piece);
    }
  }
  const int row = g.taps * 2;
  const int wunits = g.n_rows * row;
  for (int i = threadIdx.x; i < wunits; i += blockDim.x) {
    const int n = i / row, u = i - n * row;
    uint4* dst = wts + n * row + (u ^ ((n >> 2) & 1));
    const int co = t.co0 + n;
    if (co < g.npad) {
      copy_async16(dst, w + (static_cast<size_t>(co) * g.nchunks + chunk) * g.taps * 16 + u * 8);
    } else {
      *dst = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Bias, ONE rounding to the activation dtype, ReLU, then the block's
// outputs leave through shared memory as 16-byte stores (8 channels of a
// pixel; element stores where Cout is not a multiple of 8).
template <int NT, typename L>
__device__ __forceinline__ void mma_epilogue(float (&acc)[2][NT][4], void* smem, const float* __restrict__ bias,
                                             void* __restrict__ out, const MmaGeo& g, const Tile& t) {
  constexpr int kStride = NT * 8 + 4;  // floats per pixel row of the staged tile
  float* ot = static_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tc = lane & 3;
  __syncthreads();  // every warp is done reading the staged operands
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * tc;
    const int co = t.co0 + col;
    const float b0 = co < g.cout ? __ldg(bias + co) : 0.0f;
    const float b1 = co + 1 < g.cout ? __ldg(bias + co + 1) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[mt][nt][2 * h] + b0, v1 = acc[mt][nt][2 * h + 1] + b1;
        if (g.round_out) {
          v0 = round_bf16(v0);
          v1 = round_bf16(v1);
        }
        if (g.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const int r = warp * 32 + mt * 16 + h * 8 + gr;
        *reinterpret_cast<float2*>(ot + r * kStride + col) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();
  const int ncols = min(NT * 8, g.cout - t.co0);
  const bool vec = g.cout % 8 == 0;
  for (int i = threadIdx.x; i < L::kThreads * NT; i += L::kThreads) {
    const int r = i / NT, j = (i - r * NT) * 8;
    const int oy = t.oy0 + r / L::kTw, ox = t.ox0 + r % L::kTw;
    if (oy >= g.Ho || ox >= g.Wo || j >= ncols) continue;
    const float* src = ot + r * kStride + j;
    const size_t o = ((static_cast<size_t>(t.b) * g.Ho + oy) * g.Wo + ox) * g.cout + t.co0 + j;
    if (vec) {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      if (g.out_bf16) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) =
            make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                       pack_bf16(hi.z, hi.w));
      } else {
        float* d = static_cast<float*>(out) + o;
        *reinterpret_cast<float4*>(d) = lo;
        *reinterpret_cast<float4*>(d + 4) = hi;
      }
    } else {
      for (int e = 0; e < 8 && j + e < ncols; ++e) store1(out, static_cast<long long>(o) + e, src[e], g.out_bf16);
    }
  }
}

// The chunked order (Cin >= 16): K chunks staged by cp.async, double-
// buffered where two stages fit; per chunk and tap, each warp loads its
// two 16-pixel A tiles and the chunk's B tiles with ldmatrix and issues
// 2*NT mma.sync. Leaves no copy in flight; the caller syncs the block
// before shared memory is staged again.
template <typename TIn, int NT, typename L, bool kCoherent>
__device__ __forceinline__ void conv_mma_chunked_tile(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                                                      const float* __restrict__ bias, void* __restrict__ out,
                                                      const MmaGeo& g, const Tile& t, uint4* smem4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int halo_units = g.HH * g.HWs * 2, stage_units = halo_units + g.n_rows * g.taps * 2;
  // This lane's ldmatrix rows: pixel (lane & 15) of each of the warp's two
  // 16-pixel tiles, its octet lane >> 4.
  int hrow[2], hcol[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp * 32 + mt * 16 + (lane & 15);
    hrow[mt] = (r / L::kTw) * g.stride;
    hcol[mt] = r % L::kTw;
  }
  const int octet = lane >> 4;
  // B rows of this lane: channel (lane & 7) + 8 * (lane >> 4) of each pair of
  // 8-channel tiles, k half (lane >> 3) & 1.
  const int brow = (lane & 7) + ((lane >> 4) << 3), bhalf = (lane >> 3) & 1;
  const int wrow = g.taps * 2;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  stage_chunk<kCoherent>(smem4, smem4 + halo_units, x, w, g, t, 0);
  copy_async_commit();
  for (int c = 0; c < g.nchunks; ++c) {
    const int buf = g.stages == 2 ? (c & 1) : 0;
    if (g.stages == 2 && c + 1 < g.nchunks) {
      uint4* next = smem4 + ((c + 1) & 1) * stage_units;
      stage_chunk<kCoherent>(next, next + halo_units, x, w, g, t, c + 1);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    const uint4* halo = smem4 + buf * stage_units;
    const uint4* wts = halo + halo_units;
    for (int tap = 0; tap < g.taps; ++tap) {
      const int ky = tap / g.k, kx = tap - ky * g.k;
      const int kxs = halo_col(g, kx);  // the tap's column offset (hx = stride*col + kx)
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int q = (hrow[mt] + ky) * g.HWs + hcol[mt] + kxs;
        ldmatrix_x4(a[mt], halo + 2 * q + (octet ^ ((q >> 2) & 1)));
      }
      const int u = tap * 2 + bhalf;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int n = np * 16 + brow;
        unsigned b[4];
        ldmatrix_x4(b, wts + n * wrow + (u ^ ((n >> 2) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
      if constexpr (NT % 2 == 1) {
        const int n = (NT - 1) * 8 + (lane & 7);
        unsigned b[2];
        ldmatrix_x2(b, wts + n * wrow + (u ^ ((n >> 2) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
      }
    }
    if (g.stages == 1) {
      if (c + 1 < g.nchunks) {
        __syncthreads();
        stage_chunk<kCoherent>(smem4, smem4 + halo_units, x, w, g, t, c + 1);
        copy_async_commit();
      }
    } else {
      __syncthreads();  // this buffer is staged again two chunks on
    }
  }
  mma_epilogue<NT, L>(acc, smem4, bias, out, g, t);
}

// The flat order (Cin < 16): the whole halo, all its channels, as bf16
// elements, and all of K's weight rows (Kp/8 + 1 units a row: odd, so
// ldmatrix rows fall in distinct bank groups) staged once; each k-step's
// A fragment is gathered from the halo through a table of the K index's
// offset (tap, channel), since consecutive K are not contiguous there.
template <typename TIn, int NT, typename L, bool kCoherent>
__device__ __forceinline__ void conv_mma_flat_tile(const TIn* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                                                   const float* __restrict__ bias, void* __restrict__ out,
                                                   const MmaGeo& g, const Tile& t, uint4* smem4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wrow = g.kp / 8 + 1;
  uint4* wts = smem4;
  int* koff = reinterpret_cast<int*>(wts + g.n_rows * wrow);
  unsigned short* hs = reinterpret_cast<unsigned short*>(koff + g.kp);

  const int wunits = g.n_rows * (g.kp / 8);
  for (int i = threadIdx.x; i < wunits; i += L::kThreads) {
    const int n = i / (g.kp / 8), u = i - n * (g.kp / 8);
    const int co = t.co0 + n;
    if (co < g.npad) {
      copy_async16(wts + n * wrow + u, w + static_cast<size_t>(co) * g.kp + u * 8);
    } else {
      wts[n * wrow + u] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  copy_async_commit();
  const int K = g.taps * g.cin;
  for (int kk = threadIdx.x; kk < g.kp; kk += L::kThreads) {
    int off = 0;  // K padding: any finite element, times a zero weight
    if (kk < K) {
      const int tap = kk / g.cin, c = kk - tap * g.cin;
      const int ky = tap / g.k, kx = tap - ky * g.k;
      off = (ky * g.HW + kx) * g.cin + c;
    }
    koff[kk] = off;
  }
  // The halo, HH rows of HW pixels x cin channels: a halo row is one
  // contiguous run of the input, of which the elements [e_lo, e_hi) lie
  // inside the frame (the rest are SAME zeros). Rows of 128 elements or
  // more go a row per warp, lanes along it; shorter ones lane-dense over
  // the whole halo, each thread's (row, element) advanced by a fixed step.
  // Neither divides per element.
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int row_elems = g.HW * g.cin;
  const int e_lo = max(-ix0, 0) * g.cin, e_hi = min(g.HW, g.W - ix0) * g.cin, e_off = ix0 * g.cin;
  const TIn* image = x + static_cast<size_t>(t.b) * g.H * g.W * g.cin;
  if (row_elems >= 128) {
    for (int hy = warp; hy < g.HH; hy += L::kThreads / 32) {
      const int iy = iy0 + hy;
      unsigned short* dst = hs + hy * row_elems;
      const TIn* row = image + static_cast<size_t>(iy < 0 || iy >= g.H ? 0 : iy) * g.W * g.cin;
      const int lo = iy < 0 || iy >= g.H ? row_elems : e_lo;
#pragma unroll 4
      for (int e = lane; e < row_elems; e += 32) {
        dst[e] = e >= lo && e < e_hi ? bf16_bits<kCoherent>(row + e_off + e) : static_cast<unsigned short>(0);
      }
    }
  } else {
    const int step_rows = L::kThreads / row_elems, step_elems = L::kThreads - step_rows * row_elems;
    int hy = threadIdx.x / row_elems, e = threadIdx.x - hy * row_elems;
    for (int i = threadIdx.x; i < g.HH * row_elems; i += L::kThreads) {
      const int iy = iy0 + hy;
      hs[i] = iy >= 0 && iy < g.H && e >= e_lo && e < e_hi
                  ? bf16_bits<kCoherent>(image + static_cast<size_t>(iy) * g.W * g.cin + e_off + e)
                  : static_cast<unsigned short>(0);
      hy += step_rows;
      e += step_elems;
      if (e >= row_elems) {
        e -= row_elems;
        ++hy;
      }
    }
  }
  copy_async_wait_group<0>();
  __syncthreads();

  const int gr = lane >> 2, tc = lane & 3;
  int base[2][2];  // halo element of tap (0, 0), channel 0 for rows gr and gr + 8 of each A tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + h * 8 + gr;
      base[mt][h] = ((r / L::kTw) * g.stride * g.HW + (r % L::kTw) * g.stride) * g.cin;
    }
  }
  const int brow = (lane & 7) + ((lane >> 4) << 3), bhalf = (lane >> 3) & 1;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int ks = 0; ks < g.kp / 16; ++ks) {
    const int k0 = ks * 16 + 2 * tc;
    const int o0 = koff[k0], o1 = koff[k0 + 1], o8 = koff[k0 + 8], o9 = koff[k0 + 9];
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const unsigned short* r0 = hs + base[mt][0];
      const unsigned short* r1 = hs + base[mt][1];
      a[mt][0] = static_cast<unsigned>(r0[o0]) | (static_cast<unsigned>(r0[o1]) << 16);
      a[mt][1] = static_cast<unsigned>(r1[o0]) | (static_cast<unsigned>(r1[o1]) << 16);
      a[mt][2] = static_cast<unsigned>(r0[o8]) | (static_cast<unsigned>(r0[o9]) << 16);
      a[mt][3] = static_cast<unsigned>(r1[o8]) | (static_cast<unsigned>(r1[o9]) << 16);
    }
    const int u = ks * 2 + bhalf;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      ldmatrix_x4(b, wts + (np * 16 + brow) * wrow + u);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    if constexpr (NT % 2 == 1) {
      unsigned b[2];
      ldmatrix_x2(b, wts + ((NT - 1) * 8 + (lane & 7)) * wrow + u);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
    }
  }
  mma_epilogue<NT, L>(acc, smem4, bias, out, g, t);
}

// ------------------------------------------------------------- split TF32

// Four input channels of one pixel as float32, zero past `avail`: one
// 16-byte load of float32 (piece 4), one 8-byte load of bf16 (piece 4 or
// more), else element loads.
template <bool kCoherent>
__device__ __forceinline__ float4 load_quad(const float* src, int avail, int piece) {
  if (piece == 4 && avail >= 4) return load_in<kCoherent>(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = j < avail ? load_in<kCoherent>(src + j) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
template <bool kCoherent>
__device__ __forceinline__ float4 load_quad(const __nv_bfloat16* src, int avail, int piece) {
  unsigned lo, hi;  // bf16 pairs, element 0 in the low half
  if (piece >= 4 && avail >= 4) {
    const uint2 q = load_in<kCoherent>(reinterpret_cast<const uint2*>(src));
    lo = q.x;
    hi = q.y;
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    unsigned v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < avail ? load_in<kCoherent>(s + j) : 0u;
    lo = v[0] | (v[1] << 16);
    hi = v[2] | (v[3] << 16);
  }
  return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u), __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}

// v's hi into *hi and its lo into *lo (4 floats each).
__device__ __forceinline__ void stage_split(uint4* hi, uint4* lo, float4 v) {
  unsigned h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *hi = make_uint4(h[0], h[1], h[2], h[3]);
  *lo = make_uint4(l[0], l[1], l[2], l[3]);
}
// Element i of a flat halo: (hi, lo) as one float2 (kLo), else v as it is.
template <bool kLo>
__device__ __forceinline__ void stage_split1(float* halo, int i, float v) {
  if (kLo) {
    unsigned h, l;
    split(v, h, l);
    reinterpret_cast<float2*>(halo)[i] = make_float2(__uint_as_float(h), __uint_as_float(l));
  } else {
    halo[i] = v;
  }
}

// t = a * b over one 16-K step (two k-steps of 8: b[0..1] and b[2..3]) in
// split TF32 into a fresh accumulator, the small terms first; kALo: the
// input has a lo (float32), else its lo is zero (bf16: two products).
template <bool kALo>
__device__ __forceinline__ void mma_tf32_step(float t[4], const unsigned (&ahi)[2][4], const unsigned (&alo)[2][4],
                                              const unsigned bhi[4], const unsigned blo[4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (kALo) {
      if (ks == 0) {
        mma_tf32_fresh(t, alo[ks], bhi[2 * ks], bhi[2 * ks + 1]);
      } else {
        mma_tf32(t, alo[ks], bhi[2 * ks], bhi[2 * ks + 1]);
      }
      mma_tf32(t, ahi[ks], blo[2 * ks], blo[2 * ks + 1]);
    } else if (ks == 0) {
      mma_tf32_fresh(t, ahi[ks], blo[2 * ks], blo[2 * ks + 1]);
    } else {
      mma_tf32(t, ahi[ks], blo[2 * ks], blo[2 * ks + 1]);
    }
    mma_tf32(t, ahi[ks], bhi[2 * ks], bhi[2 * ks + 1]);
  }
}

// Chunked order, float32: chunk `chunk`'s halo (4 16-byte units of 4
// channels a pixel; unit o of slot q at 4q + (o ^ bits 1-2 of q), hi and
// lo planes) and weights (taps*4 units a row; unit u of row n at
// n*taps*4 + (u ^ bits 1-2 of n), hi and lo planes from the host's
// packing [2][Np][chunks][taps][16]) into shared memory. Each swizzle puts
// the 8 rows of every ldmatrix into 8 distinct 16-byte bank groups.
// kLoPlane false: the halo's one plane holds the input as it is (a bf16
// input, or a float32 one split as it is read); a float32 input in whole
// 16-byte units (piece 4) is then copied by cp.async (through L2 only:
// right for kCoherent too), zero-filled off the frame.
// With `weights` false the weights already in place are kept.
template <bool kCoherent, bool kLoPlane, typename TIn>
__device__ __forceinline__ void stage_chunk_tf32(uint4* hhi, uint4* hlo, uint4* whi, uint4* wlo,
                                                 const TIn* __restrict__ x, const float* __restrict__ w,
                                                 const MmaGeo& g, const Tile& t, int chunk, bool weights = true) {
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int units = g.HH * g.HW * 4;
  for (int i = threadIdx.x; i < units; i += blockDim.x) {
    const int o = i & 3, p = i >> 2;
    const int hy = p / g.HW, hx = p - hy * g.HW;
    const int q = hy * g.HWs + halo_col(g, hx);
    const int u = 4 * q + (o ^ ((q >> 1) & 3));
    const int iy = iy0 + hy, ix = ix0 + hx, ch = chunk * 16 + o * 4;
    if constexpr (!kLoPlane && sizeof(TIn) == 4) {
      if (g.piece == 4) {
        const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && ch < g.cin;
        copy_async16(hhi + u, inside ? x + ((static_cast<size_t>(t.b) * g.H + iy) * g.W + ix) * g.cin + ch : x,
                     inside);
        continue;
      }
    }
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // SAME zero padding, zero channels
    if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && ch < g.cin) {
      v = load_quad<kCoherent>(x + ((static_cast<size_t>(t.b) * g.H + iy) * g.W + ix) * g.cin + ch, g.cin - ch,
                               g.piece);
    }
    if (kLoPlane) {
      stage_split(hhi + u, hlo + u, v);
    } else {
      hhi[u] = make_uint4(__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z), __float_as_uint(v.w));
    }
  }
  if (!weights) return;
  const int row = g.taps * 4;
  const size_t plane = static_cast<size_t>(g.npad) * g.nchunks * g.taps * 16;  // floats of the hi plane
  for (int i = threadIdx.x; i < g.n_rows * row; i += blockDim.x) {
    const int n = i / row, u = i - n * row;
    const int dst = n * row + (u ^ ((n >> 1) & 3));
    const int co = t.co0 + n;
    if (co < g.npad) {
      const float* src = w + (static_cast<size_t>(co) * g.nchunks + chunk) * g.taps * 16 + u * 4;
      copy_async16(whi + dst, src);
      copy_async16(wlo + dst, src + plane);
    } else {
      whi[dst] = wlo[dst] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The chunked order in float32 (Cin >= 16): K chunks staged and double-
// buffered as `conv_mma_chunked_tile` stages them; per chunk and tap each
// warp loads its two 16-pixel A tiles' hi and lo for the tap's two
// k-steps with ldmatrix, and per 8-channel n-tile the tap's B hi and lo,
// then runs each (A tile, n-tile)'s split products into a fresh sum added
// to the running one. kSplitOnRead: a float32 input is staged as it is,
// one plane (half the halo's bytes), and split as each fragment is read
// (the same hi and lo, so the same sums); where K is one chunk and the
// epilogue's outputs fit in the halo's place, the weights stay staged and
// a caller whose next tile has the same channel block passes
// stage_weights false. The caller syncs the block before shared memory is
// staged again.
template <typename TIn, int NT, typename L, bool kCoherent, bool kSplitOnRead = false>
__device__ __forceinline__ void conv_tf32_chunked_tile(const TIn* __restrict__ x, const float* __restrict__ w,
                                                       const float* __restrict__ bias, void* __restrict__ out,
                                                       const MmaGeo& g, const Tile& t, uint4* smem4,
                                                       bool stage_weights = true) {
  constexpr bool kALo = sizeof(TIn) == 4;  // a bf16 input is exact in TF32
  constexpr bool kLoPlane = kALo && !kSplitOnRead;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int halo_units = g.HH * g.HWs * 4, w_units = g.n_rows * g.taps * 4;
  const int stage_units = (kLoPlane ? 2 : 1) * halo_units + 2 * w_units;
  const bool stage_w = stage_weights || !kSplitOnRead || g.nchunks > 1 ||
                       L::kThreads * (NT * 8 + 4) * sizeof(float) > halo_units * sizeof(uint4);
  // A: this lane's ldmatrix row is pixel (lane & 15) of each 16-pixel tile,
  // its k half (lane >> 4) of a k-step; B: row n = lane & 7 of an n-tile,
  // k quarter lane >> 3 of the tap's 16.
  int hrow[2], hcol[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp * 32 + mt * 16 + (lane & 15);
    hrow[mt] = (r / L::kTw) * g.stride;
    hcol[mt] = r % L::kTw;
  }
  const int khalf = lane >> 4, brow = lane & 7, bquarter = lane >> 3;
  const int wrow = g.taps * 4;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  auto stage = [&](int c, uint4* base) {
    uint4* hlo = base + halo_units;
    uint4* whi = hlo + (kLoPlane ? halo_units : 0);
    stage_chunk_tf32<kCoherent, kLoPlane>(base, hlo, whi, whi + w_units, x, w, g, t, c, stage_w);
  };
  stage(0, smem4);
  copy_async_commit();
  for (int c = 0; c < g.nchunks; ++c) {
    const int buf = g.stages == 2 ? (c & 1) : 0;
    if (g.stages == 2 && c + 1 < g.nchunks) {
      stage(c + 1, smem4 + ((c + 1) & 1) * stage_units);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    const uint4* hhi = smem4 + buf * stage_units;
    const uint4* hlo = hhi + halo_units;
    const uint4* whi = hlo + (kLoPlane ? halo_units : 0);
    const uint4* wlo = whi + w_units;
    for (int tap = 0; tap < g.taps; ++tap) {
      const int ky = tap / g.k, kx = tap - ky * g.k;
      const int kxs = halo_col(g, kx);  // the tap's column offset (hx = stride*col + kx)
      unsigned ahi[2][2][4], alo[2][2][4];  // [A tile][k-step]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int q = (hrow[mt] + ky) * g.HWs + hcol[mt] + kxs;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int u = 4 * q + ((2 * ks + khalf) ^ ((q >> 1) & 3));
          ldmatrix_x4(ahi[mt][ks], hhi + u);
          if (kLoPlane) {
            ldmatrix_x4(alo[mt][ks], hlo + u);
          } else if (kALo) {
#pragma unroll
            for (int j = 0; j < 4; ++j) split(__uint_as_float(ahi[mt][ks][j]), ahi[mt][ks][j], alo[mt][ks][j]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + brow;
        const int wu = n * wrow + ((tap * 4 + bquarter) ^ ((n >> 1) & 3));
        unsigned bhi[4], blo[4];
        ldmatrix_x4(bhi, whi + wu);
        ldmatrix_x4(blo, wlo + wu);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float s4[4];
          mma_tf32_step<kALo>(s4, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += s4[e];
        }
      }
    }
    if (g.stages == 1) {
      if (c + 1 < g.nchunks) {
        __syncthreads();
        stage(c + 1, smem4);
        copy_async_commit();
      }
    } else {
      __syncthreads();  // this buffer is staged again two chunks on
    }
  }
  mma_epilogue<NT, L>(acc, smem4, bias, out, g, t);
}

// The flat order in float32 (Cin < 16): the whole halo, all its
// channels, split into hi and lo (one float2 an element: one load gives
// both), and all of K's weight
// rows (Kp/4 + 1 units a row: odd, so ldmatrix rows fall in distinct bank
// groups; hi and lo planes from the host's [2][Np][Kp]) staged once; each
// k-step's A fragment is gathered from the halo through the table of the
// K index's offset (tap, channel). Every 16 K's products go into a fresh
// sum added to the running one. kSplitOnRead (MmaPrec::kTf32SplitOnRead):
// a float32 halo is staged as it is, one float an element, and split as
// it is gathered; the epilogue stages its outputs in the halo's place, so
// the weights and the K table stay in shared memory, and a caller whose
// next tile has the same channel block passes stage_weights false.
template <typename TIn, int NT, typename L, bool kCoherent, bool kSplitOnRead = false>
__device__ __forceinline__ void conv_tf32_flat_tile(const TIn* __restrict__ x, const float* __restrict__ w,
                                                    const float* __restrict__ bias, void* __restrict__ out,
                                                    const MmaGeo& g, const Tile& t, uint4* smem4,
                                                    bool stage_weights = true) {
  constexpr bool kALo = sizeof(TIn) == 4;
  constexpr bool kLoPlane = kALo && !kSplitOnRead;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wrow = g.kp / 4 + 1;
  uint4* whi = smem4;
  uint4* wlo = whi + g.n_rows * wrow;
  int* koff = reinterpret_cast<int*>(wlo + g.n_rows * wrow);
  float* halo = reinterpret_cast<float*>(koff + g.kp);
  const int halo_elems = g.HH * g.HW * g.cin;

  if (stage_weights) {
    const int wunits = g.n_rows * (g.kp / 4);
    const size_t plane = static_cast<size_t>(g.npad) * g.kp;
    for (int i = threadIdx.x; i < wunits; i += L::kThreads) {
      const int n = i / (g.kp / 4), u = i - n * (g.kp / 4);
      const int co = t.co0 + n;
      if (co < g.npad) {
        const float* src = w + static_cast<size_t>(co) * g.kp + u * 4;
        copy_async16(whi + n * wrow + u, src);
        copy_async16(wlo + n * wrow + u, src + plane);
      } else {
        whi[n * wrow + u] = wlo[n * wrow + u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    copy_async_commit();
    const int K = g.taps * g.cin;
    for (int kk = threadIdx.x; kk < g.kp; kk += L::kThreads) {
      int off = 0;  // K padding: any finite element, times a zero weight
      if (kk < K) {
        const int tap = kk / g.cin, c = kk - tap * g.cin;
        const int ky = tap / g.k, kx = tap - ky * g.k;
        off = (ky * g.HW + kx) * g.cin + c;
      }
      koff[kk] = off;
    }
  }
  // The halo, as `conv_mma_flat_tile` walks it: rows of 128 elements or
  // more a row per warp, shorter ones lane-dense over the whole halo.
  // Each element split into hi and lo as it is staged (kLoPlane), else
  // kept as it is; a float32 input no block of the launch writes is then
  // copied by cp.async (4 bytes, zero-filled off the frame).
  constexpr bool kAsyncHalo = kALo && !kLoPlane && !kCoherent;
  const int iy0 = t.oy0 * g.stride - g.pad_t, ix0 = t.ox0 * g.stride - g.pad_l;
  const int row_elems = g.HW * g.cin;
  const int e_lo = max(-ix0, 0) * g.cin, e_hi = min(g.HW, g.W - ix0) * g.cin, e_off = ix0 * g.cin;
  const TIn* image = x + static_cast<size_t>(t.b) * g.H * g.W * g.cin;
  if (row_elems >= 128) {
    for (int hy = warp; hy < g.HH; hy += L::kThreads / 32) {
      const int iy = iy0 + hy;
      const TIn* row = image + static_cast<size_t>(iy < 0 || iy >= g.H ? 0 : iy) * g.W * g.cin;
      const int lo = iy < 0 || iy >= g.H ? row_elems : e_lo;
#pragma unroll 4
      for (int e = lane; e < row_elems; e += 32) {
        if constexpr (kAsyncHalo) {
          const bool inside = e >= lo && e < e_hi;
          copy_async4(halo + hy * row_elems + e, inside ? row + e_off + e : row, inside);
        } else {
          const float v = e >= lo && e < e_hi ? to_float(load_in<kCoherent>(row + e_off + e)) : 0.0f;
          stage_split1<kLoPlane>(halo, hy * row_elems + e, v);
        }
      }
    }
  } else {
    const int step_rows = L::kThreads / row_elems, step_elems = L::kThreads - step_rows * row_elems;
    int hy = threadIdx.x / row_elems, e = threadIdx.x - hy * row_elems;
    for (int i = threadIdx.x; i < halo_elems; i += L::kThreads) {
      const int iy = iy0 + hy;
      const bool inside = iy >= 0 && iy < g.H && e >= e_lo && e < e_hi;
      if constexpr (kAsyncHalo) {
        copy_async4(halo + i, inside ? image + static_cast<size_t>(iy) * g.W * g.cin + e_off + e : image, inside);
      } else {
        const float v =
            inside ? to_float(load_in<kCoherent>(image + static_cast<size_t>(iy) * g.W * g.cin + e_off + e)) : 0.0f;
        stage_split1<kLoPlane>(halo, i, v);
      }
      hy += step_rows;
      e += step_elems;
      if (e >= row_elems) {
        e -= row_elems;
        ++hy;
      }
    }
  }
  if (kAsyncHalo) copy_async_commit();
  copy_async_wait_group<0>();
  __syncthreads();

  const int gr = lane >> 2, tc = lane & 3;
  int base[2][2];  // halo element of tap (0, 0), channel 0 for rows gr and gr + 8 of each A tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 32 + mt * 16 + h * 8 + gr;
      base[mt][h] = ((r / L::kTw) * g.stride * g.HW + (r % L::kTw) * g.stride) * g.cin;
    }
  }
  const int brow = lane & 7, bquarter = lane >> 3;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int k16 = 0; k16 < g.kp / 16; ++k16) {
    unsigned ahi[2][2][4], alo[2][2][4];  // [A tile][k-step]: a0 (gr, tc), a1 (gr+8, tc), a2 (gr, tc+4), a3 (gr+8, tc+4)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = k16 * 16 + ks * 8 + tc;
      const int o0 = koff[k0], o4 = koff[k0 + 4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int offs[4] = {base[mt][0] + o0, base[mt][1] + o0, base[mt][0] + o4, base[mt][1] + o4};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kLoPlane) {
            const float2 v = reinterpret_cast<const float2*>(halo)[offs[j]];
            ahi[mt][ks][j] = __float_as_uint(v.x);
            alo[mt][ks][j] = __float_as_uint(v.y);
          } else if (kALo) {
            split(halo[offs[j]], ahi[mt][ks][j], alo[mt][ks][j]);
          } else {
            ahi[mt][ks][j] = __float_as_uint(halo[offs[j]]);
            alo[mt][ks][j] = 0u;
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int wu = (nt * 8 + brow) * wrow + k16 * 4 + bquarter;
      unsigned bhi[4], blo[4];
      ldmatrix_x4(bhi, whi + wu);
      ldmatrix_x4(blo, wlo + wu);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float s4[4];
        mma_tf32_step<kALo>(s4, ahi[mt], alo[mt], bhi, blo);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += s4[e];
      }
    }
  }
  mma_epilogue<NT, L>(acc, kSplitOnRead ? reinterpret_cast<uint4*>(halo) : smem4, bias, out, g, t);
}

// ------------------------------------------------------------------ host

// Whether K runs in chunks of 16 input channels (kernels/rowconv.py
// `mma_chunked`), else flat.
inline bool mma_flat(int cin) { return cin < 16; }

// The layer's geometry for a tile of tile_h x tile_w output pixels;
// n_rows, piece, stages and the epilogue's flags are the caller's.
inline void mma_geometry(MmaGeo& g, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                         int pad_t, int pad_l, int tile_h, int tile_w) {
  g.H = H;
  g.W = W;
  g.cin = cin;
  g.Ho = Ho;
  g.Wo = Wo;
  g.cout = cout;
  g.k = k;
  g.stride = stride;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.taps = k * k;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.HH = (tile_h - 1) * stride + k;
  g.HW = (tile_w - 1) * stride + k;
  g.HWh = (g.HW + 1) / 2;
  g.HWs = stride == 2 ? 2 * g.HWh : g.HW;
  g.nchunks = (cin + 15) / 16;
  g.kp = (g.taps * cin + 15) / 16 * 16;
  g.npad = (cout + 7) / 8 * 8;
  g.tiles_x = (Wo + tile_w - 1) / tile_w;
  g.tiles = g.tiles_x * ((Ho + tile_h - 1) / tile_h);
}

// Input channels one staging copy moves, from the input's dtype, width and
// address: 16, 8 or 4 bytes of bf16, 16 bytes of float32, else one element.
inline int mma_piece(const void* x, int x_bf16, int cin) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  if (x_bf16) {
    return (cin % 8 == 0 && addr % 16 == 0) ? 8 : (cin % 4 == 0 && addr % 8 == 0) ? 4
           : (cin % 2 == 0 && addr % 4 == 0) ? 2 : 1;
  }
  return (cin % 4 == 0 && addr % 16 == 0) ? 4 : 1;
}

// The operands' precision: bf16, or float32 in split TF32 with the input's
// lo staged as a second plane (a float32 input) or not (a bf16 one, exact
// in TF32), or with one plane of the input split as it is read (the
// tiles' kSplitOnRead: the flat order's epilogue then stages in the
// halo's place, past the weights and the K table).
enum class MmaPrec { kBf16, kTf32, kTf32NoALo, kTf32SplitOnRead };

// Shared memory of one tile: the larger of the operands and the epilogue's
// staged outputs, bytes.
inline size_t mma_smem(const MmaGeo& g, bool flat, MmaPrec prec = MmaPrec::kBf16) {
  const size_t epi = static_cast<size_t>(g.tile_h) * g.tile_w * (g.n_rows + 4) * sizeof(float);
  size_t ops;
  if (prec == MmaPrec::kBf16) {
    if (flat) {
      ops = static_cast<size_t>(g.n_rows) * (g.kp / 8 + 1) * 16 + g.kp * sizeof(int) +
            static_cast<size_t>(g.HH) * g.HW * g.cin * 2;
    } else {
      ops = static_cast<size_t>(g.stages) * (static_cast<size_t>(g.HH) * g.HWs * 2 + g.n_rows * g.taps * 2) * 16;
    }
  } else {
    const size_t a_planes = prec == MmaPrec::kTf32 ? 2 : 1;  // halo hi (and lo); weights hi and lo
    if (flat) {
      size_t halo = a_planes * g.HH * g.HW * g.cin * sizeof(float);
      if (prec == MmaPrec::kTf32SplitOnRead && epi > halo) halo = epi;  // the epilogue's place
      ops = 2 * static_cast<size_t>(g.n_rows) * (g.kp / 4 + 1) * 16 + g.kp * sizeof(int) + halo;
    } else {
      ops = static_cast<size_t>(g.stages) *
            (a_planes * g.HH * g.HWs * 4 + 2 * static_cast<size_t>(g.n_rows) * g.taps * 4) * 16;
    }
  }
  return ops > epi ? ops : epi;
}

// A layer's plan for blocks of at most `cap` bytes of shared memory. The
// tile: the 4-warp one (16x8 or 8x16) that computes the fewest pixels
// past the map's edge, 16x8 on a tie; where `wide`, the 8-warp 16x16 tile
// (half the weight staging per pixel) while it computes at most 15 %
// more, the grid still gives each of the `sms` SMs a block, and K has 16
// taps' chunks or more (a single 3x3 chunk stages too little for the
// larger tile to gain); the flat order takes the 4-warp tiles only. The
// channel tile: the widest for Cout (NT 8-channel n-tiles: 1, 2, 4 or 8;
// 12 for Cout 96 where `nt12`) whose shared memory fits, halving from
// there. Two staging buffers where K has more than one chunk and they
// fit. Fills g (geometry, n_rows, stages; the caller sets piece and the
// epilogue's flags) and returns its shared memory in bytes for operands
// of precision `prec`, 0 where no channel tile fits.
inline size_t mma_plan(MmaGeo& g, int B, int H, int W, int cin, int Ho, int Wo, int cout, int k, int stride,
                       int pad_t, int pad_l, int sms, size_t cap, bool wide, bool nt12,
                       MmaPrec prec = MmaPrec::kBf16) {
  const bool flat = mma_flat(cin);
  static const int kShapes[3][2] = {{16, 8}, {8, 16}, {16, 16}};
  auto computed = [&](int s) {
    return static_cast<long long>((Ho + kShapes[s][0] - 1) / kShapes[s][0]) * kShapes[s][0] *
           ((Wo + kShapes[s][1] - 1) / kShapes[s][1]) * kShapes[s][1];
  };
  int pick = computed(1) < computed(0) ? 1 : 0;
  if (wide && !flat && computed(2) * 100 <= computed(pick) * 115 &&
      static_cast<long long>(B) * computed(2) / 256 >= sms && (cin + 15) / 16 * k * k >= 16) {
    pick = 2;
  }
  mma_geometry(g, H, W, cin, Ho, Wo, cout, k, stride, pad_t, pad_l, kShapes[pick][0], kShapes[pick][1]);
  const int n8 = g.npad / 8;
  int nt = n8 <= 1 ? 1 : n8 <= 2 ? 2 : n8 <= 4 ? 4 : (nt12 && n8 == 12) ? 12 : 8;
  for (;;) {
    g.n_rows = nt * 8;
    g.stages = !flat && g.nchunks > 1 ? 2 : 1;
    size_t smem = mma_smem(g, flat, prec);
    if (smem > cap && g.stages == 2) {
      g.stages = 1;
      smem = mma_smem(g, flat, prec);
    }
    if (smem <= cap) return smem;
    if (nt == 1) return 0;
    nt = nt == 12 ? 8 : nt / 2;
  }
}

}  // namespace davo
