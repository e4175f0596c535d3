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
//   conv_layer_gate    the layer's output cotangent as the reference forms
//                      it, dz = (dy + g) * (a_out > 0), once per element,
//                      float32, Cout zero-padded to a multiple of 8: dy the
//                      float32 cotangent from the layer above (absent for
//                      the last layer), g the cotangent of a tap output
//                      (float32 or bf16; absent for an inner layer), the
//                      gate only for a ReLU layer, on the stored a_out;
//   conv_layer_wgrad   dW (k, k, Cin, Cout) and db (Cout) of the layer from
//                      dz, summed over batch and pixels: per-chunk partial
//                      sums, then a fixed-order reduce over the chunks (two
//                      launches, no atomics: two runs give identical bits);
//   conv_layer_dgrad   the input cotangent of one SAME conv layer (any odd
//                      k, stride 1 or 2, Flax's pads) from dz;
//   flow_level_input_bwd  the backward of rowconv.cu's flow_level_input_kernel:
//                      the cost-volume gate (cv > 0) / C, d f1 (taps of f2),
//                      d f2 (the transposed taps of f1, as a gather), and the
//                      feature and flow slices of the estimator input's
//                      cotangent, on shared-memory tiles (its design note
//                      is at the kernel).
//
// Numerics: the reference's backward takes float32 operands and float32
// sums in every mode (unrounded float32 weights; only the chain input's
// cotangent may be rounded, to the input's dtype). Both conv kernels are
// implicit GEMMs on the tensor cores (mma.sync m16n8k8 TF32, float32
// accumulators) in split TF32 (CUTLASS's 3xTF32): each float32 operand is
// v = hi + lo with hi = tf32_rna(v), lo = tf32_rna(v - hi), and a product
// is lo_a hi_b + hi_a lo_b + hi_a hi_b, which leaves ~2^-22 of it (lo*lo
// dropped), against 2^-11 for one TF32 pass. An operand TF32 holds
// exactly needs no lo: wgrad's bf16 activations (2 passes). The split is
// made in registers as each fragment leaves shared memory.
//
// Bound on this card: operations. Each conv kernel does as many FLOPs as
// the layer's forward (2 k k Cin Cout per output pixel), at 494.7 TFLOP/s
// TF32 over 3 passes (2 for wgrad on bf16 activations), ~165 TFLOP/s of
// float32 products. Design:
//   dgrad  M = a block's 128 (or 64) input pixels, N = up to 64 input
//          channels, K = (Cout chunk of 8, tap). At stride 2 the input
//          pixels split into the 4 parity classes of (iy + pad_t, ix +
//          pad_l); a block takes a tile of one class, a stride-1 product
//          over that class's taps only (flipped), so no zero tap is read
//          and no parity test is left in a loop. Per Cout chunk the dz halo
//          of the tile and the class's weights are staged by cp.async,
//          double-buffered, 12 floats a slot (8 used) so that every
//          fragment load is free of bank conflicts. 4 warps: 4 (or 2)
//          along M, 32 pixels each, the rest along N. Where the blocks
//          would not fill the card (small maps, 256-512 channels), K splits
//          over Cout chunks, summed by a fixed-order reduce.
//   wgrad  M = Cout (16 or 32 a block), N = dW's (tap, input channel)
//          columns, K = output pixels: dz is the A operand, so each of its
//          fragments serves every tap. A block owns a Cout slice, up to 36
//          column tiles of 8 (chunks of 8 input channels x taps) and a run
//          of output tiles (split-K, a fixed-order reduce); per tile the
//          input halo and the dz tile are staged by cp.async,
//          double-buffered, and every tap reads the staged halo. Up to 2
//          warps split the column tiles, the others share out the tile's
//          8-pixel k-steps and add their sums in warp order at the end.
//          db comes from the same dz fragments (a product with ones), in
//          the same launch.
// Variants, chosen by shape in kernels/rowconv_ad.py: dgrad's warp tile
// (NT 8-channel n-tiles, 1 and 2 where Cin <= 16) and tile (64 pixels on
// small maps); wgrad's Cout slice (16 for Cout <= 16: the 2-channel flow
// heads and 16-channel layers; 32 otherwise) and, for the first layers
// (Cin 2, 3 and 9: the attention stack's flow, the images, the pose
// input), the flat order, (tap, channel) flattened into its columns, so
// that Cin 3 at k = 7 computes 19 column tiles, not 49 taps' chunks of 8.
// Cout = 2 runs dgrad's K with 6 of 8 channels zero; those layers' FLOPs
// are small. What limits them: mma.sync (not wgmma) at a fraction of its
// rate, the split's ALU work and FP32 adds, scalar fragment loads.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace davo;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSlot = 12;     // floats per staged 8-channel slot of dgrad (8 used): conflict-free loads

__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the low half, first
  return *reinterpret_cast<const unsigned*>(&v);
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

// ------------------------------------------------------------------ split TF32

// tf32_rna, split, mma_tf32 and mma_tf32_fresh are common.cuh's.

// t (+)= a * b in split TF32 on the tensor cores: the three products, the
// small terms first; the middle one only where b has a lo (kBLo); kFresh:
// t starts at zero.
template <bool kBLo, bool kFresh>
__device__ __forceinline__ void mma3(float t[4], const unsigned ahi[4], const unsigned alo[4],
                                     const unsigned bhi[2], const unsigned blo[2]) {
  if constexpr (kFresh) {
    mma_tf32_fresh(t, alo, bhi[0], bhi[1]);
  } else {
    mma_tf32(t, alo, bhi[0], bhi[1]);
  }
  if constexpr (kBLo) mma_tf32(t, ahi, blo[0], blo[1]);
  mma_tf32(t, ahi, bhi[0], bhi[1]);
}

// The tensor cores do not round a sum as the FP32 units do: kept in the
// mma accumulator, a running sum over K = 9 * 512 drifted past the 1e-5
// of the largest element that chip_smoke.py allows (the FMA kernels stayed
// near 1e-6). So the kernels sum the split products of one tap (dgrad) or
// two 8-pixel steps (wgrad) in a fresh accumulator and add it to the
// running sum on the FP32 units, which round to nearest as an FMA loop's
// does. (Timed on the card: two taps a fresh sum made dgrad slower, two
// steps made wgrad faster.)
__device__ __forceinline__ void add4(float c[4], const float t[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// ------------------------------------------------------------------------ gate

// out (pixels, cop) float32 <- dz, channels [cout, cop) zero. vec: cout % 4
// == 0 and the sources aligned, 4 channels a thread.
__global__ void __launch_bounds__(256)
conv_gate_kernel(Cotangent dz, float* __restrict__ out, long long pixels, int cout, int cop, int vec) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    const int q = cop / 4;
    for (long long i = start; i < pixels * q; i += step) {
      const long long p = i / q;
      const int c = static_cast<int>(i - p * q) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (c < cout) dz.at4(p * cout + c, v);
      reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (long long i = start; i < pixels * cop; i += step) {
      const long long p = i / cop;
      const int c = static_cast<int>(i - p * cop);
      out[i] = c < cout ? dz.at(p * cout + c) : 0.0f;
    }
  }
}

// ----------------------------------------------------------------------- dgrad

struct DgradGeo {
  int H, W, cin, Ho, Wo, cop, k, stride, pad_t, pad_l;
  int tile_h, tile_w;    // class pixels of a block's tile (tile_h * tile_w = 32 * wm)
  int wm;                // warps along M (4 or 2); the other 4 / wm along N
  int n_block;           // input channels of a block: NT * 8 * (4 / wm)
  int tiles_y, tiles_x;  // tiles of the largest parity class
  int halo_slots;        // staged dz slots: (tile_h + ceil(k/s) - 1) * (tile_w + ceil(k/s) - 1)
  int max_taps;          // ceil(k/s)^2
  int chunks_per_split;  // Cout chunks of 8 a block sums (all of them unless K is split)
  int dx_bf16, dx_stride;
  long long split_stride;  // elements between the K splits' partial sums
};

// dx (B, H, W, dx_stride), channels [0, cin) <- the input cotangent of a
// layer with weights w (k*k, cin, cop) float32 (Cout zero-padded) from dz
// (B, Ho, Wo, cop). Block (blockIdx.x, blockIdx.y, blockIdx.z): (image,
// parity class, tile), input channels [n_block * blockIdx.y, + n_block),
// K split (Cout chunks [chunks_per_split * blockIdx.z, + chunks_per_split));
// with more than one split, dx is float32 scratch, split z's partial sums
// at z * split_stride, summed in order by dgrad_reduce_kernel.
//
// Parity class (py, px) holds the pixels iy = iy0 + s*j (j < ny), whose
// outputs are read through the taps ky = py + s*my: oy = j + uy - my (and
// the same along x); at stride 1 there is one class, every tap.
template <int NT>
__global__ void __launch_bounds__(kThreads)
conv_dgrad_mma_kernel(const float* __restrict__ dz, const float* __restrict__ w, void* __restrict__ dx,
                      const DgradGeo g) {
  extern __shared__ __align__(16) float smem[];
  const int s = g.stride;
  const int tiles = g.tiles_y * g.tiles_x;
  const int tile = blockIdx.x % tiles;
  const int cls = (blockIdx.x / tiles) % (s * s);
  const int b = blockIdx.x / (tiles * s * s);
  const int py = cls / s, px = cls - (cls / s) * s;
  const int iy0 = ((py - g.pad_t) % s + s) % s, ix0 = ((px - g.pad_l) % s + s) % s;
  const int ny = iy0 < g.H ? (g.H - iy0 + s - 1) / s : 0;
  const int nx = ix0 < g.W ? (g.W - ix0 + s - 1) / s : 0;
  const int j0 = (tile / g.tiles_x) * g.tile_h, i0 = (tile % g.tiles_x) * g.tile_w;
  if (j0 >= ny || i0 >= nx) return;  // the whole block: a tile past a smaller class
  const int uy = (iy0 + g.pad_t - py) / s, ux = (ix0 + g.pad_l - px) / s;
  const int my_n = (g.k - py + s - 1) / s, mx_n = (g.k - px + s - 1) / s;  // the class's taps
  const int taps = my_n * mx_n;
  const int hh = g.tile_h + my_n - 1, hw = g.tile_w + mx_n - 1;  // this class's dz halo
  const int oy_base = j0 + uy - (my_n - 1), ox_base = i0 + ux - (mx_n - 1);
  const int ci0 = blockIdx.y * g.n_block;
  const int stage_floats = (g.halo_slots + g.max_taps * g.n_block) * kSlot;
  const int c_begin = blockIdx.z * g.chunks_per_split;
  const int c_end = min(c_begin + g.chunks_per_split, g.cop / 8);

  // Cout chunk c (channels [8c, 8c + 8)) into buf: the dz halo, slot hy*hw
  // + hx, then the class's weights, slot ti*n_block + n; two 16-byte
  // copies a slot, zeros outside the map and past cin.
  auto stage = [&](float* buf, int c) {
    float* wts = buf + g.halo_slots * kSlot;
    for (int i = threadIdx.x; i < hh * hw * 2; i += kThreads) {
      const int half = i & 1, q = i >> 1;
      const int hy = q / hw, hx = q - hy * hw;
      const int oy = oy_base + hy, ox = ox_base + hx;
      const bool ok = oy >= 0 && oy < g.Ho && ox >= 0 && ox < g.Wo;
      const float* src =
          ok ? dz + ((static_cast<long long>(b) * g.Ho + oy) * g.Wo + ox) * g.cop + c * 8 + half * 4 : dz;
      copy_async16(buf + q * kSlot + half * 4, src, ok);
    }
    for (int i = threadIdx.x; i < taps * g.n_block * 2; i += kThreads) {
      const int half = i & 1, q = i >> 1;
      const int ti = q / g.n_block, n = q - ti * g.n_block;
      const int my = ti / mx_n, mx = ti - my * mx_n;
      const int tap = (py + s * my) * g.k + px + s * mx;
      const bool ok = ci0 + n < g.cin;
      const float* src = ok ? w + (static_cast<long long>(tap) * g.cin + ci0 + n) * g.cop + c * 8 + half * 4 : w;
      copy_async16(wts + q * kSlot + half * 4, src, ok);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm_i = warp % g.wm, nbase = (warp / g.wm) * NT * 8;
  // Halo slot of this lane's pixel rows (gid and gid + 8 of each 16-pixel
  // m-tile) at the class's last tap; tap (my, mx) adds (my_n-1-my)*hw +
  // (mx_n-1-mx). 8 consecutive rows are 8 consecutive slots of one row.
  int slot0[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm_i * 32 + mt * 16 + h * 8 + gid;
      slot0[mt][h] = (r / g.tile_w) * hw + r % g.tile_w;
    }
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  stage(smem, c_begin);
  copy_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    if (c + 1 < c_end) {
      stage(smem + ((c + 1 - c_begin) & 1) * stage_floats, c + 1);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    const float* halo = smem + ((c - c_begin) & 1) * stage_floats;
    const float* wts = halo + g.halo_slots * kSlot;
    for (int ti = 0; ti < taps; ++ti) {
      const int my = ti / mx_n, mx = ti - my * mx_n;
      const int off = (my_n - 1 - my) * hw + (mx_n - 1 - mx);
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p0 = halo + (slot0[mt][0] + off) * kSlot + tig;
        const float* p1 = halo + (slot0[mt][1] + off) * kSlot + tig;
        split(p0[0], ahi[mt][0], alo[mt][0]);
        split(p1[0], ahi[mt][1], alo[mt][1]);
        split(p0[4], ahi[mt][2], alo[mt][2]);
        split(p1[4], ahi[mt][3], alo[mt][3]);
      }
      const float* wt = wts + (ti * g.n_block + nbase + gid) * kSlot + tig;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned bhi[2], blo[2];
        split(wt[nt * 8 * kSlot], bhi[0], blo[0]);
        split(wt[nt * 8 * kSlot + 4], bhi[1], blo[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float t[4];
          mma3<true, true>(t, ahi[mt], alo[mt], bhi, blo);
          add4(acc[mt][nt], t);
        }
      }
    }
    __syncthreads();  // this buffer is staged again two chunks on
  }

  const bool pairs = g.dx_stride % 2 == 0;
  dx = static_cast<char*>(dx) + blockIdx.z * g.split_stride * (g.dx_bf16 ? 2 : 4);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm_i * 32 + mt * 16 + h * 8 + gid;
      const int j = j0 + r / g.tile_w, i = i0 + r % g.tile_w;
      if (j >= ny || i >= nx) continue;
      const long long base =
          ((static_cast<long long>(b) * g.H + iy0 + s * j) * g.W + ix0 + s * i) * g.dx_stride;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int ci = ci0 + nbase + nt * 8 + 2 * tig;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs && ci + 1 < g.cin) {
          if (g.dx_bf16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dx) + base + ci) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(dx) + base + ci) = make_float2(v0, v1);
          }
        } else {
          if (ci < g.cin) store_any(dx, g.dx_bf16, base + ci, v0);
          if (ci + 1 < g.cin) store_any(dx, g.dx_bf16, base + ci + 1, v1);
        }
      }
    }
  }
}

// ----------------------------------------------------------------------- wgrad

struct WgradGeo {
  int H, W, cin, Ho, Wo, cop, cout, k, stride, pad_t, pad_l;
  int tile_h, tile_w;   // output pixels of a tile (tile_w a multiple of 8, 64 or 128 pixels)
  int tiles_x, tiles;   // tiles per image row of tiles, per image
  int total_tiles, tiles_per_chunk;
  int hh, hw, pitch;    // input halo of a tile: (tile_h-1)*s + k rows, (tile_w-1)*s + k columns;
                        // slots per halo row (stride 2 stores even and odd columns apart)
  int hwh;              // stride 2: slots of each column parity
  int wn;               // warps along the column tiles (1, 2 or 4); the other 4 / wn split the k-steps
  int cpb, tpg;         // chunked: chunks of 8 input channels and taps a block covers
  int cc_blocks;        // chunked: blocks along the channel chunks, ceil(ceil(cin / 8) / cpb)
  int slot;             // chunked: staged elements a halo pixel (cpb * 8, padded: conflict-free loads)
  int row_stride;       // staged elements a halo row: pitch * slot (chunked), hw * cin (flat)
  int px_step;          // staged elements from one output pixel's taps to the next's: slot, stride * cin
  int x_stride, x_vec;
  int K;                // k * k * cin
};

// Stride 2 stores a halo row's even columns, then its odd ones, so that 8
// neighbouring output pixels read 8 neighbouring slots at every tap.
__device__ __forceinline__ int halo_col(const WgradGeo& g, int hx) {
  return g.stride == 2 ? (hx & 1) * g.hwh + (hx >> 1) : hx;
}

__device__ __forceinline__ float x_value(const float* xs, int i) { return xs[i]; }
__device__ __forceinline__ float x_value(const unsigned short* xs, int i) { return bf16_bits(xs[i]); }

// Column tiles of one warp: as many as keep its sums at 72 registers.
template <int MT>
struct WgradCols {
  static constexpr int value = 18 / MT;
};

// partial (chunks, K + 1, cout): rows [0, K) dW of this chunk's pixels in
// (k, k, cin) order, row K db. x (B, H, W, x_stride) float32 or bf16, its
// first cin channels the layer's input; dz (B, Ho, Wo, cop). Block
// (blockIdx.x, blockIdx.y, blockIdx.z): Cout slice of 16*MT channels,
// up to wn C column tiles of 8 dW rows (C = 18 / MT), run of output
// tiles. wn warps split the column tiles; the 4 / wn warps of a column
// group split each tile's k-steps (pairs of them in turn) and their sums
// are added in warp order at the end. The columns:
//   chunked (Cin >= 16 or a multiple of 8): blockIdx.y = (tap group of
//     tpg taps) * cc_blocks + (run of cpb chunks of 8 input channels);
//     column tile c is chunk c / taps, tap group's tap c % taps; the halo
//     stages the block's cpb * 8 channels;
//   flat (kFlat; Cin 2, 3, 9: the images' and the pose input's first
//     layers, x_stride == cin): (tap, channel) flattened, column tile c of
//     block y holds rows 8 (4 C y + c) .. + 8; the halo rows are staged as
//     they lie in memory (hw * cin elements, no channel padding, no
//     division).
// A lane's column of each of its tiles is a halo offset, in a register.
template <int MT, typename TX, bool kFlat>
__global__ void __launch_bounds__(kThreads)
conv_wgrad_mma_kernel(const TX* __restrict__ x, const float* __restrict__ dz, float* __restrict__ partial,
                      const WgradGeo g) {
  constexpr bool kSplitX = std::is_same<TX, float>::value;  // bf16 is exact in TF32
  using TS = typename std::conditional<kSplitX, float, unsigned short>::type;
  constexpr int kNco = MT * 16;
  constexpr int kLd = kNco + 8;  // floats per staged dz pixel: conflict-free A loads
  constexpr int kCols = WgradCols<MT>::value;
  extern __shared__ __align__(16) float stages[];
  const int co0 = blockIdx.x * kNco;
  const int s = g.stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  int ci0 = 0, col0 = 0, tap0 = 0, taps = 1, n_cols;
  if constexpr (kFlat) {
    col0 = blockIdx.y * g.wn * kCols;
    n_cols = min(g.wn * kCols, (g.K + 7) / 8 - col0);
  } else {
    ci0 = (blockIdx.y % g.cc_blocks) * g.cpb * 8;
    tap0 = (blockIdx.y / g.cc_blocks) * g.tpg;
    taps = min(g.tpg, g.k * g.k - tap0);
    n_cols = min(g.cpb, (g.cin - ci0 + 7) / 8) * taps;
  }
  const int wk = kWarps / g.wn, phase = warp / g.wn;
  const int per_warp = (n_cols + g.wn - 1) / g.wn;
  const int c_first = (warp % g.wn) * per_warp;
  const int my_cols = max(0, min(per_warp, n_cols - c_first));
  // Staged element of this lane's column (gid) of each of its column
  // tiles, at the tile's first pixel.
  int coff[kCols];
#pragma unroll
  for (int tt = 0; tt < kCols; ++tt) {
    const int c = min(c_first + tt, n_cols - 1);
    int tap, off_c;
    if constexpr (kFlat) {
      const int n = min(8 * (col0 + c) + gid, g.K - 1);  // past K: any column, its rows are not written
      tap = n / g.cin, off_c = n - tap * g.cin;
    } else {
      tap = tap0 + c % taps, off_c = (c / taps) * 8 + gid;
    }
    const int ky = tap / g.k, kx = tap - ky * g.k;
    coff[tt] = kFlat ? ky * g.row_stride + kx * g.cin + off_c
                     : (ky * g.pitch + (s == 2 ? (kx & 1) * g.hwh + (kx >> 1) : kx)) * g.slot + off_c;
  }
  const bool with_db = blockIdx.y == 0 && warp % g.wn == 0;
  const int t_begin = blockIdx.z * g.tiles_per_chunk;
  const int t_end = min(t_begin + g.tiles_per_chunk, g.total_tiles);
  const int px_tile = g.tile_h * g.tile_w;
  const int x_floats = (g.hh * g.row_stride * static_cast<int>(sizeof(TS)) + 15) / 16 * 4;
  const int stage_floats = x_floats + px_tile * kLd;

  auto stage = [&](float* buf, int t) {
    TS* xs = reinterpret_cast<TS*>(buf);
    float* zs = buf + x_floats;
    const int b = t / g.tiles, rem = t - b * g.tiles;
    const int oy0 = (rem / g.tiles_x) * g.tile_h, ox0 = (rem % g.tiles_x) * g.tile_w;
    const int iy0 = oy0 * s - g.pad_t, ix0 = ox0 * s - g.pad_l;
    if constexpr (kFlat) {  // each halo row as it lies in memory
      const int e_lo = max(0, -ix0) * g.cin, e_hi = min(g.hw, g.W - ix0) * g.cin;
      const TS* xe = reinterpret_cast<const TS*>(x);
      for (int hy = 0; hy < g.hh; ++hy) {
        const int iy = iy0 + hy;
        const long long row = ((static_cast<long long>(b) * g.H + iy) * g.W + ix0) * g.cin;
        const bool row_ok = iy >= 0 && iy < g.H;
        for (int e = threadIdx.x; e < g.row_stride; e += kThreads) {
          xs[hy * g.row_stride + e] = row_ok && e >= e_lo && e < e_hi ? __ldg(xe + row + e) : TS(0);
        }
      }
    } else if (g.x_vec) {  // 16-byte units: 4 float32 or 8 bf16 channels
      constexpr int kPer = kSplitX ? 4 : 8;
      const int units = g.cpb * 8 / kPer;
      for (int i = threadIdx.x; i < g.hh * g.hw * units; i += kThreads) {
        const int q = i / units, u = i - q * units;
        const int hy = q / g.hw, hx = q - hy * g.hw;
        const int iy = iy0 + hy, ix = ix0 + hx, ch = ci0 + u * kPer;
        const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && ch < g.x_stride;
        const TX* src = ok ? x + ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.x_stride + ch : x;
        copy_async16(xs + (hy * g.pitch + halo_col(g, hx)) * g.slot + u * kPer, src, ok);
      }
    } else {
      const int cw = g.cpb * 8;
      for (int i = threadIdx.x; i < g.hh * g.hw * cw; i += kThreads) {
        const int q = i / cw, c = i - q * cw;
        const int hy = q / g.hw, hx = q - hy * g.hw;
        const int iy = iy0 + hy, ix = ix0 + hx;
        TS v = 0;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && ci0 + c < g.cin) {
          const long long e = ((static_cast<long long>(b) * g.H + iy) * g.W + ix) * g.x_stride + ci0 + c;
          if constexpr (kSplitX) {
            v = __ldg(x + e);
          } else {
            v = __ldg(reinterpret_cast<const unsigned short*>(x) + e);
          }
        }
        xs[(hy * g.pitch + halo_col(g, hx)) * g.slot + c] = v;
      }
    }
    for (int i = threadIdx.x; i < px_tile * (kNco / 4); i += kThreads) {
      const int u = i % (kNco / 4), r = i / (kNco / 4);
      const int oy = oy0 + r / g.tile_w, ox = ox0 + r % g.tile_w, co = co0 + u * 4;
      const bool ok = oy < g.Ho && ox < g.Wo && co < g.cop;
      const float* src = ok ? dz + ((static_cast<long long>(b) * g.Ho + oy) * g.Wo + ox) * g.cop + co : dz;
      copy_async16(zs + r * kLd + u * 4, src, ok);
    }
  };

  const unsigned one[2] = {0x3f800000u, 0x3f800000u};  // 1.0f, exact in TF32: db = dz x ones
  const unsigned zero[2] = {0u, 0u};

  float acc[kCols][MT][4], acc_db[MT][4];
#pragma unroll
  for (int t = 0; t < kCols; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_db[mt][e] = 0.0f;

  stage(stages, t_begin);
  copy_async_commit();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage(stages + (buf ^ 1) * stage_floats, t + 1);
      copy_async_commit();
      copy_async_wait_group<1>();
    } else {
      copy_async_wait_group<0>();
    }
    __syncthreads();
    const TS* xs = reinterpret_cast<const TS*>(stages + buf * stage_floats);
    const float* zs = stages + buf * stage_floats + x_floats;
    // A warp takes pairs of k-steps (8 pixels of one row each) in turn
    // with the other warps of its column group, a pair into one fresh sum
    // per column tile.
    for (int ks = 2 * phase; ks < px_tile / 8; ks += 2 * wk) {
      unsigned ahi[2][MT][4], alo[2][MT][4];  // A = dz^T: rows Cout (gid, gid + 8), columns pixels (tig, tig + 4)
      const TS* xp[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r0 = (ks + j) * 8;
        const int y = r0 / g.tile_w, x0 = r0 - y * g.tile_w;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* p = zs + (r0 + tig) * kLd + mt * 16 + gid;
          split(p[0], ahi[j][mt][0], alo[j][mt][0]);
          split(p[8], ahi[j][mt][1], alo[j][mt][1]);
          split(p[4 * kLd], ahi[j][mt][2], alo[j][mt][2]);
          split(p[4 * kLd + 8], ahi[j][mt][3], alo[j][mt][3]);
        }
        xp[j] = xs + y * s * g.row_stride + (x0 + tig) * g.px_step;  // B = x: rows pixels, columns gid
      }
      if (with_db) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float t4[4];
          mma3<false, true>(t4, ahi[0][mt], alo[0][mt], one, zero);
          mma3<false, false>(t4, ahi[1][mt], alo[1][mt], one, zero);
          add4(acc_db[mt], t4);
        }
      }
#pragma unroll
      for (int tt = 0; tt < kCols; ++tt) {
        if (tt < my_cols) {
          unsigned bhi[2][2], blo[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const TS* q = xp[j] + coff[tt];
            if constexpr (kSplitX) {
              split(x_value(q, 0), bhi[j][0], blo[j][0]);
              split(x_value(q, 4 * g.px_step), bhi[j][1], blo[j][1]);
            } else {
              bhi[j][0] = __float_as_uint(x_value(q, 0));
              bhi[j][1] = __float_as_uint(x_value(q, 4 * g.px_step));
              blo[j][0] = blo[j][1] = 0u;
            }
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float t4[4];
            mma3<kSplitX, true>(t4, ahi[0][mt], alo[0][mt], bhi[0], blo[0]);
            mma3<kSplitX, false>(t4, ahi[1][mt], alo[1][mt], bhi[1], blo[1]);
            add4(acc[tt][mt], t4);
          }
        }
      }
    }
    __syncthreads();  // this buffer is staged again two tiles on
  }

  // A column group's k-step phases, added in warp order into phase 0.
  if (wk > 1) {
    float* red = stages;  // [warp][tile][mt][e][lane], then [warp][mt][e][lane] for db
    float* red_db = red + kWarps * kCols * MT * 128;
    if (phase > 0) {
#pragma unroll
      for (int tt = 0; tt < kCols; ++tt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(((warp * kCols + tt) * MT + mt) * 4 + e) * 32 + lane] = acc[tt][mt][e];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red_db[((warp * MT + mt) * 4 + e) * 32 + lane] = acc_db[mt][e];
    }
    __syncthreads();
    if (phase > 0) return;
    for (int p = 1; p < wk; ++p) {
      const int w = warp + p * g.wn;
#pragma unroll
      for (int tt = 0; tt < kCols; ++tt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tt][mt][e] += red[(((w * kCols + tt) * MT + mt) * 4 + e) * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_db[mt][e] += red_db[((w * MT + mt) * 4 + e) * 32 + lane];
    }
  }
  // Each phase-0 warp writes its columns: element e of a sum is (Cout gid
  // + 8 (e >= 2), column 2 tig + (e & 1)) of its column tile.
  float* out = partial + static_cast<long long>(blockIdx.z) * (g.K + 1) * g.cout;
#pragma unroll
  for (int tt = 0; tt < kCols; ++tt) {
    if (tt < my_cols) {
      const int c = c_first + tt;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 2 * tig + (e & 1);
        int row;
        if constexpr (kFlat) {
          row = 8 * (col0 + c) + n;
          row = row < g.K ? row : -1;
        } else {
          const int ci = ci0 + (c / taps) * 8 + n;
          row = ci < g.cin ? (tap0 + c % taps) * g.cin + ci : -1;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int co = co0 + mt * 16 + gid + (e >= 2 ? 8 : 0);
          if (co < g.cout && row >= 0) out[static_cast<long long>(row) * g.cout + co] = acc[tt][mt][e];
        }
      }
    }
  }
  if (blockIdx.y == 0 && warp == 0 && tig == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // column 0 of the ones product
        const int co = co0 + mt * 16 + gid + 8 * h;
        if (co < g.cout) out[static_cast<long long>(g.K) * g.cout + co] = acc_db[mt][2 * h];
      }
    }
  }
}

// dx[i] = sum over the K splits z, in order, of partial[z][i], in dx's dtype.
__global__ void __launch_bounds__(256)
dgrad_reduce_kernel(const float* __restrict__ partial, int splits, long long n, void* __restrict__ dx, int dx_bf16) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += __ldg(partial + z * n + i);
  store_any(dx, dx_bf16, i, s);
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

// ------------------------------------------------------------ flow level input

// The backward of flow_level_input_kernel (rowconv.cu). da0 (B, H, W,
// da_stride): the cotangent of the estimator input, channels [0, D) the
// cost volume's, then Cf of feat and Cu of flow_up; a0 (B, H, W,
// a0_stride) float32: the unrounded estimator input, whose channels
// [0, D) are the ReLU'd cost volume. Per shift t (s_t = (t / d - s,
// t % d - s)), g_t(p) = da0[p, t] * (cv[p, t] > 0) * (1 / C):
//   df1[p, c] = sum_t g_t(p) f2[p + s_t, c]
//   df2[p, c] = sum_t g_t(p - s_t) f1[p - s_t, c]
// (a term whose shifted pixel leaves the frame drops out), in ascending t
// with fmaf, each rounded once to f1's dtype; dfeat, dflow: da0's next Cf
// and Cu channels.
//
// Bound on this card: bytes (da0's and a0's first D channels, the maps,
// the outputs; C*D FMAs a pixel and gradient are a few percent of the
// f32 rate's time). Design: #1b's shared-memory tiles (costvol.cu
// cost_volume_bwd_kernel). A block owns an 8x16 tile of pixels and one of
// the two gradients, and walks channel slices of 32: it stages the other
// map's window (the tile grown by s on every side, 0 outside the frame or
// past C) by cp.async, in the map's dtype (bf16 widened in registers; a
// bf16 slot padded after every 4 pixels so that a warp's 4 pixel groups
// fall in alternate halves of the banks), and the tile's D gates, formed
// once per element at staging from da0 and a0 (plain loads: their rows
// are strided and need not be 16-byte aligned): for df1 g_t(p), for df2
// g_t(p - s_t), 0 where the term drops out. The gates stay for every
// slice of the block. Each thread keeps 4 pixels x 4 channels in
// registers over the D shifts and reads shared memory only (#1b's
// register block and shift order). The df1 block of a tile also copies
// the tile's dfeat and dflow, lanes over consecutive elements. A tile
// takes all its slices where the tiles give two blocks per SM, else one
// slice a block (gates staged per slice). Where the whole window and the
// D gates do not fit shared memory (s >= 8 with float32 maps, 9 with
// bf16), a slice walks the d shift rows in passes of `rows`, each staging
// the window rows and the gates that its shift rows read (the tile's
// rows + rows - 1 window rows, 128 x rows*d gates), one slice a block;
// the accumulators carry over the passes, so the sums keep ascending t.
// One shift row a pass fits up to s = 64.
constexpr int kLvlTileH = 8;                     // tile rows, a warp each
constexpr int kLvlTileW = 16;                    // tile columns, 4 groups of kLvlPix
constexpr int kLvlPix = 4;                       // adjacent pixels per thread
constexpr int kLvlSlice = 32;                    // channels per slice, 8 quads
constexpr int kLvlThreads = kLvlTileH * 32;

struct LevelBwd {
  const float* da0;
  const float* a0;
  const void* f1;
  const void* f2;
  void* df1;
  void* df2;
  void* dfeat;
  float* dflow;
  int da_stride, a0_stride, d_bf16, dfeat_bf16;
  int H, W, C, Cf, Cu, s;
  int tiles_x, tiles_y, slices, per_item, groups, row_slots;
  int rows;  // shift rows a pass (d: one pass)
  int vec_in, vec_out;
  long long items;
};

// Window slots a row: bf16 slots (64 bytes) get one of padding after
// every 4 pixels.
__host__ __device__ constexpr int lvl_row_slots(int ww, bool bf16) { return bf16 ? ww + (ww + 3) / 4 : ww; }

template <typename TIn>
__device__ __forceinline__ int lvl_slot(int wx) {
  return sizeof(TIn) == 2 ? wx + (wx >> 2) : wx;
}

__device__ __forceinline__ float4 lvl_quad(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 lvl_quad(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);  // bf16 -> f32: a 16-bit shift
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u), __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}

__device__ __forceinline__ float lvl_gate(const LevelBwd& a, long long pix, int t, float inv_c) {
  const float cv = __ldg(a.a0 + pix * a.a0_stride + t);
  return __ldg(a.da0 + pix * a.da_stride + t) * (cv > 0.0f ? 1.0f : 0.0f) * inv_c;
}

// acc[i][.] += sum over one pass's nr shift rows of gs[pixel i, t] * the
// window at pixel i shifted by +s_t (df1) or -s_t (df2), in ascending t
// per output. `ms` points at the staged window slot of the thread's first
// pixel (its row, the pass's first staged row) and its 4 channels, `gs`
// at that pixel's gates (gd a pixel; shift row r of the pass at r * d).
// kS >= 0: one pass of all d rows.
template <bool kDf1, int kS, typename TIn>
__device__ __forceinline__ void lvl_accumulate(float (&acc)[kLvlPix][4], const TIn* ms, const float* gs, int s_rt,
                                               int nr_rt, int gd_rt, int row_slots) {
  const int s = kS >= 0 ? kS : s_rt;
  const int d = 2 * s + 1;
  const int nr = kS >= 0 ? d : nr_rt, gd = kS >= 0 ? d * d : gd_rt;
  const int span = kLvlPix + 2 * s;  // window pixels one row of shifts reaches
#pragma unroll
  for (int r = 0; r < nr; ++r) {
    // Staged from the pass's first window row: df1 reads row ty + r,
    // df2 row ty + nr - 1 - r.
    const TIn* mrow = ms + (kDf1 ? r : nr - 1 - r) * row_slots * kLvlSlice;
    const float* grow = gs + r * d;
#pragma unroll
    for (int jj = 0; jj < span; ++jj) {
      // Pixel i meets window pixel j at dx = j - i (df1) or i + 2s - j
      // (df2); j runs so that dx rises for every i.
      const int j = kDf1 ? jj : span - 1 - jj;
      const float4 m = lvl_quad(mrow + lvl_slot<TIn>(j) * kLvlSlice);
#pragma unroll
      for (int i = 0; i < kLvlPix; ++i) {
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

// Rows [wr0, wr0 + wh) of the other map's window for channels
// [c0, c0 + kLvlSlice) into `ms`.
template <typename TIn>
__device__ __forceinline__ void lvl_stage_window(TIn* ms, const TIn* __restrict__ map, const LevelBwd& a,
                                                 long long row0, int y0, int x0, int c0, int wr0, int wh) {
  const int s = a.s, ww = kLvlTileW + 2 * s;
  y0 += wr0;
  if (a.vec_in) {
    constexpr int kE = 16 / sizeof(TIn);   // channels a 16-byte unit
    constexpr int kU = kLvlSlice / kE;     // units a pixel's slice
    for (int u = threadIdx.x; u < wh * ww * kU; u += kLvlThreads) {
      const int wp = u / kU, q = u % kU;
      const int wy = wp / ww, wx = wp - wy * ww;
      const int y = y0 - s + wy, x = x0 - s + wx, c = c0 + q * kE;
      const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W && c < a.C;
      copy_async16(ms + (wy * a.row_slots + lvl_slot<TIn>(wx)) * kLvlSlice + q * kE,
                   in ? map + ((row0 + y) * a.W + x) * a.C + c : map, in);
    }
  } else {
    for (int e = threadIdx.x; e < wh * ww * kLvlSlice; e += kLvlThreads) {
      const int wp = e / kLvlSlice, q = e % kLvlSlice;
      const int wy = wp / ww, wx = wp - wy * ww;
      const int y = y0 - s + wy, x = x0 - s + wx, c = c0 + q;
      TIn v{};
      if (y >= 0 && y < a.H && x >= 0 && x < a.W && c < a.C) v = map[((row0 + y) * a.W + x) * a.C + c];
      ms[(wy * a.row_slots + lvl_slot<TIn>(wx)) * kLvlSlice + q] = v;
    }
  }
}

// The tile's gates of shift rows [dy0, dy0 + nr) into gs (tile pixel p,
// shift t = (dy0 + r) * d + dx at gs[p * gd + r * d + dx]): for df1
// g_t(p); for df2 g_t(p - s_t), whose sources, for one tile row and shift
// row, lie on one image row, walked by (window column, dx), dx fastest,
// so that neighbouring threads read runs of d gates. 0 where the term
// drops out. Loads of kLvlBatch elements are issued before any is used
// (branch-free: an element that drops out reads a clamped address).
constexpr int kLvlBatch = 8;

template <int kS>
__device__ __forceinline__ void lvl_stage_gates(float* gs, const LevelBwd& a, bool is_df1, long long row0, int y0,
                                                int x0, float inv_c, int dy0, int nr, int gd) {
  const int s = kS >= 0 ? kS : a.s, d = 2 * s + 1, ww = kLvlTileW + 2 * s;
  if (kS >= 0) nr = d, gd = d * d;
  // df1: e = p * nr * d + r * d + dx; df2: e = ((qy * nr + r) * ww + wx) * d + dx.
  const int n = is_df1 ? kLvlTileH * kLvlTileW * nr * d : kLvlTileH * nr * ww * d;
  for (int e0 = threadIdx.x; e0 < n; e0 += kLvlBatch * kLvlThreads) {
    long long pix[kLvlBatch];
    int t[kLvlBatch], tl[kLvlBatch], dst[kLvlBatch];
    bool in[kLvlBatch];
    float da[kLvlBatch], cv[kLvlBatch];
#pragma unroll
    for (int j = 0; j < kLvlBatch; ++j) {
      const int e = e0 + j * kLvlThreads;
      int y, x, p;
      if (is_df1) {
        p = e / (nr * d);
        tl[j] = e - p * (nr * d);
        t[j] = dy0 * d + tl[j];
        y = y0 + p / kLvlTileW;
        x = x0 + p % kLvlTileW;
        const int sy = y + t[j] / d - s, sx = x + t[j] % d - s;
        in[j] = sy >= 0 && sy < a.H && sx >= 0 && sx < a.W;
      } else {
        const int wx_dx = e % (ww * d), pair = e / (ww * d);
        const int qy = pair / nr, r = pair - qy * nr, dy = dy0 + r;
        const int wx = wx_dx / d, dx = wx_dx - wx * d;
        const int px = wx - 2 * s + dx;
        tl[j] = r * d + dx;
        t[j] = dy * d + dx;
        p = px >= 0 && px < kLvlTileW ? qy * kLvlTileW + px : -1;
        y = y0 + qy + s - dy;
        x = x0 - s + wx;
        in[j] = p >= 0 && y0 + qy < a.H;
      }
      in[j] = in[j] && e < n && y >= 0 && y < a.H && x >= 0 && x < a.W;
      dst[j] = e < n ? p : -1;
      pix[j] = (row0 + min(max(y, 0), a.H - 1)) * a.W + min(max(x, 0), a.W - 1);
      da[j] = __ldg(a.da0 + pix[j] * a.da_stride + t[j]);
      cv[j] = __ldg(a.a0 + pix[j] * a.a0_stride + t[j]);
    }
#pragma unroll
    for (int j = 0; j < kLvlBatch; ++j) {
      if (dst[j] >= 0) gs[dst[j] * gd + tl[j]] = in[j] ? da[j] * (cv[j] > 0.0f ? 1.0f : 0.0f) * inv_c : 0.0f;
    }
  }
}

// One block per (tile, gradient, slice group), grid-stride; kS is the
// search radius when known at compile time (one pass of all d shift
// rows), else -1.
template <int kS, typename TIn>
// Two blocks an SM with float32 maps, three with bf16 (their windows' shared memory).
__global__ void __launch_bounds__(kLvlThreads, sizeof(TIn) == 2 ? 3 : 2)
flow_level_input_bwd_kernel(const __grid_constant__ LevelBwd a) {
  extern __shared__ float4 lvl_smem[];
  const int s = kS >= 0 ? kS : a.s;
  const int d = 2 * s + 1, D = d * d;
  const int rows = kS >= 0 ? d : a.rows, gd = rows * d;
  TIn* ms = reinterpret_cast<TIn*>(lvl_smem);  // window: rows + 7 rows of row_slots slots of kLvlSlice
  float* gs = reinterpret_cast<float*>(ms + (rows + kLvlTileH - 1) * a.row_slots * kLvlSlice);  // 128 x gd gates
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_c = 1.0f / static_cast<float>(a.C);
  for (long long item = blockIdx.x; item < a.items; item += gridDim.x) {
    long long r = item;
    const int group = static_cast<int>(r % a.groups);
    r /= a.groups;
    const bool is_df1 = r % 2 == 0;
    r /= 2;
    const int x0 = static_cast<int>(r % a.tiles_x) * kLvlTileW;
    r /= a.tiles_x;
    const int y0 = static_cast<int>(r % a.tiles_y) * kLvlTileH;
    const long long row0 = (r / a.tiles_y) * a.H;  // b*H
    const TIn* map = static_cast<const TIn*>(is_df1 ? a.f2 : a.f1);
    void* out = is_df1 ? a.df1 : a.df2;
    const int first = group * a.per_item, last = min(a.slices, first + a.per_item);

    // Thread: tile row `warp`, pixels 4*grp .. 4*grp+3, channels c0 + 4*c4 .. +3.
    const int c4 = lane & 7, lx0 = (lane >> 3) * kLvlPix;
    const TIn* mbase = ms + (warp * a.row_slots + lvl_slot<TIn>(lx0)) * kLvlSlice + 4 * c4;
    const float* gbase = gs + (warp * kLvlTileW + lx0) * gd;
    for (int slice = first; slice < last; ++slice) {
      float acc[kLvlPix][4] = {};
      for (int dy0 = 0; dy0 < d; dy0 += rows) {
        const int nr = min(rows, d - dy0);
        // The window rows the pass reads: df1 dy0 .. dy0 + nr + 6; df2
        // 2s - dy0 - nr + 1 .. 2s - dy0 + 7.
        const int wr0 = is_df1 ? dy0 : 2 * s - dy0 - nr + 1;
        __syncthreads();  // every thread is done with the shared memory of the last pass or item
        lvl_stage_window(ms, map, a, row0, y0, x0, slice * kLvlSlice, wr0, nr + kLvlTileH - 1);
        copy_async_commit();
        // One pass: the gates stay for every slice; passes: one slice an item.
        if (slice == first) lvl_stage_gates<kS>(gs, a, is_df1, row0, y0, x0, inv_c, dy0, nr, gd);
        if (is_df1 && group == 0 && slice == first && dy0 == 0) {
          // dfeat and dflow of the tile: per tile row, lanes over its pixels'
          // Cf + Cu channels.
          const int ct = a.Cf + a.Cu, y = y0 + warp;
          if (y < a.H) {
            const long long pix0 = (row0 + y) * a.W + x0;
            const int n = min(kLvlTileW, a.W - x0) * ct;
            for (int e = lane; e < n; e += 32) {
              const int px = e / ct, ch = e - px * ct;
              const long long pix = pix0 + px;
              const float v = __ldg(a.da0 + pix * a.da_stride + D + ch);
              if (ch < a.Cf) {
                store_any(a.dfeat, a.dfeat_bf16, pix * a.Cf + ch, v);
              } else {
                a.dflow[pix * a.Cu + ch - a.Cf] = v;
              }
            }
          }
        }
        copy_async_wait_all();
        __syncthreads();
        if (is_df1) {
          lvl_accumulate<true, kS>(acc, mbase, gbase, s, nr, gd, a.row_slots);
        } else {
          lvl_accumulate<false, kS>(acc, mbase, gbase, s, nr, gd, a.row_slots);
        }
      }
      const int y = y0 + warp, c = slice * kLvlSlice + 4 * c4;
      if (y >= a.H || c >= a.C) continue;
#pragma unroll
      for (int i = 0; i < kLvlPix; ++i) {
        const int x = x0 + lx0 + i;
        if (x >= a.W) break;
        const long long o = ((row0 + y) * a.W + x) * a.C + c;
        if (a.vec_out) {
          if (a.d_bf16) {
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
                make_uint2(pack_bf16x2(acc[i][0], acc[i][1]), pack_bf16x2(acc[i][2], acc[i][3]));
          } else {
            *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c + q < a.C) store_any(out, a.d_bf16, o + q, acc[i][q]);
          }
        }
      }
    }
  }
}

int grid_for(long long work) {
  const long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

template <int NT>
cudaError_t launch_dgrad(const float* dz, const float* w, void* dx, int B, const DgradGeo& g, cudaStream_t s) {
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  int smem_max = 0, sms = 0;
  err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * static_cast<size_t>(g.halo_slots + g.max_taps * g.n_block) * kSlot * sizeof(float);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  static int granted[kMaxDevices] = {};
  err = allow_smem(conv_dgrad_mma_kernel<NT>, device, smem, granted);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(B) * g.stride * g.stride * g.tiles_y * g.tiles_x;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int splits = (g.cop / 8 + g.chunks_per_split - 1) / g.chunks_per_split;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>((g.cin + g.n_block - 1) / g.n_block),
                  static_cast<unsigned>(splits));
  conv_dgrad_mma_kernel<NT><<<grid, kThreads, smem, s>>>(dz, w, dx, g);
  return cudaGetLastError();
}

template <int MT, typename TX, bool kFlat>
cudaError_t launch_wgrad(const void* x, const float* dz, float* partial, int chunks, const WgradGeo& g,
                         cudaStream_t s) {
  int device = 0;
  cudaError_t err = current_device(&device);
  if (err != cudaSuccess) return err;
  int smem_max = 0, sms = 0;
  err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  const size_t x_bytes = (static_cast<size_t>(g.hh) * g.row_stride * sizeof(TX) + 15) / 16 * 16;
  const size_t stages = 2 * (x_bytes + static_cast<size_t>(g.tile_h) * g.tile_w * (MT * 16 + 8) * sizeof(float));
  const size_t reduce = g.wn < kWarps ? static_cast<size_t>(kWarps) * (WgradCols<MT>::value + 1) * MT * 128 * 4 : 0;
  const size_t smem = stages > reduce ? stages : reduce;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  static int granted[kMaxDevices] = {};
  err = allow_smem(conv_wgrad_mma_kernel<MT, TX, kFlat>, device, smem, granted);
  if (err != cudaSuccess) return err;
  const int cols = g.wn * WgradCols<MT>::value;
  const int blocks_y = kFlat ? ((g.K + 7) / 8 + cols - 1) / cols
                             : g.cc_blocks * ((g.k * g.k + g.tpg - 1) / g.tpg);
  if (blocks_y > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((g.cop + MT * 16 - 1) / (MT * 16)), static_cast<unsigned>(blocks_y),
                  static_cast<unsigned>(chunks));
  conv_wgrad_mma_kernel<MT, TX, kFlat><<<grid, kThreads, smem, s>>>(static_cast<const TX*>(x), dz, partial, g);
  return cudaGetLastError();
}

template <typename TX, bool kFlat>
cudaError_t dispatch_wgrad(int mt, const void* x, const float* dz, float* partial, int chunks, const WgradGeo& g,
                           cudaStream_t s) {
  return mt == 2 ? launch_wgrad<2, TX, kFlat>(x, dz, partial, chunks, g, s)
                 : launch_wgrad<1, TX, kFlat>(x, dz, partial, chunks, g, s);
}

}  // namespace

extern "C" {

// dz (B, Ho, Wo, cop) float32 <- (dy + g) * (a > 0), channels [cout, cop)
// zero. dy: float32 cotangent from the layer above or null; g (g_bf16):
// tap cotangent or null; a (a_bf16): the layer's output, read when relu;
// all (B, Ho, Wo, cout). cop: cout rounded up to a multiple of 8.
int davo_conv_gate(const float* dy, const void* g, int g_bf16, const void* a, int a_bf16, int relu, float* dz,
                   int B, int Ho, int Wo, int cout, int cop, void* stream) {
  const long long pixels = static_cast<long long>(B) * Ho * Wo;
  if (pixels <= 0 || cout <= 0 || cop < cout || cop % 8 != 0 || (dy == nullptr && g == nullptr) ||
      (relu && a == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Cotangent cot{dy, g, g_bf16, a, a_bf16, relu};
  const int vec = cout % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(g) % (g_bf16 ? 8 : 16) == 0 &&
                  reinterpret_cast<uintptr_t>(a) % (a_bf16 ? 8 : 16) == 0 &&
                  reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  conv_gate_kernel<<<grid_for(pixels * cop / (vec ? 4 : 1)), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      cot, dz, pixels, cout, cop, vec);
  return cudaGetLastError();
}

// The input cotangent of one layer. dz (B, Ho, Wo, cop) from
// davo_conv_gate; w (k*k, cin, cop) float32, the unrounded weights with
// Cout zero-padded to cop. dx (B, H, W, cin), in bf16 when dx_bf16. The
// launch (kernels/rowconv_ad.py dgrad_plan): nt 8-channel n-tiles a warp
// (1, 2, 4 or 8), wm warps along M (4: tiles of 128 class pixels, 2: of
// 64), tile_h x tile_w class pixels (tile_w a multiple of 8), and splits
// of K (Cout chunks), each summing its share into partial (splits * B*H*W
// * cin floats; unused for 1), then one fixed-order reduce into dx.
// Returns a cudaError_t.
int davo_conv_dgrad(const float* dz, const float* w, void* dx, int dx_bf16, float* partial, int splits, int B,
                    int H, int W, int cin, int Ho, int Wo, int cop, int k, int stride, int pad_t, int pad_l,
                    int nt, int wm, int tile_h, int tile_w, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || Ho <= 0 || Wo <= 0 || cop <= 0 || cop % 8 != 0 || k <= 0 ||
      (stride != 1 && stride != 2) || pad_t < 0 || pad_l < 0 || (wm != 4 && wm != 2) || tile_w <= 0 ||
      tile_w % 8 != 0 || tile_h * tile_w != 32 * wm || splits <= 0 || splits > cop / 8 || splits > 65535 ||
      (splits > 1 && partial == nullptr) || reinterpret_cast<uintptr_t>(dz) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  DgradGeo g;
  g.H = H, g.W = W, g.cin = cin, g.Ho = Ho, g.Wo = Wo, g.cop = cop, g.k = k, g.stride = stride;
  g.pad_t = pad_t, g.pad_l = pad_l, g.tile_h = tile_h, g.tile_w = tile_w, g.wm = wm;
  g.n_block = nt * 8 * (4 / wm);
  const int per = (k + stride - 1) / stride;
  g.tiles_y = ((H + stride - 1) / stride + tile_h - 1) / tile_h;
  g.tiles_x = ((W + stride - 1) / stride + tile_w - 1) / tile_w;
  g.halo_slots = (tile_h + per - 1) * (tile_w + per - 1);
  g.max_taps = per * per;
  g.chunks_per_split = (cop / 8 + splits - 1) / splits;
  splits = (cop / 8 + g.chunks_per_split - 1) / g.chunks_per_split;
  const long long n = static_cast<long long>(B) * H * W * cin;
  g.dx_bf16 = splits > 1 ? 0 : dx_bf16, g.dx_stride = cin, g.split_stride = n;
  void* out = splits > 1 ? static_cast<void*>(partial) : dx;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nt) {
    case 8: err = launch_dgrad<8>(dz, w, out, B, g, s); break;
    case 4: err = launch_dgrad<4>(dz, w, out, B, g, s); break;
    case 2: err = launch_dgrad<2>(dz, w, out, B, g, s); break;
    case 1: err = launch_dgrad<1>(dz, w, out, B, g, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  dgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, splits, n, dx, dx_bf16);
  return cudaGetLastError();
}

// dW and db of one layer: out (K + 1, cout) float32 with K = k*k*cin,
// rows [0, K) dW in (k, k, cin) order and row K db. x (x_bf16): the
// layer's input (B, H, W, x_stride), first cin channels. dz (B, Ho, Wo,
// cop) from davo_conv_gate. partial: scratch of chunks * (K + 1) * cout
// floats. The launch (kernels/rowconv_ad.py wgrad_plan): mt 16-channel
// Cout tiles a block (1 or 2); wn warps along the column tiles (1, 2 or
// 4, each 18 / mt of them); flat (Cin < 16: (tap, channel) flattened), or
// cpb chunks of 8 input channels and tpg taps a block (cpb * tpg <= wn *
// 18 / mt); output tiles of tile_h x tile_w pixels (tile_w a multiple of
// 8, 64 or 128 pixels), tiles_per_chunk of them a chunk, chunks = ceil(B
// * tiles per image / tiles_per_chunk).
int davo_conv_wgrad(const void* x, int x_bf16, int x_stride, const float* dz, float* partial, int chunks,
                    int tiles_per_chunk, float* out, int B, int H, int W, int cin, int Ho, int Wo, int cout,
                    int cop, int k, int stride, int pad_t, int pad_l, int mt, int flat, int wn, int cpb,
                    int tpg, int tile_h, int tile_w, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || cin <= 0 || cout <= 0 || cop < cout ||
      cop % 8 != 0 || k <= 0 || x_stride < cin || (stride != 1 && stride != 2) || pad_t < 0 || pad_l < 0 ||
      (mt != 1 && mt != 2) || (wn != 1 && wn != 2 && wn != 4) || (flat && (cin >= 16 || x_stride != cin)) ||
      (!flat && (cpb <= 0 || tpg <= 0 || tpg > k * k || cpb * tpg > wn * 18 / mt)) || tile_h <= 0 ||
      tile_w <= 0 || tile_w % 8 != 0 || (tile_h * tile_w) % 64 != 0 || tile_h * tile_w > 128 ||
      tiles_per_chunk <= 0 || chunks <= 0 || chunks > 65535 || reinterpret_cast<uintptr_t>(dz) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  WgradGeo g;
  g.H = H, g.W = W, g.cin = cin, g.Ho = Ho, g.Wo = Wo, g.cop = cop, g.cout = cout, g.k = k;
  g.stride = stride, g.pad_t = pad_t, g.pad_l = pad_l, g.tile_h = tile_h, g.tile_w = tile_w;
  g.tiles_x = (Wo + tile_w - 1) / tile_w;
  g.tiles = g.tiles_x * ((Ho + tile_h - 1) / tile_h);
  const long long total = static_cast<long long>(B) * g.tiles;
  if (total > INT_MAX || chunks != (total + tiles_per_chunk - 1) / tiles_per_chunk) return cudaErrorInvalidValue;
  g.total_tiles = static_cast<int>(total), g.tiles_per_chunk = tiles_per_chunk;
  g.hh = (tile_h - 1) * stride + k;
  g.hw = (tile_w - 1) * stride + k;
  g.hwh = (g.hw + 1) / 2;
  g.pitch = stride == 2 ? 2 * g.hwh : g.hw;
  g.K = k * k * cin;
  g.wn = wn, g.cpb = flat ? 1 : cpb, g.tpg = flat ? 1 : tpg;
  g.cc_blocks = ((cin + 7) / 8 + g.cpb - 1) / g.cpb;
  // cpb * 8 channels a slot, 8 more where that is a multiple of 16: then
  // lanes tig = 0..3 of a fragment load fall in distinct banks.
  g.slot = g.cpb * 8 + (g.cpb % 2 == 0 ? 8 : 0);
  g.row_stride = flat ? g.hw * cin : g.pitch * g.slot;
  g.px_step = flat ? stride * cin : g.slot;
  g.x_stride = x_stride;
  g.x_vec = !flat && x_stride % (x_bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_bf16) {
    err = flat ? dispatch_wgrad<__nv_bfloat16, true>(mt, x, dz, partial, chunks, g, s)
               : dispatch_wgrad<__nv_bfloat16, false>(mt, x, dz, partial, chunks, g, s);
  } else {
    err = flat ? dispatch_wgrad<float, true>(mt, x, dz, partial, chunks, g, s)
               : dispatch_wgrad<float, false>(mt, x, dz, partial, chunks, g, s);
  }
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(g.K + 1) * cout;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(partial, chunks, n, out);
  return cudaGetLastError();
}

// The backward of davo_flow_level_input. f1, f2 (in_bf16): (B, H, W, C);
// da0: (B, H, W, da_stride) float32; a0: (B, H, W, a0_stride) float32.
// Writes df1, df2 (B, H, W, C) in f1's dtype, dfeat (B, H, W, Cf) in bf16
// when dfeat_bf16, dflow (B, H, W, Cu) float32, in one launch, for any
// search up to 64. Returns a cudaError_t.
int davo_flow_level_input_bwd(const float* da0, int da_stride, const float* a0, int a0_stride,
                              const void* f1, const void* f2, int in_bf16, void* df1, void* df2,
                              void* dfeat, int dfeat_bf16, float* dflow, int B, int H, int W,
                              int C, int Cf, int Cu, int search, void* stream) {
  const long long pixels = static_cast<long long>(B) * H * W;
  const int D = (2 * search + 1) * (2 * search + 1);
  if (pixels <= 0 || C <= 0 || search < 0 || search > 64 || Cf < 0 || Cu < 0 || a0_stride < D ||
      da_stride < D + Cf + Cu || pixels > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  int device = 0, smem_max = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = device_limits(device, &smem_max, &sms);
  if (err != cudaSuccess) return err;
  LevelBwd a{};
  a.da0 = da0, a.a0 = a0, a.f1 = f1, a.f2 = f2, a.df1 = df1, a.df2 = df2, a.dfeat = dfeat, a.dflow = dflow;
  a.da_stride = da_stride, a.a0_stride = a0_stride, a.d_bf16 = in_bf16, a.dfeat_bf16 = dfeat_bf16;
  a.H = H, a.W = W, a.C = C, a.Cf = Cf, a.Cu = Cu, a.s = search;
  a.tiles_x = (W + kLvlTileW - 1) / kLvlTileW;
  a.tiles_y = (H + kLvlTileH - 1) / kLvlTileH;
  a.slices = (C + kLvlSlice - 1) / kLvlSlice;
  const int d = 2 * search + 1;
  const size_t elem = in_bf16 ? 2 : 4;
  a.row_slots = lvl_row_slots(kLvlTileW + 2 * search, in_bf16);
  // The most shift rows a pass whose window rows and gates fit.
  const auto smem_for = [&](int rows) {
    return static_cast<size_t>(rows + kLvlTileH - 1) * a.row_slots * kLvlSlice * elem +
           static_cast<size_t>(kLvlTileH) * kLvlTileW * rows * d * sizeof(float);
  };
  a.rows = d;
  while (a.rows > 1 && smem_for(a.rows) > static_cast<size_t>(smem_max)) --a.rows;
  const size_t smem = smem_for(a.rows);
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  const long long blocks2 = 2LL * B * a.tiles_y * a.tiles_x;  // (tile, gradient) pairs
  a.per_item = a.rows == d && blocks2 >= 2LL * sms ? a.slices : 1;
  a.groups = (a.slices + a.per_item - 1) / a.per_item;
  a.items = blocks2 * a.groups;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.vec_in = C % static_cast<int>(16 / elem) == 0 && aligned(f1) && aligned(f2);
  a.vec_out = C % 4 == 0 && aligned(df1) && aligned(df2);
  const bool s4 = search == 4 && a.rows == d;  // the davo levels' radius, in one pass
  void (*kernel)(LevelBwd);
  if (in_bf16) {
    kernel = s4 ? &flow_level_input_bwd_kernel<4, __nv_bfloat16> : &flow_level_input_bwd_kernel<-1, __nv_bfloat16>;
  } else {
    kernel = s4 ? &flow_level_input_bwd_kernel<4, float> : &flow_level_input_bwd_kernel<-1, float>;
  }
  static int granted[2][2][kMaxDevices] = {};
  err = allow_smem(kernel, device, smem, granted[in_bf16 != 0][s4]);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(a.items < (1LL << 20) ? a.items : (1LL << 20));
  kernel<<<grid, kLvlThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* davo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
