"""Fused conv chains of the training path: autograd Functions around the
fused kernels, the hand-written backward kernels
(`csrc/rowconv_bwd.cu`) and their plain versions.

Three functions, each the counterpart of a TPU kernel pair of
`davo_tpu/kernels/rowconv.py` with a hand-written VJP:

- `conv_chain_strided_ad` (TPU `conv_chain_strided_ad`, :1390): the
  mixed-stride chain of `rowconv.conv_chain_strided`, with per-tap
  cotangents added as the reverse sweep passes each tap layer;
- `conv_chain_nhwc_ad` (TPU `conv_chain_nhwc_ad`, :824): the stride-1
  3x3 chain of `rowconv.conv_chain_nhwc`;
- `flow_level_fused_ad` (TPU `flow_level_fused_ad`, :1059): the flow
  level of `rowconv.flow_level_fused`, its backward ending in the cost
  volume's transpose to both feature maps.

The forward runs the serving kernels of `rowconv.py` (one launch per
layer) and keeps every layer's output, and for a flow level the float32
estimator input. The backward launches, per layer from the last,
`conv_layer_gate` (the layer's output cotangent, once per element),
`conv_layer_wgrad` (dW, db) and `conv_layer_dgrad` (the input's
cotangent), then for a flow level `flow_level_input_bwd`. The two conv
kernels are implicit GEMMs on the tensor cores in split TF32 (each
float32 operand hi + lo, three TF32 products; `csrc/rowconv_bwd.cu`), so
their products keep float32 accuracy; `dgrad_plan` and `wgrad_plan` choose
their variant and tiles by shape.

The backward is the reference's, which is not autograd of the forward
in bf16: products with the unrounded float32 weights, float32 cotangents
between layers, each ReLU gated on the stored activation (a_out > 0),
the flow level's first dW taken from the float32 estimator input (the
forward ran the chain on it rounded), and only the chain input's
cotangent rounded, to the input's dtype. The `*_bwd_plain` functions
write that out.

Under no grad (or when no input requires one) each function runs the
serving wrapper and saves nothing. Otherwise CUDA tensors launch the
kernels or raise, and CPU tensors run the plain versions. The modes are
"float32" and "bfloat16": the reference's backward has no "bf16_dot"
(its dtype table lacks it), so that mode raises under autograd.
`launches` / `backward_launches` count forward / backward calls that
launched, `device_launches` the kernels they launched (the forward's
layers under the function's name, the backward kernels under their
own), `variant_launches` the conv kernels' launches by variant; the plain
versions never count.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from davo_tpu_torch.kernels import cuda_build, rowconv
from davo_tpu_torch.kernels.costvol import cost_volume_plain
from davo_tpu_torch.models.common import same_pads

TRAIN_MODES = ("float32", "bfloat16")
_NAMES = ("flow_level_fused_ad", "conv_chain_strided_ad", "conv_chain_nhwc_ad")
KERNELS = ("conv_layer_gate", "conv_layer_wgrad", "conv_layer_dgrad", "flow_level_input_bwd")
launches = dict.fromkeys(_NAMES, 0)
backward_launches = dict.fromkeys(_NAMES, 0)
device_launches = dict.fromkeys(_NAMES + KERNELS, 0)
# Launches of each conv kernel variant, by its template instance's name
# (as a profile names it): conv_dgrad_mma_kernel<nt>,
# conv_wgrad_mma_kernel<mt, x dtype, flat>.
variant_launches: dict[str, int] = {}


def reset_counts() -> None:
    for counts in (launches, backward_launches, device_launches):
        for name in counts:
            counts[name] = 0
    variant_launches.clear()


# --------------------------------------------------------------- plain versions
#
# They sum in float32, as the kernels, or in float64 when given float64
# cotangents: the precision of a reference against which the kernels'
# own float32 rounding can be measured (chip_smoke.py phase 3e).


def _sum_dtype(t):
    return torch.promote_types(t.dtype, torch.float32)


def _gate_plain(dy, g, a_out, relu):
    """The layer's output cotangent as the reference forms it:
    (dy + g) * (a_out > 0), in the sum dtype; dy or g may be None."""
    dz = dy if g is None else (g.to(_sum_dtype(g)) if dy is None else dy + g.to(dy.dtype))
    return dz * (a_out > 0).to(dz.dtype) if relu else dz


def _pads(h, w, k, stride):
    (top, bottom), (left, right) = same_pads(h, k, stride), same_pads(w, k, stride)
    return top, bottom, left, right


def _dgrad_plain(dz, w, x_shape, stride, accumulate=None):
    """dx of a SAME layer, in dz's dtype; `accumulate` (float64) sums in
    that dtype and rounds once to dz's."""
    B, H, W, cin = x_shape
    acc = accumulate or dz.dtype
    top, bottom, left, right = _pads(H, W, w.shape[-1], stride)
    dxp = torch.nn.grad.conv2d_input(
        (B, cin, H + top + bottom, W + left + right), w.to(acc), dz.permute(0, 3, 1, 2).to(acc), stride=stride
    )
    return dxp[:, :, top : top + H, left : left + W].to(dz.dtype).permute(0, 2, 3, 1)


def _wgrad_plain(x, dz, w_shape, stride, accumulate=None):
    """(dW, db) of a SAME layer, in dz's dtype; `accumulate` (float64)
    forms dW in that dtype and rounds once."""
    k = w_shape[-1]
    acc = accumulate or dz.dtype
    top, bottom, left, right = _pads(x.shape[1], x.shape[2], k, stride)
    xp = F.pad(x.to(acc).permute(0, 3, 1, 2), (left, right, top, bottom))
    dw = torch.nn.grad.conv2d_weight(xp, w_shape, dz.permute(0, 3, 1, 2).to(acc), stride=stride)
    return dw.to(dz.dtype), dz.sum((0, 1, 2))


def conv_layer_dgrad_plain(dy, g, a_out, relu, w, x_shape, stride):
    """The plain version of `conv_layer_dgrad`: the input cotangent
    (B, H, W, Cin) float32 of a SAME layer with OIHW weights `w` (used
    unrounded) on an input of `x_shape`, from the output cotangent
    (dy + g) * (a_out > 0)."""
    return _dgrad_plain(_gate_plain(dy, g, a_out, relu), w, x_shape, stride)


def conv_layer_wgrad_plain(x, dy, g, a_out, relu, w_shape, stride):
    """The plain version of `conv_layer_wgrad`: (dW in the OIHW `w_shape`,
    db), float32, of a layer on input x (read as float32)."""
    return _wgrad_plain(x, _gate_plain(dy, g, a_out, relu), w_shape, stride)


def conv_chain_bwd_plain(x, acts, weights, strides, relus, taps, gs, need_dx=True):
    """The reverse sweep of `_strided_bwd_kernel` / `_run_3x3_chain_bwd`.

    x: the chain input (its first Cin channels, read as float32); acts:
    every layer's stored output; gs: the cotangents of the layers in
    `taps`, added as the sweep passes them. Returns (dx float32, or None
    without need_dx; dW per layer, OIHW; db per layer), or float64 for
    float64 cotangents."""
    n = len(weights)
    dws, dbs = [None] * n, [None] * n
    dy = None
    for layer in reversed(range(n)):
        w, stride = weights[layer], strides[layer]
        g = gs[taps.index(layer)] if layer in taps else None
        dz = _gate_plain(dy, g, acts[layer], relus[layer])
        a_in = (x if layer == 0 else acts[layer - 1])[..., : w.shape[1]]
        dws[layer], dbs[layer] = _wgrad_plain(a_in, dz, w.shape, stride)
        dy = _dgrad_plain(dz, w, a_in.shape, stride) if layer or need_dx else None
    return dy, dws, dbs


def flow_level_input_bwd_plain(f1, f2, a0, da0, search, cf, cu):
    """The plain version of `flow_level_input_bwd`, as
    `_flow_level_bwd_kernel`: (d f1, d f2, d feat, d flow_up), float32,
    from the estimator input's cotangent da0 and the float32 estimator
    input a0 (its first D channels the ReLU'd cost volume); float64 for
    a float64 da0."""
    B, H, W, C = f1.shape
    d = 2 * search + 1
    D = d * d
    gate = da0[..., :D] * (a0[..., :D] > 0).to(da0.dtype) * (1.0 / C)
    f1, f2 = f1.to(da0.dtype), f2.to(da0.dtype)
    f2p = F.pad(f2, (0, 0, search, search, search, search))
    df1 = torch.zeros_like(f1)
    df2p = torch.zeros_like(f2p)
    for dy in range(d):
        for dx in range(d):
            gk = gate[..., dy * d + dx, None]
            df1 = df1 + gk * f2p[:, dy : dy + H, dx : dx + W]
            df2p[:, dy : dy + H, dx : dx + W] += gk * f1
    df2 = df2p[:, search : search + H, search : search + W]
    return df1, df2, da0[..., D : D + cf], da0[..., D + cf : D + cf + cu]


def flow_level_bwd_plain(f1, f2, a0, acts, weights, relus, g, search, cf):
    """The plain backward of a flow level (`_flow_level_bwd_kernel`): the
    chain's sweep from the output cotangent g down to the float32
    estimator input a0, then its cost-volume, feature and flow parts.
    Returns (d f1, d f2, d feat, d flow_up, dW list, db list), float32."""
    n = len(weights)
    da0, dws, dbs = conv_chain_bwd_plain(a0, acts, weights, (1,) * n, relus, (n - 1,), [g])
    cu = weights[0].shape[1] - (2 * search + 1) ** 2 - cf
    return (*flow_level_input_bwd_plain(f1, f2, a0, da0, search, cf, cu), dws, dbs)


def level_input_plain(f1, f2, feat, flow_up, search):
    """The flow level's float32 estimator input: relu(cost volume) ++
    feat ++ flow_up, unrounded."""
    cv = torch.relu(cost_volume_plain(f1.float(), f2.float(), search))
    return torch.cat([cv, feat.float(), flow_up.float()], -1)


# --------------------------------------------------------------------- kernels


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of `csrc/rowconv_bwd.cu` (each returns a cudaError_t).
SIGNATURES = {
    "davo_conv_gate": [_P, _P, _I, _P, _I, _I, _P] + [_I] * 5 + [_P],
    "davo_conv_dgrad": [_P, _P, _P, _I, _P] + [_I] * 16 + [_P],
    "davo_conv_wgrad": [_P, _I, _I, _P, _P, _I, _I, _P] + [_I] * 19 + [_P],
    "davo_flow_level_input_bwd": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P] + [_I] * 7 + [_P],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/rowconv_bwd.cu`) with `SIGNATURES` set."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    lib.davo_cuda_error_string.argtypes = [_I]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("rowconv_bwd"))


def _raise_if(err: int, what: str) -> None:
    if err:
        msg = _library().davo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flag(t, what):
    return 0 if t is None else rowconv._bf16_flag(t, what)


def _cotangent_args(dy, g, a_out, relu):
    """(dy, g, g_bf16, a, a_bf16, relu) for the C side; dy float32."""
    if dy is not None and (dy.dtype != torch.float32 or not dy.is_contiguous()):
        raise ValueError("the inter-layer cotangent must be contiguous float32")
    a_out = a_out if relu else None
    return (_ptr(dy), _ptr(g), _flag(g, "tap cotangent"), _ptr(a_out), _flag(a_out, "activation"),
            int(bool(relu)))


def _count_variant(name: str, variants: dict[str, int]) -> None:
    variants[name] = variants.get(name, 0) + 1


def padded_cout(cout: int) -> int:
    """Channels of conv_layer_gate's dz: Cout rounded up to a multiple of 8
    (zeros), the two conv kernels' 8-channel slots."""
    return -(-cout // 8) * 8


# Shared memory a block may opt into on an H100 (227 KB), the plans'
# default cap; on the card the launchers pass the device's own
# (`device_limits`).
SMEM_OPTIN = 227 * 1024
INT_MAX = 2**31 - 1


@functools.cache
def _cuda_limits(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)


def device_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, bytes of shared memory a block may opt into) of a CUDA
    device, the plans' `sms` and `smem_max`; an H100's (132, SMEM_OPTIN),
    the plans' defaults, for any other device."""
    if device.type != "cuda":
        return 132, SMEM_OPTIN
    return _cuda_limits(torch.cuda.current_device() if device.index is None else device.index)


def _refuse_if(refused: bool, kernel: str, B, H, W, cin, cout, k, stride) -> None:
    if refused:
        raise ValueError(f"{kernel} takes no layer of input (B, H, W, Cin) = {(B, H, W, cin)}, Cout={cout}, "
                         f"k={k}, stride={stride}")


# The layer kernel's tiles (`mma_plan`, csrc/conv_mma.cuh): 4 warps of
# 16x8 or 8x16 pixels, or 8 warps of 16x16.
LAYER_TILES = ((16, 8), (8, 16), (16, 16))


def layer_plan(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int, sms: int = 132,
               smem_max: int = SMEM_OPTIN, x_bf16: bool = False) -> tuple[int, int, int, int, int]:
    """The float32 layer kernel's launch (`davo_conv_layer_tf32`: the host
    checks of `conv_layer_mma` and `mma_plan` with `wide`, split-TF32
    operands, the halo in hi and lo planes for a float32 input, one plane
    for a bf16 one) for an input of B x H x W x cin: (tile_h, tile_w, nt,
    stages, shared memory bytes). The tile: 16x8, or 8x16 where it
    computes fewer pixels past the map's edge; 16x16 where that computes at
    most 15 % more, still gives every SM a block and K has 16 taps' chunks
    or more (chunked order only, Cin >= 16). nt: the widest channel tile
    for Cout (1, 2, 4 or 8 n-tiles of 8), halving until the shared memory
    fits `smem_max`, with two staging buffers where K has more than one
    chunk and they fit. Raises ValueError naming the shape where the
    launcher returns cudaErrorInvalidValue: an even k, a stride other than
    1 or 2, no channel tile that fits, a grid past INT_MAX blocks."""
    ho, wo = -(-H // stride), -(-W // stride)
    _refuse_if(min(B, H, W, cin, cout, k) <= 0 or k % 2 == 0 or stride not in (1, 2),
               "conv_layer_tf32", B, H, W, cin, cout, k, stride)
    flat = not rowconv.mma_chunked(cin)

    def computed(tile):
        return -(-ho // tile[0]) * tile[0] * -(-wo // tile[1]) * tile[1]

    th, tw = LAYER_TILES[1] if computed(LAYER_TILES[1]) < computed(LAYER_TILES[0]) else LAYER_TILES[0]
    nchunks, taps = -(-cin // 16), k * k
    if (not flat and computed(LAYER_TILES[2]) * 100 <= computed((th, tw)) * 115
            and B * computed(LAYER_TILES[2]) // 256 >= sms and nchunks * taps >= 16):
        th, tw = LAYER_TILES[2]
    hh, hw = (th - 1) * stride + k, (tw - 1) * stride + k
    hws = 2 * -(-hw // 2) if stride == 2 else hw
    kp = -(-(taps * cin) // 16) * 16
    a_planes = 1 if x_bf16 else 2

    def smem(n_rows, stages):
        epi = th * tw * (n_rows + 4) * 4
        if flat:
            ops = 2 * n_rows * (kp // 4 + 1) * 16 + kp * 4 + a_planes * hh * hw * cin * 4
        else:
            ops = stages * (a_planes * hh * hws * 4 + 2 * n_rows * taps * 4) * 16
        return max(ops, epi)

    n8 = -(-cout // 8)
    nt = 1 if n8 <= 1 else 2 if n8 <= 2 else 4 if n8 <= 4 else 8
    while True:
        stages = 2 if not flat and nchunks > 1 else 1
        if smem(nt * 8, stages) > smem_max and stages == 2:
            stages = 1
        if smem(nt * 8, stages) <= smem_max:
            break
        _refuse_if(nt == 1, "conv_layer_tf32", B, H, W, cin, cout, k, stride)
        nt //= 2
    _refuse_if(B * -(-ho // th) * -(-wo // tw) > INT_MAX, "conv_layer_tf32", B, H, W, cin, cout, k, stride)
    return th, tw, nt, stages, smem(nt * 8, stages)


# conv_layer_dgrad's tiles of class pixels, by warps along M: 4 warps of
# 32 pixels (128), or 2 (64; the other two warps split the channels).
DGRAD_TILES = {4: ((8, 16), (16, 8), (4, 32)), 2: ((4, 16), (8, 8))}


def dgrad_plan(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int,
               sms: int, smem_max: int = SMEM_OPTIN) -> tuple[int, int, int, int, int]:
    """conv_layer_dgrad's launch for a layer input of B x H x W x cin:
    (nt, wm, tile_h, tile_w, splits). A block takes a tile of one parity
    class (at stride 2 ceil(H/2) x ceil(W/2) pixels at most) with 4 warps,
    wm along its pixels (32 each) and 4 / wm along its input channels, nt
    8-channel n-tiles each. The tile computes the fewest pixels past the
    class's edge, a 64-pixel tile only where it computes under 85 % of the
    best 128-pixel one's; the channel slice is the widest (at most 64) that
    pads cin by at most 1/8 more than the narrowest. Where that gives under
    2 blocks per SM (the small maps of DispNet's 256- and 512-channel
    layers), K (Cout chunks of 8) splits so that it gives about 2. Where
    the block's shared memory (`dgrad_smem`) would pass `smem_max`, nt
    halves; a shape no plan fits raises ValueError, as the launcher would
    refuse it."""
    ny, nx = -(-H // stride), -(-W // stride)

    def computed(tile):
        th, tw = tile
        return -(-ny // th) * th * -(-nx // tw) * tw

    t4, t2 = min(DGRAD_TILES[4], key=computed), min(DGRAD_TILES[2], key=computed)
    wm, (th, tw) = (2, t2) if computed(t2) < 0.85 * computed(t4) else (4, t4)
    per_nt = 8 * (4 // wm)
    nts = (8, 4, 2, 1) if wm == 4 else (4, 2, 1)
    padded = {nt: -(-cin // (nt * per_nt)) * nt * per_nt for nt in nts}
    least = min(padded.values())
    nt = next(nt for nt in nts if 8 * padded[nt] <= 9 * least)
    # Fewer channels a block where its staging would not fit (large k at stride 1).
    while nt > 1 and dgrad_smem(k, stride, nt, wm, th, tw) > smem_max:
        nt //= 2
    blocks = B * stride * stride * -(-ny // th) * -(-nx // tw) * padded[nt] // (nt * per_nt)
    _refuse_if(dgrad_smem(k, stride, nt, wm, th, tw) > smem_max or blocks > INT_MAX or k % 2 == 0
               or stride not in (1, 2), "conv_layer_dgrad", B, H, W, cin, cout, k, stride)
    splits = max(1, min(padded_cout(cout) // 8, -(-2 * sms // blocks)))
    return nt, wm, th, tw, splits


def dgrad_smem(k: int, stride: int, nt: int, wm: int, tile_h: int, tile_w: int) -> int:
    """Bytes of shared memory of a conv_layer_dgrad block: two stages of
    the dz halo and the class's taps of the block's weights, 12 floats a
    slot (`launch_dgrad`)."""
    per = -(-k // stride)
    n_block = nt * 8 * (4 // wm)
    return 2 * ((tile_h + per - 1) * (tile_w + per - 1) + per * per * n_block) * 12 * 4


# conv_layer_wgrad's output tiles: 64 or 128 pixels (4 warps, two 8-pixel
# k-steps of one row each at a time).
WGRAD_TILES = ((8, 16), (4, 32), (16, 8), (4, 16), (8, 8))


def wgrad_chunks(tiles: int, blocks: int, sms: int) -> tuple[int, int]:
    """(chunks, tiles per chunk) of conv_layer_wgrad's split over output
    tiles: about 4 blocks per SM in all, `blocks` of them per chunk."""
    chunks = max(1, min(tiles, -(-4 * sms // blocks), 65535))
    per = -(-tiles // chunks)
    return -(-tiles // per), per


def wgrad_flat(cin: int, x_stride: int) -> bool:
    """Whether conv_layer_wgrad flattens (tap, channel) into its columns:
    the first layers' Cin 2, 3 and 9 (their inputs hold no other
    channels), which chunks of 8 channels would pad by 1.8-4x."""
    return cin < 16 and cin % 8 != 0 and x_stride == cin


# Shared memory a conv_layer_wgrad block may take: two blocks per SM.
WGRAD_SMEM = 112 * 1024
# Warps of a conv_layer_wgrad block along its column tiles, at most (the
# others share the pixels). Timed on the card against 1 and 4 on a `davo`
# B=4 step's layers: as fast or faster on all but the 512-channel one, and
# clearly ahead of 4 for float32 inputs.
WGRAD_COL_WARPS = 2


def wgrad_smem(tile_h: int, tile_w: int, k: int, stride: int, cpb: int, mt: int, x_bytes: int) -> int:
    """Bytes of shared memory of a chunked conv_layer_wgrad block: two
    stages of the input halo (cpb * 8 channels a pixel, 8 more where that
    is a multiple of 16) and the dz tile (16 * mt + 8 floats a pixel)."""
    hh, hw = (tile_h - 1) * stride + k, (tile_w - 1) * stride + k
    pitch = hw if stride == 1 else 2 * -(-hw // 2)
    slot = cpb * 8 + (8 if cpb % 2 == 0 else 0)
    return 2 * (-(-(hh * pitch * slot * x_bytes) // 16) * 16 + tile_h * tile_w * (16 * mt + 8) * 4)


def wgrad_plan(B: int, Ho: int, Wo: int, cin: int, cout: int, k: int, stride: int, sms: int,
               x_stride: int | None = None, x_bytes: int = 2, smem_max: int = SMEM_OPTIN):
    """conv_layer_wgrad's launch for a layer output of B x Ho x Wo x cout
    and an input of x_bytes-byte elements: (mt, flat, wn, cpb, tpg,
    tile_h, tile_w, chunks, tiles per chunk). A block takes 16 * mt output
    channels (mt = 1 for Cout <= 16) and up to WGRAD_COL_WARPS * 18 / mt
    column tiles of 8: flattened (tap, channel) columns (`wgrad_flat`, for
    an input of x_stride channels, cin unless given), or cpb chunks of 8
    input channels of tpg taps, as many chunks as fit (`wgrad_smem` within
    WGRAD_SMEM). wn warps split the column tiles, 18 / mt at most each;
    the other 4 / wn split the pixels: a block with few columns shares its
    k-steps out rather than its columns. The tile computes the fewest
    pixels past the map's edge (the first of WGRAD_TILES on a tie). A
    launch whose shared memory (the staged input and dz, or the warps'
    reduction) passes `smem_max`, or whose grid passes the card's limits,
    raises ValueError, as the launcher would refuse it."""
    th, tw = min(WGRAD_TILES, key=lambda t: -(-Ho // t[0]) * t[0] * -(-Wo // t[1]) * t[1])
    mt, flat = (1 if cout <= 16 else 2), wgrad_flat(cin, cin if x_stride is None else x_stride)
    per_warp = 18 // mt
    if flat:
        cpb = tpg = 1
        n_cols = min(WGRAD_COL_WARPS * per_warp, -(-(k * k * cin) // 8))
    else:
        tpg = min(k * k, WGRAD_COL_WARPS * per_warp)
        cpb = min(WGRAD_COL_WARPS * per_warp // tpg, -(-cin // 8))
        while cpb > 1 and wgrad_smem(th, tw, k, stride, cpb, mt, x_bytes) > WGRAD_SMEM:
            cpb -= 1
        n_cols = cpb * tpg
    wn = next(w for w in (1, 2, 4) if w * per_warp >= n_cols)
    if flat:
        blocks_y = -(-(-(-(k * k * cin) // 8)) // (wn * per_warp))
        hw = (tw - 1) * stride + k
        smem = 2 * (-(-(((th - 1) * stride + k) * hw * cin * x_bytes) // 16) * 16 + th * tw * (16 * mt + 8) * 4)
    else:
        blocks_y = -(-(-(-cin // 8)) // cpb) * -(-(k * k) // tpg)
        smem = wgrad_smem(th, tw, k, stride, cpb, mt, x_bytes)
    if wn < 4:  # the k-step warps' sums reduced through shared memory
        smem = max(smem, 4 * (per_warp + 1) * mt * 128 * 4)
    tiles = B * -(-Ho // th) * -(-Wo // tw)
    _refuse_if(smem > smem_max or blocks_y > 65535 or tiles > INT_MAX or k % 2 == 0 or stride not in (1, 2),
               "conv_layer_wgrad", B, (Ho - 1) * stride + 1, (Wo - 1) * stride + 1, cin, cout, k, stride)
    blocks = -(-padded_cout(cout) // (16 * mt)) * blocks_y
    return (mt, flat, wn, cpb, tpg, th, tw, *wgrad_chunks(tiles, blocks, sms))


def wgrad_variant(mt: int, x_bf16: bool, flat: bool) -> str:
    """conv_layer_wgrad's template instance, as a profile names it."""
    return f"conv_wgrad_mma_kernel<{mt}, {'__nv_bfloat16' if x_bf16 else 'float'}, {str(flat).lower()}>"


def _pack_dgrad(w, cop):
    """OIHW float32 -> conv_layer_dgrad's weights (k*k, Cin, cop) float32,
    unrounded, Cout zero-padded to cop."""
    cout, cin, k, _ = w.shape
    return F.pad(w.detach().float().permute(2, 3, 1, 0), (0, cop - cout)).reshape(k * k, cin, cop).contiguous()


def _launch_gate(dy, g, a_out, relu, counts=device_launches):
    """conv_layer_gate: the layer's output cotangent (dy + g) * (a_out > 0),
    float32 (B, Ho, Wo, padded_cout(Cout)), the padding zero. The launch
    counts in `counts` (`device_launches` unless given), as the other
    launchers'."""
    B, Ho, Wo, cout = (dy if dy is not None else g).shape
    device = (dy if dy is not None else g).device
    dz = torch.empty((B, Ho, Wo, padded_cout(cout)), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().davo_conv_gate(
            *_cotangent_args(dy, g, a_out, relu), dz.data_ptr(), B, Ho, Wo, cout, dz.shape[3],
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_if(err, "conv layer gate")
    counts["conv_layer_gate"] += 1
    return dz


def _launch_dgrad(dz, w, x_shape, stride, dtype, counts=device_launches, variants=variant_launches,
                  plan=None):
    """conv_layer_dgrad: the input cotangent (x_shape) in `dtype` of the
    layer with OIHW weights w, used unrounded, from the gate's dz; by
    `plan` (`dgrad_plan` on the device's limits unless given). The packed
    weights are kept by `rowconv.cached_pack`."""
    cout, cin, k, _ = w.shape
    B, H, W, _ = x_shape
    _, Ho, Wo, cop = dz.shape
    top, _, left, _ = _pads(H, W, k, stride)
    nt, wm, th, tw, splits = plan or dgrad_plan(B, H, W, cin, cout, k, stride, *device_limits(w.device))
    dx = torch.empty((B, H, W, cin), dtype=dtype, device=w.device)
    partial = torch.empty(splits * dx.numel() if splits > 1 else 0, dtype=torch.float32, device=w.device)
    wp = rowconv.cached_pack(w, ("dgrad", cop), lambda: _pack_dgrad(w, cop))
    with torch.cuda.device(w.device):
        err = _library().davo_conv_dgrad(
            dz.data_ptr(), wp.data_ptr(), dx.data_ptr(), int(dtype == torch.bfloat16),
            partial.data_ptr() if splits > 1 else None, splits, B, H, W, cin, Ho, Wo, cop, k, stride, top, left,
            nt, wm, th, tw, torch.cuda.current_stream(w.device).cuda_stream,
        )
    _raise_if(err, "conv layer dgrad")
    counts["conv_layer_dgrad"] += 1
    _count_variant(f"conv_dgrad_mma_kernel<{nt}>", variants)
    return dx


def _launch_wgrad(x, dz, w_shape, stride, counts=device_launches, variants=variant_launches, plan=None):
    """conv_layer_wgrad: (dW OIHW, db) float32 of a layer on input x,
    whose first Cin channels are the layer's input, from the gate's dz;
    by `plan` (`wgrad_plan` on the device's limits unless given)."""
    cout, cin, k, _ = w_shape
    B, H, W, _ = x.shape
    _, Ho, Wo, cop = dz.shape
    top, _, left, _ = _pads(H, W, k, stride)
    K = k * k * cin
    x_bf16 = rowconv._bf16_flag(x, "layer input")
    sms, smem_max = device_limits(x.device)
    mt, flat, wn, cpb, tpg, th, tw, chunks, per = plan or wgrad_plan(
        B, Ho, Wo, cin, cout, k, stride, sms, x.shape[3], x.element_size(), smem_max)
    partial = torch.empty(chunks * (K + 1) * cout, dtype=torch.float32, device=x.device)
    out = torch.empty((K + 1, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().davo_conv_wgrad(
            x.data_ptr(), x_bf16, x.shape[3], dz.data_ptr(), partial.data_ptr(), chunks, per, out.data_ptr(),
            B, H, W, cin, Ho, Wo, cout, cop, k, stride, top, left, mt, int(flat), wn, cpb, tpg, th, tw,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_if(err, "conv layer wgrad")
    counts["conv_layer_wgrad"] += 1
    _count_variant(wgrad_variant(mt, x_bf16, flat), variants)
    return out[:K].view(k, k, cin, cout).permute(3, 2, 0, 1).contiguous(), out[K]


def _launch_level_input_bwd(f1, f2, a0, da0, search, feat_dtype, cf, cu):
    """flow_level_input_bwd: (d f1, d f2) in f1's dtype, d feat in
    feat_dtype, d flow_up float32."""
    B, H, W, C = f1.shape
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    dfeat = torch.empty((B, H, W, cf), dtype=feat_dtype, device=f1.device)
    dflow = torch.empty((B, H, W, cu), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        err = _library().davo_flow_level_input_bwd(
            da0.data_ptr(), da0.shape[3], a0.data_ptr(), a0.shape[3], f1.data_ptr(), f2.data_ptr(),
            rowconv._bf16_flag(f1, "f1"), df1.data_ptr(), df2.data_ptr(), dfeat.data_ptr(),
            int(feat_dtype == torch.bfloat16), dflow.data_ptr(), B, H, W, C, cf, cu, search,
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    _raise_if(err, "flow level input backward")
    device_launches["flow_level_input_bwd"] += 1
    return df1, df2, dfeat, dflow


def _level_fwd_cuda(f1, f2, feat, flow_up, weights, biases, search, relus, act, dot,
                    counts=device_launches):
    """The flow level's forward kernels: (the float32 estimator input a0,
    every layer's output). In float32 a0 is the chain's own input."""
    B, H, W, _ = f1.shape
    cpad = -(-weights[0].shape[1] // 4) * 4
    x = torch.empty((B, H, W, cpad), dtype=act, device=f1.device)
    a0 = x if act == torch.float32 else torch.empty_like(x, dtype=torch.float32)
    rowconv._launch_level_input(f1, f2, feat, flow_up, x, search, None if a0 is x else a0)
    name = "flow_level_fused_ad"
    counts[name] += 1
    n = len(weights)
    acts = rowconv._chain_cuda(name, x, weights, biases, (1,) * n, relus, act, dot, tuple(range(n)), True,
                               counts=counts)
    return a0, acts


def _level_bwd_cuda(f1, f2, a0, acts, weights, relus, g, search, feat_dtype, cf):
    """The kernels' flow-level backward: the same contract as
    `flow_level_bwd_plain`, each map's cotangent in its dtype."""
    n = len(weights)
    da0, dws, dbs = _chain_bwd_cuda(a0, acts, weights, (1,) * n, relus, (n - 1,), (g,), True, torch.float32)
    cu = weights[0].shape[1] - (2 * search + 1) ** 2 - cf
    return (*_launch_level_input_bwd(f1, f2, a0, da0, search, feat_dtype, cf, cu), dws, dbs)


def _chain_bwd_cuda(x, acts, weights, strides, relus, taps, gs, need_dx, dx_dtype):
    """The kernels' reverse sweep: the same contract as
    `conv_chain_bwd_plain`, dx in dx_dtype."""
    n = len(weights)
    dws, dbs = [None] * n, [None] * n
    dy = None
    for layer in reversed(range(n)):
        w, stride, relu = weights[layer], strides[layer], relus[layer]
        g = gs[taps.index(layer)].contiguous() if layer in taps else None
        a_out = acts[layer]
        a_in = x if layer == 0 else acts[layer - 1]
        dz = _launch_gate(dy, g, a_out, relu)
        dws[layer], dbs[layer] = _launch_wgrad(a_in, dz, w.shape, stride)
        if layer or need_dx:
            x_shape = (*a_in.shape[:3], w.shape[1])
            dy = _launch_dgrad(dz, w, x_shape, stride, torch.float32 if layer else dx_dtype)
        else:
            dy = None
    return dy, dws, dbs


# ------------------------------------------------------------ autograd Functions


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


class _Chain(torch.autograd.Function):
    """A strided or stride-1 chain: outputs float32 copies of the kept
    layers (the reference's dtype; the callers cast)."""

    @staticmethod
    def forward(ctx, spec, x, *params):
        name, strides, relus, keep, mode = spec
        n = len(strides)
        weights, biases = params[:n], params[n:]
        act, dot = rowconv._modes(mode)
        last_f32 = name == "conv_chain_nhwc_ad"
        if _on_cuda(x):
            acts = rowconv._chain_cuda(name, x, weights, biases, strides, relus, act, dot,
                                       tuple(range(n)), last_f32, counts=device_launches)
            launches[name] += 1
        else:
            acts = rowconv.conv_chain_strided_plain(x, weights, biases, strides, relus,
                                                    tuple(range(n)), mode)
            if last_f32:
                acts[-1] = acts[-1].float()
        ctx.spec = spec
        ctx.save_for_backward(x, *acts, *weights)
        return tuple(acts[t].float() for t in keep)

    @staticmethod
    def backward(ctx, *gs):
        name, strides, relus, keep, _ = ctx.spec
        n = len(strides)
        x, *rest = ctx.saved_tensors
        acts, weights = rest[:n], rest[n:]
        need_dx = ctx.needs_input_grad[1]
        if _on_cuda(x):
            dx, dws, dbs = _chain_bwd_cuda(x, acts, weights, strides, relus, keep, gs, need_dx, x.dtype)
            backward_launches[name] += 1
        else:
            dx, dws, dbs = conv_chain_bwd_plain(x, acts, weights, strides, relus, keep, gs, need_dx)
            dx = None if dx is None else dx.to(x.dtype)
        return (None, dx, *dws, *dbs)


class _FlowLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, f1, f2, feat, flow_up, *params):
        search, relus, mode = spec
        n = len(relus)
        weights, biases = params[:n], params[n:]
        act, dot = rowconv._modes(mode)
        if _on_cuda(f1):
            a0, acts = _level_fwd_cuda(f1, f2, feat, flow_up, weights, biases, search, relus, act, dot)
            launches["flow_level_fused_ad"] += 1
        else:
            a0 = level_input_plain(f1, f2, feat, flow_up, search)
            acts = rowconv.conv_chain_strided_plain(a0.to(act), weights, biases, (1,) * n, relus,
                                                    tuple(range(n)), mode)
            acts[-1] = acts[-1].float()
        ctx.spec = spec
        ctx.feat = (feat.shape[3], feat.dtype, flow_up.dtype)
        ctx.save_for_backward(f1, f2, a0, *acts, *weights)
        return acts[-1]

    @staticmethod
    def backward(ctx, g):
        search, relus, _ = ctx.spec
        cf, feat_dtype, flow_dtype = ctx.feat
        n = len(relus)
        f1, f2, a0, *rest = ctx.saved_tensors
        acts, weights = rest[:n], rest[n:]
        if _on_cuda(f1):
            df1, df2, dfeat, dflow, dws, dbs = _level_bwd_cuda(f1, f2, a0, acts, weights, relus, g, search,
                                                               feat_dtype, cf)
            backward_launches["flow_level_fused_ad"] += 1
        else:
            df1, df2, dfeat, dflow, dws, dbs = flow_level_bwd_plain(
                f1, f2, a0, acts, weights, relus, g, search, cf)
            df1, df2, dfeat = df1.to(f1.dtype), df2.to(f2.dtype), dfeat.to(feat_dtype)
        return (None, df1, df2, dfeat, dflow.to(flow_dtype), *dws, *dbs)


# ------------------------------------------------------------------- wrappers


def _needs_autograd(name, mode, tensors) -> bool:
    """Whether autograd must differentiate the call; then checks the mode
    and that every tensor lies on one CPU or CUDA device."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)):
        return False
    rowconv._modes(mode)
    if mode not in TRAIN_MODES:
        raise ValueError(
            f"{name}: no backward in compute mode {mode!r} (the reference's backward takes "
            f"{' and '.join(TRAIN_MODES)} only); train with fuse_compute in {TRAIN_MODES} or ''"
        )
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    if devices.pop().type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} for device {tensors[0].device}")
    return True


def conv_chain_strided_ad(x, weights, biases, strides, relus, taps=None,
                          compute_dtype_name="bfloat16"):
    """`rowconv.conv_chain_strided`, differentiable in x, weights and
    biases. Under autograd the outputs are float32 (holding values of the
    activation dtype, as the reference's); otherwise the serving
    wrapper's."""
    tensors = [x, *weights, *biases]
    if not _needs_autograd("conv_chain_strided_ad", compute_dtype_name, tensors):
        return rowconv.conv_chain_strided(x, weights, biases, strides, relus, taps, compute_dtype_name)
    keep = rowconv.chain_keep(weights, biases, strides, relus, taps)
    rowconv._strided_shapes(x.shape[1], x.shape[2], weights, strides)
    spec = ("conv_chain_strided_ad", tuple(strides), tuple(relus), keep, compute_dtype_name)
    outs = _Chain.apply(spec, x.contiguous(), *weights, *biases)
    return outs[0] if taps is None else list(outs)


def conv_chain_nhwc_ad(x, weights, biases, relus, compute_dtype_name="bfloat16"):
    """`rowconv.conv_chain_nhwc`, differentiable in x, weights and
    biases: (B, H, W, Cout_last) float32."""
    tensors = [x, *weights, *biases]
    if not _needs_autograd("conv_chain_nhwc_ad", compute_dtype_name, tensors):
        return rowconv.conv_chain_nhwc(x, weights, biases, relus, compute_dtype_name)
    if any(w.shape[-2:] != (3, 3) for w in weights):
        raise ValueError("conv_chain_nhwc_ad takes 3x3 kernels")
    strides = (1,) * len(weights)
    keep = rowconv.chain_keep(weights, biases, strides, relus, None)
    spec = ("conv_chain_nhwc_ad", strides, tuple(relus), keep, compute_dtype_name)
    (out,) = _Chain.apply(spec, x.contiguous(), *weights, *biases)
    return out


def flow_level_fused_ad(f1, f2, feat, flow_up, weights, biases, search, relus,
                        compute_dtype_name="bfloat16"):
    """`rowconv.flow_level_fused`, differentiable in the four maps, the
    weights and the biases: the flow increment (B, H, W, Cout_last)
    float32."""
    tensors = [f1, f2, feat, flow_up, *weights, *biases]
    if not _needs_autograd("flow_level_fused_ad", compute_dtype_name, tensors):
        return rowconv.flow_level_fused(f1, f2, feat, flow_up, weights, biases, search, relus,
                                        compute_dtype_name)
    rowconv.check_level(f1, f2, feat, flow_up, weights, search)
    if _on_cuda(f1):
        rowconv.check_level_dtypes(f1, f2, feat, flow_up)
    spec = (search, tuple(relus), compute_dtype_name)
    return _FlowLevel.apply(spec, f1.contiguous(), f2.contiguous(), feat.contiguous(),
                            flow_up.contiguous(), *weights, *biases)
