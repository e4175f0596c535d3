"""Fused conv chains of the serving path: the hand-written CUDA kernels
(`csrc/rowconv.cu`) and their plain versions.

Three functions, each the counterpart of a TPU kernel of
`davo_tpu/kernels/rowconv.py`:

- `conv_chain_strided` (TPU `conv_chain_strided`, :501): a chain of SAME
  convolutions, any odd k, stride 1 or 2, bias and optional ReLU per
  layer; returns the last layer, or the layers named in `taps` (a
  feature pyramid);
- `conv_chain_nhwc` (TPU `conv_chain_nhwc`, :602): a chain of stride-1
  3x3 SAME convolutions; the last layer comes out in float32;
- `flow_level_fused` (TPU `flow_level_fused`, :246): the masked, ReLU'd
  cost volume of f1/f2, concatenated with the level's features and the
  upsampled flow, through the estimator chain; returns the flow
  increment in float32.

Every layer computes what the TPU kernels compute: operands rounded to
the dot dtype, products summed in float32, plus the float32 bias, ONE
rounding to the activation dtype, then ReLU. The unfused `ConvBlock`
rounds the conv output first and adds a bf16 bias, which is another
function in bf16: the fused modules follow the kernels, not `ConvBlock`.

Weights are the port's OIHW float32 parameters (`Conv_0.weight`, as
`convert.py` loads them). Both layer kernels are implicit GEMMs on the
tensor cores with one K order (`mma_order`) and take the weights in it:
the bf16 modes' as bf16 (`_pack_mma`), the float32 mode's split into
TF32 hi and lo planes of float32 (`_pack_tf32`). `_packed` keeps each
parameter's packing until the parameter changes in place (its
`_version`) or its storage changes, so an Adam step is seen by the next
forward and an unchanged parameter is packed once.

Serving only, as the TPU kernels (which have no VJP): every wrapper
raises when autograd would have to differentiate it (the training
variants, with their backward kernels, are in `rowconv_ad.py`). For CUDA
tensors it launches the kernels (one launch per layer, plus the
cost-volume input of a flow level) or raises; for CPU tensors it runs the
plain version. `launches` counts wrapper calls that launched,
`device_launches` the kernels they launched; the plain versions never
count.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Sequence

import torch
import torch.nn.functional as F

from davo_tpu_torch.kernels import cuda_build
from davo_tpu_torch.kernels.costvol import cost_volume_plain
from davo_tpu_torch.models.common import same_pads

# Compute-mode name -> (activation dtype, dot-operand dtype), as the
# reference's `_DTYPE_MODES`. "bf16_dot" keeps activations float32 and
# rounds only the operands of each product to bf16.
DTYPE_MODES = {
    "float32": (torch.float32, torch.float32),
    "bfloat16": (torch.bfloat16, torch.bfloat16),
    "bf16_dot": (torch.float32, torch.bfloat16),
}

_NAMES = ("flow_level_fused", "conv_chain_strided", "conv_chain_nhwc")
launches = dict.fromkeys(_NAMES, 0)
device_launches = dict.fromkeys(_NAMES, 0)
# Launches of the flow level's input kernel, from the serving level and
# the training one (`rowconv_ad`) alike.
level_input_launches = 0


def reset_counts() -> None:
    global level_input_launches
    for name in _NAMES:
        launches[name] = device_launches[name] = 0
    level_input_launches = 0


def fusable_even_prefix(h: int, w: int, strides: Sequence[int]) -> int:
    """Longest chain prefix whose stride-2 layers all see even dims (the
    reference fuses that prefix and runs the tail as `ConvBlock`s)."""
    n = 0
    for s in strides:
        if s == 2:
            if h % 2 or w % 2:
                break
            h, w = h // 2, w // 2
        n += 1
    return n


def even_prefix_chain(x, convs, compute_dtype_name, chain):
    """A stride-2, ReLU'd conv stack's longest prefix whose layers all see
    even dims, as one call of `chain`: `conv_chain_strided`, or its
    training variant `rowconv_ad.conv_chain_strided_ad` (the fused prefix
    of the reference's PoseEncoder and RegionAttention). `convs` are the
    stack's `Conv` modules. Returns (the prefix's output, or x when no
    layer fuses; the number of layers fused)."""
    n = fusable_even_prefix(x.shape[1], x.shape[2], (2,) * len(convs))
    if not n:
        return x, 0
    y = chain(
        x.contiguous(), [c.weight for c in convs[:n]], [c.bias for c in convs[:n]],
        (2,) * n, (True,) * n, compute_dtype_name=compute_dtype_name,
    )
    return y, n


def _strided_shapes(h: int, w: int, weights, strides) -> list[tuple[int, int]]:
    """Output (H, W) of each layer; raises as the reference does when a
    stride-2 layer sees odd dims."""
    shapes = []
    for i, (wt, s) in enumerate(zip(weights, strides)):
        if wt.shape[-1] % 2 == 0 or s not in (1, 2):
            raise ValueError(f"layer {i}: need an odd kernel and stride 1 or 2, got k={wt.shape[-1]} s={s}")
        if s == 2:
            if h % 2 or w % 2:
                raise ValueError(f"stride-2 layer {i} needs even dims, got {h}x{w}")
            h, w = h // 2, w // 2
        shapes.append((h, w))
    return shapes


def _modes(name: str) -> tuple[torch.dtype, torch.dtype]:
    if name not in DTYPE_MODES:
        raise ValueError(f"unknown fused compute mode {name!r}; one of {sorted(DTYPE_MODES)}")
    return DTYPE_MODES[name]


# --------------------------------------------------------------- plain versions


def _layer_plain(x, w, b, stride, relu, act, dot):
    """One fused layer on NHWC `x` (already in the activation dtype)."""
    k = w.shape[-1]
    (top, bottom), (left, right) = (same_pads(n, k, stride) for n in x.shape[1:3])
    xin = F.pad(x.to(dot).float().permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xin, w.to(dot).float(), stride=stride)
    y = (y + b.float()[:, None, None]).to(act)
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1)


def conv_chain_strided_plain(x, weights, biases, strides, relus, taps=None,
                             compute_dtype_name="bfloat16"):
    """The plain version of `conv_chain_strided` (same arguments)."""
    act, dot = _modes(compute_dtype_name)
    _strided_shapes(x.shape[1], x.shape[2], weights, strides)
    outs = []
    y = x.to(act)
    for i, (w, b, s, r) in enumerate(zip(weights, biases, strides, relus)):
        y = _layer_plain(y, w, b, s, r, act, dot)
        outs.append(y)
    return outs[-1] if taps is None else [outs[t] for t in taps]


def conv_chain_nhwc_plain(x, weights, biases, relus, compute_dtype_name="bfloat16"):
    """The plain version of `conv_chain_nhwc` (same arguments)."""
    y = conv_chain_strided_plain(
        x, weights, biases, (1,) * len(weights), relus, compute_dtype_name=compute_dtype_name
    )
    return y.float()


def flow_level_fused_plain(f1, f2, feat, flow_up, weights, biases, search, relus,
                           compute_dtype_name="bfloat16"):
    """The plain version of `flow_level_fused` (same arguments)."""
    act, _ = _modes(compute_dtype_name)
    cv = torch.relu(cost_volume_plain(f1.float(), f2.float(), search))
    x = torch.cat([cv, feat.float(), flow_up.float()], -1).to(act)
    return conv_chain_nhwc_plain(x, weights, biases, relus, compute_dtype_name)


# --------------------------------------------------------------------- kernels


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of `csrc/rowconv.cu` (each returns a cudaError_t).
SIGNATURES = {
    "davo_conv_layer_mma": [_P, _I, _P, _P, _P, _I] + [_I] * 13 + [_P],
    "davo_conv_layer_tf32": [_P, _I, _P, _P, _P, _I] + [_I] * 13 + [_P],
    "davo_flow_level_input": [_P, _P, _P, _I, _P, _P, _I, _P] + [_I] * 8 + [_P],
    "davo_flow_level_input_last": [_P],
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/rowconv.cu`) with `SIGNATURES` set."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    lib.davo_cuda_error_string.argtypes = [_I]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return bind(cuda_build.load("rowconv"))


def _raise_if(err: int, what: str) -> None:
    if err:
        msg = _library().davo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg}")


def _bf16_flag(t: torch.Tensor, what: str) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the kernels take float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: the kernels take contiguous NHWC tensors")
    return int(t.dtype == torch.bfloat16)


def mma_chunked(cin: int) -> bool:
    """Whether the tensor-core kernels run K in chunks of 16 input
    channels (Cin >= 16), or flatten (tap, channel) into K."""
    return cin >= 16


def mma_order(w: torch.Tensor, cin: int | None = None) -> torch.Tensor:
    """OIHW -> (Np, K) in the tensor-core kernels' K order (`csrc/
    conv_mma.cuh`), w's dtype: input channels zero-padded to `cin`; for cin
    >= 16 also to a multiple of 16, K ordered (chunk of 16 channels, ky,
    kx, channel); for cin < 16, K ordered (ky, kx, channel) and
    zero-padded to a multiple of 16; Np = Cout padded to a multiple of 8
    with zero rows."""
    cout, cin_w, k, _ = w.shape
    cin = cin_w if cin is None else cin
    w = w.detach()
    if mma_chunked(cin):
        cp = -(-cin // 16) * 16
        w = F.pad(w, (0, 0, 0, 0, 0, cp - cin_w))
        w = w.reshape(cout, cp // 16, 16, k, k).permute(0, 1, 3, 4, 2).reshape(cout, -1)
    else:
        w = F.pad(w, (0, 0, 0, 0, 0, cin - cin_w)).permute(0, 2, 3, 1).reshape(cout, -1)
        w = F.pad(w, (0, -(-w.shape[1] // 16) * 16 - w.shape[1]))
    return F.pad(w, (0, 0, 0, -(-cout // 8) * 8 - cout)).contiguous()


def _pack_mma(w: torch.Tensor, cin: int | None = None) -> torch.Tensor:
    """OIHW float32 -> the bf16 tensor-core kernel's weights: bf16 (Np, K)
    in `mma_order`."""
    return mma_order(w.to(torch.bfloat16), cin)


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero), as cvt.rna.tf32.f32: on the integer view, (bits + 0x1000)
    with the low 13 bits cleared."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _pack_tf32(w: torch.Tensor, cin: int | None = None) -> torch.Tensor:
    """OIHW float32 -> the float32 mode's weights: (2, Np, K) float32 in
    `mma_order`, [0] hi = tf32_rna(w), [1] lo = tf32_rna(w - hi), both
    exact TF32 values (split TF32: the kernel's products hi*hi + hi*lo +
    lo*hi keep ~2^-22 of each)."""
    w = mma_order(w.float(), cin)
    hi = tf32_rna(w)
    return torch.stack([hi, tf32_rna(w - hi)]).contiguous()


# Packed weights by parameter: id -> (weak reference to it, {(layout, cin):
# ((storage pointer, offset, _version), packed)}).
_PACKED: dict[int, tuple] = {}


def _packed(w: torch.Tensor, dot: torch.dtype, cin: int) -> torch.Tensor:
    """The layer kernel's weights for OIHW `w` (input channels padded to
    `cin`): `_pack_mma` for bf16 products, else `_pack_tf32`. Kept per
    parameter and reused while its storage and `_version` stay the same."""
    layout = "mma" if dot == torch.bfloat16 else "tf32"

    def pack():
        return _pack_mma(w, cin) if layout == "mma" else _pack_tf32(w, cin)

    if w.is_inference():  # no version counter to watch
        return pack()
    ref, entries = _PACKED.get(id(w), (None, None))
    if ref is None or ref() is not w:
        for key in [key for key, (r, _) in _PACKED.items() if r() is None]:
            del _PACKED[key]
        entries = {}
        _PACKED[id(w)] = (weakref.ref(w), entries)
    stamp = (w.untyped_storage().data_ptr(), w.storage_offset(), w._version)
    hit = entries.get((layout, cin))
    if hit is None or hit[0] != stamp:
        hit = entries[(layout, cin)] = (stamp, pack())
    return hit[1]


def _launch_layer(x, w, b, out, stride, relu, act, dot):
    """One layer kernel: x (B, H, W, Cin) -> out (B, Ho, Wo, Cout), OIHW
    weights w (Cin may exceed w's input channels: zero channels). bf16
    products (the bfloat16 and bf16_dot modes) run on the bf16
    tensor-core kernel, float32 ones on the split-TF32 one."""
    B, H, W, cin = x.shape
    _, Ho, Wo, cout = out.shape
    k = w.shape[-1]
    if w.shape[0] != cout or w.shape[1] > cin or w.shape[2] != k:
        raise ValueError(f"weights {tuple(w.shape)} do not fit input {tuple(x.shape)} -> {cout}")
    wp = _packed(w, dot, cin)
    pad_t = same_pads(H, k, stride)[0]
    pad_l = same_pads(W, k, stride)[0]
    bias = b.detach().float().contiguous()
    lib = _library()
    args = (x.data_ptr(), _bf16_flag(x, "conv input"), wp.data_ptr(), bias.data_ptr(),
            out.data_ptr(), int(out.dtype == torch.bfloat16), B, H, W, cin, Ho, Wo, cout, k, stride,
            pad_t, pad_l)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        entry = lib.davo_conv_layer_mma if dot == torch.bfloat16 else lib.davo_conv_layer_tf32
        err = entry(*args, int(act == torch.bfloat16), int(bool(relu)), stream)
    _raise_if(err, "fused conv layer")


def _launch_level_input(f1, f2, feat, flow_up, x, search, a0=None):
    """The flow level's input kernel: x (B, H, W, cpad) <- relu(cost
    volume) ++ feat ++ flow_up ++ zero channels, in x's dtype; and, when
    given, the same unrounded into a0 (float32, x's shape)."""
    global level_input_launches
    B, H, W, C = f1.shape
    in_bf16 = _bf16_flag(f1, "f1")
    for t, what in ((f2, "f2"), (feat, "feat"), (flow_up, "flow_up")):
        _bf16_flag(t, what)
    with torch.cuda.device(f1.device):
        err = _library().davo_flow_level_input(
            f1.data_ptr(), f2.data_ptr(), feat.data_ptr(), in_bf16, flow_up.data_ptr(),
            x.data_ptr(), int(x.dtype == torch.bfloat16), None if a0 is None else a0.data_ptr(),
            B, H, W, C, feat.shape[3], flow_up.shape[3], search, x.shape[3],
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
    _raise_if(err, "flow level input")
    level_input_launches += 1


def last_level_input_kernel() -> str:
    """The kernel the last `flow_level_input` launch of this process ran,
    as the C launcher chose it: `flow_level_input_kernel<3>` or `<4>` (the
    compile-time searches), `flow_level_input_kernel<-1>` (the run-time
    search), or `flow_level_input_element_kernel` (searches the tile plan
    refuses)."""
    out = (ctypes.c_int * 1)()
    _library().davo_flow_level_input_last(out)
    code = out[0]
    if code == 0:
        raise RuntimeError("no flow_level_input launch yet")
    return "flow_level_input_element_kernel" if code == -2 else f"flow_level_input_kernel<{code}>"


def _chain_cuda(name, x, weights, biases, strides, relus, act, dot, keep, last_f32, counts=None):
    """Run the layers on x; returns the outputs of the layers in `keep`.
    Each layer launch counts in `counts[name]` (`device_launches` unless
    given).
    Intermediates live in device memory. A wide input whose channels are
    not a multiple of 4 is zero-padded to one (zero weights too: the same
    sums), so the first layer reads 4 channels at a time (the tensor-core
    kernel stages them 8 bytes a copy); a narrow one (the images, the flow
    cue) is read one channel at a time, which costs less than the padded
    products."""
    B, h, w, cin = x.shape
    if cin % 4 and cin >= 32:
        cin = -(-cin // 4) * 4
        x = F.pad(x, (0, cin - x.shape[3]))
    layers = list(zip(weights, biases, strides, relus))
    outs = {}
    for i, (wt, b, s, r) in enumerate(layers):
        h, w = -(-h // s), -(-w // s)
        dtype = torch.float32 if (last_f32 and i == len(layers) - 1) else act
        y = torch.empty((B, h, w, wt.shape[0]), dtype=dtype, device=x.device)
        _launch_layer(x, wt, b, y, s, r, act, dot)
        (device_launches if counts is None else counts)[name] += 1
        if i in keep:
            outs[i] = y
        x = y
    return [outs[i] for i in sorted(keep)]


def _check_serving(name: str, tensors) -> str:
    """The device the call runs on; refuses autograd and mixed devices."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is serving-only (the fused kernels have no backward): call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no {name} for device {device}")
    return device.type


def chain_keep(weights, biases, strides, relus, taps) -> tuple[int, ...]:
    """The layers a chain returns: `taps`, or the last one; raises when the
    per-layer arguments differ in length or the taps are not increasing
    layer indices."""
    n = len(weights)
    if not (len(biases) == len(strides) == len(relus) == n):
        raise ValueError("weights, biases, strides and relus differ in length")
    keep = (n - 1,) if taps is None else tuple(taps)
    if sorted(set(keep)) != list(keep) or not all(0 <= t < n for t in keep):
        raise ValueError(f"taps {keep} must be increasing layer indices below {n}")
    return keep


def conv_chain_strided(x, weights, biases, strides, relus, taps=None,
                       compute_dtype_name="bfloat16"):
    """Mixed-stride SAME conv chain (serving only).

    x: (B, H, W, C0) float32 or bfloat16; weights[i]: (Cout, Cin, k, k)
    OIHW float32 (odd k); biases[i]: (Cout,); strides[i] in {1, 2}, and a
    stride-2 layer needs even input dims (ValueError otherwise, as the
    reference). Returns the last layer's (B, H', W', Cout), or, with
    `taps`, the list of those layers' outputs, in the activation dtype of
    `compute_dtype_name`. (The reference returns them as float32 of the
    same values; the callers cast to the compute dtype, so the values are
    identical.)
    """
    keep = chain_keep(weights, biases, strides, relus, taps)
    act, dot = _modes(compute_dtype_name)
    on = _check_serving("conv_chain_strided", [x, *weights, *biases])
    if on == "cpu":
        return conv_chain_strided_plain(x, weights, biases, strides, relus, taps, compute_dtype_name)
    _strided_shapes(x.shape[1], x.shape[2], weights, strides)
    outs = _chain_cuda("conv_chain_strided", x, weights, biases, strides, relus, act, dot, keep,
                       last_f32=False)
    launches["conv_chain_strided"] += 1
    return outs[0] if taps is None else outs


def conv_chain_nhwc(x, weights, biases, relus, compute_dtype_name="bfloat16"):
    """Stride-1 3x3 SAME conv chain (serving only): x (B, H, W, C0) ->
    (B, H, W, Cout_last) float32. Weights OIHW float32."""
    if any(w.shape[-2:] != (3, 3) for w in weights):
        raise ValueError("conv_chain_nhwc takes 3x3 kernels")
    act, dot = _modes(compute_dtype_name)
    on = _check_serving("conv_chain_nhwc", [x, *weights, *biases])
    if on == "cpu":
        return conv_chain_nhwc_plain(x, weights, biases, relus, compute_dtype_name)
    n = len(weights)
    (out,) = _chain_cuda("conv_chain_nhwc", x, weights, biases, (1,) * n, relus, act, dot, (n - 1,),
                         last_f32=True)
    launches["conv_chain_nhwc"] += 1
    return out


def check_level(f1, f2, feat, flow_up, weights, search) -> int:
    """The estimator's input channels, (2*search+1)^2 + Cf + Cu; raises
    when the maps do not share (B, H, W) or weights[0] takes another count."""
    cin0 = (2 * search + 1) ** 2 + feat.shape[3] + flow_up.shape[3]
    if f2.shape != f1.shape or feat.shape[:3] != f1.shape[:3] or flow_up.shape[:3] != f1.shape[:3]:
        raise ValueError(
            f"f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, feat {tuple(feat.shape)} and "
            f"flow_up {tuple(flow_up.shape)} must share (B, H, W)"
        )
    if weights[0].shape[1] != cin0:
        raise ValueError(f"first layer takes {weights[0].shape[1]} channels, the level gives {cin0}")
    return cin0


def check_level_dtypes(f1, f2, feat, flow_up) -> None:
    """The kernels' dtypes: f1, f2 and feat alike, flow_up float32."""
    if not (f1.dtype == f2.dtype == feat.dtype) or flow_up.dtype != torch.float32:
        raise TypeError(
            f"f1/f2/feat must share a dtype and flow_up be float32, got "
            f"{f1.dtype}/{f2.dtype}/{feat.dtype}/{flow_up.dtype}"
        )


def flow_level_fused(f1, f2, feat, flow_up, weights, biases, search, relus,
                     compute_dtype_name="bfloat16"):
    """One flow level (serving only): relu(cost volume(f1, f2)) ++ feat
    ++ flow_up, through the 3x3 chain; returns the flow increment
    (B, H, W, Cout_last) float32 (the caller adds flow_up).

    f1/f2: (B, H, W, C) correlation features (f2 already warped); feat:
    (B, H, W, Cf), the same dtype; flow_up: (B, H, W, Cu) float32;
    weights[0] takes (2*search+1)^2 + Cf + Cu input channels.
    """
    B, H, W, _ = f1.shape
    act, dot = _modes(compute_dtype_name)
    cin0 = check_level(f1, f2, feat, flow_up, weights, search)
    on = _check_serving("flow_level_fused", [f1, f2, feat, flow_up, *weights, *biases])
    if on == "cpu":
        return flow_level_fused_plain(f1, f2, feat, flow_up, weights, biases, search, relus,
                                      compute_dtype_name)
    check_level_dtypes(f1, f2, feat, flow_up)
    # The estimator input with its channels padded to a multiple of 4
    # (zero channels; `_chain_cuda` pads the weights to match).
    x = torch.empty((B, H, W, -(-cin0 // 4) * 4), dtype=act, device=f1.device)
    _launch_level_input(f1, f2, feat, flow_up, x, search)
    device_launches["flow_level_fused"] += 1
    n = len(weights)
    (out,) = _chain_cuda("flow_level_fused", x, weights, biases, (1,) * n, relus, act, dot, (n - 1,),
                         last_f32=True)
    launches["flow_level_fused"] += 1
    return out
