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
`conv_layer_wgrad` (dW, db) and `conv_layer_dgrad` (the input's
cotangent), then for a flow level `flow_level_input_bwd`.

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
own); the plain versions never count.
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
KERNELS = ("conv_layer_dgrad", "conv_layer_wgrad", "flow_level_input_bwd")
launches = dict.fromkeys(_NAMES, 0)
backward_launches = dict.fromkeys(_NAMES, 0)
device_launches = dict.fromkeys(_NAMES + KERNELS, 0)


def reset_counts() -> None:
    for counts in (launches, backward_launches, device_launches):
        for name in counts:
            counts[name] = 0


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


def _dgrad_plain(dz, w, x_shape, stride):
    B, H, W, cin = x_shape
    top, bottom, left, right = _pads(H, W, w.shape[-1], stride)
    dxp = torch.nn.grad.conv2d_input(
        (B, cin, H + top + bottom, W + left + right), w.to(dz.dtype), dz.permute(0, 3, 1, 2), stride=stride
    )
    return dxp[:, :, top : top + H, left : left + W].permute(0, 2, 3, 1)


def _wgrad_plain(x, dz, w_shape, stride):
    k = w_shape[-1]
    top, bottom, left, right = _pads(x.shape[1], x.shape[2], k, stride)
    xp = F.pad(x.to(dz.dtype).permute(0, 3, 1, 2), (left, right, top, bottom))
    dw = torch.nn.grad.conv2d_weight(xp, w_shape, dz.permute(0, 3, 1, 2), stride=stride)
    return dw, dz.sum((0, 1, 2))


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("rowconv_bwd")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.davo_conv_dgrad.argtypes = [P, P, I, P, I, I, P, P, I, I] + [I] * 11 + [P]
    lib.davo_conv_dgrad.restype = I
    lib.davo_conv_wgrad.argtypes = [P, I, I, P, P, I, P, I, I, P, I, I, P] + [I] * 11 + [P]
    lib.davo_conv_wgrad.restype = I
    lib.davo_flow_level_input_bwd.argtypes = [P, I, P, I, P, P, I, P, P, P, I, P] + [I] * 7 + [P]
    lib.davo_flow_level_input_bwd.restype = I
    lib.davo_cuda_error_string.argtypes = [I]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def _geometry(x_shape, out_shape, k, stride):
    B, H, W, _ = x_shape
    _, Ho, Wo, _ = out_shape
    top, _, left, _ = _pads(H, W, k, stride)
    return B, H, W, Ho, Wo, top, left


def _launch_dgrad(dy, g, a_out, relu, w, x_shape, stride, dtype):
    """conv_layer_dgrad: the input cotangent (x_shape) in `dtype` of the
    layer with OIHW weights w, used unrounded."""
    cout, cin, k, _ = w.shape
    out_shape = (dy if dy is not None else g).shape
    B, H, W, Ho, Wo, top, left = _geometry(x_shape, out_shape, k, stride)
    dx = torch.empty((B, H, W, cin), dtype=dtype, device=w.device)
    wp = rowconv._pack(w, torch.float32)
    device = w.device
    with torch.cuda.device(device):
        err = _library().davo_conv_dgrad(
            *_cotangent_args(dy, g, a_out, relu), wp.data_ptr(), dx.data_ptr(),
            int(dtype == torch.bfloat16), cin, B, H, W, cin, Ho, Wo, cout, k, stride, top, left,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_if(err, "conv layer dgrad")
    device_launches["conv_layer_dgrad"] += 1
    return dx


def wgrad_chunks(pixels: int, k_rows: int, cout: int) -> tuple[int, int]:
    """(chunks, pixels per chunk) of conv_layer_wgrad's partial sums:
    enough blocks of 64 x 64 tiles to fill the card (about 8 per SM),
    chunks of at least 256 pixels, a multiple of 32."""
    tiles = -(-cout // 64) * -(-k_rows // 64)
    chunks = max(1, min(-(-pixels // 256), -(-1056 // tiles), 65535))
    chunk = -(-pixels // chunks)
    chunk = -(-chunk // 32) * 32
    return -(-pixels // chunk), chunk


def _launch_wgrad(x, dy, g, a_out, relu, w_shape, stride):
    """conv_layer_wgrad: (dW OIHW, db) float32 of a layer on input x,
    whose first Cin channels are the layer's input."""
    cout, cin, k, _ = w_shape
    out_shape = (dy if dy is not None else g).shape
    B, H, W, Ho, Wo, top, left = _geometry(x.shape, out_shape, k, stride)
    K = k * k * cin
    chunks, chunk = wgrad_chunks(B * Ho * Wo, K + 1, cout)
    partial = torch.empty(chunks * (K + 1) * cout, dtype=torch.float32, device=x.device)
    out = torch.empty((K + 1, cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().davo_conv_wgrad(
            x.data_ptr(), rowconv._bf16_flag(x, "layer input"), x.shape[3],
            *_cotangent_args(dy, g, a_out, relu), partial.data_ptr(), chunks, chunk, out.data_ptr(),
            B, H, W, cin, Ho, Wo, cout, k, stride, top, left,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_if(err, "conv layer wgrad")
    device_launches["conv_layer_wgrad"] += 1
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
        dws[layer], dbs[layer] = _launch_wgrad(a_in, dy, g, a_out, relu, w.shape, stride)
        if layer or need_dx:
            x_shape = (*a_in.shape[:3], w.shape[1])
            dy = _launch_dgrad(dy, g, a_out, relu, w, x_shape, stride,
                               torch.float32 if layer else dx_dtype)
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
