"""The unfused model's float32 convolutions on the card: one SAME layer,
forward and backward, on the port's split-TF32 kernels.

The reference pins `jax_default_matmul_precision="float32"` and runs
every `Conv` through `lax.conv_general_dilated`, true float32 products.
cuDNN's float32 algorithms are not held to that: with TF32 off they
still land a train step's gradients further from float64 than the CPU's
float32. So `models.common.Conv` in float32 runs here on CUDA tensors,
on the kernels the fused chains already use:

- forward: one launch of the layer kernel (`davo_conv_layer_tf32`,
  `rowconv._launch_layer` with no ReLU, float32 activations and
  products): each float32 operand split into TF32 hi + lo, three
  tensor-core products summed in float32. The kernel adds the bias
  before its one rounding to float32, `Conv` after the conv's output is
  rounded: one float32 rounding apart;
- backward: `conv_layer_gate` pads the output cotangent's channels to
  `rowconv_ad.padded_cout` (no ReLU), then `conv_layer_wgrad` gives dW
  and db (its column of ones: the sum of dz) and `conv_layer_dgrad` dx,
  both split-TF32 GEMMs (`csrc/rowconv_bwd.cu`).

A stride-2 `Conv(s2d=True)` computes the same products as its SAME
stride-2 form, so in float32 it runs the layer kernel on that form (the
kernel takes odd kernels only, and space-to-depth builds an even VALID
one); bf16 keeps the space-to-depth route. bf16 convolutions stay on
cuDNN, as the reference computes them outside any Pallas kernel.

`layer_plan`, `rowconv_ad.dgrad_plan` and `wgrad_plan` refuse on the
host every shape the launchers would (ValueError naming the shape): a
CUDA tensor launches the kernels or raises, never another route. A CPU
tensor runs the plain version, each output's products summed in float64
and rounded once to float32: the forward by
`models.common.conv_same_torch` on float64 operands, then the bias added
in float32, as Flax adds it (`_forward_plain`), and dW and dx by
`torch.nn.grad` (`rowconv_ad._wgrad_plain`, `_dgrad_plain` with
`accumulate`). On a `davo` train step's flow net oneDNN's float32 sums
landed further from exact arithmetic than XLA's on the same operands:
dW up to 21x, dx 2.3x, the forward 3.4x (`estimator1.est0`), and that
forward's rounding flipped one ReLU and put the whole step 2.17x the
reference's distance from float64. The card's gates are twice the CPU's
distance from float64 (chip_smoke.py phases 9 and 13), so this route is
the card's yardstick too.

The layer is one registered op, `torch.ops.davo.conv_same_f32`, with a
fake implementation (so `torch.export` keeps one node per convolution)
and its backward registered with it: training, remat and export take
the same route. The backward launches by the plans `conv_same` checked
(`plans` is cached by shape and device limits), and the dgrad's weight
packing is kept per parameter version (`rowconv.cached_pack`), as the
forward's is. `launches` counts the op's forward and backward calls that
launched, `device_launches` the kernels they launched,
`variant_launches` the backward conv kernels by template instance; the
plain version never counts.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from davo_tpu_torch.kernels import rowconv, rowconv_ad
from davo_tpu_torch.models.common import conv_same_torch

KERNELS = ("conv_layer_tf32", "conv_layer_gate", "conv_layer_wgrad", "conv_layer_dgrad")
launches = {"forward": 0, "backward": 0}
device_launches = dict.fromkeys(KERNELS, 0)
variant_launches: dict[str, int] = {}


def reset_counts() -> None:
    for counts in (launches, device_launches):
        for name in counts:
            counts[name] = 0
    variant_launches.clear()


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=4096)
def plans(B: int, H: int, W: int, cin: int, cout: int, k: int, stride: int, sms: int = 132,
          smem_max: int = rowconv_ad.SMEM_OPTIN) -> dict:
    """The three launches of one layer (forward, dgrad, float32 wgrad) on
    a card of `sms` SMs and `smem_max` bytes of shared memory a block:
    {"layer": layer_plan, "dgrad": dgrad_plan, "wgrad": wgrad_plan}.
    Raises ValueError, naming the shape, for a layer any of them refuses."""
    ho, wo = -(-H // stride), -(-W // stride)
    return {
        "layer": rowconv_ad.layer_plan(B, H, W, rowconv.kernel_cin(cin), cout, k, stride, sms, smem_max),
        "dgrad": rowconv_ad.dgrad_plan(B, H, W, cin, cout, k, stride, sms, smem_max),
        "wgrad": rowconv_ad.wgrad_plan(B, ho, wo, cin, cout, k, stride, sms, cin, 4, smem_max),
    }


def _plans(x: torch.Tensor, weight: torch.Tensor, stride: int) -> dict:
    """`plans` of the layer on x's device (`rowconv_ad.device_limits`)."""
    return plans(*x.shape, weight.shape[0], weight.shape[-1], stride, *rowconv_ad.device_limits(x.device))


def _forward_cuda(x, weight, bias, stride):
    B, H, W, cin = x.shape
    cin_k = rowconv.kernel_cin(cin)
    if cin_k != cin:
        x = F.pad(x, (0, cin_k - cin))
    out = torch.empty((B, -(-H // stride), -(-W // stride), weight.shape[0]), dtype=torch.float32,
                      device=x.device)
    rowconv._launch_layer(x, weight, bias, out, stride, False, torch.float32, torch.float32)
    device_launches["conv_layer_tf32"] += 1
    launches["forward"] += 1
    return out


def _forward_plain(x, weight, bias, stride):
    """The forward on the CPU: products summed in float64, rounded once to
    float32, then the bias added in float32."""
    zero = weight.new_zeros(weight.shape[0], dtype=torch.float64)
    return conv_same_torch(x.double(), weight.double(), zero, stride).float() + bias


@torch.library.custom_op("davo::conv_same_f32", mutates_args=(), device_types=("cpu", "cuda"))
def _conv_same_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    if _on_cuda(x):
        return _forward_cuda(x, weight, bias, stride)
    return _forward_plain(x, weight, bias, stride)


@_conv_same_f32.register_fake
def _(x, weight, bias, stride):
    return x.new_empty((x.shape[0], -(-x.shape[1] // stride), -(-x.shape[2] // stride), weight.shape[0]))


def _setup_backward(ctx, inputs, output) -> None:
    x, weight, _, stride = inputs
    ctx.save_for_backward(x, weight)
    ctx.stride = stride


def _backward(ctx, g):
    """dx, dW and db that autograd needs: the gate, wgrad and dgrad
    kernels by the layer's plans for CUDA tensors, the plain versions for
    CPU tensors."""
    x, weight = ctx.saved_tensors
    s = ctx.stride
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dx = dw = db = None
    if _on_cuda(x):
        plan = _plans(x, weight, s)
        dz = rowconv_ad._launch_gate(g.float().contiguous(), None, None, False, counts=device_launches)
        if need_w or need_b:
            dw, db = rowconv_ad._launch_wgrad(x, dz, weight.shape, s, counts=device_launches,
                                              variants=variant_launches, plan=plan["wgrad"])
        if need_x:
            dx = rowconv_ad._launch_dgrad(dz, weight, x.shape, s, torch.float32, counts=device_launches,
                                          variants=variant_launches, plan=plan["dgrad"])
        launches["backward"] += 1
    else:
        g = g.float()
        if need_w or need_b:
            dw, db = rowconv_ad._wgrad_plain(x, g, weight.shape, s, accumulate=torch.float64)
        if need_x:
            dx = rowconv_ad._dgrad_plain(g, weight, x.shape, s, accumulate=torch.float64)
    return dx, dw if need_w else None, db if need_b else None, None


_conv_same_f32.register_autograd(_backward, setup_context=_setup_backward)


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """A float32 SAME convolution of NHWC `x` (B, H, W, Cin) with OIHW
    `weight` (odd k) and `bias`, stride 1 or 2: (B, ceil(H/s), ceil(W/s),
    Cout) float32, differentiable in all three. CUDA tensors run the
    split-TF32 kernels (a shape they refuse raises ValueError before any
    launch); CPU tensors the plain version."""
    tensors = (x, weight, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"conv_same takes float32 tensors, got {[t.dtype for t in tensors]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"conv_same: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no conv_same for device {device}")
    x = x.contiguous()
    if device.type == "cuda":
        _plans(x, weight, stride)
    return torch.ops.davo.conv_same_f32(x, weight, bias, stride)
