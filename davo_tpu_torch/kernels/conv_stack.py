"""A whole SAME conv stack in one kernel launch: the hand-written CUDA
kernel (`csrc/conv_stack.cu`) and its plain version.

The counterpart of the TPU kernel `davo_tpu/kernels/conv_stack.py`
(`fused_conv_stack` :179, `_stack_kernel` :145): every layer of a k x k
SAME conv stack (strides 1 and 2, bias, optional ReLU per layer) in one
launch, the activations between layers never returned to the caller.
Each layer computes what a layer of the TPU kernel computes: operands in
the compute dtype (the stack's input is cast to it first, as :83), the
products summed in float32, plus the float32 bias, then ReLU; between
layers the activation is rounded once to the compute dtype; the last
layer comes out in float32, unrounded.

The one difference from the reference's arguments: weights are the
port's OIHW float32 parameters (`Conv_0.weight`), as in the port's other
kernels, not HWIO. The kernel runs every layer on the tensor cores, the
fused layer kernel's device code (`csrc/conv_mma.cuh`): bfloat16 mode in
bf16 products, float32 mode in split TF32 (three TF32 products per term,
float32 sums). It takes each weight as `rowconv._packed` packs it for
that code (bf16 in its K order, or float32 TF32 hi and lo planes),
packed once per parameter and kept until the parameter changes; each
layer's tile width, channel tile and staging depth are the layer
kernel's plan (`mma_plan` in `csrc/conv_mma.cuh`), made in C at the
launch within the mode's shared memory a block. Packing is not part of
the launch: a call launches exactly one kernel.

Stride-2 layers read their input directly with Flax's low pad (total //
2) and take any input size: the reference's "even dims" rule comes from
its parity planes, a Mosaic workaround that this port has no need of (in
interpret mode the reference gives the XLA SAME conv at odd dims too).
`fusable_prefix` stays for callers that want the reference's prefix.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches the kernel or raises. `launches` counts wrapper calls that
launched, `device_launches` the kernels they launched (one per call);
the plain version never counts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from davo_tpu_torch.kernels import cuda_build, rowconv
from davo_tpu_torch.kernels.rowconv import _check_serving, _layer_plain
from davo_tpu_torch.models import common

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MAX_LAYERS = 16  # csrc/conv_stack.cu kMaxLayers

launches = 0
device_launches = 0


def reset_counts() -> None:
    global launches, device_launches
    launches = device_launches = 0


def same_pads(in_size: int, k: int, stride: int) -> tuple[int, int, int]:
    """XLA SAME padding: (out, pad_low, pad_high)."""
    return (-(-in_size // stride), *common.same_pads(in_size, k, stride))


def fusable_prefix(h: int, w: int, ks: Sequence[int], strides: Sequence[int]) -> int:
    """How many leading layers satisfy the reference's even-dims rule for
    stride-2 layers (the CUDA kernel itself takes any dims)."""
    n = 0
    for k, s in zip(ks, strides):
        if s == 2 and (h % 2 or w % 2):
            break
        h, w = same_pads(h, k, s)[0], same_pads(w, k, s)[0]
        n += 1
    return n


def _check(x, weights, biases, strides, relus, batch_tile, compute_dtype_name) -> torch.dtype:
    """The compute dtype; raises on arguments the reference refuses."""
    if compute_dtype_name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype_name {compute_dtype_name!r}; one of {sorted(COMPUTE_DTYPES)}")
    if not (len(weights) == len(biases) == len(strides) == len(relus) >= 1):
        raise ValueError("weights, biases, strides and relus must be non-empty and of one length")
    if x.shape[0] % batch_tile:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of batch_tile {batch_tile}")
    cin = x.shape[3]
    for i, (w, s) in enumerate(zip(weights, strides)):
        cout, wcin, kh, kw = w.shape
        if wcin != cin or kh != kw or kh % 2 == 0 or s not in (1, 2):
            raise ValueError(f"layer {i}: weights {tuple(w.shape)} on {cin} channels, stride {s}: "
                             "need (Cout, Cin, k, k) with odd k and stride 1 or 2")
        cin = cout
    return COMPUTE_DTYPES[compute_dtype_name]


def fused_conv_stack_plain(x, weights, biases, strides, relus, batch_tile=8,
                           compute_dtype_name="bfloat16"):
    """The plain version of `fused_conv_stack` (same arguments)."""
    compute = _check(x, weights, biases, strides, relus, batch_tile, compute_dtype_name)
    y = x.to(compute)
    n = len(weights)
    for i, (w, b, s, r) in enumerate(zip(weights, biases, strides, relus)):
        y = _layer_plain(y, w, b, s, r, torch.float32 if i == n - 1 else compute, compute)
    return y


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entry points of `csrc/conv_stack.cu`.
SIGNATURES = {
    "davo_conv_stack": [_I, _I, _P, _P, _P, _P, _P, _I, _P],
    "davo_conv_stack_last_launch": [_P],
}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("conv_stack")
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    lib.davo_cuda_error_string.argtypes = [_I]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def last_launch() -> dict:
    """The last kernel launch: blocks, blocks per SM (the occupancy
    query's answer at the launch's largest layer), dynamic shared memory
    in bytes and each layer's plan (tile width, nt 8-channel n-tiles,
    staging buffers)."""
    out = (ctypes.c_int * (4 + 3 * MAX_LAYERS))()
    _library().davo_conv_stack_last_launch(out)
    grid = dict(zip(("blocks", "blocks_per_sm", "smem"), out))
    grid["plans"] = [dict(zip(("tile_w", "nt", "stages"), out[4 + 3 * i: 7 + 3 * i])) for i in range(out[3])]
    return grid


def _stack_cuda(x, weights, biases, strides, relus, compute):
    """One launch of the stack kernel; returns the float32 output."""
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise TypeError(f"fused_conv_stack takes a contiguous float32 or bfloat16 NHWC x, got {x.dtype}")
    B, h, w, cin = x.shape
    n = len(weights)
    if n > MAX_LAYERS:
        raise ValueError(f"the kernel takes at most {MAX_LAYERS} layers, got {n}")
    act_bf16 = int(compute == torch.bfloat16)
    # Packed for the tensor cores in the mode's products, kept per parameter.
    ws = [rowconv._packed(w, compute, w.shape[1]) for w in weights]
    bs = [t.detach().float().contiguous() for t in biases]
    # Layer geometry, and each intermediate's place in one workspace
    # (256-byte aligned; written once, read by the next layer only).
    params, offsets, nbytes = [], [], 0
    for i, (wt, s, r) in enumerate(zip(weights, strides, relus)):
        k, cout = wt.shape[-1], wt.shape[0]
        ho, pad_t, _ = same_pads(h, k, s)
        wo, pad_l, _ = same_pads(w, k, s)
        # Layer 0 reads x (vector loads only where x is aligned for them),
        # the others the workspace in the compute dtype.
        x_bf16 = act_bf16 if i else int(x.dtype == torch.bfloat16)
        aligned = 1 if i else int(x.data_ptr() % (4 * x.element_size()) == 0)
        params += [x_bf16, aligned, h, w, cin, ho, wo, cout, k, s, pad_t, pad_l, int(bool(r))]
        if i < n - 1:
            offsets.append(nbytes)
            nbytes += -(-B * ho * wo * cout * (2 if act_bf16 else 4) // 256) * 256
        h, w, cin = ho, wo, cout
    out = torch.empty((B, h, w, cin), dtype=torch.float32, device=x.device)
    work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=x.device)
    ins = [x.data_ptr()] + [work.data_ptr() + off for off in offsets]
    outs = [work.data_ptr() + off for off in offsets] + [out.data_ptr()]

    def ptrs(values):
        return (ctypes.c_void_p * n)(*values)

    with torch.cuda.device(x.device):
        err = _library().davo_conv_stack(
            n, B, ptrs(ins), ptrs(outs), ptrs([t.data_ptr() for t in ws]), ptrs([t.data_ptr() for t in bs]),
            (ctypes.c_int * len(params))(*params), act_bf16,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"conv stack kernel launch failed: {_library().davo_cuda_error_string(err).decode()}")
    return out


def fused_conv_stack(x, weights, biases, strides, relus, batch_tile=8,
                     compute_dtype_name="bfloat16"):
    """Run the conv stack as one kernel launch (forward only: it raises
    under autograd, as the reference has no VJP).

    x: (B, H, W, Cin), any float dtype (cast to the compute dtype first);
    weights[i]: (Cout_i, Cin_i, k_i, k_i) OIHW float32 (odd k);
    biases[i]: (Cout_i,); strides[i] in {1, 2}; relus[i] a bool.
    compute_dtype_name: "bfloat16" or "float32". Returns (B, out_h,
    out_w, C_last) float32. B must be a multiple of `batch_tile` (the
    reference's grid step; the CUDA kernel spreads every layer over the
    whole card instead). Any input dims (see the module docstring).
    """
    global launches, device_launches
    compute = _check(x, weights, biases, strides, relus, batch_tile, compute_dtype_name)
    if _check_serving("fused_conv_stack", [x, *weights, *biases]) == "cpu":
        return fused_conv_stack_plain(x, weights, biases, strides, relus, batch_tile, compute_dtype_name)
    out = _stack_cuda(x, weights, biases, strides, relus, compute)
    device_launches += 1
    launches += 1
    return out
