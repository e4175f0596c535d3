"""Correlation cost volume: the hand-written CUDA kernels and their plain versions.

out[b, h, w, k] = mean_c f1[b, h, w, c] * f2[b, h+dy_k, w+dx_k, c]

k runs over the (2s+1)^2 shifts, dy-major; f2 outside the frame counts
as 0. The maps are float32 or bfloat16 (both the same); the volume is
float32, computed from the maps widened to float32, as the TPU kernel
does. The forward kernel (`csrc/costvol.cu`) replaces the TPU kernels
`davo_tpu/kernels/costvol.py::cost_volume_pallas` and
`::cost_volume_pallas_rows` and reads either dtype in place; the
backward kernel computes d f1 and d f2 of the same function in float32
(the JAX train step differentiates its XLA form).
`cost_volume` goes through `_CostVolume`, which launches the kernels for
CUDA tensors (or raises) and runs `cost_volume_plain` /
`cost_volume_plain_bwd` for CPU tensors; `chip_smoke.py` holds each
kernel against its plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from davo_tpu_torch.kernels import cuda_build

# Kernel launches since the last reset, forward and backward (one per
# wrapper call; the plain versions never count).
launches = 0
backward_launches = 0

# The forward kernel's C entry point for each map dtype, and the code it
# returns when no tile's window fits a block's shared memory
# (cudaErrorLaunchOutOfResources).
_ENTRY_POINTS = {torch.float32: "davo_cost_volume_f32", torch.bfloat16: "davo_cost_volume_bf16"}
_OUT_OF_RESOURCES = 701


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, (2*search+1)^2) float32: pad +
    shifted multiply-mean of the maps widened to float32, as
    `davo_tpu.models.flownet.cost_volume` on float32 maps."""
    f1, f2 = f1.float(), f2.float()
    B, H, W, C = f1.shape
    f2p = F.pad(f2, (0, 0, search, search, search, search))
    d = 2 * search + 1
    return torch.stack(
        [
            (f1 * f2p[:, dy : dy + H, dx : dx + W]).mean(-1)
            for dy in range(d)
            for dx in range(d)
        ],
        -1,
    )


def cost_volume_plain_bwd(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor, search: int,
    need_f1: bool = True, need_f2: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The transpose of `cost_volume_plain`: g (B, H, W, D) ->
    (d f1, d f2), each None when not asked for."""
    B, H, W, C = f1.shape
    d = 2 * search + 1
    gs = g / C
    f2p = F.pad(f2, (0, 0, search, search, search, search))
    df1 = torch.zeros_like(f1) if need_f1 else None
    df2p = torch.zeros_like(f2p) if need_f2 else None
    for dy in range(d):
        for dx in range(d):
            gk = gs[..., dy * d + dx, None]
            if need_f1:
                df1 = df1 + gk * f2p[:, dy : dy + H, dx : dx + W]
            if need_f2:
                df2p[:, dy : dy + H, dx : dx + W] += gk * f1
    df2 = df2p[:, search : search + H, search : search + W] if need_f2 else None
    return df1, df2


def _check(f1: torch.Tensor, f2: torch.Tensor, search: int) -> None:
    if f1.device != f2.device:
        raise ValueError(f"f1 on {f1.device}, f2 on {f2.device}")
    if f1.dtype != f2.dtype:
        raise TypeError(f"cost volume maps must share a dtype, got f1 {f1.dtype} and f2 {f2.dtype}")
    if f1.dtype not in _ENTRY_POINTS:
        raise TypeError(f"cost volume kernel takes float32 or bfloat16 maps, got {f1.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two equal (B, H, W, C) maps, got {tuple(f1.shape)}/{tuple(f2.shape)}")
    if f1.shape[3] < 1 or search < 0:
        raise ValueError(f"need C >= 1 and search >= 0, got C={f1.shape[3]} search={search}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost volume kernel takes contiguous maps")


def _launch(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    global launches
    _check(f1, f2, search)
    lib = _library()
    B, H, W, C = f1.shape
    out = torch.empty((B, H, W, (2 * search + 1) ** 2), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = getattr(lib, _ENTRY_POINTS[f1.dtype])(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, search, stream
        )
    if err == _OUT_OF_RESOURCES:
        raise ValueError(
            f"cost volume kernel: search {search} is too large; even a 1x4-pixel tile's "
            f"{2 * search + 1}x{2 * search + 4} window and outputs exceed a block's shared memory"
        )
    if err:
        raise RuntimeError(
            f"cost volume kernel launch failed: {lib.davo_cuda_error_string(err).decode()}"
        )
    launches += 1
    return out


def _launch_bwd(
    f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor, search: int,
    need_f1: bool, need_f2: bool,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    global backward_launches
    _check(f1, f2, search)
    B, H, W, C = f1.shape
    if g.shape != (B, H, W, (2 * search + 1) ** 2) or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match the volume")
    lib = _library()
    df1 = torch.empty_like(f1) if need_f1 else None
    df2 = torch.empty_like(f2) if need_f2 else None
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = lib.davo_cost_volume_bwd_f32(
            f1.data_ptr(), f2.data_ptr(), g.data_ptr(),
            df1.data_ptr() if need_f1 else None, df2.data_ptr() if need_f2 else None,
            B, H, W, C, search, stream,
        )
    if err:
        raise RuntimeError(
            f"cost volume backward kernel launch failed: {lib.davo_cuda_error_string(err).decode()}"
        )
    backward_launches += 1
    return df1, df2


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("costvol")
    for name in _ENTRY_POINTS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.davo_cost_volume_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.davo_cost_volume_bwd_f32.restype = ctypes.c_int
    lib.davo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no cost volume for device {t.device}")
    return t.device.type == "cuda"


class _CostVolume(torch.autograd.Function):
    """Kernels for CUDA tensors, plain versions for CPU tensors; the
    backward computes only the maps that need a gradient, in float32 on
    the maps widened to float32, and returns each in its map's dtype (as
    autograd through a `.float()` of the maps would)."""

    @staticmethod
    def forward(ctx, f1, f2, search):
        ctx.save_for_backward(f1, f2)
        ctx.search = search
        if _on_cuda(f1):
            return _launch(f1, f2, search)
        return cost_volume_plain(f1, f2, search)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        need_f1, need_f2 = ctx.needs_input_grad[:2]
        g = g.contiguous()
        w1, w2 = f1.float(), f2.float()
        if _on_cuda(f1):
            df1, df2 = _launch_bwd(w1, w2, g, ctx.search, need_f1, need_f2)
        else:
            df1, df2 = cost_volume_plain_bwd(w1, w2, g, ctx.search, need_f1, need_f2)
        return (
            None if df1 is None else df1.to(f1.dtype),
            None if df2 is None else df2.to(f2.dtype),
            None,
        )


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    """(B, H, W, C) x2, both float32 or both bfloat16 -> (B, H, W,
    (2*search+1)^2) float32, differentiable in both maps (CUDA tensors
    through the kernels, CPU tensors through the plain versions)."""
    return _CostVolume.apply(f1, f2, search)


def cost_volume_rows(
    f1: torch.Tensor, f2: torch.Tensor, height: int, width: int, search: int
) -> torch.Tensor:
    """Rows layout (B, H*W, C) x2 -> (B, H*W, (2*search+1)^2): the same
    function as `cost_volume` on the same memory (the counterpart of
    `cost_volume_pallas_rows`, whose column-wrap mask is the frame test)."""
    B, P, C = f1.shape
    if P != height * width:
        raise ValueError(f"rows P={P} != {height}x{width}")
    out = cost_volume(
        f1.reshape(B, height, width, C), f2.reshape(B, height, width, C), search
    )
    return out.reshape(B, P, -1)
