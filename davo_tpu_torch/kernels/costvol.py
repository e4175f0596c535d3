"""Correlation cost volume: the hand-written CUDA kernel and its plain version.

out[b, h, w, k] = mean_c f1[b, h, w, c] * f2[b, h+dy_k, w+dx_k, c]

k runs over the (2s+1)^2 shifts, dy-major; f2 outside the frame counts
as 0. The kernel (`csrc/costvol.cu`) replaces the TPU kernels
`davo_tpu/kernels/costvol.py::cost_volume_pallas` and
`::cost_volume_pallas_rows`. On a CUDA tensor `cost_volume` launches it
or raises; `cost_volume_plain` runs only for tensors on the CPU, and
`chip_smoke.py` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from davo_tpu_torch.kernels import cuda_build

# Kernel launches since the last reset (the plain version never counts).
launches = 0


def cost_volume_plain(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, (2*search+1)^2): pad + shifted
    multiply-mean, as `davo_tpu.models.flownet.cost_volume`."""
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


def _check(f1: torch.Tensor, f2: torch.Tensor, search: int) -> None:
    if f1.device != f2.device:
        raise ValueError(f"f1 on {f1.device}, f2 on {f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"cost volume kernel takes float32, got {f1.dtype}/{f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"need two equal (B, H, W, C) maps, got {tuple(f1.shape)}/{tuple(f2.shape)}")
    if f1.shape[3] < 1 or search < 0:
        raise ValueError(f"need C >= 1 and search >= 0, got C={f1.shape[3]} search={search}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("cost volume kernel takes contiguous maps")


def _launch(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    global launches
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise NotImplementedError(
            "the cost volume kernel has no backward yet (it comes with the "
            "training slice); run inference under torch.inference_mode()"
        )
    _check(f1, f2, search)
    lib = _library()
    B, H, W, C = f1.shape
    out = torch.empty((B, H, W, (2 * search + 1) ** 2), dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = lib.davo_cost_volume_f32(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, search, stream
        )
    if err:
        raise RuntimeError(
            f"cost volume kernel launch failed: {lib.davo_cuda_error_string(err).decode()}"
        )
    launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("costvol")
    lib.davo_cost_volume_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.davo_cost_volume_f32.restype = ctypes.c_int
    lib.davo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def cost_volume(f1: torch.Tensor, f2: torch.Tensor, search: int) -> torch.Tensor:
    """(B, H, W, C) float32 x2 -> (B, H, W, (2*search+1)^2) float32.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    `cost_volume_plain`, which stays differentiable."""
    if f1.device.type == "cpu":
        return cost_volume_plain(f1, f2, search)
    if f1.device.type != "cuda":
        raise NotImplementedError(f"no cost volume for device {f1.device}")
    return _launch(f1, f2, search)


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
