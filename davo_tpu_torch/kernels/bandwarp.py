"""Banded bilinear warp: the hand-written CUDA kernels and their plain versions.

A bilinear sample of img (B, H, W, C) at coords (B, H, W, 2) = (u, v)
whose displacement is first clamped into the band |u - x| <= rh,
|v - y| <= rv, then whose coordinates are clamped into the frame. Exact
`bilinear_sample` wherever the displacement fits the band; band-edge
clamped beyond. `valid` comes from the unclamped coordinates.

The kernels (`csrc/bandwarp.cu`) replace the TPU kernels
`davo_tpu/kernels/bandwarp.py::_core_fwd` and `::_core_bwd`. The
backward is the TPU kernel's own rule, not autograd of a gather: d/du and
d/dv take the floor-cell subgradient of the hat and are masked where the
band or the high frame edge clamps (at u == W-1 the slope is 0, where a
gather's autograd would see the edge tap). `_BandedWarp` launches the
kernels for CUDA tensors (or raises) and runs `banded_warp_plain_fwd` /
`banded_warp_plain_bwd` for CPU tensors; `chip_smoke.py` holds each
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


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t.abs(), min=0.0)


def _dhat(t: torch.Tensor) -> torch.Tensor:
    """d/dt hat(t), the floor-cell convention: [0, 1) -> -1, [-1, 0) -> +1."""
    one = torch.ones_like(t)
    return torch.where(
        (t >= 0.0) & (t < 1.0), -one, torch.where((t >= -1.0) & (t < 0.0), one, torch.zeros_like(t))
    )


def _clamped(coords: torch.Tensor, rv: int, rh: int):
    """(u, v, ucp, vcp, uc, vc, xg, yg): band-clamped then frame-clamped."""
    _, H, W, _ = coords.shape
    xg = torch.arange(W, dtype=torch.float32, device=coords.device)
    yg = torch.arange(H, dtype=torch.float32, device=coords.device)[:, None]
    u, v = coords[..., 0], coords[..., 1]
    ucp = (u - xg).clamp(-rh, rh) + xg
    vcp = (v - yg).clamp(-rv, rv) + yg
    return u, v, ucp, vcp, ucp.clamp(0.0, W - 1.0), vcp.clamp(0.0, H - 1.0), xg, yg


def _pad(x: torch.Tensor, rv: int, rh: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H+2rv+1, W+2rh+1, C), x at [rv:rv+H, rh:rh+W]."""
    return F.pad(x, (0, 0, rh, rh + 1, rv, rv + 1))


def banded_warp_plain_fwd(img: torch.Tensor, coords: torch.Tensor, rv: int, rh: int) -> torch.Tensor:
    """The TPU kernel's band sum: (B, H, W, C) f32, coords (B, H, W, 2)."""
    B, H, W, C = img.shape
    _, _, _, _, uc, vc, xg, yg = _clamped(coords, rv, rh)
    pad = _pad(img, rv, rh)
    wv = [_hat(vc - (yg + oy)) for oy in range(-rv, rv + 2)]
    out = torch.zeros_like(img)
    for ox in range(-rh, rh + 2):
        wu = _hat(uc - (xg + ox))
        for j, oy in enumerate(range(-rv, rv + 2)):
            shifted = pad[:, rv + oy : rv + oy + H, rh + ox : rh + ox + W]
            out = out + (wv[j] * wu)[..., None] * shifted
    return out


def banded_warp_plain_bwd(
    img: torch.Tensor, coords: torch.Tensor, g: torch.Tensor, rv: int, rh: int,
    need_img: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The TPU kernel's backward: (d img or None, d coords (B, H, W, 2))."""
    B, H, W, C = img.shape
    u, v, ucp, vcp, uc, vc, xg, yg = _clamped(coords, rv, rh)
    mask_u = ((u - xg).abs() <= rh) & (ucp >= 0.0) & (ucp < W - 1.0)
    mask_v = ((v - yg).abs() <= rv) & (vcp >= 0.0) & (vcp < H - 1.0)
    pad = _pad(img, rv, rh)
    dpad = torch.zeros_like(pad) if need_img else None
    wv = [_hat(vc - (yg + oy)) for oy in range(-rv, rv + 2)]
    dwv = [_dhat(vc - (yg + oy)) for oy in range(-rv, rv + 2)]
    du = torch.zeros_like(u)
    dv = torch.zeros_like(v)
    for ox in range(-rh, rh + 2):
        t = uc - (xg + ox)
        wu, dwu = _hat(t), _dhat(t)
        for j, oy in enumerate(range(-rv, rv + 2)):
            shifted = pad[:, rv + oy : rv + oy + H, rh + ox : rh + ox + W]
            gc = (g * shifted).sum(-1)
            du = du + (dwu * wv[j]) * gc
            dv = dv + (wu * dwv[j]) * gc
            if need_img:
                dpad[:, rv + oy : rv + oy + H, rh + ox : rh + ox + W] += (wv[j] * wu)[..., None] * g
    dcoords = torch.stack([du * mask_u, dv * mask_v], -1)
    return (dpad[:, rv : rv + H, rh : rh + W] if need_img else None), dcoords


def _check(img: torch.Tensor, coords: torch.Tensor, rv: int, rh: int) -> None:
    if img.device != coords.device:
        raise ValueError(f"img on {img.device}, coords on {coords.device}")
    if img.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"banded warp kernel takes float32, got {img.dtype}/{coords.dtype}")
    if img.dim() != 4 or coords.shape != img.shape[:3] + (2,):
        raise ValueError(f"need (B, H, W, C) and (B, H, W, 2), got {tuple(img.shape)}/{tuple(coords.shape)}")
    if img.shape[3] < 1 or rv < 0 or rh < 0:
        raise ValueError(f"need C >= 1 and a band >= 0, got C={img.shape[3]} band=({rv}, {rh})")
    if not (img.is_contiguous() and coords.is_contiguous()):
        raise ValueError("banded warp kernel takes contiguous tensors")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("bandwarp")
    lib.davo_banded_warp_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.davo_banded_warp_f32.restype = ctypes.c_int
    lib.davo_banded_warp_bwd_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.davo_banded_warp_bwd_f32.restype = ctypes.c_int
    lib.davo_cuda_error_string.argtypes = [ctypes.c_int]
    lib.davo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.davo_cuda_error_string(err).decode()}")


def _launch_fwd(img: torch.Tensor, coords: torch.Tensor, rv: int, rh: int) -> torch.Tensor:
    global launches
    _check(img, coords, rv, rh)
    lib = _library()
    B, H, W, C = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.davo_banded_warp_f32(
            img.data_ptr(), coords.data_ptr(), out.data_ptr(), B, H, W, C, rv, rh, stream
        )
    _raise_on(lib, err, "banded warp kernel")
    launches += 1
    return out


def _launch_bwd(
    img: torch.Tensor, coords: torch.Tensor, g: torch.Tensor, rv: int, rh: int, need_img: bool
) -> tuple[torch.Tensor | None, torch.Tensor]:
    global backward_launches
    _check(img, coords, rv, rh)
    if g.shape != img.shape or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match the image")
    lib = _library()
    B, H, W, C = img.shape
    dcoords = torch.empty_like(coords)
    dimg = torch.empty_like(img) if need_img else None
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.davo_banded_warp_bwd_f32(
            img.data_ptr(), coords.data_ptr(), g.data_ptr(), dcoords.data_ptr(),
            dimg.data_ptr() if need_img else None, B, H, W, C, rv, rh, stream,
        )
    _raise_on(lib, err, "banded warp backward kernel")
    backward_launches += 1
    return dimg, dcoords


def _on_supported_device(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"no banded warp for device {t.device}")
    return t.device.type == "cuda"


class _BandedWarp(torch.autograd.Function):
    """Kernels for CUDA tensors, plain versions for CPU tensors. d/dimg
    is computed only when the image needs a gradient."""

    @staticmethod
    def forward(ctx, img, coords, rv, rh):
        ctx.save_for_backward(img, coords)
        ctx.band = (rv, rh)
        if _on_supported_device(img):
            return _launch_fwd(img, coords, rv, rh)
        return banded_warp_plain_fwd(img, coords, rv, rh)

    @staticmethod
    def backward(ctx, g):
        img, coords = ctx.saved_tensors
        rv, rh = ctx.band
        need_img = ctx.needs_input_grad[0]
        g = g.contiguous()
        if _on_supported_device(img):
            dimg, dcoords = _launch_bwd(img, coords, g, rv, rh, need_img)
        else:
            dimg, dcoords = banded_warp_plain_bwd(img, coords, g, rv, rh, need_img)
        return dimg, dcoords, None, None


def banded_warp(
    img: torch.Tensor, coords: torch.Tensor, rv: int = 4, rh: int = 16, fill: str = "border"
) -> tuple[torch.Tensor, torch.Tensor]:
    """img (B, H, W, C), coords (B, H, W, 2) -> (out (B, H, W, C), valid
    (B, H, W, 1)): `bilinear_sample`'s contract, differentiable in img
    and coords through the hand-written backward."""
    _, H, W, _ = img.shape
    u, v = coords[..., 0], coords[..., 1]
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0))[..., None].to(img.dtype)
    out = _BandedWarp.apply(
        img.float().contiguous(), coords.float().contiguous(), rv, rh
    )
    if fill == "border":
        return out, valid
    return out * valid, valid
