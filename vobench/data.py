"""Inputs and weights of a run, made on the run's device from `--seed`.

Both sides of the correctness check get what is made here: the program
loads the weights and reads the frames, the reference (vobench/reference)
is given the same. Each kind of data draws from its own generator, seeded
from the run's seed and a fixed stream number, so the same seed gives the
same frames, labels and weights.

Frames are views of a seeded textured world: a canvas of noise summed
over octaves, panned and zoomed a little from frame to frame along a
smooth path, as a camera moving through a scene sees it; the labels are
a blocky map of the 19 classes panned the same way. Intrinsics are
KITTI odometry's (sequence 00's P2) scaled to the frame size.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# KITTI odometry sequence 00, camera 2, at 1241 x 376.
KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
KITTI_SIZE = (376, 1241)

STREAM_WEIGHTS, STREAM_FRAMES, STREAM_LABELS, STREAM_ORDER = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one kind of data of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2**63))


def make_params(shapes: dict[str, tuple[int, ...]], seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights for the named parameters, in two calls on the
    device: kernels (rank >= 2) truncated-normal with variance 1/fan-in
    (Flax's lecun normal), biases uniform in +-0.02."""
    gen = generator(seed, STREAM_WEIGHTS, device)
    names = sorted(shapes)
    kernels = [n for n in names if len(shapes[n]) >= 2]
    biases = [n for n in names if len(shapes[n]) < 2]
    out = {}
    total = sum(math.prod(shapes[n]) for n in kernels)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    at = 0
    for n in kernels:
        size, shape = math.prod(shapes[n]), shapes[n]
        std = math.sqrt(1.0 / math.prod(shape[1:])) / 0.87962566103423978
        out[n] = (flat[at : at + size] * std).reshape(shape)
        at += size
    total = sum(math.prod(shapes[n]) for n in biases)
    flat = (torch.rand(total, device=device, generator=gen) * 2 - 1) * 0.02
    at = 0
    for n in biases:
        size = math.prod(shapes[n])
        out[n] = flat[at : at + size].reshape(shapes[n]).clone()
        at += size
    return out


def intrinsics(height: int, width: int, device) -> torch.Tensor:
    """KITTI's K scaled to (height, width), (3, 3) float32."""
    fx, fy, cx, cy = KITTI_K
    sx, sy = width / KITTI_SIZE[1], height / KITTI_SIZE[0]
    return torch.tensor([[fx * sx, 0.0, cx * sx], [0.0, fy * sy, cy * sy], [0.0, 0.0, 1.0]], device=device)


def _path(n: int, gen: torch.Generator, device, pan_px: float) -> torch.Tensor:
    """(n, 3): x, y offsets in canvas pixels and a zoom, each a smooth
    random walk (a few sinusoids of seeded phase and period)."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    phase = torch.rand(9, generator=gen, device=device, dtype=torch.float64) * 2 * math.pi
    period = 40.0 + torch.rand(9, generator=gen, device=device, dtype=torch.float64) * 200.0

    def wave(i):
        return sum(torch.sin(2 * math.pi * t / period[j] + phase[j]) for j in range(3 * i, 3 * i + 3)) / 3

    x = pan_px * t + 0.8 * pan_px * torch.cumsum(wave(0), 0)
    y = 3.0 * wave(1)
    zoom = 1.0 + 0.02 * wave(2)
    return torch.stack([x, y, zoom], -1).float()


def _canvas(gen, device, height: int, width: int, channels: int) -> torch.Tensor:
    """(1, C, height, width) noise summed over octaves 4..128 px, in [0, 1]."""
    out = torch.zeros(1, channels, height, width, device=device)
    for cell, amp in ((4, 0.15), (8, 0.2), (16, 0.25), (32, 0.3), (64, 0.35), (128, 0.4)):
        g = torch.randn(1, channels, height // cell + 2, width // cell + 2, generator=gen, device=device)
        out += amp * F.interpolate(g, size=(height, width), mode="bicubic", align_corners=False)
    lo, hi = out.amin(dim=(2, 3), keepdim=True), out.amax(dim=(2, 3), keepdim=True)
    return (out - lo) / (hi - lo)


def _views(canvas, path, height, width, mode, chunk=64):
    """Each frame's view of the canvas along `path`: (n, C, H, W)."""
    _, C, Hc, Wc = canvas.shape
    n = path.shape[0]
    out = torch.empty(n, C, height, width, device=canvas.device)
    ys = torch.linspace(-1.0, 1.0, height, device=canvas.device)
    xs = torch.linspace(-1.0, 1.0, width, device=canvas.device)
    for a in range(0, n, chunk):
        p = path[a : a + chunk]
        zoom = p[:, 2, None, None]
        # Canvas pixel of each view pixel, then normalised to [-1, 1].
        cx = (p[:, 0, None, None] + 8.0 + (xs[None, None, :] + 1) / 2 * (width - 1) / zoom)
        cy = (p[:, 1, None, None] + (Hc - height) / 2 + (ys[None, :, None] + 1) / 2 * (height - 1) / zoom)
        cx, cy = torch.broadcast_tensors(cx, cy)
        grid = torch.stack([cx / (Wc - 1) * 2 - 1, cy / (Hc - 1) * 2 - 1], -1)
        out[a : a + chunk] = F.grid_sample(canvas.expand(len(p), -1, -1, -1), grid, mode=mode,
                                           padding_mode="border", align_corners=True)
    return out


def make_sequence(n_frames: int, height: int, width: int, num_classes: int, seed: int, device,
                  pan_px: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(frames (n, H, W, 3) float32 in [0, 1], labels (n, H, W) int32)."""
    gen = generator(seed, STREAM_FRAMES, device)
    path = _path(n_frames, gen, device, pan_px)
    span = float(path[:, 0].max()) + 16.0
    Hc, Wc = height + 16, int(math.ceil(width * 1.05 + span))
    frames = _views(_canvas(gen, device, Hc, Wc, 3), path, height, width, "bilinear").permute(0, 2, 3, 1)
    lgen = generator(seed, STREAM_LABELS, device)
    cells = torch.randint(0, num_classes, (1, 1, Hc // 16 + 1, Wc // 16 + 1), generator=lgen, device=device)
    label_canvas = F.interpolate(cells.float(), size=(Hc, Wc), mode="nearest")
    labels = _views(label_canvas, path, height, width, "nearest")[:, 0].round().to(torch.int32)
    return frames.contiguous(), labels.contiguous()


def permutation(n: int, seed: int, device) -> torch.Tensor:
    return torch.randperm(n, generator=generator(seed, STREAM_ORDER, device), device=device)
