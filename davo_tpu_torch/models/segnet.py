"""SegNetLite: the in-repo segmentation source for the flow_seg cue (port
of davo_tpu.models.segnet).

The reference consumes precomputed DeepLab masks it never produces
(SURVEY.md R8); this small encoder-decoder, trained on synthetic labels
(`train/seg.py`), lets `cli prep --write-seg` stamp `*_seg.png` onto any
prepared tree. Stride-2 `ConvBlock` encoder, skip-connected nearest
upsample decoder, NHWC, parameters float32 and named as in the Flax tree
(`enc0`, `enc0b`, ..., `dec3b`, `head`), so `convert.load_flax_params`
loads a reference tree.

Checkpoints are the reference's files: `segnet.msgpack`, the Flax
parameter tree as `flax.serialization.to_bytes` writes it (msgpack maps
with str keys, each array an ext type 1 holding the msgpack of `(shape,
dtype name, C-order bytes)`), and `segnet.json`, so a SegNet trained by
either package labels frames in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.nn as nn

from davo_tpu_torch import exact_f32, resolve_device
from davo_tpu_torch.convert import load_flax_params, state_dict_to_flax
from davo_tpu_torch.models.common import Conv, ConvBlock, dtype_of, lecun_init_, resize_nearest

_EXT_NDARRAY = 1  # flax.serialization's msgpack ext type for arrays


class SegNetLite(nn.Module):
    """Per-pixel class logits: (B, H, W, 3) -> (B, H, W, num_classes),
    float32. Built with Flax's default init from `seed` on `device` (the
    GPU unless device="cpu")."""

    def __init__(self, num_classes: int = 19, channels: tuple = (16, 32, 64, 128),
                 compute_dtype: str = "bfloat16", *, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        exact_f32()
        self.num_classes = num_classes
        self.channels = tuple(channels)
        self.compute_dtype = compute_dtype
        dt = dtype_of(compute_dtype)
        cin = 3
        for i, ch in enumerate(self.channels):
            setattr(self, f"enc{i}", ConvBlock(cin, ch, 7 if i == 0 else 3, 2, dt))
            setattr(self, f"enc{i}b", ConvBlock(ch, ch, 3, 1, dt))
            cin = ch
        up = list(self.channels[::-1][1:]) + [self.channels[0]]
        for i, ch in enumerate(up):
            skip = len(self.channels) - 2 - i
            setattr(self, f"dec{i}", ConvBlock(cin, ch, 3, 1, dt))
            setattr(self, f"dec{i}b", ConvBlock(ch + (self.channels[skip] if skip >= 0 else 0), ch, 3, 1, dt))
            cin = ch
        self.head = Conv(cin, num_classes, 3, 1, dt)
        lecun_init_(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.to(dtype_of(self.compute_dtype))
        skips = []
        for i in range(len(self.channels)):
            x = getattr(self, f"enc{i}b")(getattr(self, f"enc{i}")(x))
            skips.append(x)
        n = len(self.channels)
        for i in range(n):
            skip = n - 2 - i
            hw = tuple(skips[skip].shape[1:3]) if skip >= 0 else tuple(img.shape[1:3])
            x = getattr(self, f"dec{i}")(resize_nearest(x, hw))
            if skip >= 0:
                x = torch.cat([x, skips[skip]], dim=-1)
            x = getattr(self, f"dec{i}b")(x)
        return self.head(x).float()


# ---------------------------------------------------------------------------
# Checkpoint IO: the reference's segnet.msgpack + segnet.json.
# ---------------------------------------------------------------------------


def _ext_default(obj):
    import msgpack

    if isinstance(obj, np.ndarray):
        payload = msgpack.packb((obj.shape, obj.dtype.name, obj.tobytes("C")), use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"segnet.msgpack: unsupported msgpack ext type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode()), count=-1).reshape(shape)


def save_segnet(directory: str, model: SegNetLite) -> None:
    import msgpack

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "segnet.msgpack"), "wb") as f:
        f.write(msgpack.packb(state_dict_to_flax(model.state_dict()), default=_ext_default, strict_types=True))
    with open(os.path.join(directory, "segnet.json"), "w") as f:
        json.dump(
            {
                "num_classes": model.num_classes,
                "channels": list(model.channels),
                "compute_dtype": model.compute_dtype,
            },
            f,
        )
        f.write("\n")


def load_segnet(directory: str, device: str | torch.device | None = None) -> SegNetLite:
    """The SegNetLite a `save_segnet` of either package wrote, on `device`
    (the GPU unless device="cpu"). A tree that does not match the json's
    model raises."""
    import msgpack

    with open(os.path.join(directory, "segnet.json")) as f:
        meta = json.load(f)
    model = SegNetLite(
        num_classes=meta["num_classes"], channels=tuple(meta["channels"]),
        compute_dtype=meta["compute_dtype"], device=device,
    )
    with open(os.path.join(directory, "segnet.msgpack"), "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    load_flax_params(model, tree)
    return model.eval()


def make_seg_infer(directory: str, device: str | torch.device | None = None):
    """Batched labeler: (B, H, W, 3) float [0, 1] numpy -> (B, H, W)
    uint8 numpy, on `device` (the GPU unless device="cpu")."""
    model = load_segnet(directory, device)
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def infer(img: np.ndarray) -> np.ndarray:
        logits = model(torch.as_tensor(np.asarray(img, np.float32)).to(dev))
        return logits.argmax(-1).to(torch.uint8).cpu().numpy()

    return infer
