"""Train SegNetLite on synthetic GT labels, the in-repo seg source (port
of davo_tpu.train.seg).

Synthetic worlds render exact 19-class labels (`data/synthetic.py`
Voronoi regions + dynamic-object labels); a small encoder-decoder learns
them, and `cli prep --write-seg` applies it to real frames. The draws of
training images are the reference's (`default_rng(seed)`), the optimizer
optax's Adam at lr 2e-3 (`train.loop.AdamTx`), the metrics the
reference's dict.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from davo_tpu_torch import resolve_device
from davo_tpu_torch.config import Config, TrainConfig
from davo_tpu_torch.data.synthetic import SyntheticSequence
from davo_tpu_torch.models.segnet import SegNetLite
from davo_tpu_torch.train.loop import AdamTx


def _render_world(seed: int, n_frames: int, height: int, width: int):
    seq = SyntheticSequence(
        n_frames=n_frames, height=height, width=width, seed=seed, n_dynamic=2, dynamic_speed=0.6
    )
    imgs = np.stack([seq.frame(i) for i in range(n_frames)])
    labels = np.stack([seq.seg(i) for i in range(n_frames)])
    return imgs.astype(np.float32), labels.astype(np.int64)


def train_segnet(
    steps: int = 600,
    batch_size: int = 8,
    height: int = 128,
    width: int = 416,
    lr: float = 2e-3,
    seed: int = 0,
    n_worlds: int = 6,
    frames_per_world: int = 8,
    channels: tuple = (16, 32, 64, 128),
    num_classes: int = 19,
    log_every: int = 100,
    device: str | torch.device | None = None,
) -> tuple[SegNetLite, dict]:
    """Returns (model, metrics), trained on `device` (the GPU unless
    device="cpu") from the init of `seed`.

    Eval = held-out viewpoints of the training worlds (frames past the
    training range): synthetic static labels are Voronoi cells
    independent of the texture, so a held-out world has no
    appearance-to-label mapping to learn."""
    device = resolve_device(device)
    model = SegNetLite(num_classes=num_classes, channels=channels, device=device, seed=seed)
    rng = np.random.default_rng(seed)

    n_eval = max(2, frames_per_world // 4)
    imgs, labels, ev_imgs, ev_labels = [], [], [], []
    for w in range(n_worlds):
        im, lab = _render_world(seed + w, frames_per_world + n_eval, height, width)
        imgs.append(im[:frames_per_world])
        labels.append(lab[:frames_per_world])
        ev_imgs.append(im[frames_per_world:])
        ev_labels.append(lab[frames_per_world:])
    imgs = torch.from_numpy(np.concatenate(imgs)).to(device)
    labels = torch.from_numpy(np.concatenate(labels)).to(device)
    ev_imgs = np.concatenate(ev_imgs)
    ev_labels = np.concatenate(ev_labels)

    tx = AdamTx(Config(train=TrainConfig(learning_rate=lr)), model.parameters())
    model.train()
    t0 = time.monotonic()
    loss = torch.tensor(float("nan"))
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(imgs), batch_size)).to(device)
        logits = model(imgs[idx])
        loss = F.cross_entropy(logits.permute(0, 3, 1, 2), labels[idx])
        tx.zero_grad()
        loss.backward()
        tx.step(i)
        loss = loss.detach()
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"seg step {i:5d}  loss {float(loss):.4f}  ({time.monotonic() - t0:.0f}s)", flush=True)

    model.eval()
    with torch.inference_mode():
        pred = model(torch.from_numpy(ev_imgs).to(device)).argmax(-1).cpu().numpy()
    acc = float((pred == ev_labels).mean())
    ious = []
    for c in range(num_classes):
        union = ((pred == c) | (ev_labels == c)).sum()
        if union:
            ious.append(((pred == c) & (ev_labels == c)).sum() / union)
    metrics = {
        "final_loss": float(loss),
        "eval_pixel_acc": acc,
        "eval_miou": float(np.mean(ious)) if ious else 0.0,
        "eval_classes_present": len(ious),
    }
    return model, metrics
