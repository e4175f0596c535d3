"""Structured metrics: a JSONL stream, image panels as PNG files, and
TensorBoard where it is importable (port of davo_tpu.utils.metrics).

Every record is one JSON line {step, wall_time, **scalars} in
`<log_dir>/metrics.jsonl`; image summaries go to `<log_dir>/images/`
through the port's codec (`data/imageio.py`). TensorBoard output is best
effort, as in the reference.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from davo_tpu_torch.data import imageio


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # best effort: no TensorBoard install, no event files
                self._tb = None

    def log(self, step: int, scalars: dict) -> None:
        record = {"step": step, "wall_time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def log_images(self, step: int, images: dict) -> None:
        """images: name -> (H, W, 3) or (H, W) float array in [0, 1],
        written as `<log_dir>/images/<name>_<step:07d>.png` (and to
        TensorBoard when it is there)."""
        img_dir = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(img_dir, exist_ok=True)
        for name, img in images.items():
            arr = np.asarray(img, np.float32)
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], 3, -1)
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
            if self._tb is not None:
                self._tb.add_image(name, arr, step, dataformats="HWC")
            imageio.imwrite_png(os.path.join(img_dir, f"{name}_{step:07d}.png"), arr)

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
