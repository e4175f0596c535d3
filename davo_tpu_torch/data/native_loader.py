"""ctypes binding of the native multithreaded snippet-batch loader (port
of davo_tpu.data.native_loader).

The reference feeds training through native TF queue runners
(<ref>/data_loader.py); `PreparedSnippets` (data/prep.py) is the serial
Python reader for the same offline triplet layout, and this binding swaps
its decode loop for the C++ thread pool in `csrc/snippet_loader.cc`
(built with the codec by `imageio.load_library` into
`build/davo_tpu_torch/`). Yields dict batches like
`PreparedSnippets.batches`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from davo_tpu_torch.data.imageio import load_library


class NativeSnippetLoader:
    """Drop-in for `PreparedSnippets` + its batch loop, C++-backed.

    Decode runs on `threads` worker threads with a 3-deep ready queue, so
    `batches()` overlaps decode with the training step instead of
    serializing them. Per-epoch shuffling; ragged tail batches are
    dropped, as `PreparedSnippets.batches` drops them; an image whose
    size differs from the first item's raises at `batches()`."""

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        batch_size: int = 4,
        threads: int | None = None,
        seed: int = 0,
        shuffle: bool = True,
        loop: bool = True,
        with_seg: bool | None = None,
        with_gt: bool | None = None,
    ):
        if threads is None:
            # Oversubscribe 2x: decode threads stall on file I/O.
            threads = min(8, 2 * (os.cpu_count() or 4))
        self._h = None
        lib = load_library()
        self._lib = lib
        self.dir = data_dir
        with open(os.path.join(data_dir, f"{split}.txt")) as f:
            self.names = [line.strip() for line in f if line.strip()]
        if not self.names:
            raise ValueError(f"empty split {split} in {data_dir}")
        self.batch = batch_size
        h, w = ctypes.c_int(), ctypes.c_int()
        probe = os.path.join(data_dir, self.names[0] + ".jpg")
        if not lib.snl_probe(os.fsencode(probe), ctypes.byref(h), ctypes.byref(w)):
            raise ValueError(f"cannot probe {probe}")
        self.height, self.width = h.value, w.value
        # Prepared sets are uniform: presence checked on one item. None =
        # decode when present; False skips decode and transfer of lanes the
        # model does not consume.
        seg_avail = os.path.exists(os.path.join(data_dir, self.names[0] + "_seg.png"))
        gt_avail = os.path.exists(os.path.join(data_dir, self.names[0] + "_pose.txt"))
        self.has_seg = seg_avail if with_seg is None else (with_seg and seg_avail)
        self.has_gt = gt_avail if with_gt is None else (with_gt and gt_avail)
        blob = "\n".join(self.names).encode()
        self._h = lib.snl_create(
            os.fsencode(data_dir), blob, batch_size, self.height, self.width, threads, seed,
            int(shuffle), int(loop), int(self.has_seg), int(self.has_gt),
        )
        if not self._h:
            raise ValueError(f"native loader init failed ({len(self.names)} items, batch {batch_size})")

    def __len__(self) -> int:
        return len(self.names)

    def _error(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.snl_error(self._h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def batches(self, steps: int | None = None):
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        B, H, W = self.batch, self.height, self.width
        produced = 0
        while steps is None or produced < steps:
            target = np.empty((B, H, W, 3), np.float32)
            sources = np.empty((B, 2, H, W, 3), np.float32)
            K = np.empty((B, 3, 3), np.float32)
            seg = np.empty((B, H, W), np.int32) if self.has_seg else None
            gt = np.empty((B, 2, 4, 4), np.float32) if self.has_gt else None
            rc = self._lib.snl_next(
                self._h,
                target.ctypes.data_as(fp),
                sources.ctypes.data_as(fp),
                K.ctypes.data_as(fp),
                seg.ctypes.data_as(ip) if seg is not None else None,
                gt.ctypes.data_as(fp) if gt is not None else None,
            )
            if rc == 0:
                return
            if rc < 0:
                raise RuntimeError(f"native loader: {self._error()}")
            out = {"target": target, "sources": sources, "K": K}
            if seg is not None:
                out["seg"] = seg
            if gt is not None:
                out["gt_pose"] = gt
            yield out
            produced += 1

    def close(self) -> None:
        if self._h:
            self._lib.snl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
