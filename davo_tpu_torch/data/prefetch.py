"""Host -> device prefetch (port of davo_tpu.data.prefetch).

Batches (dicts of numpy arrays) go to the device one step ahead of the
consumer: on the GPU each batch is staged in pinned host memory and
copied with `non_blocking` copies on a side stream, so the copy overlaps
the previous step's compute; the consumer's stream waits on that copy
before it reads the batch. On the CPU the arrays are only wrapped.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Iterable, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class PrefetchStats:
    """Prefetch overlap accounting.

    host_s is the wall time the consumer loop loses to host-side batch
    production and copy enqueue; consumer_s is the time it spends between
    batches (device compute and bookkeeping). host_fraction near 1 means
    the input pipeline is the bottleneck.
    """

    batches: int = 0
    host_s: float = 0.0
    consumer_s: float = 0.0

    @property
    def host_fraction(self) -> float:
        total = self.host_s + self.consumer_s
        return self.host_s / total if total > 0 else 0.0

    def summary(self) -> dict:
        return {
            "batches": self.batches,
            "host_s": round(self.host_s, 4),
            "consumer_s": round(self.consumer_s, 4),
            "host_fraction": round(self.host_fraction, 4),
        }


def device_prefetch(
    batches: Iterable[dict],
    device: str | torch.device,
    buffer_size: int = 2,
    stats: PrefetchStats | None = None,
) -> Iterator[dict]:
    """Yield batches as tensors on `device`, staying `buffer_size` ahead.
    `stats`: optional PrefetchStats, filled in place while iterating."""
    device = torch.device(device)
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch: dict):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if copy_stream is None:
            return {k: t.to(device) for k, t in host.items()}, None
        with torch.cuda.stream(copy_stream):
            out = {k: t.pin_memory().to(device, non_blocking=True) for k, t in host.items()}
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def hand_over(item):
        out, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(ready)
            for t in out.values():
                t.record_stream(consumer)  # freed only after the consumer's use
        return out

    queue: collections.deque = collections.deque()
    it = iter(batches)
    with contextlib.suppress(StopIteration):
        for _ in range(buffer_size):
            queue.append(put(next(it)))
    last_yield = None
    while queue:
        item = queue.popleft()
        t0 = time.perf_counter()
        if stats is not None and last_yield is not None:
            stats.consumer_s += t0 - last_yield
        with contextlib.suppress(StopIteration):
            queue.append(put(next(it)))
        if stats is not None:
            stats.host_s += time.perf_counter() - t0
            stats.batches += 1
            last_yield = time.perf_counter()
        yield hand_over(item)
