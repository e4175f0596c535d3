"""Profiling harness: torch.profiler traces + wall-clock timing (port of
davo_tpu.utils.profiling).

`timed` reports the minimum over several loops of the ms per call, the
timing protocol of the reference: a single loop can be contaminated by
one-off costs (allocator growth, a kernel library's first load). PyTorch
returns before the device finishes, so each loop waits for the devices
that hold the output, as the reference's `block_until_ready` does.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _devices(out) -> set[torch.device]:
    """The CUDA devices holding tensors in `out` (nested lists, tuples, dicts)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*map(_devices, out)) if out else set()
    return set()


def block_until_ready(out):
    """Wait until every CUDA device holding a tensor of `out` is done."""
    for device in _devices(out):
        torch.cuda.synchronize(device)
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace (host, and the GPU when there is one)
    into `log_dir/trace.json` (Chrome trace format, Perfetto-readable).
    The trace is written even when the body raises, as the reference's
    stops in a `finally`; the exception still propagates."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn, *args, iters: int = 20, loops: int = 5) -> dict:
    """Robust wall-clock timing of a device function.

    Returns {"ms": min-over-loops per-call ms, "all_ms": [...]}. Waits for
    the output's devices after the warm-up call and at the end of each loop.
    """
    block_until_ready(fn(*args))
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters * 1000.0)
    return {"ms": min(times), "all_ms": times}
