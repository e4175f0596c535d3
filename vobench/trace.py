"""A bounded slice of a traced run under torch.profiler, reduced to what
the per-layer readers need: device time and launches by kernel, runtime
calls by name, the union of device intervals, and the longest idle gaps
labelled by the host operation that was running. Nothing is written to
disk."""

from __future__ import annotations

import bisect
import time
from collections import Counter

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
TOP = 10


def _profiler() -> profile:
    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    return profile(activities=[ProfilerActivity.CPU, *cuda])


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm_up() -> int:
    """Start the profiler once in set-up (its first start loads the
    tracing library) and return the blocking calls that profiling a bare
    synchronize counts, the slice's own share of `sync_calls`."""
    _sync()
    with _profiler() as prof:
        _sync()
    return sum(e.count for e in prof.key_averages() if e.key in SYNC_CALLS)


class Slice:
    """Profiles from `start()` to `stop()`; `stop` synchronises."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.prof = _profiler()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 == 0.0


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_label(cpu: list, starts: list[float], t: float) -> str:
    """The latest-starting host operation that contains time `t` (us),
    or "host code between operations"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 4000, -1), -1):
        name, a, b = cpu[j]
        if b >= t:
            return name
    return "host code between operations"


def reduce(sl: Slice, steps: int) -> dict:
    """The slice's records: window_s (host clock), busy_s (union of
    device intervals), steps, kernels [[name, device seconds, count]],
    runtime {call: count}, device_ops and idle_gaps (the breakdown)."""
    events = sl.prof.events()
    device, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            cpu.append((e.name, e.time_range.start, e.time_range.end))
    kernels: Counter = Counter()
    launches: Counter = Counter()
    for name, a, b in device:
        kernels[name] += (b - a) * 1e-6
        launches[name] += 1
    runtime = Counter(name for name, _, _ in cpu if name.startswith("cuda"))
    busy = _union([(a, b) for _, a, b in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    cpu.sort(key=lambda r: r[1])
    starts = [r[1] for r in cpu]
    if cpu:
        lo = cpu[0][1]
        hi = max(r[2] for r in cpu)
        edges = [(lo, lo)] + busy + [(hi, hi)]
        for (_, a_end), (b_start, _) in zip(edges, edges[1:]):
            if b_start > a_end:
                gaps.append((b_start - a_end, _host_label(cpu, starts, 0.5 * (a_end + b_start))))
    by_label: Counter = Counter()
    for length, label in gaps:
        by_label[label] += length * 1e-6
    return {
        "window_s": sl.t1 - sl.t0,
        "busy_s": busy_s,
        "steps": steps,
        "kernels": [[n, s, launches[n]] for n, s in kernels.most_common()],
        "runtime": dict(runtime),
        "device_ops": [[n[:120], s] for n, s in kernels.most_common(TOP)],
        "idle_gaps": [[n[:120], s] for n, s in by_label.most_common(TOP)],
    }
