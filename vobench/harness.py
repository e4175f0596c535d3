"""The benchmark's data-driven core: cells, configurations, traffic mixes,
limits and per-layer metric readers are files found by name.

    BENCHMARK.json          the cells (`workloads`) and metrics
    vobench/configs/<config>.json   a configuration (the file BENCHMARK.json names)
    vobench/traffic/<traffic>.json  a traffic mix; its `kind` names the driver
    vobench/drivers/<kind>.py       the driver that runs a mix of that kind
    vobench/limits/<workload>.json  each compared number's limit in a cell
    vobench/metrics/<metric>.py     a per-layer metric's reader: read(records);
                                    a metric `<stem>.<kind>` without a file of its
                                    own is read by vobench/metrics/<stem>.py

`run_cell` runs one cell once: set-up, the measured window, the check
against the plain reference, and the result line. It runs on the device
it is given; the command line (`vobench.run`) gives it the card only.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "davo_tpu")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the benchmark's files are."""

    benchmark: Path = ROOT / "BENCHMARK.json"
    root: Path = ROOT
    traffic: Path = BENCH_DIR / "traffic"
    limits: Path = BENCH_DIR / "limits"
    metrics: Path = BENCH_DIR / "metrics"


@dataclasses.dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What the measured window gives: work attempted and failed, the
    end-to-end metrics by name, and the records the per-layer readers read."""

    attempted: int
    failed: int
    metrics: dict[str, float]
    records: dict


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, layout: Layout = Layout()) -> Cell:
    """The cell named `workload` in the benchmark file, with its
    configuration, traffic mix, limits and metrics."""
    bench = _read_json(layout.benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {layout.benchmark}; have {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(layout.root / configs[entry["config"]]["file"])
    traffic = _read_json(layout.traffic / f"{entry['traffic']}.json")
    limits = _read_json(layout.limits / f"{workload}.json")
    return Cell(
        workload=workload, chips=entry["chips"], config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def reader_path(name: str, layout: Layout = Layout()) -> Path:
    """The reader file of the per-layer metric `name`: metrics/<name>.py,
    else metrics/<stem>.py for the part of the name before its first dot
    (one reader for a quantity split by the end-to-end metric it moves)."""
    for stem in (name, name.split(".")[0]):
        path = layout.metrics / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in {layout.metrics}")


def load_reader(name: str, layout: Layout = Layout()):
    """The `read(records)` function of the per-layer metric `name`."""
    path = reader_path(name, layout)
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_class(kind: str):
    """The `Driver` of a traffic mix's kind (vobench/drivers/<kind>.py)."""
    return importlib.import_module(f"vobench.drivers.{kind}").Driver


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared as whole names."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def device_info(device: torch.device, count: int, peak: int) -> dict:
    return {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": count,
        "memory_peak_bytes": peak,
    }


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, started: float,
             layout: Layout = Layout(), system: str = "port") -> dict:
    """One run of one cell: returns the result dict, checks last.
    `started` is the host clock (time.perf_counter) at process start;
    `system` is "port" (the program) or "reference:<precision>" (the
    plain reference in the program's place, the control)."""
    device = torch.device(device)
    cell = load_cell(workload, layout)
    drv = driver_class(cell.traffic["kind"])(cell, seed, device, trace, system)
    if device.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist once CUDA is initialised
        torch.cuda.reset_peak_memory_stats(device)
    drv.prepare()
    setup_s = time.perf_counter() - started
    window = drv.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    checks = drv.check()
    dev = device_info(device, cell.chips, peak)
    if trace:
        prof = window.records.get("profile", {})
        dev["busy_s"] = prof.get("busy_s", 0.0)
        dev["window_s"] = prof.get("window_s", 0.0)
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], layout)(window.records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": window.attempted,
        "failed": window.failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace and "breakdown" in window.records:
        result["breakdown"] = window.records["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
