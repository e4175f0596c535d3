"""The port's bench path against the JAX package's: the speed-of-light
counts (`davo_tpu/bench/sol.py`), the throughput harnesses' protocol and
keys (`davo_tpu/bench/throughput.py`), `bench.py`'s JSON line, the
profiling helpers and `cli bench`, on the CPU at the `tiny` preset."""

import json
import os

import pytest
import torch

import bench as reference_bench
from davo_tpu.bench import sol as jsol
from davo_tpu.models import presets as jpresets
from davo_tpu_torch.bench import __main__ as bench_main
from davo_tpu_torch.bench import sol, throughput
from davo_tpu_torch.cli import main as cli
from davo_tpu_torch.models import presets
from davo_tpu_torch.utils import profiling

POSE_PREFIX = [  # davo-fast's fused pose prefix at 128x416, B=64
    (64, 128, 416, 9, 16, 7, 2), (64, 64, 208, 16, 32, 5, 2), (64, 32, 104, 32, 64, 3, 2),
    (64, 16, 52, 64, 128, 3, 2), (64, 8, 26, 128, 256, 3, 2),
]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "median", "spread_pct", "loops", "davo_preset_fps"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("shapes", [POSE_PREFIX, [(8, 13, 15, 4, 8, 3, 2), (8, 7, 8, 8, 16, 5, 1)]])
def test_conv_stack_sol_counts_equal_the_reference(shapes):
    got, want = sol.conv_stack_sol(shapes, measured_ms=2.0), jsol.conv_stack_sol(shapes, measured_ms=2.0)
    assert (got.flops, got.bytes_accessed, got.measured_us) == (want.flops, want.bytes_accessed, want.measured_us)
    # The H100's peaks in place of v5e's: 989 TFLOP/s bf16, 3.35 TB/s.
    assert got.compute_bound_us == pytest.approx(got.flops / 989e12 * 1e6)
    assert got.memory_bound_us == pytest.approx(got.bytes_accessed / 3.35e12 * 1e6)
    assert got.sol_fraction == pytest.approx(got.roofline_us / 2000.0)


def test_pose_prefix_sol_is_the_reckoned_bound():
    r = sol.conv_stack_sol(POSE_PREFIX)
    assert r.flops == pytest.approx(23.4e9, rel=2e-3)
    assert r.roofline_us == r.memory_bound_us == pytest.approx(49.8, rel=1e-2)
    assert sol.SolReport(1.0, 1.0, 1.0, 1.0, 1.0).sol_fraction is None


@pytest.mark.parametrize("name", sorted(presets.available()))
def test_model_flops_equal_the_reference(name):
    assert sol.model_flops(presets.get(name).model) == jsol.model_flops(jpresets.get(name).model)


def test_timed_and_profile_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(a, b):
        calls.append(1)
        return {"sum": a + b, "parts": [a, b]}

    x = torch.ones(3)
    result = profiling.timed(fn, x, x, iters=3, loops=4)
    assert len(calls) == 1 + 3 * 4
    assert set(result) == {"ms", "all_ms"} and len(result["all_ms"]) == 4
    assert result["ms"] == min(result["all_ms"]) > 0
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())


def test_profile_trace_writes_its_trace_when_the_body_raises(tmp_path):
    # The reference stops its trace in a `finally`: the trace is kept and
    # the exception still reaches the caller.
    with pytest.raises(ZeroDivisionError):
        with profiling.profile_trace(str(tmp_path / "trace")):
            torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
            raise ZeroDivisionError("body failed")
    trace = tmp_path / "trace" / "trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())


def test_bench_inference_and_train_step_keys_on_tiny():
    cfg = presets.get("tiny")
    inference = throughput.bench_inference(cfg, batch=2, iters=1, device="cpu")
    assert set(inference) == {"ms_per_batch", "frames_per_s", "batch"}
    assert inference["batch"] == 2 and inference["frames_per_s"] == pytest.approx(2e3 / inference["ms_per_batch"])
    train = throughput.bench_train_step(cfg, batch=2, iters=1, device="cpu")
    assert set(train) == {"ms_per_step", "steps_per_s", "frames_per_s", "batch"}
    assert train["steps_per_s"] == pytest.approx(1e3 / train["ms_per_step"])
    assert train["frames_per_s"] == pytest.approx(2e3 / train["ms_per_step"])


def test_bench_main_prints_one_json_line_with_bench_py_keys(capsys):
    out = bench_main.main("cpu", "tiny", "tiny", batch=2, warmup=1, iters=1, loops=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == out
    assert set(out) == BENCH_KEYS
    assert out["metric"] == "pose_infer_frames_per_s" and out["unit"] == "frames/s" and out["loops"] == 2
    assert out["value"] >= out["median"] > 0 and out["davo_preset_fps"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / reference_bench.BASELINE_FPS, abs=0.01)
    # bench.py's protocol and baseline constants.
    for name in ("BASELINE_FPS", "BATCH", "WARMUP", "ITERS", "LOOPS"):
        assert getattr(bench_main, name) == getattr(reference_bench, name)


def test_cli_bench_parses_and_passes_the_device(monkeypatch):
    args = cli.build_parser().parse_args(["bench", "--version", "davo-fast", "--device", "cpu"])
    assert args.fn is cli.cmd_bench and args.device == "cpu"
    seen = []
    monkeypatch.setattr(bench_main, "main", lambda device: seen.append(device))
    assert cli.main(["bench", "--device", "cpu"]) == 0 and seen == ["cpu"]


def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    cfg = presets.get("tiny")
    for call in (lambda: throughput.bench_inference(cfg, batch=2, iters=1),
                 lambda: throughput.bench_train_step(cfg, batch=2, iters=1),
                 lambda: bench_main.main(preset="tiny", parity_preset="tiny", batch=2, iters=1, loops=1),
                 lambda: cli.main(["bench"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_bench_module_runs_as_a_script_on_the_cpu():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "davo_tpu_torch.bench"], cwd=repo, capture_output=True, text=True, timeout=120,
    )
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a GPU")
    assert res.returncode != 0 and "no CUDA device" in res.stderr and res.stdout == ""
