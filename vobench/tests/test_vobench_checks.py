"""The correctness check decides: a sound run of each tiny cell is
correct; a run with a fault planted underneath the timed path, or with
the fp8 control in the program's place, is not. Everything but the look
for a card is the benchmark's own run (`harness.run_cell` on the CPU)."""

import json
import time

import pytest

from vobench import faults, harness
from vobench.harness import BENCH_DIR
from vobench.tests.tiny import write_layout

SEED = 2**31 + 12345  # wider than 32 signed bits, as the benchmark's seeds are


def _run(layout, workload, system="port", seed=SEED):
    return harness.run_cell(workload, seed, 0.5, False, "cpu", time.perf_counter(), layout, system)


@pytest.mark.parametrize("workload", ["tiny-fast.serve", "tiny.serve", "tiny.train"])
def test_a_sound_run_is_correct(layout, workload):
    result = _run(layout, workload)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("workload,fault", [
    ("tiny.train", "unchanged_state"), ("tiny.train", "half_batch"), ("tiny.train", "altered_answer"),
    ("tiny-fast.serve", "half_batch"), ("tiny-fast.serve", "altered_answer"),
    ("tiny.serve", "half_batch"), ("tiny.serve", "altered_answer"),
])
def test_a_planted_fault_is_not_correct(layout, workload, fault):
    kind = "train" if "train" in workload else "serve"
    with faults.planted(fault, kind):
        result = _run(layout, workload)
    assert not result["correct"], result["checks"]


def _cell_limits(kind):
    names = {"serve": ["davo-fused.serve-b256", "davo.serve-b256"], "train": ["davo.train-b64"]}[kind]
    return [json.loads((BENCH_DIR / "limits" / f"{n}.json").read_text()) for n in names]


@pytest.mark.parametrize("workload", ["tiny-fast.serve", "tiny.train"])
def test_the_fp8_control_fails_each_cells_limits(tmp_path, workload):
    """The control (the reference in fp8 where the configuration states
    bf16, in the program's place) at the tiny sizes, judged by the limits
    of each benchmark cell of its kind."""
    kind = "train" if "train" in workload else "serve"
    for i, limits in enumerate(_cell_limits(kind)):
        layout = write_layout(tmp_path / str(i), limits=limits)
        result = _run(layout, workload, system="reference:fp8")
        assert not result["correct"], (limits, result["checks"])


def test_print_result_puts_the_checks_last(capsys):
    result = {"correct": False, "attempted": 3, "failed": 0, "metrics": {}, "device": {},
              "checks": {"pose_gap": {"value": 0.5, "limit": 0.1}}}
    harness.print_result(result)
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1] == "check pose_gap 0.5 limit 0.1 FAIL"
    assert json.loads(out.strip().splitlines()[-1]) == result
