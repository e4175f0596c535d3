"""On the card: the command runs each cell once, briefly, and prints the
contract's last line with `correct` true. Skipped without a card."""

import json
import subprocess
import sys

import pytest

from vobench.harness import BENCH_DIR

CELLS = [w["name"] for w in json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(card, workload, trace):
    proc = subprocess.run([sys.executable, "-m", "vobench.run", "--workload", workload, "--seed", str(2**31 + 99),
                           "--seconds", "3", "--trace", str(trace)],
                          capture_output=True, text=True, cwd=BENCH_DIR.parent, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
