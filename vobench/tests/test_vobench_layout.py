"""The harness finds a cell's configuration, traffic mix, limits and
per-layer readers by name: a throwaway set of them, added as files in a
directory of their own, runs without an edit to any file of the harness.
And BENCHMARK.json keeps to the contract's form."""

import json
import re
import time

from vobench import harness
from vobench.harness import BENCH_DIR

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_throwaway_cell_and_metric_are_found_by_name(layout, tmp_path):
    metrics = tmp_path / "metrics_dir"
    metrics.mkdir()
    for f in (BENCH_DIR / "metrics").glob("*.py"):
        (metrics / f.name).write_text(f.read_text())
    (metrics / "batches_seen.serve.py").write_text("def read(records):\n    return float(records['steps'])\n")
    (layout.traffic / "serve-other.json").write_text(json.dumps(
        {"kind": "serve", "batch": 2, "frames": 6, "pan_px": 0.5, "warmup": 1, "capture": 1,
         "profile_from": 0, "profile_batches": 1}))
    (layout.limits / "tiny.serve-other.json").write_text(json.dumps({"pose_gap": 0.05, "flow_gap": 0.05,
                                                                      "attn_gap": 0.05}))
    bench = json.loads(layout.benchmark.read_text())
    bench["workloads"].append({"name": "tiny.serve-other", "config": "tiny", "traffic": "serve-other",
                               "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({"name": "batches_seen.serve", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "runner", "moves": "serve_fps",
                               "workloads": ["tiny.serve-other"]})
    for m in bench["end_to_end"]:
        if "serve" in m["name"]:
            m["workloads"].append("tiny.serve-other")
    layout.benchmark.write_text(json.dumps(bench))
    layout = harness.Layout(benchmark=layout.benchmark, root=layout.root, traffic=layout.traffic,
                            limits=layout.limits, metrics=metrics)
    cell = harness.load_cell("tiny.serve-other", layout)
    assert cell.traffic["frames"] == 6 and [m["name"] for m in cell.per_layer] == ["batches_seen.serve"]
    result = harness.run_cell("tiny.serve-other", 3, 0.3, True, "cpu", time.perf_counter(), layout)
    assert result["correct"]
    assert result["metrics"]["batches_seen.serve"]["value"] == result["attempted"]
    result = harness.run_cell("tiny.serve-other", 3, 0.3, False, "cpu", time.perf_counter(), layout)
    assert set(result["metrics"]) == {"serve_fps", "serve_batch_ms_p95", "setup_s"}


def test_benchmark_file_keeps_to_the_contract():
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["vobench"] and 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("vobench/") and json.loads((BENCH_DIR.parent / c["file"]).read_text())
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", cells))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and harness.reader_path(m["name"]).exists()
        assert all(m["moves"] in e2e and harness._applies(e2e[m["moves"]], w) for w in m["workloads"])
    for w in cells:
        names = [m["name"] for m in bench["end_to_end"] if harness._applies(m, w)]
        assert "setup_s" in names and len(names) >= 2
        assert any(harness._applies(m, w) for m in bench["per_layer"])
