"""The per-layer readers on a recorded profile table, and the profile
reduction on a profile of known intervals."""

import json

import pytest

from vobench import flops, roofline, trace
from vobench.harness import BENCH_DIR, Layout, load_reader

DAVO = json.loads((BENCH_DIR / "configs" / "davo.json").read_text())
FAST = json.loads((BENCH_DIR / "configs" / "davo-fused.json").read_text())

# A traced slice as `trace.reduce` leaves it: 2 batches or steps, device
# seconds and launches by kernel (names as the profiler demangles them).
PROFILE = {
    "window_s": 0.040, "busy_s": 0.030, "steps": 2, "sync_baseline": 1,
    "kernels": [
        ["void (anonymous namespace)::conv_mma_chunked_kernel<__nv_bfloat16, 3>(...)", 0.004, 20],
        ["void (anonymous namespace)::flow_level_input_kernel<__nv_bfloat16, 3>(...)", 0.001, 4],
        ["void (anonymous namespace)::cost_volume_kernel<__nv_bfloat16, 4>(...)", 0.002, 6],
        ["void (anonymous namespace)::banded_warp_fwd_kernel(...)", 0.0005, 32],
        ["void (anonymous namespace)::banded_warp_bwd_coords_kernel(...)", 0.0007, 32],
        ["Memcpy DtoH (Device -> Pageable)", 0.0001, 2],
    ],
    "runtime": {"cudaStreamSynchronize": 49, "cudaDeviceSynchronize": 1, "cudaLaunchKernel": 90},
}


def _records(config, traffic, **extra):
    cell = {"workload": "w", "model": config["model"], "traffic": traffic}
    if "train" in config:
        cell["train"] = config["train"]
    return {"cell": cell, "window_s": 10.0, "units": 25600, "steps": 100, "profile": PROFILE, **extra}


def read(name, records):
    return load_reader(name, Layout())(records)


def test_serving_readers():
    r = _records(FAST, {"batch": 256}, batches={"dispatch_ms": [1.0, 3.0], "flownet_ms": [8.0, 10.0],
                                               "posenet_ms": [2.0, 2.5]})
    assert read("dispatch_ms.serve", r) == 2.0
    assert read("flownet_ms.serve", r) == 9.0
    assert read("posenet_ms.serve", r) == 2.25
    assert read("idle_share.serve", r) == pytest.approx(25.0)
    r["flops_per_unit"], r["slice_units"] = flops.pose_pair_flops(FAST["model"]), 512
    want = 100 * flops.pose_pair_flops(FAST["model"]) * (25600 - 512) / (10 - 0.040) / 989e12
    assert read("mfu.serve", r) == pytest.approx(want)
    want = 100 * roofline.fused_serving_chains_s(FAST["model"], 256) * 2 / 0.005
    assert read("chain_roofline.serve", r) == pytest.approx(want)
    want = 100 * roofline.serving_costvols_s(DAVO["model"], 256) * 2 / 0.002
    assert read("costvol_roofline.serve", _records(DAVO, {"batch": 256})) == pytest.approx(want)


def test_training_readers():
    r = _records(DAVO, {"batch": 64})
    assert read("host_syncs.train", r) == pytest.approx((50 - 1) / 2)
    assert read("launches.train", r) == pytest.approx(96 / 2)
    assert read("idle_share.train", r) == pytest.approx(25.0)
    want = 100 * roofline.train_step_warps_s(DAVO["model"], DAVO["train"], 64) * 2 / 0.0012
    assert read("warp_roofline.train", r) == pytest.approx(want)
    r["flops_per_unit"], r["slice_units"] = flops.train_snippet_flops(DAVO["model"], DAVO["train"]), 128
    want = 100 * flops.train_snippet_flops(DAVO["model"], DAVO["train"]) * (25600 - 128) / (10 - 0.040) / 989e12
    assert read("mfu.train", r) == pytest.approx(want)


@pytest.mark.parametrize("name", ["chain_roofline.serve", "costvol_roofline.serve", "warp_roofline.train",
                                  "idle_share.serve", "idle_share.train", "host_syncs.train", "launches.train",
                                  "dispatch_ms.serve", "mfu.serve", "mfu.train"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"cell": {"model": DAVO["model"], "train": DAVO["train"], "traffic": {"batch": 64}},
             "window_s": 1.0, "units": 0, "steps": 0,
             "profile": {**PROFILE, "kernels": [], "busy_s": 0.0, "steps": 0, "runtime": {}}}
    assert read(name, empty) is None


def test_a_split_metric_shares_its_stem_reader():
    assert load_reader("idle_share.train", Layout()).__code__.co_filename.endswith("metrics/idle_share.py")
    assert load_reader("mfu.serve", Layout()).__code__.co_filename.endswith("metrics/mfu.py")
    with pytest.raises(FileNotFoundError):
        load_reader("no_such_metric.serve", Layout())


def test_union_and_gap_labels():
    assert trace._union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    cpu = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("later", 6.0, 7.0)]
    starts = [c[1] for c in cpu]
    assert trace._host_label(cpu, starts, 3.0) == "inner"
    assert trace._host_label(cpu, starts, 5.0) == "outer"
    assert trace._host_label(cpu, starts, 11.0) == "host code between operations"


def test_reduce_a_cpu_profile():
    """A slice profiled on the CPU: no device interval, one host operation."""
    import torch

    sl = trace.Slice()
    sl.start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    sl.stop()
    prof = trace.reduce(sl, steps=1)
    assert prof["busy_s"] == 0.0 and prof["window_s"] > 0
    assert prof["kernels"] == [] and prof["steps"] == 1
    assert len(prof["idle_gaps"]) <= trace.TOP
