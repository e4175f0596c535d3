"""The frozen operation counts against torch.utils.flop_counter over the
plain reference at the benchmark's configurations (B=1 on the CPU)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vobench import data, flops
from vobench.drivers import common
from vobench.harness import BENCH_DIR

SHARE = 0.03  # analytic against counted: the losses' small matrix products are not in the analytic count


# The repo's `davo-fast` speed preset (an 8-channel correlation
# projection, search 3, 3 flow levels): not a benchmark configuration,
# since no public source states those settings, but the shape the
# program's `chip_smoke.py` printed its bounds and counts for.
FAST_OVERRIDES = {"flow_levels": 3, "flow_search_range": 3, "costvol_feat_channels": 8}


def _config(name):
    if name == "davo-fast":
        davo = _config("davo")
        return {**davo, "model": {**davo["model"], **FAST_OVERRIDES}}
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def _batch(model):
    H, W = model["img_height"], model["img_width"]
    frames, labels = data.make_sequence(3, H, W, model["num_seg_classes"], 1, "cpu")
    return {"target": frames[1:2], "sources": torch.stack([frames[0:1], frames[2:3]], 1), "seg": labels[1:2],
            "K": data.intrinsics(H, W, "cpu")[None]}


@pytest.mark.parametrize("name", ["davo-fast", "davo", "davo-fused"])
def test_pose_pair_flops_counts_the_serving_forward(name):
    model = _config(name)["model"]
    ref = common.build_reference(model, "float32", common.weights(model, 1, "cpu", False), "cpu", False)
    b = _batch(model)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(b["target"], b["sources"][:, :1], b["seg"])
    want = flops.pose_pair_flops(model) - flops.correlation_pair_flops(model)
    assert abs(counter.get_total_flops() - want) <= SHARE * want


def test_train_snippet_flops_counts_the_training_step():
    from vobench.reference.train import TrainStep

    config = _config("davo")
    model, train = config["model"], config["train"]
    ref = common.build_reference(model, "float32", common.weights(model, 1, "cpu", True), "cpu", True)
    step = TrainStep(ref, train)
    with FlopCounterMode(display=False) as counter:
        step(_batch(model))
    want = flops.train_snippet_flops(model, train)
    assert abs(counter.get_total_flops() - want) <= SHARE * want
    # The forward's convolutions and matrix products, and DispNet's part
    # of them (three images a snippet with geometry consistency).
    forward = 2 * (flops.pose_pair_flops(model) - flops.correlation_pair_flops(model))
    disp = 3 * flops.dispnet_image_flops(model)
    assert (forward + disp) / 1e9 == pytest.approx(28.98, abs=0.05)
    assert disp / 1e9 == pytest.approx(23.57, abs=0.05)


def test_pose_pair_flops_is_the_programs_count():
    """The frozen copy gives what the program's `bench/sol.model_flops`
    gave for the two configurations (2.267 and 2.736 GFLOP a pair)."""
    assert flops.pose_pair_flops(_config("davo-fast")["model"]) / 1e9 == pytest.approx(2.267, abs=5e-4)
    assert flops.pose_pair_flops(_config("davo")["model"]) / 1e9 == pytest.approx(2.736, abs=5e-4)
    assert flops.pose_pair_flops(_config("davo-fused")["model"]) == flops.pose_pair_flops(_config("davo")["model"])
