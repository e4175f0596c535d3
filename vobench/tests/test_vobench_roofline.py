"""The frozen roofline arithmetic against the bounds the program's
`chip_smoke.py` printed (PERF.md, section 6: ms, rounded as printed)."""

import json

import pytest

from vobench import roofline
from vobench.harness import BENCH_DIR


# The repo's `davo-fast` speed preset (an 8-channel correlation
# projection, search 3, 3 flow levels): not a benchmark configuration,
# since no public source states those settings, but the shape the
# program's `chip_smoke.py` printed its bounds and counts for.
FAST_OVERRIDES = {"flow_levels": 3, "flow_search_range": 3, "costvol_feat_channels": 8}


def _model(name):
    if name == "davo-fast":
        return {**_model("davo"), **FAST_OVERRIDES}
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())["model"]


def test_cost_volume_bounds():
    assert roofline.costvol_s(64, 32, 104, 8, 3, 2) * 1e3 == pytest.approx(0.0145, abs=5e-5)
    assert roofline.costvol_s(64, 16, 52, 8, 3, 2) * 1e3 == pytest.approx(0.0036, abs=5e-5)
    assert roofline.costvol_s(128, 32, 104, 32, 4, 2) * 1e3 == pytest.approx(0.0575, abs=5e-5)
    # The serving forward's volumes: davo-fast's two levels at B=64.
    assert roofline.serving_costvols_s(_model("davo-fast"), 64) * 1e3 == pytest.approx(0.0181, abs=1e-4)


def test_fused_chain_bounds():
    H, W = 128, 416
    pyramid = [(3, s, c) for c in (16, 32, 64) for s in (2, 1)]
    assert roofline._strided_chain_s(128, H, W, 3, pyramid, [1, 3, 5]) * 1e3 == pytest.approx(0.0408, abs=5e-5)
    attention = [(3, 2, c) for c in (16, 32, 64)]
    assert roofline._strided_chain_s(64, H, W, 2, attention, None) * 1e3 == pytest.approx(0.0061, abs=5e-5)
    pose = [(7, 2, 16), (5, 2, 32), (3, 2, 64), (3, 2, 128), (3, 2, 256)]
    assert roofline._strided_chain_s(64, H, W, 9, pose, None) * 1e3 == pytest.approx(0.0236, abs=5e-5)
    # One davo-fast request of 64 pairs: pyramid, attention, pose prefix and the /8, /4 levels
    # (0.0187 and 0.0631).
    want = 0.0408 + 0.0061 + 0.0236 + 0.0187 + 0.0631
    assert roofline.fused_serving_chains_s(_model("davo-fast"), 64) * 1e3 == pytest.approx(want, abs=3e-4)


def test_banded_warp_bounds():
    davo = json.loads((BENCH_DIR / "configs" / "davo.json").read_text())
    warps = roofline.train_step_warps(davo["model"], davo["train"], 64)
    assert len(warps) == 16
    forward = sum(roofline.banded_warp_s(*w[:4], False, False) for w in warps)
    assert forward * 1e3 == pytest.approx(0.124, abs=5e-4)
    assert roofline.banded_warp_s(64, 128, 416, 3, False, False) * 1e3 == pytest.approx(0.0326, abs=5e-5)
    assert roofline.banded_warp_s(64, 128, 416, 1, True, True) * 1e3 == pytest.approx(0.0285, abs=5e-5)
