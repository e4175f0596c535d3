"""Whole-model bf16 beyond `tiny`: the `davo-fast` forward at 128x416 in
bfloat16, the port against the reference (CPU).

Rounding flips make a bit-for-bit match impossible past the first
layers, so the criterion is chip_smoke.py's for the bf16 chains: for
each of 4 seeds (parameters and inputs), the port's mean gap to the
reference's bf16 output must be at most half the reference's own mean
gap between its bf16 and float32 outputs. A port that rounded elsewhere,
or ran in float32, would sit near 1. Both run as in use: the reference
under `jax.jit`, the port eagerly.

The flow net's levels (thousands of elements each) meet it at every
seed (0.09-0.29). The poses (B=2 pairs: 12 numbers a seed, each the
mean over the /32 map's 52 bf16-rounded pose-head outputs) do not: 0.55
over the 4 seeds (0.50, 0.43, 0.58, 0.87 each), held as a strict
expected failure (ROADMAP Queue 3); the pose encoder alone sits at
0.10-0.23 of its features' gap on these shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel

GAP_RATIO = 0.5  # chip_smoke.py ROWCONV_GAP_RATIO
J32 = jpresets.with_overrides("davo-fast", compute_dtype="float32").model
J16 = dataclasses.replace(J32, compute_dtype="bfloat16")
PORT16 = presets.with_overrides("davo-fast", compute_dtype="bfloat16").model
H, W = J32.img_height, J32.img_width


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    def outputs(cfg):
        return jax.jit(lambda p, t, s, g: JDavoModel(cfg).apply(p, t, s, seg=g, train=False))

    init = jax.jit(lambda k, t, s, g: JDavoModel(J32).init(k, t, s, seg=g, train=False))
    return init, outputs(J16), outputs(J32)


def _run(reference, seed):
    """(port bf16, reference bf16, reference float32) outputs of one seed."""
    init, apply16, apply32 = reference
    rng = np.random.default_rng(50 + seed)
    target = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    sources = rng.uniform(size=(2, 1, H, W, 3)).astype(np.float32)
    seg = rng.integers(0, J32.num_seg_classes, size=(2, H, W)).astype(np.int32)
    args = (jnp.asarray(target), jnp.asarray(sources), jnp.asarray(seg))
    params = init(jax.random.key(seed), *args)
    model = DavoModel(PORT16, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(target), torch.from_numpy(sources), seg=torch.from_numpy(seg))
    return got, apply16(params, *args), apply32(params, *args)


def _ratio(got, want16, want32):
    """The port's mean gap to the reference's bf16 over the reference's
    own mean bf16-to-float32 gap."""
    got, want16, want32 = (np.asarray(a, np.float32) for a in (got, want16, want32))
    reference_gap = np.abs(want16 - want32).mean()
    assert reference_gap > 0
    return np.abs(got - want16).mean() / reference_gap


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3: the port's mean pose gap is 0.55 of the reference's bf16-to-float32 gap over the 4 seeds "
    "(0.50, 0.43, 0.58, 0.87 each): 12 pose numbers a seed, each the mean of 52 bf16-rounded head outputs, "
    "while the flow net's levels and the pose encoder's features sit at 0.09-0.29"))
def test_davo_fast_bf16_poses_follow_reference_rounding(reference):
    """Over the 4 seeds, the port's mean pose gap to the reference's bf16
    at most half the reference's own bf16-to-float32 gap."""
    gaps, reference_gaps = [], []
    for seed in range(4):
        got, want16, want32 = _run(reference, seed)
        want16, want32 = np.asarray(want16["poses"], np.float32), np.asarray(want32["poses"], np.float32)
        gaps.append(np.abs(got["poses"].float().numpy() - want16).mean())
        reference_gaps.append(np.abs(want16 - want32).mean())
    print("pose gap ratio by seed", [round(float(g / r), 3) for g, r in zip(gaps, reference_gaps)])
    assert sum(gaps) <= GAP_RATIO * sum(reference_gaps)


@pytest.mark.parametrize("seed", range(4))
def test_davo_fast_bf16_flows_follow_reference_rounding(reference, seed):
    """The flow net's every pyramid level at davo-fast's depth (each
    thousands of elements): the gap criterion holds per level."""
    got, want16, want32 = _run(reference, seed)
    for g, w16, w32 in zip(got["flows"][0], want16["flows"][0], want32["flows"][0]):
        assert _ratio(g.float().numpy(), w16, w32) <= GAP_RATIO
