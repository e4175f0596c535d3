"""The plain reference (vobench/reference) against the program's CPU path
at the `tiny` sizes in float32: the serving forward's poses, flows and
attention weights, and one training step's loss and gradients, on the
same weights and frames."""

import dataclasses

import pytest
import torch

from vobench import data
from vobench.drivers import common
from vobench.reference.model import DavoModel as ReferenceModel
from vobench.reference.ops import Precision
from vobench.reference.train import TrainStep
from vobench.tests.tiny import model_dict, train_dict

TOL = 1e-5  # of the largest element: float32 on both sides, sums in another order


def _configs(**over):
    from davo_tpu_torch.models import presets

    model = model_dict(compute_dtype="float32", **over)
    cfg = presets.with_overrides("tiny", **model)
    train = {k: tuple(v) if isinstance(v, list) else v for k, v in train_dict().items()}
    return model, dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=4, **train))


def _inputs(model):
    frames, labels = data.make_sequence(8, model["img_height"], model["img_width"], 19, 3, "cpu")
    K = data.intrinsics(model["img_height"], model["img_width"], "cpu").expand(4, 3, 3)
    return frames, labels, {"target": frames[1:5], "sources": torch.stack([frames[0:4], frames[2:6]], 1),
                            "seg": labels[1:5], "K": K}


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("projection", [0, 4])
def test_serving_forward_matches_the_program(projection):
    model, cfg = _configs(costvol_feat_channels=projection)
    params = common.weights(model, 11, "cpu", dispnet=False)
    ref = common.build_reference(model, "float32", params, "cpu", dispnet=False)
    port = common.build_port(cfg, params, "cpu", dispnet=False)
    frames, labels, _ = _inputs(model)
    with torch.no_grad():
        got = port(frames[1:5], frames[0:4, None], seg=labels[1:5])
        want = ref(frames[1:5], frames[0:4, None], labels[1:5])
    assert _rel(got["poses"], want["poses"]) < TOL
    assert _rel(got["attn"], want["attn"]) < TOL
    for g, w in zip(got["flows"][0], want["flows"][0]):
        assert _rel(g, w) < TOL


def test_train_step_matches_the_program():
    from davo_tpu_torch.train import loop

    model, cfg = _configs()
    params = common.weights(model, 12, "cpu", dispnet=True)
    port = common.build_port(cfg, params, "cpu", dispnet=True)
    state = loop.TrainState(model=port, tx=loop.AdamTx(cfg, port.parameters()))
    ref_step = TrainStep(common.build_reference(model, "float32", params, "cpu", dispnet=True), train_dict())
    _, _, batch = _inputs(model)
    _, metrics = loop.make_train_step(cfg, "cpu")(state, batch)
    loss = ref_step(batch)
    assert abs(float(metrics["total"]) - loss) <= TOL * abs(loss)
    want = dict(zip([n for n, _ in ref_step.model.named_parameters()], ref_step.adam.mu))
    for (name, _), mu in zip(port.named_parameters(), state.tx.mu):
        scale = max(float(want[name].abs().max()), 1e-12)
        assert float((mu - want[name]).abs().max()) <= 1e-4 * scale, name


def test_reference_names_the_programs_parameters():
    """One state dict loads into both, strictly."""
    from davo_tpu_torch.models.davo import DavoModel

    model, cfg = _configs()
    for dispnet in (False, True):
        shapes = common.param_shapes(model, dispnet)
        port = DavoModel(cfg.model, device="meta", dispnet=dispnet)
        assert shapes == {k: tuple(v.shape) for k, v in port.state_dict().items()}


def test_precision_rounds_forward_only_in_fp8():
    x = torch.tensor([1.0 + 2**-5, 500.0, 1e-3], requires_grad=True)
    y = Precision("fp8").q(x)
    assert y.tolist() == [1.0, 448.0, float(torch.tensor(1e-3).to(torch.float8_e4m3fn).float())]
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]
    assert Precision("float32").q(x) is x
    with pytest.raises(ValueError):
        ReferenceModel({**model_dict(), "attention": "none"}, Precision("float32"))
