"""SegNetLite, its trainer and its checkpoint files against the JAX
package (CPU, float32).

Tolerances: logits within 1e-5 of the largest logit (the same float32
convolutions in another order); three `train_segnet` steps from the same
init to a loss within 1e-4 relative (Adam amplifies the gradients'
float32 noise a little in each step); checkpoint round trips exact (the
same float32 bytes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models import segnet as jsegnet
from davo_tpu.train import seg as jseg
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.models import segnet
from davo_tpu_torch.train import seg as tseg

H, W = 32, 104


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reference(channels=(16, 32, 64, 128), seed=0):
    model = jsegnet.SegNetLite(channels=channels, compute_dtype="float32")
    return model, model.init(jax.random.key(seed), jnp.zeros((1, H, W, 3), jnp.float32))


def _port(params, channels=(16, 32, 64, 128)):
    model = segnet.SegNetLite(channels=channels, compute_dtype="float32", device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    return model


def _images(n=2, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("channels", [(16, 32, 64, 128), (8, 16)])
def test_logits_match_reference(channels):
    jmodel, params = _reference(channels)
    model = _port(params, channels)
    img = _images()
    want = np.asarray(jmodel.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = model(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (2, H, W, 19)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_three_training_steps_match_reference(monkeypatch):
    """The same image draws, Adam at 2e-3 and cross entropy: the third
    step's loss (the reference's `final_loss`) within 1e-4 relative."""
    monkeypatch.setattr(jseg, "SegNetLite", functools.partial(jsegnet.SegNetLite, compute_dtype="float32"))
    kw = dict(steps=3, batch_size=2, height=H, width=W, n_worlds=2, frames_per_world=4, log_every=0, seed=0)
    _, _, want = jseg.train_segnet(**kw)
    _, params = _reference(seed=0)
    # The port's init is Flax's in law, not in bits: start from the reference's.
    monkeypatch.setattr(tseg, "SegNetLite", lambda **_: _port(params))
    _, got = tseg.train_segnet(**kw, device="cpu")
    assert set(got) == set(want) == {"final_loss", "eval_pixel_acc", "eval_miou", "eval_classes_present"}
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-4)
    assert got["eval_classes_present"] == want["eval_classes_present"]


def test_checkpoint_files_round_trip_both_ways(tmp_path):
    """segnet.msgpack and segnet.json written by either package load in
    the other with the same parameters; the labelers agree."""
    jmodel, params = _reference((8, 16))
    jsegnet.save_segnet(str(tmp_path / "ref"), jmodel, params)
    model = segnet.load_segnet(str(tmp_path / "ref"), device="cpu")
    assert (model.channels, model.compute_dtype) == ((8, 16), "float32")
    for key, value in _port(params, (8, 16)).state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key

    segnet.save_segnet(str(tmp_path / "port"), model)
    jmodel2, params2 = jsegnet.load_segnet(str(tmp_path / "port"))
    assert jmodel2 == jmodel
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, params2), jax.tree.map(np.asarray, params))

    img = _images(3, seed=2)
    got = segnet.make_seg_infer(str(tmp_path / "port"), device="cpu")(img)
    want = np.asarray(jsegnet.make_seg_infer(str(tmp_path / "ref"))(img))
    assert got.dtype == np.uint8 and got.shape == (3, H, W)
    np.testing.assert_array_equal(got, want)
