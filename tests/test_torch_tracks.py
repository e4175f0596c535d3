"""davo_tpu_torch.ba.tracks against davo_tpu.ba.tracks on the CPU.

Tolerances: the host-side tracking (`bilinear_at`, `track_window`,
`anchor_grid`, the float64 landmark backprojection) bit for bit, as it
is the same numpy; `refine_trajectory_tracked` with exact flow on a small
world within 1e-4 of the largest translation (float32 BA on both sides);
`make_flow_fn` at the `tiny` preset at the f32 flow nets' 1e-4
(tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.ba import tracks as jtracks
from davo_tpu.config import BAConfig as JBAConfig
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu_torch.ba import tracks
from davo_tpu_torch.config import BAConfig
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.data.synthetic import DYNAMIC_LABEL_START, SyntheticSequence
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.davo import DavoModel


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def seq():
    return SyntheticSequence(n_frames=10, height=48, width=64, seed=2, plane_z=15.0, forward_speed=1.0)


def _flows(seq, M):
    return (np.stack([seq.gt_flow(i, i + 1) for i in range(M - 1)]),
            np.stack([seq.gt_flow(i + 1, i) for i in range(M - 1)]))


def test_bilinear_at_matches_reference_bit_for_bit(rng):
    field = rng.normal(size=(7, 9, 2))
    uv = np.concatenate([rng.uniform(-2, 11, (50, 2)), [[0.0, 0.0], [8.0, 6.0], [3.0, 2.0]]])
    np.testing.assert_array_equal(tracks.bilinear_at(field, uv), jtracks.bilinear_at(field, uv))


def test_track_window_matches_reference_bit_for_bit(seq):
    ff, fb = _flows(seq, 6)
    ff_bad = ff.copy()
    ff_bad[1, :, :32] += 5.0  # the corrupted half fails the round-trip gate
    uv0 = tracks.anchor_grid(48, 64, 8)
    for f in (ff, ff_bad):
        for fb_px in (1.0, 0.3):
            obs, valid = tracks.track_window(f, fb, uv0, fb_px)
            jobs, jvalid = jtracks.track_window(f, fb, uv0, fb_px)
            np.testing.assert_array_equal(obs, jobs)
            np.testing.assert_array_equal(valid, jvalid)
    assert valid[-1].any() and not valid[-1].all()


def test_anchor_grid_matches_reference_bit_for_bit():
    dyn = SyntheticSequence(n_frames=4, height=48, width=64, seed=3, n_dynamic=3)
    seg = dyn.seg(0)
    labels = tuple(range(DYNAMIC_LABEL_START, 19))
    for step in (4, 6, 8):
        np.testing.assert_array_equal(tracks.anchor_grid(48, 64, step), jtracks.anchor_grid(48, 64, step))
        got = tracks.anchor_grid(48, 64, step, seg=seg, exclude_labels=labels)
        np.testing.assert_array_equal(got, jtracks.anchor_grid(48, 64, step, seg=seg, exclude_labels=labels))
    assert len(got) < len(tracks.anchor_grid(48, 64, 8))


def test_build_tracked_problem_matches_reference(seq):
    ff, fb = _flows(seq, 4)
    uv0 = tracks.anchor_grid(48, 64, 8)
    obs, valid = tracks.track_window(ff, fb, uv0)
    got = tracks.build_tracked_problem(seq.poses[:4], seq.depth(0), seq.K, obs, valid, device="cpu")
    want = jtracks.build_tracked_problem(seq.poses[:4], seq.depth(0), seq.K, obs, valid)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.observations.shape == (4, len(uv0), 2) and got.mask[0].min() == 1.0


def test_refine_trajectory_tracked_matches_reference(seq, rng):
    gt = seq.poses.copy()
    depths = np.stack([seq.depth(i) for i in range(10)])
    noisy = gt.copy()
    for i in range(2, 10):
        noisy[i] = noisy[i] @ geo.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6))).numpy()
    kw = dict(window_size=6, max_iterations=8, damping=1e-4, huber_delta=3.0)
    out = tracks.refine_trajectory_tracked(BAConfig(**kw), noisy, depths, seq.K, seq.gt_flow, grid_step=6,
                                           device="cpu")
    want = jtracks.refine_trajectory_tracked(JBAConfig(**kw), noisy, depths, seq.K, seq.gt_flow, grid_step=6)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * np.abs(want[:, :3, 3]).max())
    err_before = np.linalg.norm(noisy[2:, :3, 3] - gt[2:, :3, 3], axis=-1).mean()
    err_after = np.linalg.norm(out[2:, :3, 3] - gt[2:, :3, 3], axis=-1).mean()
    assert err_after < err_before * 0.3, (err_before, err_after)


def test_make_flow_fn_matches_reference():
    """The net-backed flow source at `tiny` on one world's frames, the
    reference's parameters loaded into the port's DavoModel."""
    jcfg, cfg = jpresets.get("tiny"), presets.get("tiny")
    world = SyntheticSequence(n_frames=4, height=48, width=64, seed=5)
    frames = np.stack([world.frame(i) for i in range(4)]).astype(np.float32)
    seg = np.stack([world.seg(i) for i in range(2)])
    params = JDavoModel(jcfg.model).init(
        jax.random.key(0), jnp.asarray(frames[1:3]), jnp.asarray(frames[:2, None]), seg=jnp.asarray(seg),
        train=False,
    )
    model = DavoModel(cfg.model, device="cpu")
    load_flax_params(model, params)
    got_fn = tracks.make_flow_fn(model, frames)
    want_fn = jtracks.make_flow_fn(params, jcfg, frames)
    for i, j in ((0, 1), (1, 0), (2, 3)):
        got = got_fn(i, j)
        assert got.shape == (48, 64, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want_fn(i, j)), rtol=0, atol=1e-4)
        assert got_fn(i, j) is got  # cached per pair
