"""The non-integer bilinear resize and the dense-weight sampler of
davo_tpu_torch against the JAX package (CPU, float32).

`resize_bilinear` is `jax.image.resize(..., "bilinear")`'s computation
(one weight matrix per axis, antialiased when it shrinks); it is held to
`jax.image.resize` at 1e-6 on inputs in [0, 1), and through its callers:
`resize_bilinear_aligned`'s fallback, `core.pyramid.resize_bilinear`,
`region_weight_map`'s non-divisible branch and a whole `tiny` forward
whose flow pyramid is not a chain of halvings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.core.pyramid import resize_bilinear as j_pyramid_resize
from davo_tpu.core.warp import bilinear_sample as j_bilinear_sample
from davo_tpu.kernels.resize import resize_bilinear_aligned as j_aligned
from davo_tpu.kernels.sample import bilinear_sample_matmul as j_sample_matmul
from davo_tpu.models import presets as jpresets
from davo_tpu.models.attention import region_weight_map as j_region_weight_map
from davo_tpu.models.attention import seg_to_onehot as j_seg_to_onehot
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.core.pyramid import resize_bilinear as pyramid_resize
from davo_tpu_torch.core.warp import bilinear_sample
from davo_tpu_torch.kernels import resize
from davo_tpu_torch.kernels.resize import resize_bilinear, resize_bilinear_aligned
from davo_tpu_torch.kernels.sample import bilinear_sample_matmul
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.attention import region_weight_map
from davo_tpu_torch.models.davo import DavoModel

TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _uniform(seed, *shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _jax_resize(x, h, w):
    return np.asarray(jax.image.resize(jnp.asarray(x), (x.shape[0], h, w, x.shape[3]), "bilinear"))


# (H, W) -> (h, w): up and down, integer and non-integer, each axis
# alone; 8x25 -> 15x50 is `davo`'s /16 -> /8 flow at 120x400, 25x83 ->
# 100x330 its full-resolution flow at 100x330.
RESIZE_CASES = [
    (8, 25, 15, 50),
    (25, 83, 100, 330),
    (15, 50, 8, 25),
    (100, 330, 25, 83),
    (30, 30, 4, 4),
    (6, 8, 48, 64),
    (48, 64, 17, 23),
    (7, 9, 3, 20),
    (16, 16, 16, 5),
    (5, 6, 13, 6),
    (30, 100, 120, 400),
    (10, 10, 10, 10),
]


@pytest.mark.parametrize("h_in, w_in, h_out, w_out", RESIZE_CASES)
def test_resize_matches_jax_image_resize(h_in, w_in, h_out, w_out):
    x = _uniform(h_in * 1000 + w_out, 2, h_in, w_in, 3)
    got = resize_bilinear(torch.from_numpy(x), h_out, w_out).numpy()
    want = _jax_resize(x, h_out, w_out)
    assert got.shape == want.shape == (2, h_out, w_out, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _one_rounding_resize(x, h_out, w_out):
    """JAX's weight formula in float32 with each sample position rounded
    once from its exact value ((o + 0.5) * float32(1 / scale) - 0.5, a
    fused multiply-add), the rest in float64."""

    def weights(n_in, n_out):
        inv32 = np.float64(np.float32(1.0 / (n_out / n_in)))
        sample = ((np.arange(n_out) + 0.5) * inv32 - 0.5).astype(np.float32).astype(np.float64)
        w = np.maximum(0.0, 1.0 - np.abs(sample[None] - np.arange(n_in)[:, None]) / max(inv32, 1.0))
        w = w / w.sum(0, keepdims=True)
        return np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None], w, 0.0)

    _, H, W, _ = x.shape
    return np.einsum("bhwc,hy,wx->byxc", x.astype(np.float64), weights(H, h_out), weights(W, w_out))


def test_short_axis_differs_by_at_most_an_ulp_of_a_position():
    """The port rounds each sample position once, as the fused
    multiply-add that XLA compiles it to on axes of 96 outputs and more
    (the cases above). On shorter axes XLA's CPU code rounds the product
    first, so a position far from the origin can land an ulp away: on an
    upsample from 37 rows to 90, `jax.image.resize` and the port differ
    by up to 1.9e-6 of a unit signal, within one float32 ulp of the
    largest position (3.8e-6); the port follows its own formula to 1e-6."""
    x = _uniform(37, 2, 37, 11, 3)
    got = resize_bilinear(torch.from_numpy(x), 90, 11).numpy()
    np.testing.assert_allclose(got, _one_rounding_resize(x, 90, 11), rtol=0, atol=TOL)
    gap = np.abs(got - _jax_resize(x, 90, 11)).max()
    assert TOL < gap <= np.spacing(np.float32(37.0))


def test_weight_matrix_is_cached_per_axis():
    resize._weight_mat.cache_clear()
    x = torch.from_numpy(_uniform(1, 1, 8, 25, 2))
    resize_bilinear(x, 15, 50)
    resize_bilinear(x, 15, 50)
    info = resize._weight_mat.cache_info()
    assert (info.hits, info.misses) == (2, 2)


@pytest.mark.parametrize("h_in, w_in, h_out, w_out", [(8, 25, 15, 50), (6, 8, 11, 15), (4, 4, 8, 8)])
def test_aligned_resize_takes_the_fallback_as_reference(h_in, w_in, h_out, w_out):
    x = _uniform(h_out, 2, h_in, w_in, 2)
    got = resize_bilinear_aligned(torch.from_numpy(x), h_out, w_out).numpy()
    want = np.asarray(j_aligned(jnp.asarray(x), h_out, w_out))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_pyramid_resize_matches_reference():
    x = _uniform(3, 2, 48, 64, 3)
    for h, w in ((24, 32), (17, 23), (96, 100)):
        got = pyramid_resize(torch.from_numpy(x), h, w).numpy()
        want = np.asarray(j_pyramid_resize(jnp.asarray(x), h, w))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_region_weight_map_non_divisible_matches_reference():
    """30x30 -> 4x4 divides nothing (tests/test_dist_tp.py's case): the
    full-resolution map, then the antialiased resize."""
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 19, (2, 30, 30)).astype(np.int32)
    seg[0, :2, :3] = -1  # labels outside [0, K): an all-zero one-hot row
    seg[1, -1, -5:] = 19
    weights = rng.uniform(0.5, 1.5, (2, 19)).astype(np.float32)
    got = region_weight_map(torch.from_numpy(weights), torch.from_numpy(seg), 19, (4, 4)).numpy()
    want = np.asarray(j_region_weight_map(jnp.asarray(weights), j_seg_to_onehot(jnp.asarray(seg), 19), (4, 4)))
    assert got.shape == want.shape == (2, 4, 4, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_tiny_forward_with_non_integer_flow_upsampling_matches_reference():
    """`tiny` at 44x60: the flow pyramid's /8 level is 6x8 and its /4
    level 11x15, so the flow net's upsample takes the non-integer
    resize; poses within 1e-4, as the whole-model tests hold them."""
    jcfg = jpresets.with_overrides("tiny", img_height=44, img_width=60).model
    cfg = presets.with_overrides("tiny", img_height=44, img_width=60).model
    target, sources = _uniform(10, 2, 44, 60, 3), _uniform(11, 2, 1, 44, 60, 3)
    seg = np.random.default_rng(12).integers(0, 19, (2, 44, 60)).astype(np.int32)
    jmodel = JDavoModel(jcfg)
    params = jax.jit(lambda t, s, g: jmodel.init(jax.random.key(0), t, s, seg=g, train=False))(
        target, sources, seg
    )
    want = jax.jit(lambda p, t, s, g: jmodel.apply(p, t, s, seg=g, train=False))(params, target, sources, seg)
    model = DavoModel(cfg, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(target), torch.from_numpy(sources), seg=torch.from_numpy(seg))
    assert [tuple(f.shape) for f in got["flows"][0]] == [(2, 11, 15, 2), (2, 6, 8, 2)]
    np.testing.assert_allclose(got["poses"].numpy(), np.asarray(want["poses"]), rtol=0, atol=1e-4)
    for g, w in zip(got["flows"][0], want["flows"][0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def _coords(seed, B, Ho, Wo, H, W):
    """Sample positions inside and around a (H, W) image."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1.5, W + 0.5, (B, Ho, Wo))
    v = rng.uniform(-1.5, H + 0.5, (B, Ho, Wo))
    return np.stack([u, v], -1).astype(np.float32)


def test_bilinear_sample_matmul_matches_reference_and_bilinear_sample():
    img = _uniform(20, 2, 12, 16, 5)
    coords = _coords(21, 2, 9, 7, 12, 16)
    got, got_valid = bilinear_sample_matmul(torch.from_numpy(img), torch.from_numpy(coords))
    want, want_valid = j_sample_matmul(jnp.asarray(img), jnp.asarray(coords))
    assert got.shape == (2, 9, 7, 5) and got_valid.shape == (2, 9, 7, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    # The gather-based sampler gives the same function (zero and invalid
    # out of bounds).
    gathered, gathered_valid = bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), gathered.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_valid.numpy(), gathered_valid.numpy())
    jgathered, _ = j_bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgathered), rtol=0, atol=TOL)


def test_bilinear_sample_matmul_is_differentiable_in_the_image():
    img = torch.from_numpy(_uniform(22, 1, 6, 8, 2)).requires_grad_()
    coords = torch.from_numpy(_coords(23, 1, 4, 4, 6, 8))
    out, _ = bilinear_sample_matmul(img, coords)
    out.sum().backward()
    want = jax.grad(lambda i: j_sample_matmul(i, jnp.asarray(coords.numpy()))[0].sum())(
        jnp.asarray(img.detach().numpy())
    )
    np.testing.assert_allclose(img.grad.numpy(), np.asarray(want), rtol=0, atol=TOL)
