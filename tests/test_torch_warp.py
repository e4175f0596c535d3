"""The port's geometry, pyramid, SSIM and warps against the JAX package
(CPU, float32): values and input gradients within 1e-5 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.core import geometry as jgeo
from davo_tpu.core import pyramid as jpyramid
from davo_tpu.core.ssim import ssim as j_ssim
from davo_tpu.core import warp as jwarp
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.core import pyramid, warp
from davo_tpu_torch.core.ssim import ssim


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grads(fn_torch, fn_jax, inputs, cotangent):
    """(torch output, torch input grads, jax output, jax input grads)."""
    ts = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fn_torch(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(cotangent))
    want_out, vjp = jax.vjp(fn_jax, *[jnp.asarray(x) for x in inputs])
    want = vjp(jnp.asarray(cotangent))
    return out.detach().numpy(), [g.numpy() for g in got], np.asarray(want_out), [np.asarray(w) for w in want]


def _assert_close(got, want, atol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _camera(rng, B, H, W):
    K = np.tile(
        np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]], np.float32), (B, 1, 1)
    )
    depth = rng.uniform(2.0, 20.0, (B, H, W)).astype(np.float32)
    pose = np.concatenate(
        [rng.normal(scale=0.3, size=(B, 3)), rng.normal(scale=0.02, size=(B, 3))], -1
    ).astype(np.float32)
    return K, depth, pose


def test_projection_matches_reference():
    rng = np.random.default_rng(0)
    B, H, W = 2, 6, 9
    K, depth, pose = _camera(rng, B, H, W)
    depth[0, 0, 0] = 0.0  # z == 0 exactly: the z_safe branch
    Kt = torch.from_numpy(K)

    def fwd_t(d, p):
        uv, z = geo.cam_to_pixel(geo.pixel_to_cam(d, Kt), Kt, geo.pose_vec_to_mat(p))
        return torch.cat([uv, z[:, None]], 1)

    def fwd_j(d, p):
        uv, z = jgeo.cam_to_pixel(jgeo.pixel_to_cam(d, jnp.asarray(K)), jnp.asarray(K), jgeo.pose_vec_to_mat(p))
        return jnp.concatenate([uv, z[:, None]], 1)

    g = rng.normal(size=(B, 3, H, W)).astype(np.float32) * 1e-2
    out, got, want_out, want = _grads(fwd_t, fwd_j, [depth, pose], g)
    _assert_close(out, want_out, atol=1e-3)  # pixels of magnitude ~1e2: f32 relative 1e-5
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1], atol=1e-4)  # sums over H*W pixels of ~1e2
    for a, b in zip(geo.intrinsics_pyramid(Kt, 3), jgeo.intrinsics_pyramid(jnp.asarray(K), 3)):
        _assert_close(a.numpy(), np.asarray(b), atol=0)


def test_mat_to_pose_vec_round_trip_matches_reference():
    vec = np.random.default_rng(1).normal(scale=0.3, size=(8, 6)).astype(np.float32)
    mats = jgeo.pose_vec_to_mat(jnp.asarray(vec))
    got = geo.mat_to_pose_vec(torch.from_numpy(np.array(mats))).numpy()
    _assert_close(got, np.asarray(jgeo.mat_to_pose_vec(mats)), atol=1e-6)
    _assert_close(got, vec, atol=1e-5)


def test_clip_passes_half_the_gradient_at_a_tie_as_jax():
    x = np.array([-1.0, 0.0, 0.5, 1.0, 2.0], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(geo.clip(t, 0.0, 1.0).sum(), (t,))
    want = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]


@pytest.mark.parametrize("shape", [(2, 12, 16, 3), (1, 13, 27, 2)])
def test_image_pyramid_matches_reference(shape):
    x = np.random.default_rng(2).uniform(size=shape).astype(np.float32)
    got = pyramid.image_pyramid(torch.from_numpy(x), 3)
    want = jpyramid.image_pyramid(jnp.asarray(x), 3)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        _assert_close(g.numpy(), np.asarray(w), atol=1e-6)
    gy = np.random.default_rng(3).normal(size=want[2].shape).astype(np.float32)
    _, dg, _, dw = _grads(
        lambda t: pyramid.image_pyramid(t, 3)[2], lambda a: jpyramid.image_pyramid(a, 3)[2], [x], gy
    )
    _assert_close(dg[0], dw[0], atol=1e-6)


def test_ssim_matches_reference_with_the_clip_tie():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(2, 10, 14, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 10, 14, 3)).astype(np.float32)
    # Identical textured 3x3 patches: (1 - SSIM)/2 == 0 exactly, a tie at
    # the clip's bound. (On flat identical patches the inner gradient is
    # 0 up to rounding noise that 1/C2 amplifies past any tolerance.)
    y[0, :6, :7] = x[0, :6, :7]
    y[1, 3:, 5:] = x[1, 3:, 5:]
    g = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    out, got, want_out, want = _grads(ssim, j_ssim, [x, y], g)
    assert (want_out == 0).sum() > 20  # the tie is reached
    _assert_close(out, want_out)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


def _coords(rng, B, H, W, spread):
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c = np.stack(
        [gx + rng.uniform(-spread, spread, (B, H, W)), gy + rng.uniform(-spread, spread, (B, H, W))], -1
    ).astype(np.float32)
    c[0, 1, :, 0] = np.round(c[0, 1, :, 0])  # exact integers
    c[0, :, 2, 1] = H - 1.0
    c[1, :, 3, 0] = W - 1.0
    return c


@pytest.mark.parametrize("fill", ["border", "zeros"])
def test_take4_matches_reference(fill):
    rng = np.random.default_rng(5)
    B, H, W, C = 2, 8, 11, 3
    img = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    coords = _coords(rng, B, H, W, 3.0)
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    out, got, want_out, want = _grads(
        lambda i, c: warp.bilinear_sample(i, c, fill=fill, method="take4")[0],
        lambda i, c: jwarp.bilinear_sample(i, c, fill=fill, method="take4")[0],
        [img, coords], g,
    )
    _assert_close(out, want_out, atol=1e-6)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])
    # "block" is documented as take4 and runs take4 here.
    block, _ = warp.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords), fill=fill, method="block")
    _assert_close(block.numpy(), want_out, atol=1e-6)


@pytest.mark.parametrize("fill", ["border", "zeros"])
def test_projective_inverse_warp_matches_reference(fill):
    rng = np.random.default_rng(6)
    B, H, W = 2, 10, 14
    K, depth, pose = _camera(rng, B, H, W)
    src = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    g = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    Kt = torch.from_numpy(K)
    out, got, want_out, want = _grads(
        lambda s, d, p: torch.cat(warp.projective_inverse_warp(s, d, p, Kt, fill=fill), -1)[..., :3],
        lambda s, d, p: jwarp.projective_inverse_warp(s, d, p, jnp.asarray(K), fill=fill)[0],
        [src, depth, pose], g,
    )
    _assert_close(out, want_out)
    for a, b in zip(got, want):
        _assert_close(a, b, atol=1e-4 * max(1.0, np.abs(b).max()))
    _, valid = warp.projective_inverse_warp(*(torch.from_numpy(x) for x in (src, depth, pose, K)), fill=fill)
    _, jvalid = jwarp.projective_inverse_warp(*(jnp.asarray(x) for x in (src, depth, pose, K)), fill=fill)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_flow_warp_matches_reference():
    rng = np.random.default_rng(7)
    src = rng.uniform(size=(2, 9, 12, 3)).astype(np.float32)
    flow = rng.normal(scale=2.0, size=(2, 9, 12, 2)).astype(np.float32)
    g = rng.normal(size=(2, 9, 12, 3)).astype(np.float32)
    out, got, want_out, want = _grads(
        lambda s, f: warp.flow_warp(s, f, fill="border")[0],
        lambda s, f: jwarp.flow_warp(s, f, fill="border")[0],
        [src, flow], g,
    )
    _assert_close(out, want_out, atol=1e-6)
    _assert_close(got[0], want[0])
    _assert_close(got[1], want[1])


def test_configure_sets_the_default_gather():
    saved = (warp._DEFAULT_GATHER, warp._BAND)
    try:
        warp.configure("banded", (2, 4))
        assert (warp._DEFAULT_GATHER, warp._BAND) == ("banded", (2, 4))
        warp.configure(None, None)
        assert (warp._DEFAULT_GATHER, warp._BAND) == ("banded", (2, 4))
        with pytest.raises(ValueError, match="gather"):
            warp.configure("nearest")
    finally:
        warp.configure(*saved)
