"""The port's banded warp against the JAX Pallas kernel (CPU, interpret mode).

On the CPU `banded_warp` runs the plain versions, written to the TPU
kernel's own formulas; the CUDA kernels are held against those plain
versions on the card by chip_smoke.py. Tolerance 1e-5 absolute: both
sides sum the same terms in the same order in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.core.warp import bilinear_sample as j_bilinear_sample
from davo_tpu.kernels.bandwarp import banded_warp as j_banded_warp
from davo_tpu_torch.core import warp
from davo_tpu_torch.kernels import bandwarp

RV, RH = 2, 4
B, H, W = 2, 12, 20


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _coords(seed: int, h: int = H, w: int = W, rv: int = RV, rh: int = RH) -> np.ndarray:
    """Coordinates that reach every case of the kernel: displacements
    beyond the band on each axis, points out of frame on every side,
    exact integers, and points exactly on the first and last row and
    column (rows and columns past a small frame's last one are clipped)."""
    rng = np.random.default_rng(seed)
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    du = rng.uniform(-1.6 * rh, 1.6 * rh, (B, h, w))
    dv = rng.uniform(-1.6 * rv, 1.6 * rv, (B, h, w))
    row, col = (lambda i: min(i, h - 1)), (lambda i: min(i, w - 1))
    du[0, row(2)] = np.round(du[0, row(2)])  # exact integers, inside and beyond the band
    dv[1, row(5)] = np.round(dv[1, row(5)])
    u, v = gx + du, gy + dv
    u[0, :, col(3)], v[0, row(4), :] = w - 1.0, h - 1.0  # exactly on the last column / row
    u[1, :, col(6)], v[1, row(7), :] = 0.0, 0.0  # exactly on the first column / row
    u[1, 0, :4], v[1, 1, :4] = -2.5, h + 0.5  # out of frame, within the band
    c = np.stack([u, v], -1).astype(np.float32)
    assert (np.abs(c[..., 0] - gx) > rh).any() and (np.abs(c[..., 1] - gy) > rv).any()
    return c


def _inputs(seed, C, h=H, w=W, rv=RV, rh=RH):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, h, w, C)).astype(np.float32)
    g = rng.normal(size=(B, h, w, C)).astype(np.float32)
    return img, _coords(seed + 1, h, w, rv, rh), g


def _match_pallas_kernel(C, fill, h=H, w=W, rv=RV, rh=RH, live=0.25):
    img, coords, g = _inputs(C, C, h, w, rv, rh)
    j_out, vjp, j_valid = jax.vjp(
        lambda i, c: j_banded_warp(i, c, rv=rv, rh=rh, fill=fill),
        jnp.asarray(img), jnp.asarray(coords), has_aux=True,
    )
    j_dimg, j_dcoords = vjp(jnp.asarray(g))

    t_img = torch.from_numpy(img).requires_grad_()
    t_coords = torch.from_numpy(coords).requires_grad_()
    out, valid = bandwarp.banded_warp(t_img, t_coords, rv=rv, rh=rh, fill=fill)
    dimg, dcoords = torch.autograd.grad(out, (t_img, t_coords), torch.from_numpy(g))

    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert 0 < float(valid.mean()) < 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dimg.numpy(), np.asarray(j_dimg), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dcoords.numpy(), np.asarray(j_dcoords), rtol=0, atol=1e-5)
    # The masks do cut: some coordinate gradients are exactly zero where
    # the band or the high frame edge clamps, and at least `live` of them
    # are not.
    assert (dcoords.numpy() == 0).any() and (dcoords.numpy() != 0).mean() > live


@pytest.mark.parametrize("fill", ["border", "zeros"])
@pytest.mark.parametrize("C", [1, 3])
def test_banded_forward_and_backward_match_pallas_kernel(C, fill):
    _match_pallas_kernel(C, fill)


# The train band (4, 16) on a frame narrower than its (2rh+2) x (2rv+2)
# window (5x7) and on one wider in x (9x41): C=1 with d/dimg, as the
# geometry term warps, and C=3. On the narrow frame most samples clamp to
# the frame, so fewer coordinate gradients are live. The interpret-mode
# kernel unrolls 340 shifts, so each case traces for about a minute.
@pytest.mark.parametrize("C, fill, frame, live", [(1, "zeros", (5, 7), 0.05), (3, "border", (9, 41), 0.25)])
def test_train_band_matches_pallas_kernel_on_narrow_and_wide_frames(C, fill, frame, live):
    try:
        _match_pallas_kernel(C, fill, *frame, rv=4, rh=16, live=live)
    finally:
        jax.clear_caches()  # the traced 340-shift kernels are large


def test_plain_pair_is_the_autograd_function_on_cpu():
    img, coords, g = _inputs(7, 3)
    t_img, t_coords, t_g = (torch.from_numpy(x) for x in (img, coords, g))
    before = (bandwarp.launches, bandwarp.backward_launches)
    fwd = bandwarp.banded_warp_plain_fwd(t_img, t_coords, RV, RH)
    dimg, dcoords = bandwarp.banded_warp_plain_bwd(t_img, t_coords, t_g, RV, RH)
    a, c = t_img.clone().requires_grad_(), t_coords.clone().requires_grad_()
    out = bandwarp.banded_warp(a, c, rv=RV, rh=RH)[0]
    got = torch.autograd.grad(out, (a, c), t_g)
    assert torch.equal(out.detach(), fwd)
    assert torch.equal(got[0], dimg) and torch.equal(got[1], dcoords)
    assert (bandwarp.launches, bandwarp.backward_launches) == before


def test_image_gradient_only_when_asked():
    img, coords, g = _inputs(8, 1)
    t_coords = torch.from_numpy(coords).requires_grad_()
    out = bandwarp.banded_warp(torch.from_numpy(img), t_coords, rv=RV, rh=RH)[0]
    (dcoords,) = torch.autograd.grad(out, (t_coords,), torch.from_numpy(g))
    want = bandwarp.banded_warp_plain_bwd(
        torch.from_numpy(img), torch.from_numpy(coords), torch.from_numpy(g), RV, RH,
        need_img=False,
    )
    assert want[0] is None and torch.equal(dcoords, want[1])


@pytest.mark.parametrize("fill", ["border", "zeros"])
def test_banded_equals_take4_inside_the_band(fill):
    """Within the band the banded warp is the exact bilinear sample: the
    port's take4 and the reference's take4 agree with it."""
    rng = np.random.default_rng(9)
    img = rng.uniform(size=(B, H, W, 3)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    du = rng.uniform(-RH, RH, (B, H, W))
    dv = rng.uniform(-RV, RV, (B, H, W))
    coords = np.stack([gx + du, gy + dv], -1).astype(np.float32)
    t_img, t_coords = torch.from_numpy(img), torch.from_numpy(coords)
    band, bvalid = bandwarp.banded_warp(t_img, t_coords, rv=RV, rh=RH, fill=fill)
    take4, tvalid = warp.bilinear_sample(t_img, t_coords, fill=fill, method="take4")
    ref, _ = j_bilinear_sample(jnp.asarray(img), jnp.asarray(coords), fill=fill, method="take4")
    assert torch.equal(bvalid, tvalid)
    np.testing.assert_allclose(band.numpy(), take4.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(take4.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
