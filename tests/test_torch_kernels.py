"""davo_tpu_torch kernels and primitives against the JAX reference (CPU).

On the CPU the port's cost-volume wrapper runs its plain version; the
CUDA kernel itself is held against that plain version on the card by
chip_smoke.py. Inputs come from numpy with a fixed seed and go to both
packages.
"""

import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.core import geometry as jgeo
from davo_tpu.core.warp import flow_warp_separable as j_flow_warp_separable
from davo_tpu.kernels.costvol import cost_volume_pallas, cost_volume_pallas_rows
from davo_tpu.kernels.resize import upsample2x_bilinear as j_upsample
from davo_tpu.models.flownet import cost_volume as j_cost_volume
from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.core.warp import flow_warp_separable
from davo_tpu_torch.kernels import costvol, cuda_build
from davo_tpu_torch.kernels.resize import resize_bilinear_aligned, upsample2x_bilinear


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _maps(seed, shape):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
    )


# Odd W throughout; s=4 on H=7 also puts whole shift rows out of frame.
@pytest.mark.parametrize("search", [2, 3, 4])
@pytest.mark.parametrize("channels", [8, 32])
def test_cost_volume_matches_reference(search, channels):
    a, b = _maps(search * 100 + channels, (2, 7, 13, channels))
    got = costvol.cost_volume_plain(torch.from_numpy(a), torch.from_numpy(b), search).numpy()
    d = (2 * search + 1) ** 2
    assert got.shape == (2, 7, 13, d)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for want in (
        cost_volume_pallas(ja, jb, search),
        cost_volume_pallas_rows(ja, jb, search),
        j_cost_volume(ja, jb, search),
    ):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("search", [2, 3, 4])
@pytest.mark.parametrize("channels", [8, 32])
def test_cost_volume_backward_matches_reference(search, channels):
    """The plain backward against jax.vjp of the XLA cost volume that the
    JAX train step differentiates (1e-5: the same sums in another
    order), and the CPU autograd Function against the plain pair."""
    a, b = _maps(search * 10 + channels, (2, 7, 13, channels))
    d = (2 * search + 1) ** 2
    g = np.random.default_rng(search).normal(size=(2, 7, 13, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y: j_cost_volume(x, y, search), jnp.asarray(a), jnp.asarray(b))
    want1, want2 = vjp(jnp.asarray(g))
    ta, tb, tg = (torch.from_numpy(x) for x in (a, b, g))
    got1, got2 = costvol.cost_volume_plain_bwd(ta, tb, tg, search)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), rtol=0, atol=1e-5)
    x, y = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    before = (costvol.launches, costvol.backward_launches)
    dx, dy = torch.autograd.grad(costvol.cost_volume(x, y, search), (x, y), tg)
    assert torch.equal(dx, got1) and torch.equal(dy, got2)
    assert (costvol.launches, costvol.backward_launches) == before
    # Only the map that needs a gradient is computed.
    only2 = costvol.cost_volume_plain_bwd(ta, tb, tg, search, need_f1=False)
    assert only2[0] is None and torch.equal(only2[1], got2)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_cost_volume_backward_at_the_train_search_on_an_odd_frame(need):
    """s=4 (D=81) with C=20 on a 5x9 frame: smaller than the CUDA
    kernel's 8x16 tile, channels short of its 32-channel slice, every
    shift row partly out of frame. The plain backward against jax.vjp of
    the XLA cost volume (1e-5), each gradient alone or both."""
    search, d = 4, 81
    a, b = _maps(45, (2, 5, 9, 20))
    g = np.random.default_rng(46).normal(size=(2, 5, 9, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, y: j_cost_volume(x, y, search), jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    got = costvol.cost_volume_plain_bwd(*(torch.from_numpy(x) for x in (a, b, g)), search, *need)
    for asked, x, y in zip(need, got, want):
        if asked:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-5)
        else:
            assert x is None


@pytest.mark.parametrize("search", [3, 4])
@pytest.mark.parametrize("channels", [8, 20])
def test_cost_volume_plain_on_bf16_maps_matches_pallas(search, channels):
    """bf16 maps, as the presets give them: the plain version widens them
    to float32, as the TPU kernel does inside; against cost_volume_pallas
    (interpret mode) on the same bf16 maps (1e-5: the same products,
    summed in another order)."""
    a, b = _maps(search * 1000 + channels, (2, 5, 9, channels))
    got = costvol.cost_volume_plain(
        torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), search
    )
    assert got.dtype == torch.float32
    want = cost_volume_pallas(
        jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16), search
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_cost_volume_autograd_on_bf16_maps_matches_the_float32_route(need):
    """Autograd through cost_volume with bf16 leaves gives bf16 gradients,
    bitwise those of the route that cast the maps first,
    cost_volume(x.float(), y.float(), s)."""
    a, b = _maps(7, (2, 5, 9, 8))
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 5, 9, 49)).astype(np.float32))
    x, y = (torch.from_numpy(m).bfloat16().requires_grad_(n) for m, n in zip((a, b), need))
    leaves = [t for t in (x, y) if t.requires_grad]
    got = torch.autograd.grad(costvol.cost_volume(x, y, 3), leaves, g)
    want = torch.autograd.grad(costvol.cost_volume(x.float(), y.float(), 3), leaves, g)
    for leaf, gg, ww in zip(leaves, got, want):
        assert gg.dtype == leaf.dtype == torch.bfloat16
        assert torch.equal(gg, ww)


@pytest.mark.parametrize(
    "dtypes, match",
    [
        ((torch.bfloat16, torch.float32), "share a dtype"),
        ((torch.float32, torch.bfloat16), "share a dtype"),
        ((torch.float16, torch.float16), "float32 or bfloat16"),
        ((torch.float64, torch.float64), "float32 or bfloat16"),
    ],
)
def test_cost_volume_check_refuses_other_dtypes(dtypes, match):
    f1, f2 = (torch.zeros(1, 3, 4, 8, dtype=dt) for dt in dtypes)
    with pytest.raises(TypeError, match=match):
        costvol._check(f1, f2, 3)


def test_cost_volume_check_takes_float32_and_bf16():
    for dt in (torch.float32, torch.bfloat16):
        costvol._check(torch.zeros(1, 3, 4, 8, dtype=dt), torch.zeros(1, 3, 4, 8, dtype=dt), 3)


def test_cost_volume_wrapper_on_cpu_is_plain_and_uncounted():
    a, b = (torch.from_numpy(x) for x in _maps(1, (2, 5, 9, 8)))
    before = costvol.launches
    got = costvol.cost_volume(a, b, 3)
    assert costvol.launches == before
    assert torch.equal(got, costvol.cost_volume_plain(a, b, 3))



def test_kernel_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit: loading a kernel raises; nothing is built or loaded."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda _path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("costvol")
    assert not list(tmp_path.iterdir()) and not cuda_build._LOADED


def test_kernel_build_failure_raises_and_leaves_no_library(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="costvol.cu .nvcc exit 1"):
        cuda_build.load("costvol")
    assert not list(tmp_path.iterdir()) and not cuda_build._LOADED


def test_kernel_build_is_named_by_its_source_and_the_headers(tmp_path, monkeypatch):
    """A library is reused while its source and the headers beside it
    (`csrc/*.cuh`) are unchanged; an edited header gives a new build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// one\n")
    nvcc = tmp_path / "nvcc"  # writes the file named after -o
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != -o ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    first = cuda_build._build("k")
    assert first.exists() and cuda_build._build("k") == first
    (csrc / "common.cuh").write_text("// two\n")
    second = cuda_build._build("k")
    assert second != first and second.exists()


class _StubLibrary:
    """Takes `argtypes` and `restype` for any function name, as a CDLL does."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, types.SimpleNamespace())


def _c_prototypes(source: str) -> dict[str, list[str]]:
    """The parameter types of each function of the `extern "C"` block."""
    block = source[source.index('extern "C"'):]
    found = re.findall(r"^(?:int|const char\*)\s+(davo_\w+)\(([^)]*)\)\s*\{", block, re.M)
    return {name: [" ".join(p.split()[:-1]) for p in params.split(",")] for name, params in found}


def test_ctypes_argtypes_match_the_c_prototypes(monkeypatch):
    """Each wrapper module's `_library()` declares, for every function of
    its source's C interface, one ctypes type per C parameter, c_void_p
    for each pointer: a mismatch would silently cut a pointer to 32 bits."""
    from davo_tpu_torch.kernels import bandwarp, conv_stack, rowconv, rowconv_ad

    modules = (costvol, bandwarp, rowconv, rowconv_ad, conv_stack)
    stubs = {}
    monkeypatch.setattr(cuda_build, "load", lambda name: stubs.setdefault(name, _StubLibrary()))
    for module in modules:
        module._library.cache_clear()
    try:
        for module in modules:
            module._library()
    finally:
        for module in modules:
            module._library.cache_clear()
    assert sorted(stubs) == sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    for name, lib in stubs.items():
        prototypes = _c_prototypes((cuda_build.CSRC_DIR / f"{name}.cu").read_text())
        assert prototypes and sorted(prototypes) == sorted(lib.functions), name
        for fn, params in prototypes.items():
            argtypes = lib.functions[fn].argtypes
            assert len(argtypes) == len(params), (name, fn)
            for param, argtype in zip(params, argtypes):
                assert "*" in param or param == "int", (fn, param)
                assert argtype is (ctypes.c_void_p if "*" in param else ctypes.c_int), (name, fn, param)


def test_cost_volume_rows_matches_pallas_rows():
    a, b = _maps(2, (2, 6, 11, 8))
    got = costvol.cost_volume_rows(
        torch.from_numpy(a.reshape(2, 66, 8)), torch.from_numpy(b.reshape(2, 66, 8)), 6, 11, 3
    ).numpy()
    want = np.asarray(cost_volume_pallas_rows(jnp.asarray(a), jnp.asarray(b), 3))
    np.testing.assert_allclose(got, want.reshape(2, 66, 49), rtol=0, atol=1e-5)


def test_cost_volume_plain_is_differentiable_on_cpu():
    a, b = (torch.from_numpy(x).requires_grad_() for x in _maps(3, (1, 4, 5, 8)))
    costvol.cost_volume(a, b, 2).sum().backward()
    assert a.grad is not None and b.grad is not None
    assert torch.isfinite(a.grad).all() and a.grad.abs().sum() > 0


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_matches_reference(factor):
    x = np.random.default_rng(factor).uniform(size=(2, 6, 10, 3)).astype(np.float32)
    got = upsample2x_bilinear(torch.from_numpy(x), factor).numpy()
    want = np.asarray(j_upsample(jnp.asarray(x), factor))
    assert got.shape == (2, 6 * factor, 10 * factor, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_resize_refuses_non_integer_factor():
    """A non-integer factor was refused before the fallback was ported;
    now it takes `resize_bilinear`, `jax.image.resize`'s computation."""
    x = np.random.default_rng(5).uniform(size=(1, 4, 4, 2)).astype(np.float32)
    got = resize_bilinear_aligned(torch.from_numpy(x), 6, 6).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 6, 6, 2), "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flow_warp_separable_matches_reference():
    rng = np.random.default_rng(4)
    src = rng.uniform(size=(2, 12, 16, 5)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    # A smooth field that also pushes some pixels out of frame.
    flow = np.stack([3.0 * np.sin(gy / 4.0), 2.0 * np.cos(gx / 5.0)], -1)
    flow = np.broadcast_to(flow, (2, 12, 16, 2)).astype(np.float32)
    got, got_valid = flow_warp_separable(torch.from_numpy(src), torch.from_numpy(flow))
    want, want_valid = j_flow_warp_separable(jnp.asarray(src), jnp.asarray(flow))
    assert 0 < float(got_valid.mean()) < 1
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_pose_vec_to_mat_matches_reference():
    vec = np.random.default_rng(5).normal(scale=0.3, size=(16, 6)).astype(np.float32)
    got = geo.pose_vec_to_mat(torch.from_numpy(vec)).numpy()
    want = np.asarray(jgeo.pose_vec_to_mat(jnp.asarray(vec)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_trajectory_from_relatives_matches_reference():
    rng = np.random.default_rng(6)
    vec = np.concatenate(
        [rng.normal(scale=0.5, size=(64, 3)), rng.normal(scale=0.02, size=(64, 3))], -1
    ).astype(np.float32)
    rel = geo.pose_vec_to_mat(torch.from_numpy(vec))
    got = geo.trajectory_from_relatives(rel).numpy()
    want = np.asarray(jgeo.trajectory_from_relatives(jnp.asarray(rel.numpy())))
    assert got.shape == (65, 4, 4)
    # Both chain by a log-depth scan; the groupings differ, so the
    # products agree to f32 rounding over 64 steps, not bit for bit.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # And against the plain sequential chain.
    seq = [np.eye(4, dtype=np.float64)]
    for m in rel.numpy().astype(np.float64):
        seq.append(seq[-1] @ m)
    np.testing.assert_allclose(got, np.stack(seq), rtol=0, atol=1e-4)
