"""The fused serving kernels' plain versions against the JAX package's
Pallas kernels (`davo_tpu/kernels/rowconv.py`, interpret mode on the CPU).

On CPU tensors the port's wrappers run these plain versions; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py. Inputs and weights come from numpy with a fixed seed
(weights as `tests/test_kernels.py::TestStridedRowChain._make`). The JAX
kernels take HWIO weights, the port OIHW.

Criteria: float32 within 1e-5 of the largest output. bfloat16 and
bf16_dot: for one layer at most 1e-3 of the elements differ, by at most
one bf16 ulp at the output's scale (bf16_dot keeps float32 activations,
so its layer is held at the float32 limit); for a chain, over 3 seeds, the
port's gap to the JAX output is at most half of JAX's own gap between
that mode and float32. The placement check shows the criterion tells
the kernels' rounding (f32 sum + f32 bias, one rounding) apart from
`ConvBlock`'s (rounded conv output + bf16 bias).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.kernels import rowconv as jrowconv
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.kernels import rowconv
from davo_tpu_torch.models.common import ConvBlock

EST_RELUS = (True, True, True, False)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _make(rng, ks, chans, cin, bias_scale=0.01):
    ws, bs = [], []
    for k, c in zip(ks, chans):
        ws.append((rng.normal(size=(k, k, cin, c)) / np.sqrt(k * k * cin)).astype(np.float32))
        bs.append((rng.normal(size=(c,)) * bias_scale).astype(np.float32))
        cin = c
    return ws, bs


def _jax(ws, bs):
    return tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))


def _port(ws, bs):
    return ([torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
            [torch.from_numpy(b) for b in bs])


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _assert_f32(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-5 * scale


def _assert_one_ulp(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.mean(got != want) <= 1e-3
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


# ------------------------------------------------------------------ float32


STRIDED_CASES = {
    # name: (input shape, kernel sizes, channels, strides, relus, taps)
    "single_7x7_s2": ((2, 16, 24, 6), (7,), (8,), (2,), (True,), None),
    "mixed_2_1_2": ((2, 16, 16, 4), (3, 3, 3), (8, 8, 12), (2, 1, 2), (True,) * 3, None),
    "pose_prefix": ((1, 32, 64, 9), (7, 5, 3, 3, 3), (16, 32, 64, 128, 256), (2,) * 5,
                    (True,) * 5, None),
    "attention": ((2, 16, 24, 2), (3, 3, 3), (16, 32, 64), (2,) * 3, (True, True, False), None),
    "pyramid_taps": ((2, 16, 24, 3), (3,) * 6, (16, 16, 32, 32, 64, 64), (2, 1) * 3,
                     (True,) * 6, (1, 3, 5)),
}


@pytest.mark.parametrize("case", sorted(STRIDED_CASES))
def test_conv_chain_strided_matches_reference_f32(case):
    shape, ks, chans, strides, relus, taps = STRIDED_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.uniform(size=shape).astype(np.float32)
    ws, bs = _make(rng, ks, chans, shape[-1])
    want = jrowconv.conv_chain_strided(
        jnp.asarray(x), *_jax(ws, bs), strides, relus, taps=taps, compute_dtype_name="float32"
    )
    got = rowconv.conv_chain_strided(
        torch.from_numpy(x), *_port(ws, bs), strides, relus, taps=taps,
        compute_dtype_name="float32",
    )
    if taps is None:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_f32(g, w)


def test_conv_chain_strided_refuses_odd_dims_as_reference():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(1, 10, 14, 3)).astype(np.float32)
    ws, bs = _make(rng, (3, 3), (8, 8), 3)
    for fn, args in (
        (jrowconv.conv_chain_strided, (jnp.asarray(x), *_jax(ws, bs))),
        (rowconv.conv_chain_strided, (torch.from_numpy(x), *_port(ws, bs))),
    ):
        with pytest.raises(ValueError, match="even dims"):
            fn(*args, (2, 2), (True, True), compute_dtype_name="float32")
    assert rowconv.fusable_even_prefix(10, 14, (2, 2)) == jrowconv.fusable_even_prefix(10, 14, (2, 2)) == 1
    for h, w in ((128, 416), (64, 128), (32, 104), (64, 208)):
        assert rowconv.fusable_even_prefix(h, w, (2,) * 7) == jrowconv.fusable_even_prefix(h, w, (2,) * 7)
    # davo-fast's seven pose layers: 5 fuse at 128x416 (416 / 16 = 26,
    # then 13), 6 at 64x128 (the seventh sees 1x2), 3 at 32x104.
    assert [rowconv.fusable_even_prefix(h, w, (2,) * 7) for h, w in ((128, 416), (64, 128), (32, 104))] == [5, 6, 3]


def test_conv_chain_nhwc_matches_reference_f32_at_odd_width():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 13, 40)).astype(np.float32)
    ws, bs = _make(rng, (3,) * 4, (96, 64, 32, 2), 40)
    want = jrowconv.conv_chain_nhwc(jnp.asarray(x), *_jax(ws, bs), EST_RELUS, "float32")
    got = rowconv.conv_chain_nhwc(torch.from_numpy(x), *_port(ws, bs), EST_RELUS, "float32")
    assert got.dtype == torch.float32
    _assert_f32(got, want)


def _level_inputs(rng, search, feat_channels, shape=(2, 6, 13)):
    f1 = rng.normal(size=(*shape, 8)).astype(np.float32)
    f2 = rng.normal(size=(*shape, 8)).astype(np.float32)
    feat = rng.normal(size=(*shape, feat_channels)).astype(np.float32)
    flow_up = rng.normal(scale=2.0, size=(*shape, 2)).astype(np.float32)
    ws, bs = _make(rng, (3,) * 4, (96, 64, 32, 2), (2 * search + 1) ** 2 + feat_channels + 2)
    return (f1, f2, feat, flow_up), ws, bs


def _flow_level(pkg, arrays, ws, bs, search, mode):
    if pkg is jrowconv:
        return jrowconv.flow_level_fused(
            *map(jnp.asarray, arrays), *_jax(ws, bs), search, EST_RELUS, compute_dtype_name=mode
        )
    return rowconv.flow_level_fused(
        *map(torch.from_numpy, arrays), *_port(ws, bs), search, EST_RELUS, compute_dtype_name=mode
    )


@pytest.mark.parametrize("search, feat_channels", [(2, 32), (3, 64)])
def test_flow_level_fused_matches_reference_f32(search, feat_channels):
    """Odd W (13), nonzero flow_up, C = 8 as after `cv_proj`."""
    arrays, ws, bs = _level_inputs(np.random.default_rng(search), search, feat_channels)
    want = _flow_level(jrowconv, arrays, ws, bs, search, "float32")
    got = _flow_level(rowconv, arrays, ws, bs, search, "float32")
    assert got.shape == (2, 6, 13, 2) and got.dtype == torch.float32
    _assert_f32(got, want)


# ----------------------------------------------------------- bf16 and bf16_dot


@pytest.mark.parametrize("mode", ["bfloat16", "bf16_dot"])
@pytest.mark.parametrize("k, stride", [(7, 2), (3, 1)])
def test_one_layer_rounds_as_the_kernel(mode, k, stride):
    """One fused layer in the bf16 modes: at most 1e-3 of the elements
    differ from the JAX kernel's, by at most one bf16 ulp (bf16_dot, whose
    output stays float32, within 1e-5 of the largest, which is stricter).
    Placement
    check: the same layer as a bf16 `ConvBlock` (output rounded, then the
    bf16 bias added) differs from the JAX kernel in more than 5 %."""
    rng = np.random.default_rng(k * 10 + stride)
    cin, cout = (9, 16) if k == 7 else (24, 32)
    x = rng.uniform(-1, 1, size=(2, 16, 26, cin)).astype(np.float32)
    ws, bs = _make(rng, (k,), (cout,), cin, bias_scale=0.5)
    want = jrowconv.conv_chain_strided(
        jnp.asarray(x), *_jax(ws, bs), (stride,), (True,), compute_dtype_name=mode
    )
    got = rowconv.conv_chain_strided(
        torch.from_numpy(x), *_port(ws, bs), (stride,), (True,), compute_dtype_name=mode
    )
    if mode == "bfloat16":
        assert got.dtype == torch.bfloat16
        _assert_one_ulp(got, want)
    else:  # float32 activations: only the order of the f32 sums differs
        assert got.dtype == torch.float32
        _assert_f32(got, want)
    block = ConvBlock(cin, cout, k, stride, torch.bfloat16)
    load_flax_params(block, {"Conv_0": {"kernel": ws[0], "bias": bs[0]}})
    with torch.no_grad():
        conv_block = block(torch.from_numpy(x))
    assert np.mean(_np(conv_block) != _np(want)) > 0.05


def _gap_ratio(run_port, run_jax, seeds, mode):
    """Sum over seeds of the port's max gap to JAX in `mode`, over the sum
    of JAX's own max gap between `mode` and float32."""
    gap = reference_gap = 0.0
    for seed in seeds:
        got = [_np(t) for t in run_port(seed, mode)]
        want = [_np(t) for t in run_jax(seed, mode)]
        want32 = [_np(t) for t in run_jax(seed, "float32")]
        gap += max(np.abs(g - w).max() for g, w in zip(got, want))
        reference_gap += max(np.abs(w - w32).max() for w, w32 in zip(want, want32))
    assert reference_gap > 0
    return gap / reference_gap


@pytest.mark.parametrize("mode", ["bfloat16", "bf16_dot"])
def test_pyramid_chain_follows_reference_rounding(mode):
    """The pyramid ladder with taps: over 3 seeds the port's gap to the
    JAX kernel is at most half of JAX's own gap to float32."""
    strides = (2, 1) * 3

    def inputs(seed):
        rng = np.random.default_rng(100 + seed)
        x = rng.uniform(size=(2, 16, 24, 3)).astype(np.float32)
        return x, *_make(rng, (3,) * 6, (16, 16, 32, 32, 64, 64), 3, bias_scale=0.1)

    def run_jax(seed, m):
        x, ws, bs = inputs(seed)
        return jrowconv.conv_chain_strided(
            jnp.asarray(x), *_jax(ws, bs), strides, (True,) * 6, taps=(1, 3, 5), compute_dtype_name=m
        )

    def run_port(seed, m):
        x, ws, bs = inputs(seed)
        return rowconv.conv_chain_strided(
            torch.from_numpy(x), *_port(ws, bs), strides, (True,) * 6, taps=(1, 3, 5),
            compute_dtype_name=m,
        )

    assert _gap_ratio(run_port, run_jax, range(3), mode) <= 0.5


@pytest.mark.parametrize("mode", ["bfloat16", "bf16_dot"])
def test_flow_level_chain_follows_reference_rounding(mode):
    """A whole flow level (cost volume, concat, 4 layers) in the bf16
    modes, by the same criterion over 3 seeds."""

    def run(pkg, seed, m):
        arrays, ws, bs = _level_inputs(np.random.default_rng(200 + seed), 3, 32)
        return [_flow_level(pkg, arrays, ws, bs, 3, m)]

    ratio = _gap_ratio(
        lambda seed, m: run(rowconv, seed, m), lambda seed, m: run(jrowconv, seed, m), range(3), mode
    )
    assert ratio <= 0.5


def test_estimator_chain_follows_reference_rounding():
    """conv_chain_nhwc in bf16 by the same criterion over 3 seeds."""

    def inputs(seed):
        rng = np.random.default_rng(300 + seed)
        x = rng.normal(size=(2, 7, 13, 40)).astype(np.float32)
        return x, *_make(rng, (3,) * 4, (96, 64, 32, 2), 40, bias_scale=0.1)

    def run_jax(seed, m):
        x, ws, bs = inputs(seed)
        return [jrowconv.conv_chain_nhwc(jnp.asarray(x), *_jax(ws, bs), EST_RELUS, m)]

    def run_port(seed, m):
        x, ws, bs = inputs(seed)
        return [rowconv.conv_chain_nhwc(torch.from_numpy(x), *_port(ws, bs), EST_RELUS, m)]

    assert _gap_ratio(run_port, run_jax, range(3), "bfloat16") <= 0.5


# ----------------------------------------------------------------- contract


def test_wrappers_refuse_autograd_and_count_nothing_on_the_cpu():
    """Serving only: a wrapper raises when autograd would differentiate it
    (grad enabled and an input requiring grad), on the CPU as on CUDA.
    Under no_grad it runs the plain version, and the launch counters of
    the kernels do not move."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(1, 8, 8, 3)).astype(np.float32))
    ws, bs = _port(*_make(rng, (3,), (4,), 3))
    arrays, lws, lbs = _level_inputs(rng, 2, 8, shape=(1, 4, 5))
    lws, lbs = _port(lws, lbs)
    level = [torch.from_numpy(a) for a in arrays]
    calls = {
        "conv_chain_strided": lambda w: rowconv.conv_chain_strided(x, [w], bs, (2,), (True,), None, "float32"),
        "conv_chain_nhwc": lambda w: rowconv.conv_chain_nhwc(x, [w], bs, (True,), "float32"),
        "flow_level_fused": lambda w: rowconv.flow_level_fused(
            *level, [w, *lws[1:]], lbs, 2, EST_RELUS, "float32"),
    }
    rowconv.reset_counts()
    for name, call in calls.items():
        w = (lws[0] if name == "flow_level_fused" else ws[0]).clone().requires_grad_()
        with pytest.raises(RuntimeError, match="serving-only"):
            call(w)
        with torch.no_grad():
            out = call(w)
        assert torch.isfinite(out).all()
    assert rowconv.launches == dict.fromkeys(calls, 0)
    assert rowconv.device_launches == dict.fromkeys(calls, 0)
    with pytest.raises(ValueError, match="unknown fused compute mode"):
        rowconv.conv_chain_strided(x, ws, bs, (2,), (True,), None, "float16")


def test_kernel_side_plumbing_with_the_launches_emulated(monkeypatch):
    """The wrappers' CUDA branch (weight repacking to (k, k, Cin, Cout)
    in the dot dtype, zero-padded input channels, taps, output dtypes,
    launch counts) run on the CPU, with each kernel launch emulated by
    the plain layer on the same buffers: the plain versions' results."""

    def layer(x, wp, b, out, stride, relu, act, dot):
        w = wp.permute(3, 2, 0, 1)  # back to OIHW
        assert torch.equal(w, w.to(dot).float()) and x.dtype == act and x.is_contiguous()
        out.copy_(rowconv._layer_plain(x, w, b, stride, relu, act, dot).to(out.dtype))

    def level_input(f1, f2, feat, flow_up, x, search):
        cv = torch.relu(rowconv.cost_volume_plain(f1.float(), f2.float(), search))
        cat = torch.cat([cv, feat.float(), flow_up], -1)
        x.zero_()[..., : cat.shape[3]] = cat.to(x.dtype)

    monkeypatch.setattr(rowconv, "_launch_layer", layer)
    monkeypatch.setattr(rowconv, "_launch_level_input", level_input)
    monkeypatch.setattr(rowconv, "_check_serving", lambda name, tensors: "cuda")
    rng = np.random.default_rng(5)
    rowconv.reset_counts()
    for mode in ("float32", "bfloat16", "bf16_dot"):
        act = torch.bfloat16 if mode == "bfloat16" else torch.float32
        x = torch.from_numpy(rng.uniform(size=(2, 16, 24, 3)).astype(np.float32))
        ws, bs = _port(*_make(rng, (3,) * 6, (16, 16, 32, 32, 64, 64), 3))
        args = (ws, bs, (2, 1) * 3, (True,) * 6, (1, 3, 5), mode)
        got = rowconv.conv_chain_strided(x.to(act), *args)
        want = rowconv.conv_chain_strided_plain(x.to(act), *args)
        assert [g.dtype for g in got] == [act] * 3
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        wide = torch.from_numpy(rng.normal(size=(2, 7, 13, 41)).astype(np.float32))  # padded to 44
        ws, bs = _port(*_make(rng, (3,) * 4, (96, 64, 32, 2), 41))
        # Zero-padded channels may change the CPU conv's order of sums:
        # float32 within 1e-5, bf16 within one ulp of the largest output.
        close = _assert_f32 if mode != "bfloat16" else _assert_one_ulp
        got = rowconv.conv_chain_nhwc(wide.to(act), ws, bs, EST_RELUS, mode)
        assert got.dtype == torch.float32
        close(got, rowconv.conv_chain_nhwc_plain(wide.to(act), ws, bs, EST_RELUS, mode))
        arrays, lws, lbs = _level_inputs(rng, 3, 32)
        f1, f2, feat, flow_up = (torch.from_numpy(a) for a in arrays)
        level = (f1.to(act), f2.to(act), feat.to(act), flow_up, *_port(lws, lbs), 3, EST_RELUS, mode)
        got = rowconv.flow_level_fused(*level)
        assert got.dtype == torch.float32
        close(got, rowconv.flow_level_fused_plain(*level))
    assert rowconv.launches == dict.fromkeys(rowconv.launches, 3)
    assert rowconv.device_launches == {"flow_level_fused": 15, "conv_chain_strided": 18, "conv_chain_nhwc": 12}
