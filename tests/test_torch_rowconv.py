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

import contextlib
import types

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
    """The wrappers' CUDA branch (zero-padded input channels, taps, output
    dtypes, launch counts) run on the CPU, with each kernel launch
    emulated by the plain layer on the same buffers, its weights packed as
    the kernel of its mode takes them and unpacked again: the plain
    versions' results."""

    def layer(x, w, b, out, stride, relu, act, dot):
        assert x.dtype == act and x.is_contiguous() and w.shape[1] <= x.shape[3]
        cin = x.shape[3]
        wp = rowconv._packed(w, dot, cin)
        assert wp is rowconv._packed(w, dot, cin)  # packed once per parameter
        if dot == torch.bfloat16:
            w = _unpack_mma(wp, w.shape[0], cin, w.shape[-1]).float()
        else:  # TF32 hi and lo planes that restore the weights to ~2^-22
            assert wp.shape[0] == 2 and all(torch.equal(t, rowconv.tf32_rna(t)) for t in wp)
            restored = _unpack_mma(wp[0] + wp[1], w.shape[0], cin, w.shape[-1])
            assert float((restored[:, : w.shape[1]] - w).abs().max()) <= 2.0**-21 * float(w.abs().max())
            w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, cin - w.shape[1]))
        assert torch.equal(w, w.to(dot).float())
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


@pytest.mark.parametrize("mode", ["bfloat16", "bf16_dot", "float32"])
def test_layer_launch_passes_the_kernel_its_packing_and_flags(monkeypatch, mode):
    """`_launch_layer`'s own glue, with the library replaced by one whose
    entry points record their arguments: bf16 products go to the
    tensor-core entry with `_packed`'s bf16 weights, float32 ones to the
    split-TF32 entry with its hi and lo planes; sizes, Flax's low pads,
    the input and output dtype flags, round_out and ReLU in the C
    interface's order; one call per launch; the packing reused."""
    calls = []

    class Library:
        def davo_conv_layer_mma(self, *args):
            calls.append(("davo_conv_layer_mma", args))
            return 0

        def davo_conv_layer_tf32(self, *args):
            calls.append(("davo_conv_layer_tf32", args))
            return 0

    monkeypatch.setattr(rowconv, "_library", lambda: Library())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=77))
    rng = np.random.default_rng(13)
    act, dot = rowconv.DTYPE_MODES[mode]
    B, H, W, cin, cout, k, stride = 2, 9, 11, 20, 10, 3, 2
    x = torch.from_numpy(rng.normal(size=(B, H, W, cin)).astype(np.float32)).to(act)
    w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(cout, cin - 2, k, k)).astype(np.float32)))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    Ho, Wo = -(-H // stride), -(-W // stride)
    for relu, out_dtype in ((True, act), (False, torch.float32)):
        out = torch.empty(B, Ho, Wo, cout, dtype=out_dtype)
        rowconv._launch_layer(x, w, b, out, stride, relu, act, dot)
        name, args = calls[-1]
        packed = rowconv._packed(w, dot, cin)
        if dot == torch.bfloat16:
            assert name == "davo_conv_layer_mma" and len(args) == 20
            assert torch.equal(packed, rowconv._pack_mma(w, cin))
            flags = (int(act == torch.bfloat16), int(relu))  # round_out, relu
        else:
            assert name == "davo_conv_layer_tf32" and len(args) == 20
            assert torch.equal(packed, rowconv._pack_tf32(w, cin))
            flags = (0, int(relu))  # round_out, relu
        assert args[:6] == (x.data_ptr(), int(act == torch.bfloat16), packed.data_ptr(), b.data_ptr(),
                            out.data_ptr(), int(out_dtype == torch.bfloat16))
        pads = (rowconv.same_pads(H, k, stride)[0], rowconv.same_pads(W, k, stride)[0])
        assert args[6:17] == (B, H, W, cin, Ho, Wo, cout, k, stride, *pads)
        assert args[17:-1] == flags and args[-1] == 77
    assert len(calls) == 2 and calls[0][1][2] == calls[1][1][2]  # packed once
    with pytest.raises(ValueError, match="do not fit"):
        rowconv._launch_layer(x[..., :16], w, b, out, stride, True, act, dot)


# ----------------------------------------------- the tensor-core kernel's weights


def _unpack_mma(wp, cout, cin, k):
    """`rowconv._pack_mma`'s (Np, K) back to OIHW (cout, cin, k, k)."""
    if rowconv.mma_chunked(cin):
        cp = -(-cin // 16) * 16
        w = wp[:cout].reshape(cout, cp // 16, k, k, 16).permute(0, 1, 4, 2, 3).reshape(cout, cp, k, k)
    else:
        w = wp[:cout, : k * k * cin].reshape(cout, k, k, cin).permute(0, 3, 1, 2)
    return w[:, :cin]


def _im2col_mma(x, k, stride, cin):
    """x (B, H, W, cin) -> (B, Ho, Wo, K): each output pixel's inputs in
    the tensor-core kernel's K order (chunks of 16 channels, then taps,
    then channels; or taps then channels, flat, for cin < 16), zero where
    SAME pads and where K is padded."""
    B, H, W, _ = x.shape
    (top, bottom), (left, right) = (rowconv.same_pads(n, k, stride) for n in (H, W))
    cp = -(-cin // 16) * 16 if rowconv.mma_chunked(cin) else cin
    xp = torch.nn.functional.pad(x, (0, cp - cin, left, right, top, bottom))
    Ho, Wo = -(-H // stride), -(-W // stride)
    taps = torch.stack([xp[:, ky: ky + stride * (Ho - 1) + 1: stride, kx: kx + stride * (Wo - 1) + 1: stride]
                        for ky in range(k) for kx in range(k)], 3)  # (B, Ho, Wo, k*k, cp)
    if rowconv.mma_chunked(cin):
        cols = taps.reshape(B, Ho, Wo, k * k, cp // 16, 16).permute(0, 1, 2, 4, 3, 5)
    else:
        cols = taps
    cols = cols.reshape(B, Ho, Wo, -1)
    return torch.nn.functional.pad(cols, (0, -(-cols.shape[3] // 16) * 16 - cols.shape[3]))


@pytest.mark.parametrize("cin", [3, 9, 83])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (5, 1), (5, 2), (7, 1), (7, 2)])
def test_kernel_weight_layouts_give_the_plain_layer(k, stride, cin):
    """Each layer kernel's packed weights (the tensor-core kernels' (Np,
    K): bf16 for the bf16 modes, float32 hi and lo TF32 planes for
    float32), multiplied with the input in the kernels' K order and zero
    padding (Cin to 16 or K flattened to a multiple of 16, Cout to 8),
    plus the bias, rounded once and ReLU'd, give `_layer_plain`: float32
    within 1e-5 of the largest output, bf16 by the one-ulp criterion (the
    same products summed in another order)."""
    rng = np.random.default_rng(11 + k + cin)
    cout = 10
    x = torch.from_numpy(rng.normal(size=(2, 9, 11, cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(cout, cin, k, k)) / np.sqrt(k * k * cin)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32) * 0.1)
    for mode in ("float32", "bfloat16", "bf16_dot"):
        act, dot = rowconv.DTYPE_MODES[mode]
        xa = x.to(act)
        want = rowconv._layer_plain(xa, w, b, stride, True, act, dot)
        if dot == torch.bfloat16:
            wp = rowconv._pack_mma(w)
            assert wp.dtype == torch.bfloat16 and wp.shape[0] == 16 and wp.shape[1] % 16 == 0
            assert not wp[cout:].any() and torch.equal(_unpack_mma(wp, cout, cin, k), w.to(torch.bfloat16))
            y = _im2col_mma(xa.to(dot).float(), k, stride, cin) @ wp.float().t()
            y = y[..., :cout]
        else:
            wp = rowconv._pack_tf32(w)  # (2, Np, K): hi and lo in the same K order
            assert wp.dtype == torch.float32 and wp.shape == (2, 16, rowconv._pack_mma(w).shape[1])
            assert not wp[:, cout:].any()
            assert torch.equal(_unpack_mma(wp[0], cout, cin, k), rowconv.tf32_rna(w))
            y = _im2col_mma(xa, k, stride, cin) @ (wp[0] + wp[1]).t()
            y = y[..., :cout]
        y = torch.relu((y + b).to(act))
        assert y.dtype == want.dtype and y.shape == want.shape
        (_assert_f32 if act == torch.float32 else _assert_one_ulp)(y, want)


def test_packed_weights_are_kept_until_the_parameter_changes():
    """`_packed` packs a parameter once per layout and input width, and
    packs it anew after an in-place update (an Adam step of the train
    loop) or when its storage is replaced; a new parameter gets its own."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.train.loop import AdamTx

    rng = np.random.default_rng(12)
    w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(10, 20, 3, 3)).astype(np.float32)))
    first = rowconv._packed(w, torch.bfloat16, 20)
    assert rowconv._packed(w, torch.bfloat16, 20) is first
    assert torch.equal(first, rowconv._pack_mma(w, 20))
    wide = rowconv._packed(w, torch.bfloat16, 24)
    f32 = rowconv._packed(w, torch.float32, 20)
    assert wide is not first and f32.dtype == torch.float32
    assert rowconv._packed(w, torch.float32, 20) is f32 and rowconv._packed(w, torch.bfloat16, 24) is wide

    w.grad = torch.from_numpy(rng.normal(size=w.shape).astype(np.float32))
    opt = AdamTx(presets.get("tiny"), [w])
    before = w.detach().clone()
    opt.step(0)
    assert not torch.equal(w.detach(), before)
    again = rowconv._packed(w, torch.bfloat16, 20)
    assert again is not first and torch.equal(again, rowconv._pack_mma(w, 20))
    assert not torch.equal(again, first)
    assert rowconv._packed(w, torch.bfloat16, 20) is again

    with torch.no_grad():
        w.data = torch.zeros_like(w)  # a new storage, the version counter of its own
    assert not rowconv._packed(w, torch.bfloat16, 20).any()
    other = torch.nn.Parameter(before)
    assert torch.equal(rowconv._packed(other, torch.bfloat16, 20), rowconv._pack_mma(before, 20))
