"""The fused layer's float32 mode (split TF32 on the tensor cores) and the
flow level's input kernel on the cost volume's tiles (`csrc/conv_mma.cuh`,
`csrc/costvol_tile.cuh`, `csrc/rowconv.cu`), by CPU emulations of their
algorithms, held against the plain versions and the JAX package.

The kernels run only on the card (chip_smoke.py phase 3d holds them there
against the plain versions). Here their arithmetic runs in PyTorch:

- the float32 layer: the weights as `_pack_tf32` packs them (TF32 hi and
  lo planes in the tensor-core K order), the input split once into hi and
  lo (none for a bf16 input, exact in TF32), each 16 K's products lo*hi +
  hi*lo + hi*hi (8-term sums in float32, two k-steps, small terms first)
  into a fresh sum added to the running float32 sum, then + bias, one
  rounding where the activations are bf16, ReLU;
- the level input: per 4x32 tile the f2 window staged with zeros off the
  frame, each correlation an fmaf chain over the channels ascending times
  1/C, then the epilogue's 4-channel groups of relu(correlations), feat,
  flow_up and zero padding, rounded once to the activation dtype, and
  the unrounded float32 a0.

Criteria: float32 within 1e-5 of the largest output (chip_smoke.py's
ROWCONV_F32_TOL; absolute 1e-5 for the level input and a0); bf16 at most
1e-3 of the elements one ulp apart at the output's scale.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_rowconv import (EST_RELUS, _assert_f32, _flow_level, _gap_ratio, _im2col_mma, _jax, _level_inputs,
                                _make, _port)

from davo_tpu.kernels import rowconv as jrowconv
from davo_tpu_torch.kernels import cuda_build, rowconv, rowconv_ad


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ----------------------------------------------------------------- emulation


def _split(t):
    hi = rowconv.tf32_rna(t)
    return hi, rowconv.tf32_rna(t - hi)


def _emulate_tf32_layer(x, w, b, stride, relu, act, passes=3):
    """One float32-mode layer as the split-TF32 tile computes each output:
    x (B, H, W, Cin) float32 or bf16 -> (B, Ho, Wo, Cout) in `act`.
    passes=1: one TF32 product (hi*hi) per term, for comparison."""
    cin, cout, k = x.shape[3], w.shape[0], w.shape[-1]
    hi_w, lo_w = rowconv._pack_tf32(w, cin)
    cols = _im2col_mma(x.float(), k, stride, cin)
    assert cols.shape[3] == hi_w.shape[1]
    a_hi, a_lo = _split(cols)
    if x.dtype == torch.bfloat16:  # exact in TF32: no lo, two products
        assert not a_lo.any()
    acc = torch.zeros(*cols.shape[:3], hi_w.shape[0])
    for k16 in range(0, cols.shape[3], 16):
        fresh = torch.zeros_like(acc)
        for ks in (k16, k16 + 8):
            s = slice(ks, ks + 8)
            if passes == 3:
                fresh = fresh + a_lo[..., s] @ hi_w[:, s].t()
                fresh = fresh + a_hi[..., s] @ lo_w[:, s].t()
            fresh = fresh + a_hi[..., s] @ hi_w[:, s].t()
        acc = acc + fresh
    y = (acc[..., :cout] + b.float()).to(act)
    return torch.relu(y) if relu else y


TILE_H, TILE_W = 4, 32  # the level input's tile at searches 3 and 4 (`plan_forward`)


def _emulate_level_input(f1, f2, feat, flow_up, search, cpad, act):
    """The flow level's input kernel: (x in `act`, a0 float32), both
    (B, H, W, cpad)."""
    B, H, W, C = f1.shape
    d, D = 2 * search + 1, (2 * search + 1) ** 2
    Cf, Cu = feat.shape[3], flow_up.shape[3]
    a, b = f1.float(), f2.float()
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32)
    x = torch.empty(B, H, W, cpad, dtype=act)
    a0 = torch.empty(B, H, W, cpad)
    py, px = torch.meshgrid(torch.arange(TILE_H), torch.arange(TILE_W), indexing="ij")
    for y0 in range(0, H, TILE_H):
        for x0 in range(0, W, TILE_W):
            th, tw = min(TILE_H, H - y0), min(TILE_W, W - x0)
            window = torch.zeros(B, TILE_H + 2 * search, TILE_W + 2 * search, C)
            ys, xs = slice(max(y0 - search, 0), min(y0 + TILE_H + search, H)), slice(
                max(x0 - search, 0), min(x0 + TILE_W + search, W))
            window[:, ys.start - (y0 - search): ys.stop - (y0 - search),
                   xs.start - (x0 - search): xs.stop - (x0 - search)] = b[:, ys, xs]
            tile = F.pad(a[:, y0: y0 + th, x0: x0 + tw], (0, 0, 0, TILE_W - tw, 0, TILE_H - th))
            cv = torch.zeros(B, TILE_H, TILE_W, D)
            for dy in range(d):
                for dx in range(d):
                    acc = torch.zeros(B, TILE_H, TILE_W)
                    for c in range(C):  # fmaf, channels ascending
                        m = window[:, py + dy, px + dx, c]
                        acc = (acc.double() + tile[..., c].double() * m.double()).float()
                    cv[..., dy * d + dx] = acc * inv_c
            # The epilogue: groups of 4 channels of one pixel.
            for g0 in range(0, cpad, 4):
                v = torch.zeros(B, th, tw, 4)
                for j in range(4):
                    ch = g0 + j
                    if ch < D:
                        v[..., j] = torch.relu(cv[:, :th, :tw, ch])
                    elif ch < D + Cf:
                        v[..., j] = feat[:, y0: y0 + th, x0: x0 + tw, ch - D].float()
                    elif ch < D + Cf + Cu:
                        v[..., j] = flow_up[:, y0: y0 + th, x0: x0 + tw, ch - D - Cf]
                x[:, y0: y0 + th, x0: x0 + tw, g0: g0 + 4] = v.to(act)
                a0[:, y0: y0 + th, x0: x0 + tw, g0: g0 + 4] = v
    return x, a0


def _assert_one_ulp_at_scale(got, want):
    d = (got.float() - want.float()).abs()
    assert int((d > 0).sum()) <= max(1e-3 * d.numel(), 1)
    assert float(d.max()) <= 2.0**-7 * float(want.float().abs().max())


# --------------------------------------------------------------------- tests


def test_tf32_packing_holds_tf32_planes_in_the_tensor_core_order():
    """`_pack_tf32`: hi and lo carry only TF32 bits, restore the weights
    to ~2^-22 of each, sit in `mma_order` (the bf16 kernel's K order and
    padding), and zero rows past Cout."""
    rng = np.random.default_rng(3)
    for cin in (3, 9, 20):
        w = torch.from_numpy(rng.normal(size=(10, cin, 5, 5)).astype(np.float32))
        hi, lo = rowconv._pack_tf32(w)
        for t in (hi, lo):
            assert not (t.view(torch.int32) & 0x1FFF).any()
        order = rowconv.mma_order(w)
        assert hi.shape == order.shape == rowconv._pack_mma(w).shape
        assert float(((hi + lo) - order).abs().max()) <= 2.0**-22 * float(order.abs().max())
        assert torch.equal(hi, rowconv.tf32_rna(order)) and not hi[10:].any() and not lo[10:].any()
        assert torch.equal(rowconv._pack_mma(w), order.to(torch.bfloat16))


@pytest.mark.parametrize("cin", [3, 9, 83])
@pytest.mark.parametrize("k, stride", [(3, 1), (3, 2), (5, 1), (5, 2), (7, 1), (7, 2)])
def test_emulated_tf32_layer_matches_plain_and_jax(k, stride, cin):
    """The split-TF32 tile's arithmetic on one layer (flat K for Cin 3 and
    9, 16-channel chunks for 83; odd dims at stride 1; Cout 10, padded to 16) within
    1e-5 of the largest output of `_layer_plain` in float32 and of the JAX
    package's `conv_chain_strided` (float32, interpret mode); a bf16 input
    (two products) within the same limit of the plain layer on it."""
    rng = np.random.default_rng(40 + 3 * k + stride + cin)
    h, w = (9, 11) if stride == 1 else (10, 14)  # the reference's stride 2 takes even dims only
    x = rng.uniform(-1, 1, size=(2, h, w, cin)).astype(np.float32)
    ws, bs = _make(rng, (k,), (10,), cin, bias_scale=0.1)
    (w,), (b,) = _port(ws, bs)
    xt = torch.from_numpy(x)
    got = _emulate_tf32_layer(xt, w, b, stride, True, torch.float32)
    _assert_f32(got, rowconv._layer_plain(xt, w, b, stride, True, torch.float32, torch.float32))
    want = jrowconv.conv_chain_strided(jnp.asarray(x), *_jax(ws, bs), (stride,), (True,),
                                       compute_dtype_name="float32")
    _assert_f32(got, want)
    xb = xt.to(torch.bfloat16)
    _assert_f32(_emulate_tf32_layer(xb, w, b, stride, True, torch.float32),
                rowconv._layer_plain(xb.float(), w, b, stride, True, torch.float32, torch.float32))


def test_split_keeps_a_deep_k_within_the_limit():
    """At K = 9 * 512 (a 3x3 layer of 512 channels) the split products in
    fresh 16-K sums stay within 1e-5 of the float64 sum's largest output,
    where one TF32 product per term misses it by far."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-1, 1, size=(1, 5, 6, 512)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, (9 * 512) ** -0.5, size=(16, 512, 3, 3)).astype(np.float32))
    b = torch.zeros(16)
    want = F.conv2d(x.double().permute(0, 3, 1, 2), w.double(), padding=1).permute(0, 2, 3, 1)
    scale = float(want.abs().max())
    split = _emulate_tf32_layer(x, w, b, 1, False, torch.float32)
    one = _emulate_tf32_layer(x, w, b, 1, False, torch.float32, passes=1)
    assert float((split.double() - want).abs().max()) <= 1e-5 * scale
    assert float((one.double() - want).abs().max()) > 1e-4 * scale


def _emulated_launches(monkeypatch):
    """The wrappers' CUDA branch on the CPU, each layer launch by
    `_emulate_tf32_layer` (float32 mode) and each level input by
    `_emulate_level_input`, on the same buffers."""

    def layer(x, w, b, out, stride, relu, act, dot):
        assert dot == torch.float32
        wp = F.pad(w, (0, 0, 0, 0, 0, x.shape[3] - w.shape[1]))
        out.copy_(_emulate_tf32_layer(x, wp, b, stride, relu, act).to(out.dtype))

    def level_input(f1, f2, feat, flow_up, x, search, a0=None):
        got, got_a0 = _emulate_level_input(f1, f2, feat, flow_up, search, x.shape[3], x.dtype)
        x.copy_(got)
        if a0 is not None:
            a0.copy_(got_a0)

    monkeypatch.setattr(rowconv, "_launch_layer", layer)
    monkeypatch.setattr(rowconv, "_launch_level_input", level_input)
    monkeypatch.setattr(rowconv, "_check_serving", lambda name, tensors: "cuda")


def test_emulated_float32_chains_match_jax(monkeypatch):
    """The strided chain (the pose prefix's kernels 7/5/3 on 9 channels,
    a pyramid with taps), the stride-1 estimator chain and a whole flow
    level (search 3, C=8, Cf=32, odd width) in float32 through the
    wrappers with the emulated kernels: within 1e-5 of the largest output
    of the JAX package's kernels (interpret mode)."""
    _emulated_launches(monkeypatch)
    rng = np.random.default_rng(17)
    x = rng.uniform(size=(1, 16, 24, 9)).astype(np.float32)
    ws, bs = _make(rng, (7, 5, 3), (16, 32, 40), 9)
    got = rowconv.conv_chain_strided(torch.from_numpy(x), *_port(ws, bs), (2, 2, 2), (True,) * 3, None, "float32")
    _assert_f32(got, jrowconv.conv_chain_strided(jnp.asarray(x), *_jax(ws, bs), (2, 2, 2), (True,) * 3,
                                                 compute_dtype_name="float32"))
    x = rng.uniform(size=(2, 8, 12, 3)).astype(np.float32)
    ws, bs = _make(rng, (3,) * 4, (16, 16, 32, 32), 3)
    got = rowconv.conv_chain_strided(torch.from_numpy(x), *_port(ws, bs), (2, 1, 2, 1), (True,) * 4, (1, 3),
                                     "float32")
    want = jrowconv.conv_chain_strided(jnp.asarray(x), *_jax(ws, bs), (2, 1, 2, 1), (True,) * 4, taps=(1, 3),
                                       compute_dtype_name="float32")
    for g, w in zip(got, want):
        _assert_f32(g, w)
    x = rng.normal(size=(2, 5, 9, 41)).astype(np.float32)
    ws, bs = _make(rng, (3,) * 4, (96, 64, 32, 2), 41)
    got = rowconv.conv_chain_nhwc(torch.from_numpy(x), *_port(ws, bs), EST_RELUS, "float32")
    _assert_f32(got, jrowconv.conv_chain_nhwc(jnp.asarray(x), *_jax(ws, bs), EST_RELUS, "float32"))
    arrays, ws, bs = _level_inputs(rng, 3, 32, shape=(2, 6, 37))
    got = rowconv.flow_level_fused(*map(torch.from_numpy, arrays), *_port(ws, bs), 3, EST_RELUS, "float32")
    want = jrowconv.flow_level_fused(*map(jnp.asarray, arrays), *_jax(ws, bs), 3, EST_RELUS,
                                     compute_dtype_name="float32")
    _assert_f32(got, want)


@pytest.mark.parametrize("search, dtype", [(3, torch.bfloat16), (3, torch.float32), (4, torch.bfloat16)])
def test_emulated_level_input_matches_the_plain_version(search, dtype):
    """The level input's tiles and epilogue (a frame of 2 x 2 tiles with
    ragged edges, cpad past D + Cf + Cu): a0 and a float32 output within
    1e-5 absolute of `level_input_plain`; a bf16 output (rounded once)
    by the one-ulp criterion against the plain input rounded to bf16."""
    rng = np.random.default_rng(60 + search)
    B, H, W, C, Cf = 2, 7, 37, 8, 12
    f1, f2, feat = (torch.from_numpy(rng.normal(size=(B, H, W, c)).astype(np.float32)).to(dtype)
                    for c in (C, C, Cf))
    flow_up = torch.from_numpy(rng.normal(scale=2.0, size=(B, H, W, 2)).astype(np.float32))
    D = (2 * search + 1) ** 2
    cpad = -(-(D + Cf + 2) // 4) * 4
    assert cpad > D + Cf + 2
    x, a0 = _emulate_level_input(f1, f2, feat, flow_up, search, cpad, dtype)
    want = F.pad(rowconv_ad.level_input_plain(f1, f2, feat, flow_up, search), (0, cpad - D - Cf - 2))
    assert float((a0 - want).abs().max()) <= 1e-5
    assert x.dtype == dtype and not x[..., D + Cf + 2:].any()
    if dtype == torch.float32:
        assert float((x - want).abs().max()) <= 1e-5
    else:
        _assert_one_ulp_at_scale(x, want.to(dtype))


def test_emulated_level_input_in_the_bf16_flow_level_keeps_the_gap_criterion(monkeypatch):
    """Whole bf16 flow levels with the emulated input kernel (the layers
    the plain bf16 layer), as tests/test_torch_rowconv.py holds them: over
    3 seeds the gap to the JAX level at most half of JAX's own gap between
    bf16 and float32."""
    monkeypatch.setattr(rowconv, "_launch_level_input", lambda f1, f2, feat, flow_up, x, search, a0=None: x.copy_(
        _emulate_level_input(f1, f2, feat, flow_up, search, x.shape[3], x.dtype)[0]))
    monkeypatch.setattr(rowconv, "_launch_layer", lambda x, w, b, out, stride, relu, act, dot: out.copy_(
        rowconv._layer_plain(x, F.pad(w, (0, 0, 0, 0, 0, x.shape[3] - w.shape[1])), b, stride, relu, act, dot)
        .to(out.dtype)))
    monkeypatch.setattr(rowconv, "_check_serving", lambda name, tensors: "cuda")

    def run(pkg, seed, mode):
        arrays, ws, bs = _level_inputs(np.random.default_rng(200 + seed), 3, 32)
        return [_flow_level(pkg, arrays, ws, bs, 3, mode)]

    ratio = _gap_ratio(lambda seed, m: run(rowconv, seed, m), lambda seed, m: run(jrowconv, seed, m), range(3),
                       "bfloat16")
    assert ratio <= 0.5


def test_last_level_input_kernel_names_what_the_launcher_recorded(monkeypatch):
    """`rowconv.last_level_input_kernel` names the code that
    `davo_flow_level_input_last` returns (the tile kernel's search
    instance, or the element kernel; none before a launch), and the C
    launcher records each code just before it launches that kernel."""
    def stub(code):
        def last(out):
            out[0] = code
            return 0
        return types.SimpleNamespace(davo_flow_level_input_last=last)

    for code, name in ((3, "flow_level_input_kernel<3>"), (4, "flow_level_input_kernel<4>"),
                       (-1, "flow_level_input_kernel<-1>"), (-2, "flow_level_input_element_kernel")):
        monkeypatch.setattr(rowconv, "_library", lambda code=code: stub(code))
        assert rowconv.last_level_input_kernel() == name
    monkeypatch.setattr(rowconv, "_library", lambda: stub(0))
    with pytest.raises(RuntimeError, match="no flow_level_input launch"):
        rowconv.last_level_input_kernel()
    src = (cuda_build.CSRC_DIR / "rowconv.cu").read_text()
    assert re.search(r"last_level_input = -2;\s*flow_level_input_element_kernel<T><<<", src)
    assert re.search(r"last_level_input = search == 3 \|\| search == 4 \? search : -1;\s*switch \(search\)", src)
    assert re.search(r"int davo_flow_level_input_last\(int\* out\) \{\s*out\[0\] = last_level_input;", src)
