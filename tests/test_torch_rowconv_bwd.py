"""The training chains' backward kernels (`csrc/rowconv_bwd.cu`) by a CPU
emulation of their algorithm, and the Python side that launches them
(`kernels/rowconv_ad.py`: `dgrad_plan`, `wgrad_plan`, `_pack_dgrad`, the
gate's padding to `padded_cout`, the sweep in `_chain_bwd_cuda`); and the
flow level's input backward by an emulation of its tile plan.

The emulation follows the kernels: split-TF32 products (each float32
operand hi + lo, products lo*hi + hi*lo + hi*hi, the middle one dropped
where an operand is exact in TF32), dgrad's parity classes with flipped
taps and its K order (Cout chunks of 8, then the class's taps), wgrad's
output tiles and chunks, its 8-pixel k-steps two at a time (dgrad: one
tap) summed in a fresh accumulator and added to a running sum, the pairs
dealt in turn to the 4 / wn warps of a column group, whose sums are added
in warp order, the chunks' fixed-order reduce, db as a product with
ones. TF32 rounding is
emulated on the integer view, (bits + 0x1000) & ~0x1fff: to nearest,
ties away, as cvt.rna.tf32.f32. A product of two TF32 values is exact in
float32; each 8-term mma sum is taken in float32.

Criteria: 1e-5 of each gradient's largest element against the plain
versions summed in float64 (chip_smoke.py's limit for the kernels on the
card); through a chain's sweep, 1e-4 of each gradient's largest against
the JAX package's `conv_chain_strided_ad` (jax.vjp, Pallas in interpret
mode), the float32 criterion of tests/test_torch_rowconv_ad.py.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_rowconv_ad import _assert_f32, _chain_jax, _chain_port, _level_jax, _level_port

from davo_tpu_torch.kernels import cuda_build, rowconv, rowconv_ad

LIMIT = 1e-5  # chip_smoke.py ROWCONV_BWD_TOL


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ----------------------------------------------------------------- emulation


def _tf32(t):
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _mma(acc, a, b, passes=3):
    """acc + a @ b as the kernels' products: split TF32 in 3 passes, 2
    where b is exact in TF32 (its lo dropped), or one TF32 pass."""
    ahi, alo = _split(a.contiguous())
    bhi, blo = _split(b.contiguous())
    if passes == 1:
        return acc + ahi @ bhi
    acc = acc + alo @ bhi
    if passes == 3:
        acc = acc + ahi @ blo
    return acc + ahi @ bhi


def _emulate_gate(dy, g, a_out, relu):
    """conv_layer_gate: dz float32 with Cout padded to padded_cout."""
    dz = rowconv_ad._gate_plain(dy, g, a_out, relu).float()
    return F.pad(dz, (0, rowconv_ad.padded_cout(dz.shape[3]) - dz.shape[3]))


def _emulate_dgrad(dz, w, x_shape, stride, dtype=torch.float32, passes=3, sms=132):
    """conv_layer_dgrad on dz (B, Ho, Wo, cop) with `dgrad_plan`'s K
    splits: per parity class (py, px) the pixels iy = iy0 + s*j read dz
    row oy = j + uy - my through tap ky = py + s*my; each split sums its
    Cout chunks of 8, a chunk its class's taps, each tap's products in a
    fresh sum added to the running one; the splits' sums are added in
    order."""
    B, H, W, cin = x_shape
    cout, _, k, _ = w.shape
    _, Ho, Wo, cop = dz.shape
    top, _, left, _ = rowconv_ad._pads(H, W, k, stride)
    splits = rowconv_ad.dgrad_plan(B, H, W, cin, cout, k, stride, sms)[4]
    per = -(-(cop // 8) // splits)
    wp = rowconv_ad._pack_dgrad(w, cop).view(k, k, cin, cop)
    dx = torch.zeros(B, H, W, cin)
    for py in range(stride):
        for px in range(stride):
            iy0, ix0 = (py - top) % stride, (px - left) % stride
            ny, nx = len(range(iy0, H, stride)), len(range(ix0, W, stride))
            if not ny or not nx:
                continue
            uy, ux = (iy0 + top - py) // stride, (ix0 + left - px) // stride
            total = torch.zeros(B * ny * nx, cin)
            taps = [(ky, kx) for ky in range(py, k, stride) for kx in range(px, k, stride)]
            for c in range(cop // 8):
                if c % per == 0:
                    acc = torch.zeros(B * ny * nx, cin)
                for ky, kx in taps:  # each tap's products into a fresh sum
                    oy = torch.arange(ny) + uy - (ky - py) // stride
                    ox = torch.arange(nx) + ux - (kx - px) // stride
                    ok = ((oy >= 0) & (oy < Ho))[:, None] & ((ox >= 0) & (ox < Wo))[None, :]
                    a = dz[:, oy.clamp(0, Ho - 1)][:, :, ox.clamp(0, Wo - 1), 8 * c : 8 * c + 8]
                    a = (a * ok[None, :, :, None]).reshape(-1, 8)
                    acc = acc + _mma(torch.zeros_like(acc), a, wp[ky, kx, :, 8 * c : 8 * c + 8].T, passes)
                if c % per == per - 1 or c == cop // 8 - 1:
                    total = total + acc if splits > 1 else acc
            dx[:, iy0::stride, ix0::stride] = total.view(B, ny, nx, cin)
    return dx.to(dtype)


def _emulate_wgrad(x, dz, w_shape, stride, sms=132, passes=None):
    """conv_layer_wgrad on dz (B, Ho, Wo, cop) with `wgrad_plan`'s tiles
    and chunks: (dW OIHW, db) float32. passes: 3 for float32 x, 2 for
    bf16 x (exact in TF32), unless given."""
    cout, cin, k, _ = w_shape
    B, H, W, _ = x.shape
    _, Ho, Wo, cop = dz.shape
    top, _, left, _ = rowconv_ad._pads(H, W, k, stride)
    wn, _, _, th, tw, chunks, per = rowconv_ad.wgrad_plan(B, Ho, Wo, cin, cout, k, stride, sms, None,
                                                          x.element_size())[2:]
    wk = 4 // wn  # warps sharing a column tile's k-steps
    passes = passes or (2 if x.dtype == torch.bfloat16 else 3)
    ty_n, tx_n = -(-Ho // th), -(-Wo // tw)
    # im2col on the tile grid, columns (tap, channel) and a column of ones (db).
    hp, wp = (ty_n * th - 1) * stride + k, (tx_n * tw - 1) * stride + k
    xp = torch.zeros(B, hp, wp, cin)
    xp[:, top : top + H, left : left + W] = x[..., :cin].float()
    cols = torch.stack([xp[:, ky : ky + ty_n * th * stride : stride, kx : kx + tx_n * tw * stride : stride]
                        for ky in range(k) for kx in range(k)], 3).reshape(B, ty_n * th, tx_n * tw, -1)
    cols = torch.cat([cols, torch.ones(*cols.shape[:3], 1)], -1)
    zs = torch.zeros(B, ty_n * th, tx_n * tw, cop)
    zs[:, :Ho, :Wo] = dz
    cols[:, Ho:], cols[:, :, Wo:] = 0.0, 0.0
    total = B * ty_n * tx_n
    out = torch.zeros(cop, k * k * cin + 1)
    for z in range(chunks):
        phases = [torch.zeros_like(out) for _ in range(wk)]
        for t in range(z * per, min(z * per + per, total)):
            b, rem = divmod(t, ty_n * tx_n)
            ty, tx = divmod(rem, tx_n)
            tile = (b, slice(ty * th, ty * th + th), slice(tx * tw, tx * tw + tw))
            a, bm = zs[tile].reshape(th * tw, cop), cols[tile].reshape(th * tw, -1)
            for ks in range(0, th * tw // 8, 2):  # phase (ks // 2) % wk: k-steps ks, ks + 1 into one fresh sum
                fresh = torch.zeros_like(out)
                for step in (ks, ks + 1):
                    rows = slice(8 * step, 8 * step + 8)
                    fresh = _mma(fresh, a[rows].T, bm[rows], passes)
                phases[(ks // 2) % wk] = phases[(ks // 2) % wk] + fresh
        acc = phases[0]
        for p in phases[1:]:
            acc = acc + p
        out = out + acc
    dw = out[:cout, :-1].view(cout, k, k, cin).permute(0, 3, 1, 2).contiguous()
    return dw, out[:cout, -1].contiguous()


# ------------------------------------------------------------------- helpers


def _layer(seed, B, H, W, cin, cout, k, stride, relu=True, tap=True, x_dtype=torch.float32):
    """One layer's backward inputs from numpy: x, dy, g, a_out, OIHW w."""
    rng = np.random.default_rng(seed)
    ho, wo = -(-H // stride), -(-W // stride)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)).to(x_dtype)
    w = torch.from_numpy(rng.normal(0, (k * k * cin) ** -0.5, (cout, cin, k, k)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(B, ho, wo, cout)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(B, ho, wo, cout)).astype(np.float32)) if tap else None
    a_out = torch.from_numpy(rng.normal(size=(B, ho, wo, cout)).astype(np.float32)).clamp_min(0)
    return x, dy, g, a_out, w


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


# Layers of the fused chains' kinds, cut to a few pixels: (B, H, W, Cin,
# Cout, k, stride).
LAYERS = {
    "3x3_s1": (2, 7, 13, 16, 24, 3, 1),
    "3x3_s2_odd": (2, 9, 11, 12, 16, 3, 2),
    "k7_s2_first": (1, 14, 20, 3, 16, 7, 2),
    "k5_s2": (2, 8, 12, 9, 32, 5, 2),
    "flow_head": (2, 6, 10, 32, 2, 3, 1),
    "cin2_s2": (2, 10, 16, 2, 16, 3, 2),
}


# --------------------------------------------------------------------- tests


def test_tf32_split_holds_tf32_bits_and_restores_float32():
    """hi and lo carry only TF32 bits (the low 13 mantissa bits zero) and
    hi + lo is the float32 value to within 2^-22 of it."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(np.concatenate([rng.normal(size=4096), rng.uniform(-1e-3, 1e-3, 4096),
                                         rng.normal(scale=1e4, size=4096)]).astype(np.float32))
    hi, lo = _split(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi.double() + lo.double() - v.double()).abs() / v.double().abs()).max()) <= 2.0**-22
    # One TF32 rounding alone leaves ~2^-12 (ties away from zero on the magnitude).
    assert float(((hi.double() - v.double()).abs() / v.double().abs()).max()) > 2.0**-14
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])  # half a TF32 ulp: away from zero
    assert torch.equal(_tf32(tie), torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10)]))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_emulated_kernels_match_the_plain_backward(name):
    """dgrad and wgrad as the kernels compute them, from the gate's padded
    dz, against the plain versions summed in float64."""
    B, H, W, cin, cout, k, stride = LAYERS[name]
    x, dy, g, a_out, w = _layer(1, B, H, W, cin, cout, k, stride)
    dz = _emulate_gate(dy, g, a_out, True)
    assert dz.shape[3] % 8 == 0 and not dz[..., cout:].any()
    want_dx = rowconv_ad.conv_layer_dgrad_plain(dy.double(), g, a_out, True, w.double(), x.shape, stride)
    want_dw, want_db = rowconv_ad.conv_layer_wgrad_plain(x.double(), dy.double(), g, a_out, True, w.shape, stride)
    assert _rel(_emulate_dgrad(dz, w, x.shape, stride), want_dx) <= LIMIT
    dw, db = _emulate_wgrad(x, dz, w.shape, stride)
    assert _rel(dw, want_dw) <= LIMIT and _rel(db, want_db) <= LIMIT


def test_emulated_wgrad_on_bf16_activations_takes_two_passes():
    """A bf16 layer input is exact in TF32: wgrad's 2-pass product equals
    the 3-pass one bitwise there, and both meet the limit."""
    B, H, W, cin, cout, k, stride = LAYERS["3x3_s1"]
    x, dy, g, a_out, w = _layer(2, B, H, W, cin, cout, k, stride, x_dtype=torch.bfloat16)
    dz = _emulate_gate(dy, None, a_out, True)
    two, three = _emulate_wgrad(x, dz, w.shape, stride), _emulate_wgrad(x, dz, w.shape, stride, passes=3)
    assert all(torch.equal(a, b) for a, b in zip(two, three))
    want_dw, want_db = rowconv_ad.conv_layer_wgrad_plain(x.double(), dy.double(), None, a_out, True, w.shape, stride)
    assert _rel(two[0], want_dw) <= LIMIT and _rel(two[1], want_db) <= LIMIT


def test_split_is_what_keeps_a_deep_k_within_the_limit():
    """K = 9 * 512 (DispNet's widest dgrad): the split products meet 1e-5
    of the largest element against float64; one TF32 pass does not."""
    x, dy, _, a_out, w = _layer(3, 1, 4, 6, 8, 512, 3, 1, tap=False)
    dz = _emulate_gate(dy, None, a_out, True)
    want = rowconv_ad.conv_layer_dgrad_plain(dy.double(), None, a_out, True, w.double(), x.shape, 1)
    assert _rel(_emulate_dgrad(dz, w, x.shape, 1), want) <= LIMIT
    assert _rel(_emulate_dgrad(dz, w, x.shape, 1, passes=1), want) > 10 * LIMIT


@pytest.mark.parametrize("B,H,W,cin,cout,k,stride", [
    (12, 128, 416, 3, 32, 7, 2), (12, 64, 208, 32, 32, 3, 1), (8, 32, 104, 179, 96, 3, 1),
    (12, 8, 26, 256, 512, 3, 2), (12, 4, 13, 512, 512, 3, 1), (8, 64, 208, 9, 16, 7, 2), (2, 6, 10, 2, 16, 3, 2),
    (1, 1, 1, 5, 2, 3, 2),
])
def test_dgrad_plan_tiles_cover_every_class_within_the_card_limits(B, H, W, cin, cout, k, stride):
    """Every input pixel and channel lies in one launched block; the
    shared memory of a launch (two stages of the dz halo and the class's
    weights, 12 floats a slot) fits the 227 KB a block can use; K splits
    only where the blocks would not give every SM two, into at most as
    many splits as Cout chunks."""
    nt, wm, th, tw, splits = rowconv_ad.dgrad_plan(B, H, W, cin, cout, k, stride, 132)
    assert th * tw == 32 * wm and tw % 8 == 0 and nt in ((8, 4, 2, 1) if wm == 4 else (4, 2, 1))
    assert 1 <= splits <= rowconv_ad.padded_cout(cout) // 8
    assert splits > 1 or B * H * W >= 20_000 or cout <= 8
    n_block = nt * 8 * (4 // wm)
    assert n_block <= 64
    per = -(-k // stride)
    assert 2 * ((th + per - 1) * (tw + per - 1) + per * per * n_block) * 12 * 4 <= 227 * 1024
    ny, nx = -(-H // stride), -(-W // stride)
    ty, tx = -(-ny // th), -(-nx // tw)
    seen = torch.zeros(H, W, dtype=torch.int32)
    for py in range(stride):
        for px in range(stride):
            for t in range(ty * tx):
                j0, i0 = (t // tx) * th, (t % tx) * tw
                top, _, left, _ = rowconv_ad._pads(H, W, k, stride)
                iy0, ix0 = (py - top) % stride, (px - left) % stride
                rows = [iy0 + stride * j for j in range(j0, j0 + th) if iy0 + stride * j < H]
                cols = [ix0 + stride * i for i in range(i0, i0 + tw) if ix0 + stride * i < W]
                for iy in rows:
                    seen[iy, cols] += 1
    assert bool((seen == 1).all())


def test_ctypes_signatures_match_the_c_entry_points():
    """Each entry point's argtypes in `rowconv_ad.SIGNATURES` follow its C
    declaration in csrc/rowconv_bwd.cu, a pointer per pointer and an int
    per int (ctypes would pass a missing or extra argument unchecked)."""
    src = (cuda_build.CSRC_DIR / "rowconv_bwd.cu").read_text()
    for name, argtypes in rowconv_ad.SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert argtypes == want, name


def test_sweep_of_the_emulated_kernels_matches_jax(monkeypatch):
    """The CUDA branch of `conv_chain_strided_ad` (`_chain_bwd_cuda`: the
    gate, wgrad and dgrad per layer from the last, taps injected, dx in
    the input's dtype), each launch emulated as the kernel computes, on
    the JAX tests' k 7/5/3, stride 2/2/1 chain at odd width, against
    `jax.vjp` of the reference; and the launch counts."""

    def layer(x, w, b, out, stride, relu, act, dot):
        w = F.pad(w, (0, 0, 0, 0, 0, x.shape[3] - w.shape[1]))
        out.copy_(rowconv._layer_plain(x, w, b, stride, relu, act, dot).to(out.dtype))

    def gate(dy, g, a_out, relu):
        assert dy is None or (dy.dtype == torch.float32 and dy.is_contiguous())
        rowconv_ad.device_launches["conv_layer_gate"] += 1
        return _emulate_gate(dy, g, a_out, relu)

    def wgrad(x, dz, w_shape, stride):
        rowconv_ad.device_launches["conv_layer_wgrad"] += 1
        return _emulate_wgrad(x, dz, w_shape, stride)

    def dgrad(dz, w, x_shape, stride, dtype):
        rowconv_ad.device_launches["conv_layer_dgrad"] += 1
        return _emulate_dgrad(dz, w, x_shape, stride, dtype)

    monkeypatch.setattr(rowconv, "_launch_layer", layer)
    monkeypatch.setattr(rowconv_ad, "_launch_gate", gate)
    monkeypatch.setattr(rowconv_ad, "_launch_wgrad", wgrad)
    monkeypatch.setattr(rowconv_ad, "_launch_dgrad", dgrad)
    monkeypatch.setattr(rowconv_ad, "_on_cuda", lambda t: True)
    rowconv_ad.reset_counts()
    case = "k7_5_3_s2_s2_s1_odd_width"
    _, got = _chain_port(case, 0, "float32")
    _, want = _chain_jax(case, 0, "float32")
    for a, b in zip(got, want):
        assert a.shape == b.shape and float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
    assert {k: v for k, v in rowconv_ad.device_launches.items() if v} == {
        "conv_chain_strided_ad": 3, "conv_layer_gate": 3, "conv_layer_wgrad": 3, "conv_layer_dgrad": 3}


# ----------------------------------------------- the flow level's input backward


def _level_constants():
    """The tile plan's constants as csrc/rowconv_bwd.cu states them."""
    src = (cuda_build.CSRC_DIR / "rowconv_bwd.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kLvlTileH", "kLvlTileW", "kLvlPix", "kLvlSlice")}


def _stage_gates(da0, a0, C, b, y0, x0, search, is_df1, dy0, nr, gd):
    """The kernel's `lvl_stage_gates` on the CPU: the tile's gates of shift
    rows [dy0, dy0 + nr) from the strided rows of da0 and a0 (their widths
    are the rows' strides), g = da0 * (a0 > 0) * float32(1 / C), 0 where
    the term drops out, at gs[p * gd + r * d + dx], walked in the kernel's
    element order (df2: by tile row, shift row, window column, dx). Slots
    it does not write stay NaN."""
    k = _level_constants()
    th, tw = k["kLvlTileH"], k["kLvlTileW"]
    B, H, W, _ = a0.shape
    s, d = search, 2 * search + 1
    ww = tw + 2 * s
    da_flat, a0_flat = da0.float().reshape(-1), a0.float().reshape(-1)
    inv_c = torch.tensor(1.0 / C, dtype=torch.float32)
    e = torch.arange(th * tw * nr * d if is_df1 else th * nr * ww * d)
    if is_df1:
        p = e // (nr * d)
        tl = e - p * (nr * d)
        t = dy0 * d + tl
        y, x = y0 + p // tw, x0 + p % tw
        sy, sx = y + t // d - s, x + t % d - s
        inside = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    else:
        wx_dx, pair = e % (ww * d), e // (ww * d)
        qy, r = pair // nr, pair % nr
        wx, dx = wx_dx // d, wx_dx % d
        px = wx - 2 * s + dx
        tl, t = r * d + dx, (dy0 + r) * d + dx
        p = torch.where((px >= 0) & (px < tw), qy * tw + px, -1)
        y, x = y0 + qy + s - dy0 - r, x0 - s + wx
        inside = (p >= 0) & (y0 + qy < H)
    inside &= (y >= 0) & (y < H) & (x >= 0) & (x < W)
    pix = (b * H + y.clamp(0, H - 1)) * W + x.clamp(0, W - 1)
    gate = da_flat[pix * da0.shape[3] + t] * (a0_flat[pix * a0.shape[3] + t] > 0).float() * inv_c
    gs = torch.full((th * tw * gd,), float("nan"))
    keep = p >= 0
    gs[p[keep] * gd + tl[keep]] = torch.where(inside, gate, 0.0)[keep]
    return gs



def _emulate_level_input_bwd(f1, f2, a0, da0, search, cf, cu, rows=None):
    """`flow_level_input_bwd` as its kernel computes it, on the CPU: per
    tile of kLvlTileH x kLvlTileW pixels, gradient and slice of kLvlSlice
    channels, the d shift rows in passes of `rows` (all d: one pass), each
    staging the gates of its shift rows (`_stage_gates`) and the rows of
    the other map's window that they read (the window: the tile grown by
    `search`, 0 outside the frame and past C; bf16 maps widened exactly),
    the thread's reads indexed from the pass's first staged row; each
    output summed over t ascending across the passes (an fma: the exact
    product added in float64, then rounded to float32), written where it
    lies in the frame, rounded once to f1's dtype; dfeat and dflow copied."""
    k = _level_constants()
    th, tw, slice_ = k["kLvlTileH"], k["kLvlTileW"], k["kLvlSlice"]
    B, H, W, C = f1.shape
    d = 2 * search + 1
    D = d * d
    rows = d if rows is None else rows
    gd = rows * d
    py, px = torch.meshgrid(torch.arange(th), torch.arange(tw), indexing="ij")
    py, px = py.reshape(-1), px.reshape(-1)  # tile pixels
    outs = {"df1": torch.zeros(B, H, W, C), "df2": torch.zeros(B, H, W, C)}
    for b in range(B):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                y, x = y0 + py, x0 + px
                for name, map_, is_df1 in (("df1", f2, True), ("df2", f1, False)):
                    window = torch.zeros(th + 2 * search, tw + 2 * search, -(-C // slice_) * slice_)
                    ys, xs = slice(max(y0 - search, 0), min(y0 + th + search, H)), slice(
                        max(x0 - search, 0), min(x0 + tw + search, W))
                    window[ys.start - (y0 - search): ys.stop - (y0 - search),
                           xs.start - (x0 - search): xs.stop - (x0 - search), :C] = map_[b, ys, xs].float()
                    acc = torch.zeros(th * tw, window.shape[2])
                    for c0 in range(0, window.shape[2], slice_):
                        part = torch.zeros(th * tw, slice_)
                        for dy0 in range(0, d, rows):
                            nr = min(rows, d - dy0)
                            wr0 = dy0 if is_df1 else 2 * search - dy0 - nr + 1
                            staged = window[wr0: wr0 + nr + th - 1, :, c0: c0 + slice_]
                            assert staged.shape[0] == nr + th - 1
                            gs = _stage_gates(da0, a0, C, b, y0, x0, search, is_df1, dy0, nr, gd)
                            for r in range(nr):
                                for dx in range(d):
                                    sy = py + (r if is_df1 else nr - 1 - r)
                                    sx = px + (dx if is_df1 else 2 * search - dx)
                                    g = gs[(py * tw + px) * gd + r * d + dx]
                                    m = staged[sy, sx]
                                    part = (part.double() + g[:, None].double() * m.double()).float()
                        acc[:, c0: c0 + slice_] = part
                    inside = (y < H) & (x < W)
                    outs[name][b, y[inside], x[inside]] = acc[inside, :C]
    return (outs["df1"].to(f1.dtype), outs["df2"].to(f1.dtype), da0[..., D: D + cf].float(),
            da0[..., D + cf: D + cf + cu].float())


def _level_bwd_inputs(seed, B, H, W, C, search, dtype, cf=None, cu=2):
    """f1, f2 (dtype), the float32 estimator input a0 (its width padded to
    4, as the forward writes it) and a random da0 of the dgrad's width
    (D + Cf + Cu: rows that are not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    cf = C if cf is None else cf
    f1 = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dtype)
    f2 = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dtype)
    flow = torch.from_numpy(rng.normal(size=(B, H, W, cu)).astype(np.float32))
    a0 = rowconv_ad.level_input_plain(f1, f2, f1 if cf == C else f1[..., :cf], flow, search)
    a0 = F.pad(a0, (0, -(-a0.shape[3] // 4) * 4 - a0.shape[3]))
    D = (2 * search + 1) ** 2
    da0 = torch.from_numpy(rng.normal(size=(B, H, W, D + cf + cu)).astype(np.float32))
    return f1, f2, a0, da0, cf, cu


# (B, H, W, C, search, map dtype, shift rows a pass or None for one pass):
# an odd frame smaller than a tile with C off the 32-channel slices; bf16
# maps over several tiles with a ragged edge and two slices; search 3; the
# passes a search too wide for one takes (here forced at small sizes),
# with a shorter last pass.
LEVEL_BWD_CASES = {
    "odd_5x11_c20_s4_f32": (2, 5, 11, 20, 4, torch.float32, None),
    "bf16_19x37_c40_s4": (1, 19, 37, 40, 4, torch.bfloat16, None),
    "s3_9x17_c8_f32": (2, 9, 17, 8, 3, torch.float32, None),
    "s3_9x17_c8_f32_rows3": (2, 9, 17, 8, 3, torch.float32, 3),
    "bf16_11x21_c24_s5_rows2": (1, 11, 21, 24, 5, torch.bfloat16, 2),
}


@pytest.mark.parametrize("name", sorted(LEVEL_BWD_CASES))
def test_emulated_level_input_bwd_matches_the_plain_version(name):
    """The kernel's tile plan against `flow_level_input_bwd_plain` summed
    in float64: float32 outputs within 1e-5 of each gradient's largest;
    bf16 df1, df2 (rounded once) at most 1e-3 of their elements (or one)
    off the float64 sum rounded to bf16, by at most one ulp at the
    gradient's scale; dfeat and dflow exact copies."""
    B, H, W, C, search, dtype, rows = LEVEL_BWD_CASES[name]
    f1, f2, a0, da0, cf, cu = _level_bwd_inputs(7, B, H, W, C, search, dtype)
    assert da0.shape[3] % 4 and a0.shape[3] % 4 == 0
    got = _emulate_level_input_bwd(f1, f2, a0, da0, search, cf, cu, rows)
    want = rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0.double(), search, cf, cu)
    assert torch.equal(got[2], want[2].float()) and torch.equal(got[3], want[3].float())
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == dtype and a.shape == b.shape
        if dtype == torch.float32:
            assert _rel(a, b) <= LIMIT
        else:
            d = (a.float() - b.to(dtype).float()).abs()
            assert int((d > 0).sum()) <= max(1e-3 * d.numel(), 1)
            assert float(d.max()) <= 2.0**-7 * float(b.abs().max())


@pytest.mark.parametrize("rows", [1, 2])
def test_level_input_bwd_passes_sum_as_one_pass(rows):
    """Passes of `rows` shift rows (a wide search's plan) give df1 and df2
    bitwise equal to one pass of all d rows: each output still sums its
    terms in ascending t, and every gate and window element a pass reads
    was staged by that pass."""
    f1, f2, a0, da0, cf, cu = _level_bwd_inputs(9, 1, 10, 19, 12, 2, torch.float32)
    one = _emulate_level_input_bwd(f1, f2, a0, da0, 2, cf, cu)
    passes = _emulate_level_input_bwd(f1, f2, a0, da0, 2, cf, cu, rows)
    assert all(torch.equal(a, b) for a, b in zip(one, passes))


def test_emulated_level_input_bwd_in_the_flow_level_matches_jax(monkeypatch):
    """The flow level's backward on the CPU with its input part computed
    as the kernel's tile plan (`_emulate_level_input_bwd` in place of the
    plain version), f1 of 8 channels and a 16-channel feat at search 4:
    every gradient within 1e-4 of its largest of the JAX package's
    `flow_level_fused_ad` (jax.vjp; Pallas in interpret mode)."""
    calls = []

    def emulated(*args):
        calls.append(args[0].shape)
        return _emulate_level_input_bwd(*args)

    monkeypatch.setattr(rowconv_ad, "flow_level_input_bwd_plain", emulated)
    got_out, got_grads = _level_port("search4_proj8", 0, "float32")
    want_out, want_grads = _level_jax("search4_proj8", 0, "float32")
    assert calls
    _assert_f32(got_out, want_out)
    _assert_f32(got_grads, want_grads)
