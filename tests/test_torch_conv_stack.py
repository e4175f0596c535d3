"""The conv stack's plain version against the JAX package's Pallas kernel
(`davo_tpu/kernels/conv_stack.py::fused_conv_stack`, interpret mode on
the CPU).

On CPU tensors `fused_conv_stack` runs this plain version; the CUDA
kernel (`csrc/conv_stack.cu`) is held against the same plain version on
the card by chip_smoke.py (phase 3f). Inputs and weights come from numpy
with a fixed seed (weights as `tests/test_kernels.py::TestFusedConvStack._make`).
The JAX kernel takes HWIO weights, the port OIHW.

The kernel's own arithmetic runs here too, by CPU emulations: the bf16
tile order, and the float32 mode's split TF32 (`_pack_tf32`'s hi and lo
weight planes, the input split into hi and lo, three products a term, a
fresh sum every 16 K) at the plan a CPU port of `mma_plan` gives.

Criteria: float32 within 1e-5 of the largest output. bfloat16: the output
is float32 (the last layer unrounded); one layer within 1e-5 of the
largest, as both sum the same bf16 x bf16 products in float32, and,
rounded to bf16 as a layer's output is between layers, at most 1e-3 of
its elements differ, by at most one bf16 ulp (the placement check shows
that criterion tells the kernel's rounding apart from two wrong ones); a
stack, over its layers' rounding flips, at most half of JAX's own gap
between bf16 and float32.
"""

import contextlib
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from davo_tpu.kernels import conv_stack as jconv_stack
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.kernels import conv_stack, cuda_build, rowconv
from davo_tpu_torch.models.common import ConvBlock


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


def _port(ws, bs):
    return ([torch.from_numpy(w.transpose(3, 2, 0, 1).copy()) for w in ws],
            [torch.from_numpy(b) for b in bs])


def _both(x, ws, bs, strides, relus, batch_tile, mode):
    want = jconv_stack.fused_conv_stack(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), strides, relus,
        batch_tile=batch_tile, compute_dtype_name=mode,
    )
    got = conv_stack.fused_conv_stack(
        torch.from_numpy(x), *_port(ws, bs), strides, relus, batch_tile=batch_tile, compute_dtype_name=mode,
    )
    return got, np.asarray(want)


def _assert_close(got, want):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).float().numpy()


def _differ_share_and_ulps(got, want):
    """The share of elements that differ once both are rounded to bf16,
    and the largest gap in bf16 ulps at the output's scale."""
    g, w = _bf16(got), _bf16(want)
    return float(np.mean(g != w)), float(np.abs(g - w).max() / (2.0**-7 * np.abs(w).max()))


CASES = {
    # name: (input shape, kernel sizes, channels, strides, relus, batch_tile);
    # the first three are tests/test_kernels.py::TestFusedConvStack's.
    "stride1": ((4, 8, 12, 8), (3, 3), (16, 8), (1, 1), (True, True), 2),
    "stride2_k5_k3": ((2, 16, 24, 4), (5, 3), (8, 16), (2, 2), (True, True), 1),
    "mixed_2_1_2": ((2, 8, 8, 4), (3, 3, 3), (8, 8, 8), (2, 1, 2), (True,) * 3, 2),
    "odd_13x15_k3_s2": ((2, 13, 15, 4), (3,), (8,), (2,), (True,), 2),
    "odd_7x9_k5s2_k3s1": ((2, 7, 9, 3), (5, 3), (8, 16), (2, 1), (True, True), 1),
    "last_without_relu": ((2, 16, 20, 6), (7, 3, 3), (8, 16, 4), (2, 2, 1), (True, True, False), 2),
}


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_conv_stack_matches_reference(case, mode):
    """A float32 output within 1e-5 of the largest: in float32, and in bf16
    for one layer (both sum the same exact products of rounded operands).
    A bf16 stack of several layers, where a flip in an intermediate's
    rounding carries on: its gap to the JAX kernel is at most half of
    JAX's own gap between bf16 and float32."""
    shape, ks, chans, strides, relus, batch_tile = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.uniform(size=shape).astype(np.float32)
    ws, bs = _make(rng, ks, chans, shape[-1], bias_scale=0.1)
    got, want = _both(x, ws, bs, strides, relus, batch_tile, mode)
    if mode == "float32" or len(ks) == 1:
        _assert_close(got, want)
    else:
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        want32 = _both(x, ws, bs, strides, relus, batch_tile, "float32")[1]
        assert np.abs(got.numpy() - want).max() <= 0.5 * np.abs(want - want32).max()
    if not relus[-1]:
        assert (want < 0).any() and (got.numpy() < 0).any()


@pytest.mark.parametrize("k, stride", [(7, 2), (5, 2), (3, 1)])
def test_one_layer_rounds_as_the_kernel(k, stride):
    """One bf16 layer: rounded to bf16, at most 1e-3 of the elements differ
    from the JAX kernel's, by at most one ulp. Placement check: a bf16
    `ConvBlock` (conv output rounded, then a bf16 bias) and the layer on an
    unrounded float32 input both differ from the JAX kernel in more than
    5 % of the elements."""
    rng = np.random.default_rng(k * 10 + stride)
    cin, cout = (9, 16) if k == 7 else (16, 32)
    x = rng.uniform(-1, 1, size=(2, 16, 26, cin)).astype(np.float32)
    ws, bs = _make(rng, (k,), (cout,), cin, bias_scale=0.5)
    got, want = _both(x, ws, bs, (stride,), (True,), 1, "bfloat16")
    share, ulps = _differ_share_and_ulps(got.numpy(), want)
    assert share <= 1e-3 and ulps <= 1.0

    block = ConvBlock(cin, cout, k, stride, torch.bfloat16)
    load_flax_params(block, {"Conv_0": {"kernel": ws[0], "bias": bs[0]}})
    w_bf16 = [w.to(torch.bfloat16).float() for w in _port(ws, bs)[0]]
    with torch.no_grad():
        conv_block = block(torch.from_numpy(x)).float().numpy()
        unrounded_input = conv_stack.fused_conv_stack_plain(
            torch.from_numpy(x), w_bf16, _port(ws, bs)[1], (stride,), (True,), 1, "float32"
        ).numpy()
    for wrong in (conv_block, unrounded_input):
        assert _differ_share_and_ulps(wrong, want)[0] > 0.05


def test_bf16_output_is_float32_and_follows_reference_rounding():
    """The davo-fast pose prefix's k 7/5/3 at small size in bf16: a float32
    output, unrounded; over 3 seeds the port's gap to the JAX kernel is at
    most half of JAX's own gap between bf16 and float32."""
    gap = reference_gap = 0.0
    for seed in range(3):
        rng = np.random.default_rng(200 + seed)
        x = rng.uniform(size=(2, 32, 48, 9)).astype(np.float32)
        ws, bs = _make(rng, (7, 5, 3), (16, 32, 64), 9, bias_scale=0.1)
        got, want = _both(x, ws, bs, (2,) * 3, (True,) * 3, 2, "bfloat16")
        assert got.dtype == torch.float32 and not np.array_equal(_bf16(got.numpy()), got.numpy())
        want32 = _both(x, ws, bs, (2,) * 3, (True,) * 3, 2, "float32")[1]
        gap += np.abs(got.numpy() - want).max()
        reference_gap += np.abs(want - want32).max()
    assert reference_gap > 0 and gap <= 0.5 * reference_gap


def test_batch_tile_must_divide_the_batch_as_reference():
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(3, 8, 8, 4)).astype(np.float32)
    ws, bs = _make(rng, (3,), (8,), 4)
    with pytest.raises(AssertionError):
        jconv_stack.fused_conv_stack(
            jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), (1,), (True,),
            batch_tile=2, compute_dtype_name="float32",
        )
    for fn in (conv_stack.fused_conv_stack, conv_stack.fused_conv_stack_plain):
        with pytest.raises(ValueError, match="batch_tile"):
            fn(torch.from_numpy(x), *_port(ws, bs), (1,), (True,), batch_tile=2, compute_dtype_name="float32")


def test_same_pads_and_fusable_prefix_equal_the_reference():
    for size in range(1, 40):
        for k in (1, 3, 5, 7):
            for s in (1, 2):
                assert conv_stack.same_pads(size, k, s) == jconv_stack.same_pads(size, k, s)
    ks = (7, 5, 3, 3, 3, 3, 3)
    for h in (1, 2, 7, 13, 32, 64, 96, 128):
        for w in (1, 2, 15, 26, 104, 208, 416):
            for strides in ((2,) * 7, (2, 1) * 3 + (2,), (1,) * 7):
                assert conv_stack.fusable_prefix(h, w, ks, strides) == jconv_stack.fusable_prefix(h, w, ks, strides)
    assert conv_stack.fusable_prefix(128, 416, ks, (2,) * 7) == 5


def test_wrapper_counts_nothing_on_the_cpu_and_refuses_autograd():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(2, 8, 8, 4)).astype(np.float32))
    ws, bs = _port(*_make(rng, (3,), (8,), 4))
    conv_stack.reset_counts()
    conv_stack.fused_conv_stack(x, ws, bs, (1,), (True,), batch_tile=1)
    assert conv_stack.launches == conv_stack.device_launches == 0
    ws[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv_stack.fused_conv_stack(x, ws, bs, (1,), (True,), batch_tile=1)
    with torch.no_grad():
        conv_stack.fused_conv_stack(x, ws, bs, (1,), (True,), batch_tile=1)


def _view(ptr, dtype, shape):
    count = int(np.prod(shape))
    buf = (ctypes.c_char * (count * dtype.itemsize)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=count).view(*shape)


def _packed_shape(cout, cin, k):
    """(Np, K) of `rowconv._pack_mma`'s weights."""
    kp = -(-cin // 16) * 16 * k * k if rowconv.mma_chunked(cin) else -(-k * k * cin // 16) * 16
    return -(-cout // 8) * 8, kp


def _unpack(wp, cout, cin, k):
    """`rowconv._pack_mma`'s (Np, K) back to OIHW (cout, cin, k, k)."""
    if rowconv.mma_chunked(cin):
        cp = -(-cin // 16) * 16
        w = wp[:cout].reshape(cout, cp // 16, k, k, 16).permute(0, 1, 4, 2, 3).reshape(cout, cp, k, k)
        return w[:, :cin]
    return wp[:cout, : k * k * cin].reshape(cout, k, k, cin).permute(0, 3, 1, 2)


def _cols(x, k, s, pad_t, pad_l, ho, wo):
    """x (B, H, W, cin) float32 -> (B, ho, wo, K): each output pixel's
    inputs in the tensor-core kernels' K order (chunks of 16 channels,
    then taps, then channels; taps then channels, flat, for cin < 16),
    zero where the pads and the padding of K lie."""
    B, H, W, cin = x.shape
    chunked = rowconv.mma_chunked(cin)
    cp = -(-cin // 16) * 16 if chunked else cin
    pad_b, pad_r = max((ho - 1) * s + k - H - pad_t, 0), max((wo - 1) * s + k - W - pad_l, 0)
    xp = F.pad(x, (0, cp - cin, pad_l, pad_r, pad_t, pad_b))
    taps = torch.stack([xp[:, ky: ky + s * (ho - 1) + 1: s, kx: kx + s * (wo - 1) + 1: s]
                        for ky in range(k) for kx in range(k)], 3)  # (B, ho, wo, k*k, cp)
    if chunked:
        taps = taps.reshape(B, ho, wo, k * k, cp // 16, 16).permute(0, 1, 2, 4, 3, 5)
    cols = taps.reshape(B, ho, wo, -1)
    return F.pad(cols, (0, -(-cols.shape[3] // 16) * 16 - cols.shape[3]))


def _split_tf32_sum(cols, hi, lo):
    """cols (..., K) float32 times the (N, K) TF32 weight planes hi + lo as
    the split-TF32 tile sums them: the input split once into TF32 hi and lo
    (lo zero for a bf16 input), per 16 K a fresh sum of each 8-K step's
    lo*hi, hi*lo and hi*hi products, in that order, added to the running
    float32 sum. (..., N) float32."""
    a_hi = rowconv.tf32_rna(cols)
    a_lo = rowconv.tf32_rna(cols - a_hi)
    acc = torch.zeros(*cols.shape[:-1], hi.shape[0])
    for k16 in range(0, cols.shape[-1], 16):
        fresh = torch.zeros_like(acc)
        for ks in (k16, k16 + 8):
            s = slice(ks, ks + 8)
            fresh = fresh + a_lo[..., s] @ hi[:, s].t()
            fresh = fresh + a_hi[..., s] @ lo[:, s].t()
            fresh = fresh + a_hi[..., s] @ hi[:, s].t()
        acc = acc + fresh
    return acc


def _tf32_layer(x, planes, b, k, s, pad_t, pad_l, ho, wo, relu):
    """One float32-mode layer of the stack from `_pack_tf32`'s (2, Np, K)
    planes: split-TF32 sums, + bias, ReLU; float32, unrounded."""
    cout = b.shape[0]
    y = _split_tf32_sum(_cols(x.float(), k, s, pad_t, pad_l, ho, wo), planes[0], planes[1])[..., :cout] + b
    return torch.relu(y) if relu else y


def _tf32_stack(x, ws, bs, strides, relus):
    """The float32 stack as `_tf32_layer`s on `rowconv._pack_tf32`'s
    planes of the OIHW weights: what the kernel computes for each output."""
    y = x
    for w, b, s, r in zip(ws, bs, strides, relus):
        H, W, k = y.shape[1], y.shape[2], w.shape[-1]
        ho, pad_t, _ = conv_stack.same_pads(H, k, s)
        wo, pad_l, _ = conv_stack.same_pads(W, k, s)
        y = _tf32_layer(y, rowconv._pack_tf32(w, y.shape[3]), b, k, s, pad_t, pad_l, ho, wo, r)
    return y


def _emulated_launch(n, B, xs, outs, ws, bs, params, act_bf16, stream):
    """`davo_conv_stack` in PyTorch on the CPU: each layer from the
    pointers and the geometry of the table alone, as the kernel reads them
    (the packed weights: bf16 `_pack_mma`, or float32 `_pack_tf32` hi and
    lo planes summed in split TF32; the intermediates in one workspace at
    256-byte aligned offsets), after the checks the kernel makes."""
    assert len(params) == 13 * n
    for i in range(n):
        x_bf16, aligned, H, W, cin, Ho, Wo, cout, k, s, pad_t, pad_l, relu = params[13 * i: 13 * i + 13]
        assert aligned == 1 and (i == 0 or x_bf16 == act_bf16)
        if i:  # the workspace's regions, 256 bytes apart (its base: the CUDA allocator's 512)
            assert (xs[i] - xs[1]) % 256 == 0 and xs[i] == outs[i - 1]
        x = _view(xs[i], torch.bfloat16 if x_bf16 else torch.float32, (B, H, W, cin)).float()
        b = _view(bs[i], torch.float32, (cout,))
        out_dtype = torch.bfloat16 if act_bf16 and i < n - 1 else torch.float32
        if not act_bf16:
            planes = _view(ws[i], torch.float32, (2, *_packed_shape(cout, cin, k)))
            y = _tf32_layer(x, planes, b, k, s, pad_t, pad_l, Ho, Wo, relu)
            _view(outs[i], out_dtype, (B, Ho, Wo, cout)).copy_(y)
            continue
        w = _unpack(_view(ws[i], torch.bfloat16, _packed_shape(cout, cin, k)), cout, cin, k).float()
        x = x.to(torch.bfloat16).float()
        pad_b = max((Ho - 1) * s + k - H - pad_t, 0)
        pad_r = max((Wo - 1) * s + k - W - pad_l, 0)
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pad_l, pad_r, pad_t, pad_b)), w, stride=s)
        y = (y + b[:, None, None]).permute(0, 2, 3, 1)
        y = torch.relu(y) if relu else y
        _view(outs[i], out_dtype, (B, Ho, Wo, cout)).copy_(y.to(out_dtype))
    return 0


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_side_plumbing_with_the_launch_emulated(monkeypatch, mode):
    """The CUDA branch's layer table and workspace (geometry, SAME pads,
    dtypes, pointers to each intermediate, 256-byte aligned; the packed
    weights of the mode) run on the CPU, with the one launch emulated from
    the table: in bf16 the plain version's result; in float32 the
    split-TF32 stack's (`_tf32_stack` on the OIHW weights), bit for bit,
    which is within 1e-5 of the plain version's largest output."""
    stub = types.SimpleNamespace(davo_conv_stack=_emulated_launch)
    monkeypatch.setattr(conv_stack, "_library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.default_rng(6)
    for shape, ks, chans, strides in (((2, 13, 15, 4), (7, 5, 3), (8, 16, 4), (2, 2, 1)),
                                      ((2, 16, 24, 9), (7, 5, 3, 3), (16, 32, 64, 128), (2,) * 4),
                                      ((1, 9, 21, 20), (3, 3), (20, 24), (1, 2))):
        relus = (True,) * (len(ks) - 1) + (False,)
        ws, bs = _port(*_make(rng, ks, chans, shape[-1], bias_scale=0.1))
        for x_dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.uniform(-1, 1, size=shape).astype(np.float32)).to(x_dtype)
            got = conv_stack._stack_cuda(x, ws, bs, strides, relus, conv_stack.COMPUTE_DTYPES[mode])
            want = conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 1, mode)
            assert got.dtype == torch.float32 and got.shape == want.shape
            if mode == "float32":
                _assert_close(got, want.numpy())
                want = _tf32_stack(x.float(), ws, bs, strides, relus)
            assert torch.equal(got, want)


def test_ctypes_signatures_match_the_c_entry_points():
    """Each entry point's argtypes in `conv_stack.SIGNATURES` follow its C
    declaration in csrc/conv_stack.cu, a pointer per pointer and an int
    per int (ctypes would pass a missing or extra argument unchecked); the
    table's 13 ints a layer and MAX_LAYERS are the kernel's; the bf16
    plan's shared-memory cap leaves four blocks an SM (228 KB, 1 KB
    reserved per block), the float32 plan's two; the float32 kernel is
    bound to two blocks an SM, the bf16 one to four."""
    src = (cuda_build.CSRC_DIR / "conv_stack.cu").read_text()
    for name, argtypes in conv_stack.SIGNATURES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
        assert argtypes == want, name
    assert re.search(r"constexpr int kParams = 13;", src)
    assert re.search(rf"constexpr int kMaxLayers = {conv_stack.MAX_LAYERS};", src)
    cap = int(re.search(r"constexpr size_t kStackSmem = (\d+) \* 1024;", src).group(1)) * 1024
    assert 4 * (cap + 1024) <= 228 * 1024
    assert _tf32_cap() == int(re.search(r"constexpr size_t kStackSmemTf32 = (\d+) \* 1024;", src).group(1)) * 1024
    assert 2 * (_tf32_cap() + 1024) <= 228 * 1024 < 3 * (_tf32_cap() + 1024)
    assert re.search(r"__launch_bounds__\(kThreads, 4\) conv_stack_mma_kernel", src)
    assert re.search(r"__launch_bounds__\(kThreads, 2\) conv_stack_tf32_kernel", src)


def _emulate_mma_stack(x, ws, bs, strides, relus, tile_w=8, nt=8):
    """The bf16 stack as the tensor-core kernel computes it, tile by tile
    on the CPU: per layer 128-pixel tiles (128 / tile_w x tile_w) and
    channel blocks of nt*8 packed weight rows (a plan of `mma_plan`'s);
    per tile the K loop in the
    packed order (chunked: chunks of 16 input channels, then taps; flat:
    (tap, channel) flattened, zero-padded to a multiple of 16), each
    16-deep step's products summed in float32 and added to the float32
    accumulator; then + bias, one rounding to bf16 between layers (the
    last layer float32), ReLU; only pixels and channels inside the map
    are written."""
    y = x.to(torch.bfloat16).float()
    n = len(ws)
    for i, (w, b, s, r) in enumerate(zip(ws, bs, strides, relus)):
        B, H, W, cin = y.shape
        cout, _, k, _ = w.shape
        ho, pad_t, _ = conv_stack.same_pads(H, k, s)
        wo, pad_l, _ = conv_stack.same_pads(W, k, s)
        tile_h = 128 // tile_w
        wp = rowconv._packed(w, torch.bfloat16, cin).float()
        chunked = rowconv.mma_chunked(cin)
        cp = -(-cin // 16) * 16 if chunked else cin
        # Input padded for SAME and past every tile's halo; channels to cp.
        hh, hw = (tile_h - 1) * s + k, (tile_w - 1) * s + k
        th, tw = -(-ho // tile_h), -(-wo // tile_w)
        xp = torch.zeros(B, th * tile_h * s + hh, tw * tile_w * s + hw, cp)
        xp[:, pad_t: pad_t + H, pad_l: pad_l + W, :cin] = y
        out = torch.zeros(B, ho, wo, cout)
        for ty in range(th):
            for tx in range(tw):
                oy, ox = torch.meshgrid(torch.arange(tile_h), torch.arange(tile_w), indexing="ij")
                oy, ox = (oy + ty * tile_h).reshape(-1), (ox + tx * tile_w).reshape(-1)
                taps = [xp[:, oy * s + ky, ox * s + kx] for ky in range(k) for kx in range(k)]  # (B, 128, cp)
                if chunked:
                    cols = torch.stack(taps, 2).reshape(B, 128, k * k, cp // 16, 16).permute(0, 1, 3, 2, 4)
                else:
                    cols = torch.stack(taps, 2)
                cols = cols.reshape(B, 128, -1)
                cols = F.pad(cols, (0, wp.shape[1] - cols.shape[2]))
                for co0 in range(0, wp.shape[0], nt * 8):
                    acc = torch.zeros(B, 128, nt * 8)
                    block = F.pad(wp[co0: co0 + nt * 8], (0, 0, 0, nt * 8 - wp[co0: co0 + nt * 8].shape[0]))
                    for k0 in range(0, cols.shape[2], 16):
                        acc = acc + cols[:, :, k0: k0 + 16] @ block[:, k0: k0 + 16].t()
                    ncols = min(nt * 8, cout - co0)
                    if ncols <= 0:
                        continue
                    v = acc[..., :ncols] + b[co0: co0 + ncols].float()
                    if i < n - 1:
                        v = v.to(torch.bfloat16).float()
                    if r:
                        v = torch.relu(v)
                    inside = (oy < ho) & (ox < wo)
                    out[:, oy[inside], ox[inside], co0: co0 + ncols] = v[:, inside]
        y = out
    return y


@pytest.mark.parametrize("tile_w, nt", [(8, 8), (16, 2)])
def test_emulated_tensor_core_stack_follows_plain_and_reference(tile_w, nt):
    """The kernel's tile order (`_emulate_mma_stack`: flat K for the first
    layer's 9 channels, 16-channel chunks behind it, packed weights, Cout
    of 20 padded to 24, odd dims at strides 2 and 1) on a small pose-like
    stack, with 16x8 tiles of 64 channels or 8x16 tiles of 16: each layer,
    on the plain version's input to it, at most 1e-3 of its elements (one
    element here) off the plain bf16 layer after rounding, by at most one
    ulp; the stack's gap to the JAX kernel (interpret mode) at most half
    of JAX's own bf16-to-f32 gap."""
    rng = np.random.default_rng(31)
    shape, ks, chans, strides = (2, 13, 30, 9), (7, 5, 3), (20, 32, 16), (2, 2, 1)
    relus = (True, True, True)
    x = rng.uniform(size=shape).astype(np.float32)
    ws, bs = _make(rng, ks, chans, shape[-1], bias_scale=0.1)
    wt, bt = _port(ws, bs)
    xt = torch.from_numpy(x)
    got = _emulate_mma_stack(xt, wt, bt, strides, relus, tile_w, nt)
    inputs = [xt.to(torch.bfloat16)]
    for i in range(len(ks) - 1):
        inputs.append(rowconv._layer_plain(inputs[-1], wt[i], bt[i], strides[i], relus[i],
                                           torch.bfloat16, torch.bfloat16))
    for i, inp in enumerate(inputs):
        args = (inp, [wt[i]], [bt[i]], (strides[i],), (relus[i],), 1, "bfloat16")
        one = _emulate_mma_stack(inp, [wt[i]], [bt[i]], (strides[i],), (relus[i],), tile_w, nt)
        share, ulps = _differ_share_and_ulps(one.numpy(), conv_stack.fused_conv_stack_plain(*args).numpy())
        assert share * one.numel() <= max(1e-3 * one.numel(), 1) and ulps <= 1.0, (i, share, ulps)
    want = _both(x, ws, bs, strides, relus, 1, "bfloat16")[1]
    want32 = _both(x, ws, bs, strides, relus, 1, "float32")[1]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 0.5 * np.abs(want - want32).max()


# ------------------------------------------------ the float32 (split-TF32) stack

def _tf32_cap():
    """kStackSmemTf32, the float32 plan's shared memory a block."""
    src = (cuda_build.CSRC_DIR / "conv_stack.cu").read_text()
    return int(re.search(r"constexpr size_t kStackSmemTf32 = (\d+) \* 1024;", src).group(1)) * 1024


def _plan(H, W, cin, cout, k, stride, cap, prec):
    """`mma_plan` (csrc/conv_mma.cuh) as the stack calls it (4-warp tiles,
    NT up to 8) for operands of precision `prec`: "bf16"; "tf32", the
    input's halo in hi and lo planes (the layer kernel's); or
    "tf32_one_plane", one plane of it (the stack's float32 kernel, which
    splits the input as it reads it, and whose flat order stages the
    epilogue in the halo's place): the tile (16x8, or 8x16 where it
    computes fewer pixels past the map's edge), the widest NT whose shared
    memory fits `cap`, halving, and one staging buffer where two do not
    fit. (tile_h, tile_w, nt, stages, bytes), or None."""
    ho, wo = -(-H // stride), -(-W // stride)
    shapes = ((16, 8), (8, 16))

    def computed(th, tw):
        return -(-ho // th) * th * -(-wo // tw) * tw

    th, tw = shapes[1] if computed(*shapes[1]) < computed(*shapes[0]) else shapes[0]
    flat, taps = not rowconv.mma_chunked(cin), k * k
    hh, hw = (th - 1) * stride + k, (tw - 1) * stride + k
    hws = 2 * ((hw + 1) // 2) if stride == 2 else hw
    nchunks, kp, n8 = -(-cin // 16), -(-taps * cin // 16) * 16, -(-cout // 8)
    nt = 1 if n8 <= 1 else 2 if n8 <= 2 else 4 if n8 <= 4 else 8

    def smem(n_rows, stages):
        epi = th * tw * (n_rows + 4) * 4
        if prec == "bf16":
            ops = (n_rows * (kp // 8 + 1) * 16 + kp * 4 + hh * hw * cin * 2 if flat
                   else stages * (hh * hws * 2 + n_rows * taps * 2) * 16)
        else:
            a_planes = 2 if prec == "tf32" else 1
            halo = a_planes * hh * hw * cin * 4
            if prec == "tf32_one_plane":  # the flat order's epilogue stages in the halo's place
                halo = max(halo, epi)
            ops = (2 * n_rows * (kp // 4 + 1) * 16 + kp * 4 + halo if flat
                   else stages * (a_planes * hh * hws * 4 + 2 * n_rows * taps * 4) * 16)
        return max(ops, epi)

    while True:
        stages = 2 if not flat and nchunks > 1 else 1
        if smem(nt * 8, stages) > cap and stages == 2:
            stages = 1
        if smem(nt * 8, stages) <= cap:
            return th, tw, nt, stages, smem(nt * 8, stages)
        if nt == 1:
            return None
        nt //= 2


POSE_PREFIX = ((128, 416, 9, 16, 7), (64, 208, 16, 32, 5), (32, 104, 32, 64, 3), (16, 52, 64, 128, 3),
               (8, 26, 128, 256, 3))  # davo-fast's five fused pose layers: H, W, Cin, Cout, k (stride 2)


def test_float32_plan_of_the_pose_prefix_fits_two_blocks_an_sm():
    """The plan at the float32 cap for the davo-fast pose prefix at
    128x416, the input's halo in one plane: every layer has one (layer 0
    flat at NT=2, its 16 channels in one block, in 87,620 bytes; NT 2, 2,
    8, 8, 8), the largest within kStackSmemTf32, so two blocks stay
    resident on an SM. With the layer kernel's two planes the same cap
    leaves layer 1 at NT=1 and layers 2-4 at NT=4. The bf16 plan at
    kStackSmem gives the launch the card reports (48,000 bytes; NT 2, 4,
    8, 8, 8)."""
    cap = _tf32_cap()
    plans = [_plan(h, w, cin, cout, k, 2, cap, "tf32_one_plane") for h, w, cin, cout, k in POSE_PREFIX]
    assert all(plans) and max(p[4] for p in plans) <= cap
    assert plans[0] == (16, 8, 2, 1, 87_620) and [p[2] for p in plans] == [2, 2, 8, 8, 8]
    two_planes = [_plan(h, w, cin, cout, k, 2, cap, "tf32") for h, w, cin, cout, k in POSE_PREFIX]
    assert two_planes[0][4] == 115_592 and [p[2] for p in two_planes] == [2, 1, 4, 4, 4]
    bf16 = [_plan(h, w, cin, cout, k, 2, 56 * 1024, "bf16") for h, w, cin, cout, k in POSE_PREFIX]
    assert [p[2] for p in bf16] == [2, 4, 8, 8, 8] and max(p[4] for p in bf16) == 48_000


def _emulate_tf32_stack_tiles(x, ws, bs, strides, relus, cap):
    """The float32 stack as the kernel computes it, tile by tile on the
    CPU: per layer the plan's tiles (`_plan` at `cap`) and channel blocks
    of nt*8 rows of `_pack_tf32`'s planes; per tile and channel block the
    split-TF32 sums over K in the packed order (`_split_tf32_sum`: the
    input split into hi and lo, which the kernel does as it reads each
    fragment of its one staged plane, a fresh sum every 16 K), + bias,
    ReLU; float32
    intermediates, unrounded; only pixels and channels inside the map are
    written. Returns (output, the plans)."""
    y, plans = x, []
    for w, b, s, r in zip(ws, bs, strides, relus):
        B, H, W, cin = y.shape
        cout, k = w.shape[0], w.shape[-1]
        plan = _plan(H, W, cin, cout, k, s, cap, "tf32_one_plane")
        plans.append(plan)
        th, tw, nt = plan[:3]
        ho, pad_t, _ = conv_stack.same_pads(H, k, s)
        wo, pad_l, _ = conv_stack.same_pads(W, k, s)
        hi, lo = rowconv._pack_tf32(w, cin)
        # Every pixel of every tile, those past the map's edge too.
        hp, wp = -(-ho // th) * th, -(-wo // tw) * tw
        cols = _cols(y.float(), k, s, pad_t, pad_l, hp, wp)
        out = torch.empty(B, ho, wo, cout)
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                tile = cols[:, oy0: oy0 + th, ox0: ox0 + tw]
                for co0 in range(0, hi.shape[0], nt * 8):
                    rows = slice(co0, co0 + nt * 8)
                    acc = _split_tf32_sum(tile, hi[rows], lo[rows])
                    n_out = min(nt * 8, cout - co0)
                    v = acc[..., :n_out] + b[co0: co0 + n_out]
                    v = torch.relu(v) if r else v
                    out[:, oy0: oy0 + th, ox0: ox0 + tw, co0: co0 + n_out] = v[:, : ho - oy0, : wo - ox0]
        y = out
    return y, plans


@pytest.mark.parametrize("case", ["stride1", "stride2_k5_k3", "mixed_2_1_2", "pose_like", "pose_like_bf16_input"])
def test_emulated_tf32_stack_follows_plain_and_reference(case):
    """The float32 kernel's order (`_emulate_tf32_stack_tiles` at the
    float32 cap) on the JAX tests' shapes and a pose-like stack (Cin 9:
    flat K for layer 0, 16-channel chunks behind it; Cout 20 padded to
    24; odd dims at strides 2 and 1), also from a bf16 stack input (no
    lo: two products a term): within 1e-5 of the largest output of the
    plain version and of the JAX kernel in float32 (interpret mode)."""
    if case.startswith("pose_like"):
        shape, ks, chans, strides, relus = (2, 13, 30, 9), (7, 5, 3), (20, 32, 16), (2, 2, 1), (True,) * 3
    else:
        shape, ks, chans, strides, relus, _ = CASES[case]
    rng = np.random.default_rng(70 + len(case))
    x = rng.uniform(size=shape).astype(np.float32)
    ws, bs = _make(rng, ks, chans, shape[-1], bias_scale=0.1)
    if case.endswith("bf16_input"):
        x = _bf16(x)  # the same values for the JAX kernel as a float32 input
    xt = torch.from_numpy(x)
    xt = xt.to(torch.bfloat16) if case.endswith("bf16_input") else xt
    got, plans = _emulate_tf32_stack_tiles(xt, *_port(ws, bs), strides, relus, _tf32_cap())
    assert all(plans)
    plain = conv_stack.fused_conv_stack_plain(xt, *_port(ws, bs), strides, relus, 1, "float32")
    _assert_close(got, plain.numpy())
    _assert_close(got, _both(x, ws, bs, strides, relus, 1, "float32")[1])
    assert torch.allclose(got, _tf32_stack(xt.float(), *_port(ws, bs), strides, relus), rtol=0, atol=1e-6)
