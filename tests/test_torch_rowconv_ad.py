"""The training chains' plain forwards and backwards against the JAX
package's `*_ad` functions (`davo_tpu/kernels/rowconv.py`, through
`jax.vjp`, Pallas kernels in interpret mode on the CPU).

On CPU tensors the port's `rowconv_ad` functions run these plain
versions; the CUDA kernels are held against the same plain versions on
the card by chip_smoke.py. Inputs, weights and output cotangents come from
numpy with a fixed seed; the JAX functions take HWIO weights, the port
OIHW.

Criteria: float32 within 1e-4 of each gradient's largest element (the
outputs and gradients agree to ~1e-6). bfloat16, over 3 seeds, for every
gradient leaf: the port's mean gap to the JAX gradient is at most
BF16_GAP_RATIO of JAX's own mean gap between bf16 and float32. Half of
it, the forward chains' criterion (`test_torch_rowconv._gap_ratio`),
cannot tell the backwards a port could write by mistake from the
reference's: on these cases they measure 0.017-0.72 of JAX's gap, the
plain versions at most 0.002 (the forward's rare rounding flips, which
reach the next layer's dW). The placement tests show the criterion
fails for each: bf16-rounded weights, a flow level whose first dW reads
the bf16 estimator input, and autograd of the plain bf16 forward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rowconv import EST_RELUS, _jax, _make, _np, _port

from davo_tpu.kernels import rowconv as jrowconv
from davo_tpu_torch.kernels import rowconv, rowconv_ad

BF16_GAP_RATIO = 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _dtypes(mode):
    return (jnp.bfloat16, torch.bfloat16) if mode == "bfloat16" else (jnp.float32, torch.float32)


# ---------------------------------------------------------------- the cases

CHAIN_CASES = {
    # name: (input shape, kernel sizes, channels, strides, relus, taps)
    "k7_5_3_s2_s2_s1_odd_width": ((2, 16, 52, 5), (7, 5, 3), (8, 12, 16), (2, 2, 1),
                                  (True, True, False), None),
    "pyramid_taps": ((2, 16, 24, 3), (3,) * 6, (16, 16, 32, 32, 64, 64), (2, 1) * 3,
                     (True,) * 6, (1, 3, 5)),
    "pose_prefix": ((1, 32, 64, 9), (7, 5, 3, 3), (16, 32, 32, 32), (2,) * 4, (True,) * 4, None),
    "estimator_odd_width": ((2, 7, 13, 40), (3,) * 4, (96, 64, 32, 2), (1,) * 4, EST_RELUS, None),
}
# (search, C, Cf): C=8 as after `cv_proj`; without the projection the
# correlation reads the features themselves (f1 is feat).
LEVEL_CASES = {"search4_proj8": (4, 8, 16), "search3_unprojected": (3, 16, 16)}


def _chain_inputs(case, seed):
    shape, ks, chans, strides, relus, taps = CHAIN_CASES[case]
    rng = np.random.default_rng(1000 * seed + len(case))
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    ws, bs = _make(rng, ks, chans, shape[-1], bias_scale=0.1)
    h, w = shape[1:3]
    gs = []
    for i, s in enumerate(strides):
        h, w = -(-h // s), -(-w // s)
        if i in (taps or (len(ks) - 1,)):
            gs.append(rng.normal(size=(shape[0], h, w, chans[i])).astype(np.float32))
    return x, ws, bs, gs


def _level_inputs(case, seed):
    search, C, cf = LEVEL_CASES[case]
    rng = np.random.default_rng(2000 * seed + search)
    shape = (2, 6, 13)
    f1 = rng.normal(size=(*shape, C)).astype(np.float32)
    f2 = rng.normal(size=(*shape, C)).astype(np.float32)
    feat = f1 if C == cf else rng.normal(size=(*shape, cf)).astype(np.float32)
    flow_up = rng.normal(scale=2.0, size=(*shape, 2)).astype(np.float32)
    ws, bs = _make(rng, (3,) * 4, (32, 24, 16, 2), (2 * search + 1) ** 2 + cf + 2, bias_scale=0.1)
    g = rng.normal(size=(*shape, 2)).astype(np.float32)
    return (f1, f2, feat, flow_up), ws, bs, g


# ------------------------------------------------------------ the two sides


def _chain_jax_fn(case, mode):
    _, _, _, strides, relus, taps = CHAIN_CASES[case]
    if strides == (1,) * len(strides):
        return lambda x, w, b: jrowconv.conv_chain_nhwc_ad(x, w, b, relus, mode)
    return lambda x, w, b: jrowconv.conv_chain_strided_ad(x, w, b, strides, relus, taps, mode)


@functools.cache
def _chain_jax(case, seed, mode):
    """(outputs, [dx, dW (HWIO) per layer, db per layer]) of the JAX function."""
    x, ws, bs, gs = _chain_inputs(case, seed)
    jdt, _ = _dtypes(mode)
    out, vjp = jax.vjp(_chain_jax_fn(case, mode), jnp.asarray(x, jdt), *_jax(ws, bs))
    taps = CHAIN_CASES[case][5]
    cot = [jnp.asarray(g) for g in gs] if taps else jnp.asarray(gs[0])
    dx, dws, dbs = vjp(cot)
    outs = list(out) if taps else [out]
    return [_np(o) for o in outs], [_np(dx)] + [_np(w) for w in dws] + [_np(b) for b in dbs]


def _chain_port(case, seed, mode, variant=None):
    """The port's (outputs, gradients in the JAX layout). variant: None
    (`rowconv_ad` on CPU tensors: the plain versions), "bf16_weights"
    (the plain backward on the same residuals with bf16-rounded weights)
    or "autograd" (torch.autograd through the plain forward)."""
    x, ws, bs, gs = _chain_inputs(case, seed)
    _, _, _, strides, relus, taps = CHAIN_CASES[case]
    _, tdt = _dtypes(mode)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt, bt = _port(ws, bs)
    for p in wt + bt:
        p.requires_grad_()
    gt = [torch.from_numpy(g) for g in gs]
    keep = taps or (len(ws) - 1,)
    if variant == "bf16_weights":
        acts = rowconv.conv_chain_strided_plain(xt.detach(), wt, bt, strides, relus, tuple(range(len(ws))), mode)
        rounded = [w.detach().to(torch.bfloat16).float() for w in wt]
        dx, dws, dbs = rowconv_ad.conv_chain_bwd_plain(xt.detach(), acts, rounded, strides, relus, keep, gt)
        outs, grads = [acts[t] for t in keep], [dx.to(tdt), *dws, *dbs]
    else:
        if variant == "autograd":
            outs = rowconv.conv_chain_strided_plain(xt, wt, bt, strides, relus, keep, mode)
        elif strides == (1,) * len(strides):
            outs = [rowconv_ad.conv_chain_nhwc_ad(xt, wt, bt, relus, mode)]
        else:
            outs = rowconv_ad.conv_chain_strided_ad(xt, wt, bt, strides, relus, keep, mode)
        torch.autograd.backward([o.float() for o in outs], gt)
        grads = [xt.grad, *(w.grad for w in wt), *(b.grad for b in bt)]
    n = len(ws)
    grads = [grads[0], *(w.permute(2, 3, 1, 0) for w in grads[1 : 1 + n]), *grads[1 + n :]]
    return [_np(o.detach()) for o in outs], [_np(g.detach()) for g in grads]


def _level_jax_args(case, seed, mode):
    arrays, ws, bs, g = _level_inputs(case, seed)
    jdt, _ = _dtypes(mode)
    f1, f2, feat, flow_up = arrays
    return (jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(feat, jdt), jnp.asarray(flow_up)), ws, bs, g


@functools.cache
def _level_jax(case, seed, mode):
    search = LEVEL_CASES[case][0]
    (f1, f2, feat, flow_up), ws, bs, g = _level_jax_args(case, seed, mode)
    out, vjp = jax.vjp(
        lambda f1, f2, feat, fu, w, b: jrowconv.flow_level_fused_ad(f1, f2, feat, fu, w, b, search, EST_RELUS, mode),
        f1, f2, feat, flow_up, *_jax(ws, bs),
    )
    df1, df2, dfeat, dflow, dws, dbs = vjp(jnp.asarray(g))
    if LEVEL_CASES[case][1] == LEVEL_CASES[case][2]:  # f1 is feat: one tensor, the cotangents summed
        df1, dfeat = df1 + dfeat, None
    grads = [df1, df2] + ([] if dfeat is None else [dfeat]) + [dflow, *dws, *dbs]
    return [_np(out)], [_np(t) for t in grads]


def _level_port(case, seed, mode, variant=None):
    """The port's flow level: None (`flow_level_fused_ad` on CPU
    tensors), "bf16_a0" (the plain backward with the first dW read from
    the bf16 estimator input) or "autograd" (torch.autograd through the
    plain forward)."""
    search, C, cf = LEVEL_CASES[case]
    arrays, ws, bs, g = _level_inputs(case, seed)
    _, tdt = _dtypes(mode)
    act, _ = rowconv.DTYPE_MODES[mode]
    f1 = torch.from_numpy(arrays[0]).to(tdt).requires_grad_()
    f2 = torch.from_numpy(arrays[1]).to(tdt).requires_grad_()
    feat = f1 if C == cf else torch.from_numpy(arrays[2]).to(tdt).requires_grad_()
    flow_up = torch.from_numpy(arrays[3]).requires_grad_()
    wt, bt = _port(ws, bs)
    for p in wt + bt:
        p.requires_grad_()
    gt = torch.from_numpy(g)
    leaves = [f1, f2] + ([] if feat is f1 else [feat]) + [flow_up]
    if variant == "bf16_a0":
        a0 = rowconv_ad.level_input_plain(f1.detach(), f2.detach(), feat.detach(), flow_up.detach(), search)
        acts = rowconv.conv_chain_strided_plain(a0.to(act), wt, bt, (1,) * 4, EST_RELUS, (0, 1, 2, 3), mode)
        acts[-1] = acts[-1].float()
        df1, df2, dfeat, dflow, dws, dbs = rowconv_ad.flow_level_bwd_plain(
            f1.detach(), f2.detach(), a0.to(act).float(), acts, wt, EST_RELUS, gt, search, cf)
        df1, df2, dfeat = df1.to(tdt), df2.to(tdt), dfeat.to(tdt)
        if feat is f1:
            df1, dfeat = df1 + dfeat, None
        out = acts[-1]
        grads = [df1, df2] + ([] if dfeat is None else [dfeat]) + [dflow, *dws, *dbs]
    else:
        fn = rowconv.flow_level_fused_plain if variant == "autograd" else rowconv_ad.flow_level_fused_ad
        out = fn(f1, f2, feat, flow_up, wt, bt, search, EST_RELUS, mode)
        out.backward(gt)
        grads = [t.grad for t in leaves] + [w.grad for w in wt] + [b.grad for b in bt]
    n = len(ws)
    k = len(grads) - 2 * n
    grads = [*grads[:k], *(w.permute(2, 3, 1, 0) for w in grads[k : k + n]), *grads[k + n :]]
    return [_np(out.detach())], [_np(t.detach()) for t in grads]


def _assert_f32(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = np.abs(b).max()
        assert scale > 0, i
        assert np.abs(a - b).max() <= 1e-4 * scale, (i, np.abs(a - b).max() / scale)


def _bf16_ratio(port, jax_fn, case, variant=None):
    """The worst gradient leaf's gap ratio over seeds 0-2: the port's mean
    gap to the JAX gradient in bf16, summed over the seeds, over JAX's own
    mean gap between bf16 and float32, summed likewise. A leaf that JAX
    computes alike in both modes (the last layer's db: the same cotangent,
    summed in float32) has no bf16 gap to measure against; it is held to
    the float32 criterion instead, and counts as 0 when it passes, inf
    when it fails."""
    gap = ref_gap = None
    worst_f32 = 0.0
    for seed in range(3):
        got = port(case, seed, "bfloat16", variant)[1]
        want = jax_fn(case, seed, "bfloat16")[1]
        want32 = jax_fn(case, seed, "float32")[1]
        g = np.array([np.abs(a - b).mean() for a, b in zip(got, want)])
        r = np.array([np.abs(b - c).mean() for b, c in zip(want, want32)])
        gap, ref_gap = (g, r) if gap is None else (gap + g, ref_gap + r)
        worst_f32 = max([worst_f32] + [np.abs(a - b).max() / np.abs(b).max()
                                       for a, b, c in zip(got, want, want32) if np.array_equal(b, c)])
    if worst_f32 > 1e-4:
        return np.inf
    return max(g / r for g, r in zip(gap, ref_gap) if r > 0)


# ------------------------------------------------------------------- float32


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_forward_and_backward_match_reference_f32(case):
    want_out, want_grads = _chain_jax(case, 0, "float32")
    got_out, got_grads = _chain_port(case, 0, "float32")
    _assert_f32(got_out, want_out)
    _assert_f32(got_grads, want_grads)


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_flow_level_forward_and_backward_match_reference_f32(case):
    want_out, want_grads = _level_jax(case, 0, "float32")
    got_out, got_grads = _level_port(case, 0, "float32")
    _assert_f32(got_out, want_out)
    _assert_f32(got_grads, want_grads)


def test_float32_backward_is_autograd_of_the_plain_forward():
    """In float32 the reference's backward is the plain forward's
    autograd: the two agree within 1e-5 of each gradient's largest."""
    for case in ("pyramid_taps", "k7_5_3_s2_s2_s1_odd_width"):
        _, ours = _chain_port(case, 0, "float32")
        _, auto = _chain_port(case, 0, "float32", "autograd")
        for a, b in zip(ours, auto):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    _, ours = _level_port("search4_proj8", 0, "float32")
    _, auto = _level_port("search4_proj8", 0, "float32", "autograd")
    for a, b in zip(ours, auto):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# ------------------------------------------------------------------ bfloat16


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_bf16_gradients_follow_reference(case):
    assert _bf16_ratio(_chain_port, _chain_jax, case) <= BF16_GAP_RATIO


@pytest.mark.parametrize("case", sorted(LEVEL_CASES))
def test_flow_level_bf16_gradients_follow_reference(case):
    assert _bf16_ratio(_level_port, _level_jax, case) <= BF16_GAP_RATIO


@pytest.mark.parametrize(
    "port, jax_fn, case, variant",
    [
        (_chain_port, _chain_jax, "pyramid_taps", "bf16_weights"),
        (_chain_port, _chain_jax, "pyramid_taps", "autograd"),
        (_level_port, _level_jax, "search4_proj8", "bf16_a0"),
        (_level_port, _level_jax, "search4_proj8", "autograd"),
    ],
    ids=["bf16_rounded_weights", "chain_autograd_of_plain_forward", "level_dw0_from_bf16_input",
         "level_autograd_of_plain_forward"],
)
def test_bf16_criterion_tells_wrong_backwards_apart(port, jax_fn, case, variant):
    """Each backward a port could write by mistake fails the criterion
    the bf16 tests hold the plain versions to."""
    assert _bf16_ratio(port, jax_fn, case, variant) > BF16_GAP_RATIO


# ----------------------------------------------------------------- contract


def test_no_grad_runs_the_serving_path_and_bf16_dot_is_refused():
    """Without autograd the `_ad` functions are the serving wrappers (the
    same values, nothing saved); under autograd bf16_dot raises, as the
    reference's backward has no such mode."""
    x, ws, bs, _ = _chain_inputs("pyramid_taps", 0)
    x = torch.from_numpy(x)
    wt, bt = _port(ws, bs)
    args = ((2, 1) * 3, (True,) * 6, (1, 3, 5))
    for mode in ("float32", "bfloat16", "bf16_dot"):
        want = rowconv.conv_chain_strided(x, wt, bt, *args, mode)
        got = rowconv_ad.conv_chain_strided_ad(x, wt, bt, *args, mode)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="bf16_dot"):
        rowconv_ad.conv_chain_strided_ad(x, [wt[0].requires_grad_(), *wt[1:]], bt, *args, "bf16_dot")
    with torch.no_grad():
        out = rowconv_ad.conv_chain_strided_ad(x, wt, bt, *args, "bf16_dot")
    assert not any(o.requires_grad for o in out)


def test_wgrad_chunks_cover_the_pixels():
    """`wgrad_chunks` / `wgrad_plan`: every output tile (of 64 or 128
    pixels, whose rows hold whole 8-pixel k-steps) in exactly one chunk,
    at most 65535 chunks, the Cout slice 16 wide for Cout <= 16, a block's
    column tiles within its 4 warps' 18 / mt and its stages within the
    shared memory allowed."""
    for tiles, blocks, sms in ((26_624, 3, 132), (12, 1024, 132), (1_000_000, 1, 132), (1, 7, 132), (77, 5, 8)):
        chunks, per = rowconv_ad.wgrad_chunks(tiles, blocks, sms)
        assert (chunks - 1) * per < tiles <= chunks * per and 1 <= chunks <= 65535
    for B, Ho, Wo, cin, cout, k, s, xb in ((16, 64, 208, 3, 16, 3, 2, 2), (12, 4, 13, 512, 512, 3, 1, 2),
                                           (8, 32, 104, 32, 2, 3, 1, 2), (12, 64, 208, 3, 32, 7, 2, 4),
                                           (8, 32, 104, 179, 96, 3, 1, 4), (7, 1, 3, 10, 3, 1, 2, 2),
                                           (8, 64, 208, 32, 64, 3, 2, 4)):
        mt, flat, wn, cpb, tpg, th, tw, chunks, per = rowconv_ad.wgrad_plan(B, Ho, Wo, cin, cout, k, s, 132, None, xb)
        assert th * tw in (64, 128) and tw % 8 == 0 and mt == (1 if cout <= 16 else 2) and flat == (cin in (3, 10))
        assert wn in (1, 2, 4) and flat or (cpb * tpg <= wn * 18 // mt and tpg <= k * k and cpb <= -(-cin // 8)
                                           and (cpb == 1 or rowconv_ad.wgrad_smem(th, tw, k, s, cpb, mt, xb)
                                                <= rowconv_ad.WGRAD_SMEM))
        tiles = B * -(-Ho // th) * -(-Wo // tw)
        assert (chunks - 1) * per < tiles <= chunks * per and 1 <= chunks <= 65535


def test_kernel_side_plumbing_with_the_launches_emulated(monkeypatch):
    """The functions' CUDA branch (saved residuals, the float32 estimator
    input, the order of tap injection, the skipped first dgrad when x
    needs no gradient, dtypes, packed float32 weights, launch counts) run
    on the CPU, each kernel launch emulated by its plain version on the
    same arguments: the plain versions' gradients."""

    def layer(x, w, b, out, stride, relu, act, dot):
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, x.shape[3] - w.shape[1]))
        out.copy_(rowconv._layer_plain(x, w, b, stride, relu, act, dot).to(out.dtype))

    def level_input(f1, f2, feat, flow_up, x, search, a0=None):
        cat = rowconv_ad.level_input_plain(f1, f2, feat, flow_up, search)
        x.zero_()[..., : cat.shape[3]] = cat.to(x.dtype)
        if a0 is not None:
            a0.zero_()[..., : cat.shape[3]] = cat
        assert (a0 is None) == (x.dtype == torch.float32)

    def gate(dy, g, a_out, relu):
        assert dy is None or (dy.dtype == torch.float32 and dy.is_contiguous())
        rowconv_ad.device_launches["conv_layer_gate"] += 1
        dz = rowconv_ad._gate_plain(dy, g, a_out, relu).float()
        return torch.nn.functional.pad(dz, (0, rowconv_ad.padded_cout(dz.shape[3]) - dz.shape[3]))

    def dgrad(dz, w, x_shape, stride, dtype):
        assert dz.dtype == torch.float32 and dz.shape[3] % 8 == 0 and not dz[..., w.shape[0]:].any()
        rowconv_ad.device_launches["conv_layer_dgrad"] += 1
        dz = dz[..., : w.shape[0]]
        return rowconv_ad._dgrad_plain(dz, w, x_shape, stride).to(dtype).contiguous()

    def wgrad(x, dz, w_shape, stride):
        rowconv_ad.device_launches["conv_layer_wgrad"] += 1
        return rowconv_ad._wgrad_plain(x[..., : w_shape[1]], dz[..., : w_shape[0]], w_shape, stride)

    def level_bwd(f1, f2, a0, da0, search, feat_dtype, cf, cu):
        rowconv_ad.device_launches["flow_level_input_bwd"] += 1
        df1, df2, dfeat, dflow = rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0, search, cf, cu)
        return df1.to(f1.dtype), df2.to(f2.dtype), dfeat.to(feat_dtype), dflow

    monkeypatch.setattr(rowconv, "_launch_layer", layer)
    monkeypatch.setattr(rowconv, "_launch_level_input", level_input)
    monkeypatch.setattr(rowconv_ad, "_launch_gate", gate)
    monkeypatch.setattr(rowconv_ad, "_launch_dgrad", dgrad)
    monkeypatch.setattr(rowconv_ad, "_launch_wgrad", wgrad)
    monkeypatch.setattr(rowconv_ad, "_launch_level_input_bwd", level_bwd)

    def grads(fn, on_cuda, inputs, params, g):
        monkeypatch.setattr(rowconv_ad, "_on_cuda", lambda t: on_cuda)
        leaves = [t.detach().clone().requires_grad_(r) for t, r in inputs] + [
            p.detach().clone().requires_grad_() for p in params]
        outs = fn(*leaves)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        torch.autograd.backward([o.float() for o in outs], g)
        return [o.detach() for o in outs], [t.grad for t in leaves]

    rowconv_ad.reset_counts()
    for mode in ("float32", "bfloat16"):
        dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
        x, ws, bs, gs = _chain_inputs("pyramid_taps", 1)
        wt, bt = _port(ws, bs)
        n = len(wt)

        def chain(x, *p):
            return rowconv_ad.conv_chain_strided_ad(x, p[:n], p[n:], (2, 1) * 3, (True,) * 6, (1, 3, 5), mode)

        args = ([(torch.from_numpy(x).to(dt), False)], wt + bt, [torch.from_numpy(g) for g in gs])
        (got, got_g), (want, want_g) = grads(chain, True, *args), grads(chain, False, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert got_g[0] is None and want_g[0] is None  # the image needs no gradient
        for a, b in zip(got_g[1:], want_g[1:]):
            assert a.shape == b.shape and torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))

        x, ws, bs, gs = _chain_inputs("estimator_odd_width", 1)
        wt, bt = _port(ws, bs)

        def nhwc(x, *p):
            return rowconv_ad.conv_chain_nhwc_ad(x, p[:4], p[4:], EST_RELUS, mode)

        args = ([(torch.from_numpy(x).to(dt), True)], wt + bt, [torch.from_numpy(gs[0])])
        (got, got_g), (want, want_g) = grads(nhwc, True, *args), grads(nhwc, False, *args)
        assert got_g[0].dtype == dt
        for a, b in zip(got + got_g, want + want_g):
            assert a.shape == b.shape and torch.allclose(a.float(), b.float(), rtol=0,
                                                         atol=1e-6 * float(b.float().abs().max()))

        arrays, ws, bs, g = _level_inputs("search4_proj8", 1)
        wt, bt = _port(ws, bs)

        def level(f1, f2, feat, flow_up, *p):
            return rowconv_ad.flow_level_fused_ad(f1, f2, feat, flow_up, p[:4], p[4:], 4, EST_RELUS, mode)

        inputs = [(torch.from_numpy(a).to(dt), True) for a in arrays[:3]] + [(torch.from_numpy(arrays[3]), True)]
        args = (inputs, wt + bt, [torch.from_numpy(g)])
        (got, got_g), (want, want_g) = grads(level, True, *args), grads(level, False, *args)
        assert [t.dtype for t in got_g[:4]] == [dt, dt, dt, torch.float32]
        for a, b in zip(got + got_g, want + want_g):
            assert a.shape == b.shape and torch.allclose(a.float(), b.float(), rtol=0,
                                                         atol=1e-6 * float(b.float().abs().max()))
    # Per mode: pyramid 6 layers (5 dgrads: the image needs none), the
    # estimator 4, the level 4 (+ its input kernel and its backward); a
    # gate per wgrad.
    assert rowconv_ad.launches == {"flow_level_fused_ad": 2, "conv_chain_strided_ad": 2, "conv_chain_nhwc_ad": 2}
    assert rowconv_ad.backward_launches == rowconv_ad.launches
    assert rowconv_ad.device_launches == {
        "flow_level_fused_ad": 10, "conv_chain_strided_ad": 12, "conv_chain_nhwc_ad": 8,
        "conv_layer_gate": 28, "conv_layer_dgrad": 26, "conv_layer_wgrad": 28, "flow_level_input_bwd": 2,
    }
