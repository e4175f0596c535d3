"""The float32 conv route (`davo_tpu_torch/kernels/conv_f32.py`) on the CPU.

`Conv` in float32 runs `conv_f32.conv_same`: on the card the split-TF32
layer kernel forward and the gate, wgrad and dgrad kernels backward, on
the CPU their plain version. Here, with one thread:

- the plain version, forward and VJP (dx, dW, db), against the
  reference's float32 `flax.linen.Conv` (`lax.conv_general_dilated`) and
  `jax.vjp`, on the same seeded numpy inputs, over k 1/3/5/7, stride 1/2,
  odd and even maps, Cin 2/3/9/35/64 and Cout 1/2/6/32: within 1e-5 of
  the largest element;
- the CUDA branch on CPU tensors with every launch emulated as the
  kernels compute (TF32 hi/lo split, K order, tiles and chunks), on a
  grid of the same kinds, against a float64 convolution: within
  ROWCONV_F32_TOL (1e-5) of the largest element, chip_smoke.py phase
  3d's float32 limit;
- the plans: every float32 `Conv` that `tiny`, `davo`, `davo-fast`,
  `davo-res`, geo_hybrid and SegNetLite build, at 128x416 and at KITTI's
  376x1241, is accepted by `layer_plan`, `dgrad_plan` and `wgrad_plan`;
  the refusals (even k, a kernel whose tile does not fit) raise naming
  the shape; `layer_plan` agrees with the conv stack tests' CPU port of
  `mma_plan` where the 16x16 tile is not picked;
- s2d: a float32 `Conv(s2d=True)` is its SAME stride-2 form, the same
  products as space-to-depth's; bf16 keeps space-to-depth;
- the registered op under `torch.library.opcheck`, and a float32 export
  holding one `davo::conv_same_f32` node per convolution.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from test_torch_conv_stack import _plan
from test_torch_rowconv_bwd import _emulate_dgrad, _emulate_gate, _emulate_wgrad
from test_torch_rowconv_tf32 import _emulate_tf32_layer

import davo_tpu  # noqa: F401  (pins jax_default_matmul_precision="float32")
from davo_tpu_torch.kernels import conv_f32, rowconv, rowconv_ad
from davo_tpu_torch.models import common, presets
from davo_tpu_torch.models.common import Conv, conv_same_stride2_s2d, lecun_init_
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.segnet import SegNetLite

TOL = 1e-5  # chip_smoke.py ROWCONV_F32_TOL


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(seed, B, H, W, cin, cout, k, stride):
    rng = np.random.default_rng(seed)
    ho, wo = -(-H // stride), -(-W // stride)
    x = rng.uniform(-1, 1, (B, H, W, cin)).astype(np.float32)
    w = rng.normal(0, (k * k * cin) ** -0.5, (cout, cin, k, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (cout,)).astype(np.float32)
    dy = rng.normal(size=(B, ho, wo, cout)).astype(np.float32)
    return x, w, b, dy


def _reference(x, w, b, dy, stride):
    """The reference's float32 Conv and its VJP: (y, dx, dW OIHW, db)."""
    k = w.shape[-1]
    conv = fnn.Conv(w.shape[0], (k, k), strides=(stride, stride), padding="SAME", dtype=jnp.float32,
                    param_dtype=jnp.float32)

    def f(x, kernel, bias):
        return conv.apply({"params": {"kernel": kernel, "bias": bias}}, x)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b))
    dx, dk, db = vjp(jnp.asarray(dy))
    return np.asarray(y), np.asarray(dx), np.asarray(dk).transpose(3, 2, 0, 1), np.asarray(db)


def _port(x, w, b, dy, stride):
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = conv_f32.conv_same(xt, wt, bt, stride)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy(), bt.grad.numpy()


def _assert_rel(got, want, tol=TOL):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) <= tol * scale


# ------------------------------------------------------ the plain version vs JAX


@pytest.mark.parametrize("cin", [2, 3, 9, 35, 64])
@pytest.mark.parametrize("k, stride", list(itertools.product((1, 3, 5, 7), (1, 2))))
def test_plain_forward_and_vjp_match_the_reference(k, stride, cin):
    """For odd (9x13) and even (10x14) maps and Cout 1, 2, 6, 32: y, dx,
    dW and db of `conv_same` on CPU tensors (the plain version) against
    the reference Conv and `jax.vjp`, within 1e-5 of the largest."""
    for (H, W), cout in itertools.product(((9, 13), (10, 14)), (1, 2, 6, 32)):
        x, w, b, dy = _case(k * 100 + cin + cout, 2, H, W, cin, cout, k, stride)
        for got, want in zip(_port(x, w, b, dy, stride), _reference(x, w, b, dy, stride)):
            _assert_rel(got, want)


# ------------------------------------------------ the CUDA branch, emulated


@pytest.fixture
def emulated(monkeypatch):
    """`conv_f32`'s CUDA branch on CPU tensors, each launch emulated as
    the kernel computes it, the launch counts kept as on the card."""

    def layer(x, w, b, out, stride, relu, act, dot):
        assert dot == torch.float32 and act == torch.float32 and not relu and x.is_contiguous()
        wp = F.pad(w, (0, 0, 0, 0, 0, x.shape[3] - w.shape[1]))
        out.copy_(_emulate_tf32_layer(x, wp, b, stride, relu, act))

    def gate(dy, g, a_out, relu, counts):
        assert g is None and a_out is None and not relu and dy.dtype == torch.float32 and dy.is_contiguous()
        counts["conv_layer_gate"] += 1
        return _emulate_gate(dy, g, a_out, relu)

    def wgrad(x, dz, w_shape, stride, counts, variants, plan):
        assert plan == conv_f32.plans(*x.shape, w_shape[0], w_shape[-1], stride)["wgrad"]
        counts["conv_layer_wgrad"] += 1
        return _emulate_wgrad(x, dz, w_shape, stride)

    def dgrad(dz, w, x_shape, stride, dtype, counts, variants, plan):
        assert plan == conv_f32.plans(*x_shape, w.shape[0], w.shape[-1], stride)["dgrad"]
        counts["conv_layer_dgrad"] += 1
        return _emulate_dgrad(dz, w, x_shape, stride, dtype)

    monkeypatch.setattr(rowconv, "_launch_layer", layer)
    monkeypatch.setattr(rowconv_ad, "_launch_gate", gate)
    monkeypatch.setattr(rowconv_ad, "_launch_wgrad", wgrad)
    monkeypatch.setattr(rowconv_ad, "_launch_dgrad", dgrad)
    monkeypatch.setattr(conv_f32, "_on_cuda", lambda t: True)
    conv_f32.reset_counts()
    yield
    conv_f32.reset_counts()


def _float64(x, w, b, dy, stride):
    xd, wd, bd, dyd = (torch.from_numpy(a).double() for a in (x, w, b, dy))
    y = common.conv_same_torch(xd, wd, bd, stride)
    dx = rowconv_ad._dgrad_plain(dyd, wd, xd.shape, stride)
    dw, db = rowconv_ad._wgrad_plain(xd, dyd, wd.shape, stride)
    return y.numpy(), dx.numpy(), dw.numpy(), db.numpy()


@pytest.mark.parametrize("cin, cout", [(2, 6), (3, 32), (9, 1), (35, 2), (64, 32)])
@pytest.mark.parametrize("k, stride", [(1, 2), (3, 1), (3, 2), (5, 2), (7, 2)])
def test_emulated_kernels_match_float64(emulated, k, stride, cin, cout):
    """The CUDA branch (the layer kernel forward; gate, wgrad, dgrad
    backward; Cin 35 padded to 36 for the forward) with each launch
    emulated, on an odd 9x11 and an even 8x12 map, against float64:
    within 1e-5 of the largest element; one launch of each kernel a
    call, none of the plain version."""
    for n, (H, W) in enumerate(((9, 11), (8, 12))):
        x, w, b, dy = _case(7 * k + cin + n, 2, H, W, cin, cout, k, stride)
        for got, want in zip(_port(x, w, b, dy, stride), _float64(x, w, b, dy, stride)):
            _assert_rel(got, want)
    assert conv_f32.launches == {"forward": 2, "backward": 2}
    assert conv_f32.device_launches == dict.fromkeys(conv_f32.KERNELS, 2)


def test_emulated_route_drives_a_float32_model(emulated):
    """A float32 `ConvBlock` stack (k 7 stride 2, then 3x3) through
    `Conv`: every conv forward and backward on the emulated kernels,
    equal to the same stack on the plain version within 1e-5."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(common.ConvBlock(3, 16, 7, 2, torch.float32),
                              common.ConvBlock(16, 8, 3, 1, torch.float32))
    lecun_init_(net, torch.Generator().manual_seed(1))
    x = torch.rand(2, 12, 18, 3)
    net(x).square().sum().backward()
    got = [p.grad.clone() for p in net.parameters()]
    # The input needs no gradient: the first layer runs no dgrad.
    assert conv_f32.device_launches == {"conv_layer_tf32": 2, "conv_layer_gate": 2, "conv_layer_wgrad": 2,
                                        "conv_layer_dgrad": 1}
    net.zero_grad()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(conv_f32, "_on_cuda", lambda t: False)
        net(x).square().sum().backward()
    for a, p in zip(got, net.parameters()):
        _assert_rel(a.numpy(), p.grad.double().numpy())


def test_the_cpu_counts_nothing_and_the_wrapper_checks_its_inputs():
    x, w, b, _ = _case(0, 1, 5, 6, 3, 4, 3, 1)
    conv_f32.reset_counts()
    conv_f32.conv_same(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1)
    assert not any(conv_f32.launches.values()) and not any(conv_f32.device_launches.values())
    with pytest.raises(TypeError):
        conv_f32.conv_same(torch.from_numpy(x).double(), torch.from_numpy(w), torch.from_numpy(b), 1)
    with pytest.raises(ValueError):
        conv_f32.conv_same(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b).to("meta"), 1)


# ---------------------------------------------------------------- the plans


def _model_convs(build, H, W, B=1, geo=False, seg_net=False):
    """(B, H, W, Cin, Cout, k, stride) of every Conv call of a float32
    model's training forward at H x W, the convs' arithmetic skipped
    (zero outputs of the right shape)."""
    shapes = set()

    def record(self, x, weight, bias):
        shapes.add((*x.shape, weight.shape[0], self.kernel, self.stride))
        return x.new_zeros(x.shape[0], -(-x.shape[1] // self.stride), -(-x.shape[2] // self.stride),
                           weight.shape[0])

    model = build()
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as m, torch.no_grad():
        m.setattr(Conv, "_conv", record)
        if seg_net:
            model(torch.rand(B, H, W, 3))
        else:
            tgt, src = torch.rand(B, H, W, 3), torch.rand(B, 2, H, W, 3)
            seg = torch.from_numpy(rng.integers(0, 19, (B, H, W)))
            K = torch.tensor([[W / 2.0, 0, W / 2.0], [0, W / 2.0, H / 2.0], [0, 0, 1]]) if geo else None
            model(tgt, src, seg=seg, train=True, source_disp=True, K=K)
    return shapes


MODELS = {
    "tiny": lambda h, w: DavoModel(presets.with_overrides("tiny", img_height=h, img_width=w).model,
                                   device="cpu", seed=0, dispnet=True),
    **{name: (lambda name: lambda h, w: DavoModel(
        presets.with_overrides(name, img_height=h, img_width=w, compute_dtype="float32").model, device="cpu",
        seed=0, dispnet=True))(name) for name in ("davo", "davo-fast", "davo-res")},
    "geo_hybrid": lambda h, w: DavoModel(presets.with_overrides(
        "davo", img_height=h, img_width=w, compute_dtype="float32", pose_head="geo_hybrid").model,
        device="cpu", seed=0, dispnet=True),
    "segnet": lambda h, w: SegNetLite(compute_dtype="float32", device="cpu"),
}


# geo_hybrid runs at 128x416 only: at 376x1241 its flow levels' strides
# do not divide the image, which the reference refuses as the port does.
@pytest.mark.parametrize("name, hw", [(name, hw) for name in sorted(MODELS) for hw in ((128, 416), (376, 1241))
                                      if name != "geo_hybrid" or hw == (128, 416)])
def test_every_float32_conv_of_the_models_has_a_plan(name, hw):
    """Each float32 Conv of the model's training forward (SegNetLite's
    forward) at 128x416 and KITTI's 376x1241 is accepted by the three
    plans at its batch times 1, 4 and 64 on an H100 (132 SMs, 227 KB)."""
    H, W = hw
    shapes = _model_convs(lambda: MODELS[name](H, W), H, W, geo=name == "geo_hybrid", seg_net=name == "segnet")
    assert shapes
    for (B, h, w, cin, cout, k, s), reps in itertools.product(shapes, (1, 4, 64)):
        plans = conv_f32.plans(B * reps, h, w, cin, cout, k, s)
        assert plans["layer"][4] <= rowconv_ad.SMEM_OPTIN


def test_tiny_at_its_own_size_has_plans():
    tiny = presets.get("tiny").model
    for B, h, w, cin, cout, k, s in _model_convs(lambda: MODELS["tiny"](tiny.img_height, tiny.img_width),
                                                 tiny.img_height, tiny.img_width, B=2):
        conv_f32.plans(B, h, w, cin, cout, k, s)


@pytest.mark.parametrize("shape", [(1, 16, 16, 16, 16, 31, 1), (1, 16, 16, 3, 8, 4, 1), (1, 16, 16, 3, 8, 3, 3)])
def test_plans_refuse_what_the_kernels_refuse(shape):
    """A 31x31 kernel (no channel tile fits), an even kernel, stride 3:
    ValueError naming the shape, before any launch."""
    with pytest.raises(ValueError, match=r"k=\d+, stride=\d"):
        conv_f32.plans(*shape)


@pytest.mark.parametrize("shape", [(4, 128, 416, 3, 32, 7, 2), (4, 64, 208, 32, 32, 5, 2), (12, 8, 26, 256, 512, 3, 1),
                                   (2, 9, 11, 83, 37, 5, 1), (2, 12, 20, 15, 8, 7, 1), (4, 5, 7, 512, 1, 3, 1)])
def test_layer_plan_follows_mma_plan(shape):
    """Where the 16x16 tile is not picked (B=1 leaves fewer blocks than
    SMs), `layer_plan` gives the conv stack tests' port of `mma_plan`
    with two halo planes; at the shape's own B it still fits."""
    B, H, W, cin, cout, k, s = shape
    tile_h, tile_w, nt, stages, smem = rowconv_ad.layer_plan(1, H, W, cin, cout, k, s)
    assert (tile_h, tile_w, nt, stages, smem) == _plan(H, W, cin, cout, k, s, rowconv_ad.SMEM_OPTIN, "tf32")
    assert rowconv_ad.layer_plan(B, H, W, cin, cout, k, s)[4] <= rowconv_ad.SMEM_OPTIN


def test_dgrad_plan_narrows_the_channel_tile_where_a_large_kernel_would_not_fit():
    """A 7x7 stride-1 layer: 64 channels a block would stage 330 KB, so
    nt halves until the block fits."""
    nt, wm, th, tw, _ = rowconv_ad.dgrad_plan(4, 64, 208, 32, 32, 7, 1, 132)
    assert rowconv_ad.dgrad_smem(7, 1, nt, wm, th, tw) <= rowconv_ad.SMEM_OPTIN
    assert rowconv_ad.dgrad_smem(7, 1, 2 * nt, wm, th, tw) > rowconv_ad.SMEM_OPTIN


# ----------------------------------------------------------------------- s2d


@pytest.mark.parametrize("k", [3, 7])
def test_float32_s2d_is_the_same_stride2_form(k):
    """Space-to-depth and the SAME stride-2 conv give the same products
    (within 1e-5 of the largest), so a float32 `Conv(s2d=True)` runs the
    SAME stride-2 form: bitwise equal to `Conv(s2d=False)`; bf16 keeps
    space-to-depth."""
    gen = torch.Generator().manual_seed(k)
    plain = lecun_init_(Conv(9, 16, k, 2, torch.float32), gen)
    s2d = Conv(9, 16, k, 2, torch.float32, s2d=True)
    s2d.load_state_dict(plain.state_dict())
    x = torch.rand(2, 16, 20, 9, generator=gen)
    with torch.no_grad():
        got = s2d(x)
        assert torch.equal(got, plain(x))
        _assert_rel(conv_same_stride2_s2d(x, plain.weight, plain.bias, torch.float32).numpy(),
                    got.double().numpy())
    s2d.dtype = torch.bfloat16
    calls = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(common, "conv_same_stride2_s2d", lambda *a: calls.append(a) or torch.zeros(1))
        s2d(x)
    assert len(calls) == 1


# ------------------------------------------------------------ op and export


def test_the_op_passes_opcheck():
    x, w, b, _ = _case(3, 2, 7, 9, 5, 6, 3, 2)
    torch.library.opcheck(torch.ops.davo.conv_same_f32.default,
                          (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 2))


def test_float32_conv_exports_as_one_node_per_call():
    """`torch.export` of a float32 ConvBlock stack keeps one
    davo::conv_same_f32 node per convolution, and the loaded program
    equals the live stack."""
    net = torch.nn.Sequential(common.ConvBlock(3, 8, 7, 2, torch.float32),
                              common.ConvBlock(8, 4, 3, 1, torch.float32))
    lecun_init_(net, torch.Generator().manual_seed(2))
    x = torch.rand(2, 12, 18, 3)
    with torch.no_grad():
        program = torch.export.export(net, (x,))
        want = net(x)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    assert sum(n.target is torch.ops.davo.conv_same_f32.default for n in nodes) == 2
    assert not [n for n in nodes if n.target is torch.ops.aten.convolution.default]
    with torch.no_grad():
        assert torch.equal(program.module()(x), want)


def test_float32_conv_goes_through_the_route_and_bf16_does_not():
    calls = []
    real = conv_f32.conv_same

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    x = torch.rand(1, 6, 8, 4)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(conv_f32, "conv_same", spy)
        lecun_init_(Conv(4, 8, 3, 2, torch.float32), torch.Generator().manual_seed(0))(x)
        lecun_init_(Conv(4, 8, 3, 2, torch.bfloat16), torch.Generator().manual_seed(0))(x)
    assert calls == [2]


def test_remat_sees_an_ordinary_function():
    """`torch.utils.checkpoint` around a float32 Conv recomputes it and
    gives the same gradients as the plain backward."""
    conv = lecun_init_(Conv(5, 6, 3, 1, torch.float32), torch.Generator().manual_seed(3))
    x = torch.rand(2, 7, 9, 5, requires_grad=True)
    torch.utils.checkpoint.checkpoint(conv, x, use_reentrant=False).sum().backward()
    got = x.grad.clone(), conv.weight.grad.clone()
    x.grad = None
    conv.weight.grad = None
    conv(x).sum().backward()
    assert torch.equal(got[0], x.grad) and torch.equal(got[1], conv.weight.grad)
