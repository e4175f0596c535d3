"""Whole-model bf16 beyond `tiny`: the `davo-fast` forward at 128x416 in
bfloat16, the port against the reference (CPU).

Rounding flips make a bit-for-bit match impossible past the first
layers, so the criterion is chip_smoke.py's for the bf16 chains: for
each of 4 seeds (parameters and inputs), the port's mean gap to the
reference's bf16 output must be at most half the reference's own mean
gap between its bf16 and float32 outputs. A port that rounded elsewhere,
or ran in float32, would sit near 1. Both run as in use: the reference
under `jax.jit`, the port eagerly.

The flow net's levels (thousands of elements each) meet it at every
seed (0.09-0.29). The poses do not: B=2 pairs give 12 numbers a seed,
and at 128x416 the pose map is (1, 4) (`enc6` is (2, 1, 4, 256) a
source), so each pose number is the mean of 4 bf16-rounded head outputs.
They read 0.55 over the 4 seeds (0.50, 0.43, 0.58, 0.87 each), held as
a strict expected failure. The tests below locate it, stage by stage,
with the reference's intermediates (`capture_intermediates`, jitted) and
forward hooks on the port's modules:
- on the reference's own bf16 flow pyramid, the attention weights and
  `enc0`-`enc2` sit at 0.00 of their gap and the poses at 0.34: the
  flow net's level gaps, which meet the criterion, carry half of the
  0.55;
- each encoder layer given the reference's bf16 input differs from the
  reference's output in at most 1.4e-4 of its elements, and the head
  given the reference's head input is bitwise the reference's;
- a correctly rounded bf16 layer (float64 sums, one rounding, the bias
  added in bf16), chained from the reference's `enc0`, lands as far
  from the reference at `enc6` as the port does: seven stride-2 layers
  with deep contractions amplify per-layer flips of 1e-4 until 4 values
  are averaged, whichever rounding is right;
- `full_res_flow`, the direction plane and concatenation, and
  `region_weight_map` (label counts, where the reference pools a
  one-hot) agree with the reference's within one float32 ulp of the
  largest element (XLA's CPU code fuses a multiply and an add that
  PyTorch rounds apart); where the map is resized, the resize's own
  short-axis rounding (a held difference) adds up to 4 ulps.
Each seed's reference and port outputs are made once, shared by the
tests of this module.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models import attention as jattention
from davo_tpu.models import presets as jpresets
from davo_tpu.models.davo import DavoModel as JDavoModel
from davo_tpu.models.flownet import FlowNetLite as JFlowNetLite
from davo_tpu.models.posenet import PoseEncoder as JPoseEncoder
from davo_tpu.models.posenet import PoseHead as JPoseHead
from davo_tpu_torch.convert import load_flax_params
from davo_tpu_torch.kernels.resize import resize_bilinear
from davo_tpu_torch.models import presets
from davo_tpu_torch.models.attention import region_weight_map
from davo_tpu_torch.models.common import conv_same_torch
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.models.flownet import FlowNetLite

GAP_RATIO = 0.5  # chip_smoke.py ROWCONV_GAP_RATIO
STAGE_RATIO = 0.01  # attention and enc0-enc2 on the reference's flows (measured 0.00)
LAYER_FLIPS = 1e-3  # chip_smoke.py's per-layer bf16 criterion: share of elements not bitwise equal
CONTROL_SLACK = 1.5  # the port against the correctly rounded control at enc6
SEEDS = range(4)
J32 = jpresets.with_overrides("davo-fast", compute_dtype="float32").model
J16 = dataclasses.replace(J32, compute_dtype="bfloat16")
PORT16 = presets.with_overrides("davo-fast", compute_dtype="bfloat16").model
H, W = J32.img_height, J32.img_width
DEPTH = len(J32.pose_channels)
_CACHE: dict = {}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _captured(cfg):
    """The jitted forward with its intermediates: the pose encoder's
    blocks, the attention weights and the flow pyramid, and the inputs of
    the pose encoder and the pose head."""
    keep = (JFlowNetLite, JPoseEncoder, JPoseHead, jattention.RegionAttention)

    def run(p, t, s, g):
        seen = {}

        def inputs(next_fun, args, kwargs, context):
            if context.method_name == "__call__" and isinstance(context.module, (JPoseEncoder, JPoseHead)):
                seen[type(context.module).__name__] = args[0]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(inputs):
            out, state = JDavoModel(cfg).apply(
                p, t, s, seg=g, train=False, mutable=["intermediates"],
                capture_intermediates=lambda m, name: name == "__call__" and (
                    isinstance(m, keep) or (m.name or "").startswith("enc")))
        return out, state["intermediates"], seen

    return jax.jit(run)


@pytest.fixture(scope="module")
def reference():
    def outputs(cfg):
        return jax.jit(lambda p, t, s, g: JDavoModel(cfg).apply(p, t, s, seg=g, train=False))

    init = jax.jit(lambda k, t, s, g: JDavoModel(J32).init(k, t, s, seg=g, train=False))
    return init, outputs(J16), outputs(J32), _captured(J16), _captured(J32)


def _stages(inter):
    """The captured intermediates by the port's module names."""
    enc = inter["posenet"]["encoder"]
    got = {f"posenet.encoder.enc{i}": enc[f"enc{i}"]["__call__"][0] for i in range(DEPTH)}
    got["attn"] = inter["attn"]["__call__"][0]
    got["flows"] = inter["flownet"]["__call__"][0]
    got["posenet.head"] = inter["posenet"]["head"]["__call__"][0]
    return got


def _port_stages(model, inputs, flows=None):
    """The port's bf16 forward with each stage read by forward hooks (and
    the pose encoder's and head's inputs); `flows` replaces the flow net's
    output."""
    got, hooks = {}, []
    names = [f"posenet.encoder.enc{i}" for i in range(DEPTH)] + ["attn", "posenet.head"]
    modules = dict(model.named_modules())
    for name in names:
        hooks.append(modules[name].register_forward_hook(
            lambda m, a, out, name=name: got.__setitem__(name, out)))
    for name in ("posenet.encoder", "posenet.head"):
        hooks.append(modules[name].register_forward_pre_hook(
            lambda m, a, name=name: got.__setitem__(name + ".input", a[0])))
    if flows is not None:
        hooks.append(model.flownet.register_forward_hook(
            lambda m, a, out: [torch.from_numpy(np.array(f)) for f in flows]))
    try:
        with torch.no_grad():
            got["out"] = model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    return got


def _run(reference, seed):
    """One seed's outputs, made once: the inputs, the port model, the port
    as run and on the reference's flows, and the reference in bf16 and
    float32, as run and with its intermediates."""
    if seed in _CACHE:
        return _CACHE[seed]
    init, apply16, apply32, capture16, capture32 = reference
    rng = np.random.default_rng(50 + seed)
    target = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    sources = rng.uniform(size=(2, 1, H, W, 3)).astype(np.float32)
    seg = rng.integers(0, J32.num_seg_classes, size=(2, H, W)).astype(np.int32)
    args = (jnp.asarray(target), jnp.asarray(sources), jnp.asarray(seg))
    params = init(jax.random.key(seed), *args)
    model = DavoModel(PORT16, device="cpu")
    load_flax_params(model, params)
    inputs = (torch.from_numpy(target), torch.from_numpy(sources), torch.from_numpy(seg))
    _, inter16, seen16 = capture16(params, *args)
    _, inter32, _ = capture32(params, *args)
    ref16, ref32 = _stages(inter16), _stages(inter32)
    ref16["posenet.encoder.input"] = seen16["PoseEncoder"]
    ref16["posenet.head.input"] = seen16["PoseHead"]
    as_run = _port_stages(model, inputs)
    _CACHE[seed] = dict(
        got=as_run["out"], want16=apply16(params, *args), want32=apply32(params, *args), model=model,
        ref16=ref16, ref32=ref32, as_run=as_run, on_ref_flows=_port_stages(model, inputs, flows=ref16["flows"]))
    return _CACHE[seed]


def _f32(a):
    return np.array(a.float().numpy() if torch.is_tensor(a) else a, np.float32)


def _gaps(got, want16, want32):
    """(the port's mean gap to the reference's bf16, the reference's own
    mean bf16-to-float32 gap)."""
    got, want16, want32 = _f32(got), _f32(want16), _f32(want32)
    return np.abs(got - want16).mean(), np.abs(want16 - want32).mean()


def _ratio(got, want16, want32):
    """The port's mean gap to the reference's bf16 over the reference's
    own mean bf16-to-float32 gap."""
    gap, reference_gap = _gaps(got, want16, want32)
    assert reference_gap > 0
    return gap / reference_gap


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3, held: the poses' pooled gap is 0.55 of the reference's bf16-to-float32 gap (0.50, 0.43, "
    "0.58, 0.87 a seed): 12 numbers a seed, each the mean of 4 bf16 head outputs of a (1, 4) map. Located: on "
    "the reference's flows the path reads 0.34 (attention and enc0-enc2 0.00), each layer flips at most 1e-4 "
    "of its outputs, and a correctly rounded chain lands as far at enc6; seven stride-2 bf16 layers amplify "
    "the flow net's level gaps (which meet the criterion) and those flips"))
def test_davo_fast_bf16_poses_follow_reference_rounding(reference):
    """Over the 4 seeds, the port's mean pose gap to the reference's bf16
    at most half the reference's own bf16-to-float32 gap."""
    gaps, reference_gaps = [], []
    for seed in SEEDS:
        r = _run(reference, seed)
        gap, reference_gap = _gaps(r["got"]["poses"], r["want16"]["poses"], r["want32"]["poses"])
        gaps.append(gap)
        reference_gaps.append(reference_gap)
    print("pose gap ratio by seed", [round(float(g / r), 3) for g, r in zip(gaps, reference_gaps)])
    assert sum(gaps) <= GAP_RATIO * sum(reference_gaps)


@pytest.mark.parametrize("seed", SEEDS)
def test_davo_fast_bf16_flows_follow_reference_rounding(reference, seed):
    """The flow net's every pyramid level at davo-fast's depth (each
    thousands of elements): the gap criterion holds per level."""
    r = _run(reference, seed)
    for g, w16, w32 in zip(r["got"]["flows"][0], r["want16"]["flows"][0], r["want32"]["flows"][0]):
        assert _ratio(g, w16, w32) <= GAP_RATIO


def test_pose_path_on_the_reference_flows(reference):
    """The port's flow-net output replaced by the reference's bf16
    pyramid: the attention weights and enc0-enc2 at most 0.01 of their
    gap, the poses at most 0.5, each pooled over the seeds; printed beside
    the same stages as run."""
    names = ["attn"] + [f"posenet.encoder.enc{i}" for i in range(DEPTH)] + ["posenet.head"]
    pooled = {run: {n: [0.0, 0.0] for n in names} for run in ("as_run", "on_ref_flows")}
    for seed in SEEDS:
        r = _run(reference, seed)
        for run, table in pooled.items():
            for n in names:
                gap, reference_gap = _gaps(r[run][n], r["ref16"][n], r["ref32"][n])
                table[n][0] += gap
                table[n][1] += reference_gap
    ratios = {run: {n: float(g / rg) for n, (g, rg) in table.items()} for run, table in pooled.items()}
    print("pooled gap ratio by stage:", {run: {n: round(v, 3) for n, v in t.items()} for run, t in ratios.items()})
    on_ref = ratios["on_ref_flows"]
    assert max(on_ref[n] for n in ["attn"] + [f"posenet.encoder.enc{i}" for i in range(3)]) <= STAGE_RATIO
    assert on_ref["posenet.head"] <= GAP_RATIO


def _not_equal_share(got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.mean(got != want))


@pytest.mark.parametrize("seed", SEEDS)
def test_each_pose_layer_on_the_reference_input(reference, seed):
    """enc1-enc6 each given the reference's bf16 input: at most 1e-3 of the
    outputs not bitwise equal; the head given the reference's head input:
    bitwise."""
    r = _run(reference, seed)
    encoder, ref16 = r["model"].posenet.encoder, r["ref16"]
    shares = {}
    with torch.no_grad():
        for i in range(1, DEPTH):
            x = torch.from_numpy(_f32(ref16[f"posenet.encoder.enc{i - 1}"])).bfloat16()
            shares[f"enc{i}"] = _not_equal_share(getattr(encoder, f"enc{i}")(x), ref16[f"posenet.encoder.enc{i}"])
        head_in = torch.from_numpy(_f32(ref16["posenet.head.input"])).bfloat16()
        head = r["model"].posenet.head(head_in)
    print(f"seed {seed}: share of outputs not bitwise equal on the reference's input {shares}")
    assert max(shares.values()) <= LAYER_FLIPS
    np.testing.assert_array_equal(_f32(head), _f32(ref16["posenet.head"]))


def _rounded_once(block, x):
    """A correctly rounded bf16 ConvBlock: bf16 operands, products and sums
    in float64 rounded once to bf16, then the bias added in bf16 and ReLU."""
    conv = block.Conv_0
    w, b = conv.weight.detach().bfloat16(), conv.bias.detach().bfloat16()
    y = conv_same_torch(x.double(), w.double(), torch.zeros(w.shape[0], dtype=torch.float64), conv.stride)
    return torch.relu(y.bfloat16() + b)


def test_correctly_rounded_chain_lands_as_far_from_the_reference(reference):
    """enc1-enc6 chained from the reference's enc0, by the port's layers and
    by a correctly rounded control: at enc6 the port is no further from
    the reference's bf16 than 1.5x the control (pooled over the seeds)."""
    sums = {"port": np.zeros(DEPTH), "control": np.zeros(DEPTH)}
    reference_gaps = np.zeros(DEPTH)
    for seed in SEEDS:
        r = _run(reference, seed)
        encoder, ref16, ref32 = r["model"].posenet.encoder, r["ref16"], r["ref32"]
        port = control = torch.from_numpy(_f32(ref16["posenet.encoder.enc0"])).bfloat16()
        with torch.no_grad():
            for i in range(1, DEPTH):
                block, name = getattr(encoder, f"enc{i}"), f"posenet.encoder.enc{i}"
                port, control = block(port), _rounded_once(block, control)
                for key, x in (("port", port), ("control", control)):
                    sums[key][i] += _gaps(x, ref16[name], ref32[name])[0]
                reference_gaps[i] += _gaps(port, ref16[name], ref32[name])[1]
    ratios = {k: [round(float(v), 3) for v in s[1:] / reference_gaps[1:]] for k, s in sums.items()}
    print(f"chained from the reference's enc0, gap ratio at enc1-enc6: {ratios}")
    assert sums["port"][-1] <= CONTROL_SLACK * sums["control"][-1]


def _ulps(got, want):
    """max |got - want| in float32 ulps of want's largest element: at most 1
    is agreement at float32's last place (XLA's CPU code contracts a
    product and a sum into one fused multiply-add, PyTorch rounds both)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got.astype(np.float64) - want).max() / np.spacing(np.abs(want).max()))


@pytest.mark.parametrize("seed", SEEDS)
def test_flow_cue_and_encoder_input_match_the_reference(reference, seed):
    """`full_res_flow` of the reference's finest bf16 flow, and the pose
    encoder's input on the reference's flows ([target, source, direction
    plane, full-resolution flow]): within one float32 ulp of the largest
    element of the reference's, the images and the direction plane
    bitwise."""
    r = _run(reference, seed)
    finest = np.array(r["ref16"]["flows"][0])
    want = jax.jit(JFlowNetLite.full_res_flow, static_argnums=(1, 2))(jnp.asarray(finest), H, W)
    got = FlowNetLite.full_res_flow(torch.from_numpy(finest), H, W)
    got_in, want_in = _f32(r["on_ref_flows"]["posenet.encoder.input"]), _f32(r["ref16"]["posenet.encoder.input"])
    ulps = {"full_res_flow": _ulps(got.numpy(), want), "encoder input": _ulps(got_in, want_in)}
    print(f"seed {seed}: ulps of the largest element {ulps}")
    np.testing.assert_array_equal(got_in[..., :7], want_in[..., :7])
    assert max(ulps.values()) <= 1


@pytest.mark.parametrize("full, hw", [((H, W), (1, 4)), ((64, 128), (1, 1)), ((376, 1241), (3, 10))],
                         ids=["davo_fast_128x416", "phase9_64x128", "kitti_376x1241_resized"])
def test_region_weight_map_matches_the_reference(reference, full, hw):
    """The port's label counts against the reference's pooled one-hot, at
    the pose map of 128x416 (the model's (1, 4)) and of 64x128: within one
    float32 ulp of the largest element, on the reference's attention
    weights. At 376x1241 the (3, 10) map does not divide the frame, and
    both form the map at full resolution and resize it: there the port
    is held within an ulp of its own resize of the reference's
    full-resolution map, and within the resize's short-axis bound of the
    reference (one ulp of the largest sample position, of the largest
    element: ROADMAP "Not faults", `tests/test_torch_resize.py`)."""
    r = _run(reference, 0)
    weights = np.array(r["ref16"]["attn"], np.float32)
    seg = np.random.default_rng(hw[1]).integers(0, J32.num_seg_classes, size=(weights.shape[0], *full))

    def reference_map(size):
        return np.array(jax.jit(lambda w, s: jattention.region_weight_map(
            w, jattention.seg_to_onehot(s, J32.num_seg_classes), size))(weights, seg.astype(np.int32)))

    want = reference_map(hw)
    got = region_weight_map(torch.from_numpy(weights), torch.from_numpy(seg), J32.num_seg_classes, hw).numpy()
    if full[0] % hw[0] == 0 and full[1] % hw[1] == 0:
        ulps = _ulps(got, want)
        print(f"{full} -> {hw}: {ulps} ulps of the largest element")
        assert ulps <= 1
        return
    own = resize_bilinear(torch.from_numpy(reference_map(full)), *hw).numpy()
    bound = np.spacing(np.float32(max(full))) * np.abs(want).max()
    gap = float(np.abs(got - want).max())
    print(f"{full} -> {hw}: {_ulps(got, own)} ulps of the port's resize of the reference's full-resolution map; "
          f"{_ulps(got, want)} ulps ({gap:.3e}) of the reference's, bound {bound:.3e}")
    assert _ulps(got, own) <= 1
    assert gap <= bound
