"""davo_tpu_torch — the PyTorch/CUDA port of davo_tpu.

The JAX package `davo_tpu` stays the reference; this package mirrors
its layout and module names and is held against it by the tests in
`tests/test_torch_*.py`. It never imports JAX, Flax or `davo_tpu`.

Layer map (the slices ported so far — streaming pose inference, the
photometric train step, their fused paths, the bench path, and the
trajectory backend):
  config.py, models/presets.py   typed config tree and version presets
  convert.py                     Flax parameter tree -> state_dict
  core/      geometry (pose vectors, SO(3)/SE(3) exp/log, quaternions,
             projection, trajectories), pyramid, SSIM, warps
             (bilinear_sample, projective, flow, separable)
  kernels/   hand-written CUDA kernels (sources in csrc/, five of them):
             cost volume forward/backward, banded warp forward/backward,
             the fused conv chains (rowconv, rowconv_ad) and the one-launch
             conv stack (conv_stack); + plain versions
  models/    FlowNetLite, RegionAttention, PoseNet, DispNet, DavoModel
  train/     losses, train step (optax's Adam), fit loop, checkpoints
             (and `restore_model`, a checkpoint's model for serving)
  eval/      streaming runner, trajectory metrics, TUM IO, depth metrics,
             the C++ KITTI devkit (ctypes, built with g++ at first use)
  ba/        single-host sliding-window bundle adjustment: residuals and
             Jacobians, Schur solve (batched windows too), PCG,
             Gauss-Newton, pose graph, windows, flow tracks
  data/      synthetic sequences, snippet batches, device prefetch, KITTI poses
  bench/     throughput harnesses, speed-of-light counts (H100 peaks), and
             `python -m davo_tpu_torch.bench` (bench.py's JSON line)
  utils/     profiling: `timed`, `profile_trace` (torch.profiler)
  cli/       `python -m davo_tpu_torch.cli.main {train,infer,depth,eval,
             eval-depth,ba,bench} ...`

Tensors are NHWC at every public boundary, as in the JAX package.
Entry points run on the GPU unless the caller passes device="cpu".
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def exact_f32() -> None:
    """Make float32 mean true float32 on the GPU.

    The counterpart of `davo_tpu/__init__.py`'s matmul-precision pin.
    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits), which breaks parity with the reference and the
    geometry's SE(3) chains. The model's hot path opts into speed only
    through `ModelConfig.compute_dtype="bfloat16"`, which this does not
    touch. Called wherever the port builds a model or runs geometry.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the GPU unless asked otherwise.

    With no GPU and no explicit CPU request this raises: the port never
    carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
