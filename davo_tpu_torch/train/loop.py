"""Train state, train step, fit loop and checkpoints (port of
davo_tpu.train.loop).

One step: the training forward (DispNet on top, source disparities when
the geometry term is on), `total_loss`, backward, then Adam as optax
composes it in the reference (`_make_tx`). The model and the optimizer
state are updated in place. Checkpoints are `torch.save` files of model,
optimizer and step beside the run's `config.json`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from davo_tpu_torch import resolve_device
from davo_tpu_torch.config import Config, ModelConfig
from davo_tpu_torch.core import warp as warp_mod
from davo_tpu_torch.models.davo import DavoModel
from davo_tpu_torch.train.losses import total_loss

# What `TrainConfig.warp_gather="auto"` means on the GPU: the banded
# kernel, as the reference's accelerator default.
_AUTO_CUDA_GATHER = "banded"


class AdamTx:
    """`optax.adam(lr, b1=beta1)` (b2 0.999, eps 1e-8), after optax's
    `clip_by_global_norm(grad_clip_norm)` when that is > 0, with a
    constant lr or `cosine_decay_schedule(lr, max_steps, alpha=0.01)`,
    as the reference's `_make_tx` composes them.

    Written out rather than `torch.optim.Adam`, whose bias corrections
    are computed in float64: optax computes 1 - b2**t in float32, where
    0.999 is not exact, and the first updates then differ by ~7e-6
    relative. Every parameter is updated, as in optax: one without a
    gradient counts as a zero gradient."""

    def __init__(self, cfg: Config, params: Iterable[torch.nn.Parameter]):
        t = cfg.train
        if t.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"unknown lr_schedule {t.lr_schedule!r}")
        self.train_cfg = t
        self.b1, self.b2, self.eps = t.beta1, 0.999, 1e-8
        self.params = list(params)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def learning_rate(self, count: int) -> float:
        """The schedule at `count` updates so far (optax reads the count
        before the update)."""
        t = self.train_cfg
        if t.lr_schedule == "constant":
            return t.learning_rate
        frac = min(count, t.max_steps) / t.max_steps
        return t.learning_rate * (0.99 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.01)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, count: int) -> None:
        """One update from the parameters' gradients, `count` updates
        having been applied before it."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.train_cfg.grad_clip_norm > 0.0:
            clip_by_global_norm_(grads, self.train_cfg.grad_clip_norm)
        b1, b2 = self.b1, self.b2
        # optax: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu.
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        # Bias corrections in float32, as optax.
        t = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(updates, -self.learning_rate(count))
        torch._foreach_add_(self.params, updates)

    def state_dict(self) -> dict:
        return {"mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax's rule, in place: g unchanged if the global norm is below
    max_norm, else g / norm * max_norm (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`). Stays on the device."""
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def _make_tx(cfg: Config, params: Iterable[torch.nn.Parameter]) -> AdamTx:
    return AdamTx(cfg, params)


@dataclasses.dataclass
class TrainState:
    model: DavoModel
    tx: AdamTx
    step: int = 0  # updates applied so far


SERVING_ONLY_MESSAGE = (
    "model.fuse_estimator / fuse_flow_level / fuse_pyramid / "
    "fuse_pose_encoder / fuse_attention / fuse_disp_encoder "
    "are serving-only fast paths (pallas_call has no VJP); "
    "train with them false — the *_train variants carry VJPs "
    "and may be enabled for training"
)


def serving_only_flags_set(m: ModelConfig) -> bool:
    """The reference's `cmd_train` test for serving-only fused flags that
    the training forward would reach (RegionAttention, and so its fused
    stack, exists only with attention="flow_seg")."""
    return (
        ((m.fuse_estimator or m.fuse_flow_level or m.fuse_pyramid) and m.attention != "none")
        or m.fuse_pose_encoder
        or m.fuse_disp_encoder
        or (m.fuse_attention and m.attention == "flow_seg")
    )


def create_state(cfg: Config, device: str | torch.device | None = None) -> TrainState:
    """A `davo` model with DispNet, initialised from `cfg.train.seed`, on
    `device` (the GPU unless device="cpu"), with its optimizer at step 0.
    Refuses the serving-only fused flags (ValueError), as the reference's
    `cli train` does."""
    if serving_only_flags_set(cfg.model):
        raise ValueError(SERVING_ONLY_MESSAGE)
    model = DavoModel(cfg.model, device=device, seed=cfg.train.seed, dispnet=True)
    return TrainState(model=model, tx=_make_tx(cfg, model.parameters()))


def _apply_warp_config(cfg: Config, device: torch.device) -> None:
    """Resolve cfg.train.warp_gather into the process-wide default:
    an explicit config beats DAVO_WARP_GATHER, which beats the device's
    auto policy ("banded" on CUDA, "take4" on the CPU)."""
    g = cfg.train.warp_gather
    if g == "auto":
        if "DAVO_WARP_GATHER" in os.environ:
            return  # the environment already set the default at import
        g = _AUTO_CUDA_GATHER if device.type == "cuda" else "take4"
    warp_mod.configure(g, tuple(cfg.train.warp_band))


def _to_device(batch: dict, device: torch.device) -> dict:
    return {
        k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v).to(device)
        for k, v in batch.items()
    }


def make_train_step(cfg: Config, device: str | torch.device | None = None) -> Callable:
    """Returns step(state, batch) -> (state, metrics): one update of
    state.model and state.tx in place, metrics as 0-d tensors on the
    device (reading them waits for the step)."""
    device = resolve_device(device)
    _apply_warp_config(cfg, device)
    source_disp = cfg.train.geo_consistency_weight > 0.0
    use_seg = cfg.model.attention == "flow_seg"
    use_k = cfg.model.pose_head == "geo_hybrid"  # the geometric head reads the camera

    def step(state: TrainState, batch: dict):
        batch = _to_device(batch, device)
        seg = batch.get("seg") if use_seg else None
        K = batch.get("K") if use_k else None

        def forward(target, sources, seg, K):
            return state.model(target, sources, seg=seg, train=True, source_disp=source_disp, K=K)

        if cfg.train.remat:
            # Keep no forward activations; recompute them in the backward.
            outputs = checkpoint(forward, batch["target"], batch["sources"], seg, K, use_reentrant=False)
        else:
            outputs = forward(batch["target"], batch["sources"], seg, K)
        loss, metrics = total_loss(outputs, batch, cfg.model, cfg.train, step=state.step)
        state.tx.zero_grad()
        loss.backward()
        state.tx.step(state.step)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# Checkpoints: model + optimizer + step, one file per saved step.
# ---------------------------------------------------------------------------


def save_config(directory: str, cfg: Config) -> None:
    """The full config as JSON beside the checkpoints."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_config(directory: str) -> dict | None:
    path = os.path.join(directory, "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _checkpoints(directory: str) -> list[tuple[int, Path]]:
    found = []
    for p in Path(directory).glob("ckpt_*.pt"):
        stem = p.stem[len("ckpt_"):]
        if stem.isdigit():
            found.append((int(stem), p))
    return sorted(found)


def save_checkpoint(directory: str, state: TrainState, max_to_keep: int = 3) -> Path:
    """Write `ckpt_<step>.pt` (written whole, then renamed) and keep the
    newest `max_to_keep`."""
    os.makedirs(directory, exist_ok=True)
    path = Path(directory) / f"ckpt_{state.step}.pt"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(
        {"model": state.model.state_dict(), "optimizer": state.tx.state_dict(), "step": state.step},
        tmp,
    )
    os.replace(tmp, path)
    for _, old in _checkpoints(directory)[:-max_to_keep]:
        old.unlink()
    return path


def _load_newest(directory: str, device: torch.device) -> dict | None:
    found = _checkpoints(directory)
    if not found:
        return None
    return torch.load(found[-1][1], map_location=device, weights_only=True)


def restore_checkpoint(directory: str, state: TrainState) -> TrainState | None:
    """Load the newest checkpoint in `directory` into `state` (None if
    there is none)."""
    saved = _load_newest(directory, next(state.model.parameters()).device)
    if saved is None:
        return None
    state.model.load_state_dict(saved["model"])
    state.tx.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def restore_model(cfg: Config, directory: str, device: str | torch.device | None = None) -> DavoModel | None:
    """The newest checkpoint's model in `directory`, for serving: built as
    `create_state` builds it (DispNet included), but with the serving
    flags allowed (they route the forward; the parameters are the same),
    on `device` (the GPU unless device="cpu"), without the optimizer.
    None if there is no checkpoint; a checkpoint whose parameters do not
    match `cfg` raises (a strict load)."""
    device = resolve_device(device)
    saved = _load_newest(directory, device)
    if saved is None:
        return None
    model = DavoModel(cfg.model, device=device, seed=cfg.train.seed, dispnet=True)
    model.load_state_dict(saved["model"])
    return model.eval()


# ---------------------------------------------------------------------------
# Fit loop
# ---------------------------------------------------------------------------


def fit(
    cfg: Config,
    batches: Iterable[dict],
    checkpoint_dir: str | None = None,
    log_fn: Callable[[int, dict], None] | None = None,
    state: TrainState | None = None,
    device: str | torch.device | None = None,
    metrics_logger=None,
) -> tuple[DavoModel, TrainState, list[dict]]:
    """Train for cfg.train.max_steps over `batches` (dicts of numpy
    arrays or tensors) on `device` (the GPU unless device="cpu").
    Returns (model, state, history): a history entry, with steps_per_s,
    every log_every steps and at the last step. With `checkpoint_dir`,
    resumes from its newest checkpoint and saves every checkpoint_every
    steps and at the end. `metrics_logger` (utils.metrics.MetricsLogger)
    gets each history entry and, when cfg.train.image_every > 0, the
    warped-target and disparity panels of the step's batch every
    image_every steps (train/summaries.py)."""
    device = resolve_device(device)
    if state is None:
        state = create_state(cfg, device)
    step_fn = make_train_step(cfg, device)
    summary_fn = None
    if metrics_logger is not None and cfg.train.image_every > 0:
        from davo_tpu_torch.train.summaries import make_summary_fn

        summary_fn = make_summary_fn(state.model, cfg)
    if checkpoint_dir:
        save_config(checkpoint_dir, cfg)
        restore_checkpoint(checkpoint_dir, state)

    history: list[dict] = []
    t0 = time.time()
    it = iter(batches)
    for i in range(cfg.train.max_steps):
        try:
            batch = next(it)
        except StopIteration:
            break
        _, metrics = step_fn(state, batch)
        if (i + 1) % cfg.train.log_every == 0 or i == cfg.train.max_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_s"] = (i + 1) / (time.time() - t0)
            history.append(m)
            if log_fn:
                log_fn(i + 1, m)
            if metrics_logger is not None:
                metrics_logger.log(i + 1, m)
        if summary_fn is not None and (i + 1) % cfg.train.image_every == 0:
            metrics_logger.log_images(i + 1, summary_fn(batch))
        if checkpoint_dir and (i + 1) % cfg.train.checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state.model, state, history
