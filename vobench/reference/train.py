"""One training step in plain PyTorch: the training forward (DispNet over
target and sources when geometry consistency is on), the objective,
backward, then Adam as optax composes it (b2 0.999, eps 1e-8, bias
corrections in float32, constant learning rate, no clipping)."""

from __future__ import annotations

import math

import torch

from vobench.reference import losses

SUPPORTED = {"lr_schedule": ("constant",), "grad_clip_norm": (0.0,), "remat": (False, True)}


class Adam:
    def __init__(self, params: list[torch.nn.Parameter], lr: float, b1: float):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, 0.999, 1e-8
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, count: int) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        t = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t)
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g * (1.0 - self.b1))
            v.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            p.add_(-self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))


class TrainStep:
    """step(batch) -> loss; the model and Adam updated in place."""

    def __init__(self, model: torch.nn.Module, train: dict):
        losses.check_supported(train)
        for key, allowed in SUPPORTED.items():
            if train[key] not in allowed:
                raise ValueError(f"the reference's step builds {key} in {allowed}, not {train[key]!r}")
        self.model, self.train = model, train
        self.band = tuple(train["warp_band"]) if train["warp_gather"] == "banded" else None
        self.adam = Adam(list(model.parameters()), train["learning_rate"], train["beta1"])
        self.count = 0

    def __call__(self, batch: dict) -> float:
        source_disp = self.train["geo_consistency_weight"] > 0.0
        out = self.model(batch["target"], batch["sources"], batch["seg"], train=True, source_disp=source_disp)
        loss, _ = losses.total_loss(out, batch, self.train, self.count, self.band)
        for p in self.model.parameters():
            p.grad = None
        loss.backward()
        self.adam.step(self.count)
        self.count += 1
        value = float(loss.detach())
        if not math.isfinite(value):
            raise FloatingPointError(f"reference loss {value} at step {self.count}")
        return value
