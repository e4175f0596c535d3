"""What the drivers share: the program's configuration built from a
configuration file, weights from the seed for the program and for the
reference, and the gap measures of the correctness check."""

from __future__ import annotations

import dataclasses

import torch

from vobench import data
from vobench.reference.model import DavoModel as ReferenceModel
from vobench.reference.ops import Precision


def port_config(config: dict, batch: int | None = None):
    """The program's Config: the configuration's preset with its model
    (and train) settings; each setting the file states is checked against
    the Config as built, so the file is the configuration as run."""
    from davo_tpu_torch.models import presets

    cfg = presets.with_overrides(config["preset"], **config["model"])
    if "train" in config:
        train = dataclasses.replace(cfg.train, **{k: tuple(v) if isinstance(v, list) else v
                                                 for k, v in config["train"].items()})
        cfg = dataclasses.replace(cfg, train=train if batch is None else dataclasses.replace(train, batch_size=batch))
    for part in ("model", "train"):
        for key, want in config.get(part, {}).items():
            got = getattr(getattr(cfg, part), key)
            if (list(got) if isinstance(got, tuple) else got) != want:
                raise ValueError(f"{config['name']}: {part}.{key} is {got!r} as built, the file says {want!r}")
    return cfg


def param_shapes(model_cfg: dict, dispnet: bool) -> dict[str, tuple[int, ...]]:
    """Parameter names and shapes, read from the reference built on the
    meta device."""
    with torch.device("meta"):
        ref = ReferenceModel(model_cfg, Precision("float32"), dispnet=dispnet)
    return {k: tuple(v.shape) for k, v in ref.state_dict().items()}


def build_port(cfg, params: dict, device, dispnet: bool):
    """The program's DavoModel on `device`, with `params` loaded (its own
    initialisation skipped: built on the meta device, then allocated)."""
    from davo_tpu_torch.models.davo import DavoModel

    model = DavoModel(cfg.model, device="meta", dispnet=dispnet)
    model.to_empty(device=device)
    model.load_state_dict(params, strict=True)
    return model


def build_reference(model_cfg: dict, precision: str, params: dict, device, dispnet: bool):
    ref = ReferenceModel(model_cfg, Precision(precision), dispnet=dispnet).to(device)
    ref.load_state_dict(params, strict=True)
    return ref


def weights(model_cfg: dict, seed: int, device, dispnet: bool) -> dict[str, torch.Tensor]:
    return data.make_params(param_shapes(model_cfg, dispnet), seed, device)


def rel_gap(got: torch.Tensor, want: torch.Tensor, scale: float) -> float:
    """The largest absolute difference over `scale` (the reference's
    largest magnitude); infinite where the shapes differ."""
    if got.shape != want.shape:
        return float("inf")
    return float((got.float() - want.float()).abs().max()) / scale


def norm_gap(got: list[float], want: list[float]) -> float:
    """The worst leaf's gap of norms, |got - want|, over the larger of
    that leaf's reference norm and the median leaf's."""
    med = sorted(want)[len(want) // 2]
    return max(abs(g - w) / max(w, med) for g, w in zip(got, want))
