"""Version-string preset registry.

The reference selects architecture ablations with a stringly-typed
`--version` flag (`<ref>/train.py`, SURVEY.md §5 "Config / flag
system"). Here each version name maps to a full typed Config, keeping
the reference's one-flag ablation workflow without the stringly-typed
plumbing. Names follow the paper's ablation axes (attention source),
not the reference's internal codenames (unverifiable this round —
SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses

from davo_tpu_torch.config import Config, ModelConfig

_REGISTRY: dict[str, Config] = {}


def register(name: str, cfg: Config) -> None:
    _REGISTRY[name] = cfg


def get(name: str) -> Config:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown version '{name}'; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available() -> list[str]:
    return sorted(_REGISTRY)


def _base(**model_kw) -> Config:
    return Config(model=ModelConfig(**model_kw))


# Reference-scale presets (128x416, 3-frame snippets).
register("base", _base(attention="none"))          # plain SfMLearner-style
register("flow", _base(attention="flow"))          # flow cue, no regions
register("davo", _base(attention="flow_seg"))      # full paper model
register(  # ResNet disp encoder (reference's disp_net_res variant)
    "davo-res", _base(attention="flow_seg", disp_encoder="resnet")
)
register(
    # Production-serving config: full attention pipeline with three
    # quality-neutral speed knobs: learned 8-ch correlation projection
    # + search range 3 — the reference's r3 ablation shows they also
    # IMPROVE quality (snippet 0.59 vs 0.78, r_err inversion fixed;
    # attention_ablation_r3.json) — and flow_levels=3, gated quality-neutral at
    # full res (ladder2 res128 L3 37.02 %/0.706 vs L4 37.50 %/0.686,
    # results_r3_quality2.json) and already the davo-small/tiny
    # default.
    "davo-fast",
    _base(
        attention="flow_seg", costvol_feat_channels=8,
        flow_search_range=3, flow_levels=3,
    ),
)
register(
    "davo-small",
    _base(
        attention="flow_seg",
        pose_channels=(16, 32, 64, 128, 128),
        disp_channels=(32, 64, 128, 256, 256),
        flow_levels=3,
    ),
)
# Tiny synthetic-data preset for smoke tests / CI.
register(
    "tiny",
    Config(
        model=ModelConfig(
            img_height=48,
            img_width=64,
            pose_channels=(8, 12, 16),
            disp_channels=(8, 12, 16),
            flow_levels=3,
            flow_search_range=2,
            attention="flow_seg",
            pose_scale=1.0,
            compute_dtype="float32",
        )
    ),
)


def with_overrides(name: str, **kw) -> Config:
    """Preset + dataclasses.replace-style model overrides."""
    cfg = get(name)
    model_kw = {
        k: v for k, v in kw.items() if hasattr(cfg.model, k)
    }
    rest = {k: v for k, v in kw.items() if k not in model_kw}
    if rest:
        raise TypeError(f"unknown override(s): {sorted(rest)}")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model_kw)
    )
