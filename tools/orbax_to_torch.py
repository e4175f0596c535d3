"""Convert a checkpoint directory of davo_tpu (the JAX package) into
davo_tpu_torch's checkpoint layout.

davo_tpu's `train --checkpoint-dir` writes an Orbax CheckpointManager
directory (`<step>/` folders of {params, opt_state, step}, beside the
run's `config.json`). This tool restores the newest step (or `--step`)
without a template and writes `ckpt_<step>.pt` as
`davo_tpu_torch.train.loop.save_checkpoint` does:

- params through `davo_tpu_torch.convert` (names kept, conv kernels HWIO
  -> OIHW, dense kernels transposed), loaded strictly into the model the
  run's config builds;
- optax's Adam moments `mu` and `nu` the same way, in the order of the
  model's parameters (`AdamTx`); its `count` must equal the step, which
  the port's optimizer uses for its bias corrections (the clip state and
  a schedule's count carry nothing else);
- `step`; and `config.json` is copied.

The port then serves the run with `infer --ckpt OUT_DIR` and resumes it
with `train --checkpoint-dir OUT_DIR`. Orbax needs JAX, so the tool runs
where JAX is installed, never on the GPU machine; it imports nothing of
davo_tpu.

    python tools/orbax_to_torch.py REF_CKPT_DIR OUT_DIR [--step N]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _flatten_config(node: dict, prefix: str = "") -> dict:
    flat = {}
    for key, value in node.items():
        if isinstance(value, dict):
            flat.update(_flatten_config(value, f"{prefix}{key}."))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


def _adam_state(tree):
    """The dict holding optax's ScaleByAdamState (count, mu, nu) in a
    restored opt_state (a chain's tuple, clip state or not)."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def convert(ref_dir: str, out_dir: str, step: int | None = None) -> Path:
    """Write OUT_DIR/ckpt_<step>.pt and OUT_DIR/config.json; returns the
    checkpoint's path."""
    import orbax.checkpoint as ocp
    import torch

    from davo_tpu_torch.config import Config, apply_overrides
    from davo_tpu_torch.convert import flax_to_state_dict, load_flax_params
    from davo_tpu_torch.models.davo import DavoModel
    from davo_tpu_torch.train.loop import AdamTx, TrainState, save_checkpoint

    ref_dir = os.path.abspath(ref_dir)
    with open(os.path.join(ref_dir, "config.json")) as f:
        cfg = apply_overrides(Config(), _flatten_config(json.load(f)))
    mngr = ocp.CheckpointManager(ref_dir)
    step = mngr.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ref_dir}")
    restored = mngr.restore(step, args=ocp.args.StandardRestore())
    to_np = lambda tree: {k: to_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    model = DavoModel(cfg.model, device="cpu", seed=cfg.train.seed, dispnet=True)
    load_flax_params(model, to_np(restored["params"]))
    adam = _adam_state(restored["opt_state"])
    if adam is None:
        raise ValueError("the checkpoint's opt_state holds no Adam state (count, mu, nu)")
    count, saved_step = int(np.asarray(adam["count"])), int(np.asarray(restored["step"]))
    if count != saved_step:
        raise ValueError(f"Adam count {count} != step {saved_step}: the port's optimizer counts by the step")
    names = [name for name, _ in model.named_parameters()]
    tx = AdamTx(cfg, model.parameters())
    moments = {}
    for key in ("mu", "nu"):
        state, _ = flax_to_state_dict(to_np(adam[key]))
        if sorted(state) != sorted(names):
            raise KeyError(f"Adam {key} does not match the model's parameters")
        moments[key] = [state[n] for n in names]
    tx.load_state_dict(moments)
    os.makedirs(out_dir, exist_ok=True)
    shutil.copyfile(os.path.join(ref_dir, "config.json"), os.path.join(out_dir, "config.json"))
    return save_checkpoint(out_dir, TrainState(model=model, tx=tx, step=saved_step))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ref_dir", help="davo_tpu checkpoint directory (Orbax)")
    p.add_argument("out_dir", help="davo_tpu_torch checkpoint directory to write")
    p.add_argument("--step", type=int, default=None, help="the step to convert (default: newest)")
    args = p.parse_args(argv)
    path = convert(args.ref_dir, args.out_dir, args.step)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
