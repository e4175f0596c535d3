"""Flax parameter tree <-> the port's state_dict.

The port's modules carry the Flax tree's names (`posenet/encoder/enc0/
Conv_0`, `flownet/estimator1/flow`, `attn/fc0`, ...), so a leaf's path
is its key: `a/b/kernel` -> `a.b.weight`, `a/b/bias` -> `a.b.bias`.
Conv kernels go from HWIO to OIHW, Dense kernels are transposed.

Takes the tree as nested dicts of arrays (anything `numpy.asarray`
accepts); this module imports nothing of JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

# Top-level subtrees that would be reported and skipped, not loaded.
# Every subtree of the `davo` tree (DispNet included) is ported now.
SKIPPED_SUBTREES: tuple[str, ...] = ()


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_to_state_dict(tree: Mapping) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Returns (state_dict, skipped): float32 tensors keyed by the port's
    names, and the '/'-joined paths of the leaves that were skipped."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    for path, leaf in _flatten(tree):
        if path[0] in SKIPPED_SUBTREES:
            skipped.append("/".join(path))
            continue
        arr = np.array(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
            name = "weight"
        elif name != "bias":
            raise KeyError(f"{'/'.join(path)}: unexpected leaf name {name!r}")
        state[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return state, skipped


def load_flax_params(module: nn.Module, tree: Mapping) -> list[str]:
    """Load a Flax parameter tree into `module` (any port module whose
    Flax counterpart produced the tree). Raises on any missing or
    unexpected key and on any shape mismatch; returns the skipped paths."""
    state, skipped = flax_to_state_dict(tree)
    want = module.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(
                f"{key}: shape {tuple(value.shape)} != port's {tuple(want[key].shape)}"
            )
    module.load_state_dict(state)
    return skipped


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of `flax_to_state_dict`: {"params": nested dicts of
    float32 numpy arrays}, conv kernels HWIO, dense kernels (in, out)."""
    tree: dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        arr = value.detach().float().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr, np.float32)
    return {"params": tree}
