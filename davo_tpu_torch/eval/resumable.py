"""Resumable streaming evaluation with persisted progress cursors (port
of davo_tpu.eval.resumable).

Every completed batch of frame pairs advances a JSON cursor committed
atomically (written to a temporary file, then `os.replace`d), so a
killed evaluation resumes from the last committed batch. A cursor entry
carries a `fingerprint` of the run (the sequence length and an optional
caller-supplied model stamp): resuming with another model or another
sequence resets the entry instead of splicing stale predictions into
the trajectory. The file's layout is the reference's, so either package
reads the other's cursors.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from davo_tpu_torch.core import geometry as geo
from davo_tpu_torch.eval.runner import iter_pair_batches


def params_fingerprint(params) -> str:
    """Cheap, deterministic stamp of a model's parameters (a module, or a
    mapping of tensors or arrays such as its `state_dict`) for
    `resumable_predict_sequence(fingerprint=...)`: the element count and
    a float64 sum of each leaf's absolute values and of every
    (size // 7)-th element, in the mapping's order.

    The reference's stamp of the same weights differs: it walks the Flax
    tree in its own order, with HWIO kernels where the port's are OIHW, so
    it strides over other elements. A stamp only matches stamps of its
    own package; a cursor written without one is readable by either."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError(f"params_fingerprint takes a module or a mapping, not {type(params).__name__}")
    acc = 0.0
    n = 0
    for leaf in params.values():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        a = np.asarray(leaf, np.float64)
        acc += float(np.abs(a).sum()) + float(a.ravel()[:: max(a.size // 7, 1)].sum())
        n += a.size
    return f"p{n}_{acc:.6e}"


class EvalCursor:
    """Atomic per-sequence progress: {seq_id: {next_pair, rel_vecs,
    fingerprint}}."""

    def __init__(self, path: str):
        self.path = path
        self.state: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                self.state = json.load(f)

    def next_pair(self, seq_id: str) -> int:
        return self.state.get(seq_id, {}).get("next_pair", 0)

    def rels(self, seq_id: str) -> list:
        return self.state.get(seq_id, {}).get("rel_vecs", [])

    def validate(self, seq_id: str, fingerprint: str) -> None:
        """Reset the entry if another run (other parameters or another
        sequence length) wrote it."""
        stored = self.state.get(seq_id, {}).get("fingerprint")
        if stored is not None and stored != fingerprint:
            self.state.pop(seq_id, None)

    def commit(self, seq_id: str, next_pair: int, new_rels: np.ndarray, fingerprint: str | None = None):
        entry = self.state.setdefault(seq_id, {"next_pair": 0, "rel_vecs": []})
        entry["rel_vecs"].extend(np.asarray(new_rels).tolist())
        entry["next_pair"] = next_pair
        if fingerprint is not None:
            entry["fingerprint"] = fingerprint
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.path)  # atomic on POSIX

    def done(self, seq_id: str, n_pairs: int) -> bool:
        return self.next_pair(seq_id) >= n_pairs


def resumable_predict_sequence(
    apply_fn,
    frames: np.ndarray,
    cursor: EvalCursor,
    seq_id: str,
    seg: np.ndarray | None = None,
    batch_size: int = 32,
    crash_after_batches: int | None = None,
    fingerprint: str | None = None,
) -> np.ndarray:
    """`runner.predict_sequence`'s (N-1, 4, 4) increments, committing each
    batch's pose vectors to `cursor` and starting at its next pair.

    `fingerprint` (e.g. `params_fingerprint(model)`) joins the sequence
    length in the entry's stamp, so a cursor written by another model or
    for another sequence is discarded, not resumed.
    `crash_after_batches` injects a fault: RuntimeError after committing
    that many batches. Each committed batch is read back to the host (the
    cursor holds host values); the increments are formed on the CPU from
    the cursor's float32 vectors, so a resumed run equals an
    uninterrupted one."""
    n_pairs = len(frames) - 1
    fp = f"n{n_pairs}" + (f"_{fingerprint}" if fingerprint else "")
    cursor.validate(seq_id, fp)
    batches_done = 0
    for start, end, tgt, src, sg in iter_pair_batches(frames, seg, batch_size, cursor.next_pair(seq_id)):
        vec = torch.as_tensor(apply_fn(tgt, src, sg)).float().cpu().numpy()
        cursor.commit(seq_id, end, vec[: end - start], fp)
        batches_done += 1
        if crash_after_batches is not None and batches_done >= crash_after_batches:
            raise RuntimeError("injected fault: process killed mid-eval")
    vecs = torch.from_numpy(np.asarray(cursor.rels(seq_id), np.float32).reshape(-1, 6))
    return geo.pose_vec_to_mat(vecs).numpy()
