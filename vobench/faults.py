"""Faults planted underneath a run, to show that the correctness check
catches them: each is a context manager that wraps the program's entry
for the time of a run (the serving closure `eval.runner.
make_pose_apply_fn`, the training step `train.loop.make_train_step`).

    unchanged_state  the training step computes and reports its loss but
                     leaves the model and the optimizer as they were
    half_batch       half of the batch left out: training takes the loss
                     (a mean) over the first half; serving computes the
                     first half's poses and repeats them
    altered_answer   training reports a loss 5 % off; serving returns one
                     pair's pose altered by half of it

A run on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


@contextlib.contextmanager
def _patched(module, name, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _train_step_fault(kind):
    def wrap(make_train_step):
        def make(*args, **kwargs):
            step = make_train_step(*args, **kwargs)

            def faulty(state, batch):
                if kind == "half_batch":
                    half = batch["target"].shape[0] // 2
                    return step(state, {k: v[:half] for k, v in batch.items()})
                if kind == "unchanged_state":
                    saved = [t.detach().clone() for t in list(state.model.parameters()) + state.tx.mu + state.tx.nu]
                    out = step(state, batch)
                    with torch.no_grad():
                        for t, s in zip(list(state.model.parameters()) + state.tx.mu + state.tx.nu, saved):
                            t.copy_(s)
                    state.step -= 1
                    return out
                state, metrics = step(state, batch)
                return state, {**metrics, "total": metrics["total"] * 1.05}
            return faulty
        return make
    return wrap


def _serving_fault(kind):
    def wrap(make_pose_apply_fn):
        def make(*args, **kwargs):
            fn = make_pose_apply_fn(*args, **kwargs)

            def faulty(targets, sources, seg=None):
                if kind == "half_batch":
                    half = targets.shape[0] // 2
                    poses = fn(targets[:half], sources[:half], None if seg is None else seg[:half])
                    return torch.cat([poses, poses[: targets.shape[0] - half]], 0)
                poses = fn(targets, sources, seg).clone()
                poses[0] *= 1.5
                return poses
            return faulty
        return make
    return wrap


@contextlib.contextmanager
def planted(kind: str, cell_kind: str):
    """Plant fault `kind` in the program's entry of a `cell_kind` cell
    ("serve" or "train") for the duration of the block."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; have {FAULTS}")
    if cell_kind == "train":
        from davo_tpu_torch.train import loop

        with _patched(loop, "make_train_step", _train_step_fault(kind)):
            yield
    elif kind == "unchanged_state":
        raise ValueError("a serving cell holds no state that a step updates")
    else:
        from davo_tpu_torch.eval import runner

        with _patched(runner, "make_pose_apply_fn", _serving_fault(kind)):
            yield
