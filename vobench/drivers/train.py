"""Training: `davo_tpu_torch.train.loop.make_train_step(cfg)(state, batch)`
step after step on batches cycled from a pool of snippets on the card.

The pool is the consecutive 3-frame windows (target frame t, sources t-1
and t+1) of a seeded sequence, in an order drawn from the seed; step i
takes the pool's i-th block of `batch` snippets (so any three
consecutive steps see rows that all differ), the labels of its targets
and KITTI's intrinsics scaled to the frame.

Set-up builds one train state (the program's model with the benchmark's
weights, its Adam state at step 0) and drives it through the window's
own step and feed for `warmup` steps; the first `checked` of them are
the ones the reference follows. The window goes on with the same state.

End-to-end: `train_fps`, snippets trained in the window over its
seconds (the window closes on a synchronise after its last step).

Correctness: the loss of each checked step, the norm of each leaf's
first gradient as Adam got it (its first moment after one step over
1 - beta1) and the norm of each leaf's change over the checked steps,
against the plain reference's on the same weights and batches in
float32: the worst step's loss gap relative to the reference's loss, and
the worst leaf's gap of norms relative to the larger of that leaf's
reference norm and the median leaf's. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone under
Adam and are left out of the change.

Traffic keys: batch, pool_frames, pan_px, warmup, checked, profile_from
and profile_steps (the traced slice, counted in window steps).
"""

from __future__ import annotations

import statistics
import time

import torch

from vobench import data, flops, trace
from vobench.drivers import common
from vobench.harness import Check, Window
from vobench.reference.train import TrainStep

TINY_GRAD = 1e-3  # leaves under this share of the median leaf's first gradient: out of the change


class _ReferenceState:
    """The reference's model and Adam seen as the program's train state
    (model, tx.mu, step): the control runs through the same reading."""

    def __init__(self, step: TrainStep):
        self.model, self.tx, self.step = step.model, step.adam, 0


def _reference_step(ref_step: TrainStep):
    def step(state, batch):
        loss = ref_step(batch)
        state.step += 1
        return state, {"total": torch.tensor(loss)}
    return step


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, trace_on: bool, system: str = "port"):
        self.cell, self.seed, self.device, self.trace_on, self.system = cell, seed, device, trace_on, system
        self.t = cell.traffic
        self.model_cfg = dict(cell.config["model"])  # the reference reads the file alone
        self.train_cfg = dict(cell.config["train"])

    def feed(self, i: int) -> dict:
        """The batch of step i."""
        B = self.t["batch"]
        at = (i * B) % len(self.order)
        idx = self.order[at : at + B]
        f = self.frames
        return {"target": f[idx + 1], "sources": torch.stack([f[idx], f[idx + 2]], 1),
                "seg": self.labels[idx + 1], "K": self.K}

    # -- set-up --------------------------------------------------------------
    def prepare(self) -> None:
        t, mc, dev = self.t, self.model_cfg, self.device
        B = t["batch"]
        if (t["pool_frames"] - 2) % B:
            raise ValueError(f"pool_frames - 2 = {t['pool_frames'] - 2} is not a multiple of the batch {B}")
        self.frames, self.labels = data.make_sequence(
            t["pool_frames"], mc["img_height"], mc["img_width"], mc["num_seg_classes"], self.seed, dev, t["pan_px"])
        self.order = data.permutation(t["pool_frames"] - 2, self.seed, dev)
        self.K = data.intrinsics(mc["img_height"], mc["img_width"], dev).expand(B, 3, 3).contiguous()
        params = common.weights(mc, self.seed, dev, dispnet=True)
        if self.system == "port":
            from davo_tpu_torch.train import loop

            cfg = common.port_config(self.cell.config, batch=B)
            if loop.serving_only_flags_set(cfg.model):
                raise ValueError(loop.SERVING_ONLY_MESSAGE)
            model = common.build_port(cfg, params, dev, dispnet=True)
            self.state = loop.TrainState(model=model, tx=loop.AdamTx(cfg, model.parameters()))
            self.step_fn = loop.make_train_step(cfg, dev)
        else:
            ref = common.build_reference(mc, self.system.split(":")[1], params, dev, dispnet=True)
            ref_step = TrainStep(ref, self.train_cfg)
            self.state = _ReferenceState(ref_step)
            self.step_fn = _reference_step(ref_step)
        del params
        self.readings = self._follow(self.state, self.step_fn, t["warmup"])
        self.sync_baseline = trace.warm_up() if self.trace_on and dev.type == "cuda" else 0

    def _follow(self, state, step_fn, steps: int) -> dict:
        """Drive `state` through `steps` steps of the feed; read the losses
        of the checked steps, each leaf's first gradient and its change
        over the checked steps."""
        checked, b1 = self.t["checked"], self.train_cfg["beta1"]
        names = [n for n, _ in state.model.named_parameters()]
        start = [p.detach().clone() for p in state.model.parameters()]
        losses, grad, change = [], None, None
        for i in range(steps):
            _, metrics = step_fn(state, self.feed(i))
            losses.append(metrics["total"].detach())
            if i == 0:
                grad = torch.stack([m.norm() for m in state.tx.mu]) / (1.0 - b1)
            if i == checked - 1:
                change = torch.stack([(p.detach() - s).norm() for p, s in zip(state.model.parameters(), start)])
                del start
        return {"names": names, "loss": [float(x) for x in losses[:checked]],
                "grad": grad.tolist(), "change": change.tolist()}

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> Window:
        t = self.t
        B = t["batch"]
        p0, pn = t["profile_from"], t["profile_steps"]
        losses, sl = [], None
        steps = slice_steps = 0
        start = time.perf_counter()
        while True:
            if self.trace_on and steps == p0:
                sl = trace.Slice()
                sl.start()
            _, metrics = self.step_fn(self.state, self.feed(t["warmup"] + steps))
            losses.append(metrics["total"].detach())
            steps += 1
            if sl is not None and sl.active:
                slice_steps += 1
            if sl is not None and sl.active and steps == p0 + pn:
                sl.stop()
            if time.perf_counter() - start >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        if sl is not None and sl.active:
            sl.stop()
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        records = {"cell": {"workload": self.cell.workload, "model": self.model_cfg, "train": self.train_cfg,
                            "traffic": t},
                   "window_s": window_s, "units": steps * B, "steps": steps, "slice_units": slice_steps * B,
                   "flops_per_unit": flops.train_snippet_flops(self.model_cfg, self.train_cfg)}
        if sl is not None and sl.t1:
            prof = trace.reduce(sl, steps=min(pn, steps - p0))
            prof["sync_baseline"] = self.sync_baseline
            records["profile"] = prof
            records["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        return Window(attempted=steps, failed=failed, metrics={"train_fps": steps * B / window_s}, records=records)

    # -- the check -----------------------------------------------------------
    def check(self) -> list[Check]:
        """Frees the program's state, then drives the reference from the
        same weights through the checked steps' batches and compares."""
        got = self.readings
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        params = common.weights(self.model_cfg, self.seed, self.device, dispnet=True)
        ref = common.build_reference(self.model_cfg, "float32", params, self.device, dispnet=True)
        del params
        ref_step = TrainStep(ref, self.train_cfg)
        want = self._follow(_ReferenceState(ref_step), _reference_step(ref_step), self.t["checked"])
        if got["names"] != want["names"]:
            by_name = dict(zip(got["names"], zip(got["grad"], got["change"])))
            got = {**got, "grad": [by_name[n][0] for n in want["names"]],
                   "change": [by_name[n][1] for n in want["names"]]}
        loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["loss"], want["loss"]))
        grad_gap = common.norm_gap(got["grad"], want["grad"])
        med = statistics.median(want["grad"])
        moved = [i for i, w in enumerate(want["grad"]) if w >= TINY_GRAD * med]
        change_gap = common.norm_gap([got["change"][i] for i in moved], [want["change"][i] for i in moved])
        lim = self.cell.limits
        return [Check("loss_gap", loss_gap, lim["loss_gap"]), Check("grad_gap", grad_gap, lim["grad_gap"]),
                Check("change_gap", change_gap, lim["change_gap"])]
