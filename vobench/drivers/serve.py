"""Serving: offline pose estimation of a recorded sequence held on the card.

One client, closed loop: the batches of consecutive frame pairs of the
sequence (targets frames[1:], sources frames[:-1], the last batch padded
by repeating its last pair, as `eval.runner.iter_pair_batches` forms
them) go in order, over and over, through the program's serving closure
`eval.runner.make_pose_apply_fn(model)`; each batch's poses are read back
to the host before the next is sent.

End-to-end: `serve_fps`, pairs posed in the window (padding not counted)
over its seconds; `serve_batch_ms_p95`, the 95th percentile of the
batches' times from dispatch until their poses are on the host.

Correctness: every batch's poses in the window, and the finest flow
level and the attention weights of batches drawn from the seed (and of
the window's last batch), read by forward hooks on the flow net and the
attention, against the plain reference in float32 on the same weights
and frames.

Traffic keys: batch, frames (the sequence's length), pan_px, warmup
(batches run in set-up), capture (batches drawn for the flow and
attention check, among the first two passes), profile_from and
profile_batches (the traced slice).
"""

from __future__ import annotations

import statistics
import time

import torch

from vobench import data, flops, trace
from vobench.drivers import common
from vobench.harness import Check, Window


class _Hooks:
    """The latest output of the flow net (its finest level) and of the
    attention, and with `timed` CUDA events around the flow net and the
    pose net of every call."""

    def __init__(self, model, timed: bool):
        self.latest: dict = {}
        self.events: dict[str, list] = {"flownet": [], "posenet": []}
        self.handles = [
            model.flownet.register_forward_hook(lambda m, a, out: self.latest.__setitem__("flow", out[0])),
            model.attn.register_forward_hook(lambda m, a, out: self.latest.__setitem__("attn", out)),
        ]
        if timed:
            for name in ("flownet", "posenet"):
                mod = getattr(model, name)
                self.handles.append(mod.register_forward_pre_hook(lambda m, a, name=name: self._mark(name)))
                self.handles.append(mod.register_forward_hook(lambda m, a, o, name=name: self._mark(name)))

    def _mark(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name].append(ev)

    def device_ms(self, name: str) -> list[float]:
        evs = self.events[name]
        return [a.elapsed_time(b) for a, b in zip(evs[0::2], evs[1::2])]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class _ReferenceServing:
    """The plain reference in the program's place (the control): the same
    call signature as the serving closure, the same hook points."""

    def __init__(self, ref):
        self.model = ref

    def __call__(self, targets, sources, seg):
        with torch.no_grad():
            return self.model(targets, sources[:, None], seg)["poses"][:, 0]


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, trace_on: bool, system: str = "port"):
        self.cell, self.seed, self.device, self.trace_on, self.system = cell, seed, device, trace_on, system
        self.t = cell.traffic
        self.model_cfg = dict(cell.config["model"])  # the reference reads the file alone

    # -- set-up --------------------------------------------------------------
    def prepare(self) -> None:
        t, mc, dev = self.t, self.model_cfg, self.device
        params = common.weights(mc, self.seed, dev, dispnet=False)
        if self.system == "port":
            from davo_tpu_torch.eval.runner import make_pose_apply_fn

            model = common.build_port(common.port_config(self.cell.config), params, dev, dispnet=False).eval()
            self.apply_fn = make_pose_apply_fn(model)
        else:
            model = common.build_reference(mc, self.system.split(":")[1], params, dev, dispnet=False)
            self.apply_fn = _ReferenceServing(model)
        del params
        self.model = model
        self.frames, self.labels = data.make_sequence(
            t["frames"], mc["img_height"], mc["img_width"], mc["num_seg_classes"], self.seed, dev, t["pan_px"])
        self.batches = self._pair_batches(t["batch"])
        gen = data.generator(self.seed, data.STREAM_ORDER, "cpu")
        self.capture = set(torch.randperm(2 * len(self.batches), generator=gen)[: t["capture"]].tolist())
        self.hooks = _Hooks(model, self.trace_on and dev.type == "cuda")
        for i in range(t["warmup"]):
            b = self.batches[i % len(self.batches)]
            self.apply_fn(b[0], b[1], b[2]).cpu()
        self.hooks.events = {"flownet": [], "posenet": []}
        self.sync_baseline = trace.warm_up() if self.trace_on and dev.type == "cuda" else 0

    def _pair_batches(self, B: int) -> list[tuple]:
        """(targets, sources, seg, pairs) per batch: views of the sequence,
        the last batch padded by repeating its last pair."""
        n_pairs = len(self.frames) - 1
        tgt, src, seg = self.frames[1:], self.frames[:-1], self.labels[1:]
        out = []
        for start in range(0, n_pairs, B):
            end = min(start + B, n_pairs)
            parts = [tgt[start:end], src[start:end], seg[start:end]]
            if end - start < B:
                parts = [torch.cat([p, p[-1:].expand(B - (end - start), *p.shape[1:])], 0) for p in parts]
            out.append((*parts, end - start))
        return out

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> Window:
        nb = len(self.batches)
        lat, dispatch, self.served, self.captured = [], [], [], {}
        pairs = failed = slice_pairs = 0
        sl = None
        p0, pn = self.t["profile_from"], self.t["profile_batches"]
        i = 0
        start = time.perf_counter()
        while True:
            if self.trace_on and i == p0:
                sl = trace.Slice()
                sl.start()
            tgt, src, seg, n = self.batches[i % nb]
            t0 = time.perf_counter()
            poses = self.apply_fn(tgt, src, seg)
            t_dispatch = time.perf_counter()
            host = poses.cpu()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            dispatch.append(t_dispatch - t0)
            self.served.append(host[:n])
            if not torch.isfinite(host[:n]).all():
                failed += 1
            pairs += n
            if sl is not None and sl.active:
                slice_pairs += n
            if i in self.capture:
                self.captured[i] = (self.hooks.latest["flow"].clone(), self.hooks.latest["attn"].clone())
            if sl is not None and sl.active and i == p0 + pn - 1:
                sl.stop()
            i += 1
            if t1 - start >= seconds:
                break
        window_s = t1 - start
        self.captured[i - 1] = (self.hooks.latest["flow"], self.hooks.latest["attn"])
        if sl is not None and sl.active:
            sl.stop()
        records = {"cell": {"workload": self.cell.workload, "model": self.model_cfg, "traffic": self.t},
                   "window_s": window_s, "units": pairs, "steps": i, "slice_units": slice_pairs,
                   "flops_per_unit": flops.pose_pair_flops(self.model_cfg)}
        if self.trace_on:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
                records["batches"] = {"dispatch_ms": [1e3 * d for d in dispatch],
                                      "flownet_ms": self.hooks.device_ms("flownet"),
                                      "posenet_ms": self.hooks.device_ms("posenet")}
            if sl is not None and sl.t1:
                prof = trace.reduce(sl, steps=min(pn, i - p0))
                prof["sync_baseline"] = self.sync_baseline
                records["profile"] = prof
                records["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        lat_ms = [1e3 * x for x in lat]
        p95 = statistics.quantiles(lat_ms, n=20)[-1] if len(lat_ms) > 1 else lat_ms[0]
        return Window(attempted=i, failed=failed,
                      metrics={"serve_fps": pairs / window_s, "serve_batch_ms_p95": p95}, records=records)

    # -- the check -----------------------------------------------------------
    def check(self) -> list[Check]:
        """Frees the program, then runs the reference on each batch
        position of the sequence once and compares."""
        self.hooks.remove()
        del self.apply_fn, self.model, self.hooks
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        nb = len(self.batches)
        params = common.weights(self.model_cfg, self.seed, self.device, dispnet=False)
        ref = common.build_reference(self.model_cfg, "float32", params, self.device, dispnet=False)
        del params
        want_pos = {i % nb for i in self.captured}
        poses, flows, attns = [], {}, {}
        with torch.no_grad():
            for pos, (tgt, src, seg, n) in enumerate(self.batches):
                out = ref(tgt, src[:, None], seg)
                poses.append(out["poses"][:n, 0].cpu())
                if pos in want_pos:
                    flows[pos], attns[pos] = out["flows"][0][0], out["attn"][:, 0]
        pose_scale = max(float(p.abs().max()) for p in poses)
        pose_gap = max(common.rel_gap(got, poses[i % nb], pose_scale) for i, got in enumerate(self.served))
        flow_gap = attn_gap = 0.0
        for i, (flow, attn) in self.captured.items():
            pos = i % nb
            flow_gap = max(flow_gap, common.rel_gap(flow, flows[pos], float(flows[pos].abs().max())))
            attn_gap = max(attn_gap, common.rel_gap(attn, attns[pos], float(attns[pos].abs().max())))
        lim = self.cell.limits
        return [Check("pose_gap", pose_gap, lim["pose_gap"]), Check("flow_gap", flow_gap, lim["flow_gap"]),
                Check("attn_gap", attn_gap, lim["attn_gap"])]
