#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (davo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, in order; any failure exits non-zero:
  1. environment: card name and power limit, torch/CUDA versions, TF32 flags
  2. build: compile the CUDA kernels from davo_tpu_torch/csrc (nvcc)
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with times and the card's bound
  4. the main path: davo-fast at 128x416 streams a 257-frame synthetic
     world through predict_sequence in 4 requests of 64 pairs, then
     assemble_trajectory and evaluate_sequence; plus one davo forward
  5. the port on the card against the port on the CPU (float32)
  6. davo-fast forward throughput at B=256 (recorded, not claimed)
  7. where the time goes: the steady-state stream, device time per model
     layer and per kernel of the B=256 forward, and the device's busy share
The line before the last names the card; the last line is the result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
COSTVOL_TOL = 1e-5
PORT_TOL = 1e-4


def _event_ms(fn, runs: int) -> float:
    """Median over `runs` CUDA-event-timed calls of `fn` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _costvol_bound_ms(B, H, W, C, search):
    D = (2 * search + 1) ** 2
    bytes_ms = 4.0 * B * H * W * (2 * C + D) / HBM_BYTES_PER_S * 1e3
    flops_ms = 2.0 * B * H * W * D * C / F32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def check_cost_volume(torch, costvol):
    """Phase 3: the kernel against `cost_volume_plain` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        # (label, B, H, W, C, search). The first two are the shapes the
        # main path (phase 4, requests of 64 pairs) gives the kernel.
        ("main path /8", 64, 16, 52, 8, 3),
        ("main path /4", 64, 32, 104, 8, 3),
        ("davo-fast /8", 256, 16, 52, 8, 3),
        ("davo-fast /4", 256, 32, 104, 8, 3),
        ("davo /16", 256, 8, 26, 96, 4),
        ("davo /8", 256, 16, 52, 64, 4),
        ("davo /4", 256, 32, 104, 32, 4),
        ("ragged, odd C", 3, 7, 13, 5, 2),
        ("ragged, unaligned", 2, 9, 26, 8, 3),
    ]
    rows = []
    for label, B, H, W, C, s in cases:
        n = B * H * W * C
        if label == "ragged, unaligned":
            # Contiguous maps that start 4 bytes off a 16-byte boundary:
            # the kernel's scalar path.
            f1 = torch.randn(n + 1, device="cuda", generator=gen)[1:].view(B, H, W, C)
            f2 = torch.randn(n + 1, device="cuda", generator=gen)[1:].view(B, H, W, C)
        else:
            f1 = torch.randn(B, H, W, C, device="cuda", generator=gen)
            f2 = torch.randn(B, H, W, C, device="cuda", generator=gen)
        got = costvol.cost_volume(f1, f2, s)
        torch.cuda.synchronize()
        want = costvol.cost_volume_plain(f1, f2, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = _event_ms(lambda: costvol.cost_volume(f1, f2, s), 30)
        plain_ms = _event_ms(lambda: costvol.cost_volume_plain(f1, f2, s), 20)
        bound_ms, bound_by = _costvol_bound_ms(B, H, W, C, s)
        row = {
            "shape": label, "B": B, "H": H, "W": W, "C": C, "search": s,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
        print(json.dumps({"phase": "costvol", **row}), flush=True)
        if not err <= COSTVOL_TOL:
            raise AssertionError(f"cost volume {label}: max abs err {err} > {COSTVOL_TOL}")
        rows.append(row)

    # The kernel has no backward yet: under autograd it must refuse.
    needs_grad = f1.detach().requires_grad_()
    try:
        costvol.cost_volume(needs_grad, f2, 3)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("cost_volume ran a CUDA tensor that requires grad")

    # The rows layout (B, H*W, C) is the same kernel behind a reshape;
    # timed at the main path's /4 shape.
    B, H, W, C, s = 64, 32, 104, 8, 3
    f1 = torch.randn(B, H * W, C, device="cuda", generator=gen)
    f2 = torch.randn(B, H * W, C, device="cuda", generator=gen)
    got = costvol.cost_volume_rows(f1, f2, H, W, s)
    torch.cuda.synchronize()
    want = costvol.cost_volume_plain(f1.view(B, H, W, C), f2.view(B, H, W, C), s)
    err = float((got - want.view(B, H * W, -1)).abs().max())
    bound_ms, bound_by = _costvol_bound_ms(B, H, W, C, s)
    print(json.dumps({
        "phase": "costvol_rows", "B": B, "H": H, "W": W, "C": C, "search": s,
        "max_abs_err": err,
        "ms": _event_ms(lambda: costvol.cost_volume_rows(f1, f2, H, W, s), 30),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }), flush=True)
    if not err <= COSTVOL_TOL:
        raise AssertionError(f"cost volume rows: max abs err {err} > {COSTVOL_TOL}")
    return rows


def main_path(torch, costvol):
    """Phase 4: davo-fast streaming inference at 128x416, end to end."""
    import numpy as np

    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.eval.runner import (
        assemble_trajectory,
        evaluate_sequence,
        make_pose_apply_fn,
        predict_sequence,
    )
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = presets.get("davo-fast").model
    t0 = time.perf_counter()
    world = SyntheticSequence(n_frames=257, height=cfg.img_height, width=cfg.img_width, seed=0)
    frames = np.stack([world.frame(i) for i in range(len(world))])
    seg = np.stack([world.seg(i) for i in range(len(world))])
    setup_s = time.perf_counter() - t0
    model = DavoModel(cfg, device="cuda", seed=0).eval()
    apply_fn = make_pose_apply_fn(model)

    costvol.launches = 0
    t0 = time.perf_counter()
    rels = predict_sequence(apply_fn, frames, seg=seg, batch_size=64)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = costvol.launches
    traj = assemble_trajectory(rels)
    metrics = evaluate_sequence(traj, world.poses)
    print(json.dumps({
        "phase": "main_path", "preset": "davo-fast", "hw": [cfg.img_height, cfg.img_width],
        "frames": len(frames), "requests": 4, "batch": 64,
        "costvol_launches": launches, "world_setup_s": setup_s, "stream_s": stream_s,
        "trajectory_shape": list(traj.shape), "metrics": metrics,
    }), flush=True)
    if launches != 2 * 4:
        raise AssertionError(f"main path launched the cost volume kernel {launches} times, not 8")
    if traj.shape != (257, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError(f"trajectory {traj.shape} is not a finite (257, 4, 4)")
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    stream = (model, apply_fn, frames, seg)

    # One forward of the paper-parity `davo` preset (cost volumes at /16, /8, /4).
    dcfg = presets.get("davo").model
    davo = DavoModel(dcfg, device="cuda", seed=0).eval()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand(16, dcfg.img_height, dcfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(16, 1, dcfg.img_height, dcfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (16, dcfg.img_height, dcfg.img_width), device="cuda", generator=gen)
    costvol.launches = 0
    with torch.inference_mode():
        poses = davo(x, y, seg=s)["poses"]
    torch.cuda.synchronize()
    davo_launches = costvol.launches
    print(json.dumps({
        "phase": "davo_forward", "batch": 16, "costvol_launches": davo_launches,
        "poses_finite": bool(torch.isfinite(poses).all()),
    }), flush=True)
    if davo_launches != 3 or not torch.isfinite(poses).all() or poses.shape != (16, 1, 6):
        raise AssertionError(f"davo forward: {davo_launches} launches, poses {tuple(poses.shape)}")
    return launches, stream


def gpu_against_cpu(torch, costvol):
    """Phase 5: the same seeded davo-fast-width model (64x128, float32)
    on the card and on the CPU; holds cuDNN, padding and layout."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = presets.with_overrides(
        "davo-fast", img_height=64, img_width=128, compute_dtype="float32"
    ).model
    cpu = DavoModel(cfg, device="cpu", seed=0).eval()
    gpu = DavoModel(cfg, device="cuda", seed=0).eval()
    gen = torch.Generator().manual_seed(2)
    x = torch.rand(4, 64, 128, 3, generator=gen)
    y = torch.rand(4, 1, 64, 128, 3, generator=gen)
    s = torch.randint(0, 19, (4, 64, 128), generator=gen)
    costvol.launches = 0
    with torch.inference_mode():
        want = cpu(x, y, seg=s)["poses"]
        got = gpu(x.cuda(), y.cuda(), seg=s.cuda())["poses"].cpu()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    print(json.dumps({
        "phase": "gpu_vs_cpu", "preset": "davo-fast widths, 64x128, float32",
        "max_rel_err": rel, "largest_pose_component": scale,
        "costvol_launches": costvol.launches,
        "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
    }), flush=True)
    if not (scale > 0 and rel <= PORT_TOL and costvol.launches == 2):
        raise AssertionError(f"GPU vs CPU poses: rel err {rel} > {PORT_TOL} (scale {scale})")


def throughput(torch, card, model):
    """Phase 6: davo-fast forward frames/s at B=256 (host clock around
    synchronised loops; best and median of 5). Returns the inputs."""
    cfg = model.cfg
    B, iters = 256, 10
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(B, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(B, 1, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (B, cfg.img_height, cfg.img_width), device="cuda", generator=gen)
    times = []
    with torch.inference_mode():
        for _ in range(3):
            model(x, y, seg=s)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                poses = model(x, y, seg=s)["poses"]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    if not torch.isfinite(poses).all():
        raise AssertionError("throughput run gave non-finite poses")
    print(json.dumps({
        "phase": "throughput", "preset": "davo-fast", "batch": B, "iters_per_loop": iters,
        "frames_per_s_best": B * iters / min(times),
        "frames_per_s_median": B * iters / statistics.median(times),
        "forward_ms_best": 1e3 * min(times) / iters,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card,
    }), flush=True)
    return x, y, s


def profile(torch, card, stream, inputs):
    """Phase 7: where the davo-fast forward spends its time. Prints the
    steady-state stream (3 passes after the main path's, host clock),
    CUDA-event time of each layer in one B=256 forward (forward hooks;
    nested layers lie inside their parents), and torch.profiler device
    time by kernel over 3 forwards with the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from davo_tpu_torch.eval.runner import predict_sequence

    model, apply_fn, frames, seg = stream
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict_sequence(apply_fn, frames, seg=seg, batch_size=64)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "phase": "profile_stream", "frames": len(frames), "batch": 64, "steady_s": times,
        "frames_per_s_median": (len(frames) - 1) / statistics.median(times), "card": card,
    }), flush=True)

    x, y, s = inputs
    marks: dict[str, list] = {}
    hooks = []
    for name, mod in model.named_modules():
        if not name or name.count(".") > 2:
            continue

        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name][-1][1] = ev

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        model(x, y, seg=s)
        end.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    layers = {"forward": start.elapsed_time(end)}
    layers.update({n: sum(a.elapsed_time(b) for a, b in p) for n, p in marks.items()})
    print(json.dumps({"phase": "profile_layers_ms", "batch": len(x), **layers}), flush=True)

    iters = 3
    with torch.inference_mode():
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x, y, seg=s)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    rows = sorted((  # device kernels only: operator rows repeat their kernels' time
        (e.key, e.self_device_time_total / 1e3 / iters, e.count // iters)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    print(json.dumps({
        "phase": "profile_kernels", "batch": len(x),
        "device_ms_per_forward": device_ms, "wall_ms_per_forward": wall_ms,
        "device_busy_share": device_ms / wall_ms, "card": card,
        "top": [{"kernel": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:25]],
    }), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    from davo_tpu_torch import exact_f32
    from davo_tpu_torch.kernels import costvol, cuda_build

    # Phase 1: environment.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    exact_f32()
    print(json.dumps({
        "phase": "env", "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32},
    }), flush=True)

    # Phase 2: build the kernel library from its source in the checkout.
    t0 = time.perf_counter()
    cuda_build.load("costvol")
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s, "log": cuda_build.BUILD_LOG}), flush=True)

    rows = check_cost_volume(torch, costvol)
    launches, stream = main_path(torch, costvol)
    gpu_against_cpu(torch, costvol)
    inputs = throughput(torch, card, stream[0])
    profile(torch, card, stream, inputs)

    # The kernel's line: times for the work of one main-path request
    # (its two flow levels at B=64), error over every shape checked.
    per_request = [r for r in rows if r["shape"].startswith("main path")]
    print(json.dumps({"kernels": [{
        "name": "cost_volume",
        "route": "cuda",
        "source": "davo_tpu_torch/csrc/costvol.cu",
        "replaces": "davo_tpu/kernels/costvol.py:41",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in per_request),
        "plain_ms": sum(r["plain_ms"] for r in per_request),
        "bound_ms": sum(r["bound_ms"] for r in per_request),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_request) else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
