#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (davo_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one GPU
    python3 chip_smoke.py --against OTHER/davo_tpu_torch/csrc
        # only another checkout's kernels against this one's, timed in
        # turns on the main paths' shapes: the cost-volume forward and
        # backward, the banded forward, the fused serving kernels
        # (rowconv.cu: phase 3d's units in every mode, then
        # flow_level_input per serving request and per fused train step),
        # the training backward (rowconv_bwd.cu: per fused unit, and
        # flow_level_input_bwd at the B=4 and B=64 steps' levels) and the
        # conv stack (conv_stack.cu, the pose prefix at B=64 and 256, bf16
        # and float32, each mode's weights as that source reads them)

Phases, in order; any failure exits non-zero:
  1. environment: card name and power limit, torch/CUDA versions, TF32 flags
  2. build: compile the CUDA kernels from davo_tpu_torch/csrc (one nvcc
     per source, all started together); SASS HMMA/FFMA counts per kernel
     of rowconv.cu, rowconv_bwd.cu and conv_stack.cu (HMMA and no FFMA
     asserted in the split-TF32 layer kernels and in both of the stack's
     kernels, whose registers and spills are printed)
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it, with times, the card's bound and, for
     the banded warp, F.grid_sample as the library yardstick: the cost
     volume on float32 and bf16 maps at one serving request's levels,
     one davo train step's levels at S*B=8 and 128, B=256 forwards, and
     odd frames, unaligned maps and searches 7 and 12; (3b) the
     cost-volume backward also at S*B=128 and on an odd frame (11x29,
     C=20), and at searches 1, 2, 3, 7, 8, 12 and 20 (shift rows in
     passes from 8 on), float32 and bf16 maps, (3c) the banded forward
     and backward at B=64 (C=3 and C=1 128x416, the backward with
     d/dimg) and on two edge frames (37x61, 5x7), and the forward on the
     coordinates of a davo train step at B=64 and B=4, beside
     grid_sample; (3d) the
     fused serving kernels at one fused request's shapes in bf16, f32 and
     bf16_dot, with the port's unfused route (bf16, or float32 with TF32
     off) as the yardstick, and each bf16 and f32 layer alone beside its
     bound and one cuDNN convolution in its dtype, and the float32 layer
     on 8 more shape classes (odd dims, k=1, bf16 in or out, Cin 2-512,
     Cout not a multiple of 8); then the flow level's
     input kernel alone at the serving levels and the davo train levels
     (S*B = 8 and 128, with and without a0) beside its bytes bound and
     the unfused route (cost volume, ReLU, concatenation, cast), and at
     searches 1, 2, 5, 7, 12, 43 (the tile kernel's run-time-search
     instance), 44 and 64 (the element kernel), each naming the kernel
     that ran;
     (3e) the
     training chains' backward kernels against their plain backwards at
     one fused davo train step's shapes, bf16 and f32, with the port's
     unfused route backward in the same dtype as the yardstick (device
     time, and host-included time beside it), then layer by layer (gate,
     wgrad, dgrad against float64 sums, two runs bitwise equal, beside one
     cuDNN float32 and bf16 call each) and the flow levels' input
     backward, one layer each on 21 other shapes, and the input backward
     at searches 1, 9, 20 and 64 (shift rows in passes); (3f) the conv stack (one
     launch per stack on the tensor cores: bf16, and float32 in split
     TF32, a kernel each) on the davo-fast pose prefix at B=64 and B=256
     through the bench package's speed-of-light run, then against its
     plain version and the strided chain, bf16 and f32 (each beside the
     unfused route in its dtype; float32 beside its bound at 3 TF32
     passes), and on the JAX tests' shapes and odd dims, with each
     launch's grid and per-layer plan, and each pose layer alone as a
     one-layer stack at B=64 beside #7's layer
  4. the serving path: davo-fast at 128x416 streams a 257-frame synthetic
     world through predict_sequence in 4 requests of 64 pairs, then
     assemble_trajectory and evaluate_sequence; plus one davo forward;
     (4b) the same stream on the fused serving path (fuse_pyramid,
     fuse_flow_level, fuse_attention, fuse_pose_encoder) and `cli infer`
     with those flags; (4c) one fuse_estimator forward
  5. the port on the card against the port on the CPU (float32); (5b)
     the same for the fused serving path (64x208), whose float32 layers
     run the split-TF32 kernels
  6. davo-fast forward throughput at B=256 (recorded, not claimed)
  7. where the time goes: the steady-state stream, device time per model
     layer and per kernel of the B=256 forward, and the device's busy
     share; (6b) fused against unfused forward frames/s at B=64 and
     B=256, and the fused B=64 forward's device time by kernel
  8. the train path: davo at 128x416, B=4, synthetic worlds, 5 steps
     through train.loop.fit; launch counts per step, finite loss terms,
     every parameter changed, no plain version run; (8b) the same on the
     fused training path (the five fuse_*_train flags), then `cli train`
     with those flags for 2 steps; (8c) 2 fuse_estimator_train steps
  9. one train step on the card against the port on the CPU (davo
     widths, 64x128, float32): loss terms and every gradient leaf; (9b)
     the same on the fused training path
 10. train-step time at B=4 and B=64, peak memory, and device time by
     kernel of one B=64 step; (10b) the same on the fused training path
 11. the bench entry point: `python -m davo_tpu_torch.bench` (bench.py's
     JSON line, davo-fast at B=256) beside phase 6, and one
     bench_train_step (davo, B=16)
 12. the trajectory backend through the CLI (davo 128x416, the CLI's
     synthetic worlds, a temporary directory, no plain version run):
     train 2 steps to a checkpoint, infer --ckpt (--tum), depth, eval
     --devkit, eval-depth, ba --ckpt; cost-volume launches per command,
     served poses against the checkpoint restored in memory, TUM round
     trip; then ba on the world's exact flow from a perturbed GT
     trajectory, card and --device cpu: each window's cost not raised,
     the GT error reduced, the CPU within 1e-4; ba_refine ms per window,
     the flow-net calls' ms, host syncs per window
 13. the options the earlier slices refused (`options_path`): davo-res
     through `cli train` and `cli depth`, its train step against the CPU
     and its B=4 step time against davo's; davo with the geometric pose
     head (pose_head=geo_hybrid) through `cli train` and `cli infer
     --ckpt` (with and without the serving flags), card against CPU
     (forward and train step), frames/s and host syncs against the conv
     head; davo-fast with s2d_first_conv against the plain first conv,
     and that conv alone; `cli infer --scan-chunks 4` and the 257-frame
     world through one scan call against 4 per-call requests; a
     resumable evaluation crashed and resumed; davo at 120x400 (the
     non-integer resize) card against CPU
 14. real data (`data_path`): a KITTI odometry root of two DriveSequence
     worlds at KITTI's 376x1241 (8 frames each, label maps, calib, times,
     poses), `prep --dataset kitti_odom` in its own process (4 host-only
     workers), `train-seg` and `prep --write-seg` on the card; the Python
     reader and the native loader equal item for item, batches/s of each
     at B=4 and B=64; `train --version davo --data <prepared> --loader
     native --log-dir --set train.image_every=2`, 5 steps (launches per
     step and per image summary, metrics.jsonl, panels, median step ms,
     the prefetch host share beside phase 8's); one train step card
     against CPU on a prepared batch; `train` from the KITTI root and
     `infer --data <root> --ckpt`; SegNet's labels card against CPU, its
     step ms and labels/s
The line before the last names the card; the last line is the result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
COSTVOL_TOL = 1e-5
PORT_TOL = 1e-4
# Banded warp: the forward and d/du, d/dv sum the same terms in the same
# order as the plain versions, so they differ by fma contraction only;
# d/dimg sums each source pixel's terms exactly in fixed point and rounds
# once (bitwise reproducible, checked), where the plain version rounds
# each float32 add. 1e-5 absolute for the forward (values in [0, 1]),
# 1e-5 of the largest gradient for the backward.
BANDWARP_TOL = 1e-5
BAND = (4, 16)
TRAIN_LOSS_TOL = 1e-4   # train step, card against CPU: loss terms, relative
TRAIN_GRAD_TOL = 1e-3   # each gradient leaf, relative to its largest element
KERNEL_SOURCES = ("costvol", "bandwarp", "rowconv", "rowconv_bwd", "conv_stack")  # davo_tpu_torch/csrc/<name>.cu


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


def _graph_ms(fn, reps: int = 20) -> float:
    """Device ms of one `fn()`: `reps` calls captured in a CUDA graph,
    replayed 5 times between CUDA events (median). Unlike `_event_ms`,
    no host time of the Python wrapper falls between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _costvol_bound_ms(B, H, W, C, search, elem=4):
    """Each map read once at its element size, the float32 volume written
    once; the FMAs at the float32 rate."""
    D = (2 * search + 1) ** 2
    bytes_ms = B * H * W * (2.0 * C * elem + 4.0 * D) / HBM_BYTES_PER_S * 1e3
    flops_ms = 2.0 * B * H * W * D * C / F32_FLOPS * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


# Phase 3's shapes, (label, B, H, W, C, search), each in float32 and
# bfloat16 (the presets' compute dtype, which the main paths give the
# kernel). "main path": one request of the serving path (phase 4, 64
# pairs); "train": `davo`'s three levels of one train step at S*B = 8
# and 128 (B = 4 and 64, two sources), as phase 3b; then B=256 forwards,
# and shapes for the kernel's other paths: a frame smaller than its tile
# with odd C (plain loads), maps 4 bytes off a 16-byte boundary (plain
# loads), and searches beyond the presets' (the generic instantiation:
# dx in chunks of 8; at s=12 the tile shrinks to one row, 800 threads).
COSTVOL_SHAPES = [
    ("main path /8", 64, 16, 52, 8, 3),
    ("main path /4", 64, 32, 104, 8, 3),
    *[(f"train S*B={B} {label}", B, H, W, C, 4) for B in (8, 128)
      for label, H, W, C in (("/16", 8, 26, 96), ("/8", 16, 52, 64), ("/4", 32, 104, 32))],
    ("davo-fast /8", 256, 16, 52, 8, 3),
    ("davo-fast /4", 256, 32, 104, 8, 3),
    ("davo /16", 256, 8, 26, 96, 4),
    ("davo /8", 256, 16, 52, 64, 4),
    ("davo /4", 256, 32, 104, 32, 4),
    ("ragged, odd C", 3, 7, 13, 5, 2),
    ("ragged, unaligned", 2, 9, 26, 8, 3),
    ("search 7", 2, 11, 29, 12, 7),
    ("search 12", 1, 5, 40, 8, 12),
]


def check_cost_volume(torch, costvol):
    """Phase 3: the kernel against `cost_volume_plain` on the card, at
    COSTVOL_SHAPES in float32 and bfloat16 maps."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, B, H, W, C, s in COSTVOL_SHAPES:
            n = B * H * W * C
            if label == "ragged, unaligned":
                # Contiguous maps that start 4 bytes off a 16-byte boundary.
                k = 32 // torch.finfo(dtype).bits  # elements in 4 bytes
                f1 = torch.randn(n + k, device="cuda", generator=gen).to(dtype)[k:].view(B, H, W, C)
                f2 = torch.randn(n + k, device="cuda", generator=gen).to(dtype)[k:].view(B, H, W, C)
                if f1.data_ptr() % 16 != 4 or f2.data_ptr() % 16 != 4:
                    raise AssertionError(f"unaligned case at offsets {f1.data_ptr() % 16}, {f2.data_ptr() % 16}")
            else:
                f1 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
                f2 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
            got = costvol.cost_volume(f1, f2, s)
            torch.cuda.synchronize()
            want = costvol.cost_volume_plain(f1, f2, s)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if got.dtype != torch.float32 or got.shape != (B, H, W, (2 * s + 1) ** 2):
                raise AssertionError(f"cost volume {label}: {got.dtype} {tuple(got.shape)}")
            ms = _event_ms(lambda: costvol.cost_volume(f1, f2, s), 30)
            device_ms = _graph_ms(lambda: costvol.cost_volume(f1, f2, s))
            plain_ms = _event_ms(lambda: costvol.cost_volume_plain(f1, f2, s), 5 if B == 256 else 20)
            bound_ms, bound_by = _costvol_bound_ms(B, H, W, C, s, f1.element_size())
            row = {
                "shape": label, "dtype": str(dtype).split(".")[-1], "B": B, "H": H, "W": W, "C": C,
                "search": s, "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            }
            print(json.dumps({"phase": "costvol", **row}), flush=True)
            if not err <= COSTVOL_TOL:
                raise AssertionError(f"cost volume {label} {dtype}: max abs err {err} > {COSTVOL_TOL}")
            rows.append(row)

    # The largest search whose smallest (1x4) tile fits a block's shared
    # memory, and the first the wrapper refuses, saying why.
    for dtype in (torch.float32, torch.bfloat16):
        f1 = torch.randn(1, 3, 5, 8, device="cuda", generator=gen).to(dtype)
        f2 = torch.randn(1, 3, 5, 8, device="cuda", generator=gen).to(dtype)
        err = float((costvol.cost_volume(f1, f2, 43) - costvol.cost_volume_plain(f1, f2, 43)).abs().max())
        try:
            costvol.cost_volume(f1, f2, 44)
            refused = None
        except ValueError as e:
            refused = str(e)
        print(json.dumps({"phase": "costvol_limit", "dtype": str(dtype).split(".")[-1], "search": 43,
                          "max_abs_err": err, "search_44_refused": refused}), flush=True)
        if not err <= COSTVOL_TOL or refused is None or "shared memory" not in refused:
            raise AssertionError(f"cost volume search limit {dtype}: err {err}, refusal {refused!r}")

    # The rows layout (B, H*W, C) is the same kernel behind a reshape;
    # timed at the main path's /4 shape, in the presets' bf16.
    B, H, W, C, s = 64, 32, 104, 8, 3
    f1 = torch.randn(B, H * W, C, device="cuda", generator=gen).bfloat16()
    f2 = torch.randn(B, H * W, C, device="cuda", generator=gen).bfloat16()
    got = costvol.cost_volume_rows(f1, f2, H, W, s)
    torch.cuda.synchronize()
    want = costvol.cost_volume_plain(f1.view(B, H, W, C), f2.view(B, H, W, C), s)
    err = float((got - want.view(B, H * W, -1)).abs().max())
    bound_ms, bound_by = _costvol_bound_ms(B, H, W, C, s, 2)
    print(json.dumps({
        "phase": "costvol_rows", "dtype": "bfloat16", "B": B, "H": H, "W": W, "C": C, "search": s,
        "max_abs_err": err,
        "ms": _event_ms(lambda: costvol.cost_volume_rows(f1, f2, H, W, s), 30),
        "device_ms": _graph_ms(lambda: costvol.cost_volume_rows(f1, f2, H, W, s)),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }), flush=True)
    if not err <= COSTVOL_TOL:
        raise AssertionError(f"cost volume rows: max abs err {err} > {COSTVOL_TOL}")
    return rows


def _build_other(src):
    """A ctypes library built from another checkout's source `src`."""
    import ctypes
    import hashlib

    from davo_tpu_torch.kernels import cuda_build

    src = Path(src).resolve()
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib_path = cuda_build.BUILD_DIR / f"lib{src.stem}-other-{digest.hexdigest()[:16]}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"building {src}: {proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib_path))


def _kernel_name(demangled):
    """A demangled kernel's name and template arguments, without its
    return type, namespace and parameters: `conv_dgrad_mma_kernel<8>`."""
    import re

    name = re.sub(r"\((?:int|bool)\)", "", demangled.removeprefix("void "))
    name = name.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def _sass_counts(library):
    """{kernel: {"HMMA": n, "FFMA": n}} of a built library's SASS
    (`cuobjdump -sass`): the tensor-core and float32 FMA instructions of
    each kernel, by template instance."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if filt:
                demangled = subprocess.run([filt, name], capture_output=True, text=True, timeout=60).stdout.strip()
                name = _kernel_name(demangled) if demangled else name
            counts[name] = {"HMMA": 0, "FFMA": 0}
        elif name is not None:
            for op in ("HMMA", "FFMA"):
                if f" {op}" in line:
                    counts[name][op] += 1
    return counts


def _ptxas_resources(log, fragment):
    """[{"kernel", "registers", "spill_stores", "spill_loads"}] of each
    entry function whose mangled name holds `fragment`, from a build's
    `ptxas -v` report (cuda_build.BUILD_LOG)."""
    import re

    found, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = {"kernel": m.group(1)} if fragment in m.group(1) else None
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            found.append(entry)
            entry = None
    return found


def _turns(fns, reps=20):
    """Device ms of each callable in `fns` ({"other": f, "this": g}),
    timed in turns: other, this, this, other."""
    times = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        times[name].append(_graph_ms(fns[name], reps))
    return times


def _with_library(module, lib, fn, **attrs):
    """`fn` as a callable that runs with `module._library()` giving `lib`
    (another checkout's build of the module's source, bound alike) and
    the module's other attributes in `attrs` replaced."""
    attrs["_library"] = lambda: lib

    def call():
        saved = {name: getattr(module, name) for name in attrs}
        for name, value in attrs.items():
            setattr(module, name, value)
        try:
            return fn()
        finally:
            for name, value in saved.items():
                setattr(module, name, value)
    return call


def _bind_other_rowconv(torch, lib):
    """(`lib`, another checkout's rowconv.cu build, bound; the attributes
    of `kernels.rowconv` its layers need). This checkout's entry points
    that the build has are bound alike (before PR 12 it lacks
    `davo_flow_level_input_last`, which `--against` does not call); a
    build before PR 11, whose float32 layers run the FMA kernel
    `davo_conv_layer` on (k, k, Cin, Cout) float32 weights, also gets that
    entry and a `_launch_layer` that packs for it."""
    import ctypes

    import torch.nn.functional as F

    from davo_tpu_torch.kernels import rowconv
    from davo_tpu_torch.models.common import same_pads

    P, I = ctypes.c_void_p, ctypes.c_int
    signatures = {k: v for k, v in rowconv.SIGNATURES.items() if hasattr(lib, k)}
    tf32 = "davo_conv_layer_tf32" in signatures
    if not tf32:
        signatures["davo_conv_layer"] = [P, I, P, P, P, I] + [I] * 14 + [P]
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, I
    lib.davo_cuda_error_string.argtypes, lib.davo_cuda_error_string.restype = [I], ctypes.c_char_p
    if tf32:
        return lib, {}
    launch, packed = rowconv._launch_layer, {}

    def layer(x, w, b, out, stride, relu, act, dot):
        if dot == torch.bfloat16:
            return launch(x, w, b, out, stride, relu, act, dot)
        B, H, W, cin = x.shape
        _, Ho, Wo, cout = out.shape
        k = w.shape[-1]
        key = (w.data_ptr(), tuple(w.shape), cin)
        if key not in packed:
            packed[key] = (F.pad(w.detach(), (0, 0, 0, 0, 0, cin - w.shape[1])).permute(2, 3, 1, 0).contiguous(),
                           b.detach().float().contiguous())
        wp, bias = packed[key]
        err = lib.davo_conv_layer(x.data_ptr(), int(x.dtype == torch.bfloat16), wp.data_ptr(), bias.data_ptr(),
                                  out.data_ptr(), int(out.dtype == torch.bfloat16), B, H, W, cin, Ho, Wo, cout, k,
                                  stride, same_pads(H, k, stride)[0], same_pads(W, k, stride)[0], 0,
                                  int(act == torch.bfloat16), int(bool(relu)), torch.cuda.current_stream().cuda_stream)
        if err:
            raise AssertionError(f"other float32 conv layer: launch failed ({err})")

    return lib, {"_launch_layer": layer}


def compare_against(torch, other_csrc):
    """`--against OTHER/davo_tpu_torch/csrc`: the kernels built from
    another checkout's sources against this checkout's, on the same card
    in turns (other, this, this, other), each held to this checkout's
    plain version first: the cost-volume forward (costvol.cu, through its
    float32 entry; bf16 maps cast to float32 first, as that checkout's
    model did) at phase 3's main-path shapes in both dtypes; the banded
    forward (bandwarp.cu) per B=4 train step on random coordinates, at
    B=64 128x416 on random ones, and per B=4 and B=64 step on the
    coordinates of a `davo` train step; the fused serving kernels
    (rowconv.cu, the other build behind this checkout's wrappers) in phase
    3d's units, bf16, float32 and bf16_dot; the training backward
    (rowconv_bwd.cu, likewise) per unit of phase 3e and
    `flow_level_input_bwd` alone at the fused B=4 and B=64 steps' levels;
    the conv stack (conv_stack.cu: 13 ints a layer, each mode's weights
    as that source reads them, `_stack_weight_layouts`) on the pose
    prefix at B=64 and 256, bf16 and float32.
    rowconv.cu and rowconv_bwd.cu must have this checkout's C entry points
    (the parent's do, but rowconv.cu's `davo_flow_level_input_last`,
    which no comparison calls)."""
    import ctypes

    from davo_tpu_torch.kernels import bandwarp, costvol, rowconv

    other_csrc = Path(other_csrc)
    names = [n for n in KERNEL_SOURCES if (other_csrc / f"{n}.cu").exists()]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        libs = dict(zip(names, pool.map(lambda n: _build_other(other_csrc / f"{n}.cu"), names)))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device="cuda").manual_seed(7)

    if "costvol" in libs:
        other = libs["costvol"].davo_cost_volume_f32
        other.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        other.restype = ctypes.c_int

        def other_call(f1, f2, s):
            f1, f2 = f1.float(), f2.float()
            B, H, W, C = f1.shape
            out = torch.empty(B, H, W, (2 * s + 1) ** 2, device="cuda")
            if other(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, H, W, C, s, stream()):
                raise AssertionError("other cost volume: launch failed")
            return out

        for dtype in (torch.bfloat16, torch.float32):
            for label, B, H, W, C, s in COSTVOL_SHAPES:
                if not label.startswith(("main path", "train", "davo")):
                    continue
                f1 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
                f2 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
                want = costvol.cost_volume_plain(f1, f2, s)
                errs = [float((fn(f1, f2, s) - want).abs().max()) for fn in (other_call, costvol.cost_volume)]
                if not max(errs) <= COSTVOL_TOL:
                    raise AssertionError(f"cost volume {label} {dtype}: errors (other, this) {errs}")
                times = _turns({"other": lambda: other_call(f1, f2, s), "this": lambda: costvol.cost_volume(f1, f2, s)})
                bound_ms, bound_by = _costvol_bound_ms(B, H, W, C, s, f1.element_size())
                print(json.dumps({
                    "phase": "costvol_against", "other": str(other_csrc), "shape": label,
                    "dtype": str(dtype).split(".")[-1], "B": B, "H": H, "W": W, "C": C, "search": s,
                    "max_abs_err": errs, "other_ms": times["other"], "this_ms": times["this"],
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }), flush=True)

        other_bwd = libs["costvol"].davo_cost_volume_bwd_f32
        other_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        other_bwd.restype = ctypes.c_int

        def other_bwd_call(f1, f2, g, s):
            df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
            if other_bwd(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), df1.data_ptr(), df2.data_ptr(), *f1.shape, s,
                         stream()):
                raise AssertionError("other cost volume backward: launch failed")
            return df1, df2

        for B, label, H, W, C in COSTVOL_BWD_SHAPES:
            if not label.startswith("davo"):
                continue
            f1, f2 = (torch.randn(B, H, W, C, device="cuda", generator=gen) for _ in range(2))
            g = torch.randn(B, H, W, 81, device="cuda", generator=gen)
            fns = {"other": lambda: other_bwd_call(f1, f2, g, 4),
                   "this": lambda: costvol._launch_bwd(f1, f2, g, 4, True, True)}
            got = {name: fn() for name, fn in fns.items()}
            want = costvol.cost_volume_plain_bwd(f1, f2, g, 4)
            errs = {name: max(float((a - b).abs().max()) for a, b in zip(v, want)) for name, v in got.items()}
            bitwise = all(torch.equal(a, b) for a, b in zip(got["other"], got["this"]))
            if not (bitwise and max(errs.values()) <= COSTVOL_TOL):
                raise AssertionError(f"cost volume backward {label} B={B}: errors {errs}, bitwise {bitwise}")
            times = _turns(fns)
            print(json.dumps({
                "phase": "costvol_bwd_against", "other": str(other_csrc), "shape": label, "B": B, "H": H, "W": W,
                "C": C, "search": 4, "max_abs_err": errs, "bitwise_equal": bitwise, "other_ms": times["other"],
                "this_ms": times["this"],
            }), flush=True)
            del f1, f2, g, got, want

    if "bandwarp" in libs:
        other = libs["bandwarp"].davo_banded_warp_f32
        other.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        other.restype = ctypes.c_int
        rv, rh = BAND

        def other_warp(img, coords):
            out = torch.empty_like(img)
            if other(img.data_ptr(), coords.data_ptr(), out.data_ptr(), *img.shape, rv, rh, stream()):
                raise AssertionError("other banded warp: launch failed")
            return out

        # (sum it adds to or None, coordinates, img, coords, launches per step)
        cases = [("B=4 step", "random", torch.rand(4, H, W, C, device="cuda", generator=gen),
                  _band_coords(torch, gen, 4, H, W), per_step)
                 for (C, H, W, _), per_step in TRAIN_WARPS.items()]
        cases += [(None, "random", torch.rand(64, 128, 416, C, device="cuda", generator=gen),
                   _band_coords(torch, gen, 64, 128, 416), 0) for C in (3, 1)]
        step_inputs = _step_warp_inputs(torch, bandwarp)
        cases += [(f"B={B} step", "davo train step", img[:B].contiguous(), coords[:B].contiguous(), 1)
                  for B in (4, 64) for img, coords in step_inputs]
        sums = {}
        for group, pattern, img, coords, per_step in cases:
            B, H, W, C = img.shape
            want = bandwarp.banded_warp_plain_fwd(img, coords, rv, rh)
            errs = [float((fn(img, coords) - want).abs().max())
                    for fn in (other_warp, lambda i, c: bandwarp._launch_fwd(i, c, rv, rh))]
            del want
            if not max(errs) <= BANDWARP_TOL:
                raise AssertionError(f"banded warp B={B} C={C} {H}x{W} {pattern}: errors (other, this) {errs}")
            times = _turns({"other": lambda: other_warp(img, coords),
                            "this": lambda: bandwarp._launch_fwd(img, coords, rv, rh)})
            print(json.dumps({
                "phase": "bandwarp_against", "other": str(other_csrc), "B": B, "C": C, "H": H, "W": W,
                "coords": pattern, "max_abs_err": errs, "other_ms": times["other"], "this_ms": times["this"],
                "bound_ms": _bound_ms(4.0 * B * H * W * (2 + 2 * C), 8.0 * B * H * W * C)[0],
            }), flush=True)
            if group:
                total = sums.setdefault(f"{group}, {pattern} coordinates", {"other": [0.0, 0.0], "this": [0.0, 0.0]})
                for name in ("other", "this"):
                    for i in (0, 1):
                        total[name][i] += per_step * times[name][i]
        del cases, step_inputs
        torch.cuda.empty_cache()
        print(json.dumps({"phase": "bandwarp_step_against", "other": str(other_csrc), "ms_per_step": sums}),
              flush=True)

    if "rowconv" in libs:
        from davo_tpu_torch.models import presets
        from davo_tpu_torch.models.davo import DavoModel

        builds = {"other": _bind_other_rowconv(torch, libs["rowconv"]), "this": (rowconv._library(), {})}
        model = DavoModel(presets.with_overrides("davo-fast", **FUSED_FLAGS).model, device="cuda", seed=0)
        for unit in _rowconv_units(torch, model, 64):
            for mode in ("bfloat16", "float32", "bf16_dot"):
                inputs = _unit_inputs(torch, unit, mode)
                with torch.inference_mode():
                    want, _ = _unit_plain(torch, rowconv, unit, mode, inputs)
                    fns = {name: _with_library(rowconv, lib, lambda: _unit_call(rowconv, unit, mode, inputs), **attrs)
                           for name, (lib, attrs) in builds.items()}
                    errs = {name: _rel_err(fn(), want) for name, fn in fns.items()}
                    times = _turns(fns, reps=5)
                print(json.dumps({
                    "phase": "rowconv_against", "other": str(other_csrc), "kernel": unit["kernel"],
                    "unit": unit["unit"], "mode": mode, "max_rel_err": errs, "other_ms": times["other"],
                    "this_ms": times["this"],
                }), flush=True)
                if mode == "float32" and not max(errs.values()) <= ROWCONV_F32_TOL:
                    raise AssertionError(f"{unit['unit']} float32: errors {errs}")
        del model
        torch.cuda.empty_cache()
        _level_input_against(torch, {name: lib for name, (lib, _) in builds.items()}, other_csrc)

    if "rowconv_bwd" in libs:
        _compare_backward_against(torch, libs["rowconv_bwd"], other_csrc)
    if "conv_stack" in libs:
        _compare_conv_stack_against(torch, libs["conv_stack"], other_csrc)


def _level_input_against(torch, builds, other_csrc):
    """`--against`: the flow level's input kernel of two rowconv.cu builds
    ({"other": lib, "this": lib}, behind this checkout's wrapper) at the
    `LEVEL_INPUT_UNITS`, each held to the plain version (phase 3d's
    criteria), timed in turns; prints a row per unit and the sums per
    serving request and per fused train step."""
    from davo_tpu_torch.kernels import rowconv

    gen = torch.Generator(device="cuda").manual_seed(24)
    sums = {}
    with torch.inference_mode():
        for group, label, B, H, W, C, Cf, search, mode, with_a0 in LEVEL_INPUT_UNITS:
            kernel, plain, _, nbytes, flops = _level_input_case(torch, rowconv, gen, B, H, W, C, Cf, search, mode,
                                                                 with_a0)
            fns = {name: _with_library(rowconv, lib, kernel) for name, lib in builds.items()}
            want = plain()
            errs = {name: _level_input_errors(torch, fn(), want, mode) for name, fn in fns.items()}
            del want
            if not all(_level_input_ok(e) for e in errs.values()):
                raise AssertionError(f"flow_level_input {group} {label}: {errs}")
            times = _turns(fns, reps=10)
            bound_ms = _bound_ms(nbytes, flops)[0]
            print(json.dumps({
                "phase": "level_input_against", "other": str(other_csrc), "group": group, "unit": label,
                "mode": mode, "errors": errs, "other_ms": times["other"], "this_ms": times["this"],
                "bound_ms": bound_ms,
            }), flush=True)
            total = sums.setdefault(group, {"other": [0.0, 0.0], "this": [0.0, 0.0], "bound": 0.0})
            for name in fns:
                for i in (0, 1):
                    total[name][i] += times[name][i]
            total["bound"] += bound_ms
    print(json.dumps({"phase": "level_input_against_sums", "other": str(other_csrc), "ms": sums}), flush=True)
    torch.cuda.empty_cache()


def _compare_backward_against(torch, lib, other_csrc):
    """`--against`: another checkout's rowconv_bwd.cu (built alike, behind
    this checkout's wrappers) against this checkout's: each fused training
    unit's backward (phase 3e's units, one davo B=4 step: gate, wgrad,
    dgrad per layer and, for a flow level, `flow_level_input_bwd`), bf16
    and float32, both held first to the plain backward summed in float64
    (phase 3e's criteria), then timed in turns by CUDA-graph replay; then
    `flow_level_input_bwd` alone (`_level_input_bwd_against`). Prints a
    `rowconv_bwd_against` row per unit."""
    from davo_tpu_torch.kernels import rowconv, rowconv_ad
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    builds = {"other": rowconv_ad.bind(lib), "this": rowconv_ad._library()}
    model = DavoModel(presets.with_overrides("davo", **FUSED_TRAIN_FLAGS).model, device="cuda", seed=0,
                      dispnet=True)
    for unit in _train_units(torch, model):
        for mode in ("bfloat16", "float32"):
            kernels, _, reference, rounded, *_ = _train_unit_case(torch, rowconv, rowconv_ad, unit, mode)
            fns = {name: _with_library(rowconv_ad, build, kernels) for name, build in builds.items()}
            with torch.no_grad():
                want = reference()
                errs = {name: _bwd_errors(torch, fn(), want, rounded) for name, fn in fns.items()}
                del want
                times = _turns(fns, reps=3)
            print(json.dumps({
                "phase": "rowconv_bwd_against", "other": str(other_csrc), "kernel": unit["kernel"],
                "unit": unit["unit"], "mode": mode, "max_rel_err_share_ulps": errs,
                "other_ms": times["other"], "this_ms": times["this"],
            }), flush=True)
            for name, (rel, share, ulps) in errs.items():
                if not (rel <= ROWCONV_BWD_TOL and share <= ROWCONV_BWD_BF16_SHARE and ulps <= 1.0):
                    raise AssertionError(f"{unit['unit']} {mode} ({name}): errors {errs}")
            del kernels, reference, fns
            torch.cuda.empty_cache()
    del model
    _level_input_bwd_against(torch, builds, other_csrc)


def _level_input_bwd_against(torch, builds, other_csrc):
    """`flow_level_input_bwd` of two builds ({"other": lib, "this": lib})
    at the `davo` flow levels (/16, /8, /4: C = 96, 64, 32, s = 4) of the
    fused B=4 and B=64 steps (S*B = 8 and 128 images), bf16 and float32
    maps: a0 from this checkout's flow-level input kernel on random maps,
    da0 random at the dgrad's width (D + C + 2 channels: rows neither 4-
    nor 16-byte aligned); each output of both held to the plain version
    summed in float64 (1e-5 of its largest; bf16 outputs at most 1e-3 of
    elements off, by at most one ulp at the scale), two runs of each
    bitwise equal; timed in turns. Prints a row per level and one sum per
    step and dtype."""
    from davo_tpu_torch.kernels import rowconv, rowconv_ad

    gen = torch.Generator(device="cuda").manual_seed(21)
    sums = {}
    for B in (4, 64):
        for mode, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            total = sums.setdefault(f"B={B} step, {mode}", {"other": [0.0, 0.0], "this": [0.0, 0.0], "bound": 0.0})
            for level, C in ((3, 96), (2, 64), (1, 32)):
                N, h, w = 2 * B, 128 >> (level + 1), 416 >> (level + 1)
                f1 = torch.randn(N, h, w, C, device="cuda", generator=gen).to(dt)
                f2 = torch.randn(N, h, w, C, device="cuda", generator=gen).to(dt)
                flow_up = torch.randn(N, h, w, 2, device="cuda", generator=gen) * 2.0
                cpad = -(-(81 + C + 2) // 4) * 4
                x = torch.empty((N, h, w, cpad), dtype=dt, device="cuda")
                a0 = x if dt == torch.float32 else torch.empty_like(x, dtype=torch.float32)
                rowconv._launch_level_input(f1, f2, f1, flow_up, x, 4, None if a0 is x else a0)
                da0 = torch.randn(N, h, w, 81 + C + 2, device="cuda", generator=gen)
                fns = {name: _with_library(rowconv_ad, build, lambda: rowconv_ad._launch_level_input_bwd(
                    f1, f2, a0, da0, 4, dt, C, 2)) for name, build in builds.items()}
                want = rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0.double(), 4, C, 2)
                want = [t.to(dt) if i < 3 else t.float() for i, t in enumerate(want)]
                errs, bitwise = {}, {}
                for name, fn in fns.items():
                    got = fn()
                    errs[name] = _bwd_errors(torch, got, want, (0, 1, 2))
                    bitwise[name] = all(torch.equal(a, b) for a, b in zip(fn(), got))
                    del got
                del want
                times = _turns(fns, reps=5)
                # Read: the maps, da0, a0's first D = 81 channels; written:
                # df1, df2, dfeat, dflow.
                nbytes = sum(t.numel() * t.element_size() for t in (f1, f2, da0)) + N * h * w * 81 * 4 + (
                    2 * f1.numel() * f1.element_size() + N * h * w * (C * f1.element_size() + 8))
                bound_ms = _bound_ms(nbytes, 4.0 * N * h * w * 81 * C)[0]
                print(json.dumps({
                    "phase": "level_input_bwd_against", "other": str(other_csrc), "batch": B,
                    "shape": [N, h, w, C], "mode": mode, "max_rel_err_share_ulps": errs, "bitwise_repeat": bitwise,
                    "other_ms": times["other"], "this_ms": times["this"], "bound_ms": bound_ms,
                }), flush=True)
                for name in fns:
                    rel, share, ulps = errs[name]
                    if not (bitwise[name] and rel <= ROWCONV_BWD_TOL and share <= ROWCONV_BWD_BF16_SHARE
                            and ulps <= 1.0):
                        raise AssertionError(f"flow_level_input_bwd {N}x{h}x{w}x{C} {mode} ({name}): {errs}")
                for name in fns:
                    for i in (0, 1):
                        total[name][i] += times[name][i]
                total["bound"] += bound_ms
                del f1, f2, flow_up, x, a0, da0, fns
            torch.cuda.empty_cache()
    print(json.dumps({"phase": "level_input_bwd_against_per_step", "other": str(other_csrc), "ms": sums}),
          flush=True)


def _stack_weight_layouts(src):
    """The weights each mode of a conv_stack.cu source reads, by the
    kernels it holds: "oihw" (OIHW float32: the FMA kernels of PRs 5-11,
    both modes before PR 10, float32 before PR 12), "mma" (bf16,
    `rowconv._pack_mma`: `conv_stack_mma_kernel`, PR 10 on) or "tf32"
    (`rowconv._pack_tf32`'s hi and lo planes: `conv_stack_tf32_kernel`,
    PR 12 on)."""
    text = Path(src).read_text()
    return {"bfloat16": "mma" if "conv_stack_mma_kernel" in text else "oihw",
            "float32": "tf32" if "conv_stack_tf32_kernel" in text else "oihw"}


def _parent_stack_launch(torch, lib, x, ws, bs, strides, relus, mode, layouts):
    """One launch of another checkout's conv_stack.cu (its
    `davo_conv_stack`: 13 ints a layer, the entry of every version so
    far), each weight as that source reads it in `mode` (`layouts`, from
    `_stack_weight_layouts`: OIHW float32, `_pack_mma`'s bf16 or
    `_pack_tf32`'s planes). Returns the float32 output."""
    import ctypes

    from davo_tpu_torch.kernels import conv_stack, rowconv

    B, h, w, cin = x.shape
    n, act_bf16 = len(ws), int(mode == "bfloat16")
    layout = layouts[mode]
    if layout == "oihw":
        wf = [t.detach().float().contiguous() for t in ws]
    else:
        wf = [rowconv._packed(t, torch.bfloat16 if layout == "mma" else torch.float32, t.shape[1]) for t in ws]
    bf = [t.detach().float().contiguous() for t in bs]
    params, offsets, nbytes = [], [], 0
    for i, (wt, s, r) in enumerate(zip(ws, strides, relus)):
        k, cout = wt.shape[-1], wt.shape[0]
        ho, pad_t, _ = conv_stack.same_pads(h, k, s)
        wo, pad_l, _ = conv_stack.same_pads(w, k, s)
        x_bf16 = act_bf16 if i else int(x.dtype == torch.bfloat16)
        aligned = 1 if i else int(x.data_ptr() % (4 * x.element_size()) == 0)
        params += [x_bf16, aligned, h, w, cin, ho, wo, cout, k, s, pad_t, pad_l, int(bool(r))]
        if i < n - 1:
            offsets.append(nbytes)
            nbytes += -(-B * ho * wo * cout * (2 if act_bf16 else 4) // 256) * 256
        h, w, cin = ho, wo, cout
    out = torch.empty((B, h, w, cin), dtype=torch.float32, device=x.device)
    work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=x.device)
    ins = [x.data_ptr()] + [work.data_ptr() + off for off in offsets]
    outs = [work.data_ptr() + off for off in offsets] + [out.data_ptr()]

    def ptrs(values):
        return (ctypes.c_void_p * n)(*values)

    err = lib.davo_conv_stack(n, B, ptrs(ins), ptrs(outs), ptrs([t.data_ptr() for t in wf]),
                              ptrs([t.data_ptr() for t in bf]), (ctypes.c_int * len(params))(*params), act_bf16,
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise AssertionError(f"other conv stack: launch failed ({err})")
    return out


def _compare_conv_stack_against(torch, lib, other_csrc):
    """`--against`: another checkout's conv_stack.cu (`_parent_stack_launch`
    with the weights its source reads) against this checkout's
    `fused_conv_stack` on the davo-fast pose prefix at B=64 and 256, bf16
    and float32: both held to the plain version (float32 within 1e-5 of
    the largest; bf16 a mean gap at most half the plain version's
    bf16-to-f32 gap), whether the two outputs are bitwise equal, timed in
    turns, beside #7 on the same prefix and the port's unfused route in
    the mode's dtype (cuDNN bf16, or float32 with TF32 off), with this
    checkout's grid and the float32 bound at 3 TF32 passes."""
    import ctypes

    from davo_tpu_torch.bench.sol import conv_stack_sol
    from davo_tpu_torch.kernels import conv_stack, rowconv

    layouts = _stack_weight_layouts(Path(other_csrc) / "conv_stack.cu")
    lib.davo_conv_stack.argtypes = conv_stack.SIGNATURES["davo_conv_stack"]
    lib.davo_conv_stack.restype = ctypes.c_int
    ws, bs, strides, relus, mods, prefix_input, shapes, _ = _pose_prefix(torch)
    with torch.inference_mode():
        for B in (64, 256):
            for mode in ("bfloat16", "float32"):
                x = prefix_input(B, mode)
                fns = {"other": lambda: _parent_stack_launch(torch, lib, x, ws, bs, strides, relus, mode, layouts),
                       "this": lambda: conv_stack.fused_conv_stack(x, ws, bs, strides, relus, 8, mode)}
                want = conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 8, mode)
                errs = {name: float((fn() - want).abs().max() / want.abs().max()) for name, fn in fns.items()}
                row = {"phase": "conv_stack_against", "other": str(other_csrc), "other_weights": layouts[mode],
                       "batch": B, "mode": mode, "max_rel_err": errs,
                       "bitwise_equal": bool(torch.equal(fns["other"](), fns["this"]()))}
                seq = torch.nn.Sequential(*mods)
                if mode == "bfloat16":
                    want32 = conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 8, "float32")
                    ref_gap = _mean_gap(want, want32)
                    row["gap_ratio"] = {name: _mean_gap(fn(), want) / ref_gap for name, fn in fns.items()}
                    ok = max(row["gap_ratio"].values()) <= ROWCONV_GAP_RATIO
                else:
                    seq = _in_float32(seq)
                    ok = max(errs.values()) <= CONV_STACK_TOL
                    flops = conv_stack_sol(shapes(B)[0], 1.0).flops
                    nbytes = x.numel() * 4 + sum(t.numel() * 4 for t in ws + bs) + 4 * shapes(B)[1]
                    row["tf32_bound_ms"] = _bound_ms(nbytes, 3 * flops, TF32_FLOPS)[0]
                times = _turns(fns, reps=5)
                row.update(other_ms=times["other"], this_ms=times["this"], grid=conv_stack.last_launch(),
                           conv_chain_strided_ms=_graph_ms(
                               lambda: rowconv.conv_chain_strided(x, ws, bs, strides, relus, None, mode), reps=5),
                           library_ms=_graph_ms(lambda: seq(x), reps=5))
                print(json.dumps(row), flush=True)
                if not ok:
                    raise AssertionError(f"conv stack against B={B} {mode}: {row}")
                del x, want
        torch.cuda.empty_cache()


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

    _reset_counts()
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
    _reset_counts()
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
    _reset_counts()
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
    return (x, y, s), B * iters / min(times)


def _kernel_profile(torch, run, iters, inference=True):
    """torch.profiler over `iters` calls of `run`, under inference mode
    unless `inference` is false (a backward): ([(kernel, device ms per
    call, launches per call)] by time, device ms and wall ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch.inference_mode(inference):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    rows = sorted((  # device kernels only: operator rows repeat their kernels' time
        (e.key, e.self_device_time_total / 1e3 / iters, e.count // iters)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), wall_ms


def profile(torch, card, stream, inputs):
    """Phase 7: where the davo-fast forward spends its time. Prints the
    steady-state stream (3 passes after the main path's, host clock),
    CUDA-event time of each layer in one B=256 forward (forward hooks;
    nested layers lie inside their parents), and torch.profiler device
    time by kernel over 3 forwards with the device's busy share."""
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

    rows, device_ms, wall_ms = _kernel_profile(torch, lambda: model(x, y, seg=s), 3)
    print(json.dumps({
        "phase": "profile_kernels", "batch": len(x),
        "device_ms_per_forward": device_ms, "wall_ms_per_forward": wall_ms,
        "device_busy_share": device_ms / wall_ms, "card": card,
        "top": [{"kernel": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:25]],
    }), flush=True)


def _bound_ms(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """The least time for the work: bytes over the memory rate or the
    operations over `peak` (the f32 rate unless given), whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


# Phase 3b's shapes: `davo`'s three train levels (C = 96, 64, 32; s = 4)
# at S*B = 8 and 128 (B = 4 and 64, two sources), then one odd shape
# whose frame is smaller than the kernel's 8x16 tile in both axes and
# whose channels do not fill its 32-channel slice.
COSTVOL_BWD_SHAPES = [
    (B, f"davo {label}", H, W, C) for B in (8, 128)
    for label, H, W, C in (("/16", 8, 26, 96), ("/8", 16, 52, 64), ("/4", 32, 104, 32))
] + [(3, "odd 11x29 C=20", 11, 29, 20)]


def check_cost_volume_backward(torch, costvol):
    """Phase 3b: the backward kernel against `cost_volume_plain_bwd` at
    COSTVOL_BWD_SHAPES; on the odd shape also each gradient alone (the
    launch then runs one kind of block)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    s, D = 4, 81
    rows = []
    for B, label, H, W, C in COSTVOL_BWD_SHAPES:
        f1 = torch.randn(B, H, W, C, device="cuda", generator=gen)
        f2 = torch.randn(B, H, W, C, device="cuda", generator=gen)
        g = torch.randn(B, H, W, D, device="cuda", generator=gen)
        got = costvol._launch_bwd(f1, f2, g, s, True, True)
        want = costvol.cost_volume_plain_bwd(f1, f2, g, s)
        if label.startswith("odd"):
            only1 = costvol._launch_bwd(f1, f2, g, s, True, False)
            only2 = costvol._launch_bwd(f1, f2, g, s, False, True)
            if only1[1] is not None or only2[0] is not None:
                raise AssertionError("cost volume backward computed a gradient not asked for")
            got = got + (only1[0], only2[1])
            want = want + want
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        bound_ms, bound_by = _bound_ms(4.0 * B * H * W * (4 * C + D), 4.0 * B * H * W * D * C)
        row = {
            "shape": label, "B": B, "H": H, "W": W, "C": C, "search": s,
            "max_abs_err": err,
            "ms": _event_ms(lambda: costvol._launch_bwd(f1, f2, g, s, True, True), 20),
            "device_ms": _graph_ms(lambda: costvol._launch_bwd(f1, f2, g, s, True, True)),
            "plain_ms": _event_ms(lambda: costvol.cost_volume_plain_bwd(f1, f2, g, s), 5),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        }
        print(json.dumps({"phase": "costvol_bwd", **row}), flush=True)
        if not err <= COSTVOL_TOL:
            raise AssertionError(f"cost volume backward {label} B={B}: max abs err {err} > {COSTVOL_TOL}")
        rows.append(row)
    return rows


# Phase 3b's search sweep: a small `davo`-like level (S*B = 4, the /8
# level's 16x52 at C = 64) at searches whose shift rows all fit one pass
# (1: the run-time-radius instance; 2, 3: the compile-time ones; 7: the
# widest one-pass search) and wider ones that walk the rows in passes
# (8: 15 + 2 rows; 12; 20), float32 and bf16 maps.
COSTVOL_BWD_SEARCHES = (1, 2, 3, 7, 8, 12, 20)


def check_cost_volume_backward_searches(torch, costvol):
    """Phase 3b, the backward kernel at `COSTVOL_BWD_SEARCHES` against
    `cost_volume_plain_bwd` on the same maps (bf16 maps widened to
    float32 first, as the autograd Function hands them to the kernel),
    both gradients within COSTVOL_TOL; for bf16 maps also the autograd
    path's gradients equal to the kernel's rounded to bf16. Prints one
    line; raises on a miss."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    B, H, W, C = 4, 16, 52, 64
    cases = []
    for search in COSTVOL_BWD_SEARCHES:
        D = (2 * search + 1) ** 2
        for dt in (torch.float32, torch.bfloat16):
            f1 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            f2 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
            g = torch.randn(B, H, W, D, device="cuda", generator=gen)
            got = costvol._launch_bwd(f1.float(), f2.float(), g, search, True, True)
            want = costvol.cost_volume_plain_bwd(f1.float(), f2.float(), g, search)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            case = {"search": search, "dtype": str(dt).split(".")[-1], "shape": [B, H, W, C], "max_abs_err": err}
            ok = err <= COSTVOL_TOL
            if dt == torch.bfloat16:
                a, b = f1.clone().requires_grad_(), f2.clone().requires_grad_()
                costvol.cost_volume(a, b, search).backward(g)
                case["autograd_equal"] = bool(torch.equal(a.grad, got[0].to(dt)) and torch.equal(b.grad, got[1].to(dt)))
                ok = ok and case["autograd_equal"]
            cases.append(case)
            if not ok:
                raise AssertionError(f"cost volume backward at search {search}: {case}")
            del f1, f2, g, got, want
    print(json.dumps({"phase": "costvol_bwd_searches", "cases": cases}), flush=True)


def _band_coords(torch, gen, B, H, W):
    """Sample coordinates that reach every case of the kernels: a third
    of the displacements beyond the band on each axis, points out of
    frame on every side, exact integers, and points exactly on the last
    row and column."""
    rv, rh = BAND
    du = (torch.rand(B, H, W, device="cuda", generator=gen) * 2 - 1) * 1.5 * rh
    dv = (torch.rand(B, H, W, device="cuda", generator=gen) * 2 - 1) * 1.5 * rv
    du[:, ::7] = du[:, ::7].round()
    dv[:, :, ::5] = dv[:, :, ::5].round()
    u = torch.arange(W, device="cuda", dtype=torch.float32) + du
    v = torch.arange(H, device="cuda", dtype=torch.float32)[:, None] + dv
    u[:, :, -1], v[:, -1, :] = W - 1.0, H - 1.0
    u[0, :, :2], v[-1, :2, :] = -1.5, H + 0.5
    return torch.stack([u, v], -1).contiguous()


# The banded warps of one `davo` train step at B=4: (C, H, W, fill) ->
# launches per step. Photometric: 4 scales x 2 sources; geometry: 2
# sources (C=1, zeros); flow: 2 sources x 3 levels (/4, /8, /16).
TRAIN_WARPS = {
    (3, 128, 416, "border"): 2, (3, 64, 208, "border"): 2, (3, 32, 104, "border"): 4,
    (3, 16, 52, "border"): 4, (3, 8, 26, "border"): 2, (1, 128, 416, "zeros"): 2,
}


# Phase 3c's further shapes at band (4, 16), (C, H, W, B, fill): the
# train step's full-resolution warps at B=64, the batch users train at
# (the photometric C=3 "border" warp and the geometry term's C=1 warp,
# forward and, with d/dimg, backward), and two edge frames for the d/dimg
# tiles (64x16 source pixels): one ragged in both axes, one smaller than
# the halo.
EXTRA_WARPS = [(3, 128, 416, 64, "border"), (1, 128, 416, 64, "zeros"), (1, 37, 61, 4, "zeros"),
               (3, 5, 7, 4, "border")]


def _warp_errors(torch, bandwarp, img, coords, g, fill):
    """The kernels' forward (also through `banded_warp` with `fill`) and
    backward with d/dimg against the plain versions: (forward max abs
    error, backward max error relative to each gradient's largest). Two
    backward launches must agree bitwise."""
    rv, rh = BAND
    out = bandwarp._launch_fwd(img, coords, rv, rh)
    dimg, dcoords = bandwarp._launch_bwd(img, coords, g, rv, rh, True)
    again = bandwarp._launch_bwd(img, coords, g, rv, rh, True)
    want = bandwarp.banded_warp_plain_fwd(img, coords, rv, rh)
    want_dimg, want_dcoords = bandwarp.banded_warp_plain_bwd(img, coords, g, rv, rh, True)
    with torch.no_grad():
        filled, valid = bandwarp.banded_warp(img, coords, rv, rh, fill=fill)
    torch.cuda.synchronize()
    fwd_err = max(float((out - want).abs().max()),
                  float((filled - (want if fill == "border" else want * valid)).abs().max()))
    bwd_err = max(float((dcoords - want_dcoords).abs().max()) / float(want_dcoords.abs().max()),
                  float((dimg - want_dimg).abs().max()) / float(want_dimg.abs().max()))
    if not (torch.equal(again[0], dimg) and torch.equal(again[1], dcoords)):
        raise AssertionError(f"banded warp backward {tuple(img.shape)}: two launches differ")
    return fwd_err, bwd_err


def _grid_sample_bwd(torch, bandwarp, img, coords, g, need_img):
    """grid_sample's backward op (`grid_sampler_2d_backward`, the one op
    autograd runs for it) on the band-clamped coordinates, as a callable,
    with the forward's NCHW image and grid."""
    rv, rh = BAND
    _, H, W, _ = img.shape
    _, _, _, _, uc, vc, _, _ = bandwarp._clamped(coords, rv, rh)
    grid = torch.stack([uc / (W - 1) * 2 - 1, vc / (H - 1) * 2 - 1], -1)
    nchw = img.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    return grid, nchw, g_nchw, lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, nchw, grid, 0, 1, True, [need_img, True])


def check_banded_warp(torch, bandwarp):
    """Phase 3c: the banded forward and backward kernels against their
    plain versions at every shape of the train step (B=4, band (4, 16)),
    with F.grid_sample on band-clamped coordinates as the library
    yardstick (the same forward; its backward follows other edge rules);
    then EXTRA_WARPS, forward and backward with d/dimg, timed beside
    grid_sample and its backward (no plain timing)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rv, rh = BAND
    B = 4
    rows = []
    for (C, H, W, fill), per_step in TRAIN_WARPS.items():
        img = torch.rand(B, H, W, C, device="cuda", generator=gen)
        coords = _band_coords(torch, gen, B, H, W)
        g = torch.randn(B, H, W, C, device="cuda", generator=gen)
        need_img = C == 1  # only the geometry term's sampled depth needs d/dimg
        fwd_err, bwd_err = _warp_errors(torch, bandwarp, img, coords, g, fill)
        want = bandwarp.banded_warp_plain_fwd(img, coords, rv, rh)
        grid, nchw, g_nchw, library_bwd = _grid_sample_bwd(torch, bandwarp, img, coords, g, need_img)

        def library_fwd():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

        lib_err = float((library_fwd().permute(0, 2, 3, 1) - want).abs().max())
        lib_in = [grid.detach().requires_grad_()] + ([nchw.detach().requires_grad_()] if need_img else [])
        lib_out = F.grid_sample(lib_in[-1] if need_img else nchw, lib_in[0], mode="bilinear",
                                padding_mode="border", align_corners=True)
        fwd_bound = _bound_ms(4.0 * B * H * W * (2 + 2 * C), 8.0 * B * H * W * C)
        bwd_bound = _bound_ms(4.0 * B * H * W * (4 + (3 if need_img else 2) * C), 16.0 * B * H * W * C)
        row = {
            "C": C, "H": H, "W": W, "B": B, "fill": fill, "per_step": per_step,
            "fwd_max_abs_err": fwd_err, "bwd_max_rel_err": bwd_err, "library_fwd_max_abs_err": lib_err,
            "fwd_ms": _event_ms(lambda: bandwarp._launch_fwd(img, coords, rv, rh), 30),
            "fwd_device_ms": _graph_ms(lambda: bandwarp._launch_fwd(img, coords, rv, rh)),
            "fwd_library_device_ms": _graph_ms(library_fwd),
            "fwd_plain_ms": _event_ms(lambda: bandwarp.banded_warp_plain_fwd(img, coords, rv, rh), 5),
            "fwd_library_ms": _event_ms(library_fwd, 30),
            "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
            "bwd_need_img": need_img,
            "bwd_ms": _event_ms(lambda: bandwarp._launch_bwd(img, coords, g, rv, rh, need_img), 30),
            "bwd_device_ms": _graph_ms(lambda: bandwarp._launch_bwd(img, coords, g, rv, rh, need_img)),
            "bwd_library_device_ms": _graph_ms(library_bwd),
            "bwd_plain_ms": _event_ms(
                lambda: bandwarp.banded_warp_plain_bwd(img, coords, g, rv, rh, need_img), 5),
            "bwd_library_ms": _event_ms(
                lambda: torch.autograd.grad(lib_out, lib_in, g_nchw, retain_graph=True), 30),
            "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
        }
        print(json.dumps({"phase": "bandwarp", **row}), flush=True)
        if not (fwd_err <= BANDWARP_TOL and bwd_err <= BANDWARP_TOL):
            raise AssertionError(f"banded warp C={C} {H}x{W}: fwd err {fwd_err}, bwd rel err {bwd_err}")
        rows.append(row)
    extra_rows = []
    for C, H, W, B, fill in EXTRA_WARPS:
        img = torch.rand(B, H, W, C, device="cuda", generator=gen)
        coords = _band_coords(torch, gen, B, H, W)
        g = torch.randn(B, H, W, C, device="cuda", generator=gen)
        fwd_err, bwd_err = _warp_errors(torch, bandwarp, img, coords, g, fill)
        grid, nchw, _, library_bwd = _grid_sample_bwd(torch, bandwarp, img, coords, g, True)

        def library_fwd():
            return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border", align_corners=True)

        fwd_bound = _bound_ms(4.0 * B * H * W * (2 + 2 * C), 8.0 * B * H * W * C)
        bwd_bound = _bound_ms(4.0 * B * H * W * (4 + 3 * C), 16.0 * B * H * W * C)
        row = {
            "C": C, "H": H, "W": W, "B": B, "fill": fill, "per_step": 0,
            "fwd_max_abs_err": fwd_err, "bwd_max_rel_err": bwd_err, "bwd_need_img": True,
            "fwd_device_ms": _graph_ms(lambda: bandwarp._launch_fwd(img, coords, rv, rh)),
            "fwd_library_device_ms": _graph_ms(library_fwd),
            "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
            "bwd_device_ms": _graph_ms(lambda: bandwarp._launch_bwd(img, coords, g, rv, rh, True)),
            "bwd_library_device_ms": _graph_ms(library_bwd),
            "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1],
        }
        print(json.dumps({"phase": "bandwarp_extra", **row}), flush=True)
        if not (fwd_err <= BANDWARP_TOL and bwd_err <= BANDWARP_TOL):
            raise AssertionError(f"banded warp C={C} {H}x{W} B={B}: fwd err {fwd_err}, bwd rel err {bwd_err}")
        extra_rows.append(row)
    return rows, extra_rows


def _step_warp_inputs(torch, bandwarp, B=64):
    """The banded forward's inputs, (img, coords) in launch order (16), in
    one `davo` train step at batch B: phase 8's synthetic worlds (a B=4
    batch tiled), seeded weights. These are the coordinates a step warps
    by: smooth flows from depth and pose and from the flow net."""
    import dataclasses

    from davo_tpu_torch.data.snippets import MultiSourceDataset
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.train import loop

    cfg = presets.with_overrides("davo")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=B))
    m = cfg.model
    worlds = [SyntheticSequence(n_frames=8, height=m.img_height, width=m.img_width, seed=i) for i in range(2)]
    batch4 = next(MultiSourceDataset(worlds, batch_size=4, with_seg=True, augment=True, seed=0).batches(steps=1))
    state = loop.create_state(cfg, "cuda")
    step_fn = loop.make_train_step(cfg, "cuda")
    seen = []
    launch = bandwarp._launch_fwd

    def grab(img, coords, rv, rh):
        seen.append((img.detach().clone(), coords.detach().clone()))
        return launch(img, coords, rv, rh)

    bandwarp._launch_fwd = grab
    try:
        step_fn(state, _device_batch(torch, batch4, B // 4))
    finally:
        bandwarp._launch_fwd = launch
    torch.cuda.synchronize()
    del state, step_fn
    torch.cuda.empty_cache()
    if len(seen) != 16:
        raise AssertionError(f"a davo train step launched the banded forward {len(seen)} times, not 16")
    return seen


def check_banded_warp_on_step(torch, bandwarp, step_inputs):
    """Phase 3c on the coordinates of a `davo` train step at B=64
    (`_step_warp_inputs`; phase 3c's other shapes take random per-pixel
    coordinates): each of the step's 16 forwards against its plain
    version, with device ms, grid_sample's on the band-clamped
    coordinates and the bound; then the same 16 on the first 4 images
    (the B=4 step). Returns (rows, per-step sums at B=4 and B=64)."""
    import torch.nn.functional as F

    rv, rh = BAND
    rows = []
    sums = {}
    for B in (64, 4):
        for img, coords in step_inputs:
            img, coords = img[:B].contiguous(), coords[:B].contiguous()
            _, H, W, C = img.shape
            want = bandwarp.banded_warp_plain_fwd(img, coords, rv, rh)
            err = float((bandwarp._launch_fwd(img, coords, rv, rh) - want).abs().max())
            del want
            _, _, _, _, uc, vc, _, _ = bandwarp._clamped(coords, rv, rh)
            grid = torch.stack([uc / (W - 1) * 2 - 1, vc / (H - 1) * 2 - 1], -1)
            nchw = img.permute(0, 3, 1, 2).contiguous()
            bound = _bound_ms(4.0 * B * H * W * (2 + 2 * C), 8.0 * B * H * W * C)
            row = {
                "B": B, "C": C, "H": H, "W": W, "coords": "davo train step", "max_abs_err": err,
                "ms": _graph_ms(lambda: bandwarp._launch_fwd(img, coords, rv, rh)),
                "library_ms": _graph_ms(lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="border",
                                                              align_corners=True)),
                "bound_ms": bound[0], "bound_by": bound[1],
            }
            print(json.dumps({"phase": "bandwarp_step_coords", **row}), flush=True)
            if not err <= BANDWARP_TOL:
                raise AssertionError(f"banded warp on step coordinates B={B} C={C} {H}x{W}: error {err}")
            rows.append(row)
            for key in ("ms", "library_ms", "bound_ms"):
                sums[f"b{B}_step_{key}"] = sums.get(f"b{B}_step_{key}", 0.0) + row[key]
            del uc, vc, grid, nchw
    print(json.dumps({"phase": "bandwarp_step_coords_per_step", **sums}), flush=True)
    torch.cuda.empty_cache()
    return rows, sums


def _counts(costvol, bandwarp):
    return {
        "cost_volume": costvol.launches, "cost_volume_backward": costvol.backward_launches,
        "banded_warp": bandwarp.launches, "banded_warp_backward": bandwarp.backward_launches,
    }


def _reset_counts():
    """Every launch count of every kernel module to 0."""
    from davo_tpu_torch.kernels import bandwarp, conv_stack, costvol, rowconv, rowconv_ad

    costvol.launches = costvol.backward_launches = 0
    bandwarp.launches = bandwarp.backward_launches = 0
    rowconv.reset_counts()
    rowconv_ad.reset_counts()
    conv_stack.reset_counts()


# ---------------------------------------------------------------- fused serving kernels

# Fused chains (kernels/rowconv.py), on the card against their plain
# versions. float32: within 1e-5 of the largest output (the same products
# summed in another order). bfloat16: per layer, at most 1e-3 of the
# elements differ, by at most one bf16 ulp at the output's scale; per
# chain, the mean gap to the plain version is at most half of the plain
# version's own mean gap between the mode and float32 (rounding flips
# that spread through later layers must stay well inside the mode's
# noise). The mean, not the max: over millions of elements a single flip
# already makes the max one ulp, as large as the mode's own max gap.
ROWCONV_F32_TOL = 1e-5
ROWCONV_BF16_SHARE = 1e-3
ROWCONV_GAP_RATIO = 0.5
BF16_FLOPS = 989e12        # H100 SXM bf16 tensor-core rate, dense
EST_RELUS = (True, True, True, False)
FUSED_FLAGS = dict(fuse_pyramid=True, fuse_flow_level=True, fuse_attention=True, fuse_pose_encoder=True)
FUSED_SETS = [arg for k in FUSED_FLAGS for arg in ("--set", f"model.{k}=true")]
# The fused training path: the five `_train` flags set together.
FUSED_TRAIN_FLAGS = dict(fuse_pyramid_train=True, fuse_flow_level_train=True, fuse_attention_train=True,
                         fuse_pose_encoder_train=True, fuse_disp_encoder_train=True)
FUSED_TRAIN_SETS = [arg for k in FUSED_TRAIN_FLAGS for arg in ("--set", f"model.{k}=true")]


def _conv_params(mods):
    convs = [getattr(m, "Conv_0", m) for m in mods]
    return [c.weight.detach() for c in convs], [c.bias.detach() for c in convs]


def _in_float32(mod):
    """A copy of `mod` (the port's unfused ConvBlocks, or a FlowEstimator)
    that computes in float32: the same parameters, every compute dtype
    float32 (cuDNN float32; TF32 off under `exact_f32`)."""
    import copy

    import torch

    mod = copy.deepcopy(mod)
    for m in mod.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    return mod


def _rowconv_units(torch, model, N):
    """The fused kernels' calls of one davo-fast request of N pairs at
    128x416 (the pyramid sees both images of a pair, 2N), with weights
    from `model` (a seeded DavoModel) and random inputs of the path's
    ranges. Each unit: what the wrapper takes, its unfused route in the
    port (cuDNN ConvBlocks; for a flow level, the cost-volume kernel, ReLU,
    concatenation and estimator ConvBlocks), and its bytes and FLOPs."""
    from davo_tpu_torch.kernels import costvol

    gen = torch.Generator(device="cuda").manual_seed(6)
    Hh, Ww = model.cfg.img_height, model.cfg.img_width
    fn, pyr, enc = model.flownet, model.flownet.pyramid, model.posenet.encoder

    def rand(*shape, scale=None):
        if scale is None:
            return torch.rand(*shape, device="cuda", generator=gen)
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def strided(name, label, x, mods, strides, relus, taps):
        ws, bs = _conv_params(mods)
        flops, h, w, cin = 0, x.shape[1], x.shape[2], x.shape[3]
        for wt, s in zip(ws, strides):
            h, w = -(-h // s), -(-w // s)
            flops += 2 * x.shape[0] * h * w * wt.shape[0] * wt[0].numel()
        seq = torch.nn.Sequential(*mods)
        seq32 = _in_float32(seq)
        return dict(kernel="conv_chain_strided", unit=label, kind="strided", x=x, ws=ws, bs=bs,
                    strides=strides, relus=relus, taps=taps, library=lambda: seq(x.to(torch.bfloat16)),
                    library32=lambda: seq32(x), flops=flops, weight_bytes=4 * sum(t.numel() for t in ws + bs))

    units = [
        strided("pyramid", "pyramid (2N, 128, 416, 3), taps 1/3/5", rand(2 * N, Hh, Ww, 3),
                [getattr(pyr, f"feat{i}{s}") for i in range(3) for s in "ab"], (2, 1) * 3,
                (True,) * 6, (1, 3, 5)),
        strided("attention", "attention (N, 128, 416, 2), 3 x 3x3/s2", rand(N, Hh, Ww, 2, scale=2.0),
                [getattr(model.attn, f"conv{i}") for i in range(3)], (2,) * 3, (True,) * 3, None),
        strided("pose", "pose prefix (N, 128, 416, 9), k 7/5/3/3/3",
                torch.cat([rand(N, Hh, Ww, 6), rand(N, Hh, Ww, 1) * 0 - 1, rand(N, Hh, Ww, 2, scale=2.0)], -1),
                [getattr(enc, f"enc{i}") for i in range(5)], (2,) * 5, (True,) * 5, None),
    ]
    for level, (h, w, cf, up_scale) in ((2, (16, 52, 64, 0.0)), (1, (32, 104, 32, 2.0))):
        est = getattr(fn, f"estimator{level}")
        ws, bs = _conv_params([est.est0, est.est1, est.est2, est.flow])
        f1, f2 = rand(N, h, w, 8, scale=1.0), rand(N, h, w, 8, scale=1.0)
        feat, flow_up = rand(N, h, w, cf), rand(N, h, w, 2, scale=up_scale)
        P, D = N * h * w, 49
        chain_flops = sum(2 * P * wt[0].numel() * wt.shape[0] for wt in ws)
        weight_bytes = 4 * sum(t.numel() for t in ws + bs)

        est32 = _in_float32(est)

        def level_library(est=est, f1=f1, f2=f2, feat=feat, flow_up=flow_up, dt=torch.bfloat16):
            cv = torch.relu(costvol.cost_volume(f1.float().contiguous(), f2.float().contiguous(), 3))
            return est(cv, feat.to(dt), flow_up)

        units.append(dict(
            kernel="flow_level_fused", unit=f"flow level /{2 ** (level + 1)} ({N}, {h}, {w}), C=8, Cf={cf}",
            kind="level", f1=f1, f2=f2, feat=feat, flow_up=flow_up, ws=ws, bs=bs, relus=EST_RELUS,
            library=level_library, library32=functools.partial(level_library, est=est32, dt=torch.float32),
            flops=2 * P * D * 8 + chain_flops, weight_bytes=weight_bytes,
        ))
        x = torch.cat([torch.relu(costvol.cost_volume_plain(f1, f2, 3)), feat, flow_up], -1)

        def chain_library(est=est, x=x, dt=torch.bfloat16):
            return est.flow(est.est2(est.est1(est.est0(x.to(dt))))).float()

        units.append(dict(
            kernel="conv_chain_nhwc", unit=f"estimator /{2 ** (level + 1)} ({N}, {h}, {w}, {x.shape[3]})",
            kind="nhwc", x=x, ws=ws, bs=bs, relus=EST_RELUS, library=chain_library,
            library32=functools.partial(chain_library, est=est32, dt=torch.float32),
            flops=chain_flops, weight_bytes=weight_bytes,
        ))
    return units


def _unit_inputs(torch, unit, mode):
    """The unit's tensors as the path hands them over in `mode`: the
    compute dtype's maps (bf16 for "bfloat16"), float32 flow_up."""
    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    if unit["kind"] == "level":
        return [unit["f1"].to(dt), unit["f2"].to(dt), unit["feat"].to(dt), unit["flow_up"]]
    return [unit["x"].to(dt)]


def _unit_call(rowconv, unit, mode, inputs):
    """The wrapper on the unit; a list of outputs."""
    ws, bs = unit["ws"], unit["bs"]
    if unit["kind"] == "strided":
        out = rowconv.conv_chain_strided(inputs[0], ws, bs, unit["strides"], unit["relus"], unit["taps"], mode)
        return out if unit["taps"] else [out]
    if unit["kind"] == "nhwc":
        return [rowconv.conv_chain_nhwc(inputs[0], ws, bs, unit["relus"], mode)]
    return [rowconv.flow_level_fused(*inputs, ws, bs, 3, unit["relus"], mode)]


def _unit_plain(torch, rowconv, unit, mode, inputs):
    """(plain outputs as the wrapper returns them, [(layer input, layer
    output)] of every layer) from the plain versions."""
    from davo_tpu_torch.kernels.costvol import cost_volume_plain

    ws, bs, relus = unit["ws"], unit["bs"], unit["relus"]
    act = torch.bfloat16 if mode == "bfloat16" else torch.float32
    if unit["kind"] == "level":
        f1, f2, feat, flow_up = inputs
        x = torch.cat([torch.relu(cost_volume_plain(f1.float(), f2.float(), 3)), feat.float(), flow_up], -1)
        x = x.to(act)
    else:
        x = inputs[0].to(act)
    strides = unit.get("strides", (1,) * len(ws))
    layers = rowconv.conv_chain_strided_plain(x, ws, bs, strides, relus, tuple(range(len(ws))), mode)
    pairs = list(zip([x] + layers[:-1], layers))
    if unit["kind"] == "strided":
        taps = unit["taps"] or (len(ws) - 1,)
        return [layers[t] for t in taps], pairs
    return [layers[-1].float()], pairs


def _rel_err(got, want):
    scale = max(float(w.float().abs().max()) for w in want)
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)) / scale


def _layer_yardsticks(torch, x, w, b, s, g, mode):
    """One layer of phase 3d beside one cuDNN convolution of its shape in
    the mode's dtype (channels-last; symmetric k // 2 padding; float32
    with TF32 off under `exact_f32`) and its bound: input, weights and
    bias read once (bf16 weights in bf16), output written once; the
    products at the bf16 tensor-core rate, or for float32 as 3 TF32
    passes at the TF32 rate, with the f32 FMA bound beside it."""
    k = w.shape[-1]
    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    xn = x.to(dt).permute(0, 3, 1, 2)  # NHWC storage: channels-last
    wn = w.to(dt).contiguous(memory_format=torch.channels_last)
    bn = b.to(dt)
    flops = 2.0 * g.numel() * w[0].numel()
    nbytes = x.numel() * x.element_size() + w.numel() * wn.element_size() + b.numel() * 4 + g.numel() * g.element_size()
    out = dict(shape=[*x.shape, w.shape[0], k, s], flops=flops, bytes=nbytes,
               conv2d_ms=_graph_ms(lambda: torch.nn.functional.conv2d(xn, wn, bn, stride=s, padding=k // 2), reps=5))
    if mode == "bfloat16":
        out["bound_ms"], out["bound_by"] = _bound_ms(nbytes, flops, BF16_FLOPS)
    else:
        out["bound_ms"], out["bound_by"] = _bound_ms(nbytes, 3 * flops, TF32_FLOPS)
        out["fma_bound_ms"] = _bound_ms(nbytes, flops)[0]
    return out


def check_rowconv(torch, rowconv, N=64):
    """Phase 3d: the fused kernels against their plain versions on the
    card, at the fused serving path's shapes for one request of N pairs:
    bfloat16 (the path's mode: every layer by the ulp criterion, the chain
    by the gap criterion), float32 (the chain and every layer within 1e-5
    of the largest output), and bf16_dot (every layer within the float32
    limit). Device ms by CUDA-graph replay of the wrapper (weights packed
    once, as the wrappers keep them), the plain version's ms by CUDA
    events, and, as the library yardstick, the device ms of the port's
    unfused route for the same function in the mode's dtype (bf16, or
    float32 with TF32 off for the float32 mode); each bf16 and float32
    layer alone beside its bound and one cuDNN convolution of its shape
    (`_layer_yardsticks`). Weights: the seeded fused davo-fast."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    model = DavoModel(presets.with_overrides("davo-fast", **FUSED_FLAGS).model, device="cuda", seed=0)
    rows = []
    for unit in _rowconv_units(torch, model, N):
        modes = ["bfloat16", "float32", "bf16_dot"]
        for mode in modes:
            inputs = _unit_inputs(torch, unit, mode)
            with torch.inference_mode():
                got = _unit_call(rowconv, unit, mode, inputs)
                torch.cuda.synchronize()
                want, layers = _unit_plain(torch, rowconv, unit, mode, inputs)
                row = {"kernel": unit["kernel"], "unit": unit["unit"], "mode": mode,
                       "max_rel_err": _rel_err(got, want)}
                # Every layer alone, on the plain version's input to it.
                layer_err = []
                for i, (x, y) in enumerate(layers):
                    strides = unit.get("strides", (1,) * len(unit["ws"]))
                    w, b, s = unit["ws"][i], unit["bs"][i], strides[i]

                    def one(x=x, w=w, b=b, s=s, r=unit["relus"][i]):
                        return rowconv.conv_chain_strided(x.contiguous(), [w], [b], (s,), (r,), None, mode)

                    g = one()
                    d = (g.float() - y.float()).abs()
                    if mode == "float32":
                        entry = {"max_rel_err": float(d.max() / y.float().abs().max())}
                    else:
                        entry = {"differ_share": float((d > 0).float().mean()),
                                 "max_err_in_ulps": float(d.max() / (2.0**-7 * y.float().abs().max()))}
                    if mode != "bf16_dot":
                        entry.update(ms=_graph_ms(one, reps=5), **_layer_yardsticks(torch, x, w, b, s, g, mode))
                    layer_err.append(entry)
                row["layers"] = layer_err
                if mode == "float32":
                    ok = row["max_rel_err"] <= ROWCONV_F32_TOL and all(
                        e["max_rel_err"] <= ROWCONV_F32_TOL for e in layer_err)
                else:
                    want32, _ = _unit_plain(torch, rowconv, unit, "float32", _unit_inputs(torch, unit, "float32"))

                    def gaps(a, b):  # (mean, max) |a - b| over every element of the outputs
                        d = torch.cat([(x.float() - y.float()).abs().flatten() for x, y in zip(a, b)])
                        return float(d.mean()), float(d.max())

                    (gap, gap_max), (ref_gap, ref_gap_max) = gaps(got, want), gaps(want, want32)
                    row.update(chain_gap_mean=gap, reference_gap_mean=ref_gap,
                               chain_gap_max=gap_max, reference_gap_max=ref_gap_max,
                               gap_ratio=gap / ref_gap if ref_gap > 0 else math.inf)
                    if mode == "bfloat16":
                        ok = all(e["differ_share"] <= ROWCONV_BF16_SHARE and e["max_err_in_ulps"] <= 1.0
                                 for e in layer_err)
                    else:  # bf16_dot layers stay float32: the float32 limit
                        ok = all(e["max_err_in_ulps"] * 2.0**-7 <= ROWCONV_F32_TOL for e in layer_err)
                    ok = ok and row["gap_ratio"] <= ROWCONV_GAP_RATIO
                del got, want, layers
                nbytes = unit["weight_bytes"] + sum(t.numel() * t.element_size() for t in inputs)
                outs = _unit_call(rowconv, unit, mode, inputs)
                nbytes += sum(t.numel() * t.element_size() for t in outs)
                del outs
                bound_ms, bound_by = _bound_ms(
                    nbytes, unit["flops"], BF16_FLOPS if mode != "float32" else F32_FLOPS)
                row.update(
                    ms=_graph_ms(lambda: _unit_call(rowconv, unit, mode, inputs), reps=5),
                    plain_ms=_event_ms(lambda: _unit_plain(torch, rowconv, unit, mode, inputs), 3),
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=unit["flops"],
                )
                route = "cuDNN bf16 ConvBlocks" if mode == "bfloat16" else "cuDNN float32 ConvBlocks, TF32 off"
                if mode == "bfloat16":
                    row["library_ms"] = _graph_ms(unit["library"], reps=5)
                elif mode == "float32":
                    # The float32 products as 3 TF32 passes (the layer kernel's design).
                    row["tf32_bound_ms"] = _bound_ms(nbytes, 3 * unit["flops"], TF32_FLOPS)[0]
                    row["library_ms"] = _graph_ms(unit["library32"], reps=5)
                if mode != "bf16_dot":
                    row["library_is"] = f"the port's unfused route ({route}" + (
                        ", cost-volume kernel, ReLU, concatenation)" if unit["kind"] == "level" else ")")
            print(json.dumps({"phase": "rowconv", **row}), flush=True)
            if not ok:
                raise AssertionError(f"{unit['kernel']} {unit['unit']} {mode}: {row}")
            rows.append(row)
    torch.cuda.empty_cache()
    return rows


# The float32 layer kernel's shape classes beyond the model's, as (B, H,
# W, Cin, Cout, k, stride, input dtype, output dtype): odd dims and a
# Cout that is not a multiple of 8, k=1 at stride 2, a bf16 input (no lo
# staged) with bf16 and float32 outputs, the flat order at k=7 and Cin
# 15, Cin 2 at stride 2, Cin 16 (one chunk) into NT=8, a deep K (9*512).
F32_LAYER_SHAPES = [
    (3, 13, 29, 20, 10, 3, 1, "float32", "float32"),
    (3, 14, 30, 3, 16, 1, 2, "float32", "float32"),
    (2, 9, 11, 83, 37, 5, 1, "bfloat16", "float32"),
    (2, 10, 14, 9, 24, 7, 2, "bfloat16", "bfloat16"),
    (2, 12, 20, 15, 8, 7, 1, "float32", "float32"),
    (4, 17, 23, 2, 16, 3, 2, "float32", "float32"),
    (2, 11, 13, 16, 64, 3, 2, "float32", "bfloat16"),
    (2, 16, 16, 512, 16, 3, 1, "float32", "float32"),
]


def check_float32_layer_shapes(torch, rowconv):
    """Phase 3d, the float32 layer kernel (split TF32) at
    `F32_LAYER_SHAPES` against `_layer_plain` in float32 on the same
    input: a float32 output within ROWCONV_F32_TOL of the largest, a
    bf16 one (rounded once) at most 1e-3 of its elements (or one) off by
    at most one ulp at its scale. Prints one line; raises on a miss."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    cases = []
    with torch.inference_mode():
        for B, H, W, cin, cout, k, s, x_dt, out_dt in F32_LAYER_SHAPES:
            x = (torch.rand(B, H, W, cin, device="cuda", generator=gen) * 2 - 1).to(getattr(torch, x_dt))
            w = torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (k * k * cin) ** 0.5
            b = torch.randn(cout, device="cuda", generator=gen) * 0.1
            act = getattr(torch, out_dt)
            out = torch.empty(B, -(-H // s), -(-W // s), cout, dtype=act, device="cuda")
            rowconv._launch_layer(x, w, b, out, s, True, act, torch.float32)
            want = rowconv._layer_plain(x.float(), w, b, s, True, act, torch.float32)
            d = (out.float() - want.float()).abs()
            case = {"shape": [B, H, W, cin, cout, k, s], "input": x_dt, "output": out_dt}
            if act == torch.float32:
                case["max_rel_err"] = float(d.max() / want.abs().max())
                ok = case["max_rel_err"] <= ROWCONV_F32_TOL
            else:
                case.update(differ=int((d > 0).sum()), max_err_in_ulps=float(d.max() / (2.0**-7 * want.float().abs().max())))
                ok = case["differ"] <= max(ROWCONV_BF16_SHARE * d.numel(), 1) and case["max_err_in_ulps"] <= 1.0
            cases.append(case)
            if not ok:
                raise AssertionError(f"float32 layer kernel at {case}")
    print(json.dumps({"phase": "rowconv_f32_shapes", "cases": cases}), flush=True)


# The flow level's input kernel (#5's `flow_level_input`) alone, as
# (group, label, B, H, W, C, Cf, search, maps, with a0): one fused serving
# request's two levels (davo-fast at B=64: C=8, s=3), bf16 (the path's
# mode) and float32; the `davo` levels (/16, /8, /4: C = Cf = 96, 64,
# 32, s=4) of the fused B=4 and B=64 train steps (S*B = 8 and 128) on
# bf16 maps with the float32 a0 the training forward keeps, and without
# it. Cu = 2 throughout.
LEVEL_INPUT_UNITS = [
    (f"serving request, {mode}", f"/{f} (64, {h}, {w})", 64, h, w, 8, cf, 3, mode, False)
    for mode in ("bfloat16", "float32") for f, h, w, cf in ((8, 16, 52, 64), (4, 32, 104, 32))
] + [
    (f"B={B} step{'' if a0 else ', no a0'}", f"/{f} ({2 * B}, {h}, {w}, {c})", 2 * B, h, w, c, c, 4,
     "bfloat16", a0)
    for a0 in (True, False) for B in (4, 64) for f, h, w, c in ((16, 8, 26, 96), (8, 16, 52, 64), (4, 32, 104, 32))
]


def _level_input_case(torch, rowconv, gen, B, H, W, C, Cf, search, mode, with_a0):
    """(kernel call, plain call, unfused-route call, bytes, flops) of one
    `LEVEL_INPUT_UNITS` entry on random maps (flow_up ~2 px). Each call
    returns (the estimator input in the mode's dtype, a0 or None)."""
    import torch.nn.functional as F

    from davo_tpu_torch.kernels import costvol, rowconv_ad

    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    f1, f2, feat = (torch.randn(B, H, W, c, device="cuda", generator=gen).to(dt) for c in (C, C, Cf))
    flow_up = torch.randn(B, H, W, 2, device="cuda", generator=gen) * 2.0
    D = (2 * search + 1) ** 2
    cpad = -(-(D + Cf + 2) // 4) * 4

    def kernel():
        x = torch.empty((B, H, W, cpad), dtype=dt, device="cuda")
        a0 = torch.empty((B, H, W, cpad), dtype=torch.float32, device="cuda") if with_a0 else None
        rowconv._launch_level_input(f1, f2, feat, flow_up, x, search, a0)
        return x, a0

    def plain():
        a0 = F.pad(rowconv_ad.level_input_plain(f1, f2, feat, flow_up, search), (0, cpad - D - Cf - 2))
        return a0.to(dt), (a0 if with_a0 else None)

    def unfused():  # the cost-volume kernel, ReLU, concatenation, cast
        cv = torch.relu(costvol.cost_volume(f1, f2, search))
        if with_a0:
            a0 = torch.cat([cv, feat.float(), flow_up], -1)
            return a0.to(dt), a0
        return torch.cat([cv.to(dt), feat, flow_up.to(dt)], -1), None

    esize = f1.element_size()
    nbytes = B * H * W * ((2 * C + Cf) * esize + 2 * 4 + cpad * esize + (cpad * 4 if with_a0 else 0))
    return kernel, plain, unfused, nbytes, 2.0 * B * H * W * D * C


def _level_input_errors(torch, got, want, mode):
    """float32: the largest absolute error of the output and a0; bf16:
    the output's share of elements that differ and its largest gap in
    bf16 ulps at the output's scale, and a0's largest absolute error."""
    x, a0 = got
    wx, wa0 = want
    row = {}
    if mode == "float32":
        row["max_abs_err"] = float((x - wx).abs().max())
    else:
        d = (x.float() - wx.float()).abs()
        row["differ_share"] = float((d > 0).float().mean())
        row["max_err_in_ulps"] = float(d.max() / (2.0**-7 * wx.float().abs().max()))
    if a0 is not None:
        row["a0_max_abs_err"] = float((a0 - wa0).abs().max())
    return row


def _level_input_ok(row):
    return (row.get("max_abs_err", 0.0) <= COSTVOL_TOL and row.get("a0_max_abs_err", 0.0) <= COSTVOL_TOL
            and row.get("differ_share", 0.0) <= ROWCONV_BF16_SHARE and row.get("max_err_in_ulps", 0.0) <= 1.0)


def check_level_input(torch, rowconv):
    """Phase 3d, `flow_level_input` as a unit of its own (#5's input
    kernel; `LEVEL_INPUT_UNITS`): against its plain version (float32
    output and a0 within 1e-5 absolute; the bf16 output at most 1e-3 of
    its elements off, by at most one ulp at its scale), device ms by
    CUDA-graph replay beside its bytes bound, the plain version (CUDA
    events) and the port's unfused route for the same output (the
    cost-volume kernel, ReLU, concatenation and cast). Prints a row per
    unit and the sums per serving request and per fused train step."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    rows, sums = [], {}
    with torch.inference_mode():
        for group, label, B, H, W, C, Cf, search, mode, with_a0 in LEVEL_INPUT_UNITS:
            kernel, plain, unfused, nbytes, flops = _level_input_case(
                torch, rowconv, gen, B, H, W, C, Cf, search, mode, with_a0)
            row = {"group": group, "unit": label, "C": C, "Cf": Cf, "search": search, "mode": mode,
                   "a0": with_a0, **_level_input_errors(torch, kernel(), plain(), mode),
                   "kernel": rowconv.last_level_input_kernel()}
            bound_ms, bound_by = _bound_ms(nbytes, flops)
            row.update(ms=_graph_ms(kernel, reps=10), plain_ms=_event_ms(plain, 3),
                       library_ms=_graph_ms(unfused, reps=10), bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, flops=flops)
            print(json.dumps({"phase": "level_input", **row}), flush=True)
            if not _level_input_ok(row):
                raise AssertionError(f"flow_level_input {group} {label}: {row}")
            rows.append(row)
            total = sums.setdefault(group, dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
            for key in total:
                total[key] += row[key]
    print(json.dumps({"phase": "level_input_sums", "ms": sums}), flush=True)
    torch.cuda.empty_cache()
    return rows, sums


# The searches at which phase 3d also holds `flow_level_input` (a small
# `davo`-like level: B=2, 8x26, C = Cf = 32, Cu = 2; float32 and bf16
# maps, with and without a0): the tile kernel's run-time-search instance
# (`flow_level_input_kernel<T, -1>`, every search but 3 and 4 that the
# tile plan takes: 1 to 43) and the element kernel the wrapper runs where
# the plan refuses (44 to 64, the largest the kernel takes).
LEVEL_INPUT_SEARCHES = (1, 2, 5, 7, 12, 43, 44, 64)


def check_level_input_searches(torch, rowconv):
    """Phase 3d, `flow_level_input` at `LEVEL_INPUT_SEARCHES` against its
    plain version with `check_level_input`'s criteria (float32 output and
    a0 within 1e-5 absolute; bf16 at most 1e-3 of the elements off, by at
    most one ulp at the output's scale). Each row names the kernel that
    ran, as the C launcher records it (`rowconv.last_level_input_kernel`:
    the tile kernel's instance, or the element kernel), which must be the
    tile kernel's run-time-search instance up to 43 and the element
    kernel from 44. Prints one line; raises on a miss."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    cases = []
    with torch.inference_mode():
        for search in LEVEL_INPUT_SEARCHES:
            for mode in ("float32", "bfloat16"):
                for with_a0 in (False, True):
                    kernel, plain, *_ = _level_input_case(torch, rowconv, gen, 2, 8, 26, 32, 32, search, mode,
                                                          with_a0)
                    row = {"search": search, "mode": mode, "a0": with_a0,
                           **_level_input_errors(torch, kernel(), plain(), mode),
                           "kernel": rowconv.last_level_input_kernel()}
                    want = "flow_level_input_element_kernel" if search >= 44 else "flow_level_input_kernel<-1>"
                    cases.append(row)
                    if not (_level_input_ok(row) and row["kernel"] == want):
                        raise AssertionError(f"flow_level_input at search {search}: {row}")
    print(json.dumps({"phase": "level_input_searches", "level": [2, 8, 26, 32], "cases": cases}), flush=True)
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------- fused training kernels

# The training chains' backward kernels (kernels/rowconv_ad.py,
# csrc/rowconv_bwd.cu) on the card against the plain backwards, on the
# same residuals (the forward kernels' outputs) and output cotangents.
# float32: every gradient within 1e-5 of its largest element. bfloat16:
# the cotangents rounded to a bf16 input's dtype differ from the plain
# version's in at most 1e-3 of their elements, each by at most one bf16
# ulp at the gradient's scale; the float32 ones (dW, db, the flow's)
# within 1e-5 of their largest, as both sum the same float32 products.
ROWCONV_BWD_TOL = 1e-5
ROWCONV_BWD_BF16_SHARE = 1e-3
# The backward's conv kernels run float32 products as 3 TF32 passes on
# the tensor cores (2 for wgrad on a bf16 layer input): their bound takes
# the FLOPs times the passes at the dense TF32 rate; the f32 FMA bound of
# the same FLOPs stands beside it.
TF32_FLOPS = 494.7e12


def _sweep_layers(torch, sweep):
    """The layers of a unit's reverse sweep, last first: (layer, its input,
    dy, g, a_out, relu, OIHW w, stride, input shape, dx dtype or None
    where no dgrad runs). The caller sends each layer's dx back (as the
    next layer's dy) with `send`."""
    x, acts, ws, strides, relus = sweep["x"], sweep["acts"], sweep["ws"], sweep["strides"], sweep["relus"]
    taps, gs, need_dx = sweep["taps"], sweep["gs"], sweep["need_dx"]
    dy = None
    for layer in reversed(range(len(ws))):
        w = ws[layer]
        a_in = x if layer == 0 else acts[layer - 1]
        g = gs[taps.index(layer)].contiguous() if layer in taps else None
        dtype = (torch.float32 if layer else sweep["dx_dtype"]) if layer or need_dx else None
        x_shape = (*a_in.shape[:3], w.shape[1])
        dx = yield layer, a_in, dy, g, acts[layer], relus[layer], w, strides[layer], x_shape, dtype
        dy = dx if layer else None


def _bwd_layer_rows(torch, rowconv_ad, unit, mode, sweep):
    """Phase 3e per layer: the unit's reverse sweep as the kernels run it
    (each layer's dy the previous dgrad's output), every layer's gate,
    wgrad and dgrad against the plain backward on the same inputs summed
    in float64 (max error relative to the largest element), checked to
    repeat bitwise, timed by CUDA-graph replay beside one cuDNN call for
    the same function on pre-formed operands (`conv2d_input` /
    `conv2d_weight` on the padded NCHW maps: float32, TF32 off, the same
    numerics; and bf16); the bounds at the design's TF32 rate and at the
    f32 FMA rate. For a flow level, `flow_level_input_bwd` after the
    sweep. Returns the rows."""
    import torch.nn.functional as F

    from davo_tpu_torch.models.common import same_pads

    ws = sweep["ws"]
    rows, dy = [], None

    def rel(got, want):
        return float((got.double() - want).abs().max()) / max(float(want.abs().max()), 1e-30)

    layers = _sweep_layers(torch, sweep)
    step = next(layers, None)
    while step is not None:
        layer, a_in, dy, g, a_out, relu, w, s, x_shape, dtype = step
        cout, cin, k, _ = w.shape
        has_dx = dtype is not None
        B, H, W, _ = x_shape
        _, Ho, Wo, _ = a_out.shape

        def gate(dy=dy, g=g, a_out=a_out, relu=relu):
            return rowconv_ad._launch_gate(dy, g, a_out, relu)

        dz = gate()

        def wgrad(a_in=a_in, dz=dz, w=w, s=s):
            return rowconv_ad._launch_wgrad(a_in, dz, w.shape, s)

        def dgrad(dz=dz, w=w, x_shape=x_shape, s=s, dtype=dtype):
            return rowconv_ad._launch_dgrad(dz, w, x_shape, s, dtype)

        seen = dict(rowconv_ad.variant_launches)
        dw, db = wgrad()
        dx = dgrad() if has_dx else None
        variants = sorted(k for k, v in rowconv_ad.variant_launches.items() if v != seen.get(k, 0))
        bitwise = (torch.equal(gate(), dz) and all(torch.equal(a, b) for a, b in zip(wgrad(), (dw, db)))
                   and (dx is None or torch.equal(dgrad(), dx)))
        dzr = rowconv_ad._gate_plain(None if dy is None else dy.double(), None if g is None else g.double(),
                                     a_out, relu)
        want_dw, want_db = rowconv_ad._wgrad_plain(a_in[..., :cin], dzr, w.shape, s)
        errs = {"dz": rel(dz[..., :cout], dzr), "dw": rel(dw, want_dw), "db": rel(db, want_db)}
        if has_dx:
            want_dx = rowconv_ad._dgrad_plain(dzr, w, x_shape, s)
            d = (dx.double() - want_dx).abs()
            errs["dx"] = float(d.max()) / max(float(want_dx.abs().max()), 1e-30)
            if dtype == torch.bfloat16:  # against the float64 sum rounded once, in ulps at the scale
                d = (dx.float() - want_dx.float().to(torch.bfloat16).float()).abs()
                errs.update(dx_bf16_differ_share=float((d > 0).float().mean()),
                            dx_bf16_max_ulps=float(d.max()) / (2.0**-7 * max(float(want_dx.abs().max()), 1e-30)))
                errs["dx"] = None
        del dzr, want_dw, want_db
        # One cuDNN call per function on pre-formed operands.
        (top, bottom), (left, right) = same_pads(H, k, s), same_pads(W, k, s)
        dz_n = dz[..., :cout].permute(0, 3, 1, 2).contiguous()
        xp_n = F.pad(a_in[..., :cin].float().permute(0, 3, 1, 2), (left, right, top, bottom)).contiguous()
        size = (B, cin, H + top + bottom, W + left + right)
        lib = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            wd, zd, xd = w.to(dt), dz_n.to(dt), xp_n.to(dt)
            lib[f"cudnn_{name}_wgrad_ms"] = _graph_ms(
                lambda xd=xd, zd=zd: torch.nn.grad.conv2d_weight(xd, w.shape, zd, stride=s), reps=5)
            lib[f"cudnn_{name}_dgrad_ms"] = _graph_ms(
                lambda wd=wd, zd=zd: torch.nn.grad.conv2d_input(size, wd, zd, stride=s), reps=5) if has_dx else None
        flops = 2.0 * B * Ho * Wo * k * k * cin * cout
        passes_w = 2 if a_in.dtype == torch.bfloat16 else 3
        gate_bytes = a_out.numel() * (4 + (dy is not None) * 4 + (0 if g is None else g.element_size())
                                      + relu * a_out.element_size()) + dz.numel() * 4
        w_bytes = a_in.numel() * a_in.element_size() + dz.numel() * 4 + 4 * (w.numel() + cout)
        d_bytes = dz.numel() * 4 + 4 * w.numel() + B * H * W * cin * torch.tensor([], dtype=dtype).element_size()
        times = {"gate_ms": _graph_ms(gate, reps=5), "wgrad_ms": _graph_ms(wgrad, reps=5),
                 "dgrad_ms": _graph_ms(dgrad, reps=5) if has_dx else None}
        dz32 = rowconv_ad._gate_plain(dy, g, a_out, relu)
        times.update(
            gate_plain_ms=_event_ms(lambda: rowconv_ad._gate_plain(dy, g, a_out, relu), 3),
            wgrad_plain_ms=_event_ms(lambda: rowconv_ad._wgrad_plain(a_in[..., :cin], dz32, w.shape, s), 3),
            dgrad_plain_ms=_event_ms(lambda: rowconv_ad._dgrad_plain(dz32, w, x_shape, s), 3) if has_dx else None)
        del dz32
        row = {"phase": "rowconv_bwd_layer", "kernel": unit["kernel"], "unit": unit["unit"], "mode": mode,
               "layer": layer, "shape": [B, H, W, cin, cout, k, s], "x_dtype": str(a_in.dtype).split(".")[-1],
               "variants": variants,
               "max_rel_err": errs, "bitwise_repeat": bitwise, **times, **lib, "flops": flops,
               "gate_bound_ms": _bound_ms(gate_bytes, 0)[0],
               "wgrad_bound_ms": _bound_ms(w_bytes, flops * passes_w, TF32_FLOPS)[0],
               "wgrad_fma_bound_ms": _bound_ms(w_bytes, flops)[0],
               "dgrad_bound_ms": _bound_ms(d_bytes, flops * 3, TF32_FLOPS)[0] if has_dx else None,
               "dgrad_fma_bound_ms": _bound_ms(d_bytes, flops)[0] if has_dx else None}
        print(json.dumps(row), flush=True)
        f32_errs = [v for key, v in errs.items() if v is not None and not key.startswith("dx_bf16")]
        if not (bitwise and max(f32_errs) <= ROWCONV_BWD_TOL
                and errs.get("dx_bf16_differ_share", 0.0) <= ROWCONV_BWD_BF16_SHARE
                and errs.get("dx_bf16_max_ulps", 0.0) <= 1.0):
            raise AssertionError(f"{unit['unit']} {mode} layer {layer}: {row}")
        rows.append(row)
        del dz, dw, db, dz_n, xp_n
        step = layers.send(dx) if layer else None
    if sweep["level"] is not None:
        f1, f2, a0, dt, cf = sweep["level"]
        cu = ws[0].shape[1] - 81 - cf
        da0 = dx

        def level_bwd():
            return rowconv_ad._launch_level_input_bwd(f1, f2, a0, da0, 4, dt, cf, cu)

        got = level_bwd()
        bitwise = all(torch.equal(a, b) for a, b in zip(level_bwd(), got))
        want = rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0.double(), 4, cf, cu)
        errs = [rel(a, b) for a, b in zip(got, want)]
        B, H, W, C = f1.shape
        # a0: only its first D = 81 channels (the gates' mask) are read.
        nbytes = sum(t.numel() * t.element_size() for t in (f1, f2, da0, *got)) + B * H * W * 81 * 4
        row = {"phase": "rowconv_bwd_layer", "kernel": unit["kernel"], "unit": unit["unit"], "mode": mode,
               "layer": "flow_level_input_bwd", "max_rel_err": errs, "bitwise_repeat": bitwise,
               "flow_level_input_bwd_ms": _graph_ms(level_bwd, reps=5),
               "flow_level_input_bwd_plain_ms": _event_ms(
                   lambda: rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0, 4, cf, cu), 3),
               "bound_ms": _bound_ms(nbytes, 4.0 * B * H * W * 81 * C)[0]}
        print(json.dumps(row), flush=True)
        if not (bitwise and (dt == torch.bfloat16 or max(errs) <= ROWCONV_BWD_TOL)):
            raise AssertionError(f"{unit['unit']} {mode} flow_level_input_bwd: {row}")
        rows.append(row)
    return rows


def _train_units(torch, model):
    """The training chains' calls of one `davo` train step at B=4 with two
    sources (128x416): the pyramid on 16 images, the attention stack and
    the pose prefix on 8, the DispNet prefix on 12, the three flow levels
    and (the fuse_estimator_train configuration) the three estimator
    chains on 8. Weights from `model` (a seeded fused davo with DispNet),
    inputs of the path's ranges."""
    from davo_tpu_torch.kernels import costvol

    gen = torch.Generator(device="cuda").manual_seed(13)
    Hh, Ww = model.cfg.img_height, model.cfg.img_width
    B, S = 4, 2
    fn, enc, dn = model.flownet, model.posenet.encoder, model.dispnet

    def rand(*shape, scale=None):
        if scale is None:
            return torch.rand(*shape, device="cuda", generator=gen)
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def strided(label, x, mods, strides, taps, need_dx):
        ws, bs = _conv_params(mods)
        return dict(kernel="conv_chain_strided_ad", unit=label, kind="strided", x=x, ws=ws, bs=bs, mods=mods,
                    strides=strides, relus=(True,) * len(ws), taps=taps, need_dx=need_dx)

    units = [
        strided(f"pyramid ({2 * S * B}, {Hh}, {Ww}, 3), 8 layers, taps 1/3/5/7", rand(2 * S * B, Hh, Ww, 3),
                [getattr(fn.pyramid, f"feat{i}{s}") for i in range(4) for s in "ab"], (2, 1) * 4, (1, 3, 5, 7),
                False),
        strided(f"attention ({S * B}, {Hh}, {Ww}, 2), 3 x 3x3/s2", rand(S * B, Hh, Ww, 2, scale=2.0),
                [getattr(model.attn, f"conv{i}") for i in range(3)], (2,) * 3, (2,), True),
        strided(f"pose prefix ({S * B}, {Hh}, {Ww}, 9), k 7/5/3/3/3",
                torch.cat([rand(S * B, Hh, Ww, 6), rand(S * B, Hh, Ww, 1) * 0 - 1,
                           rand(S * B, Hh, Ww, 2, scale=2.0)], -1),
                [getattr(enc, f"enc{i}") for i in range(5)], (2,) * 5, (4,), True),
        strided(f"DispNet prefix ({(1 + S) * B}, {Hh}, {Ww}, 3), 10 layers, taps 1/3/5/7/9",
                rand((1 + S) * B, Hh, Ww, 3),
                [getattr(dn, f"enc{i}{s}") for i in range(5) for s in ("", "b")], (2, 1) * 5, (1, 3, 5, 7, 9),
                False),
    ]
    for level, c in ((3, 96), (2, 64), (1, 32)):
        h, w = Hh >> (level + 1), Ww >> (level + 1)
        est = getattr(fn, f"estimator{level}")
        mods = [est.est0, est.est1, est.est2, est.flow]
        ws, bs = _conv_params(mods)
        f1, f2 = rand(S * B, h, w, c, scale=1.0), rand(S * B, h, w, c, scale=1.0)
        flow_up = rand(S * B, h, w, 2, scale=0.0 if level == 3 else 2.0)
        units.append(dict(
            kernel="flow_level_fused_ad", unit=f"flow level /{2 ** (level + 1)} ({S * B}, {h}, {w}), C=Cf={c}, D=81",
            kind="level", f1=f1, f2=f2, flow_up=flow_up, ws=ws, bs=bs, relus=EST_RELUS, est=est,
        ))
        x = torch.cat([torch.relu(costvol.cost_volume_plain(f1, f2, 4)), f1, flow_up], -1)
        units.append(dict(
            kernel="conv_chain_nhwc_ad", unit=f"estimator /{2 ** (level + 1)} ({S * B}, {h}, {w}, {x.shape[3]})",
            kind="strided", x=x, ws=ws, bs=bs, mods=mods, strides=(1,) * 4, relus=EST_RELUS, taps=(3,),
            need_dx=True, last_f32=True,
        ))
    return units


def _train_unit_case(torch, rowconv, rowconv_ad, unit, mode):
    """The unit in `mode` as the training path hands it over: residuals
    from the forward kernels and random float32 output cotangents.
    Returns (kernels' backward, plain backward, the plain backward summed
    in float64, the indices of the outputs rounded to a bf16 input's
    dtype, bytes moved, FLOPs, the port's unfused route backward in the
    mode's dtype, the conv FLOPs counted as the kernels' TF32 passes, the
    sweep's operands for `_bwd_layer_rows`), each backward a function
    returning a flat list of gradients in the kernels' dtypes."""
    from collections import Counter

    from davo_tpu_torch.kernels import costvol

    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    act, dot = rowconv.DTYPE_MODES[mode]
    gen = torch.Generator(device="cuda").manual_seed(14)
    ws, bs, relus = unit["ws"], unit["bs"], unit["relus"]
    n = len(ws)
    scratch = Counter()  # the residuals' launches are not the path's

    def layer_flops(shapes, dgrads):
        # wgrad per layer, dgrad per layer that has one: 2 k k Cin Cout per output pixel each.
        return sum((1 + (i in dgrads)) * 2 * out.shape[0] * out.shape[1] * out.shape[2] * w[0].numel() * w.shape[0]
                   for i, (w, out) in enumerate(zip(ws, shapes)))

    def tf32_flops(x0, outs, dgrads):
        # The same products as TF32 passes: dgrad 3, wgrad 3 on a float32 layer input, 2 on a bf16 one.
        ins = [x0, *outs[:-1]]
        return sum(((2 if a_in.dtype == torch.bfloat16 else 3) + 3 * (i in dgrads))
                   * 2 * out.shape[0] * out.shape[1] * out.shape[2] * w[0].numel() * w.shape[0]
                   for i, (w, out, a_in) in enumerate(zip(ws, outs, ins)))

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    if unit["kind"] == "level":
        f1, f2, flow_up = unit["f1"].to(dt), unit["f2"].to(dt), unit["flow_up"]
        a0, acts = rowconv_ad._level_fwd_cuda(f1, f2, f1, flow_up, ws, bs, 4, relus, act, dot, counts=scratch)
        g = torch.randn(acts[-1].shape, device="cuda", generator=gen)
        cf = f1.shape[3]

        def kernels():
            df1, df2, dfeat, dflow, dws, dbs = rowconv_ad._level_bwd_cuda(f1, f2, a0, acts, ws, relus, g, 4, dt, cf)
            return [df1, df2, dfeat, dflow, *dws, *dbs]

        def plain(cot=g):
            df1, df2, dfeat, dflow, dws, dbs = rowconv_ad.flow_level_bwd_plain(f1, f2, a0, acts, ws, relus, cot, 4, cf)
            return [df1.to(dt), df2.to(dt), dfeat.to(dt), dflow.float(), *(t.float() for t in dws + dbs)]

        def reference():
            return plain(g.double())

        rounded = (0, 1, 2)
        P, C = f1.shape[0] * f1.shape[1] * f1.shape[2], f1.shape[3]
        flops = layer_flops(acts, range(n)) + 4 * P * 81 * C
        design_flops = tf32_flops(a0, acts, range(n))
        moved = nbytes([f1, f2, a0, *acts, g]) + 4 * sum(t.numel() for t in ws)
        sweep = dict(x=a0, acts=acts, ws=ws, strides=(1,) * n, relus=relus, taps=(n - 1,), gs=(g,), need_dx=True,
                     dx_dtype=torch.float32, level=(f1, f2, a0, dt, cf))

        def library_fn(f32):  # the unfused route: cost-volume kernel, ReLU, concat, ConvBlocks
            est = _in_float32(unit["est"]) if f32 else unit["est"]
            leaves = [f1.detach().clone().requires_grad_(), f2.detach().clone().requires_grad_(),
                      flow_up.detach().clone().requires_grad_()]
            cv = torch.relu(costvol.cost_volume(leaves[0].float().contiguous(), leaves[1].float().contiguous(), 4))
            out = est(cv, leaves[0], leaves[2])
            return out, leaves + list(est.parameters()), [g]
    else:
        x, strides, taps = unit["x"].to(dt), unit["strides"], unit["taps"]
        acts = rowconv._chain_cuda("residuals", x, ws, bs, strides, relus, act, dot, tuple(range(n)),
                                   unit.get("last_f32", False), counts=scratch)
        gs = [torch.randn(acts[t].shape, device="cuda", generator=gen) for t in taps]
        need_dx = unit["need_dx"]

        def kernels():
            dx, dws, dbs = rowconv_ad._chain_bwd_cuda(x, acts, ws, strides, relus, taps, gs, need_dx, x.dtype)
            return ([dx] if need_dx else []) + [*dws, *dbs]

        def plain(cots=gs):
            dx, dws, dbs = rowconv_ad.conv_chain_bwd_plain(x, acts, ws, strides, relus, taps, cots, need_dx)
            return ([dx.to(x.dtype)] if need_dx else []) + [t.float() for t in dws + dbs]

        def reference():
            return plain([t.double() for t in gs])

        rounded = (0,) if need_dx else ()
        flops = layer_flops(acts, range(n) if need_dx else range(1, n))
        design_flops = tf32_flops(x, acts, range(n) if need_dx else range(1, n))
        moved = nbytes([x, *acts, *gs]) + 4 * sum(t.numel() for t in ws)
        sweep = dict(x=x, acts=acts, ws=ws, strides=strides, relus=relus, taps=taps, gs=gs, need_dx=need_dx,
                     dx_dtype=x.dtype, level=None)

        def library_fn(f32):  # the unfused route: the ConvBlocks (the flow head a bare Conv)
            mods = [_in_float32(m) for m in unit["mods"]] if f32 else unit["mods"]
            leaf = x.detach().clone().requires_grad_(need_dx)
            y, outs = leaf, []
            for m in mods:
                y = m(y)
                outs.append(y)
            params = [p for m in mods for p in m.parameters()]
            return [outs[t] for t in taps], ([leaf] if need_dx else []) + params, gs

    # The unfused route in the mode's dtype: the model's bf16 ConvBlocks,
    # or float32 copies of them (cuDNN float32, TF32 off).
    outs, leaves, cots = library_fn(mode == "float32")
    outs = outs if isinstance(outs, list) else [outs]
    cots = [c.to(o.dtype) for c, o in zip(cots, outs)]

    def library():
        return torch.autograd.grad(outs, leaves, cots, retain_graph=True)

    return kernels, plain, reference, rounded, moved, flops, library, design_flops, sweep


def _bwd_errors(torch, got, want, rounded):
    """(worst float32 error relative to each gradient's largest, worst
    share of differing elements among the bf16-rounded outputs, their
    worst error in bf16 ulps at the gradient's scale: one ulp of its
    largest element, as phase 3d counts them. An element near zero by
    cancellation has a far smaller ulp of its own, which a difference of
    one float32 rounding in the sum before the cast can exceed.)"""
    rel, share, ulps = 0.0, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"gradient {i}: {tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}")
        d = (a.float() - b.float()).abs()
        if i in rounded and a.dtype == torch.bfloat16:
            share = max(share, float((d > 0).float().mean()))
            ulps = max(ulps, float(d.max()) / (2.0**-7 * max(float(b.float().abs().max()), 1e-30)))
        else:
            rel = max(rel, float(d.max()) / max(float(b.float().abs().max()), 1e-30))
    return rel, share, ulps


def check_rowconv_backward(torch, rowconv, rowconv_ad):
    """Phase 3e: the training chains' backward kernels against their plain
    backwards on the card, at the fused training path's shapes (one davo
    train step at B=4), in bfloat16 (the path's mode) and float32. The
    kernels are held against the plain backward summed in float64 (the
    float32 plain backward's own error against it, cuDNN's weight
    gradient over up to 213,000 pixels among it, is recorded beside:
    two float32 sums in different orders can differ by more than either
    differs from the exact sum). Device
    ms of the backward by CUDA-graph replay; the plain backward's ms by
    CUDA events; as the library figure, the port's unfused route backward
    for the same unit in the mode's dtype (autograd through the cuDNN
    ConvBlocks, bf16 or float32 with TF32 off, and for a flow level the
    cost-volume backward kernel): its device time, the profiler's sum of
    its kernels ("library_ms"), and CUDA events around
    torch.autograd.grad, host time included ("library_call_ms")."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    model = DavoModel(presets.with_overrides("davo", **FUSED_TRAIN_FLAGS).model, device="cuda", seed=0,
                      dispnet=True)
    rows, layer_rows = [], []
    for unit in _train_units(torch, model):
        for mode in ("bfloat16", "float32"):
            kernels, plain, reference, rounded, moved, flops, library, design_flops, sweep = _train_unit_case(
                torch, rowconv, rowconv_ad, unit, mode)
            with torch.no_grad():
                got = kernels()
                torch.cuda.synchronize()
                want = reference()
                rel, share, ulps = _bwd_errors(torch, got, want, rounded)
                plain_rel, plain_share, _ = _bwd_errors(torch, plain(), want, rounded)
                bitwise = all(torch.equal(a, b) for a, b in zip(kernels(), got))
                moved_all = moved + sum(t.numel() * t.element_size() for t in got)
                del got, want
                # The conv kernels' products at their TF32 passes; the flow
                # level's input backward (f32 FMAs) at the f32 rate.
                other_flops = 0 if sweep["level"] is None else 4 * sweep["level"][0].numel() * 81
                bytes_ms = moved_all / HBM_BYTES_PER_S * 1e3
                ops_ms = (design_flops / TF32_FLOPS + other_flops / F32_FLOPS) * 1e3
                row = {"kernel": unit["kernel"], "unit": unit["unit"], "mode": mode,
                       "max_rel_err": rel, "bf16_differ_share": share, "bf16_max_ulps": ulps,
                       "plain_f32_max_rel_err": plain_rel, "plain_f32_bf16_differ_share": plain_share,
                       "bitwise_repeat": bitwise,
                       "ms": _graph_ms(kernels, reps=3), "plain_ms": _event_ms(plain, 3),
                       "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "fma_bound_ms": _bound_ms(moved_all, flops)[0],
                       "bytes": moved_all, "flops": flops, "tf32_pass_flops": design_flops}
            # The unfused route's backward: device time (the profiler's sum
            # of its kernels; autograd's backward is not captured in a CUDA
            # graph) and, beside it, CUDA events around the call, host
            # time included.
            row["library_call_ms"] = _event_ms(library, 5)
            row["library_ms"] = _kernel_profile(torch, library, 3, inference=False)[1]
            print(json.dumps({"phase": "rowconv_bwd", **row}), flush=True)
            ok = rel <= ROWCONV_BWD_TOL and share <= ROWCONV_BWD_BF16_SHARE and ulps <= 1.0 and bitwise
            if not ok:
                raise AssertionError(f"{unit['kernel']} {unit['unit']} {mode}: {row}")
            rows.append(row)
            with torch.no_grad():
                layer_rows += _bwd_layer_rows(torch, rowconv_ad, unit, mode, sweep)
            del kernels, plain, reference, library, sweep
            torch.cuda.empty_cache()
    return rows, layer_rows


# Shapes beyond the model's for the backward's conv kernels: odd and tiny
# maps, Cin and Cout off the 8-channel slots, k 1 to 7 at both strides,
# inputs with more channels than the layer reads, bf16 inputs and dx,
# every variant of dgrad_plan and wgrad_plan. (B, H, W, Cin, Cout, k,
# stride, input dtype, extra input channels, tap cotangent, ReLU.)
BWD_SHAPES = [
    (2, 9, 11, 12, 16, 3, 2, "float32", 0, True, True), (3, 7, 13, 20, 24, 3, 1, "bfloat16", 0, False, True),
    (1, 1, 1, 5, 3, 3, 2, "float32", 0, True, False), (2, 2, 3, 8, 8, 3, 1, "bfloat16", 0, True, True),
    (2, 15, 17, 3, 16, 7, 2, "bfloat16", 0, True, True), (2, 15, 17, 9, 16, 7, 2, "float32", 0, False, True),
    (2, 16, 20, 2, 16, 3, 2, "bfloat16", 0, True, True), (2, 13, 21, 32, 2, 3, 1, "bfloat16", 0, True, False),
    (2, 12, 12, 40, 40, 5, 1, "float32", 0, True, True), (2, 12, 12, 40, 40, 5, 2, "bfloat16", 0, True, True),
    (2, 10, 14, 64, 72, 1, 1, "bfloat16", 0, True, True), (2, 10, 14, 64, 72, 1, 2, "float32", 0, True, True),
    (2, 6, 26, 179, 96, 3, 1, "float32", 1, False, True), (2, 6, 26, 179, 96, 3, 1, "bfloat16", 0, True, True),
    (2, 5, 7, 256, 264, 3, 2, "bfloat16", 0, True, True), (1, 4, 13, 512, 512, 3, 1, "bfloat16", 0, True, True),
    (3, 33, 65, 16, 32, 3, 2, "bfloat16", 8, True, True), (2, 31, 47, 24, 8, 3, 1, "float32", 4, True, True),
    (2, 64, 64, 96, 64, 3, 1, "bfloat16", 0, True, True), (4, 19, 23, 11, 13, 3, 1, "float32", 0, True, True),
    (2, 15, 17, 3, 32, 7, 2, "float32", 0, True, True),
]


def check_rowconv_backward_shapes(torch, rowconv_ad):
    """Phase 3e, last part: `BWD_SHAPES` one layer each through the gate,
    wgrad and dgrad (dx in the input's dtype, as for a chain's first
    layer) against the float64 plain versions: float32 outputs within
    ROWCONV_BWD_TOL of their largest, a bf16 dx within one bf16 ulp at its
    scale, two runs bitwise equal. Prints one line; raises on a miss."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    worst, cases = {"dw": 0.0, "db": 0.0, "dx": 0.0, "dx_bf16_ulps": 0.0}, []
    for B, H, W, cin, cout, k, s, dt, extra, tap, relu in BWD_SHAPES:
        dt = getattr(torch, dt)
        Ho, Wo = -(-H // s), -(-W // s)
        x = torch.rand(B, H, W, cin + extra, device="cuda", generator=gen).to(dt)
        w = torch.randn(cout, cin, k, k, device="cuda", generator=gen) * (k * k * cin) ** -0.5
        dy = torch.randn(B, Ho, Wo, cout, device="cuda", generator=gen)
        g = torch.randn(B, Ho, Wo, cout, device="cuda", generator=gen).to(dt) if tap else None
        a = torch.relu(torch.randn(B, Ho, Wo, cout, device="cuda", generator=gen)).to(dt)
        seen = dict(rowconv_ad.variant_launches)

        def run():
            dz = rowconv_ad._launch_gate(dy, g, a, relu)
            dw, db = rowconv_ad._launch_wgrad(x, dz, w.shape, s)
            return dz, dw, db, rowconv_ad._launch_dgrad(dz, w, (B, H, W, cin), s, dt)

        got = run()
        variants = sorted(k_ for k_, v in rowconv_ad.variant_launches.items() if v != seen.get(k_, 0))
        bitwise = all(torch.equal(p, q) for p, q in zip(got, run()))
        dzr = rowconv_ad._gate_plain(dy.double(), None if g is None else g.double(), a, relu)
        want_dw, want_db = rowconv_ad._wgrad_plain(x[..., :cin], dzr, w.shape, s)
        want_dx = rowconv_ad._dgrad_plain(dzr, w, (B, H, W, cin), s)
        errs = {key: float((t.double() - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                for key, t, r in (("dw", got[1], want_dw), ("db", got[2], want_db))}
        if dt == torch.bfloat16:
            errs["dx_bf16_ulps"] = float((got[3].float() - want_dx.float()).abs().max()) / (
                2.0**-7 * max(float(want_dx.abs().max()), 1e-30))
        else:
            errs["dx"] = float((got[3].double() - want_dx).abs().max()) / max(float(want_dx.abs().max()), 1e-30)
        for key, v in errs.items():
            worst[key] = max(worst[key], v)
        cases.append({"shape": [B, H, W, cin, cout, k, s, str(dt).split(".")[-1], extra], "variants": variants,
                      "max_rel_err": errs, "bitwise_repeat": bitwise})
        ok = bitwise and all(v <= (1.0 if key.endswith("ulps") else ROWCONV_BWD_TOL) for key, v in errs.items())
        if not ok:
            raise AssertionError(f"backward kernels on {cases[-1]}")
        del x, w, dy, g, a, got, dzr, want_dw, want_db, want_dx
    print(json.dumps({"phase": "rowconv_bwd_shapes", "cases": len(cases), "worst": worst,
                      "variants": sorted({v for c in cases for v in c["variants"]}), "each": cases}), flush=True)


# (label, B, H, W, C, search, map dtype): searches whose window and gates
# do not fit one pass of `flow_level_input_bwd` (shift rows in passes:
# 14 of 19 at s 9 with float32 maps, 17 with bf16, 7 of 41 at s 20, one a
# pass at s 64, the largest search the kernel takes), and s 1 (one pass,
# the run-time-radius instance).
LEVEL_BWD_SEARCHES = [
    ("s1 f32", 2, 13, 21, 12, 1, "float32"),
    ("s9 f32", 2, 24, 40, 40, 9, "float32"),
    ("s9 bf16", 2, 24, 40, 40, 9, "bfloat16"),
    ("s20 bf16", 1, 30, 50, 36, 20, "bfloat16"),
    ("s64 f32", 1, 9, 17, 8, 64, "float32"),
]


def check_level_input_bwd_searches(torch, rowconv, rowconv_ad):
    """Phase 3e, the flow level's input backward at `LEVEL_BWD_SEARCHES`
    against its plain version summed in float64, as phase 3e's level rows
    hold it: float32 outputs within ROWCONV_BWD_TOL of each gradient's
    largest, bf16 df1/df2 at most ROWCONV_BWD_BF16_SHARE of elements off
    by at most one ulp at the gradient's scale, two runs bitwise equal
    (a0 from the flow-level input kernel on random maps, da0 random at the
    dgrad's width). Prints one line; raises on a miss."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = []
    for label, B, H, W, C, search, dt in LEVEL_BWD_SEARCHES:
        dt = getattr(torch, dt)
        D = (2 * search + 1) ** 2
        f1 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
        f2 = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dt)
        flow_up = torch.randn(B, H, W, 2, device="cuda", generator=gen)
        x = torch.empty((B, H, W, -(-(D + C + 2) // 4) * 4), dtype=dt, device="cuda")
        a0 = x if dt == torch.float32 else torch.empty_like(x, dtype=torch.float32)
        rowconv._launch_level_input(f1, f2, f1, flow_up, x, search, None if a0 is x else a0)
        da0 = torch.randn(B, H, W, D + C + 2, device="cuda", generator=gen)
        got = rowconv_ad._launch_level_input_bwd(f1, f2, a0, da0, search, dt, C, 2)
        bitwise = all(torch.equal(a, b) for a, b in zip(
            rowconv_ad._launch_level_input_bwd(f1, f2, a0, da0, search, dt, C, 2), got))
        want = rowconv_ad.flow_level_input_bwd_plain(f1, f2, a0, da0.double(), search, C, 2)
        want = [t.to(dt) if i < 3 else t.float() for i, t in enumerate(want)]
        rel, share, ulps = _bwd_errors(torch, got, want, (0, 1, 2))
        cases.append({"case": label, "shape": [B, H, W, C], "search": search, "max_rel_err": rel,
                      "bf16_differ_share": share, "bf16_max_ulps": ulps, "bitwise_repeat": bitwise})
        if not (bitwise and rel <= ROWCONV_BWD_TOL and share <= ROWCONV_BWD_BF16_SHARE and ulps <= 1.0):
            raise AssertionError(f"flow_level_input_bwd at {cases[-1]}")
        del f1, f2, flow_up, x, a0, da0, got, want
    print(json.dumps({"phase": "level_input_bwd_searches", "cases": cases}), flush=True)


# ---------------------------------------------------------------- the conv stack (#11)

# kernels/conv_stack.py + csrc/conv_stack.cu on the card against the plain
# version, with phase 3d's criteria: float32 within 1e-5 of the largest
# output; bfloat16 per layer (single-layer stacks on the plain version's
# input to the layer; their float32 outputs rounded to bf16, as the stack
# rounds a layer between layers) at most 1e-3 of the elements differ, by
# at most one bf16 ulp at the output's scale (on the small cases' few
# hundred elements, one element may differ), their float32 outputs within
# 1e-5 of the largest, and per stack a mean gap at most half the plain
# version's own bf16-to-f32 mean gap.
CONV_STACK_TOL = 1e-5
POSE_KS = (7, 5, 3, 3, 3, 3, 3)  # davo-fast's seven pose layers
CONV_STACK_CASES = [
    # (label, input shape, kernel sizes, channels, strides): the JAX
    # tests' shapes (tests/test_kernels.py::TestFusedConvStack), then odd
    # input dims at stride 2.
    ("stride1 (4, 8, 12, 8)", (4, 8, 12, 8), (3, 3), (16, 8), (1, 1)),
    ("stride2 (2, 16, 24, 4) k5 k3", (2, 16, 24, 4), (5, 3), (8, 16), (2, 2)),
    ("mixed (2, 8, 8, 4) s 2/1/2", (2, 8, 8, 4), (3, 3, 3), (8, 8, 8), (2, 1, 2)),
    ("odd (2, 13, 15, 4) k3 s2", (2, 13, 15, 4), (3,), (8,), (2,)),
    ("odd (2, 7, 9, 3) k5 s2, k3 s1", (2, 7, 9, 3), (5, 3), (8, 16), (2, 1)),
]


def _mean_gap(a, b):
    return float((a.float() - b.float()).abs().mean())


def _conv_stack_criteria(torch, conv_stack, rowconv, x, ws, bs, strides, relus, mode, chain=False):
    """(errors of one stack against its plain version, whether they meet
    the criteria). bf16: each layer's share and ulps and the stack's gap
    ratio; f32: the error relative to the largest output and, with
    `chain`, against #7 on the same inputs."""
    got = conv_stack.fused_conv_stack(x, ws, bs, strides, relus, 1, mode)
    torch.cuda.synchronize()
    grid = conv_stack.last_launch()
    want = conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 1, mode)
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"conv stack gave {got.dtype} {tuple(got.shape)}, want float32 {tuple(want.shape)}")
    row = {"max_rel_err": float((got - want).abs().max() / want.abs().max()), "grid": grid}
    if mode == "float32":
        ok = row["max_rel_err"] <= CONV_STACK_TOL
        if chain:
            ref = rowconv.conv_chain_strided(x, ws, bs, strides, relus, None, "float32")
            row["vs_conv_chain_strided_rel_err"] = float((got - ref).abs().max() / ref.abs().max())
            ok = ok and row["vs_conv_chain_strided_rel_err"] <= CONV_STACK_TOL
        return row, ok
    # Each layer alone on the plain stack's input to it (bf16 between layers).
    inputs = [x.to(torch.bfloat16)]
    for i in range(len(ws) - 1):
        inputs.append(rowconv._layer_plain(inputs[-1], ws[i], bs[i], strides[i], relus[i],
                                           torch.bfloat16, torch.bfloat16))
    layers = []
    for i, inp in enumerate(inputs):
        args = (inp, [ws[i]], [bs[i]], (strides[i],), (relus[i],), 1, mode)
        g, w = conv_stack.fused_conv_stack(*args), conv_stack.fused_conv_stack_plain(*args)
        d = (g.to(torch.bfloat16).float() - w.to(torch.bfloat16).float()).abs()
        layers.append({"differ_share": float((d > 0).float().mean()), "elements": d.numel(),
                       "max_err_in_ulps": float(d.max() / (2.0**-7 * w.abs().max())),
                       "f32_rel_err": float((g - w).abs().max() / w.abs().max())})
    want32 = conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 1, "float32")
    gap, ref_gap = _mean_gap(got, want), _mean_gap(want, want32)
    row.update(layers=layers, stack_gap_mean=gap, reference_gap_mean=ref_gap,
               gap_ratio=gap / ref_gap if ref_gap > 0 else math.inf)
    ok = row["gap_ratio"] <= ROWCONV_GAP_RATIO and all(
        e["differ_share"] * e["elements"] <= max(ROWCONV_BF16_SHARE * e["elements"], 1) and e["max_err_in_ulps"] <= 1.0
        and e["f32_rel_err"] <= CONV_STACK_TOL for e in layers)
    return row, ok


def _pose_prefix(torch):
    """The davo-fast pose prefix at 128x416 (the layers `fusable_prefix`
    gives, enc0..enc4 of a seeded davo-fast): (OIHW weights, biases,
    strides, relus, the modules, a seeded input maker (B, mode) -> (B,
    128, 416, 9), the layers' shapes for `conv_stack_sol` and the output's
    elements at batch B, the generator that makes the inputs)."""
    from davo_tpu_torch.kernels import conv_stack
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = presets.get("davo-fast").model
    H, W = cfg.img_height, cfg.img_width
    n = conv_stack.fusable_prefix(H, W, POSE_KS, (2,) * len(POSE_KS))
    if n != 5:
        raise AssertionError(f"fusable_prefix gave {n} pose layers at {H}x{W}, not 5")
    model = DavoModel(cfg, device="cuda", seed=0).eval()
    mods = [getattr(model.posenet.encoder, f"enc{i}") for i in range(n)]
    ws, bs = _conv_params(mods)
    strides, relus = (2,) * n, (True,) * n
    gen = torch.Generator(device="cuda").manual_seed(13)

    def prefix_input(B, mode):  # images in [0, 1], the -1 direction plane, flow ~2 px
        x = torch.cat([torch.rand(B, H, W, 6, device="cuda", generator=gen),
                       torch.full((B, H, W, 1), -1.0, device="cuda"),
                       torch.randn(B, H, W, 2, device="cuda", generator=gen) * 2.0], -1)
        return x.to(torch.bfloat16 if mode == "bfloat16" else torch.float32)

    def shapes(B):  # conv_stack_sol's layers, and the output's elements
        out, h, w, cin = [], H, W, 9
        for wt, s in zip(ws, strides):
            out.append((B, h, w, cin, wt.shape[0], wt.shape[-1], s))
            h, w, cin = -(-h // s), -(-w // s), wt.shape[0]
        return out, B * h * w * cin

    return ws, bs, strides, relus, mods, prefix_input, shapes, gen


def check_conv_stack(torch, card):
    """Phase 3f: the conv stack (#11; bf16 and float32 on the tensor
    cores, a kernel each). Its path is the bench package's speed-of-light
    measurement: `utils.profiling.timed` of
    `fused_conv_stack` on the davo-fast pose prefix at 128x416 (B=64 and
    B=256, bf16 and f32; `_pose_prefix`), then `bench.sol.conv_stack_sol`
    of the time; launch counts are read around that run, one device
    launch per call asserted. Then the kernel against its plain version
    on the same inputs (the criteria above), against #7
    (`rowconv.conv_chain_strided`, the same function) in f32, and on the
    JAX tests' shapes and odd dims, with each launch's grid (blocks per
    SM from the occupancy query, shared memory, each layer's plan); each
    pose layer alone as a one-layer stack at B=64, beside #7's layer.
    Device ms by CUDA-graph replay (the cooperative launch is captured);
    the plain version's by CUDA events; #7 and the port's unfused route
    (cuDNN ConvBlocks in the mode's dtype, float32 with TF32 off: the
    library yardstick) by graph replay; the float32 bound at 3 TF32
    passes beside the f32 FMA bound."""
    from davo_tpu_torch.bench.sol import conv_stack_sol
    from davo_tpu_torch.kernels import conv_stack, rowconv
    from davo_tpu_torch.utils.profiling import timed

    ws, bs, strides, relus, mods, prefix_input, shapes, gen = _pose_prefix(torch)
    H, W = 128, 416
    units = [(B, mode, prefix_input(B, mode)) for B in (64, 256) for mode in ("bfloat16", "float32")]
    path = []
    _reset_counts()
    with torch.inference_mode():
        for B, mode, x in units:
            r = timed(lambda: conv_stack.fused_conv_stack(x, ws, bs, strides, relus, 8, mode), iters=10, loops=3)
            path.append({"batch": B, "mode": mode, "ms": r["ms"], "sol": conv_stack_sol(shapes(B)[0], r["ms"])})
    counts = {"launches": conv_stack.launches, "device_launches": conv_stack.device_launches}
    calls = len(units) * (1 + 10 * 3)
    print(json.dumps({"phase": "conv_stack_path", "calls": calls, **counts, "units": [
        {"batch": p["batch"], "mode": p["mode"], "timed_ms": p["ms"],
         "sol_roofline_ms": p["sol"].roofline_us / 1e3, "sol_fraction": p["sol"].sol_fraction} for p in path],
        "card": card}), flush=True)
    if counts != {"launches": calls, "device_launches": calls}:
        raise AssertionError(f"conv stack path: {counts} for {calls} calls, want one device launch per call")

    rows = []
    with torch.inference_mode():
        for (B, mode, x), p in zip(units, path):
            row, ok = _conv_stack_criteria(torch, conv_stack, rowconv, x, ws, bs, strides, relus, mode, chain=True)
            flops = p["sol"].flops
            nbytes = x.numel() * x.element_size() + sum(t.numel() * 4 for t in ws + bs) + 4 * shapes(B)[1]
            bound_ms, bound_by = _bound_ms(nbytes, flops, BF16_FLOPS if mode == "bfloat16" else F32_FLOPS)
            row.update(
                unit=f"pose prefix ({B}, {H}, {W}, 9), k 7/5/3/3/3", batch=B, mode=mode,
                ms=_graph_ms(lambda: conv_stack.fused_conv_stack(x, ws, bs, strides, relus, 8, mode), reps=5),
                plain_ms=_event_ms(lambda: conv_stack.fused_conv_stack_plain(x, ws, bs, strides, relus, 8, mode), 3),
                conv_chain_strided_ms=_graph_ms(
                    lambda: rowconv.conv_chain_strided(x, ws, bs, strides, relus, None, mode), reps=5),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops,
                sol_roofline_ms=p["sol"].roofline_us / 1e3,
                timing="CUDA-graph replay of the wrapper (the cooperative launch is captured)",
            )
            seq = torch.nn.Sequential(*mods)
            if mode == "float32":
                seq = _in_float32(seq)
                # The float32 products as 3 TF32 passes (the layer kernel's design).
                row["tf32_bound_ms"] = _bound_ms(nbytes, 3 * flops, TF32_FLOPS)[0]
            row["library_ms"] = _graph_ms(lambda: seq(x), reps=5)
            row["library_is"] = "the port's unfused route ({} ConvBlocks enc0..enc4)".format(
                "cuDNN bf16" if mode == "bfloat16" else "cuDNN float32, TF32 off")
            print(json.dumps({"phase": "conv_stack", **row, "card": card}), flush=True)
            if not ok:
                raise AssertionError(f"conv stack {row['unit']} {mode}: {row}")
            rows.append(row)
        del units
        torch.cuda.empty_cache()
        # Where the stack's time goes: each layer alone, a one-layer stack
        # on a random input of its shape at B=64 in the mode's dtype, beside
        # #7's layer kernel on the same input.
        for mode in ("bfloat16", "float32"):
            h, w, cin, layers = H, W, 9, []
            for i, wt in enumerate(ws):
                x = torch.rand(64, h, w, cin, device="cuda", generator=gen)
                args = (x.to(torch.bfloat16) if mode == "bfloat16" else x, [wt], [bs[i]], (strides[i],), (relus[i],))
                ms = _graph_ms(lambda: conv_stack.fused_conv_stack(*args, 8, mode), reps=5)
                layers.append({"layer": i, "shape": [64, h, w, cin, wt.shape[0], wt.shape[-1], strides[i]], "ms": ms,
                               "plan": conv_stack.last_launch()["plans"][0],
                               "conv_chain_strided_ms": _graph_ms(
                                   lambda: rowconv.conv_chain_strided(*args, None, mode), reps=5)})
                h, w, cin = -(-h // strides[i]), -(-w // strides[i]), wt.shape[0]
            print(json.dumps({"phase": "conv_stack_layers", "batch": 64, "mode": mode, "layers": layers}), flush=True)
        for label, shape, ks, chans, st in CONV_STACK_CASES:
            sws = [torch.randn(c, ci, k, k, device="cuda", generator=gen) / (k * k * ci) ** 0.5
                   for k, c, ci in zip(ks, chans, (shape[-1],) + chans[:-1])]
            sbs = [torch.randn(c, device="cuda", generator=gen) * 0.1 for c in chans]
            x = torch.rand(*shape, device="cuda", generator=gen)
            for mode in ("float32", "bfloat16"):
                row, ok = _conv_stack_criteria(torch, conv_stack, rowconv, x, sws, sbs, st, (True,) * len(ks), mode)
                print(json.dumps({"phase": "conv_stack_small", "case": label, "mode": mode, **row}), flush=True)
                if not ok:
                    raise AssertionError(f"conv stack {label} {mode}: {row}")
    return rows, counts


def _fused_counts(costvol, rowconv):
    return {"cost_volume": costvol.launches, **rowconv.launches, "flow_level_input": rowconv.level_input_launches,
            "device_launches": dict(rowconv.device_launches)}


def fused_path(torch, costvol, rowconv, stream):
    """Phase 4b: the fused serving path: davo-fast at 128x416 with the four
    serving flags streams the main path's 257-frame world through
    predict_sequence in requests of 64 pairs (2 flow-level and 3
    strided-chain launches per forward, no cost volume), then through
    `cli infer` with the four --set flags. The fused and unfused poses of
    the same seeded weights are compared (bf16; recorded, not gated)."""
    import numpy as np

    from davo_tpu_torch.cli.main import main as cli_main
    from davo_tpu_torch.eval.runner import assemble_trajectory, make_pose_apply_fn, predict_sequence
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    unfused_model, unfused_fn, frames, seg = stream
    cfg = presets.with_overrides("davo-fast", **FUSED_FLAGS).model
    model = DavoModel(cfg, device="cuda", seed=0).eval()
    apply_fn = make_pose_apply_fn(model)
    _reset_counts()
    t0 = time.perf_counter()
    rels = predict_sequence(apply_fn, frames, seg=seg, batch_size=64)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    counts = _fused_counts(costvol, rowconv)
    traj = assemble_trajectory(rels)
    unfused_rels = predict_sequence(unfused_fn, frames, seg=seg, batch_size=64)
    want = {"cost_volume": 0, "flow_level_fused": 2 * 4, "flow_level_input": 2 * 4, "conv_chain_strided": 3 * 4,
            "conv_chain_nhwc": 0}
    print(json.dumps({
        "phase": "fused_path", "preset": "davo-fast", "flags": FUSED_FLAGS, "frames": len(frames),
        "requests": 4, "batch": 64, "launches": counts, "stream_s": stream_s,
        "trajectory_shape": list(traj.shape),
        "fused_vs_unfused_max_abs_increment_diff": float(np.abs(rels - unfused_rels).max()),
    }), flush=True)
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"fused path launches {counts}, want {want}")
    if traj.shape != (257, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError(f"fused trajectory {traj.shape} is not a finite (257, 4, 4)")

    out = Path("build/chip_smoke/fused_poses.txt")
    out.parent.mkdir(parents=True, exist_ok=True)
    _reset_counts()
    rc = cli_main(["infer", "--version", "davo-fast", *FUSED_SETS, "--data", "synthetic",
                   "--seq", "0", "--out", str(out), "--batch-size", "64"])
    torch.cuda.synchronize()
    cli_counts = _fused_counts(costvol, rowconv)
    rows = np.loadtxt(out)
    print(json.dumps({"phase": "fused_cli_infer", "rc": rc, "poses": list(rows.shape),
                      "launches": cli_counts}), flush=True)
    cli_want = {"cost_volume": 0, "flow_level_fused": 2, "flow_level_input": 2, "conv_chain_strided": 3,
                "conv_chain_nhwc": 0}
    if rc != 0 or rows.shape != (32, 12) or not np.isfinite(rows).all():
        raise AssertionError(f"fused cli infer: rc {rc}, poses {rows.shape}")
    if {k: cli_counts[k] for k in cli_want} != cli_want:
        raise AssertionError(f"fused cli infer launches {cli_counts}, want {cli_want}")
    return counts, model


def fused_estimator(torch, costvol, rowconv):
    """Phase 4c: davo-fast with fuse_estimator only: one B=64 forward runs
    the estimator chains as 2 conv_chain_nhwc launches after the 2
    cost-volume launches."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = presets.with_overrides("davo-fast", fuse_estimator=True).model
    model = DavoModel(cfg, device="cuda", seed=0).eval()
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand(64, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(64, 1, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (64, cfg.img_height, cfg.img_width), device="cuda", generator=gen)
    _reset_counts()
    with torch.inference_mode():
        poses = model(x, y, seg=s)["poses"]
    torch.cuda.synchronize()
    counts = _fused_counts(costvol, rowconv)
    print(json.dumps({"phase": "fused_estimator", "batch": 64, "launches": counts,
                      "poses_finite": bool(torch.isfinite(poses).all())}), flush=True)
    want = {"cost_volume": 2, "flow_level_fused": 0, "flow_level_input": 0, "conv_chain_strided": 0,
            "conv_chain_nhwc": 2}
    if {k: counts[k] for k in want} != want or not torch.isfinite(poses).all():
        raise AssertionError(f"fused estimator: launches {counts}, want {want}")
    return counts


def fused_gpu_against_cpu(torch, rowconv):
    """Phase 5b: the fused davo-fast-width model (64x208, float32, TF32
    off, the four serving flags) on the card against the same model on the
    CPU (the plain versions): poses within 1e-4 of the largest."""
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    cfg = presets.with_overrides(
        "davo-fast", img_height=64, img_width=208, compute_dtype="float32", **FUSED_FLAGS
    ).model
    cpu = DavoModel(cfg, device="cpu", seed=0).eval()
    gpu = DavoModel(cfg, device="cuda", seed=0).eval()
    gen = torch.Generator().manual_seed(10)
    x = torch.rand(4, 64, 208, 3, generator=gen)
    y = torch.rand(4, 1, 64, 208, 3, generator=gen)
    s = torch.randint(0, 19, (4, 64, 208), generator=gen)
    rowconv.reset_counts()
    with torch.inference_mode():
        want = cpu(x, y, seg=s)["poses"]
        got = gpu(x.cuda(), y.cuda(), seg=s.cuda())["poses"].cpu()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    counts = dict(rowconv.launches)
    print(json.dumps({
        "phase": "fused_gpu_vs_cpu", "preset": "davo-fast widths, 64x208, float32, 4 serving flags",
        "max_rel_err": rel, "largest_pose_component": scale, "launches": counts,
        "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
    }), flush=True)
    if counts != {"flow_level_fused": 2, "conv_chain_strided": 3, "conv_chain_nhwc": 0}:
        raise AssertionError(f"fused GPU forward launches {counts}")
    if not (scale > 0 and rel <= PORT_TOL):
        raise AssertionError(f"fused GPU vs CPU poses: rel err {rel} > {PORT_TOL} (scale {scale})")


def _forward_fps(torch, model, B, iters=5):
    """(best, median) frames/s of the model's forward at batch B over 5
    synchronised loops of `iters` forwards, after 2 warm-ups."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand(B, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(B, 1, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (B, cfg.img_height, cfg.img_width), device="cuda", generator=gen)
    times = []
    with torch.inference_mode():
        for _ in range(2):
            model(x, y, seg=s)
        torch.cuda.synchronize()
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x, y, seg=s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return B * iters / min(times), B * iters / statistics.median(times)


def fused_throughput(torch, card, unfused, fused):
    """Phase 6b: forward frames/s of the fused and the unfused davo-fast
    at B=64 and B=256, in turns (unfused, fused, fused, unfused), and the
    fused B=64 forward's device time by kernel. Recorded, not claimed."""
    from davo_tpu_torch.eval.runner import predict_sequence

    result = {}
    for B in (64, 256):
        runs = []
        for name, model in (("unfused", unfused), ("fused", fused), ("fused", fused), ("unfused", unfused)):
            runs.append((name, _forward_fps(torch, model, B)))
        result[B] = {name: [r for n, r in runs if n == name] for name in ("unfused", "fused")}
        print(json.dumps({"phase": "fused_throughput", "batch": B,
                          "frames_per_s_best_median": result[B], "card": card}), flush=True)
    torch.cuda.empty_cache()
    cfg = fused.cfg
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.rand(64, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(64, 1, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (64, cfg.img_height, cfg.img_width), device="cuda", generator=gen)
    rows, device_ms, wall_ms = _kernel_profile(torch, lambda: fused(x, y, seg=s), 3)
    ours = sum(ms for k, ms, _ in rows if any(part in k for part in (
        "conv_tf32_", "conv_mma_", "flow_level_input_")))
    print(json.dumps({
        "phase": "fused_profile_kernels", "batch": 64, "device_ms_per_forward": device_ms,
        "wall_ms_per_forward": wall_ms, "device_busy_share": device_ms / wall_ms,
        "rowconv_kernels_ms": ours, "rowconv_kernels_share": ours / device_ms, "card": card,
        "top": [{"kernel": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:25]],
    }), flush=True)
    return result


def _train_counts(costvol, bandwarp):
    """The train path's launch counts: the cost volume, the banded warp,
    and the training chains (`rowconv_ad`: forward and backward calls,
    and every kernel launch under `device_launches`)."""
    from davo_tpu_torch.kernels import rowconv, rowconv_ad

    return {
        **_counts(costvol, bandwarp), **{f"serving_{k}": v for k, v in rowconv.launches.items()},
        "flow_level_input": rowconv.level_input_launches, **rowconv_ad.launches,
        **{f"{k}_backward": v for k, v in rowconv_ad.backward_launches.items()},
        "device_launches": dict(rowconv_ad.device_launches),
    }


def _refuse_plains(plains):
    """Patch each (module, name) in `plains` to raise; returns the undo."""
    saved = [getattr(mod, name) for mod, name in plains]

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on the train path")

    for mod, name in plains:
        setattr(mod, name, refuse)

    def undo():
        for (mod, name), fn in zip(plains, saved):
            setattr(mod, name, fn)

    return undo


def _train_plains(costvol, bandwarp):
    """Every plain version the train path's kernels stand in for."""
    from davo_tpu_torch.kernels import rowconv, rowconv_ad

    return [(costvol, "cost_volume_plain"), (costvol, "cost_volume_plain_bwd"),
            (bandwarp, "banded_warp_plain_fwd"), (bandwarp, "banded_warp_plain_bwd"),
            (rowconv, "_layer_plain"), (rowconv, "conv_chain_strided_plain"),
            (rowconv, "conv_chain_nhwc_plain"), (rowconv, "flow_level_fused_plain"),
            (rowconv_ad, "conv_chain_bwd_plain"), (rowconv_ad, "flow_level_bwd_plain"),
            (rowconv_ad, "flow_level_input_bwd_plain"), (rowconv_ad, "level_input_plain"),
            (rowconv_ad, "_gate_plain"), (rowconv_ad, "_dgrad_plain"), (rowconv_ad, "_wgrad_plain")]


def train_path(torch, costvol, bandwarp, phase="train_path", flags=None, steps=5, per_step=None):
    """Phase 8: the davo train path at 128x416 with the TrainConfig
    defaults (B=4, bf16, warp_gather auto -> banded (4, 16)), synthetic
    worlds, `steps` steps through `fit`, with the model `flags` set. No
    plain version may run; the launch counts must be `per_step` times
    the steps (every count not named there 0). Returns (counts, a host
    batch of B=4)."""
    import dataclasses

    import numpy as np

    from davo_tpu_torch.data.prefetch import PrefetchStats, device_prefetch
    from davo_tpu_torch.data.snippets import MultiSourceDataset
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.kernels import rowconv_ad
    from davo_tpu_torch.train import loop

    cfg = presets.with_overrides("davo", **(flags or {}))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_steps=steps, log_every=1))
    m = cfg.model
    t0 = time.perf_counter()
    worlds = [SyntheticSequence(n_frames=8, height=m.img_height, width=m.img_width, seed=i) for i in range(2)]
    ds = MultiSourceDataset(worlds, batch_size=cfg.train.batch_size, with_seg=True, augment=True, seed=0)
    state = loop.create_state(cfg, "cuda")
    before = [p.detach().clone() for p in state.model.parameters()]
    setup_s = time.perf_counter() - t0
    undo = _refuse_plains(_train_plains(costvol, bandwarp))
    stats = PrefetchStats()
    try:
        _reset_counts()
        t0 = time.perf_counter()
        _, state, history = loop.fit(
            cfg, device_prefetch(ds.batches(steps=steps), "cuda", stats=stats), state=state, device="cuda"
        )
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = _train_counts(costvol, bandwarp)
        variants = dict(rowconv_ad.variant_launches)
    finally:
        undo()
    unchanged = [
        n for (n, p), b in zip(state.model.named_parameters(), before) if torch.equal(p.detach(), b)
    ]
    per_step = per_step or {"cost_volume": 3, "cost_volume_backward": 3, "banded_warp": 16,
                            "banded_warp_backward": 16}
    want = _want_counts(counts, per_step, steps)
    print(json.dumps({
        "phase": phase, "preset": "davo", "flags": flags or {}, "hw": [m.img_height, m.img_width],
        "batch": cfg.train.batch_size, "steps": steps, "compute_dtype": m.compute_dtype,
        "warp_gather": "banded", "band": list(BAND), "launches": counts, "variant_launches": variants,
        "history": history, "setup_s": setup_s, "fit_s": fit_s, "prefetch": stats.summary(),
        "unchanged_parameters": unchanged, "n_parameters": len(before),
    }), flush=True)
    if counts != want:
        raise AssertionError(f"{phase} launches {counts}, want {want}")
    if len(history) != steps or state.step != steps:
        raise AssertionError(f"{phase} ran {state.step} steps, logged {len(history)}")
    bad = [(i, k) for i, h in enumerate(history) for k, v in h.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{phase}: non-finite loss terms {bad}")
    if unchanged:
        raise AssertionError(f"{phase}: parameters unchanged after {steps} steps: {unchanged}")
    return {**counts, "variant_launches": variants, "prefetch": stats.summary()}, next(ds.batches(steps=1))


def _want_counts(counts, per_step, steps):
    """`counts`' shape with every count `per_step[name]` times `steps`
    (0 when not named), device launches included."""
    want = {k: per_step.get(k, 0) * steps for k in counts if k != "device_launches"}
    want["device_launches"] = {k: per_step.get(f"device:{k}", 0) * steps for k in counts["device_launches"]}
    return want


# Launches per `davo` train step (B=4, two sources, 128x416) on the fused
# training path, reckoned from the model: the pyramid (8 layers on 16
# images), the attention stack (3 layers) and the pose prefix (5 of 7
# layers; the sixth sees 4x13) as one `conv_chain_strided_ad` each, the
# DispNet encoder's (s2, s1) prefix (10 of 14 layers) as a fourth; three
# flow levels (/16, /8, /4) of 4 layers plus the input kernel. Backward:
# a gate and a wgrad per layer, a dgrad per layer but the first of the
# pyramid and of DispNet (their input is the images), and one
# flow_level_input_bwd per level. No cost volume: the fused levels bypass
# it.
FUSED_TRAIN_PER_STEP = {
    "banded_warp": 16, "banded_warp_backward": 16,
    "flow_level_fused_ad": 3, "flow_level_fused_ad_backward": 3, "flow_level_input": 3,
    "conv_chain_strided_ad": 4, "conv_chain_strided_ad_backward": 4,
    "device:flow_level_fused_ad": 3 * 5, "device:conv_chain_strided_ad": 8 + 3 + 5 + 10,
    "device:conv_layer_gate": 8 + 3 + 5 + 10 + 3 * 4,
    "device:conv_layer_wgrad": 8 + 3 + 5 + 10 + 3 * 4, "device:conv_layer_dgrad": 7 + 3 + 5 + 9 + 3 * 4,
    "device:flow_level_input_bwd": 3,
}
# `fuse_estimator_train` alone: the three estimators as conv_chain_nhwc_ad
# (4 layers each; every layer's dgrad, as the cost volume needs one).
ESTIMATOR_TRAIN_PER_STEP = {
    "cost_volume": 3, "cost_volume_backward": 3, "banded_warp": 16, "banded_warp_backward": 16,
    "conv_chain_nhwc_ad": 3, "conv_chain_nhwc_ad_backward": 3, "device:conv_chain_nhwc_ad": 12,
    "device:conv_layer_gate": 12, "device:conv_layer_wgrad": 12, "device:conv_layer_dgrad": 12,
}


def fused_train_cli(torch, costvol, bandwarp, steps=2):
    """Phase 8b (end): `cli train --version davo` with the five --set
    flags of the fused training path, `steps` steps; launch counts as
    the fit phase's."""
    from davo_tpu_torch.cli.main import main as cli_main

    undo = _refuse_plains(_train_plains(costvol, bandwarp))
    try:
        _reset_counts()
        rc = cli_main(["train", "--version", "davo", "--steps", str(steps), "--worlds", "2",
                       "--world-frames", "8", "--set", "train.log_every=1", *FUSED_TRAIN_SETS])
        torch.cuda.synchronize()
        counts = _train_counts(costvol, bandwarp)
    finally:
        undo()
    want = _want_counts(counts, FUSED_TRAIN_PER_STEP, steps)
    print(json.dumps({"phase": "fused_cli_train", "rc": rc, "steps": steps, "launches": counts}), flush=True)
    if rc != 0 or counts != want:
        raise AssertionError(f"fused cli train: rc {rc}, launches {counts}, want {want}")


def _loss_and_grads(torch, model, batch, cfg, device, step):
    from davo_tpu_torch.train import loop
    from davo_tpu_torch.train.losses import total_loss

    loop._apply_warp_config(cfg, torch.device(device))
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model.zero_grad(set_to_none=True)
    K = tb["K"] if cfg.model.pose_head == "geo_hybrid" else None
    out = model(tb["target"], tb["sources"], seg=tb["seg"], train=True, source_disp=True, K=K)
    loss, metrics = total_loss(out, tb, cfg.model, cfg.train, step=step)
    loss.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def train_gpu_against_cpu(torch, phase="train_gpu_vs_cpu", flags=None, chain_backward=None):
    """Phase 9: one train step's loss terms and gradients on the card
    against the port on the CPU: `davo` widths at 64x128 in float32,
    TF32 off, the same seeded parameters and batch, banded warp (4, 16)
    on both (kernels on the card, plain versions on the CPU), with the
    model `flags` set (9b: the fused training path, whose step on the
    card must launch the training chains' backward kernels; whether it
    must is `chain_backward`, by default whether flags are set).

    Gated on a batch of independent noise images. On a synthetic-world
    batch, whose frames are nearly alike, SSIM's (1 - s)/2 cancels: on
    the CPU alone, summing its 3x3 pools in another order moves the loss
    by 1e-4 and gradient leaves by up to 7e-3 of their largest (measured
    at this configuration), so there the comparison is recorded, not
    gated."""
    import dataclasses

    import numpy as np

    from davo_tpu_torch.data.snippets import MultiSourceDataset
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel

    from davo_tpu_torch.kernels import rowconv_ad

    cfg = presets.with_overrides("davo", img_height=64, img_width=128, compute_dtype="float32", **(flags or {}))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, warp_gather="banded", warp_band=BAND))
    world = SyntheticSequence(n_frames=5, height=64, width=128, seed=7)
    world_batch = next(
        MultiSourceDataset([world], batch_size=2, with_seg=True, augment=True, seed=1).batches(steps=1)
    )
    rng = np.random.default_rng(8)
    noise_batch = dict(world_batch)
    for key in ("target", "sources"):
        noise_batch[key] = rng.uniform(size=world_batch[key].shape).astype(np.float32)
    cpu = DavoModel(cfg.model, device="cpu", seed=0, dispnet=True)
    gpu = DavoModel(cfg.model, device="cuda", seed=0, dispnet=True)
    gpu.load_state_dict(cpu.state_dict())
    step = 125  # the depth warm-up gate half open
    for name, batch, gated in (("noise", noise_batch, True), ("world", world_batch, False)):
        want_m, want_g = _loss_and_grads(torch, cpu, batch, cfg, "cpu", step)
        rowconv_ad.reset_counts()
        got_m, got_g = _loss_and_grads(torch, gpu, batch, cfg, "cuda", step)
        backward_launches = sum(rowconv_ad.backward_launches.values())
        loss_err = {k: abs(got_m[k] - want_m[k]) / abs(want_m[k]) for k in want_m}
        grad_err = {n: float((got_g[n] - want_g[n]).abs().max()) / max(float(want_g[n].abs().max()), 1e-30)
                    for n in want_g}
        worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
        print(json.dumps({
            "phase": phase, "batch": name, "gated": gated, "flags": flags or {},
            "preset": "davo widths, 64x128, float32, B=2", "loss_terms": want_m,
            "rowconv_ad_backward_launches": backward_launches,
            "loss_rel_err": loss_err, "grad_leaves": len(grad_err), "worst_grad_rel_err": worst,
            "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
        }), flush=True)
        if gated and (max(loss_err.values()) > TRAIN_LOSS_TOL or worst[0][1] > TRAIN_GRAD_TOL):
            raise AssertionError(f"{phase}: loss {loss_err}, worst grads {worst}")
        if (bool(flags) if chain_backward is None else chain_backward) != (backward_launches > 0):
            raise AssertionError(f"{phase}: {backward_launches} training-chain backward launches on the card")


def _device_batch(torch, batch, reps):
    """A host batch tiled `reps` times along the batch axis, on the card."""
    import numpy as np

    return {k: torch.from_numpy(np.concatenate([v] * reps)).cuda() for k, v in batch.items()}


def _time_steps(torch, cfg, batch4, B):
    """(state, step_fn, batch, CUDA-event ms of 10 steps after 3 warm-ups)."""
    from davo_tpu_torch.train import loop

    state = loop.create_state(cfg, "cuda")
    step_fn = loop.make_train_step(cfg, "cuda")
    batch = _device_batch(torch, batch4, B // 4)
    for _ in range(3):
        step_fn(state, batch)
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = step_fn(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return state, step_fn, batch, times, float(metrics["total"])


def train_step_time(torch, card, batch4, phase="train_step_time", flags=None):
    """Phase 10: davo train-step time at B=4 and B=64 (median of 10 steps
    after 3 warm-up steps, CUDA events), peak memory, and device time by
    kernel of one B=64 step (torch.profiler); with the model `flags` set
    (10b: the fused training path, beside phase 10's unfused step)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from davo_tpu_torch.models import presets
    from davo_tpu_torch.train import loop

    base = presets.with_overrides("davo", **(flags or {}))
    results = {}
    for want_B in (4, 64):
        B = want_B
        while True:  # the largest power of two up to want_B that fits
            cfg = dataclasses.replace(base, train=dataclasses.replace(base.train, batch_size=B))
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                state, step_fn, batch, times, loss = _time_steps(torch, cfg, batch4, B)
                break
            except torch.cuda.OutOfMemoryError:
                B //= 2
                if B < 4:
                    raise
        results[want_B] = {
            "batch": B, "step_ms_median": statistics.median(times), "step_ms": times,
            "frames_per_s": B / statistics.median(times) * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "loss": loss,
        }
        print(json.dumps({"phase": phase, "flags": flags or {}, "requested_batch": want_B,
                          **results[want_B], "card": card}), flush=True)
        if not math.isfinite(loss):
            raise AssertionError(f"train step at B={B} gave a non-finite loss")
        if want_B == 4:
            del state, step_fn, batch

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted((
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    ours = {
        name: sum(ms for k, ms, _ in rows if part in k)
        for name, part in (("banded_warp", "banded_warp_fwd_kernel"),
                           ("banded_warp_backward", "banded_warp_bwd_"),
                           ("cost_volume_backward", "cost_volume_bwd_kernel"),
                           ("cost_volume", "cost_volume_kernel<"),
                           ("rowconv_tf32_layers", "conv_tf32_"),
                           ("rowconv_mma_layers", "conv_mma_"),
                           ("flow_level_input", "flow_level_input_kernel<"),
                           ("conv_layer_gate", "conv_gate_kernel"),
                           ("conv_layer_dgrad", "conv_dgrad_mma_kernel<"),
                           ("conv_layer_wgrad", "conv_wgrad_mma_kernel<"),
                           ("conv_layer_wgrad_reduce", "wgrad_reduce_kernel"),
                           ("flow_level_input_bwd", "flow_level_input_bwd_kernel<"))
    }
    ours = {k: {"ms": v, "share": v / device_ms} for k, v in ours.items()}
    # The backward conv kernels by variant (template instance).
    variants = {}
    for k, ms, n in rows:
        for part in ("conv_dgrad_mma_kernel<", "conv_wgrad_mma_kernel<"):
            if part in k:
                name = part + k.split(part, 1)[1].split(">", 1)[0] + ">"
                variants[name] = {"ms": variants.get(name, {}).get("ms", 0.0) + ms,
                                  "calls": variants.get(name, {}).get("calls", 0) + n}
    print(json.dumps({
        "phase": phase.replace("step_time", "profile"), "batch": results[64]["batch"], "device_ms": device_ms,
        "wall_ms": wall_ms, "device_busy_share": device_ms / wall_ms, "kernels_of_this_port": ours,
        "backward_conv_variants": variants,
        "top": [{"kernel": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:30]], "card": card,
    }), flush=True)
    return results, ours


# ---------------------------------------------------------------- the bench entry point

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "median", "spread_pct", "loops", "davo_preset_fps"}


def bench_entry(torch, card, phase6_fps):
    """Phase 11: `python -m davo_tpu_torch.bench` once, in a subprocess
    (davo-fast at B=256: bench.py's protocol and JSON line); its line is
    printed on a line of its own, then beside phase 6's frames/s for the
    same configuration. Then `bench_train_step(davo, batch=16)` once."""
    from davo_tpu_torch.bench import bench_train_step
    from davo_tpu_torch.models import presets

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "davo_tpu_torch.bench"], capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"python -m davo_tpu_torch.bench: rc {res.returncode}, stdout {res.stdout!r}, "
                             f"stderr {res.stderr[-2000:]!r}")
    line = json.loads(lines[-1])
    if set(line) != BENCH_KEYS or line["metric"] != "pose_infer_frames_per_s" or not all(
            math.isfinite(line[k]) and line[k] > 0 for k in ("value", "davo_preset_fps")):
        raise AssertionError(f"bench line {line}")
    print(lines[-1], flush=True)
    print(json.dumps({"phase": "bench", "bench_line": line, "seconds": seconds,
                      "phase6_frames_per_s_best": phase6_fps, "card": card}), flush=True)
    train = bench_train_step(presets.get("davo"), batch=16, device="cuda")
    print(json.dumps({"phase": "bench_train_step", "preset": "davo", **train, "card": card}), flush=True)
    if not math.isfinite(train["ms_per_step"]):
        raise AssertionError(f"bench_train_step: {train}")
    return line, train


# ---------------------------------------------------------------- the trajectory backend

BACKEND_POSE_TOL = 1e-6  # infer --ckpt against the checkpoint restored in memory; TUM round trip
BACKEND_BA_TOL = 1e-4    # the BA on the card against the BA on the CPU, of the largest translation


def _host_syncs(torch, fn) -> int:
    """Host syncs of `fn()`: the runtime calls that block the host until the
    device is done (a copy to or from pageable host memory makes one), as
    the profiler counts them, less those of profiling nothing."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def count(body):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            body()
        return sum(e.count for e in prof.key_averages() if any(n in e.key for n in names))

    return count(fn) - count(lambda: None)


def backend_path(torch, card, costvol, bandwarp):
    """Phase 12: the trajectory backend through `cli_main` on the card, in a
    temporary directory, at the `davo` preset, 128x416, on the CLI's
    synthetic worlds, every plain version refused: `train` (2 steps, a
    checkpoint), `infer --ckpt --tum --gt-out`, `depth --ckpt`, `eval
    --devkit`, `eval-depth` and `ba --ckpt --depth-dir` (flow tracks from
    the checkpoint's flow net), then `ba` on the world's exact flow and
    depth from a perturbed GT trajectory (tests/test_tracks.py's
    oracle-free case at this size), on the card and with `--device cpu`.

    Asserts each rc and each command's cost-volume launches (as reckoned
    below), the served poses against the same checkpoint restored in
    memory and the TUM file against them (1e-6 of the largest), the
    devkit against the Python segment errors, both refined trajectories
    finite and moved, and on the exact-flow `ba`: no window's Huber cost
    raised by its refine, the error to GT reduced, the CPU run (TF32 off)
    within 1e-4 of the largest translation. On the net-backed `ba` these
    are recorded, not held: a random-weight pose net's trajectory can
    put a window's two anchor poses (its gauge) a fraction of a
    millimetre apart, where scale is unobservable, and the damped
    Gauss-Newton of the reference, which the port keeps, has no step
    acceptance to stop a step that raises the cost. Times ba_refine per
    window of the net-backed run (CUDA events) and its device time and
    kernel launches (profiler), the flow-net calls and the whole `ba`,
    and counts host syncs per window."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from davo_tpu_torch.ba import gn, tracks
    from davo_tpu_torch.ba.window import window_starts
    from davo_tpu_torch.cli.main import main as cli_main
    from davo_tpu_torch.config import BAConfig
    from davo_tpu_torch.core import geometry as geo
    from davo_tpu_torch.data.kitti import parse_poses, write_poses_kitti
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.eval import tum
    from davo_tpu_torch.eval.runner import assemble_trajectory, make_pose_apply_fn, predict_sequence
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.train import loop

    cfg = presets.get("davo")
    m = cfg.model
    n_frames, batch, window, steps = 32, 32, 8, 2  # the CLI's world, its --batch-size and --window defaults
    levels = m.flow_levels - 1  # cost volumes per flow-net call (/16, /8, /4)
    starts = window_starts(n_frames, window, window // 2)
    pairs = {(i, i + 1) for st in starts for i in range(st, min(st + window, n_frames) - 1)}
    want_cv = {"infer": levels * -(-(n_frames - 1) // batch), "depth": levels * -(-n_frames // batch),
               "eval": 0, "eval-depth": 0, "ba": levels * 2 * len(pairs), "ba exact flow": 0,
               "ba exact flow, cpu": 0}
    ba_cfg = BAConfig(window_size=window, max_iterations=8, damping=1e-3, huber_delta=3.0)

    windows, flow_ms, flows = {}, [], {}
    real_refine, real_flow_fn = tracks.ba_refine, tracks.make_flow_fn

    def recording_refine(problem, c):
        before = float(gn.ba_cost(problem, c.huber_delta))
        out = real_refine(problem, c)
        windows.setdefault(current, []).append(
            {"problem": problem, "cost_before": before, "cost_after": float(gn.ba_cost(out, c.huber_delta))})
        return out

    def recording_flow_fn(model, frames):
        fn = real_flow_fn(model, frames)

        def timed(i, j):
            t0 = time.perf_counter()
            f = fn(i, j)  # ends in a copy to the host: the device has finished
            if (i, j) not in flows:
                flow_ms.append(1e3 * (time.perf_counter() - t0))
                flows[(i, j)] = f
            return f

        return timed

    world = SyntheticSequence(n_frames=n_frames, height=m.img_height, width=m.img_width, seed=1)
    rng = np.random.default_rng(0)
    noisy = world.poses.copy()
    for i in range(2, n_frames):  # the first window's anchors stay at GT
        noisy[i] = noisy[i] @ geo.se3_exp(torch.from_numpy(rng.normal(0, 0.01, 6))).numpy()

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        D, P, T, G, DEPTH, R, N, R2, R2C = (str(Path(tmp) / n) for n in (
            "ckpt", "p.txt", "p.tum", "g.txt", "depth", "r.txt", "noisy.txt", "r2.txt", "r2cpu.txt"))
        write_poses_kitti(N, noisy)
        exact = ["ba", "--version", "davo", "--seq", "1", "--pred", N]
        commands = [
            ("train", ["train", "--version", "davo", "--steps", str(steps), "--worlds", "2", "--world-frames", "8",
                       "--checkpoint-dir", D]),
            ("infer", ["infer", "--version", "davo", "--ckpt", D, "--seq", "1", "--out", P, "--tum", T,
                       "--gt-out", G]),
            ("depth", ["depth", "--version", "davo", "--ckpt", D, "--seq", "1", "--out", DEPTH]),
            ("eval", ["eval", "--gt", G, "--pred", P, "--devkit"]),
            ("eval-depth", ["eval-depth", "--depth-dir", DEPTH, "--seq", "1"]),
            ("ba", ["ba", "--version", "davo", "--ckpt", D, "--seq", "1", "--pred", P, "--depth-dir", DEPTH,
                    "--out", R]),
            ("ba exact flow", [*exact, "--out", R2]),
            ("ba exact flow, cpu", [*exact, "--out", R2C, "--device", "cpu"]),
        ]
        undo = _refuse_plains(_train_plains(costvol, bandwarp))
        tracks.ba_refine, tracks.make_flow_fn = recording_refine, recording_flow_fn
        try:
            for current, argv in commands:
                out = io.StringIO()
                _reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli_main(argv)
                torch.cuda.synchronize()
                results[current] = {"rc": rc, "seconds": time.perf_counter() - t0,
                                    "launches": _train_counts(costvol, bandwarp), "stdout": out.getvalue()}
        finally:
            undo()
            tracks.ba_refine, tracks.make_flow_fn = real_refine, real_flow_fn

        bad = {k: r["rc"] for k, r in results.items() if r["rc"] != 0}
        if bad:
            raise AssertionError(f"backend path: non-zero rc {bad}")
        train_want = _want_counts(results["train"]["launches"], {"cost_volume": 3, "cost_volume_backward": 3,
                                                                  "banded_warp": 16, "banded_warp_backward": 16}, steps)
        wrong = {k: r["launches"] for k, r in results.items()
                 if r["launches"] != (train_want if k == "train" else _want_counts(r["launches"], {"cost_volume": want_cv[k]}, 1))}
        if wrong:
            raise AssertionError(f"backend path launches {wrong}, want cost volumes {want_cv} and the train path's")

        # The served poses against the same checkpoint restored in memory.
        served = parse_poses(open(P).read())
        state = loop.restore_checkpoint(D, loop.create_state(cfg, "cuda"))
        frames = np.stack([world.frame(i) for i in range(n_frames)])
        seg = np.stack([world.seg(i) for i in range(n_frames)])
        memory = assemble_trajectory(predict_sequence(make_pose_apply_fn(state.model), frames, seg=seg,
                                                      batch_size=batch))
        serve_err = float(np.abs(served - memory).max())
        tum_err = float(np.abs(tum.parse_poses_tum(open(T).read())[1] - served).max())
        largest = float(np.abs(memory).max())
        report = json.loads(results["eval"]["stdout"])
        devkit_pairs = {k: (report[k], report[f"{k}_cpp"]) for k in ("t_err_pct", "r_err_deg_per_100m")}
        depth_report = json.loads(results["eval-depth"]["stdout"])
        refined = parse_poses(open(R).read())
        depths = np.stack([np.load(Path(DEPTH) / f"{i:06d}.npy") for i in range(n_frames)])
        exact_card, exact_cpu = parse_poses(open(R2).read()), parse_poses(open(R2C).read())

    # The net-backed BA again on the CPU, on the card run's flow fields.
    net_cpu = tracks.refine_trajectory_tracked(ba_cfg, served, depths, world.K, lambda i, j: flows[(i, j)],
                                               device="cpu")
    exact_err = float(np.abs(exact_cpu - exact_card).max())
    exact_largest_t = float(np.abs(exact_card[:, :3, 3]).max())
    gt_err = {name: float(np.linalg.norm(poses[2:, :3, 3] - world.poses[2:, :3, 3], axis=-1).mean())
              for name, poses in (("before", noisy), ("after", exact_card))}
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}

    # ba_refine per window of the net-backed run on the card; host syncs.
    net = windows["ba"]
    per_window_ms = [_event_ms(lambda w=w: gn.ba_refine(w["problem"], ba_cfg), 5) for w in net]
    refine_syncs = _host_syncs(torch, lambda: gn.ba_refine(net[0]["problem"], ba_cfg))
    refine_kernels, refine_device_ms, refine_wall_ms = _kernel_profile(
        torch, lambda: gn.ba_refine(net[0]["problem"], ba_cfg), 3, inference=False)
    path_syncs = _host_syncs(torch, lambda: tracks.refine_trajectory_tracked(
        ba_cfg, served, depths, world.K, lambda i, j: flows[(i, j)], device="cuda"))

    def costs(name):
        return {"before": [w["cost_before"] for w in windows[name]], "after": [w["cost_after"] for w in windows[name]]}

    def anchor_baselines(name):  # metres between each window's two anchor poses
        return [float(np.linalg.norm((np.linalg.inv(w["problem"].poses_cw[0].cpu().numpy())
                                      - np.linalg.inv(w["problem"].poses_cw[1].cpu().numpy()))[:3, 3]))
                for w in windows[name]]

    row = {
        "phase": "backend_path", "preset": "davo", "hw": [m.img_height, m.img_width], "frames": n_frames,
        "seconds": {k: r["seconds"] for k, r in results.items()},
        "cost_volume_launches": {k: r["launches"]["cost_volume"] for k, r in results.items()},
        "train_launches": results["train"]["launches"],
        "served_vs_memory_max_abs": serve_err, "tum_vs_served_max_abs": tum_err, "largest_pose_element": largest,
        "devkit_python_vs_cpp": devkit_pairs, "ate_full": report["ate_full"], "depth_metrics": depth_report,
        "net_ba": {"windows": len(net), "landmarks": [int(w["problem"].points_w.shape[0]) for w in net],
                   "observations": [int(w["problem"].mask.sum()) for w in net], "cost": costs("ba"),
                   "anchor_baseline_m": anchor_baselines("ba"),
                   "refined_vs_served_max_abs": float(np.abs(refined - served).max()),
                   "card_vs_cpu_max_abs": float(np.abs(net_cpu - refined).max()),
                   "largest_translation": float(np.abs(refined[:, :3, 3]).max())},
        "exact_flow_ba": {"windows": len(windows["ba exact flow"]), "cost": costs("ba exact flow"),
                          "anchor_baseline_m": anchor_baselines("ba exact flow"),
                          "card_vs_cpu_max_abs": exact_err, "largest_translation": exact_largest_t,
                          "gt_error_m": gt_err},
        "tf32": tf32,
        "ba_refine_ms_per_window": per_window_ms, "ba_refine_ms_median": statistics.median(per_window_ms),
        "ba_iterations": ba_cfg.max_iterations, "ba_command_s": results["ba"]["seconds"],
        "ba_refine_device_ms": refine_device_ms, "ba_refine_profiled_wall_ms": refine_wall_ms,
        "ba_refine_kernel_launches": sum(r[2] for r in refine_kernels),
        "ba_refine_top_kernels": [[k[:60], ms, n] for k, ms, n in refine_kernels[:5]],
        "flow_net_calls": len(flow_ms), "flow_net_ms_total": sum(flow_ms),
        "flow_net_ms_median": statistics.median(flow_ms),
        "host_syncs_ba_refine": refine_syncs, "host_syncs_per_window": path_syncs / len(net),
        "card": card,
    }
    print(json.dumps(row), flush=True)
    if serve_err > BACKEND_POSE_TOL * largest or tum_err > BACKEND_POSE_TOL * largest:
        raise AssertionError(f"infer --ckpt: served poses {serve_err}, TUM {tum_err} off (largest {largest})")
    for key, (py, cpp) in devkit_pairs.items():
        if math.isfinite(py) and math.isfinite(cpp) and not math.isclose(py, cpp, rel_tol=1e-5):
            raise AssertionError(f"eval --devkit: {key} python {py}, C++ {cpp}")
    for name, poses, start in (("ba", refined, served), ("ba exact flow", exact_card, noisy)):
        if not windows.get(name) or not np.isfinite(poses).all() or np.array_equal(poses, start):
            raise AssertionError(f"{name}: no window refined, or the trajectory is not finite or did not move")
    raised = [i for i, w in enumerate(windows["ba exact flow"]) if not w["cost_after"] <= w["cost_before"]]
    if raised or not gt_err["after"] < gt_err["before"]:
        raise AssertionError(f"ba exact flow: Huber cost raised in windows {raised}, GT error {gt_err}")
    if exact_err > BACKEND_BA_TOL * exact_largest_t or any(tf32.values()):
        raise AssertionError(f"ba: card against CPU {exact_err} (largest translation {exact_largest_t}), TF32 {tf32}")
    return {k: r["launches"]["cost_volume"] for k, r in results.items()}


# ------------------------------------------------------------- phase 13: options

OPTIONS_SCAN_TOL = 1e-6  # scan against per call, resumed against uninterrupted: of the largest element
GEO_SETS = ["--set", "model.pose_head=geo_hybrid"]


def _resize_fallbacks():
    """Count calls of the non-integer resize (`kernels.resize.resize_bilinear`,
    which `resize_bilinear_aligned` falls back to); returns (calls, undo)."""
    from davo_tpu_torch.kernels import resize

    real, calls = resize.resize_bilinear, []

    def counted(x, height, width):
        calls.append([list(x.shape[1:3]), [height, width], x.device.type])
        return real(x, height, width)

    resize.resize_bilinear = counted

    def undo():
        resize.resize_bilinear = real

    return calls, undo


def _card_and_cpu(torch, cfg, B, seed, with_k=False):
    """Poses (and pose_geo) of the same seeded model on the card
    and on the CPU, on one batch of the synthetic world's frames at cfg's
    size (with its camera K when `with_k`)."""
    import numpy as np

    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models.davo import DavoModel

    world = SyntheticSequence(n_frames=B + 1, height=cfg.img_height, width=cfg.img_width, seed=seed)
    x = torch.from_numpy(np.stack([world.frame(i + 1) for i in range(B)]))
    y = torch.from_numpy(np.stack([world.frame(i) for i in range(B)]))[:, None]
    s = torch.from_numpy(np.stack([world.seg(i + 1) for i in range(B)]).astype(np.int64))
    kw = {"K": torch.from_numpy(np.asarray(world.K, np.float32))} if with_k else {}
    cpu = DavoModel(cfg, device="cpu", seed=seed).eval()
    gpu = DavoModel(cfg, device="cuda", seed=seed).eval()
    with torch.inference_mode():
        want = cpu(x, y, seg=s, **kw)
        got = gpu(x.cuda(), y.cuda(), seg=s.cuda(), **{k: v.cuda() for k, v in kw.items()})
    errs = {}
    for key in ("poses", "pose_geo"):
        if key in want:
            scale = float(want[key].abs().max())
            errs[key] = {"max_rel_err": float((got[key].cpu() - want[key]).abs().max()) / scale, "largest": scale}
    return errs


def _geo_fps(torch, model, B, K, iters=5):
    """(best, median) forward frames/s at batch B, as `_forward_fps`, with
    the camera K passed (the geometric head needs it; the conv head
    ignores it)."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand(B, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    y = torch.rand(B, 1, cfg.img_height, cfg.img_width, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (B, cfg.img_height, cfg.img_width), device="cuda", generator=gen)
    times = []
    with torch.inference_mode():
        for _ in range(2):
            model(x, y, seg=s, K=K)
        torch.cuda.synchronize()
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x, y, seg=s, K=K)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        syncs = _host_syncs(torch, lambda: model(x, y, seg=s, K=K))
    return B * iters / min(times), B * iters / statistics.median(times), syncs


def options_path(torch, card, costvol, bandwarp, frames, seg, batch4):
    """Phase 13: the options the earlier slices refused, on the card, no
    plain version run where the card alone computes:
    - `davo-res` (the resnet DispNet encoder) at 128x416: `cli train` 2
      steps and `cli depth --ckpt` (launches asserted); one train step
      card against CPU (phase 9's criteria); its B=4 step time against
      `davo`'s on phase 8's batch (phase 10's protocol, in turns);
    - `davo` with pose_head=geo_hybrid: `cli train` 1 step, `cli infer
      --ckpt` on the CLI's 32-frame world (the sequence's K reaches the
      model) against the checkpoint restored in memory (1e-6 of the
      largest), and with the four serving flags; the forward card against
      CPU (64x128, float32: poses and pose_geo within 1e-4 of the
      largest); one train step card against CPU; forward frames/s and
      host syncs per forward against the conv head at B=64;
    - `davo-fast` with s2d_first_conv at B=64: poses against the plain
      first conv (float32, TF32 off, 1e-4 of the largest); the first pose
      conv alone, s2d against plain cuDNN, bf16 and float32;
    - scan-chunked serving: `cli infer --scan-chunks 4` against 1 on the
      CLI's world, and the main path's 257-frame world in 4 requests of
      64 through one scan call against 4 per-call requests (1e-6 of the
      largest increment), streaming frames/s in turns;
    - `resumable_predict_sequence`: a crash after 2 of 4 batches, then a
      resume, equal to an uninterrupted run and within 1e-6 of
      `predict_sequence`;
    - `davo` at 120x400, whose /16 -> /8 flow upsample (8x25 -> 15x50)
      takes the non-integer resize once a forward: card against CPU
      (float32, 1e-4 of the largest), the fallback's calls asserted.
    Returns the launch counts by command."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import numpy as np

    from davo_tpu_torch.cli.main import main as cli_main
    from davo_tpu_torch.data.kitti import parse_poses
    from davo_tpu_torch.data.synthetic import SyntheticSequence
    from davo_tpu_torch.models.common import ConvBlock, lecun_init_
    from davo_tpu_torch.eval.resumable import EvalCursor, params_fingerprint, resumable_predict_sequence
    from davo_tpu_torch.eval.runner import (
        assemble_trajectory,
        make_pose_apply_fn,
        make_pose_apply_scan_fn,
        predict_sequence,
    )
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel
    from davo_tpu_torch.train import loop

    t_phase = time.perf_counter()
    train_step = {"cost_volume": 3, "cost_volume_backward": 3, "banded_warp": 16, "banded_warp_backward": 16}
    results, timings = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        R, DEPTH, G, P, PF, S1, S4 = (str(Path(tmp) / n) for n in (
            "res_ckpt", "depth", "geo_ckpt", "p.txt", "pf.txt", "s1.txt", "s4.txt"))
        world_args = ["--worlds", "2", "--world-frames", "8"]
        commands = [
            ("davo-res train", ["train", "--version", "davo-res", "--steps", "2", *world_args, "--checkpoint-dir", R],
             {k: 2 * v for k, v in train_step.items()}),
            ("davo-res depth", ["depth", "--version", "davo-res", "--ckpt", R, "--seq", "1", "--out", DEPTH],
             {"cost_volume": 3}),
            ("geo_hybrid train", ["train", "--version", "davo", *GEO_SETS, "--steps", "1", *world_args,
                                  "--checkpoint-dir", G], train_step),
            ("geo_hybrid infer", ["infer", "--version", "davo", *GEO_SETS, "--ckpt", G, "--seq", "1", "--out", P],
             {"cost_volume": 3}),
            # davo's three flow levels fused, and the pyramid, attention and
            # pose prefixes as strided chains; DispNet (the geometric head's
            # depth) unfused.
            ("geo_hybrid infer, serving flags", ["infer", "--version", "davo", *GEO_SETS, *FUSED_SETS, "--ckpt", G,
                                                 "--seq", "1", "--out", PF],
             {"serving_flow_level_fused": 3, "serving_conv_chain_strided": 3, "flow_level_input": 3}),
            # 31 pairs in batches of 8: 4 forwards of davo-fast's 2 flow levels.
            ("scan infer, 1 a call", ["infer", "--version", "davo-fast", "--seq", "1", "--out", S1,
                                      "--batch-size", "8", "--scan-chunks", "1"], {"cost_volume": 8}),
            ("scan infer, 4 a call", ["infer", "--version", "davo-fast", "--seq", "1", "--out", S4,
                                      "--batch-size", "8", "--scan-chunks", "4"], {"cost_volume": 8}),
        ]
        undo = _refuse_plains(_train_plains(costvol, bandwarp))
        try:
            for name, argv, _ in commands:
                _reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli_main(argv)
                torch.cuda.synchronize()
                results[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                                 "launches": _train_counts(costvol, bandwarp)}
        finally:
            undo()
        bad = {k: r["rc"] for k, r in results.items() if r["rc"] != 0}
        if bad:
            raise AssertionError(f"options path: non-zero rc {bad}")
        wrong = {name: results[name]["launches"] for name, _, per in commands
                 if results[name]["launches"] != _want_counts(results[name]["launches"], per, 1)}
        served, fused_served = parse_poses(open(P).read()), parse_poses(open(PF).read())
        scan1, scan4 = parse_poses(open(S1).read()), parse_poses(open(S4).read())
        depth_files = sorted(Path(DEPTH).iterdir())
        # The served geo_hybrid poses against the checkpoint restored in memory, with K.
        gcfg = presets.with_overrides("davo", pose_head="geo_hybrid")
        state = loop.restore_checkpoint(G, loop.create_state(gcfg, "cuda"))
        world = SyntheticSequence(n_frames=32, height=gcfg.model.img_height, width=gcfg.model.img_width, seed=1)
        wframes = np.stack([world.frame(i) for i in range(32)])
        wseg = np.stack([world.seg(i) for i in range(32)])
        memory = assemble_trajectory(predict_sequence(make_pose_apply_fn(state.model, K=world.K), wframes,
                                                      seg=wseg, batch_size=32))
    print(json.dumps({"phase": "options_cli", "commands": {
        k: {"rc": r["rc"], "seconds": r["seconds"], "launches": {a: b for a, b in r["launches"].items()
                                                                  if b and a != "device_launches"}}
        for k, r in results.items()}, "card": card}), flush=True)
    if wrong:
        raise AssertionError(f"options path launches {wrong}")
    largest = float(np.abs(memory).max())
    checks = {
        "geo_infer_vs_memory": float(np.abs(served - memory).max()) / largest,
        "geo_infer_fused_vs_unfused_max_abs": float(np.abs(fused_served - served).max()),
        "scan4_vs_scan1": float(np.abs(scan4 - scan1).max()) / float(np.abs(scan1).max()),
        "depth_maps": len(depth_files),
    }
    if not (np.isfinite(served).all() and np.isfinite(fused_served).all() and served.shape == (32, 4, 4)):
        raise AssertionError("geo_hybrid infer: poses not finite (32, 4, 4)")
    if checks["geo_infer_vs_memory"] > BACKEND_POSE_TOL or checks["scan4_vs_scan1"] > OPTIONS_SCAN_TOL:
        raise AssertionError(f"options CLI: {checks}")
    if checks["depth_maps"] != 32:
        raise AssertionError(f"davo-res depth wrote {checks['depth_maps']} maps, not 32")
    del state
    torch.cuda.empty_cache()

    # Card against CPU: the geo_hybrid forward and both train steps.
    geo_cfg = presets.with_overrides("davo", img_height=64, img_width=128, compute_dtype="float32",
                                     pose_head="geo_hybrid").model
    geo_errs = _card_and_cpu(torch, geo_cfg, 4, 21, with_k=True)
    print(json.dumps({"phase": "options_geo_gpu_vs_cpu", "preset": "davo widths, 64x128, float32, geo_hybrid",
                      "errors": geo_errs, "tf32": [torch.backends.cuda.matmul.allow_tf32,
                                                   torch.backends.cudnn.allow_tf32]}), flush=True)
    if any(not (e["largest"] > 0 and e["max_rel_err"] <= PORT_TOL) for e in geo_errs.values()):
        raise AssertionError(f"geo_hybrid card vs CPU: {geo_errs}")
    train_gpu_against_cpu(torch, "options_geo_train_gpu_vs_cpu", {"pose_head": "geo_hybrid"}, chain_backward=False)
    train_gpu_against_cpu(torch, "options_res_train_gpu_vs_cpu", {"disp_encoder": "resnet"}, chain_backward=False)
    step_ms = {"davo": [], "davo-res": []}
    for name in ("davo", "davo-res", "davo-res", "davo"):
        times = _time_steps(torch, presets.get(name), batch4, 4)[3]
        step_ms[name].append(statistics.median(times))
    print(json.dumps({"phase": "options_res_step_time", "batch": 4, "median_ms_in_turns": step_ms,
                      "card": card}), flush=True)
    torch.cuda.empty_cache()

    # davo at 120x400: the /16 -> /8 flow upsample takes the non-integer resize.
    odd_cfg = presets.with_overrides("davo", img_height=120, img_width=400, compute_dtype="float32").model
    calls, undo = _resize_fallbacks()
    try:
        odd_errs = _card_and_cpu(torch, odd_cfg, 2, 22)
    finally:
        undo()
    print(json.dumps({"phase": "options_odd_size_gpu_vs_cpu", "preset": "davo widths, 120x400, float32",
                      "errors": odd_errs, "resize_fallbacks": calls}), flush=True)
    # One call on the CPU's forward, then one on the card's.
    if calls != [[[8, 25], [15, 50], "cpu"], [[8, 25], [15, 50], "cuda"]] or odd_errs["poses"]["max_rel_err"] > PORT_TOL:
        raise AssertionError(f"davo 120x400: fallbacks {calls}, errors {odd_errs}")

    # The geometric head against the conv head: forward frames/s, host syncs.
    batch = 64
    K = torch.from_numpy(np.asarray(world.K, np.float32)).cuda()
    heads = {}
    for name in ("conv", "geo_hybrid"):
        heads[name] = DavoModel(presets.with_overrides("davo", pose_head=name).model, device="cuda", seed=0).eval()
    fps = {"conv": [], "geo_hybrid": []}
    for name in ("conv", "geo_hybrid", "geo_hybrid", "conv"):
        best, median, syncs = _geo_fps(torch, heads[name], batch, K)
        fps[name].append({"best": best, "median": median, "host_syncs_per_forward": syncs})
    del heads
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "options_geo_throughput", "preset": "davo", "batch": batch,
                      "frames_per_s": fps, "card": card}), flush=True)

    # s2d_first_conv on davo-fast at B=64.
    gen = torch.Generator(device="cuda").manual_seed(14)
    fast32 = presets.with_overrides("davo-fast", compute_dtype="float32").model
    hw = (fast32.img_height, fast32.img_width)
    x = torch.rand(batch, *hw, 3, device="cuda", generator=gen)
    y = torch.rand(batch, 1, *hw, 3, device="cuda", generator=gen)
    s = torch.randint(0, 19, (batch, *hw), device="cuda", generator=gen)
    plain = DavoModel(fast32, device="cuda", seed=0).eval()
    s2d = DavoModel(dataclasses.replace(fast32, s2d_first_conv=True), device="cuda", seed=0).eval()
    undo = _refuse_plains(_train_plains(costvol, bandwarp))
    try:
        _reset_counts()
        with torch.inference_mode():
            want, got = plain(x, y, seg=s)["poses"], s2d(x, y, seg=s)["poses"]
        torch.cuda.synchronize()
        s2d_launches = costvol.launches
    finally:
        undo()
    s2d_err = float((got - want).abs().max()) / float(want.abs().max())
    del plain, s2d
    conv_ms = {}
    pair = torch.rand(batch, *hw, 9, device="cuda", generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        for flag in (False, True):
            block = lecun_init_(ConvBlock(9, 16, 7, 2, dtype, s2d=flag), torch.Generator().manual_seed(0))
            block = block.cuda()
            with torch.inference_mode():
                conv_ms[f"{str(dtype).split('.')[-1]} {'s2d' if flag else 'plain cuDNN'}"] = _graph_ms(
                    lambda b=block: b(pair))
    print(json.dumps({"phase": "options_s2d", "preset": f"davo-fast, float32, B={batch}",
                      "max_rel_err_vs_plain": s2d_err, "costvol_launches": s2d_launches,
                      "first_pose_conv_device_ms": conv_ms, "shape": list(pair.shape), "card": card}), flush=True)
    if s2d_err > PORT_TOL or s2d_launches != 4:  # two forwards of two flow levels
        raise AssertionError(f"s2d_first_conv: rel err {s2d_err}, {s2d_launches} cost-volume launches")
    del x, y, s, pair
    torch.cuda.empty_cache()

    # Scan-chunked streaming and the resumable evaluation on the main path's world.
    fast = DavoModel(presets.get("davo-fast").model, device="cuda", seed=0).eval()
    per_call, scan = make_pose_apply_fn(fast), make_pose_apply_scan_fn(fast)
    undo = _refuse_plains(_train_plains(costvol, bandwarp))
    try:
        _reset_counts()
        rels1 = predict_sequence(per_call, frames, seg=seg, batch_size=64)
        rels4 = predict_sequence(scan, frames, seg=seg, batch_size=64, scan_chunks=4)
        torch.cuda.synchronize()
        scan_launches = costvol.launches
        stream_s = {"1": [], "4": []}
        for chunks in (1, 4, 4, 1):
            t0 = time.perf_counter()
            predict_sequence(scan if chunks > 1 else per_call, frames, seg=seg, batch_size=64, scan_chunks=chunks)
            torch.cuda.synchronize()
            stream_s[str(chunks)].append(time.perf_counter() - t0)
        sub = frames[:65]
        stamp = params_fingerprint(fast)
        with tempfile.TemporaryDirectory() as tmp:
            cursor_path = str(Path(tmp) / "cursor.json")
            try:
                resumable_predict_sequence(per_call, sub, EvalCursor(cursor_path), "seq", seg=seg[:65], batch_size=16,
                                           crash_after_batches=2, fingerprint=stamp)
                raise AssertionError("resumable: the injected fault did not fire")
            except RuntimeError as e:
                if "injected fault" not in str(e):
                    raise
            crashed_at = EvalCursor(cursor_path).next_pair("seq")
            resumed = resumable_predict_sequence(per_call, sub, EvalCursor(cursor_path), "seq", seg=seg[:65],
                                                 batch_size=16, fingerprint=stamp)
            whole = resumable_predict_sequence(per_call, sub, EvalCursor(str(Path(tmp) / "whole.json")), "seq",
                                               seg=seg[:65], batch_size=16, fingerprint=stamp)
        direct = predict_sequence(per_call, sub, seg=seg[:65], batch_size=16)
    finally:
        undo()
    del fast
    scan_err = float(np.abs(rels4 - rels1).max()) / float(np.abs(rels1).max())
    resume_err = float(np.abs(resumed - direct).max()) / float(np.abs(direct).max())
    print(json.dumps({
        "phase": "options_scan_and_resume", "preset": "davo-fast", "frames": len(frames), "batch": 64,
        "scan_chunks": 4, "costvol_launches": scan_launches, "scan_vs_per_call": scan_err,
        "stream_s": stream_s, "frames_per_s_median": {k: (len(frames) - 1) / statistics.median(v)
                                                       for k, v in stream_s.items()},
        "resume": {"frames": len(sub), "batch": 16, "crashed_at_pair": crashed_at,
                   "resumed_equals_uninterrupted": bool(np.array_equal(resumed, whole)),
                   "resumed_vs_predict_sequence": resume_err},
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }), flush=True)
    if scan_err > OPTIONS_SCAN_TOL or scan_launches != 2 * 2 * 4:
        raise AssertionError(f"scan serving: rel err {scan_err}, {scan_launches} cost-volume launches")
    if crashed_at != 32 or not np.array_equal(resumed, whole) or resume_err > OPTIONS_SCAN_TOL:
        raise AssertionError(f"resumable: crashed at {crashed_at}, resumed vs predict_sequence {resume_err}")
    return {k: r["launches"] for k, r in results.items()}


# ------------------------------------------------------------- phase 14: real data

DATA_SEQS = ("00", "01")
DATA_FRAMES = 8                # frames per sequence: cut from KITTI's thousands, not the size
DATA_HW = (376, 1241)          # KITTI odometry's image_2
SEG_F32_AGREE = 0.999          # SegNet labels, card against CPU in float32 (TF32 off): share of equal pixels
SEG_BF16_AGREE = 0.95          # the same in bf16, the checkpoint's mode: near-tied logits flip with rounding
# Launches of one image summary (train/summaries.py): a training forward
# (3 cost volumes) and one projective warp of source 0 (the banded gather).
SUMMARY_LAUNCHES = {"cost_volume": 3, "banded_warp": 1}


@contextlib.contextmanager
def _float64_program(torch):
    """Run the port's float32 training program in float64 on the CPU: a
    reference for how far float32 lands from exact arithmetic. The
    model's compute dtype "float64", and the forward's and the losses'
    explicit float32 (`.float()`, `.to(torch.float32)`, float32 zeros and
    ones, einsum operands, the default dtype) go to float64 while it is
    open."""
    from davo_tpu_torch.models import common

    real = (torch.Tensor.float, torch.Tensor.to, torch.einsum, torch.zeros, torch.ones)

    def to(self, *a, **k):
        if a and a[0] is torch.float32:
            a = (torch.float64,) + a[1:]
        if k.get("dtype") is torch.float32:
            k = {**k, "dtype": torch.float64}
        return real[1](self, *a, **k)

    def dtype64(fn):
        def make(*a, **k):
            return fn(*a, **({**k, "dtype": torch.float64} if k.get("dtype") is torch.float32 else k))
        return make

    common._DTYPES["float64"] = torch.float64
    torch.Tensor.float, torch.Tensor.to = (lambda self, *a, **k: self.double()), to
    torch.einsum = lambda eq, *ops: real[2](eq, *[o.double() if o.is_floating_point() else o for o in ops])
    torch.zeros, torch.ones = dtype64(real[3]), dtype64(real[4])
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to, torch.einsum, torch.zeros, torch.ones = real
        torch.set_default_dtype(torch.float32)
        del common._DTYPES["float64"]


def _nonzero(counts):
    """A launch-count dict without its zeros."""
    return {k: v for k, v in counts.items() if v and k != "device_launches"}


def _render_kitti_frame(job):
    """Frame i of sequence `seq`'s DriveSequence as image_2 and seg PNGs
    (a host-only worker: spawned, it never touches the card)."""
    import numpy as np

    from davo_tpu_torch.data import imageio
    from davo_tpu_torch.data.synthetic import DriveSequence

    root, seq, seed, i = job
    world = DriveSequence(n_frames=DATA_FRAMES, height=DATA_HW[0], width=DATA_HW[1], seed=seed)
    d = Path(root) / "sequences" / seq
    imageio.imwrite_png(str(d / "image_2" / f"{i:06d}.png"), np.round(world.frame(i) * 255).astype(np.uint8))
    imageio.imwrite_png(str(d / "seg" / f"{i:06d}.png"), world.seg(i).astype(np.uint8))


def _write_kitti_root(root):
    """A KITTI odometry root: image_2 and seg/ PNGs rendered in spawned
    worker processes, calib.txt (P2 = [K | 0]), times.txt, poses/NN.txt."""
    import multiprocessing
    import os

    import numpy as np

    from davo_tpu_torch.data.kitti import write_poses_kitti
    from davo_tpu_torch.data.synthetic import DriveSequence

    jobs = []
    for k, seq in enumerate(DATA_SEQS):
        world = DriveSequence(n_frames=DATA_FRAMES, height=DATA_HW[0], width=DATA_HW[1], seed=20 + k)
        d = Path(root) / "sequences" / seq
        (d / "image_2").mkdir(parents=True)
        (d / "seg").mkdir()
        P = np.concatenate([np.asarray(world.K, np.float64), np.zeros((3, 1))], axis=1)
        (d / "calib.txt").write_text("".join(f"P{c}: " + " ".join(f"{v:.12e}" for v in P.ravel()) + "\n"
                                             for c in range(4)))
        np.savetxt(d / "times.txt", np.arange(DATA_FRAMES) * 0.1)
        (Path(root) / "poses").mkdir(exist_ok=True)
        write_poses_kitti(str(Path(root) / "poses" / f"{seq}.txt"), np.asarray(world.poses))
        jobs += [(root, seq, 20 + k, i) for i in range(DATA_FRAMES)]
    with multiprocessing.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 4)) as pool:
        pool.map(_render_kitti_frame, jobs)


def data_path(torch, card, costvol, bandwarp, synthetic_prefetch):
    """Phase 14: training on real data, through the CLI at `davo`'s full
    size (128x416, B=4, TrainConfig defaults, attention flow_seg fed by
    the port's own SegNetLite labels), in a temporary directory, no plain
    version run.

    A KITTI odometry root of two DriveSequence worlds at 376x1241 (8
    frames each) is prepared by `prep --dataset kitti_odom` as a process
    of its own with 4 host-only workers; `train-seg` (20 steps at
    128x416) and `prep --write-seg` label the prepared targets on the
    card. The Python reader and the native loader must give equal arrays
    item for item (one codec; the CPU tests hold it against OpenCV);
    batches/s of each at B=4 and B=64 (a split of the train names six
    times over). `train --data <prepared> --loader native --log-dir
    --set train.image_every=2` for 5 steps: launches 3/3/16/16 per step
    (#1/#1b/#3/#4) plus SUMMARY_LAUNCHES per image summary (2), 5 lines
    of metrics.jsonl, 5 panels per summary, the median step ms and the
    prefetch host share beside phase 8's. One train step card against
    CPU on a prepared batch (B=2 of it, float32, TF32 off): loss terms
    within TRAIN_LOSS_TOL; gradients no further from a float64 CPU run of
    the same program than twice the CPU float32's distance, or
    TRAIN_GRAD_TOL (see below). `train` 2 steps from the KITTI root and `infer --data
    <root> --seq 01 --ckpt`: one pose per frame, 3 cost volumes per
    forward. SegNet's labels of the prepared targets, card against CPU
    (SEG_F32_AGREE, SEG_BF16_AGREE), its train step ms (B=8, CUDA
    events) and labels/s (B=16 calls, host clock)."""
    import contextlib
    import dataclasses
    import io
    import re
    import tempfile

    import numpy as np
    import torch.nn.functional as F

    from davo_tpu_torch.cli.main import main as cli_main
    from davo_tpu_torch.config import Config, TrainConfig
    from davo_tpu_torch.data.native_loader import NativeSnippetLoader
    from davo_tpu_torch.data.prep import PreparedSnippets
    from davo_tpu_torch.models import presets
    from davo_tpu_torch.models.davo import DavoModel
    from davo_tpu_torch.models.segnet import SegNetLite, load_segnet, make_seg_infer
    from davo_tpu_torch.train import loop, summaries

    t_phase = time.perf_counter()
    report, counts = {"card": card}, {}

    def cli(label, argv):
        out = io.StringIO()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        report[f"{label}_s"] = time.perf_counter() - t0
        counts[label] = _train_counts(costvol, bandwarp)
        if rc != 0:
            raise AssertionError(f"data path: {label} returned {rc}")
        return out.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        root, prepared, seg_dir, logs, ckpt = (str(Path(tmp) / n) for n in ("kitti", "prepared", "seg", "logs", "ck"))
        t0 = time.perf_counter()
        _write_kitti_root(root)
        report["render_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "davo_tpu_torch.cli.main", "prep", "--dataset", "kitti_odom", "--root", root,
             "--out", prepared, "--seqs", ",".join(DATA_SEQS), "--num-workers", "4"],
            capture_output=True, text=True, timeout=600, cwd=str(Path(__file__).resolve().parent),
        )
        report["prep_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"prep exited {proc.returncode}: {proc.stderr[-2000:]}")
        names = [n for split in ("train", "val") for n in (Path(prepared) / f"{split}.txt").read_text().split()]
        report.update(prep_stdout=proc.stdout.strip(), snippets=len(names),
                      prep_s_per_snippet=report["prep_s"] / len(names))
        if len(names) != len(DATA_SEQS) * (DATA_FRAMES - 2):
            raise AssertionError(f"prep wrote {len(names)} snippets")

        undo = _refuse_plains(_train_plains(costvol, bandwarp))
        real_make_step, real_make_summary = loop.make_train_step, summaries.make_summary_fn
        step_s, summary_counts = [], []
        try:
            seg_out = cli("train_seg", ["train-seg", "--checkpoint-dir", seg_dir, "--steps", "20"])
            report["segnet_metrics"] = json.loads(seg_out.strip().splitlines()[-1])
            out = cli("write_seg", ["prep", "--out", prepared, "--write-seg", "--seg-ckpt", seg_dir, "--overwrite-seg"])
            if f"wrote {len(names)} seg maps" not in out:
                raise AssertionError(f"write-seg: {out}")

            # The two readers, item for item, then their rates.
            py = PreparedSnippets(prepared)
            native = NativeSnippetLoader(prepared, batch_size=4, shuffle=False, loop=False)
            worst = {}
            for bi, batch in enumerate(native.batches()):
                for k in range(4):
                    item = py.load(py.names[bi * 4 + k])
                    for key, want in item.items():
                        worst[key] = max(worst.get(key, 0.0), float(np.abs(batch[key][k] - want).max()))
            native.close()
            report["readers_max_abs_diff"] = worst
            if set(worst) != {"target", "sources", "K", "seg", "gt_pose"} or any(worst.values()):
                raise AssertionError(f"native loader against the Python reader: {worst}")
            (Path(prepared) / "bench.txt").write_text("\n".join(py.names * 6) + "\n")
            rates = {}
            for B, n in ((4, 20), (64, 4)):
                nl = NativeSnippetLoader(prepared, split="bench", batch_size=B, seed=1)
                it = nl.batches()
                next(it)
                t0 = time.perf_counter()
                for _ in range(n):
                    next(it)
                rates[f"native_B{B}"] = n / (time.perf_counter() - t0)
                nl.close()
                it = PreparedSnippets(prepared, split="bench", seed=1).batches(B)
                next(it)
                t0 = time.perf_counter()
                for _ in range(max(n // 4, 1)):
                    next(it)
                rates[f"python_B{B}"] = max(n // 4, 1) / (time.perf_counter() - t0)
            report["batches_per_s"] = rates

            # Training on the prepared tree: per-step host time and the
            # summaries' launches, recorded around the loop's own calls.
            def timed_make_step(cfg, device=None):
                fn = real_make_step(cfg, device)

                def step(state, batch):
                    t0 = time.perf_counter()
                    result = fn(state, batch)
                    torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t0)
                    return result

                return step

            def counted_make_summary(model, cfg):
                fn = real_make_summary(model, cfg)

                def summarize(batch):
                    before = _counts(costvol, bandwarp)
                    panels = fn(batch)
                    summary_counts.append({k: v - before[k] for k, v in _counts(costvol, bandwarp).items()})
                    return panels

                return summarize

            loop.make_train_step, summaries.make_summary_fn = timed_make_step, counted_make_summary
            out = cli("train_prepared", ["train", "--version", "davo", "--data", prepared, "--loader", "native",
                                         "--steps", "5", "--log-dir", logs, "--set", "train.image_every=2",
                                         "--set", "train.log_every=1"])
            loop.make_train_step, summaries.make_summary_fn = real_make_step, real_make_summary
            prefetch = json.loads(re.search(r"prefetch: (\{.*\})", out).group(1).replace("'", '"'))
            jsonl = (Path(logs) / "metrics.jsonl").read_text().splitlines()
            panels = sorted(p.name for p in (Path(logs) / "images").iterdir())
            report["train_prepared"] = {
                "input_pipeline_native": "input pipeline: native C++ loader" in out,
                "launches": _nonzero(counts["train_prepared"]), "summary_launches": summary_counts,
                "metrics_lines": len(jsonl), "panels": len(panels),
                "tensorboard_events": any(p.name.startswith("events.") for p in Path(logs).iterdir()),
                "step_ms": [1e3 * t for t in step_s], "median_step_ms": 1e3 * statistics.median(step_s),
                "median_step_ms_after_first": 1e3 * statistics.median(step_s[1:]),
                "prefetch": prefetch, "synthetic_prefetch_phase8": synthetic_prefetch,
                "last_metrics": json.loads(jsonl[-1]) if jsonl else None,
            }
            want = _want_counts(counts["train_prepared"], {"cost_volume": 3, "cost_volume_backward": 3,
                                                           "banded_warp": 16, "banded_warp_backward": 16}, 5)
            for k, v in SUMMARY_LAUNCHES.items():
                want[k] += 2 * v
            want_summary = {k: SUMMARY_LAUNCHES.get(k, 0) for k in _counts(costvol, bandwarp)}
            if (counts["train_prepared"] != want or summary_counts != [want_summary] * 2
                    or not report["train_prepared"]["input_pipeline_native"]
                    or len(jsonl) != 5 or len(panels) != 10 or len(step_s) != 5):
                print(json.dumps({"phase": "data_path", **report}), flush=True)
                raise AssertionError(f"data path train: launches {counts['train_prepared']} (want {want}), "
                                     f"summaries {summary_counts}, {len(jsonl)} metrics lines, {len(panels)} panels")

            # From the KITTI root: train 2 steps, then serve sequence 01.
            cli("train_kitti_root", ["train", "--version", "davo", "--data", root, "--seq", "00", "--steps", "2",
                                     "--checkpoint-dir", ckpt])
            poses_path = str(Path(tmp) / "poses.txt")
            cli("infer_kitti_root", ["infer", "--version", "davo", "--data", root, "--seq", "01", "--ckpt", ckpt,
                                     "--out", poses_path])
            poses = np.loadtxt(poses_path)
        finally:
            undo()
            loop.make_train_step, summaries.make_summary_fn = real_make_step, real_make_summary
        root_want = _want_counts(counts["train_kitti_root"], {"cost_volume": 3, "cost_volume_backward": 3,
                                                              "banded_warp": 16, "banded_warp_backward": 16}, 2)
        infer_want = _want_counts(counts["infer_kitti_root"], {"cost_volume": 3}, 1)
        report["kitti_root"] = {"train_launches": _nonzero(counts["train_kitti_root"]),
                                "infer_launches": _nonzero(counts["infer_kitti_root"]), "poses": list(poses.shape)}
        if (counts["train_kitti_root"] != root_want or counts["infer_kitti_root"] != infer_want
                or poses.shape != (DATA_FRAMES, 12) or not np.isfinite(poses).all()):
            print(json.dumps({"phase": "data_path", **report}), flush=True)
            raise AssertionError(f"KITTI root: {report['kitti_root']}")

        # One train step on a prepared batch, card against CPU: the loss
        # terms by phase 9's criterion (TRAIN_LOSS_TOL). The gradients: at
        # 128x416 float32 lands ~2.6e-3 of a DispNet leaf's largest from
        # exact arithmetic (the CPU's own float32 against its float64 run
        # of the same program, on the H100 machine's host), so no float32
        # program meets TRAIN_GRAD_TOL against another here. They are held against the
        # float64 run instead: the card's worst leaf no further from it
        # than twice the CPU float32's worst, or TRAIN_GRAD_TOL.
        reader = NativeSnippetLoader(prepared, batch_size=4, shuffle=False, loop=False)
        first = next(reader.batches())
        reader.close()
        batch2 = {k: v[:2] for k, v in first.items()}
        cfg = presets.with_overrides("davo", compute_dtype="float32")
        cfg = Config(model=cfg.model, train=TrainConfig(batch_size=2, warp_gather="banded", warp_band=BAND))
        cpu = DavoModel(cfg.model, device="cpu", seed=0, dispnet=True)
        gpu = DavoModel(cfg.model, device="cuda", seed=0, dispnet=True)
        gpu.load_state_dict(cpu.state_dict())
        t0 = time.perf_counter()
        want_m, want_g = _loss_and_grads(torch, cpu, batch2, cfg, "cpu", 125)
        got_m, got_g = _loss_and_grads(torch, gpu, batch2, cfg, "cuda", 125)
        with _float64_program(torch):
            cfg64 = Config(model=dataclasses.replace(cfg.model, compute_dtype="float64"), train=cfg.train)
            cpu64 = DavoModel(cfg64.model, device="cpu", seed=0, dispnet=True).double()
            cpu64.load_state_dict({k: v.double() for k, v in cpu.state_dict().items()})
            batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch2.items()}
            _, exact_g = _loss_and_grads(torch, cpu64, batch64, cfg64, "cpu", 125)

        def rel(a, b):
            return {n: float((a[n].double() - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30) for n in b}

        loss_err = {k: abs(got_m[k] - want_m[k]) / abs(want_m[k]) for k in want_m}
        grad_err, card64, cpu64_err = rel(got_g, want_g), rel(got_g, exact_g), rel(want_g, exact_g)
        worst = {name: max(e.items(), key=lambda kv: kv[1])
                 for name, e in (("card_vs_cpu", grad_err), ("card_vs_float64", card64), ("cpu_vs_float64", cpu64_err))}
        grad_limit = max(2 * worst["cpu_vs_float64"][1], TRAIN_GRAD_TOL)
        report["gpu_vs_cpu"] = {"batch": "prepared, B=2 of the first native batch, 128x416, float32, TF32 off",
                                "loss_rel_err": loss_err, "worst_grad_rel_err": worst,
                                "card_vs_cpu_top5": sorted(grad_err.items(), key=lambda kv: -kv[1])[:5],
                                "grad_limit_vs_float64": grad_limit, "seconds": time.perf_counter() - t0}
        del cpu, gpu, cpu64

        # SegNet: labels card against CPU, step ms, labels/s.
        targets = first["target"]
        agree = {}
        for mode in ("float32", "bfloat16"):
            labels = {}
            for dev in ("cuda", "cpu"):
                loaded = load_segnet(seg_dir, dev)
                model = SegNetLite(num_classes=loaded.num_classes, channels=loaded.channels,
                                   compute_dtype=mode, device=dev)
                model.load_state_dict(loaded.state_dict())
                with torch.inference_mode():
                    labels[dev] = model.eval()(torch.from_numpy(targets).to(dev)).argmax(-1).cpu().numpy()
            agree[mode] = float((labels["cuda"] == labels["cpu"]).mean())
        seg_model = load_segnet(seg_dir, "cuda").train()
        from davo_tpu_torch.train.loop import AdamTx

        tx = AdamTx(Config(train=TrainConfig(learning_rate=2e-3)), seg_model.parameters())
        x = torch.from_numpy(np.concatenate([targets] * 2)).cuda()
        y = torch.randint(0, 19, x.shape[:3], device="cuda", generator=torch.Generator("cuda").manual_seed(0))
        seg_ms = []
        for i in range(13):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = F.cross_entropy(seg_model(x).permute(0, 3, 1, 2), y)
            tx.zero_grad()
            loss.backward()
            tx.step(i)
            end.record()
            end.synchronize()
            if i >= 3:
                seg_ms.append(start.elapsed_time(end))
        infer = make_seg_infer(seg_dir, "cuda")
        x16 = np.concatenate([targets] * 4)
        infer(x16)
        t0 = time.perf_counter()
        for _ in range(10):
            infer(x16)
        report["segnet"] = {"labels_agree": agree, "limits": {"float32": SEG_F32_AGREE, "bfloat16": SEG_BF16_AGREE},
                            "step_ms_B8_median": statistics.median(seg_ms),
                            "labels_per_s_B16": 160 / (time.perf_counter() - t0)}
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"phase": "data_path", **report}), flush=True)
    if max(loss_err.values()) > TRAIN_LOSS_TOL or worst["card_vs_float64"][1] > grad_limit:
        raise AssertionError(f"data path, card against CPU: loss {loss_err}, gradients {worst} (limit {grad_limit})")
    if agree["float32"] < SEG_F32_AGREE or agree["bfloat16"] < SEG_BF16_AGREE:
        raise AssertionError(f"SegNet labels card against CPU agree {agree}")
    return {k: counts[k] for k in ("train_prepared", "train_kitti_root", "infer_kitti_root")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--against"] and len(sys.argv) == 3:
        from davo_tpu_torch import exact_f32

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
        exact_f32()
        compare_against(torch, sys.argv[2])
        return 0
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py [--against OTHER/davo_tpu_torch/csrc]", file=sys.stderr)
        return 2
    from davo_tpu_torch import exact_f32
    from davo_tpu_torch.kernels import bandwarp, costvol, cuda_build, rowconv, rowconv_ad

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

    # Phase 2: build every kernel library from its source in the
    # checkout, one nvcc per source, all started together.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNEL_SOURCES)) as pool:
        for future in [pool.submit(cuda_build.load, name) for name in KERNEL_SOURCES]:
            future.result()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s, "log": cuda_build.BUILD_LOG}), flush=True)
    sass = {source: _sass_counts(cuda_build.load(source)._name) for source in ("rowconv", "rowconv_bwd", "conv_stack")}
    for source, per_kernel in sass.items():
        print(json.dumps({"phase": "sass", "source": source, "per_kernel": per_kernel}), flush=True)
    # The stack's two kernels: tensor cores only, no float32 FMA; their
    # registers and spills (the float32 one is not held to 128 registers).
    stack_sass = {name: next(v for k, v in sass["conv_stack"].items() if name in k)
                  for name in ("conv_stack_mma_kernel", "conv_stack_tf32_kernel")}
    stack_resources = {name: _ptxas_resources(cuda_build.BUILD_LOG.get("conv_stack", ""), name)
                       for name in stack_sass}
    print(json.dumps({"phase": "conv_stack_kernels", "sass": stack_sass, "ptxas": stack_resources}), flush=True)
    for name, counts in stack_sass.items():
        if not (counts["HMMA"] > 0 and counts["FFMA"] == 0):
            raise AssertionError(f"{name} SASS: {counts}, want HMMA and no FFMA")
    mma_sass, tf32_stack_sass = stack_sass["conv_stack_mma_kernel"], stack_sass["conv_stack_tf32_kernel"]
    # The float32 layer kernels: split TF32 on the tensor cores, no float32 FMA anywhere in them.
    tf32_sass = {k: v for k, v in sass["rowconv"].items() if "conv_tf32_" in k}
    if not tf32_sass or any(v["HMMA"] == 0 or v["FFMA"] for v in tf32_sass.values()):
        raise AssertionError(f"conv_tf32 kernels' SASS: {tf32_sass}, want HMMA and no FFMA in each")

    rows = check_cost_volume(torch, costvol)
    bwd_rows = check_cost_volume_backward(torch, costvol)
    check_cost_volume_backward_searches(torch, costvol)
    band_rows, extra_band_rows = check_banded_warp(torch, bandwarp)
    _, warp_step_sums = check_banded_warp_on_step(torch, bandwarp, _step_warp_inputs(torch, bandwarp))
    rowconv_rows = check_rowconv(torch, rowconv)
    check_float32_layer_shapes(torch, rowconv)
    level_input_rows, level_input_sums = check_level_input(torch, rowconv)
    level_search_rows = check_level_input_searches(torch, rowconv)
    bwd_kernel_rows, bwd_layer_rows = check_rowconv_backward(torch, rowconv, rowconv_ad)
    check_rowconv_backward_shapes(torch, rowconv_ad)
    check_level_input_bwd_searches(torch, rowconv, rowconv_ad)
    stack_rows, stack_counts = check_conv_stack(torch, card)
    launches, stream = main_path(torch, costvol)
    fused_counts, fused_model = fused_path(torch, costvol, rowconv, stream)
    estimator_counts = fused_estimator(torch, costvol, rowconv)
    gpu_against_cpu(torch, costvol)
    fused_gpu_against_cpu(torch, rowconv)
    inputs, phase6_fps = throughput(torch, card, stream[0])
    profile(torch, card, stream, inputs)
    del inputs
    fused_throughput(torch, card, stream[0], fused_model)
    world_frames, world_seg = stream[2], stream[3]  # the main path's 257-frame world, for phase 13
    del stream, fused_model
    torch.cuda.empty_cache()
    train_counts, batch4 = train_path(torch, costvol, bandwarp)
    fused_train_counts, _ = train_path(torch, costvol, bandwarp, "fused_train_path", FUSED_TRAIN_FLAGS,
                                       per_step=FUSED_TRAIN_PER_STEP)
    fused_train_cli(torch, costvol, bandwarp)
    estimator_train_counts, _ = train_path(torch, costvol, bandwarp, "estimator_train_path",
                                           {"fuse_estimator_train": True}, steps=2,
                                           per_step=ESTIMATOR_TRAIN_PER_STEP)
    train_gpu_against_cpu(torch)
    train_gpu_against_cpu(torch, "fused_train_gpu_vs_cpu", FUSED_TRAIN_FLAGS)
    train_step_time(torch, card, batch4)
    _, fused_step_kernels = train_step_time(torch, card, batch4, "fused_train_step_time", FUSED_TRAIN_FLAGS)
    bench_entry(torch, card, phase6_fps)
    backend_counts = backend_path(torch, card, costvol, bandwarp)
    options_counts = options_path(torch, card, costvol, bandwarp, world_frames, world_seg, batch4)
    del world_frames, world_seg
    data_counts = data_path(torch, card, costvol, bandwarp, train_counts["prefetch"])

    def options_by_path(kernel):
        """Launches of the later phases' commands: options (13), real data (14)."""
        return {f"{group} {k}": v[kernel] for group, counts in (("options", options_counts), ("data", data_counts))
                for k, v in counts.items() if v.get(kernel)}

    # The kernels' line. cost_volume: the work of one serving request (its
    # two flow levels at B=64) on bf16 maps, the presets' dtype, beside the
    # same in float32 and the forward's share of one davo train step at
    # B=4 and B=64 (its 3 levels at S*B=8 and 128, bf16); launches on both
    # main paths (serving: 4 requests; train: 5 steps). The other train
    # kernels: the work of one davo train step at B=4 (its 3 cost-volume
    # levels at S*B=8; its 16 banded warps, TRAIN_WARPS), launches over
    # the 5 train steps; beside them the B=64 step's share (the 3 levels at
    # S*B=128; one C=1 128x416 backward with d/dimg and the C=3 and C=1
    # forwards at B=64, per launch). "ms" and "library_ms" are device
    # times (CUDA-graph replay); "call_ms" times one call from Python,
    # host overhead included.
    def cv_rows(prefix, dtype="bfloat16"):
        return [r for r in rows if r["shape"].startswith(prefix) and r["dtype"] == dtype]

    per_request = cv_rows("main path")
    per_request32 = cv_rows("main path", "float32")
    train_cv, b64_fwd_cv = cv_rows("train S*B=8 "), cv_rows("train S*B=128 ")
    per_step_cv = [r for r in bwd_rows if r["B"] == 8]
    b64_cv = [r for r in bwd_rows if r["B"] == 128]
    b64_warp = next(r for r in extra_band_rows if (r["C"], r["H"], r["W"], r["B"]) == (1, 128, 416, 64))
    b64_warp3 = next(r for r in extra_band_rows if (r["C"], r["H"], r["W"], r["B"]) == (3, 128, 416, 64))

    def step_sum(key):
        return sum(r[key] * r["per_step"] for r in band_rows)

    def bound_by(values):
        return "bytes" if all(v == "bytes" for v in values) else "operations"

    kernels = [
        {
            "name": "cost_volume", "route": "cuda", "source": "davo_tpu_torch/csrc/costvol.cu",
            "replaces": "davo_tpu/kernels/costvol.py:41",
            "launches": launches + train_counts["cost_volume"] + sum(backend_counts.values())
            + sum(options_by_path("cost_volume").values()),
            "launches_by_path": {"serving": launches, "train": train_counts["cost_volume"],
                                 **{f"backend {k}": v for k, v in backend_counts.items()},
                                 **options_by_path("cost_volume")},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["device_ms"] for r in per_request),
            "call_ms": sum(r["ms"] for r in per_request),
            "plain_ms": sum(r["plain_ms"] for r in per_request),
            "bound_ms": sum(r["bound_ms"] for r in per_request),
            "bound_by": bound_by(r["bound_by"] for r in per_request),
            "library_ms": None,
            "dtype": "bfloat16",
            "float32_ms": sum(r["device_ms"] for r in per_request32),
            "float32_bound_ms": sum(r["bound_ms"] for r in per_request32),
            "train_step_ms": sum(r["device_ms"] for r in train_cv),
            "train_step_bound_ms": sum(r["bound_ms"] for r in train_cv),
            "b64_step_ms": sum(r["device_ms"] for r in b64_fwd_cv),
            "b64_step_bound_ms": sum(r["bound_ms"] for r in b64_fwd_cv),
        },
        {
            "name": "cost_volume_backward", "route": "cuda", "source": "davo_tpu_torch/csrc/costvol.cu",
            "replaces": "davo_tpu/models/flownet.py:30 (XLA form; no TPU kernel)",
            "launches": train_counts["cost_volume_backward"] + sum(options_by_path("cost_volume_backward").values()),
            "launches_by_path": {"train": train_counts["cost_volume_backward"],
                                 **options_by_path("cost_volume_backward")},
            "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
            "ms": sum(r["device_ms"] for r in per_step_cv),
            "call_ms": sum(r["ms"] for r in per_step_cv),
            "plain_ms": sum(r["plain_ms"] for r in per_step_cv),
            "bound_ms": sum(r["bound_ms"] for r in per_step_cv),
            "bound_by": bound_by(r["bound_by"] for r in per_step_cv),
            "library_ms": None,
            "b64_step_ms": sum(r["device_ms"] for r in b64_cv),
            "b64_step_bound_ms": sum(r["bound_ms"] for r in b64_cv),
        },
        {
            "name": "banded_warp", "route": "cuda", "source": "davo_tpu_torch/csrc/bandwarp.cu",
            "replaces": "davo_tpu/kernels/bandwarp.py:161",
            "launches": train_counts["banded_warp"] + sum(options_by_path("banded_warp").values()),
            "launches_by_path": {"train": train_counts["banded_warp"], **options_by_path("banded_warp")},
            "max_abs_err": max(r["fwd_max_abs_err"] for r in band_rows + extra_band_rows),
            "ms": step_sum("fwd_device_ms"), "call_ms": step_sum("fwd_ms"),
            "plain_ms": step_sum("fwd_plain_ms"), "bound_ms": step_sum("fwd_bound_ms"),
            "bound_by": bound_by(r["fwd_bound_by"] for r in band_rows),
            "library_ms": step_sum("fwd_library_device_ms"),
            "library_call_ms": step_sum("fwd_library_ms"),
            "c3_b64_ms": b64_warp3["fwd_device_ms"], "c3_b64_library_ms": b64_warp3["fwd_library_device_ms"],
            "c3_b64_bound_ms": b64_warp3["fwd_bound_ms"],
            "c1_b64_ms": b64_warp["fwd_device_ms"], "c1_b64_library_ms": b64_warp["fwd_library_device_ms"],
            "c1_b64_bound_ms": b64_warp["fwd_bound_ms"],
            "on_step_coords": warp_step_sums,
        },
        {
            "name": "banded_warp_backward", "route": "cuda", "source": "davo_tpu_torch/csrc/bandwarp.cu",
            "replaces": "davo_tpu/kernels/bandwarp.py:188",
            "launches": train_counts["banded_warp_backward"]
            + sum(options_by_path("banded_warp_backward").values()),
            "launches_by_path": {"train": train_counts["banded_warp_backward"],
                                 **options_by_path("banded_warp_backward")},
            "max_abs_err": max(r["bwd_max_rel_err"] for r in band_rows + extra_band_rows),
            "max_err_is": "relative to the largest gradient",
            "ms": step_sum("bwd_device_ms"), "call_ms": step_sum("bwd_ms"),
            "plain_ms": step_sum("bwd_plain_ms"), "bound_ms": step_sum("bwd_bound_ms"),
            "bound_by": bound_by(r["bwd_bound_by"] for r in band_rows),
            "library_ms": step_sum("bwd_library_device_ms"),
            "library_call_ms": step_sum("bwd_library_ms"),
            "c1_b64_ms": b64_warp["bwd_device_ms"], "c1_b64_library_ms": b64_warp["bwd_library_device_ms"],
            "c1_b64_bound_ms": b64_warp["bwd_bound_ms"],
        },
    ]
    # The fused kernels: the work of one serving request in bf16, the
    # path's mode (the units of phase 3d); launches on the fused serving
    # path (4 requests) and, for conv_chain_nhwc, the fused-estimator
    # forward. max_abs_err is the float32 error relative to the largest
    # output; the bf16 criteria are in the phase's lines.
    for name, line, path_counts in (
        ("flow_level_fused", 246, fused_counts), ("conv_chain_strided", 501, fused_counts),
        ("conv_chain_nhwc", 602, estimator_counts),
    ):
        unit_rows = [r for r in rowconv_rows if r["kernel"] == name and r["mode"] == "bfloat16"]
        f32_rows = [r for r in rowconv_rows if r["kernel"] == name and r["mode"] == "float32"]
        kernels.append({
            "name": name, "route": "cuda", "source": "davo_tpu_torch/csrc/rowconv.cu",
            "replaces": f"davo_tpu/kernels/rowconv.py:{line}",
            "launches": path_counts[name] + sum(options_by_path(f"serving_{name}").values()),
            "launches_by_path": {"fused serving" if path_counts is fused_counts else "fused estimator":
                                 path_counts[name], **options_by_path(f"serving_{name}")},
            "device_launches": path_counts["device_launches"][name],
            "max_abs_err": max(r["max_rel_err"] for r in f32_rows),
            "max_err_is": "float32, relative to the largest output",
            "bf16_gap_ratio": max(r["gap_ratio"] for r in unit_rows),
            "ms": sum(r["ms"] for r in unit_rows), "plain_ms": sum(r["plain_ms"] for r in unit_rows),
            "bound_ms": sum(r["bound_ms"] for r in unit_rows),
            "bound_by": bound_by(r["bound_by"] for r in unit_rows),
            "library_ms": sum(r["library_ms"] for r in unit_rows),
            "library_is": "the port's unfused route for the same function",
            "float32_ms": sum(r["ms"] for r in f32_rows),
            "float32_bound_ms": sum(r["bound_ms"] for r in f32_rows),
            "float32_tf32_bound_ms": sum(r["tf32_bound_ms"] for r in f32_rows),
            "float32_library_ms": sum(r["library_ms"] for r in f32_rows),
            "float32_library_is": "the port's unfused route in float32 (cuDNN float32, TF32 off)",
        })
    # The flow level's input kernel: the work of one fused serving request
    # (its two levels at B=64) in bf16, the path's mode, beside one fused
    # train step's three levels (with a0) at B=4 and B=64; launches on the
    # fused serving path (4 requests) and the fused training path (5
    # steps). max_abs_err: the float32 output's and a0's, absolute.
    serving = level_input_sums["serving request, bfloat16"]
    kernels.append({
        "name": "flow_level_input", "route": "cuda", "source": "davo_tpu_torch/csrc/rowconv.cu",
        "replaces": "davo_tpu/kernels/rowconv.py:283 (flow_level_fused's pallas_call, its input part)",
        "launches": fused_counts["flow_level_input"] + fused_train_counts["flow_level_input"]
        + sum(options_by_path("flow_level_input").values()),
        "launches_by_path": {"fused serving": fused_counts["flow_level_input"],
                             "fused training path": fused_train_counts["flow_level_input"],
                             **options_by_path("flow_level_input")},
        "max_abs_err": max(max(r.get("max_abs_err", 0.0), r.get("a0_max_abs_err", 0.0)) for r in level_input_rows),
        "max_err_is": "absolute: the float32 output and the float32 a0",
        "bf16_max_differ_share": max(r.get("differ_share", 0.0) for r in level_input_rows),
        "ms": serving["ms"], "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"], "bound_by": "bytes",
        "library_ms": serving["library_ms"],
        "library_is": "the port's unfused route: the cost-volume kernel, ReLU, concatenation, cast",
        "b4_step_ms": level_input_sums["B=4 step"]["ms"], "b4_step_bound_ms": level_input_sums["B=4 step"]["bound_ms"],
        "b64_step_ms": level_input_sums["B=64 step"]["ms"],
        "b64_step_bound_ms": level_input_sums["B=64 step"]["bound_ms"],
        "b64_step_library_ms": level_input_sums["B=64 step"]["library_ms"],
        "searches_held": sorted({r["search"] for r in level_input_rows} | {r["search"] for r in level_search_rows}),
        "kernels_held": sorted({r["kernel"] for r in level_input_rows + level_search_rows}),
    })
    # The training chains: the work of one davo train step at B=4 (the
    # units of phase 3e) in bf16, the path's mode: "ms" is the backward
    # kernels' device time (the forwards are the serving kernels, timed
    # in phase 3d at serving shapes); launches are the autograd
    # functions' backward calls on the fused training path (5 steps), or
    # for conv_chain_nhwc_ad on the fuse_estimator_train path (2 steps),
    # with the kernel launches of that run. max_abs_err is the float32
    # error relative to each gradient's largest element.
    for name, line, path, counts in (
        ("flow_level_fused_ad", 1059, "fused training path", fused_train_counts),
        ("conv_chain_strided_ad", 1390, "fused training path", fused_train_counts),
        ("conv_chain_nhwc_ad", 824, "fuse_estimator_train path", estimator_train_counts),
    ):
        unit_rows = [r for r in bwd_kernel_rows if r["kernel"] == name and r["mode"] == "bfloat16"]
        f32_rows = [r for r in bwd_kernel_rows if r["kernel"] == name and r["mode"] == "float32"]
        kernels.append({
            "name": name, "route": "cuda", "source": "davo_tpu_torch/csrc/rowconv_bwd.cu",
            "forward_source": "davo_tpu_torch/csrc/rowconv.cu",
            "replaces": f"davo_tpu/kernels/rowconv.py:{line}",
            "launches": counts[f"{name}_backward"], "forward_launches": counts[name],
            "launches_by_path": {path: counts[f"{name}_backward"]},
            "path_device_launches": {k: v for k, v in counts["device_launches"].items() if v},
            "max_abs_err": max(r["max_rel_err"] for r in f32_rows),
            "max_err_is": "float32, relative to each gradient's largest element",
            "bf16_max_differ_share": max(r["bf16_differ_share"] for r in unit_rows),
            "bf16_max_ulps": max(r["bf16_max_ulps"] for r in unit_rows),
            "ms": sum(r["ms"] for r in unit_rows), "plain_ms": sum(r["plain_ms"] for r in unit_rows),
            "bound_ms": sum(r["bound_ms"] for r in unit_rows),
            "bound_by": bound_by(r["bound_by"] for r in unit_rows),
            "library_ms": sum(r["library_ms"] for r in unit_rows),
            "library_is": "the port's unfused route backward for the same units (cuDNN bf16), device time",
            "library_call_ms": sum(r["library_call_ms"] for r in unit_rows),
            "float32_ms": sum(r["ms"] for r in f32_rows),
            "float32_library_ms": sum(r["library_ms"] for r in f32_rows),
            "float32_library_is": "the same in float32 (cuDNN float32, TF32 off), device time",
            "float32_library_call_ms": sum(r["library_call_ms"] for r in f32_rows),
        })
    # The training chains' backward kernels one by one: the work of one
    # davo train step at B=4 on the fused training path (phase 3e's units
    # but the estimators, which fuse_estimator_train runs) in bf16, summed
    # over their layers; "bound_ms" at the design's rate (TF32 passes),
    # "fma_bound_ms" at the f32 FMA rate; "library_ms" one cuDNN float32
    # call (TF32 off) per layer on pre-formed operands, "library_bf16_ms"
    # the same in bf16; launches on the fused training path (5 steps), by
    # variant where the kernel has several; "b64_step_ms" its device time
    # in phase 10b's profile of one fused B=64 step.
    step_layers = [r for r in bwd_layer_rows if r["mode"] == "bfloat16" and r["kernel"] != "conv_chain_nhwc_ad"]
    est_layers = [r for r in bwd_layer_rows if r["mode"] == "bfloat16" and r["kernel"] == "conv_chain_nhwc_ad"]

    def layer_sum(rows_, key):
        values = [r[key] for r in rows_ if r.get(key) is not None]
        return sum(values) if values else None

    def worst(kind):
        return max(v for r in bwd_layer_rows if isinstance(r["max_rel_err"], dict)
                   for k, v in r["max_rel_err"].items() if k in kind and v is not None)

    for name, prefix, errs in (("conv_layer_gate", "gate", ("dz",)), ("conv_layer_wgrad", "wgrad", ("dw", "db")),
                               ("conv_layer_dgrad", "dgrad", ("dx",))):
        conv = prefix != "gate"
        kernels.append({
            "name": name, "route": "cuda", "source": "davo_tpu_torch/csrc/rowconv_bwd.cu",
            "replaces": "davo_tpu/kernels/rowconv.py:1455, :1186, :869 (the backward pallas_calls of #8, #6, #10)",
            "launches": fused_train_counts["device_launches"][name],
            "launches_by_variant": {k: v for k, v in fused_train_counts["variant_launches"].items()
                                    if prefix in k} if conv else None,
            "max_abs_err": worst(errs),
            "max_err_is": "float32, relative to the largest element, against the float64 sum on the same inputs",
            "ms": layer_sum(step_layers, f"{prefix}_ms"), "plain_ms": layer_sum(step_layers, f"{prefix}_plain_ms"),
            "bound_ms": layer_sum(step_layers, f"{prefix}_bound_ms"),
            "bound_by": "operations" if conv else "bytes",
            "fma_bound_ms": layer_sum(step_layers, f"{prefix}_fma_bound_ms") if conv else None,
            "library_ms": layer_sum(step_layers, f"cudnn_f32_{prefix}_ms") if conv else None,
            "library_is": "cuDNN conv2d_weight / conv2d_input, float32, TF32 off, one call per layer" if conv else None,
            "library_bf16_ms": layer_sum(step_layers, f"cudnn_bf16_{prefix}_ms") if conv else None,
            "estimator_path_ms": layer_sum(est_layers, f"{prefix}_ms"),
            "float32_ms": layer_sum([r for r in bwd_layer_rows if r["mode"] == "float32"
                                     and r["kernel"] != "conv_chain_nhwc_ad"], f"{prefix}_ms"),
            "b64_step_ms": fused_step_kernels[name]["ms"],
        })
    level_rows = [r for r in bwd_layer_rows if r["layer"] == "flow_level_input_bwd"]
    level_bf16 = [r for r in level_rows if r["mode"] == "bfloat16"]
    kernels.append({
        "name": "flow_level_input_bwd", "route": "cuda", "source": "davo_tpu_torch/csrc/rowconv_bwd.cu",
        "replaces": "davo_tpu/kernels/rowconv.py:1186 (the flow level's backward pallas_call, its input part)",
        "launches": fused_train_counts["device_launches"]["flow_level_input_bwd"],
        "max_abs_err": max(max(r["max_rel_err"]) for r in level_rows if r["mode"] == "float32"),
        "max_err_is": "float32, relative to the largest element, against the float64 sum",
        "ms": layer_sum(level_bf16, "flow_level_input_bwd_ms"),
        "plain_ms": layer_sum(level_bf16, "flow_level_input_bwd_plain_ms"),
        "bound_ms": layer_sum(level_bf16, "bound_ms"), "bound_by": "bytes", "library_ms": None,
        "b64_step_ms": fused_step_kernels["flow_level_input_bwd"]["ms"],
    })
    # The conv stack: the work of the davo-fast pose prefix at B=64 in bf16,
    # beside the same in float32 (its own kernel) and both at B=256;
    # launches on its path (phase 3f's speed-of-light run through the bench
    # package). max_abs_err is the float32 error relative to the largest
    # output; the bf16 criteria are in the phase's lines.
    unit = next(r for r in stack_rows if r["batch"] == 64 and r["mode"] == "bfloat16")
    unit32 = next(r for r in stack_rows if r["batch"] == 64 and r["mode"] == "float32")
    unit256 = {r["mode"]: r for r in stack_rows if r["batch"] == 256}
    kernels.append({
        "name": "fused_conv_stack", "route": "cuda", "source": "davo_tpu_torch/csrc/conv_stack.cu",
        "replaces": "davo_tpu/kernels/conv_stack.py:179",
        "launches": stack_counts["launches"],
        "launches_by_path": {"bench: timed + conv_stack_sol (phase 3f)": stack_counts["launches"]},
        "device_launches": stack_counts["device_launches"],
        "max_abs_err": max(r["max_rel_err"] for r in stack_rows if r["mode"] == "float32"),
        "max_err_is": "float32, relative to the largest output",
        "bf16_gap_ratio": max(r["gap_ratio"] for r in stack_rows if r["mode"] == "bfloat16"),
        "ms": unit["ms"], "plain_ms": unit["plain_ms"], "bound_ms": unit["bound_ms"],
        "bound_by": unit["bound_by"], "sol_roofline_ms": unit["sol_roofline_ms"],
        "library_ms": unit["library_ms"], "library_is": unit["library_is"],
        "conv_chain_strided_ms": unit["conv_chain_strided_ms"],
        "float32_ms": unit32["ms"], "float32_plain_ms": unit32["plain_ms"],
        "float32_bound_ms": unit32["bound_ms"], "float32_tf32_bound_ms": unit32["tf32_bound_ms"],
        "float32_library_ms": unit32["library_ms"], "float32_library_is": unit32["library_is"],
        "float32_conv_chain_strided_ms": unit32["conv_chain_strided_ms"],
        "b256_ms": unit256["bfloat16"]["ms"], "b256_float32_ms": unit256["float32"]["ms"],
        "b256_float32_bound_ms": unit256["float32"]["tf32_bound_ms"],
        "grid": unit["grid"], "float32_grid": unit32["grid"],
        "sass_bf16_kernel": mma_sass, "sass_float32_kernel": tf32_stack_sass,
        "ptxas": stack_resources,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
