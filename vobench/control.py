"""Readings that set a cell's limits, in one process on the card:

    python3 -m vobench.control --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults half_batch,...] [--seconds 3]

For each seed of --seeds, one run of the cell's timed path as the
benchmark makes it (a short window at the cell's own load); for each seed
of --control-seeds, the same run with the plain reference in the
program's place computed in fp8 (e4m3) where the configuration states
bf16 (the control); for each fault of --faults (vobench/faults.py), a
run with the fault planted in the program on each control seed. Prints
one JSON line per run with the numbers compared (the limits of
vobench/limits/<workload>.json beside them). The benchmark's own runs
never run this.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def readings(workload: str, seeds, control_seeds, faults, seconds: float, device, layout=None, out=sys.stdout):
    """Run each reading and print its line; returns the lines as dicts."""
    import torch

    from vobench import faults as fault_mod
    from vobench import harness

    layout = layout or harness.Layout()
    kind = harness.load_cell(workload, layout).traffic["kind"]
    runs = [("program", s, "port", None) for s in seeds]
    runs += [("control", s, "reference:fp8", None) for s in control_seeds]
    runs += [(f"fault:{f}", s, "port", f) for f in faults for s in control_seeds]
    lines = []
    for what, seed, system, fault in runs:
        planted = fault_mod.planted(fault, kind) if fault else contextlib.nullcontext()
        t0 = time.perf_counter()
        with planted:
            result = harness.run_cell(workload, seed, seconds, False, device, t0, layout, system)
        line = {"reading": what, "workload": workload, "seed": seed, "correct": result["correct"],
                "checks": result["checks"], "metrics": result["metrics"], "s": time.perf_counter() - t0}
        print(json.dumps(line), file=out, flush=True)
        lines.append(line)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("vobench.control: the readings are taken on the card; no CUDA device found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    readings(args.workload, _seeds(args.seeds), _seeds(args.control_seeds),
             [f for f in args.faults.split(",") if f], args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
