"""Run one benchmark cell once on the card and print its result line.

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs made on the card from the seed, warm-up of
the cell's own shapes), the measured window of `--seconds`, then the
check of the window's outputs against the plain reference. The last line
of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and the compared numbers
with their limits (checks). Exits non-zero, printing no result, when
there is no card or too few, or when JAX, Flax or the JAX package was
loaded. The program's kernels build once per checkout, into its
`build/davo_tpu_torch/` (named by the sources' hash).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from vobench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vobench: {args.workload} needs {cell.chips} CUDA device(s), found {found}; "
              "the benchmark runs on the card only", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"vobench: modules of JAX, Flax or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
