"""Benchmark harnesses: throughput and speed-of-light accounting (port of
davo_tpu.bench; `scaling_efficiency` waits for the port of `dist/`).
`python -m davo_tpu_torch.bench` prints bench.py's JSON line."""

from davo_tpu_torch.bench.sol import conv_stack_sol, model_flops  # noqa: F401
from davo_tpu_torch.bench.throughput import bench_inference, bench_train_step  # noqa: F401
