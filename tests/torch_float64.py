"""Float64 runs of both packages' float32 programs, for the tests that
hold each package's float32 rounding against its own exact arithmetic
(tests/test_torch_float32_distance.py, the `tiny` parity steps of
tests/test_torch_train.py). The port's side is chip_smoke.py's
`_float64_program`; this module holds the reference's, and the distance
both tests read."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch


@contextlib.contextmanager
def reference_float64():
    """x64 on, and `jnp.float32` read as float64 while open: the
    reference's explicit float32 casts (its compute dtype, `.astype`,
    zeros, grids) compute in float64."""
    real = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = real


def to_float64(batch: dict) -> dict:
    """A NumPy batch with its float32 arrays in float64."""
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def relative_error(got, exact) -> float:
    """max |got - exact| over exact's largest magnitude."""
    got, exact = (torch.as_tensor(np.array(a)).double() for a in (got, exact))
    return float((got - exact).abs().max()) / max(float(exact.abs().max()), 1e-30)


def worst_leaf(got: dict, exact: dict) -> tuple[str, float]:
    """The leaf of `got` farthest from `exact`, by name: (name,
    `relative_error`)."""
    errs = {n: relative_error(got[n], w) for n, w in exact.items()}
    return max(errs.items(), key=lambda kv: kv[1])
