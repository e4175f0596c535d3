"""The cost-volume backward kernel's tile plan (`csrc/costvol.cu`),
emulated on the CPU: shift rows in passes for wide searches.

The kernel runs only on the card (chip_smoke.py phase 3b holds it there
against `cost_volume_plain_bwd`). Here its pass plan is mirrored from the
C source and its algorithm (8x16 tiles, the window rows and cotangents a
pass stages, the per-output shift order) is run in PyTorch, then held
against the plain backward and the JAX package's `jax.vjp` of the XLA
cost volume that the JAX train step differentiates.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models.flownet import cost_volume as j_cost_volume
from davo_tpu_torch.kernels import costvol, cuda_build

SMEM_MAX = 232448  # H100: the dynamic shared memory a block may opt in to


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tile_constants():
    """kBwdTileH, kBwdTileW, kBwdSlice as the C source declares them."""
    src = (cuda_build.CSRC_DIR / "costvol.cu").read_text()
    m = re.search(r"constexpr int kBwdTileH = (\d+), kBwdTileW = (\d+), kBwdSlice = (\d+)", src)
    return tuple(int(v) for v in m.groups())


TILE_H, TILE_W, SLICE = _tile_constants()


def bwd_rows(search, smem_max=SMEM_MAX):
    """`bwd_rows` of costvol.cu: the most shift rows a pass whose window
    rows ((tile rows + rows - 1) x (tile columns + 2s) pixels of one
    32-channel slice) and cotangents (tile pixels x rows * (2s+1)) fit
    `smem_max` bytes of float32; 0 where not even one row fits."""
    d = 2 * search + 1
    for rows in range(d, 0, -1):
        floats = (TILE_H + rows - 1) * (TILE_W + 2 * search) * SLICE + TILE_H * TILE_W * rows * d
        if 4 * floats <= smem_max:
            return rows
    return 0


def emulate_bwd(f1, f2, g, search, rows=None):
    """The kernel's algorithm on float32 maps: per 8x16 tile and gradient,
    the shift rows in passes of `rows` (all 2s+1 by default), each pass
    staging the window rows and cotangents it reads, accumulating every
    output's terms in ascending (dy, dx) with single-rounding FMAs
    (float64 products of float32 values are exact), times 1/C last."""
    B, H, W, C = f1.shape
    s, d = search, 2 * search + 1
    rows = d if rows is None else rows
    py, px = torch.meshgrid(torch.arange(TILE_H), torch.arange(TILE_W), indexing="ij")
    py, px = py.reshape(-1), px.reshape(-1)
    gp = torch.nn.functional.pad(g, (0, 0, s, s + TILE_W, s, s + TILE_H))  # cotangents, 0 off the frame
    out = {"df1": torch.zeros(B, H, W, C), "df2": torch.zeros(B, H, W, C)}
    for b in range(B):
        for y0 in range(0, H, TILE_H):
            for x0 in range(0, W, TILE_W):
                for name, other, is_df1 in (("df1", f2, True), ("df2", f1, False)):
                    window = torch.zeros(TILE_H + 2 * s, TILE_W + 2 * s, C)
                    ys = slice(max(y0 - s, 0), min(y0 + TILE_H + s, H))
                    xs = slice(max(x0 - s, 0), min(x0 + TILE_W + s, W))
                    window[ys.start - (y0 - s): ys.stop - (y0 - s), xs.start - (x0 - s): xs.stop - (x0 - s)] = (
                        other[b, ys, xs])
                    acc = torch.zeros(TILE_H * TILE_W, C)
                    for dy0 in range(0, d, rows):
                        nr = min(rows, d - dy0)
                        wr0 = dy0 if is_df1 else 2 * s - dy0 - nr + 1
                        staged = window[wr0: wr0 + nr + TILE_H - 1]
                        assert staged.shape[0] == nr + TILE_H - 1
                        for r in range(nr):
                            dy = dy0 + r
                            for dx in range(d):
                                k = dy * d + dx
                                if is_df1:  # g[p, k] * f2[p + delta_k]
                                    gk = gp[b, y0 + py + s, x0 + px + s, k]
                                    gk = torch.where((y0 + py < H) & (x0 + px < W), gk, 0.0)
                                    m = staged[py + r, px + dx]
                                else:  # g[q - delta_k, k] * f1[q - delta_k]
                                    gk = gp[b, y0 + py + 2 * s - dy, x0 + px + 2 * s - dx, k]
                                    m = staged[py + nr - 1 - r, px + 2 * s - dx]
                                acc = (acc.double() + gk[:, None].double() * m.double()).float()
                    acc = acc * (1.0 / C)
                    y, x = y0 + py, x0 + px
                    inside = (y < H) & (x < W)
                    out[name][b, y[inside], x[inside]] = acc[inside]
    return out["df1"], out["df2"]


def _inputs(seed, B, H, W, C, search):
    rng = np.random.default_rng(seed)
    f1, f2 = (rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(B, H, W, (2 * search + 1) ** 2)).astype(np.float32)
    return f1, f2, g


def test_pass_plan_mirrors_the_kernel():
    """One pass of all 2s+1 shift rows up to search 7 (the searches the
    one-pass kernel took), passes from 8 on (15 + 2 rows at 8), and a
    plan for every search the entry point takes, up to 64."""
    assert (TILE_H, TILE_W, SLICE) == (8, 16, 32)
    assert all(bwd_rows(s) == 2 * s + 1 for s in range(8))
    assert bwd_rows(8) == 15 and bwd_rows(12) < 25
    assert all(1 <= bwd_rows(s) < 2 * s + 1 for s in range(8, 65))
    assert bwd_rows(64) == 1
    src = (cuda_build.CSRC_DIR / "costvol.cu").read_text()
    assert "search > 64" in src and "bwd_rows(search, smem_max)" in src


@pytest.mark.parametrize("search", [8, 12])
def test_emulated_passes_match_plain_and_jax(search):
    """At searches 8 and 12, on a frame smaller than the search's reach
    and not a whole number of tiles, the pass plan's gradients: within
    1e-5 of `cost_volume_plain_bwd` and of `jax.vjp` of the JAX
    package's XLA cost volume (the same sums in another order)."""
    f1, f2, g = _inputs(search, 1, 11, 21, 6, search)
    rows = bwd_rows(search)
    assert rows < 2 * search + 1
    got = emulate_bwd(*(torch.from_numpy(a) for a in (f1, f2, g)), search, rows)
    want = costvol.cost_volume_plain_bwd(*(torch.from_numpy(a) for a in (f1, f2, g)), search)
    _, vjp = jax.vjp(lambda a, b: j_cost_volume(a, b, search), jnp.asarray(f1), jnp.asarray(f2))
    jwant = vjp(jnp.asarray(g))
    for a, b, j in zip(got, want, jwant):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 2])
def test_passes_sum_as_one_pass(rows):
    """Passes of `rows` shift rows give the same bits as one pass of all
    2s+1: every output still sums its terms in ascending (dy, dx), and
    every window row and cotangent a pass reads was staged by it."""
    f1, f2, g = (torch.from_numpy(a) for a in _inputs(5, 2, 9, 19, 5, 2))
    one = emulate_bwd(f1, f2, g, 2)
    passes = emulate_bwd(f1, f2, g, 2, rows)
    assert all(torch.equal(a, b) for a, b in zip(one, passes))
