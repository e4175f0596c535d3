"""Dense-weight bilinear sampling for small grids (port of
davo_tpu.kernels.sample).

out[b, p, c] = sum_{v, u} hat(v_p - v) hat(u_p - u) img[b, v, u, c]

Arbitrary-coordinate sampling as two einsum contractions instead of a
gather; FLOPs scale as P * (H + W) * C, so it is only worthwhile for
coarse grids. No path of the model selects it, as in the reference:
`core.warp.bilinear_sample` is the warps' sampler.
"""

from __future__ import annotations

import torch


def bilinear_sample_matmul(
    img: torch.Tensor, coords: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """img: (B, H, W, C); coords: (B, Ho, Wo, 2) as (u, v).

    Returns (sampled (B, Ho, Wo, C), valid (B, Ho, Wo, 1)), with
    `core.warp.bilinear_sample`'s semantics: zero and invalid out of
    bounds.
    """
    B, H, W, C = img.shape
    _, Ho, Wo, _ = coords.shape
    P = Ho * Wo
    u = coords[..., 0].reshape(B, P)
    v = coords[..., 1].reshape(B, P)
    valid = ((u >= 0.0) & (u <= W - 1.0) & (v >= 0.0) & (v <= H - 1.0)).to(img.dtype)
    qu = torch.arange(W, dtype=img.dtype, device=img.device)
    qv = torch.arange(H, dtype=img.dtype, device=img.device)
    wu = torch.clamp(1.0 - (u[..., None] - qu).abs(), min=0.0)  # (B, P, W)
    wv = torch.clamp(1.0 - (v[..., None] - qv).abs(), min=0.0)  # (B, P, H)
    t = torch.einsum("bpv,bvuc->bpuc", wv, img)
    out = torch.einsum("bpu,bpuc->bpc", wu, t) * valid[..., None]
    return out.reshape(B, Ho, Wo, C), valid.reshape(B, Ho, Wo, 1)
