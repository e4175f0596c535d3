"""SSIM distance map of the photometric loss (port of davo_tpu.core.ssim).

3x3 VALID average pools, the SfMLearner-family convention. NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from davo_tpu_torch.core.geometry import clip

_C1 = 0.01**2
_C2 = 0.03**2


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 VALID average pool over (B, H, W, C)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 3, stride=1).permute(0, 2, 3, 1)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x2 in [0, 1] -> (B, H-2, W-2, C) of (1 - SSIM)/2,
    clipped to [0, 1] with JAX's half gradient at a tie (identical 3x3
    patches give exactly 0)."""
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    sigma_x = _avg_pool3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3(x * y) - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    den = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return clip((1.0 - num / den) * 0.5, 0.0, 1.0)
