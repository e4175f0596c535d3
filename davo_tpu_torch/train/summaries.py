"""Training image summaries: warped targets and disparity panels (port
of davo_tpu.train.summaries).

Reference parity: DAVO's TensorBoard shows the photometrically warped
source->target reconstructions and the predicted disparity maps
(`<ref>/davo.py` image summaries, SURVEY.md §5). One training forward on
the current batch on the device, then small numpy panels on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from davo_tpu_torch.core.warp import projective_inverse_warp
from davo_tpu_torch.models.dispnet import disp_to_depth


def _colorize(x: np.ndarray) -> np.ndarray:
    """Normalize a scalar map to [0, 1] and apply a blue->red ramp."""
    lo, hi = np.percentile(x, 2), np.percentile(x, 98)
    n = np.clip((x - lo) / max(hi - lo, 1e-6), 0.0, 1.0)
    return np.stack([n, 0.4 * (1 - np.abs(2 * n - 1)), 1.0 - n], axis=-1)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def make_summary_fn(model, cfg):
    """Returns batch -> dict[str, np.ndarray] image panels of the first
    item, from `model`'s training forward (batch: numpy arrays or tensors
    on the model's device). A geo_hybrid model gets the batch's K, which
    its forward needs (the reference's summary passes none)."""
    use_seg = cfg.model.attention == "flow_seg"
    use_k = cfg.model.pose_head == "geo_hybrid"

    @torch.no_grad()
    def summarize(batch: dict) -> dict:
        dev = next(model.parameters()).device
        b = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(dev)
             for k, v in batch.items()}
        out = model(
            b["target"], b["sources"], seg=b.get("seg") if use_seg else None, train=True,
            K=b["K"] if use_k else None,
        )
        disp0 = out["disp"][0][..., 0]
        warped, valid = projective_inverse_warp(b["sources"][:, 0], disp_to_depth(disp0), out["poses"][:, 0], b["K"])
        tgt = _host(b["target"][0])
        w = _host(warped[0])
        v = _host(valid[0]).reshape(tgt.shape[0], tgt.shape[1], 1)
        return {
            "target": tgt,
            "source0": _host(b["sources"][0, 0]),
            "warped_source0": w * v,
            "photometric_err": _colorize(np.abs(w - tgt).mean(-1) * v[..., 0]),
            "disparity": _colorize(_host(disp0[0])),
        }

    return summarize
