"""Gaussian joint-heatmap rendering (``hoisdf_tpu/ops/heatmap.py``):
per-joint isotropic gaussians at ``joint_coord`` (heatmap pixel coords),
summed over joints, scaled by 255."""

from __future__ import annotations

import torch


def render_gaussian_heatmap(joint_coord: torch.Tensor, hm_shape=(128, 128),
                            sigma: float = 1.25) -> torch.Tensor:
    """joint_coord [B,J,2] (x,y) -> heatmap [B,H,W]."""
    h, w = hm_shape
    dt, dev = joint_coord.dtype, joint_coord.device
    xx = torch.arange(w, dtype=dt, device=dev)[None, None, None, :]
    yy = torch.arange(h, dtype=dt, device=dev)[None, None, :, None]
    x = joint_coord[:, :, 0, None, None]
    y = joint_coord[:, :, 1, None, None]
    hm = torch.exp(-(((xx - x) / sigma) ** 2) / 2 - (((yy - y) / sigma) ** 2) / 2)
    return hm.sum(dim=1) * 255.0
