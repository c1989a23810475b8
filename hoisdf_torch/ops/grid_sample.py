"""Pixel-aligned feature gather (``hoisdf_tpu/ops/grid_sample.py``).

Feature maps are NHWC, as in the JAX package; the point axis is a flat list of
P query points per image.  The multi-level gather is one launch of the
``gather_lerp`` kernel on the card, in its bilinear or its nearest mode.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import torch

from hoisdf_torch.ops.kernels.gather_lerp import (
    gather_lerp,
    grid_sample_bilinear,
    grid_sample_nearest,
)

__all__ = ["grid_sample_bilinear", "grid_sample_nearest", "multiscale_point_features",
           "pixels_to_grid", "project_points"]


def multiscale_point_features(
    feature_pyramid: Dict[str, torch.Tensor],
    grid: torch.Tensor,
    layer_names: Sequence[str],
    *,
    nearest: bool = False,
) -> torch.Tensor:
    """Bilinear-sample (``nearest``: take the nearest texel of) every named
    NHWC level at ``grid`` [B,P,2] and channel-concatenate in
    ``layer_names`` order -> [B, P, sum(C_l)]."""
    return gather_lerp(grid, [feature_pyramid[name] for name in layer_names], nearest)


def project_points(points_cam: torch.Tensor, cam_intr: torch.Tensor) -> torch.Tensor:
    """Pinhole projection: points [B,P,3], intrinsics [B,3,3] -> pixels [B,P,2]."""
    p2d = torch.einsum("bpc,bkc->bpk", points_cam, cam_intr)
    return p2d[..., :2] / p2d[..., 2:3]


@functools.lru_cache(maxsize=16)
def _grid_normalizer(img_shape: Tuple[int, int], dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """[(W-1)/2, (H-1)/2] on ``device``, made once: built from the host on
    every call it would hold the host until the card reached the copy.  A
    tensor, not Python floats: the card divides by a host scalar as a
    multiply by its reciprocal, which may round otherwise than the JAX
    function's division."""
    h, w = img_shape
    with torch.inference_mode(False):
        return torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=dtype, device=device)


def pixels_to_grid(pix: torch.Tensor, img_shape: Tuple[int, int]) -> torch.Tensor:
    """Pixel coords -> [-1, 1] grid coords; the normalizer is (size-1)/2."""
    normalizer = _grid_normalizer(tuple(img_shape), pix.dtype, pix.device)
    return (pix - normalizer) / normalizer
