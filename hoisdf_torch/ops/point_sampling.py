"""Field-guided point sampling: the hierarchical cascade of
``hoisdf_tpu/ops/point_sampling.py``.

The whole batch is processed at once with static shapes: lattice points are
integer indices into a bins_n^3 unit-cube lattice in the scaled SDF frame,
out-of-bbox points score +inf, and each stage keeps the ``keep`` smallest
|sdf|.  Selection is ``argsort(stable=True)``, which breaks ties by the lower
index exactly like ``lax.top_k``; out-of-box probes all tie at +inf, so the
tie order decides which cells survive the pruning stages.

The cascade's constants (cell corners, child offsets, the base lattice) are
made once per device and shape: built from host data on every call, each
would hold the host until the card reached its copy.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch


def _on_device(value: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host constant on ``device``; a normal tensor even when first asked
    for under inference mode."""
    with torch.inference_mode(False):
        return torch.from_numpy(value).to(device)


@functools.lru_cache(maxsize=16)
def _corner_offsets(h: float, device: torch.device) -> torch.Tensor:
    """The 8 corner offsets of a cell of half-width ``h``: [8, 3] f32."""
    return _on_device(np.array([[sx * h, sy * h, sz * h] for sx in (-1, 1)
                                for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float32),
                      device)


@functools.lru_cache(maxsize=16)
def _child_offsets(s: int, child_factor: int, bins_n: int,
                   device: torch.device) -> torch.Tensor:
    """Flat-index offsets of a cell's s^3 children: [s^3] i64."""
    r = np.arange(s, dtype=np.int64) * child_factor
    return _on_device((r[:, None, None] * bins_n * bins_n + r[None, :, None] * bins_n
                       + r[None, None, :]).reshape(-1), device)


@functools.lru_cache(maxsize=16)
def _base_cells(bins_n: int, f0: int, device: torch.device) -> torch.Tensor:
    """The first stage's cell bases, every f0-th lattice point: [1, M] i64."""
    r = np.arange(bins_n // f0, dtype=np.int64) * f0
    return _on_device((r[:, None, None] * bins_n * bins_n + r[None, :, None] * bins_n
                       + r[None, None, :]).reshape(1, -1), device)


def scaled_to_cam(pts_scaled: torch.Tensor, center: torch.Tensor, sdf_scale: float):
    """Scaled-SDF-frame points [B,P,3] -> camera frame."""
    return pts_scaled / sdf_scale + center[:, None, :]


def _in_bbox(pts_scaled, center, cam_intr, bbox, sdf_scale, z_guard=False):
    """Project scaled-frame points and test them against the pixel bbox.

    ``z_guard=True`` also counts points at projected depth z <= 1e-6 as
    inside (a conservative pruning decision)."""
    cam_pts = scaled_to_cam(pts_scaled, center, sdf_scale)
    p2d = torch.einsum("bpc,bkc->bpk", cam_pts, cam_intr)
    pix = p2d[..., :2] / p2d[..., 2:3]
    inside = (
        (pix[..., 0] > bbox[:, None, 0]) & (pix[..., 0] < bbox[:, None, 2])
        & (pix[..., 1] > bbox[:, None, 1]) & (pix[..., 1] < bbox[:, None, 3])
    )
    if z_guard:
        inside = inside | (p2d[..., 2] <= 1e-6)
    return inside


def _cell_overlaps_bbox(probe_pts, factor, step, center, cam_intr, bbox, sdf_scale):
    """Conservative visibility of a cell: does the pixel AABB of its 8 corner
    lattice points overlap the bbox?  Cells with a corner at depth <= 1e-6
    count as visible.  At factor 1 this is the z-guarded point test."""
    if factor == 1:
        return _in_bbox(probe_pts, center, cam_intr, bbox, sdf_scale, z_guard=True)
    corners = _corner_offsets((factor - 1) * 0.5 * step, probe_pts.device)
    pts = probe_pts[:, :, None, :] + corners[None, None]  # [B, M, 8, 3]
    cam_pts = scaled_to_cam(pts.reshape(pts.shape[0], -1, 3), center,
                            sdf_scale).reshape(pts.shape)
    p2d = torch.einsum("bmqc,bkc->bmqk", cam_pts, cam_intr)
    z = p2d[..., 2]
    straddles_camera = (z <= 1e-6).any(dim=2)
    pix = p2d[..., :2] / torch.clamp(z, min=1e-6)[..., None]
    lo = pix.amin(dim=2)
    hi = pix.amax(dim=2)
    return straddles_camera | (
        (hi[..., 0] > bbox[:, None, 0]) & (lo[..., 0] < bbox[:, None, 2])
        & (hi[..., 1] > bbox[:, None, 1]) & (lo[..., 1] < bbox[:, None, 3])
    )


def _smallest(score: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the ``keep`` smallest scores per row, ties to the lower index."""
    return torch.argsort(score, dim=1, stable=True)[:, :keep]


def sdf_guided_sample_hierarchical(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    center: torch.Tensor,
    cam_intr: torch.Tensor,
    bbox: torch.Tensor,
    *,
    sdf_scale: float,
    num_points: int,
    bins_n: int = 64,
    levels: Tuple[Tuple[int, int], ...] = ((4, 512), (2, 896)),
    clamp: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the ``num_points`` lattice points nearest the predicted surface
    through a cell-subdivision cascade.

    ``levels`` are ``(cell_factor, keep)`` pairs with strictly decreasing
    factors, each dividing the previous.  Level i probes the centers of the
    active cells' sub-cells and keeps the ``keep`` nearest-surface ones; the
    final stage evaluates every fine lattice point of the surviving cells.
    ``sdf_fn`` maps scaled-frame points [B, M, 3] to sdf [B, M].  Returns
    (points [B, K, 3] in the scaled frame, sdf [B, K, 1] clamped).
    """
    b = center.shape[0]
    dev = center.device
    step = 2.0 / (bins_n - 1)
    factors = [f for f, _ in levels]
    if not all(factors[i] % factors[i + 1] == 0 and factors[i] > factors[i + 1]
               for i in range(len(factors) - 1)) or bins_n % factors[0]:
        raise ValueError(f"bad cascade levels {levels} for bins_n={bins_n}")

    def cell_coords(base_idx, factor):
        ci = base_idx // (bins_n * bins_n)
        cj = (base_idx // bins_n) % bins_n
        ck = base_idx % bins_n
        origin = torch.stack([ci, cj, ck], dim=-1).float() * step - 1.0
        return origin + (factor - 1) * 0.5 * step

    def child_bases(bases, parent_factor, child_factor):
        offs = _child_offsets(parent_factor // child_factor, child_factor, bins_n, dev)
        return (bases[..., None] + offs[None, None]).reshape(b, -1)

    def probe(bases, factor, keep, final):
        pts = cell_coords(bases, factor)  # [B, M, 3]
        sdf = sdf_fn(pts)  # [B, M]
        in_box = _cell_overlaps_bbox(pts, factor, step, center, cam_intr, bbox, sdf_scale)
        score = torch.where(in_box, sdf.abs(), torch.full_like(sdf, float("inf")))
        if final:
            if score.shape[1] < keep:
                raise ValueError(
                    f"hier cascade yields {score.shape[1]} candidate points < "
                    f"num_points={keep}; raise the last level's keep")
        else:
            keep = min(keep, score.shape[1])  # small lattices (tests)
        sel = _smallest(score, keep)
        return torch.take_along_dim(bases, sel, dim=1), pts, sdf, sel

    f0 = factors[0]
    bases = _base_cells(bins_n, f0, dev).expand(b, -1)
    bases, _, _, _ = probe(bases, f0, levels[0][1], final=False)
    for (pf, _), (cf, keep) in zip(levels[:-1], levels[1:]):
        bases, _, _, _ = probe(child_bases(bases, pf, cf), cf, keep, final=False)

    _, pts, sdf, sel = probe(child_bases(bases, factors[-1], 1), 1, num_points, final=True)
    points = torch.take_along_dim(pts, sel[..., None], dim=1)
    sdf = torch.take_along_dim(sdf, sel, dim=1)
    return points, torch.clamp(sdf, -clamp, clamp)[..., None]
