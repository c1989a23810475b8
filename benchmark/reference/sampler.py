"""The field-guided samplers of the reference: a frozen copy of the port's
``ops/point_sampling.py`` (the dense scan, coarse2fine and the "hier" cell
cascade), with its constants made on every call.

Lattice points are integer indices into a bins_n^3 unit-cube lattice in the
scaled SDF frame, out-of-bbox points score +inf, and each stage keeps the
``keep`` smallest |sdf| (``argsort(stable=True)``: ties to the lower index)."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch



def _on_device(value: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host constant on ``device``; a normal tensor even when first asked
    for under inference mode."""
    return torch.from_numpy(value).to(device)


def make_lattice(bins_n: int = 64) -> np.ndarray:
    """The unit-cube lattice in the scaled SDF frame, [bins_n^3, 3] f32, axis
    0 slowest (the original's index arithmetic)."""
    step = 2.0 / (bins_n - 1)
    r = np.arange(bins_n, dtype=np.float32) * step - 1.0
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


def _lattice(bins_n: int, device: torch.device) -> torch.Tensor:
    return _on_device(make_lattice(bins_n), device)


def _coarse_probes(bins_n: int, factor: int, device: torch.device) -> torch.Tensor:
    """The mean point of each factor^3 block of the lattice,
    [(bins_n/factor)^3, 3] f32, summed in f32 over the block in row-major
    order and divided by factor^3: the JAX package's ``mean`` bit for bit."""
    cb = bins_n // factor
    blocks = make_lattice(bins_n).reshape(cb, factor, cb, factor, cb, factor, 3)
    blocks = blocks.transpose(0, 2, 4, 1, 3, 5, 6).reshape(cb ** 3, factor ** 3, 3)
    acc = np.zeros((cb ** 3, 3), np.float32)
    for i in range(factor ** 3):
        acc += blocks[:, i]
    return _on_device(acc / np.float32(factor ** 3), device)


def _corner_offsets(h: float, device: torch.device) -> torch.Tensor:
    """The 8 corner offsets of a cell of half-width ``h``: [8, 3] f32."""
    return _on_device(np.array([[sx * h, sy * h, sz * h] for sx in (-1, 1)
                                for sy in (-1, 1) for sz in (-1, 1)], dtype=np.float32),
                      device)


def _child_offsets(s: int, child_factor: int, bins_n: int,
                   device: torch.device) -> torch.Tensor:
    """Flat-index offsets of a cell's s^3 children: [s^3] i64."""
    r = np.arange(s, dtype=np.int64) * child_factor
    return _on_device((r[:, None, None] * bins_n * bins_n + r[None, :, None] * bins_n
                       + r[None, None, :]).reshape(-1), device)


def _base_cells(bins_n: int, f0: int, device: torch.device) -> torch.Tensor:
    """The first stage's cell bases, every f0-th lattice point: [1, M] i64."""
    r = np.arange(bins_n // f0, dtype=np.int64) * f0
    return _on_device((r[:, None, None] * bins_n * bins_n + r[None, :, None] * bins_n
                       + r[None, None, :]).reshape(1, -1), device)


def scaled_to_cam(pts_scaled: torch.Tensor, center: torch.Tensor, sdf_scale):
    """Scaled-SDF-frame points [B,P,3] -> camera frame.  ``sdf_scale`` is a
    float or a per-item [B] tensor (the paired sampler folds two fields with
    their own scales into the batch axis)."""
    if isinstance(sdf_scale, torch.Tensor):
        sdf_scale = sdf_scale[:, None, None]
    return pts_scaled / sdf_scale + center[:, None, :]


def _in_bbox(pts_scaled, center, cam_intr, bbox, sdf_scale, z_guard=False):
    """Project scaled-frame points and test them against the pixel bbox.

    Unguarded, it divides by the projected z as the original's filter does
    (the dense scan and coarse2fine's final stage); ``z_guard=True`` also
    counts points at projected depth z <= 1e-6 as inside (a conservative
    pruning decision)."""
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


def _merge_topk(state, score, sdf, index, k: int):
    """The ``k`` smallest scores of [state, chunk]: ties go to the earlier
    entry, so over a scan of lattice-ordered chunks this is one stable sort
    by (score, lattice index), with the initial state's +inf entries ahead
    of every out-of-box point."""
    all_score = torch.cat([state[0], score], dim=1)
    sel = _smallest(all_score, k)
    return (torch.gather(all_score, 1, sel),
            torch.gather(torch.cat([state[1], sdf], dim=1), 1, sel),
            torch.gather(torch.cat([state[2], index], dim=1), 1, sel))


def sdf_guided_sample(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    center: torch.Tensor,
    cam_intr: torch.Tensor,
    bbox: torch.Tensor,
    *,
    sdf_scale,
    num_points: int,
    bins_n: int = 64,
    chunk: int = 32768,
    clamp: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the ``num_points`` lattice points nearest the predicted surface
    by scoring every point of the bins_n^3 lattice, ``chunk`` at a time (the
    chunk must divide the lattice, or cover it).  Returns (points [B, K, 3]
    in the scaled frame, sdf [B, K, 1] clamped)."""
    dev = center.device
    lattice = _lattice(bins_n, dev)
    n = lattice.shape[0]
    if not (n % chunk == 0 or chunk >= n):
        raise ValueError(f"sdf_infer_chunk={chunk} must divide the {n}-point lattice")
    chunk = min(chunk, n)
    b = center.shape[0]
    state = (torch.full((b, num_points), float("inf"), device=dev),
             torch.zeros(b, num_points, device=dev),
             torch.zeros(b, num_points, dtype=torch.long, device=dev))
    for c0 in range(0, n, chunk):
        pts = lattice[None, c0:c0 + chunk].expand(b, -1, -1)
        in_box = _in_bbox(pts, center, cam_intr, bbox, sdf_scale)
        sdf = sdf_fn(pts)
        score = torch.where(in_box, sdf.abs(), torch.full_like(sdf, float("inf")))
        ids = torch.arange(c0, c0 + chunk, device=dev).expand(b, -1)
        state = _merge_topk(state, score, sdf, ids, num_points)
    return lattice[state[2]], torch.clamp(state[1], -clamp, clamp)[..., None]


def sdf_guided_sample_coarse2fine(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    center: torch.Tensor,
    cam_intr: torch.Tensor,
    bbox: torch.Tensor,
    *,
    sdf_scale,
    num_points: int,
    bins_n: int = 64,
    coarse_factor: int = 4,
    keep_cells: int = 512,
    clamp: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage selection: probe the mean point of every coarse_factor^3
    block of the lattice, keep the ``keep_cells`` blocks nearest the surface
    (the conservative 8-corner bbox test), then score every lattice point of
    those blocks (the unguarded point test) and keep ``num_points``."""
    b, dev = center.shape[0], center.device
    f = coarse_factor
    cb = bins_n // f
    if bins_n % f or not keep_cells <= cb ** 3:
        raise ValueError(f"coarse2fine: keep_cells={keep_cells} of the {cb}^3 cells of "
                         f"{f}^3 points of a {bins_n}^3 lattice")
    if num_points > keep_cells * f ** 3:
        raise ValueError(f"coarse2fine: {keep_cells} cells of {f}^3 points cannot give "
                         f"{num_points} points")
    step = 2.0 / (bins_n - 1)
    coarse = _coarse_probes(bins_n, f, dev)[None].expand(b, -1, -1)
    sdf_c = sdf_fn(coarse)
    in_box_c = _cell_overlaps_bbox(coarse, f, step, center, cam_intr, bbox, sdf_scale)
    score_c = torch.where(in_box_c, sdf_c.abs(), torch.full_like(sdf_c, float("inf")))
    cell = _smallest(score_c, keep_cells)  # [B, keep]
    base = ((cell // (cb * cb)) * f * bins_n * bins_n + ((cell // cb) % cb) * f * bins_n
            + (cell % cb) * f)
    child = (base[..., None] + _child_offsets(f, 1, bins_n, dev)).reshape(b, -1)
    pts = _lattice(bins_n, dev)[child]  # [B, keep * f^3, 3]
    sdf_f = sdf_fn(pts)
    in_box = _in_bbox(pts, center, cam_intr, bbox, sdf_scale)
    score = torch.where(in_box, sdf_f.abs(), torch.full_like(sdf_f, float("inf")))
    sel = _smallest(score, num_points)
    points = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3))
    sdf = torch.gather(sdf_f, 1, sel)
    return points, torch.clamp(sdf, -clamp, clamp)[..., None]


def sdf_guided_sample_hierarchical(
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    center: torch.Tensor,
    cam_intr: torch.Tensor,
    bbox: torch.Tensor,
    *,
    sdf_scale,
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
    ``sdf_fn`` maps scaled-frame points [B, M, 3] to sdf [B, M];
    ``sdf_scale`` is a float or a per-item [B] tensor.  Returns (points
    [B, K, 3] in the scaled frame, sdf [B, K, 1] clamped).
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
        return torch.gather(bases, 1, sel), pts, sdf, sel

    f0 = factors[0]
    bases = _base_cells(bins_n, f0, dev).expand(b, -1)
    bases, _, _, _ = probe(bases, f0, levels[0][1], final=False)
    for (pf, _), (cf, keep) in zip(levels[:-1], levels[1:]):
        bases, _, _, _ = probe(child_bases(bases, pf, cf), cf, keep, final=False)

    _, pts, sdf, sel = probe(child_bases(bases, factors[-1], 1), 1, num_points, final=True)
    points = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3))
    sdf = torch.gather(sdf, 1, sel)
    return points, torch.clamp(sdf, -clamp, clamp)[..., None]


def first_stage_probes(bins_n: int, f0: int, device) -> torch.Tensor:
    """The centres of the cascade's first-stage cells of factor ``f0``:
    [(bins_n/f0)^3, 3] in the scaled frame."""
    step = 2.0 / (bins_n - 1)
    r = torch.arange(bins_n // f0, device=device, dtype=torch.float32) * (f0 * step) - 1.0
    r = r + (f0 - 1) * 0.5 * step
    gx, gy, gz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
