"""The dense-scan oracle's quality gate for the field-guided samplers
(``hoisdf_tpu/ops/selection_quality.py``).

The "hier" cascade replaces the dense bins_n^3 scan with pruned probing,
which can only hurt by missing near-surface lattice points; so its selection
is measured against the dense scan (``sdf_guided_sample``) on the same field:

- ``overlap_at_k``: the share of the oracle's top-K lattice points that the
  cascade also selects;
- ``mean_abs_ratio`` / ``max_abs_ratio``: mean / max |sdf| of the cascade's
  selection over the oracle's (1.0: indistinguishable);
- ``rank_corr``: Spearman correlation of the two selections' ascending
  |sdf| order statistics.

``gate`` is the promotion rule for the ``hier_levels`` defaults: overlap@K
>= 0.95 and mean |sdf| ratio <= 1.05 for every batch item.  The fields run
on the port's synthetic MANO stand-in, on the device of the caller's
choosing.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.ops.point_sampling import sdf_guided_sample, sdf_guided_sample_hierarchical


def _lattice_keys(points: np.ndarray, bins_n: int) -> np.ndarray:
    """Scaled-frame lattice points -> flat integer lattice indices."""
    step = 2.0 / (bins_n - 1)
    idx = np.rint((points + 1.0) / step).astype(np.int64)
    return (idx[..., 0] * bins_n + idx[..., 1]) * bins_n + idx[..., 2]


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 1.0


def selection_quality(
    sdf_fn: Callable,
    center: torch.Tensor,
    cam_intr: torch.Tensor,
    bbox: torch.Tensor,
    *,
    sdf_scale: float,
    num_points: int,
    bins_n: int,
    levels: Sequence[Tuple[int, int]],
    chunk: int = 32768,
) -> Dict[str, np.ndarray]:
    """Per-batch-item quality of the hier cascade against the dense scan."""
    oracle_pts, oracle_sdf = sdf_guided_sample(
        sdf_fn, center, cam_intr, bbox, sdf_scale=sdf_scale, num_points=num_points,
        bins_n=bins_n, chunk=chunk)
    cand_pts, cand_sdf = sdf_guided_sample_hierarchical(
        sdf_fn, center, cam_intr, bbox, sdf_scale=sdf_scale, num_points=num_points,
        bins_n=bins_n, levels=tuple(tuple(lv) for lv in levels))
    o_keys = _lattice_keys(oracle_pts.cpu().numpy(), bins_n)
    c_keys = _lattice_keys(cand_pts.cpu().numpy(), bins_n)
    o_abs = np.abs(oracle_sdf.cpu().numpy())[..., 0]
    c_abs = np.abs(cand_sdf.cpu().numpy())[..., 0]

    b = o_keys.shape[0]
    overlap, mean_ratio, max_ratio, rank_corr = (np.empty(b) for _ in range(4))
    for i in range(b):
        overlap[i] = len(set(o_keys[i]) & set(c_keys[i])) / num_points
        om, cm = o_abs[i].mean(), c_abs[i].mean()
        mean_ratio[i] = cm / om if om > 0 else 1.0
        o_mx, c_mx = o_abs[i].max(), c_abs[i].max()
        max_ratio[i] = c_mx / o_mx if o_mx > 0 else 1.0
        rank_corr[i] = _spearman(np.sort(c_abs[i]), np.sort(o_abs[i]))
    return {"overlap_at_k": overlap, "mean_abs_ratio": mean_ratio,
            "max_abs_ratio": max_ratio, "rank_corr": rank_corr}


def gate(report: Dict[str, np.ndarray], *, min_overlap: float = 0.95,
         max_mean_ratio: float = 1.05) -> bool:
    """The promotion rule for the ``hier_levels`` defaults (module doc)."""
    return bool((report["overlap_at_k"] >= min_overlap).all()
                and (report["mean_abs_ratio"] <= max_mean_ratio).all())


def _distance_field(surf: torch.Tensor) -> Callable:
    """Unsigned distance to the point set ``surf`` [B, V, 3], through
    squared distances by matmul (no [B, M, V, 3] intermediate)."""
    def field(pts):  # [B, M, 3] -> [B, M]
        p2 = (pts ** 2).sum(-1)
        v2 = (surf ** 2).sum(-1)
        cross = torch.einsum("bmc,bvc->bmv", pts, surf)
        d2 = p2[..., None] + v2[:, None, :] - 2.0 * cross
        return torch.sqrt(torch.clamp(d2, min=0.0)).amin(-1)

    return field


def _posed_hands(batch: int, seed: int, pose_scale: float, device):
    """Posed synthetic MANO hands (mm) and the seeded generator's state."""
    buffers = ManoBuffers.from_model(make_synthetic_mano(0), device)
    rng = np.random.RandomState(seed)
    pose = torch.from_numpy(rng.randn(batch, 48).astype(np.float32) * pose_scale).to(device)
    betas = torch.from_numpy(rng.randn(batch, 10).astype(np.float32) * 0.5).to(device)
    verts_mm, joints_mm = mano_forward(buffers, pose, betas)
    return verts_mm, joints_mm, rng


def stress_geometry(batch: int = 2, seed: int = 3, sdf_scale: float = 3.1, device="cpu"):
    """The gate's stress scene at production scale: a 2.5x-scaled posed MANO
    hand (thin fingers stress the coarse pruning stages) and a random object
    blob, seen through a tight pixel bbox.  Returns ``(field, center,
    cam_intr, bbox)`` for ``selection_quality(..., sdf_scale=3.1,
    num_points=600, bins_n=64)``."""
    device = torch.device(device)
    verts_mm, joints_mm, rng = _posed_hands(batch, seed, 0.6, device)
    verts_s = (verts_mm - joints_mm[:, :1]) / 1000.0 * sdf_scale * 2.5
    obj = torch.from_numpy(rng.randn(batch, 200, 3).astype(np.float32) * 0.35
                           + np.array([0.3, -0.2, 0.1], np.float32)).to(device)
    field = _distance_field(torch.cat([verts_s, obj], dim=1))
    center = torch.tensor([[0.0, 0.0, 0.6]], device=device).repeat(batch, 1)
    cam = torch.tensor([[[600.0, 0, 320], [0, 600, 240], [0, 0, 1]]],
                       device=device).repeat(batch, 1, 1)
    bbox = torch.tensor([[200.0, 150.0, 480.0, 360.0]], device=device).repeat(batch, 1)
    return field, center, cam, bbox


def perturbed_field(field: Callable, seed: int = 0, amplitude: float = 0.02,
                    num_waves: int = 8, max_freq: float = 6.0) -> Callable:
    """``field`` plus smooth random noise, a model of a trained decoder's
    error: ``num_waves`` sinusoids with per-axis wavevector components
    uniform in +-``max_freq`` and Dirichlet amplitudes summing to
    amplitude * sqrt(num_waves) (worst-case gradient about 0.59 at the
    defaults).  Oracle and cascade see the same field, so the report still
    isolates the pruning's loss."""
    rng = np.random.RandomState(seed)
    k = rng.uniform(-max_freq, max_freq, size=(num_waves, 3)).astype(np.float32)
    phase = rng.uniform(0.0, 2 * np.pi, size=(num_waves,)).astype(np.float32)
    amp = (rng.dirichlet(np.ones(num_waves)) * amplitude * num_waves ** 0.5).astype(np.float32)
    consts = {}

    def noisy(pts):  # [B, M, 3] -> [B, M]
        if pts.device not in consts:
            consts[pts.device] = tuple(torch.from_numpy(a).to(pts.device)
                                       for a in (k, phase, amp))
        kt, ph, am = consts[pts.device]
        waves = torch.sin(torch.einsum("bmc,wc->bmw", pts, kt) + ph)
        return field(pts) + waves @ am

    return noisy


def hand_geometry_field(batch: int = 2, seed: int = 3, sdf_scale: float = 3.1,
                        device="cpu") -> Callable:
    """The unsigned distance field of posed synthetic MANO hands in the
    scaled lattice frame (hand-shaped geometry: a sphere is too easy for the
    pruning)."""
    verts_mm, joints_mm, _ = _posed_hands(batch, seed, 0.4, torch.device(device))
    return _distance_field((verts_mm - joints_mm[:, :1]) / 1000.0 * sdf_scale)
