"""Evaluation metrics (``hoisdf_tpu/metrics.py``): hand MJE / PA-MJE, object
ADD-S / MCE / OCE / MME, the batched mesh metrics of dexycb_full (EPE,
F-scores), and the PCK / AUC accumulator.

The metric functions are batched torch code and run on the tensors' device,
so an eval batch's metrics take a few launches and one host transfer;
``EvalUtil`` accumulates on the host in numpy, as the original's
``common/eval_util.py`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hoisdf_torch.ops.rotations import batch_rodrigues, rigid_align

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has only trapz


def _pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., M, 3] -> Euclidean distances [..., N, M], as norms
    of the differences: a matrix product would lose f32 bits, and
    ``torch.cdist``'s exact mode took 29 ms for one batch's ADD-S (22 x
    1,000 x 1,000) on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
    eval line)."""
    return torch.linalg.vector_norm(a[..., :, None, :] - b[..., None, :, :], dim=-1)


# ---- hand metrics ------------------------------------------------------------

def eval_hand_joint(pred_joints: torch.Tensor, gt_joints: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MJE and Procrustes-aligned MJE of [B, J, 3] joints, averaged over the
    batch (metrics.py:213-232); same unit in and out."""
    mje = torch.linalg.vector_norm(pred_joints - gt_joints, dim=-1).mean()
    aligned = rigid_align(pred_joints, gt_joints)
    pamje = torch.linalg.vector_norm(aligned - gt_joints, dim=-1).mean()
    return mje, pamje


# ---- object metrics ----------------------------------------------------------

_CORNER_IDX = ((0, 1, 0, 0, 1, 0, 1, 1), (0, 0, 1, 0, 1, 1, 0, 1), (0, 0, 0, 1, 0, 1, 1, 1))


def _aabb_corners(meshes: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] -> the 8 corners [B, 8, 3] of each axis-aligned box."""
    mm = torch.stack([meshes.amin(dim=1), meshes.amax(dim=1)], dim=2)  # [B, 3, 2]
    return torch.stack([mm[:, i, list(_CORNER_IDX[i])] for i in range(3)], dim=2)


def add_s(pred_meshes: torch.Tensor, target_meshes: torch.Tensor) -> torch.Tensor:
    """Symmetric ADD: mean over predicted vertices of the distance to the
    nearest target vertex, [B, N, 3] x 2 -> [B] (metrics.py:62-68)."""
    return _pairwise(pred_meshes, target_meshes).amin(dim=2).mean(dim=1)


def obj_metrics_dexycb(pred_meshes, target_meshes):
    """ADD-S and MCE (the mean bounding-box corner error) per sample."""
    mce = torch.linalg.vector_norm(
        _aabb_corners(pred_meshes) - _aabb_corners(target_meshes), dim=-1).mean(dim=-1)
    return add_s(pred_meshes, target_meshes), mce


def obj_metrics_ho3d(pred_meshes, target_meshes):
    """ADD-S and MME (the mean per-vertex error) per sample."""
    mme = torch.linalg.vector_norm(target_meshes - pred_meshes, dim=-1).mean(dim=-1)
    return add_s(pred_meshes, target_meshes), mme


def transform_templates(templates: torch.Tensor, rot_aa: torch.Tensor,
                        trans: torch.Tensor) -> torch.Tensor:
    """Template vertices [B, N, 3] posed by axis-angle [B, 3] and translation
    [B, 3]: verts @ R^T + t (metrics.py:151-168)."""
    rot = batch_rodrigues(rot_aa)
    return torch.einsum("bnk,bjk->bnj", templates, rot) + trans[:, None, :]


def eval_batched_obj_direct(pred_rot: torch.Tensor, pred_trans: torch.Tensor,
                            gt_rot: torch.Tensor, gt_trans: torch.Tensor,
                            template_meshes: torch.Tensor, *, ho3d: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """Per-sample object-pose metrics from point-averaged rotation and
    translation [B, 3] and each sample's template [B, N, 3]
    (metrics.py:116-185): ADDS and MME for HO3D, ADDS, MCE and OCE for
    DexYCB.  The caller masks and aggregates."""
    target = transform_templates(template_meshes, gt_rot, gt_trans)
    pred = transform_templates(template_meshes, pred_rot, pred_trans)
    if ho3d:
        adds, mme = obj_metrics_ho3d(pred, target)
        return {"ADDS": adds, "MME": mme}
    adds, mce = obj_metrics_dexycb(pred, target)
    return {"ADDS": adds, "MCE": mce,
            "OCE": torch.linalg.vector_norm(pred_trans - gt_trans, dim=-1)}


# ---- F-score and mesh error ------------------------------------------------

def _f_from(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    total = recall + precision
    return torch.where(total > 0, 2 * recall * precision / torch.where(total > 0, total, 1.0),
                       torch.zeros_like(total))


def fscore_pr(gt_points: torch.Tensor, pred_points: torch.Tensor, threshold: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F-score, precision, recall) of one sample's point sets [N, 3] / [M, 3]
    at a distance threshold (eval_util.py:117-140), with the original's
    naming: ``recall`` is the share of predicted points near a ground-truth
    point, ``precision`` the share of ground-truth points near a prediction.
    The F-score is symmetric either way."""
    d = _pairwise(gt_points, pred_points)
    recall = (d.amin(dim=0) < threshold).float().mean()  # pred -> gt
    precision = (d.amin(dim=1) < threshold).float().mean()  # gt -> pred
    return _f_from(precision, recall), precision, recall


def fscore(gt_points: torch.Tensor, pred_points: torch.Tensor, threshold: float
           ) -> torch.Tensor:
    """F-score only (see :func:`fscore_pr`)."""
    return fscore_pr(gt_points, pred_points, threshold)[0]


def mesh_metrics_batch(gt_verts: torch.Tensor, pred_verts: torch.Tensor,
                       thresholds: Sequence[float]) -> Dict[str, torch.Tensor]:
    """dexycb_full's mesh metrics of a batch [B, N, 3] x 2, in one batched
    pass on the tensors' device: per-vertex correspondence distances
    ``epe_dist`` / ``epe_dist_aligned`` [B, N] (what ``EvalUtil.feed``
    takes) and F-scores ``fscores`` / ``fscores_aligned`` [B, T] of the plain
    and the Procrustes-aligned prediction.  Each pairwise matrix is built once
    and serves every threshold.  Recall and precision are named as
    :func:`fscore_pr` names them (the JAX package swaps the two names here;
    the F-score is the same)."""
    aligned = rigid_align(pred_verts, gt_verts)

    def per_variant(pv):
        d = _pairwise(gt_verts, pv)
        d_gt, d_pred = d.amin(dim=2), d.amin(dim=1)  # gt -> pred, pred -> gt
        fs = []
        for t in thresholds:
            recall = (d_pred < t).float().mean(dim=1)
            precision = (d_gt < t).float().mean(dim=1)
            fs.append(_f_from(precision, recall))
        return torch.linalg.vector_norm(gt_verts - pv, dim=-1), torch.stack(fs, dim=1)

    epe, fs = per_variant(pred_verts)
    epe_a, fs_a = per_variant(aligned)
    return {"epe_dist": epe, "epe_dist_aligned": epe_a, "fscores": fs,
            "fscores_aligned": fs_a}


# ---- PCK / AUC accumulator (host) ----------------------------------------------

class EvalUtil:
    """PCK-curve / AUC / EPE accumulator (common/eval_util.py:11-101), numpy."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self.data: List[List[np.ndarray]] = [[] for _ in range(num_kp)]

    def feed(self, keypoint_gt, keypoint_pred, keypoint_vis=None):
        dist = np.linalg.norm(np.asarray(keypoint_gt) - np.asarray(keypoint_pred), axis=-1)
        self.feed_dist(dist, keypoint_vis)

    def feed_dist(self, dist, keypoint_vis=None):
        """Per-keypoint distances [num_kp] (the batched mesh metrics compute
        them on the device)."""
        dist = np.asarray(dist)
        if keypoint_vis is None:
            keypoint_vis = np.ones(dist.shape[0], bool)
        keypoint_vis = np.asarray(keypoint_vis).astype(bool).reshape(-1)
        for i in range(self.num_kp):
            if keypoint_vis[i]:
                self.data[i].append(dist[i])

    def _pck(self, kp_id: int, threshold: float) -> Optional[float]:
        if len(self.data[kp_id]) == 0:
            return None
        return float((np.asarray(self.data[kp_id]) <= threshold).mean())

    def get_measures(self, val_min: float, val_max: float, steps: int
                     ) -> Tuple[float, float, float, List[float], List[float]]:
        """(mean EPE, median EPE, AUC, PCK curve, thresholds)."""
        thresholds = np.linspace(val_min, val_max, steps)
        norm_factor = _trapezoid(np.ones_like(thresholds), thresholds)
        epe_mean_all, epe_median_all, auc_all, pck_curve_all = [], [], [], []
        for i in range(self.num_kp):
            if len(self.data[i]) == 0:
                continue
            d = np.asarray(self.data[i])
            epe_mean_all.append(float(d.mean()))
            epe_median_all.append(float(np.median(d)))
            pck = np.asarray([self._pck(i, t) for t in thresholds])
            pck_curve_all.append(pck)
            auc_all.append(float(_trapezoid(pck, thresholds) / norm_factor))
        pck_curve = np.mean(np.stack(pck_curve_all), axis=0)
        return (float(np.mean(epe_mean_all)), float(np.mean(epe_median_all)),
                float(np.mean(auc_all)), pck_curve.tolist(), thresholds.tolist())
