"""Training losses of the reference (a frozen copy of the port's, one process),
and the train loop's weighting."""

from __future__ import annotations

from typing import Dict, Tuple

import torch



def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """SmoothL1Loss(reduction='none') with beta 1."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE-with-logits."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """BCELoss on probabilities (the decoder's seg heads are sigmoided)."""
    p = torch.clamp(probs, eps, 1 - eps)
    return -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))


def joint_heatmap_loss(pred_hm: torch.Tensor, gt_hm: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every heatmap pixel."""
    return torch.mean((pred_hm - gt_hm) ** 2)


def sep_sdf_loss(hand_sdf, obj_sdf, hand_gt, obj_gt) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 on the hand and object SDF samples; preds [B,P,1], gts [B,P]."""
    return (torch.mean(torch.abs(hand_sdf - hand_gt[..., None])),
            torch.mean(torch.abs(obj_sdf - obj_gt[..., None])))


def joint_vote_loss(cfg, hand_points: torch.Tensor, hand_off: torch.Tensor,
                    hand_cls: torch.Tensor, joint_gt: torch.Tensor):
    """Per-point joint voting loss.

    hand_points [B,P,3] root-relative metres; hand_off [L,B,P,J*3]; hand_cls
    [L,B,P,J] membership logits; joint_gt [B,J,3] millimetres (root excluded).
    Returns (vote regression loss, membership BCE, aggregated-joint
    regression loss, hand joints [L,B,J,3] in metres)."""
    l, b, p, j = hand_cls.shape
    votes = hand_points[None, :, :, None, :] + hand_off.reshape(l, b, p, j, 3)
    dist = torch.linalg.vector_norm(
        hand_points[:, :, None, :] - joint_gt[:, None, :, :] / 1000.0, dim=-1)  # [B,P,J]
    cls_gt = (dist < cfg.hand_cls_dist).to(hand_off.dtype)

    gt_b = joint_gt[None, :, None]  # [1,B,1,J,3] mm
    reg = smooth_l1(votes * 1000.0, gt_b.expand(votes.shape)) * cls_gt[None, ..., None]
    # the masked sum over points, joints and the 3 coordinates, over the
    # membership count, then the mean over layers and coordinates (/ 3)
    loss_joint_3d = reg.sum(dim=(1, 2, 3, 4)) / torch.clamp(cls_gt.sum(), min=1.0)
    loss_joint_3d = loss_joint_3d.mean() / 3.0

    loss_joint_cls = torch.mean(bce_with_logits(hand_cls, cls_gt[None].expand(hand_cls.shape)))

    weights = torch.softmax(hand_cls, dim=2)[..., None]  # over points
    hand_joints = torch.sum(votes * weights, dim=2)  # [L,B,J,3] metres
    loss_all_joint_3d = torch.mean(
        smooth_l1(hand_joints * 1000.0, joint_gt[None].expand(hand_joints.shape)))
    return loss_joint_3d, loss_joint_cls, loss_all_joint_3d, hand_joints


def mano_loss(cfg, preds: Dict[str, torch.Tensor], gts: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """MSE on verts, joints, pose rotation matrices and shape, weighted by
    the lambdas; the ground truth broadcasts over decoder layers."""

    def mse_vs_gt(p, g):
        return torch.mean((p - g[None].expand(p.shape)) ** 2)

    return {
        "mano_mesh_loss": cfg.lambda_verts3d * mse_vs_gt(preds["verts3d"], gts["verts3d"]),
        "mano_joint_loss": cfg.lambda_joints3d * mse_vs_gt(preds["joints3d"], gts["joints3d"]),
        "pose_param_loss": cfg.lambda_manopose * mse_vs_gt(preds["mano_pose"], gts["mano_pose"]),
        "shape_param_loss": cfg.lambda_manoshape * mse_vs_gt(preds["mano_shape"],
                                                             gts["mano_shape"]),
    }


def weighted_total(cfg, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The train loop's weighting (main/train.py:115-127), summed; a key
    without a weight counts once."""
    w = {
        "sdfhand_loss": cfg.sdf_hand_weight,
        "sdfobj_loss": cfg.sdf_obj_weight,
        "joint_heatmap": cfg.hm_weight,
        "obj_seg": cfg.obj_hm_weight,
        "hand_seg": cfg.obj_hm_weight,
        "obj_rot": cfg.obj_rot_weight,
        "obj_trans": cfg.obj_trans_weight,
        "loss_joint_3d": cfg.joint_weight,
        "loss_joint_cls": cfg.cls_weight,
        "loss_all_joint_3d": cfg.joint_weight,
        "sdf_cls_loss": cfg.sdf_cls_weight,
    }
    total = None
    for k, v in losses.items():
        term = v * w.get(k, 1.0)
        total = term if total is None else total + term
    return total if total is not None else torch.zeros(())
