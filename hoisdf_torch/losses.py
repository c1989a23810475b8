"""Training losses (``hoisdf_tpu/losses.py``): pure functions returning
scalars, and the train loop's weighting (``weighted_total``).  The vote loss
also returns the softmax-aggregated hand joints.  Under a data-parallel group
the two losses normalised by a data-dependent count divide by the global
count (:func:`global_count`); the plain means need nothing, since every rank
holds as many rows."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from hoisdf_torch.config import Config
from hoisdf_torch.parallel.mesh import world_size


def global_count(count: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """A data-dependent count summed over the ranks of a data-parallel group
    (without gradient), and the world size; ``(count, 1)`` without one.

    The JAX package's step sees the global batch, so a loss normalised by
    such a count divides the global sum by the global count.  A rank's term
    ``world * local sum / global count`` makes the mean over ranks of the
    terms, and of their gradients (what DDP averages), that global ratio."""
    world = world_size()
    if world == 1:
        return count, 1
    count = count.detach().float().clone()
    dist.all_reduce(count)
    return count, world


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


def joint_vote_loss(cfg: Config, hand_points: torch.Tensor, hand_off: torch.Tensor,
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
    count, world = global_count(cls_gt.sum())
    loss_joint_3d = reg.sum(dim=(1, 2, 3, 4)) / torch.clamp(count, min=1.0)
    loss_joint_3d = world * loss_joint_3d.mean() / 3.0

    loss_joint_cls = torch.mean(bce_with_logits(hand_cls, cls_gt[None].expand(hand_cls.shape)))

    weights = torch.softmax(hand_cls, dim=2)[..., None]  # over points
    hand_joints = torch.sum(votes * weights, dim=2)  # [L,B,J,3] metres
    loss_all_joint_3d = torch.mean(
        smooth_l1(hand_joints * 1000.0, joint_gt[None].expand(hand_joints.shape)))
    return loss_joint_3d, loss_joint_cls, loss_all_joint_3d, hand_joints


def mano_loss(cfg: Config, preds: Dict[str, torch.Tensor], gts: Dict[str, torch.Tensor]
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


def mano_shape_loss(cfg: Config, pred_shape: torch.Tensor, gt_shape: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Shape-only supervision of the IK variant: MSE plus a regulariser."""
    param = cfg.lambda_manoshape * torch.mean(
        (pred_shape - gt_shape[None].expand(pred_shape.shape)) ** 2)
    reg = cfg.mano_lambda_regulshape * torch.mean(pred_shape ** 2)
    return {"shape_param_loss": param, "shape_reg_loss": reg}


def sdf_part_classifier_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Part-class cross-entropy at the supervised SDF points, labels -1
    ignored.  logits [B,P,C]; labels [B,P] int."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    count, world = global_count(valid.sum())
    return world * torch.where(valid, nll, torch.zeros_like(nll)).sum() / torch.clamp(count, min=1)


def weighted_total(cfg: Config, losses: Dict[str, torch.Tensor]) -> torch.Tensor:
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
