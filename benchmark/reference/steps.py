"""The reference's eval outputs and train steps.

``eval_outputs`` is the port's eval step in f32: the forward in eval mode,
the voted joints and MANO on the final decoder layer.  ``train_step`` is the
port's train step: the forward in train mode with the step's generator, the
losses with the train loop's weights, autograd, and one AdamW step written
out (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-2 scaled by the learning
rate; the backbone's stem and block BNs frozen, as the original's name
filter leaves them).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from benchmark.reference.heatmap import render_gaussian_heatmap
from benchmark.reference.losses import (
    bce,
    joint_heatmap_loss,
    joint_vote_loss,
    mano_loss,
    sep_sdf_loss,
    smooth_l1,
    weighted_total,
)
from benchmark.reference.mano_head import mano_head_gt, mano_head_pred
from benchmark.reference.mano_layer import ManoBuffers
from benchmark.reference.model import HOISDF

SERVE_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans")


def vote_hand_joints(out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    off = out["hand_off"]
    votes = out["hand_points_notrans"][None, :, :, None, :] + off.reshape(*off.shape[:3], 20, 3)
    weights = torch.softmax(out["hand_cls"], dim=2)[..., None]
    return torch.sum(votes * weights, dim=2)[-1]


@torch.no_grad()
def eval_outputs(model: HOISDF, mano: ManoBuffers, batch: Mapping[str, torch.Tensor], *,
                 supervise_sdf: bool, forced: Optional[Mapping[str, torch.Tensor]] = None,
                 mano_rounding=None) -> Dict[str, torch.Tensor]:
    """The eval step's outputs for ``batch`` (decoded f32 inputs);
    ``mano_rounding`` rounds the MANO layer's product operands."""
    model.eval()
    out = model(dict(batch), supervise_sdf=supervise_sdf, forced=forced)
    pred = mano_head_pred(mano, out["mano_pose6d"][-1:], out["mano_shape"][-1:],
                          round_operands=mano_rounding)
    return {
        "obj_rot": out["obj_rot"][-1],
        "obj_trans": out["obj_trans"][-1],
        "hand_points_notrans": out["hand_points_notrans"],
        "hand_off": out["hand_off"],
        "hand_cls": out["hand_cls"],
        "decoder_heads": out["decoder_heads"],
        "hand_joints": vote_hand_joints(out),
        "mano_pose6d": out["mano_pose6d"][-1],
        "mano_shape": out["mano_shape"][-1],
        "mano_verts": pred["verts3d"][-1],
        "mano_joints": pred["joints3d"][-1],
        "hand_points": out["hand_points"],
        "obj_points": out["obj_points"],
    }


@torch.no_grad()
def mano_outputs(mano: ManoBuffers, pose6d: torch.Tensor, shape: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """MANO on given head outputs (pose6d [B,16,6], shape [B,10]) -> the
    meshes the eval step returns."""
    pred = mano_head_pred(mano, pose6d.float()[None], shape.float()[None])
    return {"mano_verts": pred["verts3d"][-1], "mano_joints": pred["joints3d"][-1]}


def compute_losses(cfg, out: Mapping[str, torch.Tensor], targets: Mapping[str, torch.Tensor],
                   mano: ManoBuffers) -> Dict[str, torch.Tensor]:
    losses: Dict[str, torch.Tensor] = {}
    clamp = cfg.clamping_distance
    losses["sdfhand_loss"], losses["sdfobj_loss"] = sep_sdf_loss(
        out["hand_sdf_pred"], out["obj_sdf_pred"],
        torch.clamp(targets["hand_sdf"], -clamp, clamp),
        torch.clamp(targets["obj_sdf"], -clamp, clamp))
    gt_hm = render_gaussian_heatmap(
        targets["joint_coord"], (cfg.output_hm_shape[1], cfg.output_hm_shape[2]), cfg.sigma)
    heads = out["decoder_heads"]
    losses["joint_heatmap"] = joint_heatmap_loss(heads[..., 0], gt_hm)
    losses["hand_seg"] = torch.mean(bce(heads[..., 1], targets["hand_seg"]))
    losses["obj_seg"] = torch.mean(bce(heads[..., 2], targets["obj_seg"]))
    joints_gt = targets["joint_cam_no_trans"][:, 1:]
    (losses["loss_joint_3d"], losses["loss_joint_cls"], losses["loss_all_joint_3d"],
     _) = joint_vote_loss(cfg, out["hand_points_notrans"], out["hand_off"], out["hand_cls"],
                          joints_gt)
    pred_mano = mano_head_pred(mano, out["mano_pose6d"], out["mano_shape"])
    gt_mano = mano_head_gt(mano, targets["mano_param"])
    losses.update(mano_loss(cfg, pred_mano, gt_mano))
    losses["obj_rot"] = torch.mean(smooth_l1(
        out["obj_rot"], targets["obj_rot"][None, :, None].expand(out["obj_rot"].shape)))
    losses["obj_trans"] = torch.mean(smooth_l1(
        out["obj_trans"],
        targets["rel_obj_trans"][None, :, None].expand(out["obj_trans"].shape)))
    return losses


def is_frozen(name: str) -> bool:
    parts = name.split(".")
    return parts[0] == "backbone_net" and any(p in ("bn1", "bn2", "bn3") for p in parts)


class AdamW:
    """AdamW over the model's trainable parameters, written out."""

    def __init__(self, model: HOISDF, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        self.params = {n: p for n, p in model.named_parameters() if not is_frozen(n)}
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for n, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.mul_(1.0 - lr * self.wd)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)


def train_step(cfg, model: HOISDF, opt: AdamW, mano: ManoBuffers,
               batch: Mapping[str, torch.Tensor], targets: Mapping[str, torch.Tensor],
               generator: Optional[torch.Generator], dist_range: float, lr: float, *,
               use_presampled: bool, forced: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """One step in train mode -> (the losses with ``total``, the token
    points by field of a field-guided step or None); leaves each
    parameter's gradient in ``.grad``."""
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(dict(batch), use_presampled=use_presampled, dist_range=float(dist_range),
                generator=generator, forced=forced)
    losses = compute_losses(cfg, out, targets, mano)
    total = weighted_total(cfg, losses)
    total.backward()
    opt.step(lr)
    losses = {k: v.detach() for k, v in losses.items()}
    losses["total"] = total.detach()
    picks = None if use_presampled else {"hand": out["hand_points"], "obj": out["obj_points"]}
    return losses, picks
