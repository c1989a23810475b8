"""Analytic MANO inverse kinematics, joints -> pose, for the ho3d_render
preset (``hoisdf_tpu/ops/ik.py``; the original's
``common/utils/inverse_kinematics.py:15-150``).

The global orientation comes from Kabsch (an SVD) on the five knuckle
directions, then each finger's three joints are recovered in turn as
axis-angle rotations of the template's bones, then MANO runs forward again.
The finger loop has static bounds, so it is unrolled; a sample whose Kabsch
rotation is a reflection keeps the identity pose (``valid_idx`` of the
original, a ``torch.where`` select).  Everything runs on the tensors' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.ops.rotations import batch_rodrigues, mat2aa

# Finger chains in 21-joint order: [root, knuckle, mid, tip-1, tip]
# (inverse_kinematics.py:73-79); group order maps to MANO pose slots 1..15.
FINGER_LIST = (
    (0, 5, 6, 7, 8),
    (0, 9, 10, 11, 12),
    (0, 17, 18, 19, 20),
    (0, 13, 14, 15, 16),
    (0, 1, 2, 3, 4),
)
KNUCKLES = (1, 5, 9, 13, 17)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def ik_solver_mano(buffers: ManoBuffers, pred_joints: torch.Tensor,
                   mano_shape: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """pred_joints [B, 21, 3] in metres (root first), mano_shape [B, 10] or
    None (the mean shape) -> verts [B, 778, 3] and joints [B, 21, 3] in
    metres at the predicted root, the shape, the axis-angle pose [B, 48] and
    ``vis`` [B, 1] (0 where the global rotation came out a reflection)."""
    b = pred_joints.shape[0]
    dtype, dev = pred_joints.dtype, pred_joints.device
    target = pred_joints[:, :21] - pred_joints[:, :1]
    shape = torch.zeros(b, 10, dtype=dtype, device=dev) if mano_shape is None else mano_shape
    _, template = mano_forward(buffers, torch.zeros(b, 48, dtype=dtype, device=dev), shape)
    template = template / 1000.0

    def knuckle_dirs(j):  # [B, 3, 5]
        return (j[:, list(KNUCKLES)] - j[:, :1]).transpose(1, 2)

    h = knuckle_dirs(template) @ knuckle_dirs(target).transpose(1, 2)
    u, _, vt = torch.linalg.svd(h)
    rot = vt.transpose(1, 2) @ u.transpose(1, 2)  # V U^T: the global orient
    valid = (torch.abs(torch.linalg.det(rot) + 1) > 1e-6)[:, None]  # not a reflection

    eye = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3)
    pose_mats = [eye] * 16
    axisang = [torch.zeros(b, 3, dtype=dtype, device=dev)] * 16
    axisang[0] = torch.where(valid, mat2aa(rot), axisang[0])
    pose_mats[0] = torch.where(valid[..., None], rot, eye)

    for g_idx, group in enumerate(FINGER_LIST):
        recon = [torch.zeros(b, 3, dtype=dtype, device=dev) for _ in range(5)]
        for j_idx in range(2, 5):
            vec_template = template[:, group[j_idx]] - template[:, group[j_idx - 1]]
            r_pa = rot
            for i in range(j_idx - 2):
                r_pa = r_pa @ pose_mats[g_idx * 3 + i + 1]
            recon[j_idx - 1] = torch.einsum(
                "bij,bj->bi", r_pa,
                template[:, group[j_idx - 1]] - template[:, group[j_idx - 2]],
            ) + recon[j_idx - 2]
            vec_target = torch.einsum("bji,bj->bi", r_pa,
                                      target[:, group[j_idx]] - recon[j_idx - 1])
            axis = torch.linalg.cross(vec_template, vec_target, dim=-1)
            axis = axis / (_norm(axis) + 1e-7)
            cosang = (torch.sum(vec_template * vec_target, -1, keepdim=True)
                      / (_norm(vec_template) + 1e-7) / (_norm(vec_target) + 1e-7))
            angle = torch.arccos(torch.clamp(cosang, -1 + 1e-7, 1 - 1e-7))
            aa = angle * axis
            slot = g_idx * 3 + j_idx - 1
            axisang[slot] = torch.where(valid, aa, axisang[slot])
            pose_mats[slot] = torch.where(valid[..., None], batch_rodrigues(aa),
                                          pose_mats[slot])

    pose = torch.stack(axisang, dim=1).reshape(b, 48)
    verts, joints = mano_forward(buffers, pose, shape)
    root = pred_joints[:, :1]
    return {"verts": verts / 1000.0 + root, "joints": joints / 1000.0 + root,
            "shape": shape, "pose": pose, "vis": valid.to(torch.int32)}
