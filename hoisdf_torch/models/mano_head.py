"""MANO parameter head (``hoisdf_tpu/models/mano_head.py``): 6D-rotation
query outputs -> hand mesh per decoder layer, and the ground truth's mesh from
its axis-angle pose and shape; all in metres."""

from __future__ import annotations

from typing import Dict

import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.ops.rotations import batch_rodrigues, mat2aa, rot6d2mat

MANO_POSE_SIZE = 48  # 16 joints x 3


def mano_head_pred(buffers: ManoBuffers, pose6d: torch.Tensor,
                   shape: torch.Tensor) -> Dict[str, torch.Tensor]:
    """pose6d [L, B, 16, 6], shape [L, B, 10] -> per-layer MANO results."""
    l, b = pose6d.shape[:2]
    rotmats = rot6d2mat(pose6d.reshape(l * b * 16, 6))
    pose_aa = mat2aa(rotmats).reshape(l * b, MANO_POSE_SIZE)
    verts, joints = mano_forward(buffers, pose_aa, shape.reshape(l * b, 10))
    return {
        "verts3d": verts.reshape(l, b, 778, 3) / 1000.0,
        "joints3d": joints.reshape(l, b, 21, 3) / 1000.0,
        "mano_pose": rotmats.reshape(l, b, 16, 3, 3),
        "mano_shape": shape,
    }


def mano_head_gt(buffers: ManoBuffers, mano_params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Ground-truth MANO results from ``mano_params`` [B, 58] = 48 pose
    (axis-angle) + 10 shape.  The hand mean is zero under flat_hand_mean,
    so the pose is used as given."""
    gt_shape = mano_params[:, MANO_POSE_SIZE:]
    gt_pose = mano_params[:, :MANO_POSE_SIZE]
    gt_rotmat = batch_rodrigues(gt_pose.reshape(-1, 3)).reshape(-1, 16, 3, 3)
    verts, joints = mano_forward(buffers, gt_pose, gt_shape)
    return {
        "verts3d": verts / 1000.0,
        "joints3d": joints / 1000.0,
        "mano_pose": gt_rotmat,
        "mano_shape": gt_shape,
    }
