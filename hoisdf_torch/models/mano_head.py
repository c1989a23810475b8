"""MANO parameter head for predictions (``hoisdf_tpu/models/mano_head.py``):
6D-rotation query outputs -> hand mesh, in metres."""

from __future__ import annotations

from typing import Dict

import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.ops.rotations import mat2aa, rot6d2mat

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
