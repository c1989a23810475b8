"""MANO forward in PyTorch for the reference: blend shapes, forward
kinematics, skinning (a frozen copy of the port's ``mano/layer.py``, the
path of its MANO head only).

Geometry runs in f32 whatever the model's compute type; on the card f32
matmuls stay full f32 unless TF32 is switched on.  Outputs are millimetres.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.mano_model import (
    JOINT_REORDER,
    LEV1_IDXS,
    LEV2_IDXS,
    LEV3_IDXS,
    TIPS_LEFT,
    TIPS_RIGHT,
    TRANSFORM_REORDER,
    ManoModel,
)
from benchmark.reference.rotations import batch_rodrigues


_MODEL_FIELDS = ("betas", "shapedirs", "posedirs", "v_template", "j_regressor", "weights",
                 "hands_components", "hands_mean")


class ManoBuffers(NamedTuple):
    """The model's f32 arrays and the forward's index constants, all on one
    device (``to`` moves them together): indexing with host lists would copy
    them to the card on every call and hold the host until the copy ran."""

    betas: torch.Tensor  # [10]
    shapedirs: torch.Tensor  # [778, 3, 10]
    posedirs: torch.Tensor  # [778, 3, 135]
    v_template: torch.Tensor  # [778, 3]
    j_regressor: torch.Tensor  # [16, 778]
    weights: torch.Tensor  # [778, 16]
    hands_components: torch.Tensor  # [45, 45] PCA pose basis
    hands_mean: torch.Tensor  # [45] mean pose (axis-angle)
    lev1: torch.Tensor  # [5] i64, the FK levels' joints (LEV*_IDXS)
    lev2: torch.Tensor  # [5]
    lev3: torch.Tensor  # [5]
    transform_reorder: torch.Tensor  # [16]
    tips: torch.Tensor  # [5] fingertip vertices, right hand
    tips_left: torch.Tensor  # [5] fingertip vertices, left hand
    joint_reorder: torch.Tensor  # [21]

    @classmethod
    def from_model(cls, m: ManoModel, device="cpu") -> "ManoBuffers":
        arrays = [torch.as_tensor(getattr(m, f), dtype=torch.float32) for f in _MODEL_FIELDS]
        index = [torch.as_tensor(i, dtype=torch.long) for i in (
            LEV1_IDXS, LEV2_IDXS, LEV3_IDXS, TRANSFORM_REORDER, TIPS_RIGHT, TIPS_LEFT,
            JOINT_REORDER)]
        return cls(*arrays, *index).to(device)

    def to(self, device) -> "ManoBuffers":
        return ManoBuffers(*(t.to(device) for t in self))


def _rigid_transform(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation + [..., 3] translation -> [..., 4, 4]."""
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mano_forward(buffers: ManoBuffers, pose_coeffs: torch.Tensor, betas: torch.Tensor, *,
                 round_operands=None):
    """MANO forward of the port's head: axis-angle pose [B, 48] (root then
    15 joints, flat hand mean, no PCA) and shape [B, 10] -> (verts [B,778,3]
    mm, joints [B,21,3] mm), centred on the root joint.  ``round_operands``
    rounds both operands of every product (a control's lower precision)."""
    r = round_operands or (lambda t: t)

    def einsum(eq, a, b):
        return torch.einsum(eq, r(a), r(b))

    batch = pose_coeffs.shape[0]
    dev, dtype = pose_coeffs.device, pose_coeffs.dtype
    eye = torch.eye(3, dtype=dtype, device=dev)
    rot_mats = batch_rodrigues(pose_coeffs[:, :48].reshape(-1, 3)).reshape(batch, 16, 3, 3)
    root_rot = rot_mats[:, 0]
    rot_map = rot_mats[:, 1:]
    pose_map = (rot_map - eye).reshape(batch, 135)

    v_shaped = einsum("vds,bs->bvd", buffers.shapedirs, betas) + buffers.v_template[None]
    joints = einsum("jv,bvd->bjd", buffers.j_regressor, v_shaped)
    v_posed = v_shaped + einsum("vdp,bp->bvd", buffers.posedirs, pose_map)

    lev1, lev2, lev3 = buffers.lev1, buffers.lev2, buffers.lev3
    root_j = joints[:, 0]
    root_t = _rigid_transform(root_rot, root_j)
    lev1_t = r(root_t[:, None]) @ r(_rigid_transform(rot_map[:, lev1 - 1],
                                                     joints[:, lev1] - root_j[:, None]))
    lev2_t = r(lev1_t) @ r(_rigid_transform(rot_map[:, lev2 - 1],
                                            joints[:, lev2] - joints[:, lev1]))
    lev3_t = r(lev2_t) @ r(_rigid_transform(rot_map[:, lev3 - 1],
                                            joints[:, lev3] - joints[:, lev2]))
    all_t = torch.cat([root_t[:, None], lev1_t, lev2_t, lev3_t], dim=1)
    all_t = all_t[:, buffers.transform_reorder]  # [B,16,4,4]

    joints_h = torch.cat([joints, torch.zeros(batch, 16, 1, dtype=dtype, device=dev)], dim=-1)
    tmp = einsum("bjrc,bjc->bjr", all_t, joints_h)
    correction = torch.zeros_like(all_t)
    correction[..., :, 3] = tmp
    rel_t = all_t - correction

    skin_t = einsum("vj,bjrc->bvrc", buffers.weights, rel_t)
    v_posed_h = torch.cat([v_posed, torch.ones(batch, v_posed.shape[1], 1, dtype=dtype,
                                               device=dev)], dim=-1)
    verts = einsum("bvrc,bvc->bvr", skin_t, v_posed_h)[..., :3]

    jtr = torch.cat([all_t[:, :, :3, 3], verts[:, buffers.tips]], dim=1)
    jtr = jtr[:, buffers.joint_reorder]
    center = jtr[:, :1]
    return (verts - center) * 1000.0, (jtr - center) * 1000.0
