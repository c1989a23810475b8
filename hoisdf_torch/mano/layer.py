"""MANO forward in PyTorch: blend shapes, forward kinematics, skinning
(``hoisdf_tpu/mano/layer.py``, every option of its ``mano_forward``, and
``ManoLayer``).

Geometry runs in f32 whatever the model's compute type; on the card f32
matmuls stay full f32 unless TF32 is switched on.  Outputs are millimetres.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hoisdf_torch.mano.model import (
    JOINT_REORDER,
    LEV1_IDXS,
    LEV2_IDXS,
    LEV3_IDXS,
    TIPS_LEFT,
    TIPS_RIGHT,
    TRANSFORM_REORDER,
    ManoModel,
)
from hoisdf_torch.ops.rotations import batch_rodrigues, batch_rotprojs


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


def mano_forward(buffers: ManoBuffers, pose_coeffs: torch.Tensor,
                 betas: Optional[torch.Tensor] = None, trans: Optional[torch.Tensor] = None, *,
                 use_pca: bool = False, ncomps: int = 45, center_idx: Optional[int] = 0,
                 flat_hand_mean: bool = True, side: str = "right",
                 joint_rot_mode: str = "axisang"):
    """MANO forward: pose/shape -> (verts [B,778,3] mm, joints [B,21,3] mm),
    the JAX package's ``mano_forward`` (manolayer.py:111-276, root rotation
    in axis-angle).

    ``pose_coeffs``: [B, 3 + ncomps], the global axis-angle rotation then
    the hand pose (PCA coefficients with ``use_pca``, else 45 axis-angle
    values); or with ``joint_rot_mode="rotmat"`` (and no PCA) [B,16,3,3]
    matrices, projected onto SO(3).  ``betas`` [B, 10], or None for the
    template shape.  ``trans`` [B, 3] in metres is added; without it the
    result is centred on joint ``center_idx`` (None: not centred).  The
    hand mean is added unless ``flat_hand_mean``; ``side`` picks the
    fingertip vertices.  The eval head's case (axis-angle, flat mean, no
    PCA) takes the pose as given: no extra launch."""
    batch = pose_coeffs.shape[0]
    dev, dtype = pose_coeffs.device, pose_coeffs.dtype
    eye = torch.eye(3, dtype=dtype, device=dev)
    if not use_pca and joint_rot_mode == "rotmat":
        if tuple(pose_coeffs.shape[1:]) != (16, 3, 3):
            raise ValueError(f"rotmat pose must be [B,16,3,3], got {tuple(pose_coeffs.shape)}")
        rot_mats = batch_rotprojs(pose_coeffs)
    else:
        if use_pca or not flat_hand_mean:
            hand_pose = pose_coeffs[:, 3:3 + ncomps]
            if use_pca:
                hand_pose = hand_pose @ buffers.hands_components[:ncomps]
            mean = torch.zeros_like(buffers.hands_mean) if flat_hand_mean else buffers.hands_mean
            full_pose = torch.cat([pose_coeffs[:, :3], mean[None] + hand_pose], dim=1)
        else:
            full_pose = pose_coeffs[:, :48]
        rot_mats = batch_rodrigues(full_pose.reshape(-1, 3)).reshape(batch, 16, 3, 3)
    root_rot = rot_mats[:, 0]
    rot_map = rot_mats[:, 1:]
    pose_map = (rot_map - eye).reshape(batch, 135)

    if betas is None:
        v_shaped = (torch.einsum("vds,s->vd", buffers.shapedirs, buffers.betas)
                    + buffers.v_template)
        joints = (buffers.j_regressor @ v_shaped).expand(batch, 16, 3)
        v_shaped = v_shaped.expand(batch, -1, 3)
    else:
        v_shaped = (torch.einsum("vds,bs->bvd", buffers.shapedirs, betas)
                    + buffers.v_template[None])
        joints = torch.einsum("jv,bvd->bjd", buffers.j_regressor, v_shaped)
    v_posed = v_shaped + torch.einsum("vdp,bp->bvd", buffers.posedirs, pose_map)

    lev1, lev2, lev3 = buffers.lev1, buffers.lev2, buffers.lev3
    root_j = joints[:, 0]
    root_t = _rigid_transform(root_rot, root_j)
    lev1_t = root_t[:, None] @ _rigid_transform(rot_map[:, lev1 - 1],
                                                joints[:, lev1] - root_j[:, None])
    lev2_t = lev1_t @ _rigid_transform(rot_map[:, lev2 - 1], joints[:, lev2] - joints[:, lev1])
    lev3_t = lev2_t @ _rigid_transform(rot_map[:, lev3 - 1], joints[:, lev3] - joints[:, lev2])
    all_t = torch.cat([root_t[:, None], lev1_t, lev2_t, lev3_t], dim=1)
    all_t = all_t[:, buffers.transform_reorder]  # [B,16,4,4]

    joints_h = torch.cat([joints, torch.zeros(batch, 16, 1, dtype=dtype, device=dev)], dim=-1)
    tmp = torch.einsum("bjrc,bjc->bjr", all_t, joints_h)
    correction = torch.zeros_like(all_t)
    correction[..., :, 3] = tmp
    rel_t = all_t - correction

    skin_t = torch.einsum("vj,bjrc->bvrc", buffers.weights, rel_t)
    v_posed_h = torch.cat([v_posed, torch.ones(batch, v_posed.shape[1], 1, dtype=dtype,
                                               device=dev)], dim=-1)
    verts = torch.einsum("bvrc,bvc->bvr", skin_t, v_posed_h)[..., :3]

    tips = buffers.tips if side == "right" else buffers.tips_left
    jtr = torch.cat([all_t[:, :, :3, 3], verts[:, tips]], dim=1)
    jtr = jtr[:, buffers.joint_reorder]
    if trans is not None:
        jtr = jtr + trans[:, None]
        verts = verts + trans[:, None]
    elif center_idx is not None:
        center = jtr[:, center_idx:center_idx + 1]
        jtr = jtr - center
        verts = verts - center
    return verts * 1000.0, jtr * 1000.0


class ManoLayer:
    """Buffers and static options bound together, as the reference's
    constructor binds them (manolayer.py:20-109)."""

    def __init__(self, model: ManoModel, *, use_pca: bool = False, ncomps: int = 45,
                 center_idx: Optional[int] = 0, flat_hand_mean: bool = True, device="cpu"):
        self.buffers = ManoBuffers.from_model(model, device)
        self.use_pca = use_pca
        self.ncomps = ncomps
        self.center_idx = center_idx
        self.flat_hand_mean = flat_hand_mean
        self.side = model.side
        self.faces = model.faces

    @property
    def hands_mean(self) -> torch.Tensor:
        return self.buffers.hands_mean

    def __call__(self, pose_coeffs, betas=None, trans=None):
        return mano_forward(self.buffers, pose_coeffs, betas, trans, use_pca=self.use_pca,
                            ncomps=self.ncomps, center_idx=self.center_idx,
                            flat_hand_mean=self.flat_hand_mean, side=self.side)
