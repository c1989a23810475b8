"""The analytic MANO inverse kinematics' solve, joints -> axis-angle pose:
the CUDA kernel of ``csrc/ik.cu`` and its plain PyTorch version.

The solve is the part of ``hoisdf_tpu/ops/ik.py::ik_solver_mano`` (the
original's ``common/utils/inverse_kinematics.py:15-150``) between its two
MANO forwards: Kabsch on the five knuckle directions for the global
rotation, then each finger's three bones as axis-angle rotations of the
template's.  A frame whose Kabsch rotation is a reflection keeps the zero
pose and reads 0 in the flag.  ``ops/ik.py::ik_solver_mano`` runs the MANO
forwards around it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from hoisdf_torch.ops.kernels import launch_counts
from hoisdf_torch.ops.kernels.build import library
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


def ik_solve_plain(target: torch.Tensor, template: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """target [B, 21, 3] (root-relative joints, metres), template [B, 21, 3]
    (MANO's joints at zero pose and the frame's shape, metres) -> the
    axis-angle pose [B, 48] and the flag [B] (int32, 0 where the global
    rotation came out a reflection).  The finger loop has static bounds, so
    it is unrolled; the reflection's identity pose is a ``torch.where``
    select.  A reflection is ``det(V U^T) < 0``: the original's test,
    ``|det + 1| > 1e-6`` for a solved frame, sits inside f32 rounding (a
    reflected V U^T from an f32 SVD misses -1 by up to ~1.4e-6, and 0.18 %
    of reflected frames then pass as solved), while the sign does not rest
    on it.  ``torch.linalg.svd`` waits for the card on a card: the CUDA
    kernel replaces it there."""
    b = target.shape[0]
    dtype, dev = target.dtype, target.device

    def knuckle_dirs(j):  # [B, 3, 5]
        return (j[:, list(KNUCKLES)] - j[:, :1]).transpose(1, 2)

    h = knuckle_dirs(template) @ knuckle_dirs(target).transpose(1, 2)
    u, _, vt = torch.linalg.svd(h)
    rot = vt.transpose(1, 2) @ u.transpose(1, 2)  # V U^T: the global orient
    valid = (torch.linalg.det(rot) > 0)[:, None]  # not a reflection

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
    return pose, valid[:, 0].to(torch.int32)


def ik_solve(target: torch.Tensor, template: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The solve of :func:`ik_solve_plain` through the custom op
    ``hoisdf_torch::ik_solve``: one kernel launch on the card, the plain
    version on the CPU."""
    return torch.ops.hoisdf_torch.ik_solve(target.contiguous(), template.contiguous())


@torch.library.custom_op("hoisdf_torch::ik_solve", mutates_args=(), device_types="cpu")
def _ik_solve_op(target: torch.Tensor, template: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ik_solve_plain(target, template)


@_ik_solve_op.register_fake
def _(target, template):
    b = target.shape[0]
    return target.new_empty((b, 48)), target.new_empty((b,), dtype=torch.int32)


def _check(t: torch.Tensor, name: str, b: int, dev) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (b, 21, 3) or not t.is_contiguous() \
            or t.device != dev:
        raise ValueError(f"ik_solve: {name} must be a contiguous f32 [{b},21,3] on {dev}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


@_ik_solve_op.register_kernel("cuda")
def _(target, template):
    b = target.shape[0]
    _check(target, "target", b, target.device)
    _check(template, "template", b, target.device)
    pose = torch.empty((b, 48), dtype=torch.float32, device=target.device)
    valid = torch.empty((b,), dtype=torch.int32, device=target.device)
    if b == 0:
        return pose, valid
    lib = library()
    with torch.cuda.device(target.device):
        stream = torch.cuda.current_stream(target.device).cuda_stream
        rc = lib.ik_solve_launch(target.data_ptr(), template.data_ptr(), b, pose.data_ptr(),
                                 valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ik_solve kernel launch failed with CUDA error {rc}")
    launch_counts["ik_solve"] += 1
    return pose, valid


@register_flop_formula(torch.ops.hoisdf_torch.ik_solve)
def _ik_solve_flops(target_shape, template_shape, *, out_shape=None, **kwargs) -> int:
    """0: a frame's solve is a few thousand scalar operations on 3 x 3
    matrices, not the matrix products, convolutions and attention that MFU
    counts (registered so that the count says so rather than skipping an
    unknown op)."""
    return 0
