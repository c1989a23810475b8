"""MANO inverse kinematics in plain PyTorch: the reference's solver for the
IK head (the HOISDF release's ``common/utils/inverse_kinematics.py:15-150``,
``ik_solver_mano``), in f32 (TF32 off, as the benchmark runs it) on the
reference's MANO layer.

From the predicted joints [B, 21, 3] (metres, root first) and shape: MANO at
zero pose gives the template's joints; Kabsch on the five knuckle
directions (``torch.linalg.svd``) gives the global rotation R = V U^T; each
finger's three bones, root to tip, give an axis (the cross product of the
template bone and the target bone in the parent's frame) and an angle (the
arccos of their cosine), whose Rodrigues matrix turns the next bone's
frame; MANO runs again with the solved pose.

Departures from the release's code (the first changes the answer only of
a reflected frame whose f32 determinant the release would misread):

- a frame whose R is a reflection is told by the sign, ``det R < 0``; the
  release's test, ``|det R + 1| > 1e-6`` for a solved frame, sits inside f32
  rounding: an f32 SVD's reflected V U^T misses -1 by up to ~1.4e-6, and
  0.18 % of reflected frames (a CPU draw of 100,000 covariances shaped like
  an untrained model's) pass it as solved;
- every frame is solved and a reflected frame is then given the zero pose
  by a select; the release solves only the frames it indexes as valid and
  leaves the others at zero;
- MANO is the reference's own layer (``mano_layer.py``: the stand-in's
  arrays at MANO's shapes, flat hand mean, no PCA), in millimetres, so the
  template and the result are divided by 1,000 as the release's metre
  convention needs;
- the 3 x 3 SVD of the Kabsch covariance and the determinant of V U^T run
  on the CPU (LAPACK), whatever the device: on the H100, torch's CUDA SVD in
  f32 under the release's test called 21 of 528 frames of an untrained
  model's voted joints solved where LAPACK in f32 and in f64 both find the
  reflection (the covariances' determinants were negative, at least 1e-4
  of the largest singular value cubed);
- ``round_operands`` (the controls) rounds both operands of every product,
  the Kabsch covariance, the bones' frames and MANO's; the SVD, arccos and
  norms stay in the inputs' precision.

It imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from benchmark.reference.mano_layer import ManoBuffers, mano_forward
from benchmark.reference.rotations import batch_rodrigues, mat2aa

# the release's finger order (inverse_kinematics.py:73-79): root, then the
# chain from the knuckle to the tip; finger i owns MANO's pose slots 3i+1..3i+3
FINGERS = ((0, 5, 6, 7, 8), (0, 9, 10, 11, 12), (0, 17, 18, 19, 20), (0, 13, 14, 15, 16),
           (0, 1, 2, 3, 4))
KNUCKLES = (1, 5, 9, 13, 17)


def solve_pose(target: torch.Tensor, template: torch.Tensor,
               round_operands: Optional[Callable] = None):
    """Root-relative target joints and template joints [B, 21, 3] (metres)
    -> (axis-angle pose [B, 48], flag [B] bool: False where Kabsch gave a
    reflection)."""
    r = round_operands or (lambda t: t)
    b = target.shape[0]
    kw = dict(dtype=target.dtype, device=target.device)
    knuckles = list(KNUCKLES)
    a = template[:, knuckles] - template[:, :1]  # [B, 5, 3]
    c = target[:, knuckles] - target[:, :1]
    cov = torch.einsum("bki,bkj->bij", r(a), r(c))  # sum_k a_k c_k^T
    # the 3 x 3 SVD and the determinant on the CPU (LAPACK), see above; a
    # count of operations on ``meta`` stays there
    u, _, vh = torch.linalg.svd(cov.cpu() if cov.device.type == "cuda" else cov)
    rot = vh.transpose(1, 2) @ u.transpose(1, 2)
    valid = (torch.linalg.det(rot) > 0).to(target.device)
    rot = rot.to(target.device)

    pose = torch.zeros(b, 16, 3, **kw)
    pose[:, 0] = mat2aa(rot)
    for f, chain in enumerate(FINGERS):
        parent = rot  # the bone's parent frame
        done = torch.zeros(b, 3, **kw)  # the chain's reconstructed joint
        for j in range(2, 5):
            bone_t = template[:, chain[j]] - template[:, chain[j - 1]]
            done = (r(parent) @ r(template[:, chain[j - 1]] - template[:, chain[j - 2]])[..., None]
                    )[..., 0] + done
            bone_x = (r(parent.transpose(1, 2)) @ r(target[:, chain[j]] - done)[..., None])[..., 0]
            axis = torch.linalg.cross(bone_t, bone_x, dim=-1)
            axis = axis / (axis.norm(dim=-1, keepdim=True) + 1e-7)
            cos = ((bone_t * bone_x).sum(-1, keepdim=True)
                   / (bone_t.norm(dim=-1, keepdim=True) + 1e-7)
                   / (bone_x.norm(dim=-1, keepdim=True) + 1e-7))
            aa = torch.arccos(cos.clamp(-1 + 1e-7, 1 - 1e-7)) * axis
            pose[:, 3 * f + j - 1] = aa
            parent = r(parent) @ r(batch_rodrigues(aa))
    pose = torch.where(valid[:, None, None], pose, torch.zeros_like(pose))
    return pose.reshape(b, 48), valid


@torch.no_grad()
def ik_hand(mano: ManoBuffers, hand_joints: torch.Tensor, shape: torch.Tensor,
            round_operands: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
    """The IK head's hand from the voted joints [B, 20, 3] (the root, 0,
    prepended) and the shape [B, 10] -> ``mano_joints`` [B, 21, 3] and
    ``mano_verts`` [B, 778, 3] (root-relative metres), ``mano_pose`` [B, 48]
    and ``ik_valid`` [B] (int32)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    dtype = mano.v_template.dtype  # f32, or f64 with buffers cast to it
    joints = torch.cat([torch.zeros_like(hand_joints[:, :1]), hand_joints], dim=1).to(dtype)
    shape = shape.to(dtype)
    b = joints.shape[0]
    _, template = mano_forward(mano, torch.zeros(b, 48, dtype=dtype, device=joints.device),
                               shape, round_operands=round_operands)
    pose, valid = solve_pose(joints - joints[:, :1], template / 1000.0, round_operands)
    verts, out_joints = mano_forward(mano, pose, shape, round_operands=round_operands)
    return {"mano_joints": out_joints / 1000.0, "mano_verts": verts / 1000.0,
            "mano_pose": pose, "ik_valid": valid.to(torch.int32)}
