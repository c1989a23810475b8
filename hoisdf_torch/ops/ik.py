"""Analytic MANO inverse kinematics, joints -> pose, for the ho3d_render
preset (``hoisdf_tpu/ops/ik.py``; the original's
``common/utils/inverse_kinematics.py:15-150``).

MANO runs at zero pose with the predicted shape for the template joints;
the solve (``ops/kernels/ik.py``: Kabsch on the five knuckle directions for
the global orientation, then each finger's three joints as axis-angle
rotations of the template's bones) gives the pose; then MANO runs forward
again.  The solve is the custom op ``hoisdf_torch::ik_solve``: one kernel
launch on the card, which makes no host sync; on the CPU its plain
PyTorch twin.  A sample whose Kabsch rotation is a reflection keeps the
identity pose (``valid_idx`` of the original).  While a ``torch.profiler``
runs, the three parts record the spans ``ik.template``, ``ik.solve`` and
``ik.mano`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.ops.kernels.ik import ik_solve
from hoisdf_torch.utils.profiling import span


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
    with span("ik.template"):
        _, template = mano_forward(buffers, torch.zeros(b, 48, dtype=dtype, device=dev), shape)
        template = template / 1000.0
    with span("ik.solve"):
        pose, valid = ik_solve(target, template)
    with span("ik.mano"):
        verts, joints = mano_forward(buffers, pose, shape)
    root = pred_joints[:, :1]
    return {"verts": verts / 1000.0 + root, "joints": joints / 1000.0 + root,
            "shape": shape, "pose": pose, "vis": valid[:, None]}
