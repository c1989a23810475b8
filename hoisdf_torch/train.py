"""Eval step of the port (``hoisdf_tpu/train.py::make_eval_step``).

Training is not ported yet; this module holds the eval forward with joint
voting and the final-layer MANO head.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from hoisdf_torch.config import Config
from hoisdf_torch.mano.layer import ManoBuffers
from hoisdf_torch.models.hoisdf import HOISDF
from hoisdf_torch.models.mano_head import mano_head_pred
from hoisdf_torch.ops import wire


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when asked for
    (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def vote_hand_joints(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Softmax-weighted per-point joint votes of the final layer -> [B,20,3] m."""
    off = out["hand_off"]
    votes = out["hand_points_notrans"][None, :, :, None, :] + off.reshape(*off.shape[:3], 20, 3)
    weights = torch.softmax(out["hand_cls"], dim=2)[..., None]
    return torch.sum(votes * weights, dim=2)[-1]


def make_eval_step(cfg: Config, model: HOISDF, mano_buffers: ManoBuffers,
                   supervise_sdf: Optional[bool] = None, *, device="cuda"
                   ) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
    """Eval forward on ``device``: field-guided sampling, running BN, MANO on
    the final decoder layer.  Moves ``model`` to the device and puts it in
    eval mode.  The returned step takes numpy arrays or tensors (u8 or f32
    image wire) and returns tensors on the device.

    ``supervise_sdf`` defaults to the DexYCB behaviour (also query the SDF at
    the ground-truth sample points); pass False for serving."""
    dev = resolve_device(device)
    supervise = cfg.dataset == "dexycb" if supervise_sdf is None else supervise_sdf
    model.to(dev).eval()
    mano = mano_buffers.to(dev)

    def eval_step(inputs: Mapping) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            batch = {k: (torch.from_numpy(np.ascontiguousarray(v))
                         if isinstance(v, np.ndarray) else v).to(dev, non_blocking=True)
                     for k, v in inputs.items()}
            out = model(wire.decode_inputs(batch), supervise_sdf=supervise)
            preds = {
                "obj_rot": out["obj_rot"][-1],
                "obj_trans": out["obj_trans"][-1],
                "hand_points_notrans": out["hand_points_notrans"],
                "hand_off": out["hand_off"],
                "hand_cls": out["hand_cls"],
                "decoder_heads": out["decoder_heads"],
                "hand_joints": vote_hand_joints(out),
            }
            pred_mano = mano_head_pred(mano, out["mano_pose6d"][-1:], out["mano_shape"][-1:])
            preds["mano_verts"] = pred_mano["verts3d"][-1]
            preds["mano_joints"] = pred_mano["joints3d"][-1]
        return preds

    return eval_step
