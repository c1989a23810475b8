"""Synthetic eval inputs with the tensor contract of the DexYCB loader
(a numpy copy of ``hoisdf_tpu/data/synthetic.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from hoisdf_torch.config import Config


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The eval inputs of ``hoisdf_tpu.data.synthetic.synthetic_batch``: the
    same draws from the same seed (the targets, drawn after the inputs there,
    are not made)."""
    rng = np.random.RandomState(seed)
    h, w = cfg.input_img_shape
    b = batch_size

    fx = fy = 0.9 * w
    cam_intr = np.zeros((b, 3, 3), np.float32)
    cam_intr[:, 0, 0] = fx
    cam_intr[:, 1, 1] = fy
    cam_intr[:, 0, 2] = w / 2
    cam_intr[:, 1, 2] = h / 2
    cam_intr[:, 2, 2] = 1

    root_z = 0.5 + rng.rand(b).astype(np.float32) * 0.2
    mano_root = np.stack(
        [rng.randn(b).astype(np.float32) * 0.02,
         rng.randn(b).astype(np.float32) * 0.02, root_z], axis=1
    )
    obj_center = mano_root + rng.randn(b, 3).astype(np.float32) * 0.03
    return {
        "img": rng.rand(b, h, w, 3).astype(np.float32),
        "cam_intr": cam_intr,
        "mano_root": mano_root,
        "obj_center_cam": obj_center.astype(np.float32),
        "bbox_hand": np.tile(
            np.array([[w * 0.2, h * 0.2, w * 0.8, h * 0.8]], np.float32), (b, 1)),
        "bbox_obj": np.tile(
            np.array([[w * 0.25, h * 0.25, w * 0.85, h * 0.85]], np.float32), (b, 1)),
        # SDF supervision points live in the scaled field frame
        "hand_sdf_points": (rng.randn(b, cfg.num_samp_hand, 3) * 0.3).astype(np.float32),
        "obj_sdf_points": (rng.randn(b, cfg.num_samp_obj, 3) * 0.3).astype(np.float32),
    }
