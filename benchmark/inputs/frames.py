"""Synthetic frames and targets with the tensor contract of the DexYCB loader:
a frozen copy of the draws of the port's ``data/synthetic.py``, taken from a
numpy generator, the image as the u8 bytes of the wire."""

from __future__ import annotations

from typing import Dict

import numpy as np

INPUT_KEYS = ("img", "cam_intr", "mano_root", "obj_center_cam", "bbox_hand", "bbox_obj")


def make_batch(cfg, b: int, rng: np.random.Generator, *, supervise: bool = True,
               train: bool = False) -> Dict[str, np.ndarray]:
    """One batch of ``b`` frames: the inputs, with ``supervise`` the SDF
    query points, with ``train`` the presampled points and the targets
    (keys ``target_*``)."""
    h, w = cfg.input_img_shape
    hm = cfg.output_hm_shape[1]
    f32 = np.float32
    cam_intr = np.zeros((b, 3, 3), f32)
    cam_intr[:, 0, 0] = cam_intr[:, 1, 1] = 0.9 * w
    cam_intr[:, 0, 2] = w / 2
    cam_intr[:, 1, 2] = h / 2
    cam_intr[:, 2, 2] = 1
    root_z = 0.5 + rng.random(b, dtype=f32) * 0.2
    mano_root = np.stack([rng.standard_normal(b, dtype=f32) * 0.02,
                          rng.standard_normal(b, dtype=f32) * 0.02, root_z], axis=1)
    obj_center = mano_root + rng.standard_normal((b, 3), dtype=f32) * 0.03
    out = {
        "img": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        "cam_intr": cam_intr,
        "mano_root": mano_root.astype(f32),
        "obj_center_cam": obj_center.astype(f32),
        "bbox_hand": np.tile(np.array([[w * 0.2, h * 0.2, w * 0.8, h * 0.8]], f32), (b, 1)),
        "bbox_obj": np.tile(np.array([[w * 0.25, h * 0.25, w * 0.85, h * 0.85]], f32), (b, 1)),
    }
    if supervise or train:
        out["hand_sdf_points"] = rng.standard_normal((b, cfg.num_samp_hand, 3), dtype=f32) * 0.3
        out["obj_sdf_points"] = rng.standard_normal((b, cfg.num_samp_obj, 3), dtype=f32) * 0.3
    if train:
        out["hand_pre_points"] = rng.standard_normal((b, cfg.num_samp_hand, 3), dtype=f32) * 0.3
        out["obj_pre_points"] = rng.standard_normal((b, cfg.num_samp_obj, 3), dtype=f32) * 0.3
        targets = {
            "hand_sdf": rng.standard_normal((b, cfg.num_samp_hand), dtype=f32) * 0.05,
            "obj_sdf": rng.standard_normal((b, cfg.num_samp_obj), dtype=f32) * 0.05,
            "joint_coord": rng.random((b, 21, 2), dtype=f32) * hm,
            "joint_cam_no_trans": rng.standard_normal((b, 21, 3), dtype=f32) * 50,
            "hand_seg": (rng.random((b, hm, hm), dtype=f32) > 0.7).astype(np.uint8),
            "obj_seg": (rng.random((b, hm, hm), dtype=f32) > 0.7).astype(np.uint8),
            "mano_param": rng.standard_normal((b, 58), dtype=f32) * 0.2,
            "obj_rot": rng.standard_normal((b, 3), dtype=f32),
            "rel_obj_trans": rng.standard_normal((b, 3), dtype=f32) * 0.05,
        }
        out.update({f"target_{k}": v for k, v in targets.items()})
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def split(batch: Dict[str, np.ndarray]):
    """-> (inputs, targets): the ``target_`` keys lose their prefix."""
    inputs = {k: v for k, v in batch.items() if not k.startswith("target_")}
    targets = {k[7:]: v for k, v in batch.items() if k.startswith("target_")}
    return inputs, targets


def frames_of(inputs: Dict[str, np.ndarray]):
    """A batch's inputs as single frames (the serving requests)."""
    n = inputs["img"].shape[0]
    return [{k: inputs[k][i] for k in INPUT_KEYS} for i in range(n)]
