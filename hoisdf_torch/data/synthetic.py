"""Synthetic batches with the tensor contract of the DexYCB loader
(a numpy copy of ``hoisdf_tpu/data/synthetic.py``)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from hoisdf_torch.config import Config


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0, train: bool = False
                    ) -> Dict[str, np.ndarray]:
    """The batch of ``hoisdf_tpu.data.synthetic.synthetic_batch``: the same
    draws from the same seed.  Inputs, the targets (keys ``target_*``) and,
    with ``train``, the presampled points ``hand_pre_points`` /
    ``obj_pre_points``.  ``train`` defaults to False here (the serving
    callers take the eval inputs); the JAX package defaults to True."""
    rng = np.random.RandomState(seed)
    h, w = cfg.input_img_shape
    hm = cfg.output_hm_shape[1]
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
    batch = {
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
    targets = {
        "hand_sdf": (rng.randn(b, cfg.num_samp_hand) * 0.05).astype(np.float32),
        "obj_sdf": (rng.randn(b, cfg.num_samp_obj) * 0.05).astype(np.float32),
        "joint_coord": (rng.rand(b, 21, 2) * hm).astype(np.float32),
        "joint_cam_no_trans": (rng.randn(b, 21, 3) * 50).astype(np.float32),  # mm
        "hand_seg": (rng.rand(b, hm, hm) > 0.7).astype(np.float32),
        "obj_seg": (rng.rand(b, hm, hm) > 0.7).astype(np.float32),
        "mano_param": (rng.randn(b, 58) * 0.2).astype(np.float32),
        "obj_rot": rng.randn(b, 3).astype(np.float32),
        "rel_obj_trans": (rng.randn(b, 3) * 0.05).astype(np.float32),
    }
    if cfg.classifier_branch:
        labels = rng.randint(0, cfg.num_class, (b, cfg.num_samp_hand))
        labels[rng.rand(b, cfg.num_samp_hand) < 0.1] = -1  # clamp-invalidated
        targets["hand_part_labels"] = labels.astype(np.int32)
    if train:
        batch["hand_pre_points"] = (rng.randn(b, cfg.num_samp_hand, 3) * 0.3).astype(np.float32)
        batch["obj_pre_points"] = (rng.randn(b, cfg.num_samp_obj, 3) * 0.3).astype(np.float32)
    batch.update({f"target_{k}": v for k, v in targets.items()})
    return batch


def split_inputs_targets(batch: Dict) -> Tuple[Dict, Dict]:
    """``{inputs}, {targets}``: the ``target_`` keys lose their prefix."""
    inputs = {k: v for k, v in batch.items() if not k.startswith("target_")}
    targets = {k[7:]: v for k, v in batch.items() if k.startswith("target_")}
    return inputs, targets
