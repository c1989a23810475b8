"""Offline SDF preprocessing: AlignSDF npz -> per-frame camera-space samples
(a copy of ``hoisdf_tpu/tools/preprocess_sdf.py``; numpy only).

Usage: ``python -m hoisdf_torch.tools.preprocess_sdf SDF_DIR OUT_DIR
[--index-dict]``.  Parity target: ``tool/pre_process_sdf.py`` + the runtime unpack helpers it
reuses (``common/utils/sdf_utils.py:13-93``): NaN filtering, hand/obj
cross-SDF column layout ([x,y,z,sdf_hand,sdf_obj]), optional |sdf|<dist
filtering, part-label clamping, then the per-frame normalized-unit ->
camera-space transform via the norm npz's scale/offset.

Output layout (the reference's, consumed by the datasets): per frame
``{out}/sdf_processed/{key}.npy`` of shape [N,6] float32 = [xyz(cam),
sdf_hand, sdf_obj, part_label] with hand rows first, plus ONE global
``{out}/sdf_index.npy`` of (hand_count, obj_count) rows aligned with the
sorted key listing (tool/pre_process_sdf.py:95-148).  ``--index-dict``
writes the index as a pickled {key: (hand, obj)} dict instead — the form
the HO3D train loader reads from ``full/sdf_index.npy``
(data/ho3d.py:104-107).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np


def _remove_nans(arr: np.ndarray) -> np.ndarray:
    return arr[~np.isnan(arr[:, 3])]


def unpack_sdf_samples(
    npz_dir: str, key: str, *, hand: bool, clamp: Optional[float] = None,
    filter_dist: bool = False, dist: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """AlignSDF npz -> ([N,5] samples, [N] part labels); column layout is
    [xyz, sdf_hand, sdf_obj] for both sides (sdf_utils.py:36-93)."""
    sub = "sdf_hand" if hand else "sdf_obj"
    npz = np.load(os.path.join(npz_dir, sub, key + ".npz"))
    pos = _remove_nans(npz["pos"])
    neg = _remove_nans(npz["neg"])
    pos_other = npz["pos_other"]
    neg_other = npz["neg_other"]
    lab_key = "lab_pos" if hand else "lab_pos_other"
    lab_neg_key = "lab_neg" if hand else "lab_neg_other"
    lab_pos = npz[lab_key]
    lab_neg = npz[lab_neg_key]

    if hand:
        pos = np.concatenate([pos, pos_other], axis=1)
        neg = np.concatenate([neg, neg_other], axis=1)
    else:
        pos = np.concatenate([pos[:, :3], pos_other, pos[:, 3:4]], axis=1)
        neg = np.concatenate([neg[:, :3], neg_other, neg[:, 3:4]], axis=1)

    if filter_dist:
        keep_p = (np.abs(pos[:, 3]) < dist) & (np.abs(pos[:, 4]) < dist)
        keep_n = (np.abs(neg[:, 3]) < dist) & (np.abs(neg[:, 4]) < dist)
        pos, lab_pos = pos[keep_p], lab_pos[keep_p]
        neg, lab_neg = neg[keep_n], lab_neg[keep_n]

    samples = np.concatenate([pos, neg], axis=0)
    labels = np.concatenate([lab_pos[:, 0], lab_neg[:, 0]], axis=0).astype(
        np.float32
    )
    if clamp:
        labels[samples[:, 3] < -clamp] = -1
        labels[samples[:, 3] > clamp] = -1
    if not hand:
        labels[:] = -1
    return samples.astype(np.float32), labels


def process_frame(
    sdf_dir: str, key: str, out_dir: str, *, clamp: float = 0.05,
    filter_dist: bool = True, dist: float = 2.0,
) -> Tuple[int, int]:
    """One frame: unpack both fields, move to camera space, save npy+index."""
    norm = np.load(os.path.join(sdf_dir, "norm", key + ".npz"))
    hand_s, hand_l = unpack_sdf_samples(
        sdf_dir, key, hand=True, clamp=clamp, filter_dist=filter_dist, dist=dist
    )
    obj_s, obj_l = unpack_sdf_samples(
        sdf_dir, key, hand=False, clamp=clamp, filter_dist=filter_dist, dist=dist
    )
    for s in (hand_s, obj_s):
        s[:, :3] = s[:, :3] / norm["scale"] - norm["offset"]
        s[:, 3:] = s[:, 3:] / norm["scale"]
    hand = np.concatenate([hand_s, hand_l[:, None]], axis=1)
    obj = np.concatenate([obj_s, obj_l[:, None]], axis=1)
    data = np.concatenate([hand, obj], axis=0).astype(np.float32)
    proc_dir = os.path.join(out_dir, "sdf_processed")
    os.makedirs(proc_dir, exist_ok=True)
    np.save(os.path.join(proc_dir, key + ".npy"), data)
    return hand.shape[0], obj.shape[0]


def compute_scales(sdf_dir: str, keys, joints_fn) -> Tuple[np.ndarray, np.ndarray]:
    """Derive hand/obj SDF scales as 1/max(dist to wrist) per frame
    (tool/compute_scales.py:60-81); informs the 3.1 constants."""
    hand_scales, obj_scales = [], []
    for key in keys:
        norm = np.load(os.path.join(sdf_dir, "norm", key + ".npz"))
        hand_s, _ = unpack_sdf_samples(sdf_dir, key, hand=True)
        obj_s, _ = unpack_sdf_samples(sdf_dir, key, hand=False)
        wrist = joints_fn(key)[0]
        for s, out in ((hand_s, hand_scales), (obj_s, obj_scales)):
            xyz_cam = s[:, :3] / norm["scale"] - norm["offset"]
            out.append(1.0 / np.max(np.linalg.norm(xyz_cam - wrist, axis=1)))
    return np.asarray(hand_scales), np.asarray(obj_scales)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("sdf_dir", help="AlignSDF dump with sdf_hand/ sdf_obj/ norm/")
    p.add_argument("out_dir")
    p.add_argument("--clamp", type=float, default=0.05)
    p.add_argument("--dist", type=float, default=2.0)
    p.add_argument(
        "--index-dict", action="store_true",
        help="write sdf_index.npy as a pickled {key: (hand, obj)} dict "
             "(the HO3D full/ form) instead of the positional array",
    )
    args = p.parse_args()
    keys = sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(os.path.join(args.sdf_dir, "sdf_hand"))
        if f.endswith(".npz")
    )
    index = {}
    for key in keys:
        index[key] = process_frame(
            args.sdf_dir, key, args.out_dir, clamp=args.clamp, dist=args.dist
        )
    index_path = os.path.join(args.out_dir, "sdf_index.npy")
    if args.index_dict:
        np.save(index_path, {k: np.asarray(v) for k, v in index.items()})
    else:
        np.save(index_path, np.asarray([index[k] for k in keys]))
    print(f"processed {len(keys)} frames -> {args.out_dir}")


if __name__ == "__main__":
    main()
