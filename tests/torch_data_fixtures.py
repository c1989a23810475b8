"""On-disk DexYCB and HO3D trees in the original's layout, written from a
seed, for the port's data tests and for ``chip_smoke.py``'s data phase.

The layout is the one the JAX package's dataset tests build
(``tests/test_dexycb_dataset.py``, ``tests/test_ho3d_dataset.py``): random
640x480 images, label npz files, per-frame SDF dumps with their index,
annotation JSON, HO3D meta pickles and seg composites, the rendered
extension, the YCB models' point clouds and the simplified meshes.  Each
writer returns the config overrides that point a dataset at its tree.
Imports numpy and PIL only.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Sequence

import numpy as np
from PIL import Image

IMG_W, IMG_H = 640, 480
K = np.array([[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]])
YCB_CLASSES = (
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)
HO3D_OBJECTS = (
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "019_pitcher_base",
    "021_bleach_cleanser", "025_mug", "035_power_drill", "037_scissors",
)
DEXYCB_OBJ = 5  # 006_mustard_bottle, the grasped object of every sample


def _rodrigues(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3)
    k = aa / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def _project(p3d: np.ndarray) -> np.ndarray:
    p = p3d @ K.T
    return p[:, :2] / p[:, 2:3]


def _image(rng) -> Image.Image:
    return Image.fromarray(rng.randint(0, 255, (IMG_H, IMG_W, 3), dtype=np.uint8))


def _sdf_rows(rng, n_hand: int, n_obj: int) -> np.ndarray:
    """[n_hand + n_obj, 6]: xyz near the hand, hand and object SDF (most
    within 5 cm, so the near-surface draws find enough), a part label."""
    n = n_hand + n_obj
    return np.concatenate([rng.randn(n, 3) * 0.05 + np.array([0, 0, 0.6]),
                           rng.randn(n, 2) * 0.02, rng.randint(0, 6, (n, 1))],
                          axis=1).astype(np.float32)


def _hand(rng):
    """21 joints about 60 cm in front of the camera, and their pixels."""
    j3d = rng.randn(21, 3) * 0.03 + np.array([0, 0, 0.6])
    return j3d, _project(j3d)


def write_dexycb(base: str, n_train: int = 3, n_test: int = 3, seed: int = 0, cut: bool = False,
                 n_hand: int = 300, n_obj: int = 200) -> Dict[str, object]:
    """A DexYCB tree under ``base``: every third sample a left hand.  With
    ``cut`` the small split's layout (``*_data_cut.json``, SDF dumps under
    ``{split}/`` named by the mangled ``color_file``, jpg frames), else the
    full split's (``*_data.json``, ``full_{split}/``, png frames)."""
    rng = np.random.RandomState(seed)
    root, ann, img_dir, sdf_root = (os.path.join(base, d) for d in ("root", "ann", "img", "sdf"))
    for d in (os.path.join(root, "labels"), ann, img_dir):
        os.makedirs(d, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        sdf_split = split if cut else f"full_{split}"
        sdf_dir = os.path.join(sdf_root, sdf_split, "sdf_processed")
        os.makedirs(sdf_dir, exist_ok=True)
        samples, counts = {}, {}
        for i in range(n):
            key = f"idx{i}"
            if cut:
                color_file = (f"2020{split}-subject-01/20200709_14{i:04d}/932122060861/"
                              f"color_{i:06d}.jpg")
                name = color_file.split("-")[-1].split(".")[0].replace("/", "_")
                name = name[:-12] + name[-2:]
            else:
                color_file, name = f"{split}_{key}.png", key
            path = os.path.join(img_dir, color_file)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _image(rng).save(path)
            j3d, j2d = _hand(rng)
            label_file = f"labels/{split}_{key}_label.npz"
            samples[key] = {
                "color_file": color_file, "label_file": label_file,
                "intrinsics": {"fx": K[0, 0], "fy": K[1, 1], "ppx": K[0, 2], "ppy": K[1, 2]},
                "pose_m": (rng.randn(51) * 0.1).tolist(),
                "mano_betas": (rng.randn(10) * 0.1).tolist(),
                "joint_3d": j3d.tolist(), "joint_2d": j2d.tolist(),
                "mano_side": "left" if i % 3 == 2 else "right",
                "pose_y": [np.concatenate([_rodrigues(rng.randn(3) * 0.3),
                                           np.array([[0.02], [0.0], [0.62]])], 1).tolist()],
                "ycb_ids": [DEXYCB_OBJ], "ycb_grasp_ind": 0,
            }
            seg = np.zeros((IMG_H, IMG_W), np.uint8)  # hand 255, the object its ycb id
            seg[rng.rand(IMG_H, IMG_W) > 0.95] = 255
            seg[rng.rand(IMG_H, IMG_W) > 0.95] = DEXYCB_OBJ
            np.savez(os.path.join(root, label_file), seg=seg)
            np.save(os.path.join(sdf_dir, f"{name}.npy"), _sdf_rows(rng, n_hand, n_obj))
            counts[name] = (n_hand, n_obj)
        # one index aligned with the sorted listing of the dumps
        np.save(os.path.join(sdf_root, sdf_split, "sdf_index.npy"),
                np.asarray([counts[k] for k in sorted(counts)]))
        suffix = "_cut" if cut else ""
        with open(os.path.join(ann, f"dex_ycb_s0_{split}_data{suffix}.json"), "w") as f:
            json.dump(samples, f)
    write_points(os.path.join(root, "models"), [YCB_CLASSES[DEXYCB_OBJ - 1]], rng)
    return {"annotation_dir": ann, "image_fast_path": img_dir, "fast_data_dir": sdf_root,
            "data_dir": root, "small_dexycb": cut}


def write_points(models: str, names: Sequence[str], rng, n: int = 50) -> str:
    """``{models}/{name}/points.xyz`` clouds, one per name."""
    for name in names:
        os.makedirs(os.path.join(models, name), exist_ok=True)
        np.savetxt(os.path.join(models, name, "points.xyz"), rng.randn(n, 3) * 0.04)
    return models


def write_simple_models(base: str, seed: int = 5, verts: int = 50) -> str:
    """``{base}/{name}/textured_simple_2000.obj`` for every YCB class."""
    rng = np.random.RandomState(seed)
    for name in YCB_CLASSES:
        os.makedirs(os.path.join(base, name), exist_ok=True)
        with open(os.path.join(base, name, "textured_simple_2000.obj"), "w") as f:
            for v in rng.randn(verts, 3) * 0.04:
                f.write("v %f %f %f\n" % tuple(v))
    return base


def _seg_composite(rng) -> np.ndarray:
    """Hand in channel 0, object in channel 2, saturated so that a JPEG
    round trip keeps them above the 200 threshold."""
    seg = np.zeros((IMG_H, IMG_W, 3), np.uint8)
    x, y = rng.randint(150, 350), rng.randint(100, 250)
    seg[y:y + 100, x:x + 100, 0] = 255
    seg[y + 50:y + 150, x + 50:x + 150, 2] = 255
    return seg


def write_ho3d(base: str, n_train: int = 2, n_eval: int = 2, n_render: int = 2, seed: int = 0,
               n_hand: int = 200, n_obj: int = 150) -> Dict[str, object]:
    """An HO3D v2 tree under ``base``: train frames (one more annotation row
    whose SDF dump is missing), evaluation frames (every second one the
    pitcher, which the object metrics leave out), the rendered extension and
    the models' point clouds."""
    rng = np.random.RandomState(seed)
    root, fast, ann, models = (os.path.join(base, d) for d in ("HO3D_v2", "fast", "ann", "models"))
    write_points(models, HO3D_OBJECTS, rng)
    seq = "ABF10"
    for d in ("rgb", "meta", "seg"):
        os.makedirs(os.path.join(root, "train", seq, d), exist_ok=True)
    for d in (os.path.join(fast, "train", "sdf_processed"), os.path.join(fast, "full"), ann):
        os.makedirs(d, exist_ok=True)
    rows, sdf_index = [], {}
    for i in range(n_train):
        frame = f"{i:04d}"
        flat = f"{seq}_{frame}"
        tdir = os.path.join(root, "train", seq)
        _image(rng).save(os.path.join(tdir, "rgb", f"{frame}.png"))
        Image.fromarray(_seg_composite(rng)).save(os.path.join(tdir, "seg", f"{frame}.jpg"),
                                                  quality=95)
        with open(os.path.join(tdir, "meta", f"{frame}.pkl"), "wb") as f:
            pickle.dump({"objRot": rng.randn(3, 1) * 0.3,
                         "objTrans": np.array([0.02, 0.0, -0.62]),
                         "objName": HO3D_OBJECTS[i % 3 + 1]}, f)
        np.save(os.path.join(fast, "train", "sdf_processed", f"{flat}.npy"),
                _sdf_rows(rng, n_hand, n_obj))
        sdf_index[flat] = np.array([n_hand, n_obj])
        j3d, _ = _hand(rng)
        p3d = rng.randn(21, 3) * 0.05 + np.array([0.02, 0, 0.62])
        rows.append({"seqName_id": f"{seq}/{frame}", "K": K.tolist(), "joints_3d": j3d.tolist(),
                     "mano_params": (rng.randn(58) * 0.1).tolist(), "obj_p3ds": p3d.tolist(),
                     "obj_p2ds": _project(p3d).astype(np.float32).tolist()})
    rows.append({**rows[0], "seqName_id": f"{seq}/9999"})  # no SDF dump: skipped
    with open(os.path.join(ann, "ho3d_train_data.json"), "w") as f:
        json.dump(rows, f)
    np.save(os.path.join(fast, "full", "sdf_index.npy"), sdf_index)

    for d in ("rgb", "meta"):
        os.makedirs(os.path.join(root, "evaluation", seq, d), exist_ok=True)
    keys = []
    for i in range(n_eval):
        frame = f"{i:04d}"
        keys.append(f"{seq}/{frame}")
        edir = os.path.join(root, "evaluation", seq)
        _image(rng).save(os.path.join(edir, "rgb", f"{frame}.png"))
        with open(os.path.join(edir, "meta", f"{frame}.pkl"), "wb") as f:
            pickle.dump({"camMat": K, "objRot": rng.randn(3, 1) * 0.3,
                         "objTrans": np.array([0.02, 0.0, -0.62]),
                         "objName": HO3D_OBJECTS[2] if i % 2 == 0 else "019_pitcher_base",
                         "handJoints3D": np.array([0.0, 0.01, -0.6]),
                         "handBoundingBox": np.array([250.0, 180.0, 400.0, 330.0])}, f)
    with open(os.path.join(root, "evaluation.txt"), "w") as f:
        f.write("\n".join(keys) + "\n")

    rdir = os.path.join(fast, "render")
    for d in ("rgb", "anno", "seg", "sdf_processed"):
        os.makedirs(os.path.join(rdir, d), exist_ok=True)
    counts = []
    for i in range(n_render):
        fname = f"r{i:04d}"
        _image(rng).save(os.path.join(rdir, "rgb", f"{fname}.png"))
        Image.fromarray(_seg_composite(rng)).save(os.path.join(rdir, "seg", f"{fname}.png"))
        j3d, _ = _hand(rng)  # rendered annotations are OpenCV-side already
        with open(os.path.join(rdir, "anno", f"{fname}.json"), "w") as f:
            json.dump({"camMat": K.tolist(), "handJoints3D": j3d.tolist(),
                       "objRot": _rodrigues(rng.randn(3) * 0.3).tolist(),
                       "objTrans": [0.02, 0.0, 0.62], "objName": "019_pitcher_base"}, f)
        np.save(os.path.join(rdir, "sdf_processed", f"{fname}.npy"),
                _sdf_rows(rng, n_hand - 20, n_obj - 10))
        counts.append((n_hand - 20, n_obj - 10))
    np.save(os.path.join(rdir, "sdf_index.npy"), np.asarray(counts))
    return {"data_dir": root, "fast_data_dir": fast, "annotation_dir": ann,
            "object_models_dir": models}


def assert_samples_equal(got, want, what: str = "") -> None:
    """Two samples (or batches) with the same keys, dtypes and values."""
    assert set(got) == set(want), what
    for k, w in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(w).dtype, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


class ToyDataset:
    """A dataset of ``n`` samples whose values depend on (index, epoch): the
    loader tests' stand-in, importable by a spawned worker."""

    def __init__(self, n: int = 23, fail_at: int = -1):
        self.n, self.fail_at = n, fail_at

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        if idx == self.fail_at:
            raise ValueError(f"boom at idx {idx}")
        rng = np.random.default_rng((0, epoch, idx))
        return {"x": np.full((3,), idx, np.float32), "r": rng.random(2)}
