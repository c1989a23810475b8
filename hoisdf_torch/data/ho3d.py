"""The HO3D dataset (a copy of ``hoisdf_tpu/data/ho3d.py``):
train samples with full labels, the rendered extension of ho3d_render, and
the evaluation split (image, box, intrinsics, root and the object-pose
targets of ADD-S and MME; hand predictions go to the codalab JSON).

The original's on-disk layout (``data/ho3d.py:85-268``):

  * ``{annotation_dir}/ho3d_train_data.json``, a list of per-sample dicts
    (seqName_id, K, joints_3d, mano_params, obj_p3ds, obj_p2ds); samples whose
    SDF dump is missing are skipped (data/ho3d.py:130-138);
  * ``{fast_data_dir}/train/sdf_processed/{seq}_{frame}.npy`` and one pickled
    dict ``{fast_data_dir}/full/sdf_index.npy`` of ``{seq}_{frame}`` ->
    (hand_count, obj_count);
  * images ``{data_dir}/{split}/{seq}/rgb/{frame}.png``, train seg
    composites ``.../seg/{frame}.jpg`` (resized to 640x480, nearest, and
    thresholded at 200 per channel), per-frame ``.../meta/{frame}.pkl``;
  * the rendered extension under ``{fast_data_dir}/render/{rgb,anno,seg,
    sdf_processed}`` with a positional ``render/sdf_index.npy``.

As in the JAX package, images, masks and metas are decoded per sample, and
the augmentation and assembly are DexYCB's with HO3D's knobs.  The meta
``.pkl`` files are pickles: read only trusted dataset files.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List

import numpy as np
from PIL import Image

from hoisdf_torch import native as N
from hoisdf_torch.config import Config
from hoisdf_torch.data import image_io as IIO
from hoisdf_torch.data import transforms as T
from hoisdf_torch.data.dexycb import DexYCBDataset
from hoisdf_torch.data.meshes import load_xyz
from hoisdf_torch.mano.model import ManoModel

# OpenGL -> OpenCV camera flip (data/ho3d_util.py:44-53)
COORD_CHANGE_MAT = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], dtype=np.float32
)

# HO3D object names; a sample's ``obj_cls`` indexes this tuple (the original
# keys objects by name; the ids keep batches numeric).
HO3D_OBJECTS = (
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "019_pitcher_base",
    "021_bleach_cleanser", "025_mug", "035_power_drill", "037_scissors",
)


def convert_pose_to_opencv(rot_aa: np.ndarray, trans: np.ndarray):
    """OpenGL-convention object pose -> OpenCV (ho3d_util.py:44-53)."""
    rot = T.rodrigues_np(rot_aa.astype(np.float64))
    rot = COORD_CHANGE_MAT.astype(np.float64) @ rot
    trans = COORD_CHANGE_MAT @ trans
    return T.inv_rodrigues_np(rot).astype(np.float32), trans.astype(np.float32)


def load_meta_pkl(path: str) -> Dict:
    """Per-frame HO3D meta ``.pkl`` (data/ho3d.py:597-605 loads these with
    ``np.load(allow_pickle=True)``; plain pickle underneath)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def load_objects_ho3d(obj_root: str) -> Dict[str, np.ndarray]:
    """Name -> [N,3] vertex cloud for the 10 HO3D objects from the YCB models
    dir's per-object ``points.xyz`` (ho3d_util.py:66-86, trimesh-free)."""
    return {name: load_xyz(os.path.join(obj_root, name, "points.xyz"))
            for name in HO3D_OBJECTS}


def dump_codalab_json(pred_out_path: str, xyz_pred_list, verts_pred_list) -> str:
    """Write the HO-3D challenge submission ``pred_mano.json``: the joint and
    vertex lists, rounded to 4 decimals (ho3d_util.py:123-134)."""
    xyz = [x.round(4).tolist() for x in xyz_pred_list]
    verts = [v.round(4).tolist() for v in verts_pred_list]
    path = os.path.join(pred_out_path, "pred_mano.json")
    with open(path, "w") as f:
        json.dump([xyz, verts], f)
    return path


class HO3DDataset:
    """HO3D v2, with the DexYCB dataset's flat-dict contract.  Train samples
    carry full supervision; evaluation samples the image, boxes, K, root and
    the object-pose targets of ADD-S and MME (data/ho3d.py:591-653)."""

    # HO3D aug deviations from DexYCB (data/ho3d.py:319-345 vs dexycb.py:266-300)
    bbox_hand_factor = 1.2
    aug_coord_change_mat = COORD_CHANGE_MAT  # MANO orient is stored OpenGL-side

    def __init__(
        self,
        cfg: Config,
        mode: str,
        mano_right: ManoModel,
        seed: int = 0,
    ):
        if mode not in ("train", "evaluation"):
            raise ValueError(f"HO3DDataset: mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.inp_res = cfg.input_img_shape[0]
        self.heatmap_res = cfg.output_hm_shape[1]
        self.seed = seed
        self.hands_mean = mano_right.hands_mean
        # the native C++ image pipeline or PIL (Config.native_pipeline)
        self.native = IIO.resolve_native(cfg.native_pipeline)

        self.max_rot = np.pi
        self.scale_jittering = 0.2
        self.center_jittering = 0.1
        self.hue, self.saturation, self.contrast, self.brightness = 0.15, 0.5, 0.5, 0.5
        self.blur_radius = 0.5

        root = cfg.data_dir
        if root is None:
            raise FileNotFoundError(
                "cfg.data_dir is unset — point it at the HO3D_v2 root "
                "(the original's cfg.ho3d_data_dir)"
            )
        self.root = root
        self.fast_data_dir = cfg.fast_data_dir
        # 21-point 3D bboxes of the real object clouds; needed by the eval
        # split and the rendered extension (data/ho3d.py:91-92).
        self.obj_bbox3d: Dict[str, np.ndarray] = {}
        if cfg.object_models_dir is not None and (
            mode == "evaluation" or cfg.add_render
        ):
            meshes = load_objects_ho3d(cfg.object_models_dir)
            self.obj_bbox3d = {
                name: T.get_bbox21_3d(pts) for name, pts in meshes.items()
            }

        if mode == "train":
            with open(
                os.path.join(cfg.annotation_dir, "ho3d_train_data.json")
            ) as f:
                data_ho3d = json.load(f)
            sdf_index = np.load(
                os.path.join(self.fast_data_dir, "full", "sdf_index.npy"),
                allow_pickle=True,
            ).tolist()  # dict: "{seq}_{frame}" -> (hand_count, obj_count)
            self.samples: List[Dict] = []
            for data in data_ho3d:
                flat = data["seqName_id"].replace("/", "_")
                sdf_path = os.path.join(
                    self.fast_data_dir, "train", "sdf_processed", flat + ".npy"
                )
                if not os.path.exists(sdf_path):
                    continue  # data/ho3d.py:130-138
                self.samples.append(
                    dict(
                        key=data["seqName_id"],
                        K=np.asarray(data["K"], np.float32),
                        joints_3d=np.asarray(data["joints_3d"], np.float32),
                        mano_param=np.asarray(data["mano_params"], np.float32),
                        obj_p3d=np.asarray(data["obj_p3ds"], np.float32),
                        obj_p2d=np.asarray(data["obj_p2ds"], np.float32),
                        sdf_path=sdf_path,
                        sdf_counts=np.asarray(sdf_index[flat], np.int64),
                    )
                )
            if cfg.add_render:
                self._append_render_samples()
            self.set_list = [s["key"] for s in self.samples]
        else:
            with open(os.path.join(root, "evaluation.txt")) as f:
                self.set_list = [line.strip() for line in f if line.strip()]

    def _append_render_samples(self) -> None:
        """Rendered-data extension (data/ho3d.py:195-263): per-sample png rgb,
        json anno (OpenCV-convention, 3x3 objRot, zero MANO params), png seg,
        and a positional render/sdf_index.npy of (hand, obj) counts."""
        rdir = os.path.join(self.fast_data_dir, "render")
        sdf_dir = os.path.join(rdir, "sdf_processed")
        if not os.path.isdir(sdf_dir):
            return
        names = sorted(f[:-4] for f in os.listdir(sdf_dir) if f.endswith(".npy"))
        render_index = np.load(os.path.join(rdir, "sdf_index.npy"))
        for i, fname in enumerate(names):
            self.samples.append(
                dict(
                    key="render:" + fname,
                    sdf_path=os.path.join(sdf_dir, fname + ".npy"),
                    sdf_counts=np.asarray(render_index[i], np.int64).reshape(-1),
                )
            )

    def __len__(self) -> int:
        return len(self.set_list)

    def _rng(self, idx: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, epoch, idx))

    def _load_seg(self, path: str, thresh: int = 200):
        """Composite seg image -> (hand, obj) masks: hand in channel 0,
        object in channel 2, resized to the 640x480 annotation canvas and
        thresholded at 200 (data/ho3d.py:141-165, 230-232).  The native path
        decodes and resizes through the C library, with the same bits."""
        if self.native:
            kind = "jpeg" if path.lower().endswith((".jpg", ".jpeg")) else "png"
            with open(path, "rb") as f:
                arr = N.decode_image(f.read(), kind)
            if arr is not None:
                if arr.shape[:2] != (480, 640):
                    arr = N.resize_nearest(arr, (480, 640))
                return (IIO.SegMask((arr[..., 0] > thresh).astype(np.uint8)),
                        IIO.SegMask((arr[..., 2] > thresh).astype(np.uint8)))
        with Image.open(path) as seg:
            if seg.size != (640, 480):
                seg = seg.resize((640, 480), Image.NEAREST)
            seg = np.asarray(seg)
        return (IIO.SegMask((seg[..., 0] > thresh).astype(np.uint8)),
                IIO.SegMask((seg[..., 2] > thresh).astype(np.uint8)))

    def _draw_sdf_points(
        self, rng: np.random.Generator, sdf_data: np.ndarray, n_hand_avail: int
    ):
        """Draw supervision + near-surface 'pre' points (data/ho3d.py:462-487;
        HO3D train always draws both sets).  Returns
        ([2*(num_samp_hand+num_samp_obj), 5] points, hand part labels or None)."""
        cfg = self.cfg
        hand_idx = rng.choice(n_hand_avail, cfg.num_samp_hand, replace=False)
        obj_idx = rng.choice(
            np.arange(n_hand_avail, sdf_data.shape[0]), cfg.num_samp_obj,
            replace=False,
        )
        hand_near = np.where(
            np.abs(sdf_data[:n_hand_avail, 3]) < cfg.points_filter_dist
        )[0]
        obj_near = np.where(
            np.abs(sdf_data[n_hand_avail:, 4]) < cfg.points_filter_dist
        )[0] + n_hand_avail
        hand_pre_idx = rng.choice(hand_near, cfg.num_samp_hand, replace=False)
        obj_pre_idx = rng.choice(obj_near, cfg.num_samp_obj, replace=False)
        all_idx = np.concatenate([hand_idx, obj_idx, hand_pre_idx, obj_pre_idx])
        labels = None
        if cfg.classifier_branch and sdf_data.shape[1] > 5:
            # part label column; clamp-invalidated -> -1 (sdf_utils.py:87-91)
            labels = np.where(
                np.abs(sdf_data[hand_idx, 3]) > cfg.clamping_distance,
                -1, sdf_data[hand_idx, 5].astype(np.int32),
            ).astype(np.int32)
        return sdf_data[all_idx, :5].copy(), labels

    def _getitem_render(
        self, sample: Dict, rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        """Rendered-sample decode (data/ho3d.py:208-263): annotations are
        already in OpenCV camera coordinates (no OpenGL flip); objRot is a
        3x3 matrix; MANO params are zeros (the ho3d_render preset supervises
        hand pose via IK on joints instead, data/ho3d.py:249)."""
        cfg = self.cfg
        fname = sample["key"][len("render:"):]
        rdir = os.path.join(self.fast_data_dir, "render")
        img = IIO.open_image(os.path.join(rdir, "rgb", f"{fname}.png"), self.native)
        with open(os.path.join(rdir, "anno", f"{fname}.json")) as f:
            anno = json.load(f)
        K = np.asarray(anno["camMat"], np.float64).reshape(3, 3)
        joints_3d = np.asarray(anno["handJoints3D"], np.float32)
        _, joints_uv = T.project_points_np(joints_3d, K)
        mano_param = np.zeros(58, np.float32)  # original ho3d.py:249

        obj_rot_mat = np.asarray(anno["objRot"], np.float32).reshape(3, 3)
        obj_trans = np.asarray(anno["objTrans"], np.float32)
        obj_rot = T.inv_rodrigues_np(obj_rot_mat.astype(np.float64)).astype(
            np.float32
        )
        # rest-frame 21-pt bbox from the real object cloud (ho3d.py:250-259)
        obj_corners = self.obj_bbox3d[anno["objName"]]
        rt = np.concatenate(
            [obj_rot_mat.astype(np.float32), obj_trans[:, None]], axis=1
        )
        p3d, p2d = T.project_points_np(obj_corners, K, rt=rt)

        hand_seg, obj_seg = self._load_seg(
            os.path.join(rdir, "seg", f"{fname}.png")
        )

        sdf_data = np.load(sample["sdf_path"])
        n_hand_avail = int(sample["sdf_counts"][0])
        sdf_points, hand_part_labels = self._draw_sdf_points(
            rng, sdf_data, n_hand_avail
        )

        (img, mano_param, K, hand_seg_a, obj_seg_a, p2d, joints_uv, bbox_hand,
         bbox_obj, sdf_points, joints_3d, p3d, obj_rot, obj_trans) = self._aug(
            rng, img, mano_param, joints_uv, K, hand_seg, obj_seg,
            p2d, sdf_points, joints_3d, p3d, obj_rot, obj_trans,
            coord_change_mat=np.eye(3, dtype=np.float32),  # already OpenCV
        )
        return self._assemble(
            cfg, img, mano_param, K, hand_seg_a, obj_seg_a, joints_uv,
            joints_3d, sdf_points, bbox_hand, bbox_obj, obj_rot, obj_trans,
            np.int32(HO3D_OBJECTS.index(anno["objName"]))
            if anno.get("objName") in HO3D_OBJECTS else np.int32(-1),
            hand_part_labels=hand_part_labels,
        )

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(idx, epoch)
        if self.mode == "evaluation":
            return self._getitem_eval(idx)
        sample = self.samples[idx]
        if sample["key"].startswith("render:"):
            return self._getitem_render(sample, rng)
        seq, frame = sample["key"].split("/")
        img = IIO.open_image(os.path.join(self.root, "train", seq, "rgb", f"{frame}.png"),
                             self.native)
        K = sample["K"].copy()
        joints_3d = sample["joints_3d"].copy()
        mano_param = sample["mano_param"].copy()
        _, joints_uv = T.project_points_np(joints_3d, K)
        p2d = sample["obj_p2d"].copy()
        p3d = sample["obj_p3d"].copy()

        # object pose + class from the per-frame meta pkl (ho3d.py:178-196)
        meta = load_meta_pkl(
            os.path.join(self.root, "train", seq, "meta", f"{frame}.pkl")
        )
        obj_rot, obj_trans = convert_pose_to_opencv(
            np.asarray(meta["objRot"], np.float32).reshape(3),
            np.asarray(meta["objTrans"], np.float32),
        )
        obj_name = str(meta["objName"])

        hand_seg, obj_seg = self._load_seg(
            os.path.join(self.root, "train", seq, "seg", f"{frame}.jpg")
        )

        sdf_data = np.load(sample["sdf_path"])
        n_hand, n_obj = int(sample["sdf_counts"][0]), int(sample["sdf_counts"][1])
        if sdf_data.shape[0] != n_hand + n_obj:  # ho3d.py:460
            raise ValueError(f"{sample['sdf_path']}: {sdf_data.shape[0]} rows, but "
                             f"sdf_index counts {(n_hand, n_obj)}")
        sdf_points, hand_part_labels = self._draw_sdf_points(rng, sdf_data, n_hand)

        (img, mano_param, K, hand_seg_a, obj_seg_a, p2d, joints_uv, bbox_hand,
         bbox_obj, sdf_points, joints_3d, p3d, obj_rot, obj_trans) = self._aug(
            rng, img, mano_param, joints_uv, K, hand_seg, obj_seg,
            p2d, sdf_points, joints_3d, p3d, obj_rot, obj_trans,
        )
        return self._assemble(
            cfg, img, mano_param, K, hand_seg_a, obj_seg_a, joints_uv,
            joints_3d, sdf_points, bbox_hand, bbox_obj, obj_rot, obj_trans,
            np.int32(HO3D_OBJECTS.index(obj_name))
            if obj_name in HO3D_OBJECTS else np.int32(-1),
            hand_part_labels=hand_part_labels,
        )

    def _getitem_eval(self, idx: int) -> Dict[str, np.ndarray]:
        """Evaluation split (data/ho3d.py:591-653): image + bbox + K + root
        joint + object-pose targets (obj_rot / rel_obj_trans feed ADD-S/MME
        at main/test.py:131-137)."""
        cfg = self.cfg
        seq, frame = self.set_list[idx].split("/")
        img = IIO.open_image(os.path.join(self.root, "evaluation", seq, "rgb", f"{frame}.png"),
                             self.native)
        meta = load_meta_pkl(
            os.path.join(self.root, "evaluation", seq, "meta", f"{frame}.pkl")
        )
        K = np.asarray(meta["camMat"], np.float64).reshape(3, 3)
        obj_name = str(meta["objName"])

        # project the rest-frame 21-pt bbox with the OpenCV-converted pose
        # (= ho3d_util.pose_from_RT's row flip, ho3d_util.py:44-53)
        obj_rot, obj_trans = convert_pose_to_opencv(
            np.asarray(meta["objRot"], np.float32).reshape(3),
            np.asarray(meta["objTrans"], np.float32),
        )
        rt = np.concatenate(
            [T.rodrigues_np(obj_rot.astype(np.float64)).astype(np.float32),
             obj_trans[:, None]], 1,
        )
        _, p2d = T.project_points_np(self.obj_bbox3d[obj_name], K, rt=rt)

        hj = np.asarray(meta["handJoints3D"], np.float32)
        if hj.ndim == 2:  # some frames store all 21; the root is joint 0
            hj = hj[0]
        root_joint = COORD_CHANGE_MAT @ hj
        bbox_hand = np.asarray(meta["handBoundingBox"], np.float32)

        img, bbox_hand, bbox_obj, K2 = self._crop_eval(img, K, bbox_hand, p2d)
        obj_center_cam = T.get_center_cam(
            bbox_obj, cfg.obj_depth_mean_value, K2
        ).astype(np.float32)
        return {
            "img": IIO.to_float_image(img),
            "cam_intr": K2.astype(np.float32),
            "mano_root": root_joint.astype(np.float32),
            "obj_center_cam": obj_center_cam,
            "bbox_hand": bbox_hand.astype(np.float32),
            "bbox_obj": bbox_obj.astype(np.float32),
            "obj_cls": np.asarray(
                HO3D_OBJECTS.index(obj_name)
                if obj_name in HO3D_OBJECTS else -1, np.int32
            ),
            # pitcher_base is excluded from HO3D object metrics
            # (common/metrics.py:131-143)
            "obj_valid": np.asarray(obj_name != "019_pitcher_base"),
            "target_obj_rot": obj_rot.astype(np.float32),
            "target_rel_obj_trans": (
                obj_trans.astype(np.float32) - obj_center_cam
            ),
        }

    def _crop_eval(self, img, K, bbox_hand, p2d):
        """Deterministic eval crop (data/ho3d.py:399-430): hand bbox expanded
        1.2x, object bbox 1.0x, fused 1.5x window, no in-plane spin."""
        bh = np.asarray(bbox_hand, np.float32).reshape(2, 2)
        crop_hand = T.get_bbox_joints(bh, bbox_factor=1.5)
        crop_obj = T.get_bbox_joints(p2d, bbox_factor=1.5)
        bbox_hand = T.get_bbox_joints(bh, bbox_factor=self.bbox_hand_factor)
        bbox_obj = T.get_bbox_joints(p2d, bbox_factor=1.0)
        center, scale = T.fuse_bbox(crop_hand, crop_obj, img.size)
        affinetrans, _ = T.get_affine_transform(
            center, scale, [self.inp_res, self.inp_res]
        )
        bbox_hand = T.transform_coords(
            bbox_hand.reshape(2, 2), affinetrans
        ).flatten()
        bbox_obj = T.transform_coords(bbox_obj.reshape(2, 2), affinetrans).flatten()
        img = IIO.finalize_image(img, affinetrans, self.inp_res)
        return img, bbox_hand.astype(np.float32), bbox_obj.astype(np.float32), (
            affinetrans.astype(np.float64) @ K
        )

    def _sample_rot(self, rng: np.random.Generator) -> float:
        """HO3D draws the aug spin uniformly over +-max_rot (data/ho3d.py:319),
        unlike DexYCB's gated gaussian (data/dexycb.py:266-274)."""
        return float(rng.uniform(-self.max_rot, self.max_rot))

    # The original's HO3D train path runs DexYCB's augmentation and assembly
    # with HO3D's knobs (bbox_hand_factor, the spin law, the MANO orient's
    # coordinate change), so the methods are DexYCB's.
    _aug = DexYCBDataset._aug
    _warp_seg = DexYCBDataset._warp_seg
    _assemble = DexYCBDataset._assemble
