"""The DexYCB dataset (a copy of ``hoisdf_tpu/data/dexycb.py``):
annotations, seg masks, SDF samples and augmentation, on the original's
on-disk layout (per-sample JSON annotation dict, label npz files, per-frame
SDF ``.npy`` dumps with one ``sdf_index.npy`` per split), giving the flat
dict of numpy arrays that the JAX package's dataset gives.

As in the JAX package, seg masks are decoded per sample, and randomness goes
through a per-sample ``numpy.random.Generator`` keyed on ``(seed, epoch,
index)``, so a sample is the same in any worker; the colour jitter factors
come from the global ``random`` stream, as there.  Images take the native
C++ pipeline or the PIL path (``Config.native_pipeline``,
``data/image_io.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from hoisdf_torch.config import Config
from hoisdf_torch.data import image_io as IIO
from hoisdf_torch.data import transforms as T
from hoisdf_torch.data.meshes import load_xyz
from hoisdf_torch.mano.model import ManoModel

# YCB class ids 1..21 (data/dex_ycb_util.py:11-33)
YCB_CLASSES = (
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)


class DexYCBDataset:
    """Map-style dataset; ``__getitem__(idx, epoch=0)`` -> a flat dict of
    numpy arrays with ``synthetic_batch``'s keys (one sample, no batch axis)
    and ``obj_cls``."""

    # per-dataset aug knobs; HO3DDataset overrides these (data/ho3d.py:319-345
    # vs data/dexycb.py:266-300 in the original)
    bbox_hand_factor = 1.1
    aug_coord_change_mat = np.eye(3, dtype=np.float32)

    def __init__(
        self,
        cfg: Config,
        mode: str,
        mano_right: ManoModel,
        mano_left: Optional[ManoModel] = None,
        seed: int = 0,
    ):
        if mode not in ("train", "test", "evaluation"):
            raise ValueError(f"DexYCBDataset: mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.inp_res = cfg.input_img_shape[0]
        self.heatmap_res = cfg.output_hm_shape[1]
        self.seed = seed
        # the native C++ image pipeline or PIL (Config.native_pipeline)
        self.native = IIO.resolve_native(cfg.native_pipeline)

        # augmentation hyperparams (data/dexycb.py:31-39)
        self.max_rot = np.pi
        self.scale_jittering = 0.2
        self.center_jittering = 0.1
        self.hue, self.saturation, self.contrast, self.brightness = 0.15, 0.5, 0.5, 0.5
        self.blur_radius = 0.5

        self.comp_right = mano_right.hands_components
        self.comp_left = (
            mano_left.hands_components if mano_left is not None else self.comp_right
        )
        self.has_left_basis = mano_left is not None
        self.hands_mean = mano_right.hands_mean

        ann_dir = cfg.annotation_dir
        if ann_dir is None:
            raise FileNotFoundError(
                "cfg.annotation_dir is unset — point it at the directory "
                "holding the original's dex_ycb_s0_{train,test}_data[_cut]"
                ".json annotation dumps (data/dexycb.py:122-148)."
            )
        # root of the DexYCB release (label npz files, models/) — the
        # original's cfg.dexycb_data_dir (data/dexycb.py:41)
        self.root = cfg.data_dir
        self.fast_data_dir = cfg.fast_data_dir
        self.image_fast_path = cfg.image_fast_path

        # Annotation file names + SDF split dirs exactly as the original
        # resolves them (data/dexycb.py:122-148): the "_cut" jsons pair with
        # the {train,test} SDF dirs, the full jsons with full_{train,test}.
        split = "train" if mode == "train" else "test"
        suffix = "_cut" if cfg.small_dexycb else ""
        sdf_split = split if cfg.small_dexycb else f"full_{split}"
        ann_path = os.path.join(ann_dir, f"dex_ycb_s0_{split}_data{suffix}.json")
        with open(ann_path, encoding="utf-8") as f:
            self.sample_dict = json.load(f)

        # One GLOBAL sdf_index.npy aligned with the sorted sdf_processed
        # listing (data/dexycb.py:149-160): rows are (hand_count, obj_count).
        sdf_dir = os.path.join(self.fast_data_dir, sdf_split, "sdf_processed")
        sdf_list = sorted(f.split(".")[0] for f in os.listdir(sdf_dir))
        sdf_pos = {name: i for i, name in enumerate(sdf_list)}
        raw_sdf_index = np.load(
            os.path.join(self.fast_data_dir, sdf_split, "sdf_index.npy")
        )

        # Sample keys sorted numerically by their trailing id
        # (data/dexycb.py:162), then bbox-sanitized for the full split
        # (data/dexycb.py:163-180).
        self.sample_list = sorted(
            self.sample_dict.keys(), key=lambda x: int(x[3:])
        )
        if not cfg.small_dexycb:
            kept = []
            for sample in self.sample_list:
                joint_2d = np.asarray(
                    self.sample_dict[sample]["joint_2d"], np.float32
                ).squeeze()
                bbox = T.get_bbox(
                    joint_2d, np.ones_like(joint_2d[:, 0]), expansion_factor=1.5
                )
                if T.process_bbox(bbox, 640, 480) is not None:
                    kept.append(sample)
            self.sample_list = kept

        self.sdf_paths, self.sdf_counts = [], []
        for sample in self.sample_list:
            if cfg.small_dexycb:
                # _cut jsons index SDF dumps by a mangled color_file stem
                # (data/dexycb.py:195-202)
                name = (
                    self.sample_dict[sample]["color_file"]
                    .split("-")[-1].split(".")[0].replace("/", "_")
                )
                name = name[:-12] + name[-2:]
            else:
                name = sample
            self.sdf_paths.append(os.path.join(sdf_dir, name + ".npy"))
            self.sdf_counts.append(raw_sdf_index[sdf_pos[name]])
        self.obj_bbox3d = self._load_bbox3d(cfg)

    def _load_bbox3d(self, cfg: Config) -> Dict[int, np.ndarray]:
        """21-pt 3D bbox keypoints per YCB class (dataset_util.py:204-272)
        from the ``{dexycb_root}/models/{name}/points.xyz`` clouds the
        original reads (dex_ycb_util.py:36-44); ``cfg.object_models_dir``
        overrides the models root when set."""
        out = {}
        models_root = cfg.object_models_dir or (
            os.path.join(cfg.data_dir, "models") if cfg.data_dir else None
        )
        if models_root is None:
            return out
        for cls_id, name in enumerate(YCB_CLASSES, start=1):
            path = os.path.join(models_root, name, "points.xyz")
            if not os.path.exists(path):
                continue
            out[cls_id] = T.get_bbox21_3d(load_xyz(path))
        return out

    def __len__(self) -> int:
        return len(self.sample_list)

    def _rng(self, idx: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, epoch, idx))

    def __getitem__(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        info = self.sample_dict[self.sample_list[idx]]
        rng = self._rng(idx, epoch)
        do_flip = info["mano_side"] == "left"

        img = IIO.open_image(os.path.join(self.image_fast_path, info["color_file"]),
                             self.native)
        K = np.zeros((3, 3))
        K[0, 0], K[1, 1] = info["intrinsics"]["fx"], info["intrinsics"]["fy"]
        K[0, 2], K[1, 2] = info["intrinsics"]["ppx"], info["intrinsics"]["ppy"]
        K[2, 2] = 1
        if do_flip:
            img = IIO.flip_image(img)

        # MANO PCA -> axis-angle (+flip mirroring), data/dexycb.py:433-473
        pose_pca = np.asarray(info["pose_m"], np.float32).reshape(-1)
        betas = np.asarray(info["mano_betas"], np.float32)
        joints_3d = np.asarray(info["joint_3d"], np.float32).reshape(21, 3)
        joints_uv = np.asarray(info["joint_2d"], np.float32).reshape(21, 2)
        comp = self.comp_left if do_flip else self.comp_right
        pose_aa = np.concatenate(
            [pose_pca[:3], pose_pca[3:48] @ comp, pose_pca[48:]], 0
        )
        if do_flip:
            p = pose_aa[:48].reshape(-1, 3)
            p[:, 1:] *= -1
            pose_aa[:48] = p.reshape(-1)
            joints_3d[:, 0] *= -1
            joints_uv[:, 0] = img.size[0] - joints_uv[:, 0] - 1
        mano_param = np.concatenate(
            [pose_aa[:3], pose_aa[3:48] + self.hands_mean, betas], 0
        )

        # seg masks from the DexYCB label npz: hand pixels are 255, the
        # grasped object's pixels carry its ycb id (data/dexycb.py:186-193;
        # the original packbits these at init — we decode lazily, same bits)
        label = np.load(os.path.join(self.root, info["label_file"]))
        hand_seg = (label["seg"] == 255).astype(np.uint8)
        obj_seg = (
            label["seg"] == info["ycb_ids"][info["ycb_grasp_ind"]]
        ).astype(np.uint8)
        hand_seg = IIO.SegMask(hand_seg, flip=do_flip)
        obj_seg = IIO.SegMask(obj_seg, flip=do_flip)

        # object pose + projected bbox corners (data/dexycb.py:487-513)
        grasp_pose = np.asarray(
            info["pose_y"][info["ycb_grasp_ind"]], np.float32
        ).reshape(3, 4)
        obj_cls = info["ycb_ids"][info["ycb_grasp_ind"]]
        obj_rot = T.inv_rodrigues_np(grasp_pose[:, :3].astype(np.float64)).astype(
            np.float32
        )
        obj_trans = grasp_pose[:, 3].copy()
        if do_flip:
            K[0, 2] = img.size[0] - K[0, 2] - 1
            obj_trans[0] *= -1
            obj_rot[1:] *= -1
        rt = np.concatenate(
            [T.rodrigues_np(obj_rot.astype(np.float64)).astype(np.float32),
             obj_trans[:, None]], 1,
        )
        p3d, p2d = T.project_points_np(self.obj_bbox3d[obj_cls].copy(), K, rt=rt)

        # SDF samples: per-frame [N,6] = [xyz, sdf_hand, sdf_obj, label] with
        # hand rows first (tool/pre_process_sdf.py output); counts come from
        # the global sdf_index rows (data/dexycb.py:514-521)
        sdf_data = np.load(self.sdf_paths[idx])
        n_hand_avail = int(self.sdf_counts[idx][0])
        n_total = sdf_data.shape[0]
        if n_total != n_hand_avail + int(self.sdf_counts[idx][1]):
            raise ValueError(f"{self.sdf_paths[idx]}: {n_total} rows, but sdf_index counts "
                             f"{tuple(int(c) for c in self.sdf_counts[idx])}")

        hand_idx = rng.choice(n_hand_avail, size=cfg.num_samp_hand, replace=False)
        obj_idx = rng.choice(
            np.arange(n_hand_avail, n_total), size=cfg.num_samp_obj, replace=False
        )
        if self.mode == "train":
            hand_near = np.where(
                np.abs(sdf_data[:n_hand_avail, 3]) < cfg.points_filter_dist
            )[0]
            obj_near = (
                np.where(
                    np.abs(sdf_data[n_hand_avail:, 4]) < cfg.points_filter_dist
                )[0]
                + n_hand_avail
            )
            hand_pre_idx = rng.choice(hand_near, cfg.num_samp_hand, replace=False)
            obj_pre_idx = rng.choice(obj_near, cfg.num_samp_obj, replace=False)
            all_idx = np.concatenate([hand_idx, obj_idx, hand_pre_idx, obj_pre_idx])
        else:
            all_idx = np.concatenate([hand_idx, obj_idx])
        sdf_points = sdf_data[all_idx, :5].copy()
        if do_flip:
            sdf_points[:, 0] *= -1

        hand_part_labels = None
        if cfg.classifier_branch and sdf_data.shape[1] > 5:
            # part label column; clamp-invalidated -> -1 (sdf_utils.py:87-91)
            hand_part_labels = np.where(
                np.abs(sdf_data[hand_idx, 3]) > cfg.clamping_distance,
                -1, sdf_data[hand_idx, 5].astype(np.int32),
            ).astype(np.int32)

        # ---- augmentation / deterministic crop ----
        if self.mode == "train":
            (img, mano_param, K, hand_seg, obj_seg, p2d, joints_uv, bbox_hand,
             bbox_obj, sdf_points, joints_3d, p3d, obj_rot, obj_trans) = self._aug(
                rng, img, mano_param, joints_uv, K, hand_seg, obj_seg, p2d,
                sdf_points, joints_3d, p3d, obj_rot, obj_trans,
            )
        else:
            (img, bbox_hand, bbox_obj, K, joints_uv, p2d, hand_seg, obj_seg) = (
                self._crop(img, K, joints_uv, p2d, hand_seg, obj_seg)
            )

        return self._assemble(
            cfg, img, mano_param, K, hand_seg, obj_seg, joints_uv, joints_3d,
            sdf_points, bbox_hand, bbox_obj, obj_rot, obj_trans, obj_cls,
            hand_part_labels=hand_part_labels,
        )

    # ---- augmentation (data/dexycb.py:219-353) --------------------------------

    def _sample_rot(self, rng) -> float:
        """DexYCB's gated-gaussian 30-degree spin (data/dexycb.py:266-274);
        HO3D overrides with a uniform +-pi draw."""
        rot = (
            np.clip(rng.standard_normal(), -2.0, 2.0) * 30
            if rng.random() <= 0.6 else 0.0
        )
        return rot * self.max_rot / 180

    def _aug(self, rng, img, mano_param, joints_uv, K, hand_seg, obj_seg, p2d,
             sdf_points, joints_3d, p3d, obj_rot, obj_trans,
             coord_change_mat=None):
        crop_hand = T.get_bbox_joints(joints_uv, bbox_factor=1.5)
        crop_obj = T.get_bbox_joints(p2d, bbox_factor=1.5)
        center, scale = T.fuse_bbox(crop_hand, crop_obj, img.size)

        center = center + self.center_jittering * scale * rng.uniform(-1, 1, 2)
        scale_jit = np.clip(
            self.scale_jittering * rng.standard_normal() + 1,
            1 - self.scale_jittering, 1 + self.scale_jittering,
        )
        scale = scale * scale_jit
        rot = self._sample_rot(rng)

        affinetrans, post_rot_trans, rot_mat = T.get_affine_transform(
            center, scale, [self.inp_res, self.inp_res], rot=rot, K=K
        )
        if coord_change_mat is None:
            # HO3D stores the MANO global orient OpenGL-side and folds the
            # OpenCV flip into the aug spin (data/ho3d.py:324-326)
            coord_change_mat = self.aug_coord_change_mat
        mano_param = mano_param.copy()
        mano_param[:3] = T.rotation_angle(
            mano_param[:3].astype(np.float64), rot_mat.astype(np.float64),
            coord_change_mat=coord_change_mat.astype(np.float64),
        )
        joints_uv = T.transform_coords(joints_uv, affinetrans)
        sdf_points = sdf_points.copy()
        sdf_points[:, :3] = sdf_points[:, :3] @ rot_mat.T
        joints_3d = joints_3d @ rot_mat.T
        p3d = p3d @ rot_mat.T
        obj_rot = T.rotation_angle(
            obj_rot.astype(np.float64), rot_mat.astype(np.float64)
        )
        obj_trans = rot_mat @ obj_trans
        K = post_rot_trans @ K
        p2d = T.transform_coords(p2d, affinetrans)

        bbox_hand = T.get_bbox_joints(joints_uv, bbox_factor=self.bbox_hand_factor)
        joints_uv = joints_uv / self.inp_res * self.heatmap_res
        bbox_obj = T.get_bbox_joints(p2d, bbox_factor=1.0)

        # the JAX package's draw order: the blur radius, then the jitter
        blur_r = rng.random() * self.blur_radius
        jitter_ops = T.draw_jitter_params(
            self.brightness, self.saturation, self.hue, self.contrast
        )
        img = IIO.finalize_image(
            img, affinetrans, self.inp_res, blur_radius=blur_r,
            jitter_ops=jitter_ops,
        )
        hand_seg, obj_seg = (
            self._warp_seg(s, affinetrans) for s in (hand_seg, obj_seg)
        )
        return (img, mano_param, K, hand_seg, obj_seg, p2d, joints_uv, bbox_hand,
                bbox_obj, sdf_points, joints_3d, p3d, obj_rot, obj_trans)

    def _crop(self, img, K, joints_uv, p2d, hand_seg, obj_seg):
        """Deterministic eval crop (data/dexycb.py:355-404)."""
        crop_hand = T.get_bbox_joints(joints_uv, bbox_factor=1.5)
        crop_obj = T.get_bbox_joints(p2d, bbox_factor=1.5)
        bbox_hand = T.get_bbox_joints(joints_uv, bbox_factor=1.1)
        bbox_obj = T.get_bbox_joints(p2d, bbox_factor=1.0)
        center, scale = T.fuse_bbox(crop_hand, crop_obj, img.size)
        affinetrans, post_rot_trans, _ = T.get_affine_transform(
            center, scale, [self.inp_res, self.inp_res], K=K
        )
        bbox_hand = T.transform_coords(bbox_hand.reshape(2, 2), affinetrans).flatten()
        bbox_obj = T.transform_coords(bbox_obj.reshape(2, 2), affinetrans).flatten()
        img = IIO.finalize_image(img, affinetrans, self.inp_res)
        joints_uv = T.transform_coords(joints_uv, affinetrans)
        joints_uv = joints_uv / self.inp_res * self.heatmap_res
        K = post_rot_trans @ K
        p2d = T.transform_coords(p2d, affinetrans)
        hand_seg, obj_seg = (
            self._warp_seg(s, affinetrans) for s in (hand_seg, obj_seg)
        )
        return img, bbox_hand, bbox_obj, K, joints_uv, p2d, hand_seg, obj_seg

    def _warp_seg(self, seg, affinetrans) -> np.ndarray:
        return IIO.warp_seg(seg, affinetrans, self.inp_res, self.heatmap_res, self.native)

    def _assemble(self, cfg, img, mano_param, K, hand_seg, obj_seg, joints_uv,
                  joints_3d, sdf_points, bbox_hand, bbox_obj, obj_rot, obj_trans,
                  obj_cls, hand_part_labels=None) -> Dict[str, np.ndarray]:
        """Root-relative normalization + flat dict (data/dexycb.py:586-657)."""
        hand_root = joints_3d[0].copy()
        joints_3d = joints_3d - hand_root[None]
        obj_center_cam = T.get_center_cam(bbox_obj, hand_root[-1], K).astype(
            np.float32
        )

        nh, no = cfg.num_samp_hand, cfg.num_samp_obj
        hand_pts = sdf_points[:nh].copy()
        obj_pts = sdf_points[nh : nh + no].copy()
        # NOTE the row-wise scale: xyz AND sdf columns are multiplied
        # (data/dexycb.py:598-603) — the GT sdf targets live in scaled units.
        hand_pts[:, :3] -= hand_root[None]
        hand_pts *= cfg.hand_sdf_scale
        obj_pts[:, :3] -= obj_center_cam[None]
        obj_pts *= cfg.obj_sdf_scale

        out = {
            "img": IIO.to_float_image(img),
            "cam_intr": K.astype(np.float32),
            "mano_root": hand_root.astype(np.float32),
            "obj_center_cam": obj_center_cam,
            "bbox_hand": bbox_hand.astype(np.float32),
            "bbox_obj": bbox_obj.astype(np.float32),
            "hand_sdf_points": hand_pts[:, :3].astype(np.float32),
            "obj_sdf_points": obj_pts[:, :3].astype(np.float32),
            "obj_cls": np.int32(obj_cls),
            "target_hand_sdf": hand_pts[:, 3].astype(np.float32),
            "target_obj_sdf": obj_pts[:, 4].astype(np.float32),
            "target_joint_coord": joints_uv.astype(np.float32),
            "target_joint_cam_no_trans": (joints_3d * 1000).astype(np.float32),
            "target_hand_seg": np.asarray(hand_seg, np.float32),
            "target_obj_seg": np.asarray(obj_seg, np.float32),
            "target_mano_param": mano_param.astype(np.float32),
            "target_obj_rot": obj_rot.astype(np.float32),
            "target_rel_obj_trans": (
                obj_trans.astype(np.float32) - obj_center_cam
            ),
        }
        if hand_part_labels is not None:
            out["target_hand_part_labels"] = hand_part_labels.astype(np.int32)
        if self.mode == "train":
            hand_pre = sdf_points[nh + no : 2 * nh + no, :3].copy()
            obj_pre = sdf_points[2 * nh + no :, :3].copy()
            out["hand_pre_points"] = (
                (hand_pre - hand_root[None]) * cfg.hand_sdf_scale
            ).astype(np.float32)
            out["obj_pre_points"] = (
                (obj_pre - obj_center_cam[None]) * cfg.obj_sdf_scale
            ).astype(np.float32)
        return out
