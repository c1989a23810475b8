"""Host-side geometric and photometric transforms of the data pipeline
(a numpy + PIL copy of ``hoisdf_tpu/data/transforms.py``, the same
arithmetic in the same order, so samples agree bit for bit).

The original's ``data/dataset_util.py``: affine crop construction (:54-103),
coordinate and image transforms (:38-51), bboxes (:114-141, 319-332), colour
jitter (:144-201) and camera helpers (:335-350); Rodrigues in numpy.  These
run in the loader's workers; the model sees only the fixed-shape arrays they
produce.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance


# ---- rotations (numpy; replaces cv2.Rodrigues uses in the data path) -----------


def rodrigues_np(aa: np.ndarray) -> np.ndarray:
    """Axis-angle [3] -> rotation matrix [3,3]."""
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    k = aa / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def inv_rodrigues_np(rot: np.ndarray) -> np.ndarray:
    """Rotation matrix [3,3] -> axis-angle [3]."""
    cos_t = np.clip((np.trace(rot) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # near-pi: extract axis from R + I
        m = (rot + np.eye(3)) / 2
        axis = np.sqrt(np.maximum(np.diagonal(m), 0))
        # fix signs from off-diagonals
        if m[0, 1] < 0:
            axis[1] = -axis[1]
        if m[0, 2] < 0:
            axis[2] = -axis[2]
        return axis / np.linalg.norm(axis) * theta
    v = np.array(
        [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]]
    )
    return v / (2 * np.sin(theta)) * theta


def rotation_angle(
    angle: np.ndarray, rot_mat: np.ndarray, coord_change_mat: Optional[np.ndarray] = None
) -> np.ndarray:
    """Compose a rotation matrix onto an axis-angle pose
    (dataset_util.py:106-111)."""
    per = rodrigues_np(angle)
    if coord_change_mat is not None:
        rot_mat = rot_mat @ coord_change_mat
    return inv_rodrigues_np(rot_mat @ per).astype(np.float32)


# ---- affine crop construction ---------------------------------------------------


def get_affine_trans_no_rot(center, scale, res) -> np.ndarray:
    """Pixel-space 3x3 mapping a square window of edge ``scale`` centred at
    ``center`` onto an output canvas of dims ``res``.

    Numerically identical to the original's matrix (dataset_util.py:97-103)
    including its crossed use of the two output dims between the zoom
    diagonal and the translation column (visible only for non-square
    outputs; every preset crops square).
    """
    zoom_u = float(res[0]) / scale
    zoom_v = float(res[1]) / scale
    shift_u = res[1] * (0.5 - float(center[0]) / scale)
    shift_v = res[0] * (0.5 - float(center[1]) / scale)
    return np.array(
        [[zoom_u, 0.0, shift_u], [0.0, zoom_v, shift_v], [0.0, 0.0, 1.0]]
    )


def get_affine_transform(center, scale, res, rot: float = 0, K=None):
    """In-plane spin about the pixel origin composed with the crop window
    (dataset_util.py:54-94).

    With ``K`` the spin is additionally re-centred on the principal point —
    that variant feeds the intrinsics update, and its matrix-chain
    evaluation order is kept bit-identical to the original for crop
    parity.  Returns ``(total, spun_crop, spin)`` with K, else
    ``(total, spin)``.
    """
    sn, cs = np.sin(rot), np.cos(rot)
    spin = np.array(
        [[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]]
    )
    center_h = np.array([center[0], center[1], 1.0])
    crop = get_affine_trans_no_rot((spin @ center_h)[:2], scale, res)
    total = crop @ spin
    if K is None:
        return total.astype(np.float32), spin.astype(np.float32)
    to_pp = np.eye(3)
    to_pp[:2, 2] = [-K[0, 2], -K[1, 2]]
    from_pp = to_pp.copy()
    from_pp[:2, 2] *= -1
    center_spun_about_pp = from_pp @ spin @ to_pp @ center_h
    spun_crop = get_affine_trans_no_rot(center_spun_about_pp[:2], scale, res)
    return (
        total.astype(np.float32),
        spun_crop.astype(np.float32),
        spin.astype(np.float32),
    )


def transform_coords(pts: np.ndarray, affine_trans: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to 2D points [N,2] (dataset_util.py:38-41)."""
    hom = np.concatenate([pts, np.ones((np.asarray(pts).shape[0], 1))], axis=1)
    return (affine_trans @ hom.T).T[:, :2]


def transform_img(img: Image.Image, affine_trans: np.ndarray, res) -> Image.Image:
    """Warp a PIL image by the affine (PIL takes the inverse map;
    dataset_util.py:44-51)."""
    inv = np.linalg.inv(affine_trans)
    return img.transform(
        tuple(res),
        Image.AFFINE,
        (inv[0, 0], inv[0, 1], inv[0, 2], inv[1, 0], inv[1, 1], inv[1, 2]),
    )


# ---- bboxes ---------------------------------------------------------------------


def get_bbox_joints(joints2d: np.ndarray, bbox_factor: float = 1.1) -> np.ndarray:
    """Expanded bbox around 2D points (dataset_util.py:114-126); note the
    original's int() center truncation, preserved."""
    min_x, min_y = joints2d.min(0)
    max_x, max_y = joints2d.max(0)
    center = np.asarray([int((max_x + min_x) / 2), int((max_y + min_y) / 2)])
    delta = np.asarray(
        [(max_x - min_x) * bbox_factor / 2, (max_y - min_y) * bbox_factor / 2]
    )
    return np.array([*(center - delta), *(center + delta)], dtype=np.float32)


def fuse_bbox(bbox_1, bbox_2, img_shape, scale_factor: float = 1.0):
    """Union of two bboxes clipped to the image -> (center, square scale)
    (dataset_util.py:319-333)."""
    bbox = np.concatenate((bbox_1.reshape(2, 2), bbox_2.reshape(2, 2)), axis=0)
    min_x, min_y = bbox.min(0)
    min_x, min_y = max(0, min_x), max(0, min_y)
    max_x, max_y = bbox.max(0)
    max_x, max_y = min(max_x, img_shape[0]), min(max_y, img_shape[1])
    center = np.asarray([int((max_x + min_x) / 2), int((max_y + min_y) / 2)])
    scale = max(max_x - min_x, max_y - min_y) * scale_factor
    return center, scale


def normalize_joints(joints2d: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    bbox = bbox.reshape(2, 2)
    return (joints2d - bbox[0]) / (bbox[1] - bbox[0])


def get_bbox21_3d(points: np.ndarray) -> np.ndarray:
    """Axis-aligned 3D bbox of a vertex cloud expanded to 21 keypoints:
    8 corners + 12 edge midpoints + center (dataset_util.py:204-272; the
    original's per-point stacking order is corners, bottom/top edge centers,
    then vertical edge centers, then center — reproduced since both builds
    project these for 2D bbox fitting and the set, not the order, matters).
    """
    mn, mx = points.min(0), points.max(0)
    (x0, y0, z0), (x1, y1, z1) = mn, mx
    c = lambda x, y, z: np.array([x, y, z], np.float64)
    corners = [
        c(x0, y0, z0), c(x1, y0, z0), c(x0, y1, z0), c(x1, y1, z0),
        c(x0, y0, z1), c(x1, y0, z1), c(x0, y1, z1), c(x1, y1, z1),
    ]
    # 12 edge midpoints in the original's grouping: 4 bottom (z0), 4 top
    # (z1), 4 vertical (x/y corners)
    edges = [
        (corners[0] + corners[2]) / 2, (corners[1] + corners[3]) / 2,
        (corners[2] + corners[3]) / 2, (corners[0] + corners[1]) / 2,
        (corners[4] + corners[6]) / 2, (corners[5] + corners[7]) / 2,
        (corners[6] + corners[7]) / 2, (corners[4] + corners[5]) / 2,
        (corners[6] + corners[2]) / 2, (corners[4] + corners[0]) / 2,
        (corners[7] + corners[3]) / 2, (corners[5] + corners[1]) / 2,
    ]
    center = (corners[4] + corners[3]) / 2
    return np.stack(corners + edges + [center]).astype(np.float32)


def get_bbox(joint_img: np.ndarray, joint_valid: np.ndarray,
             expansion_factor: float = 1.0) -> np.ndarray:
    """Visibility-aware [x,y,w,h] bbox around 2D joints
    (dex_ycb_util.py:57-80)."""
    x = joint_img[:, 0][joint_valid == 1]
    y = joint_img[:, 1][joint_valid == 1]
    xc, yc = (x.min() + x.max()) / 2.0, (y.min() + y.max()) / 2.0
    w = (x.max() - x.min()) * expansion_factor
    h = (y.max() - y.min()) * expansion_factor
    return np.array([xc - w / 2, yc - h / 2, w, h], np.float32)


def process_bbox(bbox, img_width: int, img_height: int):
    """Clip an [x,y,w,h] bbox to the image; None if degenerate
    (dex_ycb_util.py:82-92)."""
    x, y, w, h = bbox
    x1, y1 = max(0, x), max(0, y)
    x2 = min(img_width - 1, x1 + max(0, w - 1))
    y2 = min(img_height - 1, y1 + max(0, h - 1))
    if w * h > 0 and x2 >= x1 and y2 >= y1:
        return np.array([x1, y1, x2 - x1, y2 - y1])
    return None


# ---- camera ---------------------------------------------------------------------


def pixel2cam(joint25d: np.ndarray, K: np.ndarray) -> np.ndarray:
    x = (joint25d[0] - K[0, 2]) / K[0, 0] * joint25d[2]
    y = (joint25d[1] - K[1, 2]) / K[1, 1] * joint25d[2]
    return np.array([x, y, joint25d[2]])


def get_center_cam(bbox2d: np.ndarray, z: float, K: np.ndarray) -> np.ndarray:
    """2D bbox center lifted to camera space at depth z
    (dataset_util.py:344-350)."""
    c_x = int((bbox2d[0] + bbox2d[2]) / 2)
    c_y = int((bbox2d[1] + bbox2d[3]) / 2)
    return pixel2cam(np.asarray([c_x, c_y, z]), K)


def project_points_np(p3d: np.ndarray, K: np.ndarray, rt: Optional[np.ndarray] = None):
    """3D points (+optional [R|t]) -> (camera pts, pixel coords)
    (dex_ycb_util.py:47-54)."""
    if rt is not None:
        p3d = p3d @ rt[:, :3].T + rt[:, 3]
    p2d = p3d @ K.T
    return p3d, (p2d[:, :2] / p2d[:, 2:3]).astype(np.float32)


# ---- photometric ----------------------------------------------------------------


def _adjust_hue(img: Image.Image, hue_factor: float) -> Image.Image:
    """PIL hue shift matching torchvision.adjust_hue semantics."""
    if abs(hue_factor) < 1e-8:
        return img
    hsv = np.array(img.convert("HSV"), dtype=np.uint8)
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(hue_factor * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


def draw_jitter_params(
    brightness: float = 0,
    saturation: float = 0,
    hue: float = 0,
    contrast: float = 0,
    rng: Optional[random.Random] = None,
) -> list:
    """Draw the jitter op order and factors (dataset_util.py:144-201 draw
    semantics) from ``rng`` (default: the global ``random`` stream), apart
    from their application; the op list is ``[(name, factor), ...]`` in
    shuffled application order."""
    rng = rng or random
    ops = []
    if brightness > 0:
        ops.append(("brightness", rng.uniform(max(0, 1 - brightness), 1 + brightness)))
    if saturation > 0:
        ops.append(("saturation", rng.uniform(max(0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append(("hue", rng.uniform(-hue, hue)))
    if contrast > 0:
        ops.append(("contrast", rng.uniform(max(0, 1 - contrast), 1 + contrast)))
    rng.shuffle(ops)
    return ops


_PIL_JITTER = {
    "brightness": lambda im, f: ImageEnhance.Brightness(im).enhance(f),
    "saturation": lambda im, f: ImageEnhance.Color(im).enhance(f),
    "hue": _adjust_hue,
    "contrast": lambda im, f: ImageEnhance.Contrast(im).enhance(f),
}


def apply_jitter_pil(img: Image.Image, ops: list) -> Image.Image:
    out = img.copy()
    for name, factor in ops:
        out = _PIL_JITTER[name](out, factor)
    return out


def color_jitter(
    img: Image.Image,
    brightness: float = 0,
    contrast: float = 0,
    saturation: float = 0,
    hue: float = 0,
    rng: Optional[random.Random] = None,
) -> Image.Image:
    """Random brightness/saturation/hue/contrast in random order
    (dataset_util.py:144-201); the original's distributions, not its RNG
    order."""
    ops = draw_jitter_params(brightness, saturation, hue, contrast, rng=rng)
    return apply_jitter_pil(img, ops)
