"""The port's host-side data transforms, image seams and mesh helpers against
the JAX package's (``data/transforms.py``, the PIL half of
``data/image_io.py``, ``data/meshes.py``): the same numpy and PIL arithmetic,
so every result is equal bit for bit, on seeded random inputs and on the
edge cases (the zero and the near-pi rotation, a degenerate box, a
non-square crop, the jitter draws from one ``random.Random`` stream)."""

import random

import numpy as np
from PIL import Image

from hoisdf_torch.data import image_io as PI
from hoisdf_torch.data import meshes as PM
from hoisdf_torch.data import transforms as PT
from hoisdf_tpu.data import image_io as JI
from hoisdf_tpu.data import meshes as JM
from hoisdf_tpu.data import transforms as JT

from torch_data_fixtures import write_simple_models


def _eq(got, want, what=""):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _eq(g, w, what)
        return
    if want is None:
        assert got is None, what
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)
    assert np.asarray(got).dtype == np.asarray(want).dtype, what


def test_rotations_equal_jax():
    rng = np.random.RandomState(0)
    near_pi = JT.rodrigues_np(np.array([0.0, np.pi - 1e-8, 0.0]))
    for aa in [rng.randn(3) for _ in range(5)] + [np.zeros(3), np.array([np.pi, 0, 0])]:
        _eq(PT.rodrigues_np(aa), JT.rodrigues_np(aa), "rodrigues")
        rot = JT.rodrigues_np(aa)
        _eq(PT.inv_rodrigues_np(rot), JT.inv_rodrigues_np(rot), "inv_rodrigues")
        m = JT.rodrigues_np(rng.randn(3))
        _eq(PT.rotation_angle(aa, m), JT.rotation_angle(aa, m), "rotation_angle")
        _eq(PT.rotation_angle(aa, m, np.diag([1.0, -1, -1])),
            JT.rotation_angle(aa, m, np.diag([1.0, -1, -1])), "rotation_angle, coord change")
    _eq(PT.inv_rodrigues_np(near_pi), JT.inv_rodrigues_np(near_pi), "near pi")


def test_affine_and_boxes_equal_jax():
    rng = np.random.RandomState(1)
    K = np.array([[600.0, 0, 321.5], [0, 598.0, 242.0], [0, 0, 1]])
    for _ in range(4):
        center, scale, rot = rng.rand(2) * 400 + 100, rng.rand() * 200 + 50, rng.randn()
        for res in ([64, 64], [64, 48]):
            _eq(PT.get_affine_trans_no_rot(center, scale, res),
                JT.get_affine_trans_no_rot(center, scale, res), "no_rot")
            _eq(PT.get_affine_transform(center, scale, res, rot=rot),
                JT.get_affine_transform(center, scale, res, rot=rot), "affine")
            _eq(PT.get_affine_transform(center, scale, res, rot=rot, K=K),
                JT.get_affine_transform(center, scale, res, rot=rot, K=K), "affine, K")
        pts = rng.rand(21, 2) * 600
        aff = JT.get_affine_transform(center, scale, [64, 64], rot=rot)[0]
        _eq(PT.transform_coords(pts, aff), JT.transform_coords(pts, aff), "coords")
        _eq(PT.get_bbox_joints(pts, 1.5), JT.get_bbox_joints(pts, 1.5), "bbox_joints")
        b1, b2 = JT.get_bbox_joints(pts, 1.1), JT.get_bbox_joints(pts[:5] + 30, 1.0)
        _eq(PT.fuse_bbox(b1, b2, (640, 480)), JT.fuse_bbox(b1, b2, (640, 480)), "fuse")
        _eq(PT.normalize_joints(pts, b1), JT.normalize_joints(pts, b1), "normalize")
        cloud = rng.randn(50, 3)
        _eq(PT.get_bbox21_3d(cloud), JT.get_bbox21_3d(cloud), "bbox21")
        valid = (rng.rand(21) > 0.2).astype(np.float32)
        box = JT.get_bbox(pts, valid, 1.5)
        _eq(PT.get_bbox(pts, valid, 1.5), box, "get_bbox")
        _eq(PT.process_bbox(box, 640, 480), JT.process_bbox(box, 640, 480), "process_bbox")
        p25 = np.array([*pts[0], 0.6])
        _eq(PT.pixel2cam(p25, K), JT.pixel2cam(p25, K), "pixel2cam")
        _eq(PT.get_center_cam(b1, 0.6, K), JT.get_center_cam(b1, 0.6, K), "center_cam")
        rt = np.concatenate([JT.rodrigues_np(rng.randn(3)), rng.randn(3, 1)], 1)
        p3 = rng.randn(21, 3) + [0, 0, 5]
        _eq(PT.project_points_np(p3, K, rt), JT.project_points_np(p3, K, rt), "project")
    _eq(PT.process_bbox(np.array([10.0, 10, 0, 5]), 640, 480), None, "degenerate box")


def test_images_jitter_and_seams_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "frame.png")
    Image.fromarray(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8)).save(path)
    img, jimg = PI.open_image(path), JI.open_image(path, native=False)
    _eq(np.asarray(img), np.asarray(jimg), "open")
    _eq(np.asarray(PI.flip_image(img)), np.asarray(JI.flip_image(jimg)), "flip")
    aff = JT.get_affine_transform(np.array([30.0, 20]), 40.0, [32, 32], rot=0.3)[0]
    _eq(np.asarray(PT.transform_img(img, aff, [32, 32])),
        np.asarray(JT.transform_img(jimg, aff, [32, 32])), "transform_img")
    for seed in range(4):
        ops = PT.draw_jitter_params(0.5, 0.5, 0.15, 0.5, rng=random.Random(seed))
        assert ops == JT.draw_jitter_params(0.5, 0.5, 0.15, 0.5, rng=random.Random(seed))
        _eq(np.asarray(PT.apply_jitter_pil(img, ops)), np.asarray(JT.apply_jitter_pil(img, ops)),
            f"jitter {ops}")
        _eq(np.asarray(PT.color_jitter(img, 0.5, 0.5, 0.5, 0.15, rng=random.Random(seed))),
            np.asarray(JT.color_jitter(jimg, 0.5, 0.5, 0.5, 0.15, rng=random.Random(seed))),
            "color_jitter")
        out = PI.finalize_image(img, aff, 32, blur_radius=0.3 * seed, jitter_ops=ops)
        want = JI.finalize_image(jimg, aff, 32, blur_radius=0.3 * seed, jitter_ops=ops)
        _eq(PI.to_float_image(out), JI.to_float_image(want), "finalize")
    seg = (rng.rand(48, 64) > 0.5).astype(np.uint8)
    for flip in (False, True):
        jseg = Image.fromarray(seg[:, ::-1] if flip else seg)
        _eq(PI.warp_seg(PI.SegMask(seg, flip), aff, 32, 16), JI.warp_seg(jseg, aff, 32, 16),
            f"warp_seg flip={flip}")


def test_meshes_equal_jax(tmp_path):
    models = write_simple_models(str(tmp_path / "simple"), verts=40)
    rng = np.random.RandomState(3)
    np.savetxt(tmp_path / "simple" / "011_banana" / "points.xyz", rng.randn(30, 3))
    names = ("011_banana", "024_bowl", "999_absent")
    for mesh_file in ("points.xyz", "textured_simple_2000.obj"):
        got = PM.load_object_library(models, names, mesh_file=mesh_file)
        want = JM.load_object_library(models, names, mesh_file=mesh_file)
        for g, w in zip(got, want):
            assert list(g) == list(w), mesh_file
            for k in w:
                _eq(g[k], w[k], f"{mesh_file} {k}")
    big = rng.randn(2500, 3).astype(np.float32)
    for verts in (big, big[:300]):
        assert PM.mesh_diameter(verts) == JM.mesh_diameter(verts)
        assert PM.mesh_radius(verts) == JM.mesh_radius(verts)
        _eq(PM.bbox21_3d(verts), JM.bbox21_3d(verts))
