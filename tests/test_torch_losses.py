"""The port's losses and heatmap against the JAX package's functions on the
same seeded inputs, and against the torch goldens (``golden/losses.npz``, read
as ``tests/test_golden_losses.py`` reads it).

Tolerance: 1e-5 absolute + relative (f32 on both sides, other summation
orders), 1e-4 relative where the golden's lambdas (up to 1e4) amplify f32
rounding, as the JAX package's golden test states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch import losses as P
from hoisdf_torch.config import get_config
from hoisdf_torch.ops.heatmap import render_gaussian_heatmap
from hoisdf_tpu import losses as J
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.ops.heatmap import render_gaussian_heatmap as jax_render_gaussian_heatmap

T = torch.from_numpy


def _close(got, want, atol=1e-5, rtol=1e-5, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def g(golden):
    return golden("losses")


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("name", ["smooth_l1", "bce_with_logits", "bce"])
def test_elementwise_losses_match_jax(name):
    a = _rand(0, 5, 40, scale=2.0)
    b = np.random.RandomState(1).rand(5, 40).astype(np.float32)
    if name == "bce":
        a = 1 / (1 + np.exp(-a))
        a[0, :3] = (0.0, 1.0, 1e-9)  # the clip at eps
    _close(getattr(P, name)(T(a), T(b)), getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))


def test_heatmap_and_its_loss_match_jax():
    coord = np.random.RandomState(2).rand(2, 21, 2).astype(np.float32) * 32
    got = render_gaussian_heatmap(T(coord), (32, 32), 1.25)
    want = jax_render_gaussian_heatmap(jnp.asarray(coord), (32, 32), 1.25)
    assert got.shape == (2, 32, 32)
    _close(got, want, atol=1e-3, rtol=1e-5)  # values up to 255 * 21
    pred = _rand(3, 2, 32, 32, scale=50.0)
    _close(P.joint_heatmap_loss(T(pred), got), J.joint_heatmap_loss(jnp.asarray(pred), want),
           rtol=1e-5)


def test_vote_sdf_mano_and_classifier_losses_match_jax():
    cfg, jcfg = get_config("dexycb"), jax_get_config("dexycb")
    pts = _rand(4, 3, 30, 3, scale=0.03)
    off = _rand(5, 2, 3, 30, 60, scale=0.03)
    cls = _rand(6, 2, 3, 30, 20)
    gt = _rand(7, 3, 20, 3, scale=30.0)
    got = P.joint_vote_loss(cfg, T(pts), T(off), T(cls), T(gt))
    want = J.joint_vote_loss(jcfg, *map(jnp.asarray, (pts, off, cls, gt)))
    assert float(want[0]) > 0  # some points lie within hand_cls_dist of a joint
    for a, b in zip(got, want):
        _close(a, b)
    sdf = [_rand(8 + i, 3, n, *s) for i, (n, s) in enumerate(
        ((12, (1,)), (7, (1,)), (12, ()), (7, ())))]
    for a, b in zip(P.sep_sdf_loss(*map(T, sdf)), J.sep_sdf_loss(*map(jnp.asarray, sdf))):
        _close(a, b)
    shapes = {"verts3d": (24, 3), "joints3d": (21, 3), "mano_pose": (16, 3, 3), "mano_shape": (10,)}
    preds = {k: _rand(20 + i, 2, 3, *s) for i, (k, s) in enumerate(shapes.items())}
    gts = {k: _rand(30 + i, 3, *s) for i, (k, s) in enumerate(shapes.items())}
    got = P.mano_loss(cfg, {k: T(v) for k, v in preds.items()}, {k: T(v) for k, v in gts.items()})
    want = J.mano_loss(jcfg, {k: jnp.asarray(v) for k, v in preds.items()},
                       {k: jnp.asarray(v) for k, v in gts.items()})
    for k in want:
        _close(got[k], want[k], rtol=1e-5, err_msg=k)
    got = P.mano_shape_loss(cfg, T(preds["mano_shape"]), T(gts["mano_shape"][0]))
    want = J.mano_shape_loss(jcfg, jnp.asarray(preds["mano_shape"]),
                             jnp.asarray(gts["mano_shape"][0]))
    for k in want:
        _close(got[k], want[k], err_msg=k)
    logits = _rand(40, 3, 12, 6)
    labels = np.random.RandomState(41).randint(-1, 6, (3, 12)).astype(np.int32)
    _close(P.sdf_part_classifier_loss(T(logits), T(labels)),
           J.sdf_part_classifier_loss(jnp.asarray(logits), jnp.asarray(labels)))


def test_weighted_total_matches_jax_on_every_key():
    cfg, jcfg = get_config("dexycb"), jax_get_config("dexycb")
    keys = ["sdfhand_loss", "sdfobj_loss", "joint_heatmap", "obj_seg", "hand_seg", "obj_rot",
            "obj_trans", "loss_joint_3d", "loss_joint_cls", "loss_all_joint_3d",
            "sdf_cls_loss", "mano_mesh_loss"]  # the last takes the default weight 1
    vals = np.abs(_rand(50, len(keys))) + 0.5
    got = P.weighted_total(cfg, {k: torch.tensor(v) for k, v in zip(keys, vals)})
    want = J.weighted_total(jcfg, {k: jnp.asarray(v) for k, v in zip(keys, vals)})
    _close(got, want, rtol=1e-6)


# ---- the torch goldens -------------------------------------------------------

def test_golden_heatmap_vote_and_sdf_losses(g):
    cfg = get_config("dexycb")
    _close(P.joint_heatmap_loss(T(g["hm_pred"]), T(g["hm_gt"])), g["hm_loss"])
    # golden layouts are [L, P, B, ...]; the port's [L, B, P, ...]
    off = T(np.ascontiguousarray(np.transpose(g["hand_off"], (0, 2, 1, 3))))
    cls = T(np.ascontiguousarray(np.transpose(g["hand_cls"], (0, 2, 1, 3))))
    l3d, lcls, lall, joints = P.joint_vote_loss(cfg, T(g["hand_points"]), off, cls,
                                                T(g["joint_gt"]))
    for got, key in ((l3d, "loss_joint_3d"), (lcls, "loss_joint_cls"),
                     (lall, "loss_all_joint_3d"), (joints, "hand_joints")):
        _close(got, g[key], err_msg=key)
    lh, lo = P.sep_sdf_loss(T(g["hand_sdf"]), T(g["obj_sdf"]), T(g["hand_sdf_gt"]),
                            T(g["obj_sdf_gt"]))
    _close(lh, g["sdfhand_loss"])
    _close(lo, g["sdfobj_loss"])


def test_golden_mano_and_weighted_total(g):
    cfg = get_config("dexycb")
    out = P.mano_loss(
        cfg,
        {"verts3d": T(g["mano_preds_verts3d"]), "joints3d": T(g["mano_preds_joints3d"]),
         "mano_pose": T(g["mano_preds_pose"]), "mano_shape": T(g["mano_preds_shape"])},
        {"verts3d": T(g["mano_gts_verts3d"]), "joints3d": T(g["mano_gts_joints3d"]),
         "mano_pose": T(g["mano_gts_pose"]), "mano_shape": T(g["mano_gts_shape"])})
    for k in ("mano_mesh_loss", "mano_joint_loss", "pose_param_loss", "shape_param_loss"):
        _close(out[k], g[k], rtol=1e-4, err_msg=k)
    out = P.mano_shape_loss(cfg, T(g["shapeonly_pred"]), T(g["shapeonly_gt"]))
    _close(out["shape_param_loss"], g["shapeonly_param_loss"], rtol=1e-5)
    _close(out["shape_reg_loss"], g["shapeonly_reg_loss"], rtol=1e-5)
    names = [str(n) for n in g["weight_term_names"]]
    total = P.weighted_total(cfg, {n: torch.tensor(v) for n, v in
                                   zip(names, np.asarray(g["weight_term_values"]))})
    _close(total, g["weighted_total"], rtol=1e-6)
