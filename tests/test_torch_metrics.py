"""The port's eval metrics and the rotations they use, against the JAX
package's functions on the same seeded inputs and against the torch golden
``tests/golden/metrics.npz``.

Both sides run in f32 on the CPU.  Tolerance 1e-5 relative (with a 1e-6
absolute floor for values near zero): single-precision sums taken in another
order, and SVDs from two LAPACK builds.  ``EvalUtil`` is host numpy on both
sides and must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch import metrics as PM
from hoisdf_torch.ops import rotations as PR
from hoisdf_tpu import metrics as JM
from hoisdf_tpu.ops import rotations as JR

TOL = dict(rtol=1e-5, atol=1e-6)
GOLDEN_TOL = dict(atol=1e-5, rtol=1e-4)  # the JAX package's own bar for this golden
T = torch.from_numpy


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def g(golden):
    return golden("metrics")


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---- rotations -------------------------------------------------------------

def _reflected_pair(seed):
    """b is a reflection of a: the Kabsch rotation needs its sign fix."""
    a = _rand(seed, 4, 30, 3, scale=0.05)
    b = a * np.array([-1.0, 1.0, 1.0], np.float32) + _rand(seed + 1, 4, 30, 3, scale=0.002)
    return a, b


@pytest.mark.parametrize("case", ["rotated", "reflected"])
def test_rigid_align_matches_jax(case):
    if case == "rotated":
        a = _rand(1, 4, 30, 3, scale=0.05)
        rot = PR.batch_rodrigues(T(_rand(2, 4, 3))).numpy()
        b = 1.3 * a @ rot.transpose(0, 2, 1) + _rand(3, 4, 1, 3, scale=0.1) \
            + _rand(4, 4, 30, 3, scale=0.003)
    else:
        a, b = _reflected_pair(5)
    c, r, t = PR.rigid_transform_3d(T(a), T(b))
    flips = 0
    for i in range(a.shape[0]):
        jc, jr, jt = JR.rigid_transform_3d(jnp.asarray(a[i]), jnp.asarray(b[i]))
        np.testing.assert_allclose(float(c[i]), float(jc), **TOL)
        np.testing.assert_allclose(r[i].numpy(), np.asarray(jr), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(PR.rigid_align(T(a[i]), T(b[i])).numpy(),
                                   np.asarray(JR.rigid_align(jnp.asarray(a[i]),
                                                             jnp.asarray(b[i]))), **TOL)
        assert np.linalg.det(r[i].numpy()) > 0
        u, _, vt = np.linalg.svd((a[i] - a[i].mean(0)).T @ (b[i] - b[i].mean(0)))
        flips += np.linalg.det(vt.T @ u.T) < 0
    assert flips == (a.shape[0] if case == "reflected" else 0)


def test_batch_rotprojs_matches_jax():
    mats = _rand(6, 8, 3, 3)
    mats[:4] *= -1  # some with negative determinant
    got = PR.batch_rotprojs(T(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(JR.batch_rotprojs(jnp.asarray(mats))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


# ---- hand and object metrics ------------------------------------------------

def test_eval_hand_joint_matches_jax_and_golden(g):
    for pred, gt in ((g["hand_pred"], g["hand_gt"]),
                     (_rand(7, 5, 21, 3, scale=0.05), _rand(8, 5, 21, 3, scale=0.05))):
        mje, pamje = PM.eval_hand_joint(T(pred), T(gt))
        jmje, jpamje = JM.eval_hand_joint(jnp.asarray(pred), jnp.asarray(gt))
        np.testing.assert_allclose(float(mje), float(jmje), **TOL)
        np.testing.assert_allclose(float(pamje), float(jpamje), **TOL)
    mje, pamje = PM.eval_hand_joint(T(g["hand_pred"]), T(g["hand_gt"]))
    np.testing.assert_allclose(float(mje), float(g["MJE"]), **GOLDEN_TOL)
    np.testing.assert_allclose(float(pamje), float(g["PAMJE"]), **GOLDEN_TOL)


def _obj_case(g, ho3d):
    rot, trans = g["obj_rot_out"].mean(axis=1), g["obj_trans_out"].mean(axis=1)
    if ho3d:
        used = np.asarray(g["ho3d_used"])
        return (rot[used], trans[used], g["gt_rot"][used], g["gt_trans"][used],
                g["templates"][np.asarray(g["ho3d_cls_ids"])[used]])
    return rot, trans, g["gt_rot"], g["gt_trans"], g["templates"][np.asarray(g["obj_cls"]) - 1]


@pytest.mark.parametrize("ho3d", [False, True], ids=["dexycb", "ho3d"])
def test_eval_batched_obj_direct_matches_jax_and_golden(g, ho3d):
    args = _obj_case(g, ho3d)
    got = PM.eval_batched_obj_direct(*map(T, args), ho3d=ho3d)
    want = JM.eval_batched_obj_direct(*map(jnp.asarray, args), ho3d=ho3d)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    pre = "ho3d" if ho3d else "dexycb"
    for k in want:
        np.testing.assert_allclose(float(got[k].mean()), float(g[f"{pre}_{k}"]), err_msg=k,
                                   **GOLDEN_TOL)
    # the same functions on random meshes with rotated and translated poses
    b, n = 3, 40
    args = (_rand(9, b, 3), _rand(10, b, 3, scale=0.05), _rand(11, b, 3),
            _rand(12, b, 3, scale=0.05), _rand(13, b, n, 3, scale=0.05))
    got = PM.eval_batched_obj_direct(*map(T, args), ho3d=ho3d)
    want = JM.eval_batched_obj_direct(*map(jnp.asarray, args), ho3d=ho3d)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_add_s_corners_and_templates_match_jax():
    a, b = _rand(14, 3, 50, 3, scale=0.05), _rand(15, 3, 50, 3, scale=0.05)
    np.testing.assert_allclose(PM.add_s(T(a), T(b)).numpy(),
                               np.asarray(JM.add_s(jnp.asarray(a), jnp.asarray(b))), **TOL)
    np.testing.assert_array_equal(PM._aabb_corners(T(a)).numpy(),
                                  np.asarray(JM._aabb_corners(jnp.asarray(a))))
    rot, trans = _rand(16, 3, 3), _rand(17, 3, 3)
    np.testing.assert_allclose(
        PM.transform_templates(T(a), T(rot), T(trans)).numpy(),
        np.asarray(JM.transform_templates(jnp.asarray(a), jnp.asarray(rot), jnp.asarray(trans))),
        **TOL)


# ---- F-scores and mesh metrics ------------------------------------------------

@pytest.mark.parametrize("th,fk,pk,rk", [(0.005, "f5", "p5", "r5"), (0.015, "f15", None, None)])
def test_fscore_matches_jax_and_golden(g, th, fk, pk, rk):
    gt, pred = g["fscore_gt"], g["fscore_pred"]
    f, p, r = PM.fscore_pr(T(gt), T(pred), th)
    jf, jp, jr = JM.fscore_pr(jnp.asarray(gt), jnp.asarray(pred), th)
    for got, want in ((f, jf), (p, jp), (r, jr)):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(PM.fscore(T(gt), T(pred), th)) == float(f)
    np.testing.assert_allclose(float(f), float(g[fk]), **GOLDEN_TOL)
    if pk is not None:  # the original's recall is pred -> gt, precision gt -> pred
        np.testing.assert_allclose(float(p), float(g[pk]), **GOLDEN_TOL)
        np.testing.assert_allclose(float(r), float(g[rk]), **GOLDEN_TOL)


def test_mesh_metrics_batch_matches_jax_and_per_sample_fscores():
    """The batched mesh metrics against the JAX package's (whose recall and
    precision carry each other's names: the F-scores agree all the same) and
    against the per-sample ``fscore_pr`` (the port's names)."""
    b, n, th = 3, 778, (0.005, 0.015)
    gt = _rand(18, b, n, 3, scale=0.03)
    pred = gt * 1.05 + _rand(19, b, n, 3, scale=0.004) + _rand(20, b, 1, 3, scale=0.01)
    got = PM.mesh_metrics_batch(T(gt), T(pred), th)
    want = JM.mesh_metrics_batch(jnp.asarray(gt), jnp.asarray(pred), th)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    aligned = PR.rigid_align(T(pred), T(gt))
    for i in range(b):
        for j, t in enumerate(th):
            assert float(got["fscores"][i, j]) == pytest.approx(
                float(PM.fscore_pr(T(gt[i]), T(pred[i]), t)[0]), rel=1e-6)
            assert float(got["fscores_aligned"][i, j]) == pytest.approx(
                float(PM.fscore_pr(T(gt[i]), aligned[i], t)[0]), rel=1e-6)
    assert 0 < float(got["fscores"].min()) < float(got["fscores_aligned"].max()) <= 1


def test_evalutil_measures_equal_jax():
    rng = np.random.RandomState(21)
    port, jax_util = PM.EvalUtil(num_kp=21), JM.EvalUtil(num_kp=21)
    for _ in range(5):
        gt, pred = rng.randn(21, 3) * 0.05, rng.randn(21, 3) * 0.05
        vis = rng.rand(21) > 0.2
        port.feed(gt, pred, vis)
        jax_util.feed(gt, pred, vis)
        d = rng.rand(21) * 0.06
        port.feed_dist(d)
        jax_util.feed_dist(d)
    for args in ((0.0, 0.05, 100), (0.02, 0.05, 20)):
        assert port.get_measures(*args) == jax_util.get_measures(*args)
