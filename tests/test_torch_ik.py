"""The port's MANO inverse kinematics (``hoisdf_torch/ops/ik.py``, the
dispatcher: two MANO forwards around the ``hoisdf_torch::ik_solve`` op, whose
CPU implementation is the plain solve) against the JAX solver on the same
seeded joints, against the original solver's golden ``tests/golden/ik.npz``,
and on the JAX package's own cases (``tests/test_ik.py``: the zero pose and
the FK round trip).

Both sides run in f32 on the CPU with the synthetic MANO stand-in.
Tolerance 1e-4 absolute (metres and radians): two SVDs and a chain of
rotations, each in single precision.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.mano.layer import ManoBuffers, mano_forward
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_torch.ops.ik import ik_solver_mano
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.ops.ik import ik_solver_mano as jax_ik_solver_mano

TOL = dict(atol=1e-4, rtol=0)
KEYS = ("verts", "joints", "shape", "pose", "vis")
T = torch.from_numpy


@pytest.fixture(scope="module")
def buffers():
    mano = make_synthetic_mano(0)
    return ManoBuffers.from_model(mano), JaxManoBuffers.from_model(mano)


def _fk_joints(buf, seed, b, scale=0.2, mirror=False):
    """FK joints in metres, 0.5 m in front of the camera, with 2 mm noise."""
    rng = np.random.RandomState(seed)
    pose = T((rng.randn(b, 48) * scale).astype(np.float32))
    shape = (rng.randn(b, 10) * 0.3).astype(np.float32)
    _, joints = mano_forward(buf, pose, T(shape))
    joints = joints.numpy() / 1000.0 + np.float32([0.0, 0.0, 0.5])
    joints += (rng.randn(*joints.shape) * 0.002).astype(np.float32)
    if mirror:  # a left hand: Kabsch finds a reflection, and the pose stays zero
        joints[..., 0] *= -1
    return joints.astype(np.float32), shape


def _both(buffers, joints, shape):
    got = ik_solver_mano(buffers[0], T(joints), None if shape is None else T(shape))
    want = jax_ik_solver_mano(buffers[1], jnp.asarray(joints),
                              None if shape is None else jnp.asarray(shape))
    return {k: got[k].numpy() for k in KEYS}, {k: np.asarray(want[k]) for k in KEYS}


def test_ik_matches_golden_solver(golden, buffers):
    g = golden("ik")
    res = ik_solver_mano(buffers[0], T(g["pred_joints"]), T(g["mano_shape"]))
    for k in ("pose", "joints", "verts"):
        np.testing.assert_allclose(res[k].numpy(), g[k], err_msg=k, **TOL)
    np.testing.assert_array_equal(res["vis"].numpy().ravel(), g["vis"].ravel())


@pytest.mark.parametrize("case", ["golden_inputs", "posed", "mirrored", "no_shape"])
def test_ik_matches_jax_solver(golden, buffers, case):
    if case == "golden_inputs":
        g = golden("ik")
        joints, shape = g["pred_joints"], g["mano_shape"]
    else:
        joints, shape = _fk_joints(buffers[0], 3, 4, mirror=case == "mirrored")
        if case == "no_shape":
            shape = None
    got, want = _both(buffers, joints, shape)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    if case == "mirrored":
        assert not got["vis"].any()
        np.testing.assert_array_equal(got["pose"], 0.0)
    elif case == "posed":
        assert got["vis"].all()


def test_ik_zero_pose_exact(buffers):
    buf = buffers[0]
    shape = torch.zeros(1, 10)
    _, joints = mano_forward(buf, torch.zeros(1, 48), shape)
    joints_m = joints / 1000.0
    res = ik_solver_mano(buf, joints_m, shape)
    assert float(torch.linalg.vector_norm(res["joints"] - joints_m, dim=-1).max()) < 1e-3
    assert float(res["pose"].abs().max()) < 0.2


def test_ik_roundtrip_on_fk_joints(buffers):
    buf = buffers[0]
    rng = np.random.RandomState(0)
    pose = T(rng.randn(2, 48).astype(np.float32) * 0.2)
    shape = T(rng.randn(2, 10).astype(np.float32) * 0.3)
    _, joints = mano_forward(buf, pose, shape)
    joints_m = joints / 1000.0 + torch.tensor([[0.0, 0.0, 0.5]])[:, None]
    res = ik_solver_mano(buf, joints_m, shape)
    assert res["pose"].shape == (2, 48) and res["vis"].shape == (2, 1)
    err = torch.linalg.vector_norm(res["joints"] - joints_m, dim=-1)
    assert float(err.mean()) < 0.02, float(err.mean())
