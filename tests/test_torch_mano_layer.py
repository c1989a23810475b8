"""The port's MANO layer (``hoisdf_torch/mano/layer.py``) against the JAX
package's, option by option, on shared seeded inputs (numpy draws handed to
both sides): PCA at 6 and 45 components, ``center_idx`` None and 5,
``trans``, the left hand's fingertips, ``flat_hand_mean=False`` and
rotation matrices; ``ManoLayer``; the torch golden
``tests/golden/mano_forward.npz``; and ``mano/demo.py``'s random hand.

Tolerance 1e-3 mm on vertices and joints (f32 on both sides, JAX at matmul
precision "highest"; other summation orders through the skinning), as
``tests/test_torch_modules.py``; the golden at 2e-2 mm, as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hoisdf_torch.mano.demo import generate_random_hand
from hoisdf_torch.mano.layer import ManoBuffers, ManoLayer, mano_forward
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_tpu.mano.demo import generate_random_hand as jax_random_hand
from hoisdf_tpu.mano.layer import ManoBuffers as JaxManoBuffers
from hoisdf_tpu.mano.layer import ManoLayer as JaxManoLayer
from hoisdf_tpu.mano.layer import mano_forward as jax_mano_forward

from torch_port_util import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL_MM = 1e-3
B = 3


@pytest.fixture(scope="module")
def buffers():
    m = make_synthetic_mano(0)
    return ManoBuffers.from_model(m), JaxManoBuffers.from_model(m)


def _pose(ncomps, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3 + ncomps) * 0.4).astype(np.float32)


def _rotmats(seed):
    """[B,16,3,3] near-rotations (noise added, so the SO(3) projection works)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    r = Rotation.from_rotvec(rng.randn(B * 16, 3) * 0.4).as_matrix().reshape(B, 16, 3, 3)
    return (r + rng.randn(*r.shape) * 0.01).astype(np.float32)


CASES = {
    "axisang": dict(ncomps=45),
    "pca6": dict(use_pca=True, ncomps=6),
    "pca45": dict(use_pca=True, ncomps=45),
    "pca6_not_flat": dict(use_pca=True, ncomps=6, flat_hand_mean=False),
    "not_flat": dict(ncomps=45, flat_hand_mean=False),
    "uncentred": dict(ncomps=45, center_idx=None),
    "centred_5": dict(ncomps=45, center_idx=5),
    "trans": dict(ncomps=45, trans=True),
    "left": dict(ncomps=45, side="left"),
    "rotmat": dict(joint_rot_mode="rotmat"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_betas", [True, False])
def test_mano_forward_option_matches_jax(buffers, case, with_betas):
    port, jbuf = buffers
    opts = dict(CASES[case])
    rng = np.random.RandomState(7)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32) if with_betas else None
    trans = (rng.randn(B, 3) * 0.1).astype(np.float32) if opts.pop("trans", False) else None
    if opts.get("joint_rot_mode") == "rotmat":
        pose = _rotmats(3)
    else:
        pose = _pose(opts["ncomps"], 3)
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    verts, joints = mano_forward(port, t(pose), t(betas), t(trans), **opts)
    jv, jj = jax_mano_forward(jbuf, j(pose), j(betas), j(trans), **opts)
    assert verts.shape == (B, 778, 3) and joints.shape == (B, 21, 3)
    np.testing.assert_allclose(verts.numpy(), np.asarray(jv), atol=ATOL_MM)
    np.testing.assert_allclose(joints.numpy(), np.asarray(jj), atol=ATOL_MM)


def test_options_change_the_result(buffers):
    """Each option reaches the forward (a no-op option would pass the
    parity test above trivially)."""
    port, _ = buffers
    pose = torch.from_numpy(_pose(45, 4))
    base_v, base_j = mano_forward(port, pose)
    for opts in (dict(flat_hand_mean=False), dict(center_idx=None), dict(side="left"),
                 dict(use_pca=True, ncomps=45)):
        v, j = mano_forward(port, pose, **opts)
        assert not torch.equal(j, base_j) or not torch.equal(v, base_v), opts
    assert torch.equal(mano_forward(port, pose, trans=torch.zeros(B, 3))[1],
                       mano_forward(port, pose, center_idx=None)[1])


def test_mano_layer_matches_jax():
    m = make_synthetic_mano(1, side="left")
    layer = ManoLayer(m, use_pca=True, ncomps=6, center_idx=None, flat_hand_mean=False)
    jlayer = JaxManoLayer(m, use_pca=True, ncomps=6, center_idx=None, flat_hand_mean=False)
    assert layer.side == "left" and np.array_equal(layer.faces, jlayer.faces)
    np.testing.assert_array_equal(layer.hands_mean.numpy(), np.asarray(jlayer.hands_mean))
    pose = _pose(6, 5)
    betas = (np.random.RandomState(6).randn(B, 10) * 0.5).astype(np.float32)
    v, jt = layer(torch.from_numpy(pose), torch.from_numpy(betas))
    jv, jj = jlayer(jnp.asarray(pose), jnp.asarray(betas))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL_MM)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=ATOL_MM)


def test_mano_forward_golden(golden, buffers):
    g = golden("mano_forward")
    port, _ = buffers
    for betas, suffix in ((g["betas"], ""), (None, "_template")):
        verts, joints = mano_forward(port, torch.from_numpy(g["pose"]),
                                     None if betas is None else torch.from_numpy(betas),
                                     use_pca=False, center_idx=0, flat_hand_mean=True)
        np.testing.assert_allclose(verts.numpy(), g["verts" + suffix], atol=2e-2)
        np.testing.assert_allclose(joints.numpy(), g["joints" + suffix], atol=2e-2)


def test_generate_random_hand_on_the_cpu():
    """Seeded and shaped as JAX's; the draws differ (torch's generator), so
    the values are held through the layer above, not here."""
    a = generate_random_hand(batch_size=2, ncomps=6, seed=3, device="cpu")
    b = generate_random_hand(batch_size=2, ncomps=6, seed=3, device="cpu")
    want = jax_random_hand(batch_size=2, ncomps=6, seed=3)
    for k in ("verts", "joints"):
        assert a[k].shape == tuple(want[k].shape) and torch.equal(a[k], b[k])
        assert torch.isfinite(a[k]).all()
    assert not torch.equal(a["joints"], generate_random_hand(2, 6, seed=4, device="cpu")["joints"])
