"""The port's HO3D dataset against the JAX package's, on an on-disk tree in
the original's layout (``torch_data_fixtures.write_ho3d``): train samples
(the jpg seg composites, the meta pickles, the OpenGL -> OpenCV pose
change), the rendered extension of ho3d_render and the evaluation split,
equal bit for bit on the PIL path (both packages at
``native_pipeline="off"``; the native path is ``test_torch_data_native.py``),
with the global ``random`` stream seeded alike before each sample."""

import random

import numpy as np
import pytest

from hoisdf_torch.config import get_config
from hoisdf_torch.data import ho3d as P
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data import ho3d as J
from hoisdf_tpu.mano.model import make_synthetic_mano as jax_make_synthetic_mano

from torch_data_fixtures import assert_samples_equal, write_ho3d

SMALL = dict(num_samp_hand=48, num_samp_obj=24, points_filter_dist=1.0,
             input_img_shape=(64, 64), output_hm_shape=(32, 32, 32), use_big_decoder=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_ho3d(str(tmp_path_factory.mktemp("ho3d")))


def _pair(tree, setting, mode):
    over = dict(tree, **SMALL, add_render=setting == "ho3d_render")
    return (P.HO3DDataset(get_config(setting, native_pipeline="off", **over), mode,
                          make_synthetic_mano(0), seed=2),
            J.HO3DDataset(jax_get_config(setting, native_pipeline="off", **over), mode,
                          jax_make_synthetic_mano(0), seed=2))


@pytest.mark.parametrize("setting,mode,n", [("ho3d", "train", 2), ("ho3d_render", "train", 4),
                                            ("ho3d", "evaluation", 2)])
def test_samples_equal_jax(tree, setting, mode, n):
    port, jax_ds = _pair(tree, setting, mode)
    assert len(port) == len(jax_ds) == n  # the row without an SDF dump is skipped
    assert port.set_list == jax_ds.set_list
    for epoch in (0, 3):
        for idx in range(n):
            random.seed(10 * epoch + idx)
            got = port.__getitem__(idx, epoch=epoch)
            random.seed(10 * epoch + idx)
            want = jax_ds.__getitem__(idx, epoch=epoch)
            assert_samples_equal(got, want, f"{setting}/{mode}/{epoch}/{idx}")
    if mode == "evaluation":  # the pitcher is left out of the object metrics
        assert [bool(port.__getitem__(i)["obj_valid"]) for i in range(n)] == [True, False]


def test_helpers_equal_jax(tree):
    rng = np.random.RandomState(1)
    for _ in range(3):
        rot, trans = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
        for g, w in zip(P.convert_pose_to_opencv(rot, trans), J.convert_pose_to_opencv(rot, trans)):
            np.testing.assert_array_equal(g, w)
    got, want = (m.load_objects_ho3d(tree["object_models_dir"]) for m in (P, J))
    assert list(got) == list(want) == list(P.HO3D_OBJECTS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(P.COORD_CHANGE_MAT, J.COORD_CHANGE_MAT)
