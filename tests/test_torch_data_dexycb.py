"""The port's DexYCB dataset against the JAX package's, on an on-disk tree in
the original's layout (``torch_data_fixtures.write_dexycb``): every sample
of the train and the test split, in the full and the small ("cut") layout,
over two epochs, equal bit for bit on the PIL path (the JAX package at
``native_pipeline="off"``).  That covers the left-hand flips, the SDF draws,
the seg masks, the crop and the photometric jitter, whose factors come from
the global ``random`` stream (seeded alike before each sample on both
sides)."""

import random

import numpy as np
import pytest

from hoisdf_torch.config import get_config
from hoisdf_torch.data.dexycb import DexYCBDataset
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data.dexycb import DexYCBDataset as JaxDexYCBDataset
from hoisdf_tpu.mano.model import make_synthetic_mano as jax_make_synthetic_mano

from torch_data_fixtures import assert_samples_equal, write_dexycb

SMALL = dict(num_samp_hand=64, num_samp_obj=32, points_filter_dist=1.0,
             input_img_shape=(64, 64), output_hm_shape=(32, 32, 32))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("dexycb")
    return {cut: write_dexycb(str(base / ("cut" if cut else "full")), cut=cut)
            for cut in (False, True)}


def _pair(tree, mode, left=False, **over):
    cfg = get_config("dexycb", **tree, **SMALL, **over)
    jcfg = jax_get_config("dexycb", **tree, **SMALL, native_pipeline="off", **over)
    mano_l = make_synthetic_mano(7, side="left") if left else None
    jmano_l = jax_make_synthetic_mano(7, side="left") if left else None
    return (DexYCBDataset(cfg, mode, make_synthetic_mano(0), mano_left=mano_l, seed=3),
            JaxDexYCBDataset(jcfg, mode, jax_make_synthetic_mano(0), mano_left=jmano_l, seed=3))


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("layout", ["full", "cut"])
def test_samples_equal_jax(trees, layout, mode):
    port, jax_ds = _pair(trees[layout == "cut"], mode)
    assert len(port) == len(jax_ds) == 3
    assert port.sample_list == jax_ds.sample_list and port.sdf_paths == jax_ds.sdf_paths
    for epoch in (0, 1):
        for idx in range(len(port)):  # idx 2 is a left hand: flipped
            random.seed(1000 * epoch + idx)
            got = port.__getitem__(idx, epoch=epoch)
            random.seed(1000 * epoch + idx)
            want = jax_ds.__getitem__(idx, epoch=epoch)
            assert_samples_equal(got, want, f"{layout}/{mode}/{epoch}/{idx}")
    assert ("hand_pre_points" in got) == (mode == "train")


def test_left_basis_and_part_labels_equal_jax(trees):
    """A flipped sample converts its PCA pose with the left hand's basis; the
    classifier branch adds the part labels."""
    port, jax_ds = _pair(trees[False], "train", left=True, classifier_branch=True)
    assert port.has_left_basis
    random.seed(7)
    got = port.__getitem__(2, epoch=4)
    random.seed(7)
    want = jax_ds.__getitem__(2, epoch=4)
    assert "target_hand_part_labels" in got
    assert_samples_equal(got, want, "left")


def test_train_crop_differs_across_epochs_and_eval_crop_does_not(trees):
    """The train augmentation is drawn per epoch; the eval crop has no
    randomness (its SDF draws do, keyed on the epoch as in the JAX package)."""
    train, _ = _pair(trees[False], "train")
    assert not np.array_equal(train.__getitem__(0, epoch=0)["img"],
                              train.__getitem__(0, epoch=1)["img"])
    test, _ = _pair(trees[False], "test")
    a, b = test.__getitem__(1, epoch=0), test.__getitem__(1, epoch=5)
    for k in ("img", "bbox_hand", "bbox_obj", "cam_intr", "target_hand_seg"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_pipeline_on_is_refused(trees):
    with pytest.raises(NotImplementedError, match="native_pipeline='on'"):
        get_config("dexycb", native_pipeline="on", **trees[False])
    with pytest.raises(ValueError, match="native_pipeline"):
        get_config("dexycb", native_pipeline="fast")
