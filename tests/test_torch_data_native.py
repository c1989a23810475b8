"""The port's datasets on the native image pipeline, on the fixture trees
(``torch_data_fixtures``): DexYCB in the full (png) and the small (jpg)
layout, HO3D train, its rendered extension and its evaluation split.

* The port at ``native_pipeline="on"`` against the JAX package at "on":
  every key of every sample bit-identical, in train and eval mode, over two
  epochs, with the global ``random`` stream (the jitter factors) seeded alike
  before each sample.
* The port at "on" against the port at "off" (the counterparts of
  ``tests/test_dexycb_dataset.py::test_native_vs_pil_backend_ab`` and
  ``tests/test_ho3d_dataset.py::test_ho3d_native_vs_pil_backend_ab``, with
  their bars): eval samples bit-identical; train samples bit-identical on
  every key but ``img``, whose pixels may differ by the blur's few LSB
  (more than 5 LSB on at most 0.2 % of them: the rotated warp's boundary
  ties, ``pipeline.cc``).
"""

import random

import numpy as np
import pytest

from hoisdf_torch.config import get_config
from hoisdf_torch.data import ho3d as P
from hoisdf_torch.data.dexycb import DexYCBDataset
from hoisdf_torch.mano.model import make_synthetic_mano
from hoisdf_tpu.config import get_config as jax_get_config
from hoisdf_tpu.data import ho3d as J
from hoisdf_tpu.data.dexycb import DexYCBDataset as JaxDexYCBDataset
from hoisdf_tpu.mano.model import make_synthetic_mano as jax_make_synthetic_mano

from torch_data_fixtures import assert_samples_equal, write_dexycb, write_ho3d
from torch_port_util import one_torch_thread  # noqa: F401

DEX_SMALL = dict(num_samp_hand=64, num_samp_obj=32, points_filter_dist=1.0,
                 input_img_shape=(64, 64), output_hm_shape=(32, 32, 32))
HO3D_SMALL = dict(num_samp_hand=48, num_samp_obj=24, points_filter_dist=1.0,
                  input_img_shape=(64, 64), output_hm_shape=(32, 32, 32), use_big_decoder=False)
HO3D_CASES = [("ho3d", "train", 2), ("ho3d_render", "train", 4), ("ho3d", "evaluation", 2)]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def dex_trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("dexycb")
    return {cut: write_dexycb(str(base / ("cut" if cut else "full")), cut=cut)
            for cut in (False, True)}


@pytest.fixture(scope="module")
def ho3d_tree(tmp_path_factory):
    return write_ho3d(str(tmp_path_factory.mktemp("ho3d")))


def _dex(tree, mode, native):
    return DexYCBDataset(get_config("dexycb", native_pipeline=native, **tree, **DEX_SMALL),
                         mode, make_synthetic_mano(0), seed=3)


def _ho3d(tree, setting, mode, native):
    over = dict(tree, **HO3D_SMALL, add_render=setting == "ho3d_render")
    return P.HO3DDataset(get_config(setting, native_pipeline=native, **over), mode,
                         make_synthetic_mano(0), seed=2)


def _pairs(a, b, epochs, seed_of):
    for epoch in epochs:
        for idx in range(len(a)):
            random.seed(seed_of(epoch, idx))
            got = a.__getitem__(idx, epoch=epoch)
            random.seed(seed_of(epoch, idx))
            yield f"{epoch}/{idx}", got, b.__getitem__(idx, epoch=epoch)


def _assert_backends_agree(got, want, train: bool, what: str):
    assert set(got) == set(want), what
    for k in want:
        if k == "img" and train:
            d = np.abs(got[k] - want[k]) * 255.0
            assert (d > 5.0).mean() <= 2e-3, (what, k, d.max())
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("layout", ["full", "cut"])
def test_dexycb_native_equals_jax_native(dex_trees, layout, mode):
    tree = dex_trees[layout == "cut"]
    port = _dex(tree, mode, "on")
    jax_ds = JaxDexYCBDataset(
        jax_get_config("dexycb", native_pipeline="on", **tree, **DEX_SMALL), mode,
        jax_make_synthetic_mano(0), seed=3)
    assert port.native and jax_ds.native and len(port) == len(jax_ds) == 3
    for what, got, want in _pairs(port, jax_ds, (0, 1), lambda e, i: 1000 * e + i):
        assert_samples_equal(got, want, f"{layout}/{mode}/{what}")


@pytest.mark.parametrize("layout", ["full", "cut"])
def test_dexycb_native_against_pil(dex_trees, layout):
    tree = dex_trees[layout == "cut"]
    for mode in ("test", "train"):
        native, pil = _dex(tree, mode, "on"), _dex(tree, mode, "off")
        assert native.native and not pil.native
        for what, got, want in _pairs(native, pil, (1,), lambda e, i: 1234):
            _assert_backends_agree(got, want, mode == "train", f"{layout}/{mode}/{what}")


@pytest.mark.parametrize("setting,mode,n", HO3D_CASES)
def test_ho3d_native_equals_jax_native(ho3d_tree, setting, mode, n):
    port = _ho3d(ho3d_tree, setting, mode, "on")
    over = dict(ho3d_tree, **HO3D_SMALL, add_render=setting == "ho3d_render")
    jax_ds = J.HO3DDataset(jax_get_config(setting, native_pipeline="on", **over), mode,
                           jax_make_synthetic_mano(0), seed=2)
    assert port.native and jax_ds.native and len(port) == len(jax_ds) == n
    for what, got, want in _pairs(port, jax_ds, (0, 3), lambda e, i: 10 * e + i):
        assert_samples_equal(got, want, f"{setting}/{mode}/{what}")


@pytest.mark.parametrize("setting,mode,n", HO3D_CASES)
def test_ho3d_native_against_pil(ho3d_tree, setting, mode, n):
    native = _ho3d(ho3d_tree, setting, mode, "on")
    pil = _ho3d(ho3d_tree, setting, mode, "off")
    for what, got, want in _pairs(native, pil, (1,), lambda e, i: 99):
        _assert_backends_agree(got, want, mode == "train", f"{setting}/{mode}/{what}")
