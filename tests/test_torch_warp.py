"""The port's affine warp (``hoisdf_torch.ops.warp``) against PIL and against
``hoisdf_tpu.ops.warp.affine_warp_image``: the counterparts of
``tests/test_warp.py`` and more.

Bars: nearest is bit-identical to PIL (on the JAX test's crop) and to the JAX
function (on seeded rotations, scales and shifts, f32 and u8 images);
bilinear is within 1e-5 of the JAX function in f32 (both interpolate in f32;
their inverses round differently).  On the card, nearest is bit-identical to
the CPU (the coordinates are elementwise f32 ops on both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hoisdf_torch.data import transforms as T
from hoisdf_torch.ops.warp import affine_warp_image
from hoisdf_tpu.ops.warp import affine_warp_image as jax_affine_warp_image

from torch_port_util import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    yield


def _crops(seed, n, src_hw=(60, 80), res=40):
    """``n`` train-style crops (centre, scale and a spin drawn) of random images."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, *src_hw, 3), dtype=np.uint8)
    affs = np.stack([T.get_affine_transform(rng.uniform(10, 60, 2), rng.uniform(20, 90),
                                            [res, res], rot=rng.uniform(-3, 3))[0]
                     for _ in range(n)]).astype(np.float32)
    return imgs, affs


def _jax(img, aff, hw, mode):
    return np.asarray(jax_affine_warp_image(jnp.asarray(img), jnp.asarray(aff), hw, mode=mode))


def test_affine_warp_matches_pil_nearest():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (48, 48, 3), dtype=np.uint8)
    trans, _ = T.get_affine_transform(np.array([20.0, 26.0]), 30.0, [32, 32], rot=0.2)
    want = np.asarray(T.transform_img(Image.fromarray(img), trans, [32, 32]))
    aff = torch.from_numpy(trans[None].astype(np.float32))
    got = affine_warp_image(torch.from_numpy(img[None].astype(np.float32)), aff, (32, 32))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint8), want)
    got_u8 = affine_warp_image(torch.from_numpy(img[None]), aff, (32, 32))
    assert got_u8.dtype == torch.uint8
    np.testing.assert_array_equal(got_u8[0].numpy(), want)


def test_affine_warp_bilinear_smooth():
    rng = np.random.RandomState(1)
    img = torch.from_numpy(rng.rand(1, 16, 16, 1).astype(np.float32))
    ident = torch.from_numpy(np.eye(3, dtype=np.float32)[None])
    out = affine_warp_image(img, ident, (16, 16), mode="bilinear")
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nearest_bitwise_equal_jax(seed):
    imgs, affs = _crops(seed, 8)
    got = affine_warp_image(torch.from_numpy(imgs), torch.from_numpy(affs), (40, 40))
    want = _jax(imgs.astype(np.float32), affs, (40, 40), "nearest")
    np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))
    got_f = affine_warp_image(torch.from_numpy(imgs.astype(np.float32)),
                              torch.from_numpy(affs), (40, 40))
    np.testing.assert_array_equal(got_f.numpy(), want)


def test_nearest_eval_crops_bitwise_equal_pil():
    """The datasets' eval crops (a scale and a shift, no spin) at 640 x 480:
    the same pixels as PIL's NEAREST transform, zeros outside the image."""
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
    for center, scale in (((320.0, 240.0), 300.0), ((40.0, 30.0), 200.0), ((600.0, 460.0), 90.0)):
        trans, _ = T.get_affine_transform(np.array(center), scale, [64, 64])
        want = np.asarray(T.transform_img(Image.fromarray(img), trans, [64, 64]))
        got = affine_warp_image(torch.from_numpy(img[None]),
                                torch.from_numpy(trans[None].astype(np.float32)), (64, 64))
        np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_bilinear_within_1e5_of_jax(seed):
    imgs, affs = _crops(seed, 4)
    x = imgs.astype(np.float32) / 255.0
    got = affine_warp_image(torch.from_numpy(x), torch.from_numpy(affs), (40, 40),
                            mode="bilinear")
    want = _jax(x, affs, (40, 40), "bilinear")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    got_u8 = affine_warp_image(torch.from_numpy(imgs), torch.from_numpy(affs), (40, 40),
                               mode="bilinear")
    assert got_u8.dtype == torch.float32
    np.testing.assert_allclose(got_u8.numpy() / 255.0, want, rtol=0, atol=1e-5)


def test_rejects_a_bad_mode_or_shape():
    img = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError, match="mode"):
        affine_warp_image(img, torch.eye(3).expand(2, 3, 3), (4, 4), mode="cubic")
    with pytest.raises(ValueError, match="affine"):
        affine_warp_image(img, torch.eye(3)[None], (4, 4))


@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs an NVIDIA card")
def test_card_matches_cpu():
    imgs, affs = _crops(5, 4, src_hw=(480, 640), res=256)
    img, aff = torch.from_numpy(imgs), torch.from_numpy(affs)
    cpu = affine_warp_image(img, aff, (256, 256))
    card = affine_warp_image(img.cuda(), aff.cuda(), (256, 256)).cpu()
    assert torch.equal(card, cpu)
    cpu_b = affine_warp_image(img, aff, (256, 256), mode="bilinear")
    card_b = affine_warp_image(img.cuda(), aff.cuda(), (256, 256), mode="bilinear").cpu()
    assert (card_b - cpu_b).abs().max() <= 1e-3
