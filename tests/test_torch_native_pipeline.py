"""The port's native image pipeline (``hoisdf_torch.native``) against PIL and
against the JAX package's library (``hoisdf_tpu.native``).

Each case is the counterpart of one in ``tests/test_native_pipeline.py``,
parametrised alike, with the JAX package's bars against PIL:
  * decode, warp, resize, normalise and the fused eval path: bit-identical;
  * enhance and hue: bit-identical (PIL's integer semantics);
  * blur: within 1 LSB at the radii the datasets draw (<= 0.5), 4 above;
and bit-identical to ``hoisdf_tpu.native`` on the same seeded inputs, since
the port's source is the same arithmetic built by the same g++.

Then the build: it writes under ``hoisdf_torch/_build/`` only, rebuilds when
its source changes, survives two processes building at once, and its
codec-free variant (where g++ finds no jpeg/png headers) decodes with PIL
into the same fused call, with the same bits.
"""

import io
import json
import os
import pathlib
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter

import hoisdf_torch.data.transforms as T
import hoisdf_torch.native as N
import hoisdf_tpu.data.transforms as JT
import hoisdf_tpu.native as JN
from hoisdf_torch.data import image_io as IIO
from hoisdf_torch.native import build as B

from torch_port_util import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread(one_torch_thread):
    yield


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="module")
def rgb(rng):
    return rng.randint(0, 256, (120, 160, 3), np.uint8)


def _jpeg_bytes(arr, quality=90):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _png_bytes(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _eq(a, b):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype


def test_jpeg_decode_bit_exact(rgb):
    data = _jpeg_bytes(rgb)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    mine = N.decode_image(data, "jpeg")
    _eq(pil, mine)
    _eq(JN.decode_image(data, "jpeg"), mine)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_png_decode_bit_exact(rgb, mode):
    data = _png_bytes(Image.fromarray(rgb).convert(mode))
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    mine = N.decode_image(data, "png")
    _eq(pil, mine)
    _eq(JN.decode_image(data, "png"), mine)


def test_decode_corrupt_returns_none():
    assert N.decode_image(b"not an image", "jpeg") is None
    assert N.decode_image(b"not an image", "png") is None
    assert N.image_dims(b"not an image", "jpeg") is None


def test_warp_general_affine_bit_exact(rng, rgb):
    im = Image.fromarray(rgb)
    for _ in range(6):
        aff = np.eye(3)
        aff[:2, :2] = np.eye(2) * rng.uniform(0.3, 1.5) + rng.randn(2, 2) * 0.05
        aff[:2, 2] = rng.uniform(-40, 40, 2)
        mine = N.warp_affine_nearest(rgb, aff, 96)
        _eq(np.asarray(T.transform_img(im, aff, [96, 96])), mine)
        _eq(JN.warp_affine_nearest(rgb, aff, 96), mine)


def test_warp_scale_path_bit_exact(rng, rgb):
    # rot=0 crops take Pillow's ImagingScaleAffine path (double incremental
    # accumulation), not the general fixed-point one: this pins the former
    im = Image.fromarray(rgb)
    for _ in range(6):
        aff = np.eye(3)
        aff[0, 0] = aff[1, 1] = rng.uniform(0.2, 2.0)
        aff[:2, 2] = rng.uniform(-60, 40, 2)
        mine = N.warp_affine_nearest(rgb, aff, 96)
        _eq(np.asarray(T.transform_img(im, aff, [96, 96])), mine)
        _eq(JN.warp_affine_nearest(rgb, aff, 96), mine)


def test_warp_flip_matches_pil_on_flipped_array(rgb):
    aff = np.eye(3)
    aff[0, 0] = aff[1, 1] = 0.8
    aff[:2, 2] = [-10.0, -5.0]
    pil = np.asarray(T.transform_img(Image.fromarray(rgb[:, ::-1]), aff, [96, 96]))
    mine = N.warp_affine_nearest(rgb, aff, 96, flip=True)
    _eq(pil, mine)
    _eq(JN.warp_affine_nearest(rgb, aff, 96, flip=True), mine)


def test_seg_fused_path_bit_exact(rng):
    seg = (rng.rand(120, 160) > 0.8).astype(np.uint8)
    aff = np.eye(3)
    aff[0, 0] = aff[1, 1] = 0.7
    aff[:2, 2] = [-15.0, -9.0]
    for flip in (False, True):
        src = seg[:, ::-1] if flip else seg
        pil = (T.transform_img(Image.fromarray(src), aff, [96, 96]).crop((0, 0, 96, 96))
               .resize((24, 24), Image.NEAREST))
        mine = N.warp_seg(seg, aff, 96, 24, flip=flip)
        _eq(np.asarray(pil), mine)
        _eq(JN.warp_seg(seg, aff, 96, 24, flip=flip), mine)
        # and the dataset seam on both backends
        mask = IIO.SegMask(seg, flip=flip)
        _eq(IIO.warp_seg(mask, aff, 96, 24, native=True), mine)
        _eq(IIO.warp_seg(mask, aff, 96, 24, native=False), mine)


@pytest.mark.parametrize("shape,res", [((100, 100), 37), ((96, 96), 24)])
def test_resize_nearest_bit_exact(rng, shape, res):
    src = rng.randint(0, 256, shape, np.uint8)
    mine = N.resize_nearest(src, res)
    _eq(np.asarray(Image.fromarray(src).resize((res, res), Image.NEAREST)), mine)
    _eq(JN.resize_nearest(src, res), mine)


@pytest.mark.parametrize("op,enh", [(N.OP_BRIGHTNESS, ImageEnhance.Brightness),
                                    (N.OP_SATURATION, ImageEnhance.Color),
                                    (N.OP_CONTRAST, ImageEnhance.Contrast)])
@pytest.mark.parametrize("factor", [0.62, 1.0, 1.37])
def test_enhance_bit_exact(rgb, op, enh, factor):
    mine = N.enhance(rgb.copy(), op, factor)
    _eq(np.asarray(enh(Image.fromarray(rgb)).enhance(factor)), mine)
    _eq(JN.enhance(rgb.copy(), op, factor), mine)


@pytest.mark.parametrize("hue_factor", [0.17, -0.12, 0.5])
def test_hue_shift_bit_exact(rgb, hue_factor):
    mine = N.hue_shift(rgb.copy(), int(hue_factor * 255))
    _eq(np.asarray(T._adjust_hue(Image.fromarray(rgb), hue_factor)), mine)
    _eq(JN.hue_shift(rgb.copy(), int(hue_factor * 255)), mine)


@pytest.mark.parametrize("radius", [0.12, 0.2, 0.33, 0.45, 0.499])
def test_gaussian_blur_production_radii_within_1(rgb, radius):
    pil = np.asarray(Image.fromarray(rgb).filter(ImageFilter.GaussianBlur(radius))).astype(int)
    mine = N.gaussian_blur(rgb.copy(), radius)
    assert np.abs(pil - mine.astype(int)).max() <= 1
    _eq(JN.gaussian_blur(rgb.copy(), radius), mine)


@pytest.mark.parametrize("radius", [1.0, 2.0])
def test_gaussian_blur_large_radii_within_4(rgb, radius):
    pil = np.asarray(Image.fromarray(rgb).filter(ImageFilter.GaussianBlur(radius))).astype(int)
    mine = N.gaussian_blur(rgb.copy(), radius)
    assert np.abs(pil - mine.astype(int)).max() <= 4
    _eq(JN.gaussian_blur(rgb.copy(), radius), mine)


def _eval_affine(scale, tx, ty):
    aff = np.eye(3)
    aff[0, 0] = aff[1, 1] = scale
    aff[:2, 2] = [tx, ty]
    return aff


def test_fused_eval_path_bit_exact(rgb):
    # decode -> warp -> f32/255, no aug: the eval crop of data/dexycb.py::_crop
    data = _jpeg_bytes(rgb)
    aff = _eval_affine(0.55, -30.0, -20.0)
    pil = T.transform_img(Image.open(io.BytesIO(data)).convert("RGB"), aff, [96, 96])
    mine = N.process_image(data, "jpeg", False, aff, 96)
    _eq(np.asarray(pil.crop((0, 0, 96, 96)), np.float32) / 255.0, mine)
    _eq(JN.process_image(data, "jpeg", False, aff, 96), mine)


def test_fused_eval_path_flip_bit_exact(rgb):
    data = _jpeg_bytes(rgb)
    aff = _eval_affine(0.9, 5.0, -12.0)
    src = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.uint8)
    pil = T.transform_img(Image.fromarray(src[:, ::-1]), aff, [96, 96])
    mine = N.process_image(data, "jpeg", True, aff, 96)
    _eq(np.asarray(pil, np.float32) / 255.0, mine)
    _eq(JN.process_image(data, "jpeg", True, aff, 96), mine)
    # the raw route (the decode done outside) gives the same bits
    _eq(N.process_image(src, "raw", True, aff, 96), mine)


def test_fused_train_path_close_and_rng_order_identical(rgb):
    """The whole train chain: the same drawn factors through both backends
    stay within the blur's compounding (<= 5 LSB), and without the blur the
    chain is bit-exact; the port's jitter draw is the JAX package's."""
    data = _jpeg_bytes(rgb)
    aff = _eval_affine(0.55, -30.0, -20.0)
    random.seed(7)
    ops = T.draw_jitter_params(0.3, 0.3, 0.3, 0.15)
    random.seed(7)
    assert JT.draw_jitter_params(0.3, 0.3, 0.3, 0.15) == ops
    assert T.jitter_ops_native(ops) == JT.jitter_ops_native(ops)

    base = T.transform_img(Image.open(io.BytesIO(data)).convert("RGB"), aff, [96, 96])
    base = base.crop((0, 0, 96, 96))
    pil = T.apply_jitter_pil(base.filter(ImageFilter.GaussianBlur(0.3)), ops)
    mine = N.process_image(data, "jpeg", False, aff, 96, blur_radius=0.3,
                           jitter=T.jitter_ops_native(ops))
    assert np.abs(np.asarray(pil, np.float32) / 255.0 - mine).max() * 255.0 <= 5.0
    _eq(JN.process_image(data, "jpeg", False, aff, 96, blur_radius=0.3,
                         jitter=JT.jitter_ops_native(ops)), mine)
    mine2 = N.process_image(data, "jpeg", False, aff, 96, jitter=T.jitter_ops_native(ops))
    _eq(np.asarray(T.apply_jitter_pil(base, ops), np.float32) / 255.0, mine2)


def test_color_jitter_pil_path_unchanged(rgb):
    # color_jitter draws and applies as draw_jitter_params + apply_jitter_pil,
    # and both are the JAX package's
    img = Image.fromarray(rgb)
    out = T.color_jitter(img, brightness=0.3, saturation=0.3, hue=0.15, contrast=0.3,
                         rng=random.Random(11))
    ops = T.draw_jitter_params(0.3, 0.3, 0.15, 0.3, rng=random.Random(11))
    _eq(np.asarray(out), np.asarray(T.apply_jitter_pil(img, ops)))
    want = JT.color_jitter(img, brightness=0.3, saturation=0.3, hue=0.15, contrast=0.3,
                           rng=random.Random(11))
    _eq(np.asarray(want), np.asarray(out))


def test_warp_large_rotation_stray_fraction(rng, rgb):
    """Train spins (uniform +-pi) meet boundary-tie pixels where the fixed-
    point evaluation and PIL pick neighbouring texels; the stray fraction is
    bounded (pipeline.cc's warp comment).  The JAX library picks the same."""
    im = Image.fromarray(rgb)
    total = bad = 0
    for _ in range(8):
        rot = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(rot), np.sin(rot)
        aff = np.eye(3)
        aff[:2, :2] = np.array([[c, -s], [s, c]]) * rng.uniform(0.4, 1.2)
        aff[:2, 2] = rng.uniform(-30, 60, 2)
        mine = N.warp_affine_nearest(rgb, aff, 96)
        bad += int(((np.asarray(T.transform_img(im, aff, [96, 96])) != mine).any(-1)).sum())
        total += 96 * 96
        _eq(JN.warp_affine_nearest(rgb, aff, 96), mine)
    assert bad / total <= 5e-4, bad


# ---- the build ----------------------------------------------------------------

def _tree(base: pathlib.Path) -> dict:
    return {str(p.relative_to(base)): p.stat().st_mtime_ns for p in base.rglob("*")
            if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts}


def test_build_writes_under_build_dir_only():
    pkg = ROOT / "hoisdf_torch"
    before = _tree(pkg)
    report = B.build(force=True)
    assert report["built"] and _tree(pkg) == before
    assert pathlib.Path(report["path"]).parent == pkg / "_build"
    assert not [p for p in os.listdir(pkg / "_build") if ".tmp." in p]
    assert report["decode"] == ("libjpeg" if report["headers"] else "pil")
    assert report["cxx"].startswith(("g++", "c++"))
    assert bool(N.bind(report["path"]).hn_has_codecs()) == report["codecs"]
    assert N.available() and N.build_report()["path"] == report["path"]
    assert N.decode_backend() == report["decode"]


def test_build_rebuilds_when_the_source_changes(tmp_path):
    src = tmp_path / "src" / "pipeline.cc"
    src.parent.mkdir()
    shutil.copy(B.SRC, src)
    out = tmp_path / "build"
    first = B.build(src=str(src), build_dir=str(out))
    assert first["built"]
    assert not B.build(src=str(src), build_dir=str(out))["built"]
    with open(src, "a") as f:
        f.write("\n// an edit\n")
    again = B.build(src=str(src), build_dir=str(out))
    assert again["built"] and again["path"] == first["path"]
    assert sorted(os.listdir(out)) == sorted([".pipeline.lock", B.LIB_NAME, "pipeline.stamp"])
    assert N.bind(again["path"]).hn_has_codecs() in (0, 1)


def test_two_processes_build_at_once(tmp_path):
    code = ("import json, sys; from hoisdf_torch.native.build import build; "
            "print(json.dumps(build(build_dir=sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    reports = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert sorted(r["built"] for r in reports) == [False, True]
    assert reports[0]["path"] == reports[1]["path"]
    lib = N.bind(reports[0]["path"])
    out = np.empty((4, 4), np.uint8)
    lib.hn_resize_nearest(np.arange(64, dtype=np.uint8).reshape(8, 8), 8, 8, 1, out, 4, 4)
    _eq(out, N.resize_nearest(np.arange(64, dtype=np.uint8).reshape(8, 8), 4))


def test_codec_free_build_decodes_with_pil_into_the_same_call(tmp_path, monkeypatch, rgb):
    """Where g++ finds no jpeg/png headers the library is built without its
    decoders: the bindings decode with PIL and enter the same fused call, so
    every result keeps its bits."""
    report = B.build(build_dir=str(tmp_path), codecs=False)
    assert report["decode"] == "pil" and not report["codecs"]
    data = _jpeg_bytes(rgb)
    png = _png_bytes(Image.fromarray(rgb).convert("L"))
    aff = _eval_affine(0.9, 5.0, -12.0)
    want = {"fused": N.process_image(data, "jpeg", True, aff, 96, blur_radius=0.3,
                                     jitter=[(N.OP_HUE, 20), (N.OP_CONTRAST, 1.2)]),
            "dims": N.image_dims(data, "jpeg"), "png": N.decode_image(png, "png")}
    monkeypatch.setattr(N, "_lib", N.bind(report["path"]))
    monkeypatch.setattr(N, "_report", report)
    monkeypatch.setattr(N, "_tried", True)
    assert N.decode_backend() == "pil"
    _eq(N.process_image(data, "jpeg", True, aff, 96, blur_radius=0.3,
                        jitter=[(N.OP_HUE, 20), (N.OP_CONTRAST, 1.2)]), want["fused"])
    assert N.image_dims(data, "jpeg") == want["dims"] == (120, 160)
    _eq(N.decode_image(png, "png"), want["png"])
    assert N.process_image(b"not an image", "jpeg", False, aff, 96) is None
    assert N.decode_image(b"not an image", "png") is None
