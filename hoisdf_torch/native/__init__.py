"""ctypes bindings for the port's native (C++) image pipeline.

``src/pipeline.cc`` fuses a sample's image path, decode -> flip -> affine
crop -> blur -> jitter -> f32/255, into one C call (plus one per seg mask),
so that a loader thread holds the GIL only for the glue around it: ctypes
releases the GIL around every foreign call.  The API and its names are the
JAX package's (``hoisdf_tpu/native``), and so is the arithmetic: geometry and
decode bit-identical to PIL, enhance and hue exact, blur within 1 LSB at the
datasets' radii (``tests/test_torch_native_pipeline.py``).

The library builds at first use (:mod:`hoisdf_torch.native.build`).  Where
g++ finds no libjpeg / libpng headers it is built without its decoders
(:func:`decode_backend` is ``"pil"``): the functions here then decode with
PIL, whose decoder also releases the GIL, and hand the RGB array to the same
fused call.  :func:`available` is the one capability gate; the datasets take
the native path only through ``Config.native_pipeline``
(``hoisdf_torch/data/image_io.py::resolve_native``).
"""

from __future__ import annotations

import ctypes
import io
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

import hoisdf_torch.native.build as _build

# jitter op codes shared with pipeline.cc
OP_BRIGHTNESS, OP_SATURATION, OP_CONTRAST, OP_HUE = 0, 1, 2, 3
_KIND_CODES = {"jpeg": 0, "png": 1, "raw": 2}

_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None
_report: "dict | None" = None
_error: "str | None" = None
_tried = False


def bind(path: str) -> ctypes.CDLL:
    """Load the library at ``path`` and declare every function's types (the
    decoders only where the library has them)."""
    lib = ctypes.CDLL(path)
    i, sz, vp = ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hn_has_codecs.argtypes = []
    lib.hn_has_codecs.restype = i
    if lib.hn_has_codecs():
        for name in ("hn_jpeg_dims", "hn_png_dims"):
            getattr(lib, name).argtypes = [ctypes.c_char_p, sz, ip, ip]
            getattr(lib, name).restype = i
        for name in ("hn_jpeg_decode", "hn_png_decode_rgb"):
            getattr(lib, name).argtypes = [ctypes.c_char_p, sz, _U8P, i, i]
            getattr(lib, name).restype = i
    lib.hn_warp_affine_nearest.argtypes = [_U8P, i, i, i, i, _F64P, _U8P, i, i]
    lib.hn_warp_affine_nearest.restype = None
    lib.hn_resize_nearest.argtypes = [_U8P, i, i, i, _U8P, i, i]
    lib.hn_resize_nearest.restype = None
    lib.hn_enhance.argtypes = [_U8P, i, i, i, ctypes.c_float]
    lib.hn_enhance.restype = None
    lib.hn_hue_shift.argtypes = [_U8P, i, i, i]
    lib.hn_hue_shift.restype = None
    lib.hn_gaussian_blur.argtypes = [_U8P, i, i, i, ctypes.c_double]
    lib.hn_gaussian_blur.restype = None
    lib.hn_u8_to_f32.argtypes = [_U8P, _F32P, ctypes.c_int64, ctypes.c_float]
    lib.hn_u8_to_f32.restype = None
    lib.hn_process_image.argtypes = [
        vp, sz, i, i, i, i, _F64P, i, ctypes.c_double, _I32P, _F64P, i, _F32P]
    lib.hn_process_image.restype = i
    lib.hn_warp_seg.argtypes = [_U8P, i, i, i, _F64P, i, i, _U8P]
    lib.hn_warp_seg.restype = i
    return lib


def _load() -> "ctypes.CDLL | None":
    global _lib, _report, _error, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _report = _build.build()
                _lib = bind(_report["path"])
            except (_build.BuildError, OSError, AttributeError) as exc:
                _error = f"{type(exc).__name__}: {exc}"
        return _lib


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native image pipeline is unavailable: {_error}")
    return lib


def available() -> bool:
    """Whether the library built and loaded in this process."""
    return _load() is not None


def build_report() -> "dict | None":
    """This process's :func:`hoisdf_torch.native.build.build` report, or
    None when the build failed (:func:`build_error` says why)."""
    _load()
    return _report


def build_error() -> "str | None":
    _load()
    return _error


def decode_backend() -> str:
    """``"libjpeg"`` where the library decodes JPEG and PNG itself, ``"pil"``
    where it was built without its decoders."""
    return "libjpeg" if _need().hn_has_codecs() else "pil"


# ---------------------------------------------------------------------------
# numpy-facing API (mirrors the PIL calls it replaces)
# ---------------------------------------------------------------------------

def _inv6(affine3x3: np.ndarray) -> np.ndarray:
    """PIL's transform takes the inverse (output -> source) map, as
    ``transforms.transform_img`` computes it."""
    inv = np.linalg.inv(np.asarray(affine3x3, np.float64))
    return np.ascontiguousarray(inv[:2].reshape(6))


def _channels(img: np.ndarray) -> int:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a u8 [H, W] or [H, W, C] array, got {img.dtype} {img.shape}")
    return 1 if img.ndim == 2 else img.shape[2]


def _rgb(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a u8 [H, W, 3] array, got {img.dtype} {img.shape}")
    if not img.flags.c_contiguous:
        raise ValueError("the in-place ops need a C-contiguous array")
    return img


def _pil_decode(data: bytes) -> Optional[np.ndarray]:
    try:
        with Image.open(io.BytesIO(data)) as img:
            return np.asarray(img.convert("RGB"))
    except OSError:
        return None


def image_dims(data: bytes, kind: str) -> "Optional[Tuple[int, int]]":
    """(H, W) from the encoded header only; None if unparseable."""
    lib = _need()
    if not lib.hn_has_codecs():
        try:
            with Image.open(io.BytesIO(data)) as img:
                return img.height, img.width
        except OSError:
            return None
    h, w = ctypes.c_int(), ctypes.c_int()
    fn = lib.hn_jpeg_dims if kind == "jpeg" else lib.hn_png_dims
    if fn(data, len(data), h, w) != 0:
        return None
    return h.value, w.value


def decode_image(data: bytes, kind: str) -> Optional[np.ndarray]:
    """Decode jpeg/png bytes to RGB u8 [H, W, 3]; None on failure."""
    if kind not in ("jpeg", "png"):
        raise ValueError(f"unknown image kind {kind!r}")
    lib = _need()
    if not lib.hn_has_codecs():
        return _pil_decode(data)
    dims_fn, decode_fn = ((lib.hn_jpeg_dims, lib.hn_jpeg_decode) if kind == "jpeg"
                          else (lib.hn_png_dims, lib.hn_png_decode_rgb))
    h, w = ctypes.c_int(), ctypes.c_int()
    if dims_fn(data, len(data), h, w) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    return out if decode_fn(data, len(data), out, h.value, w.value) == 0 else None


def warp_affine_nearest(img: np.ndarray, affine3x3: np.ndarray, res: int,
                        flip: bool = False) -> np.ndarray:
    """PIL transform(AFFINE, NEAREST)-exact warp of u8 HWC/HW to res x res."""
    lib = _need()
    img = np.ascontiguousarray(img)
    c = _channels(img)
    out = np.empty((res, res) if img.ndim == 2 else (res, res, c), np.uint8)
    lib.hn_warp_affine_nearest(img, img.shape[0], img.shape[1], c, int(flip),
                               _inv6(affine3x3), out, res, res)
    return out


def resize_nearest(img: np.ndarray, res: "int | Tuple[int, int]") -> np.ndarray:
    """PIL resize(NEAREST)-exact; ``res`` is an edge or an (h, w) pair."""
    lib = _need()
    img = np.ascontiguousarray(img)
    c = _channels(img)
    oh, ow = (res, res) if isinstance(res, int) else res
    out = np.empty((oh, ow) if img.ndim == 2 else (oh, ow, c), np.uint8)
    lib.hn_resize_nearest(img, img.shape[0], img.shape[1], c, out, oh, ow)
    return out


def enhance(img: np.ndarray, op: int, factor: float) -> np.ndarray:
    """In-place PIL ImageEnhance.{Brightness,Color,Contrast} on u8 RGB."""
    _need().hn_enhance(_rgb(img), img.shape[0], img.shape[1], op, factor)
    return img


def hue_shift(img: np.ndarray, delta: int) -> np.ndarray:
    """In place: H += delta (mod 256) in PIL's HSV, as the PIL path's hue."""
    _need().hn_hue_shift(_rgb(img), img.shape[0], img.shape[1], int(delta))
    return img


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """In place: PIL's GaussianBlur (three box passes each way)."""
    lib = _need()
    c = _channels(img)
    if not img.flags.c_contiguous:
        raise ValueError("the in-place ops need a C-contiguous array")
    lib.hn_gaussian_blur(img, img.shape[0], img.shape[1], c, float(radius))
    return img


def process_image(data: "bytes | np.ndarray", kind: str, flip: bool, affine3x3: np.ndarray,
                  res: int, blur_radius: float = 0.0,
                  jitter: Sequence[Tuple[int, float]] = ()) -> Optional[np.ndarray]:
    """Fused decode->flip->warp->blur->jitter->f32/255; one GIL-free call.

    ``data``: encoded bytes (kind 'jpeg'/'png') or a decoded u8 RGB array
    (kind 'raw').  Returns f32 [res, res, 3], or None on decode failure.
    Without the library's decoders, PIL decodes the bytes first."""
    lib = _need()
    if kind not in _KIND_CODES:
        raise ValueError(f"unknown image kind {kind!r}")
    if kind != "raw" and not lib.hn_has_codecs():
        data, kind = _pil_decode(data), "raw"
        if data is None:
            return None
    ops = np.asarray([o for o, _ in jitter], np.int32)
    fac = np.asarray([f for _, f in jitter], np.float64)
    out = np.empty((res, res, 3), np.float32)
    if kind == "raw":
        arr = _rgb(np.ascontiguousarray(data))
        rc = lib.hn_process_image(arr.ctypes.data, arr.size, 2, int(flip), arr.shape[0],
                                  arr.shape[1], _inv6(affine3x3), res, float(blur_radius),
                                  ops, fac, len(jitter), out)
    else:
        rc = lib.hn_process_image(data, len(data), _KIND_CODES[kind], int(flip), 0, 0,
                                  _inv6(affine3x3), res, float(blur_radius), ops, fac,
                                  len(jitter), out)
    return out if rc == 0 else None


def warp_seg(seg: np.ndarray, affine3x3: np.ndarray, inp_res: int, heat_res: int,
             flip: bool = False) -> Optional[np.ndarray]:
    """Fused PIL-exact seg path: warp NEAREST to inp_res, then resize
    NEAREST to heat_res (two quantization stages, like the PIL chain)."""
    lib = _need()
    seg = np.ascontiguousarray(seg, np.uint8)
    if seg.ndim != 2:
        raise ValueError(f"expected a [H, W] mask, got {seg.shape}")
    out = np.empty((heat_res, heat_res), np.uint8)
    rc = lib.hn_warp_seg(seg, seg.shape[0], seg.shape[1], int(flip), _inv6(affine3x3),
                         inp_res, heat_res, out)
    return out if rc == 0 else None
