"""The image seams of the data pipeline (``hoisdf_tpu/data/image_io.py``):
open, flip, the final affine crop with blur and jitter, the seg-mask warp and
the normalisation to f32.  Each seam takes one of two backends:

  * the native C++ pipeline (``hoisdf_torch/native``): one GIL-free call per
    sample for decode -> flip -> affine crop -> blur -> jitter -> f32, and
    one per seg mask, so that loader threads scale past the GIL;
  * the PIL path, the source of truth for parity.

Geometry is bit-identical between the two; train-time photometrics differ
by at most a few LSB through the blur.  The dataset picks the backend once,
from ``Config.native_pipeline`` (:func:`resolve_native`).  The one swap at
run time is the JAX package's: a stream that the native decoder refuses is
decoded by PIL, which then raises the error the PIL path would.

The callers draw the blur radius and the jitter factors before calling
:func:`finalize_image`, in the JAX package's order, so both backends consume
the same random streams and every non-image target is the same bits
whichever backend runs.
"""

from __future__ import annotations

import io
import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter

from hoisdf_torch import native as N
from hoisdf_torch.data import transforms as T


def resolve_native(mode: str) -> bool:
    """Map ``Config.native_pipeline`` ("auto" | "on" | "off") to a backend:
    "auto" is native where the library builds, "on" raises where it does
    not, "off" is PIL."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"native_pipeline {mode!r}")
    if mode == "off":
        return False
    ok = N.available()
    if mode == "on" and not ok:
        raise RuntimeError("native_pipeline='on' but the native image pipeline did not build "
                           f"(hoisdf_torch/native/build.py): {N.build_error()}")
    return ok


class LazyImage:
    """An undecoded image for the native path: its encoded bytes and header
    size, with the x-flip deferred into the fused warp.  Carries the part of
    the PIL API that the datasets touch (``.size``)."""

    __slots__ = ("data", "kind", "size", "flip")

    def __init__(self, data: bytes, kind: str, size: Tuple[int, int]):
        self.data = data
        self.kind = kind
        self.size = size  # (W, H), PIL's convention
        self.flip = False

    def to_pil(self) -> Image.Image:
        img = Image.open(io.BytesIO(self.data)).convert("RGB")
        if self.flip:
            img = Image.fromarray(np.asarray(img, np.uint8)[:, ::-1, :])
        return img


class SegMask:
    """A u8 seg mask with its x-flip deferred to :func:`warp_seg`."""

    __slots__ = ("arr", "flip")

    def __init__(self, arr: np.ndarray, flip: bool = False):
        self.arr = np.ascontiguousarray(arr, np.uint8)
        self.flip = flip


_KIND_BY_EXT = {".jpg": "jpeg", ".jpeg": "jpeg", ".png": "png"}


def open_image(path: str, native: bool = False):
    """An RGB image from disk: a :class:`LazyImage` on the native path, a PIL
    image otherwise (and for a format or header the native path cannot
    read)."""
    kind = _KIND_BY_EXT.get(os.path.splitext(path)[1].lower())
    if native and kind is not None:
        with open(path, "rb") as f:
            data = f.read()
        dims = N.image_dims(data, kind)
        if dims is not None:
            return LazyImage(data, kind, (dims[1], dims[0]))
    with Image.open(path) as img:
        return img.convert("RGB")


def flip_image(img):
    """Mirror the x axis (the original's numpy ``[:, ::-1]`` flip): deferred
    for a :class:`LazyImage`, done for a PIL image."""
    if isinstance(img, LazyImage):
        img.flip = not img.flip
        return img
    return Image.fromarray(np.asarray(img, np.uint8)[:, ::-1, :])


def finalize_image(img, affinetrans: np.ndarray, res: int, blur_radius: float = 0.0,
                   jitter_ops: Sequence[Tuple[str, float]] = ()):
    """The affine crop to ``res`` x ``res``, then the Gaussian blur and the
    jitter ops when given: a normalised f32 [res, res, 3] array on the native
    path, the augmented PIL image on the PIL path (the assembler
    normalises it)."""
    if isinstance(img, LazyImage):
        out = N.process_image(img.data, img.kind, img.flip, affinetrans, res,
                              blur_radius=blur_radius,
                              jitter=T.jitter_ops_native(jitter_ops))
        if out is not None:
            return out
        img = img.to_pil()  # a stream the native decoder refused
    img = T.transform_img(img, affinetrans, [res, res]).crop((0, 0, res, res))
    if blur_radius > 0.0:
        img = img.filter(ImageFilter.GaussianBlur(blur_radius))
    if jitter_ops:
        img = T.apply_jitter_pil(img, jitter_ops)
    return img


def warp_seg(seg: SegMask, affinetrans: np.ndarray, inp_res: int, heat_res: int,
             native: bool = False) -> np.ndarray:
    """Warp a mask by the crop and resize it (nearest) to the heatmap size:
    one fused call on the native path, PIL's transform and resize otherwise;
    the same bits."""
    if native:
        out = N.warp_seg(seg.arr, affinetrans, inp_res, heat_res, flip=seg.flip)
        if out is not None:  # None only where the C call could not allocate
            return out
    img = Image.fromarray(seg.arr[:, ::-1] if seg.flip else seg.arr)
    img = T.transform_img(img, affinetrans, [inp_res, inp_res]).crop((0, 0, inp_res, inp_res))
    return np.asarray(img.resize((heat_res, heat_res), Image.NEAREST))


def to_float_image(img) -> np.ndarray:
    """[H, W, 3] f32 in [0, 1]; the native path's output already is."""
    if isinstance(img, np.ndarray) and img.dtype == np.float32:
        return img
    return np.asarray(img, np.float32) / 255.0
