"""The image seams of the data pipeline on the PIL path (the PIL half of
``hoisdf_tpu/data/image_io.py``): open, flip, the final affine crop with blur
and jitter, the seg-mask warp, and the normalisation to f32.

The JAX package can also route these through its native C++ pipeline
(``native_pipeline``); the port has no native library yet, so every sample
takes the PIL path, which the JAX package holds as its source of truth.  The
callers draw the blur radius and the jitter factors before calling
:func:`finalize_image`, in the JAX package's order, so their random streams
match it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter

from hoisdf_torch.data import transforms as T


class SegMask:
    """A u8 seg mask with its x-flip deferred to :func:`warp_seg`."""

    __slots__ = ("arr", "flip")

    def __init__(self, arr: np.ndarray, flip: bool = False):
        self.arr = np.ascontiguousarray(arr, np.uint8)
        self.flip = flip


def open_image(path: str) -> Image.Image:
    """An RGB image from disk."""
    with Image.open(path) as img:
        return img.convert("RGB")


def flip_image(img: Image.Image) -> Image.Image:
    """Mirror the x axis (the original's numpy ``[:, ::-1]`` flip)."""
    return Image.fromarray(np.asarray(img, np.uint8)[:, ::-1, :])


def finalize_image(img: Image.Image, affinetrans: np.ndarray, res: int,
                   blur_radius: float = 0.0,
                   jitter_ops: Sequence[Tuple[str, float]] = ()) -> Image.Image:
    """The affine crop to ``res`` x ``res``, then the Gaussian blur and the
    jitter ops when given."""
    img = T.transform_img(img, affinetrans, [res, res]).crop((0, 0, res, res))
    if blur_radius > 0.0:
        img = img.filter(ImageFilter.GaussianBlur(blur_radius))
    if jitter_ops:
        img = T.apply_jitter_pil(img, jitter_ops)
    return img


def warp_seg(seg: SegMask, affinetrans: np.ndarray, inp_res: int, heat_res: int
             ) -> np.ndarray:
    """Warp a mask by the crop and resize it (nearest) to the heatmap size."""
    img = Image.fromarray(seg.arr[:, ::-1] if seg.flip else seg.arr)
    img = T.transform_img(img, affinetrans, [inp_res, inp_res]).crop((0, 0, inp_res, inp_res))
    return np.asarray(img.resize((heat_res, heat_res), Image.NEAREST))


def to_float_image(img: Image.Image) -> np.ndarray:
    """[H, W, 3] f32 in [0, 1]."""
    return np.asarray(img, np.float32) / 255.0
