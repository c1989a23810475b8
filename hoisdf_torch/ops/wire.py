"""Lossless uint8 wire codec for host->device image transfer
(``hoisdf_tpu/ops/wire.py``, input side).

Every image value is a uint8 byte divided by 255 on the host.  Shipping the
byte and rebuilding the f32 value on the card through a 256-entry table
computed on the host with numpy's own ``v/255`` rounding reproduces the host
normalize bit for bit (a device-side divide may be 1 ulp off), at a quarter of
the transfer bytes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def u8_lut_np() -> np.ndarray:
    """The 256-entry f32 normalize table, rounded on the host."""
    return np.arange(256, dtype=np.float32) / 255.0


def quantize_image_u8(img) -> np.ndarray:
    """f32 [0,1] image -> u8 wire bytes.  u8 passes through; floats are
    re-quantized with rint, lossless iff they came from u8 / 255."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def decode_inputs(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device side: a u8 image batch -> the exact host f32 values, through
    the table.  f32 inputs pass through, so one step serves both wires."""
    img = inputs.get("img")
    if img is None or img.dtype != torch.uint8:
        return inputs
    lut = torch.from_numpy(u8_lut_np()).to(img.device)
    return dict(inputs, img=lut[img.long()])
