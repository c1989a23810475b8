"""Lossless uint8 wire codec for host->device transfer
(``hoisdf_tpu/ops/wire.py``).

Every image value is a uint8 byte divided by 255 on the host.  Shipping the
byte and rebuilding the f32 value on the card through a 256-entry table
computed on the host with numpy's own ``v/255`` rounding reproduces the host
normalize bit for bit (a device-side divide may be 1 ulp off), at a quarter of
the transfer bytes.  The train targets' binary seg masks ride as u8 {0, 1}
and are cast back on the card; a mask that is not exactly binary stays f32.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Target keys that are binary masks (f32 {0,1} on the host).
_BINARY_MASK_KEYS = ("hand_seg", "obj_seg")


def u8_lut_np() -> np.ndarray:
    """The 256-entry f32 normalize table, rounded on the host."""
    return np.arange(256, dtype=np.float32) / 255.0


@functools.lru_cache(maxsize=8)
def _lut(device: torch.device) -> torch.Tensor:
    """The table on ``device``, made once per device: a step that built it
    from the host on every call would wait on the card for the copy.  A
    normal tensor even when first asked for under inference mode, so a
    train step may use it too."""
    with torch.inference_mode(False):
        return torch.from_numpy(u8_lut_np()).to(device)


def quantize_image_u8(img) -> np.ndarray:
    """f32 [0,1] image -> u8 wire bytes.  u8 passes through; floats are
    re-quantized with rint, lossless iff they came from u8 / 255."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)


def encode_inputs(inputs: Dict) -> Dict:
    """Host side: the image batch as u8 wire bytes."""
    if "img" not in inputs:
        return inputs
    return dict(inputs, img=quantize_image_u8(inputs["img"]))


def encode_targets(targets: Dict) -> Dict:
    """Host side: binary {0,1} masks -> u8.  A mask that is not exactly
    binary is left in f32 (never silently quantized)."""
    out = dict(targets)
    for k in _BINARY_MASK_KEYS:
        v = out.get(k)
        if v is None:
            continue
        v = np.asarray(v)
        if v.dtype != np.uint8 and ((v == 0.0) | (v == 1.0)).all():
            out[k] = v.astype(np.uint8)
    return out


def encode_batch(inputs: Dict, targets: Optional[Dict] = None
                 ) -> Tuple[Dict, Optional[Dict]]:
    """Host side: an (inputs, targets) pair for the u8 wire."""
    return encode_inputs(inputs), (None if targets is None else encode_targets(targets))


def decode_targets(targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device side: u8 binary masks -> f32."""
    out = dict(targets)
    for k in _BINARY_MASK_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == torch.uint8:
            out[k] = v.float()
    return out


def decode_inputs(inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device side: a u8 image batch -> the exact host f32 values, through
    the table.  f32 inputs pass through, so one step serves both wires."""
    img = inputs.get("img")
    if img is None or img.dtype != torch.uint8:
        return inputs
    return dict(inputs, img=_lut(img.device)[img.long()])
