"""Operand roundings for the controls: the reference computed in the
nearest precision below the one a configuration states (products' inputs
rounded, accumulation in f32).

- ``fp8``: e4m3 with one scale a tensor (its largest magnitude to 448),
  below bf16;
- ``tf32``: f32 with the mantissa rounded to 10 bits (nearest, ties to
  even), what TF32 tensor cores take, below f32 with TF32 off.

A model at bf16 keeps its MANO layer in f32 (the port's geometry runs in
f32 whatever the model's type), so its control rounds the MANO layer's
products to TF32 (:data:`MANO_ROUNDING`).
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q.to(t.dtype) - t).detach()


def tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.detach().float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    q = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return t + (q.to(t.dtype) - t).detach()


ROUNDINGS = {"fp8": fp8, "tf32": tf32}
# the MANO layer is f32 in every configuration
MANO_ROUNDING = tf32
