"""Stock layers that keep their parameters in f32 and cast them at use.

Under ``compute_dtype="bfloat16"`` activations are bf16 while every weight
stays f32 (the JAX package's flax ``dtype=`` semantics): these subclasses cast
the weight and bias to the input's type inside ``forward``.  BatchNorm needs
no subclass: ``F.batch_norm`` takes bf16 input with f32 statistics directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, x):
    return None if p is None else p.to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x),
                                  self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm with flax's default epsilon (1e-6), as the JAX package uses."""

    def __init__(self, d: int):
        super().__init__(d, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)
