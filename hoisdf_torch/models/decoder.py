"""U-Net feature-pyramid decoder with heatmap/segmentation heads
(``hoisdf_tpu/models/decoder.py::Decoder``, the compressed variant).

Pyramid dims 512/256/128/64/32 (total 992), NCHW.  The deconvs are
``ConvTranspose2d(k=4, s=2, p=1)``, the torch form of the JAX package's
``ConvTranspose(4, 2, "SAME", transpose_kernel=True)``; concat order is
[compressed skip, upsampled].  Heads: joint heatmap (raw), hand seg and obj
seg (sigmoid), [B, 3, H, W].
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from hoisdf_torch.models.layers import BatchNorm2d, Conv2d, ConvTranspose2d


def conv_bn_relu(cin: int, cout: int, kernel: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, cout, kernel, 1, kernel // 2, bias=True),
        BatchNorm2d(cout), nn.ReLU(),
    )


def deconv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(
        ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
        BatchNorm2d(cout), nn.ReLU(),
    )


def _head(cin: int, hidden: int) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(cin, hidden, 1, 1, 0, bias=True), BatchNorm2d(hidden),
        nn.ReLU(), Conv2d(hidden, 1, 1, 1, 0, bias=True),
    )


class Decoder(nn.Module):
    # (skip name, skip-compress dim, deconv dim, fuse dim)
    SPEC = (("stride16", 256, 256, 256), ("stride8", 128, 128, 128),
            ("stride4", 64, 64, 64), ("stride2", 32, 64, 32))

    def __init__(self, skip_channels: Dict[str, int]):
        super().__init__()
        x_ch = skip_channels["stride32"]
        self.conv0d = conv_bn_relu(x_ch, 512, 1)
        for i, (name, skip_dim, deconv_dim, fuse_dim) in enumerate(self.SPEC, start=1):
            setattr(self, f"conv{i}d", conv_bn_relu(skip_channels[name], skip_dim, 1))
            setattr(self, f"deconv{i}", deconv_bn_relu(x_ch, deconv_dim))
            setattr(self, f"conv{i}", conv_bn_relu(skip_dim + deconv_dim, fuse_dim, 3))
            x_ch = fuse_dim
        self.convOut_hm = _head(x_ch, 32)
        self.convOut_hand_seg = _head(x_ch, 32)
        self.convOut_obj_seg = _head(x_ch, 32)

    def forward(self, img_feat: torch.Tensor, skips: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        pyr = {"stride32": self.conv0d(img_feat)}
        x = img_feat
        for i, (name, *_dims) in enumerate(self.SPEC, start=1):
            skip = getattr(self, f"conv{i}d")(skips[name])
            up = getattr(self, f"deconv{i}")(x)
            x = getattr(self, f"conv{i}")(torch.cat([skip, up], dim=1))
            pyr[name] = x
        heads = torch.cat([
            self.convOut_hm(x),
            torch.sigmoid(self.convOut_hand_seg(x)),
            torch.sigmoid(self.convOut_obj_seg(x)),
        ], dim=1)
        return pyr, heads
