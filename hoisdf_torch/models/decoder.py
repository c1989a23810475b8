"""U-Net feature-pyramid decoders with heatmap/segmentation heads
(``hoisdf_tpu/models/decoder.py``): ``Decoder``, the compressed variant
(pyramid dims 512/256/128/64/32, total 992), and ``DecoderBig``, the ho3d
preset's full-width one (2048/1024/512/256/128 at ResNet-50, total 3968).

NCHW, and channels_last where the input is.  The deconvs are
``ConvTranspose2d(k=4, s=2, p=1)``, the torch form of the JAX package's
``ConvTranspose(4, 2, "SAME", transpose_kernel=True)``; concat order is
[skip, upsampled].  Heads: joint heatmap (raw), hand seg and obj seg
(sigmoid), [B, 3, H, W].
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


def _head(cin: int, hidden: Tuple[int, ...]) -> nn.Sequential:
    """1x1 conv-BN-ReLU per ``hidden`` width, then a 1x1 conv to one channel
    (torch indices 0, 1, 3, 4, ... and 3 * len(hidden) for the last conv)."""
    layers = []
    for d in hidden:
        layers += [Conv2d(cin, d, 1, 1, 0, bias=True), BatchNorm2d(d), nn.ReLU()]
        cin = d
    return nn.Sequential(*layers, Conv2d(cin, 1, 1, 1, 0, bias=True))


class _Heads(nn.Module):
    """The heatmap, hand-seg and obj-seg heads on the finest map, concatenated;
    a subclass adds them after its pyramid layers."""

    def add_heads(self, cin: int, hidden: Tuple[int, ...]) -> None:
        self.convOut_hm = _head(cin, hidden)
        self.convOut_hand_seg = _head(cin, hidden)
        self.convOut_obj_seg = _head(cin, hidden)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.convOut_hm(x),
            torch.sigmoid(self.convOut_hand_seg(x)),
            torch.sigmoid(self.convOut_obj_seg(x)),
        ], dim=1)


class Decoder(_Heads):
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
        self.add_heads(x_ch, (32,))
        self.out_channels = {"stride32": 512, **{name: fuse for name, _, _, fuse in self.SPEC}}

    def forward(self, img_feat: torch.Tensor, skips: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        pyr = {"stride32": self.conv0d(img_feat)}
        x = img_feat
        for i, (name, *_dims) in enumerate(self.SPEC, start=1):
            skip = getattr(self, f"conv{i}d")(skips[name])
            up = getattr(self, f"deconv{i}")(x)
            x = getattr(self, f"conv{i}")(torch.cat([skip, up], dim=1))
            pyr[name] = x
        return pyr, self.heads(x)


class DecoderBig(_Heads):
    """Full-width decoder (module.py:147-218): the backbone's stride32 map is
    the top level, each finer level fuses the raw skip with the upsampled
    map, and the heads have two hidden convs."""

    SPEC = (("stride16", 1024), ("stride8", 512), ("stride4", 256), ("stride2", 128))

    def __init__(self, skip_channels: Dict[str, int]):
        super().__init__()
        x_ch = skip_channels["stride32"]
        for i, (name, dim) in enumerate(self.SPEC, start=1):
            setattr(self, f"deconv{i}", deconv_bn_relu(x_ch, dim))
            setattr(self, f"conv{i}", conv_bn_relu(skip_channels[name] + dim, dim, 3))
            x_ch = dim
        self.add_heads(x_ch, (128, 64))
        self.out_channels = {"stride32": skip_channels["stride32"], **dict(self.SPEC)}

    def forward(self, img_feat: torch.Tensor, skips: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        pyr = {"stride32": img_feat}
        x = img_feat
        for i, (name, _dim) in enumerate(self.SPEC, start=1):
            up = getattr(self, f"deconv{i}")(x)
            x = getattr(self, f"conv{i}")(torch.cat([skips[name], up], dim=1))
            pyr[name] = x
        return pyr, self.heads(x)
