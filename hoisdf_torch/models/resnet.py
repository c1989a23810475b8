"""ResNet backbone with multi-stride skip features (``hoisdf_tpu/models/resnet.py``).

torchvision's BasicBlock / Bottleneck layout and key names (stride on the 3x3
conv), NCHW.  BatchNorm (eps 1e-5) keeps f32 statistics under bf16 compute;
in train mode it updates them by flax's rule (``layers.BatchNorm2d``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from hoisdf_torch.models.layers import BatchNorm2d, Conv2d

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int, downsample):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, downsample):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNetBackbone(nn.Module):
    """Stem + 4 stages; returns the stride-32 feature and every skip level."""

    def __init__(self, resnet_type: int = 50):
        super().__init__()
        kind, layers = RESNET_SPECS[resnet_type]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            stride = 1 if stage == 1 else 2
            seq = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                ds = None
                if i == 0 and (s != 1 or inplanes != planes * block.expansion):
                    ds = nn.Sequential(
                        Conv2d(inplanes, planes * block.expansion, 1, s, 0, bias=False),
                        _bn(planes * block.expansion),
                    )
                seq.append(block(inplanes, planes, s, ds))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*seq))
        # channels of stride2 .. stride32, for the decoder
        self.skip_channels = {"stride2": 64, **{
            f"stride{2 ** (s + 1)}": p * block.expansion
            for s, p in enumerate((64, 128, 256, 512), start=1)}}

    def forward(self, img: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x = torch.relu(self.bn1(self.conv1(img)))
        skips = {"stride2": x}
        x = self.maxpool(x)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            skips[f"stride{2 ** (stage + 1)}"] = x
        return x, skips
