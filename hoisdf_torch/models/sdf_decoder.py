"""DeepSDF-style signed-distance decoder (``hoisdf_tpu/models/sdf_decoder.py``).

Dims [in, 512, 512 - in, 512, 512, 1] with weight normalization on layers
0-3 (written out by hand so the keys stay ``weight_g`` [out, 1] /
``weight_v`` / ``bias``), the latent skip re-concat of the full input before
layer 2, ReLU and (train mode) dropout 0.2 after hidden layers 0-3, and a
final tanh.  With ``use_classifier`` a ``classifier_head`` gives part-class
logits from the last hidden layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hoisdf_torch.models.layers import Dropout, Linear


class WeightNormLinear(nn.Module):
    """Linear layer with torch-style weight norm over the input dim."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def folded_weight(self) -> torch.Tensor:
        """``g * v / max(||v||, 1e-12)``, [out, in] f32."""
        norm = torch.linalg.vector_norm(self.weight_v, dim=1, keepdim=True)
        return (self.weight_g / torch.clamp(norm, min=1e-12)) * self.weight_v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.folded_weight().to(x.dtype), self.bias.to(x.dtype))


class SDFDecoder(nn.Module):
    def __init__(self, latent_size: int = 256, point_feat_size: int = 33,
                 dims=(512, 512, 512, 512), use_classifier: bool = False,
                 num_class: int = 6):
        super().__init__()
        in_dim = latent_size + point_feat_size
        self.in_dim = in_dim
        self.linh0 = WeightNormLinear(in_dim, dims[0])
        self.linh1 = WeightNormLinear(dims[0], dims[1] - in_dim)
        self.linh2 = WeightNormLinear(dims[1], dims[2])
        self.linh3 = WeightNormLinear(dims[2], dims[3])
        self.linh4 = Linear(dims[3], 1)
        self.classifier_head = Linear(dims[3], num_class) if use_classifier else None
        self.dropout = Dropout(0.2)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [N, in] -> (sdf [N, 1] (tanh), class logits [N, num_class] or
        None), in x's type.  Dropout (train mode) draws from ``generator``."""
        h = self.dropout(torch.relu(self.linh0(x)), generator)
        h = self.dropout(torch.relu(self.linh1(h)), generator)
        h = self.dropout(torch.relu(self.linh2(torch.cat([h, x], dim=-1))), generator)
        h = self.dropout(torch.relu(self.linh3(h)), generator)
        logits = None if self.classifier_head is None else self.classifier_head(h)
        return torch.tanh(self.linh4(h)), logits
