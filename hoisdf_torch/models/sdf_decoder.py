"""DeepSDF-style signed-distance decoder, eval mode
(``hoisdf_tpu/models/sdf_decoder.py``).

Dims [in, 512, 512 - in, 512, 512, 1] with weight normalization on layers
0-3 (written out by hand so the keys stay ``weight_g`` [out, 1] /
``weight_v`` / ``bias``), the latent skip re-concat of the full input before
layer 2, ReLU between hidden layers and a final tanh.  Dropout is an identity
in eval and is not modelled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hoisdf_torch.models.layers import Linear


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
                 dims=(512, 512, 512, 512)):
        super().__init__()
        in_dim = latent_size + point_feat_size
        self.in_dim = in_dim
        self.linh0 = WeightNormLinear(in_dim, dims[0])
        self.linh1 = WeightNormLinear(dims[0], dims[1] - in_dim)
        self.linh2 = WeightNormLinear(dims[1], dims[2])
        self.linh3 = WeightNormLinear(dims[2], dims[3])
        self.linh4 = Linear(dims[3], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, in] -> sdf [N, 1] (tanh), in x's type."""
        h = torch.relu(self.linh0(x))
        h = torch.relu(self.linh1(h))
        h = torch.relu(self.linh2(torch.cat([h, x], dim=-1)))
        h = torch.relu(self.linh3(h))
        return torch.tanh(self.linh4(h))
