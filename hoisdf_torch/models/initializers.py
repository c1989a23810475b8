"""The original's from-scratch weight initialization
(``hoisdf_tpu/models/initializers.py``; ``main/model.py:668-679`` applied at
``main/model.py:744-750`` in train mode).

It touches the decoder, both SDF decoders and both transformers only: the
backbone (ImageNet weights in the original) and the model's own heads keep
their initialization.  With torch's semantics:

- Conv2d / ConvTranspose2d weights -> normal(0, 0.001); Linear weights ->
  normal(0, 0.01); every bias -> 0.
- The SDF decoders' weight-normed layers: the original's ``normal_`` writes
  the computed weight, which the weight-norm hook overwrites from (g, v) at
  the next forward, so it is a no-op; only their biases are zeroed.
  ``linh4`` and the classifier head are plain Linear layers and are drawn.
- ``MultiheadAttention``'s packed ``in_proj_weight`` / ``in_proj_bias`` are no
  Linear and keep their values; its ``out_proj`` is drawn.
- BatchNorm and LayerNorm scales stay 1 (their biases are zeroed, as they
  already are).
"""

from __future__ import annotations

import torch
from torch import nn

REINIT_SCOPES = ("decoder_net", "hand_sdf_decoder", "obj_sdf_decoder",
                 "hand_transformer", "obj_transformer")


@torch.no_grad()
def apply_reference_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialize ``model``'s :data:`REINIT_SCOPES` in place, drawing from
    ``generator``; returns the model."""
    for scope in REINIT_SCOPES:
        for m in getattr(model, scope).modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, 0.001, generator=generator)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.01, generator=generator)
            # conv, linear, weight-norm and norm biases (attention's packed
            # in_proj_bias is no module's ``bias``)
            bias = getattr(m, "bias", None)
            if isinstance(bias, nn.Parameter):
                bias.zero_()
    return model
