"""Weights made on the device from the seed, in one draw: a frozen copy of
the port's initialisers (``models/hoisdf.py::init_weights``, and for
training ``models/initializers.py::apply_reference_init`` on the decoder,
SDF decoders and transformers).

Every value comes from one ``torch.randn`` over all leaves, on the device,
from a ``torch.Generator`` there, then scaled per leaf: lecun-normal
convolutions and dense layers, N(0, 0.01) weight-norm directions with unit
gains, xavier-normal packed qkv, N(0, 1) MANO queries, zero biases and
identity norms; with ``train_init`` the re-drawn scopes take N(0, 0.001)
convolutions and N(0, 0.01) dense layers.  Leaves keep their model's
names, so one state dict loads into the port and the reference alike.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from benchmark.reference.model import HOISDF
from benchmark.reference.sdf_decoder import WeightNormLinear
from benchmark.reference.transformer import MultiheadAttention

REINIT_SCOPES = ("decoder_net", "hand_sdf_decoder", "obj_sdf_decoder",
                 "hand_transformer", "obj_transformer")


def _plan(model: nn.Module, train_init: bool) -> Dict[str, object]:
    """Leaf name -> std of its normal draw, or a constant fill value."""
    plan: Dict[str, object] = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        redrawn = train_init and mname.split(".")[0] in REINIT_SCOPES
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            std = 1.0 / math.sqrt(fan_in)
            if redrawn:
                std = 0.01 if isinstance(m, nn.Linear) else 0.001
            plan[pre + "weight"] = ("normal", std)
            if m.bias is not None:
                plan[pre + "bias"] = ("fill", 0.0)
        elif isinstance(m, nn.BatchNorm2d):
            plan.update({pre + "weight": ("fill", 1.0), pre + "bias": ("fill", 0.0),
                         pre + "running_mean": ("fill", 0.0),
                         pre + "running_var": ("fill", 1.0),
                         pre + "num_batches_tracked": ("fill", 0)})
        elif isinstance(m, WeightNormLinear):
            plan.update({pre + "weight_v": ("normal", 0.01), pre + "weight_g": ("fill", 1.0),
                         pre + "bias": ("fill", 0.0)})
        elif isinstance(m, MultiheadAttention):
            c = m.d_model
            plan.update({pre + "in_proj_weight": ("normal", math.sqrt(2.0 / (c + 3 * c))),
                         pre + "in_proj_bias": ("fill", 0.0)})
        elif isinstance(m, nn.Embedding):
            plan[pre + "weight"] = ("normal", 1.0)
        elif isinstance(m, nn.LayerNorm):
            plan.update({pre + "weight": ("fill", 1.0), pre + "bias": ("fill", 0.0)})
    return plan


def make_state_dict(cfg, seed: int, device, *, train_init: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The state dict of the configuration's model, f32 on ``device``."""
    with torch.device("meta"):
        model = HOISDF(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    plan = _plan(model, train_init)
    missing = sorted(set(shapes) - set(plan) - {"hand_sigmoid_beta", "obj_sigmoid_beta"})
    if missing:
        raise ValueError(f"no initialiser for {missing[:5]}")
    normal = [k for k in shapes if plan.get(k, ("",))[0] == "normal"]
    total = sum(math.prod(shapes[k][0]) for k in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, (shape, dtype) in shapes.items():
        kind = plan.get(k, ("fill", 0.1))
        if kind[0] == "normal":
            n = math.prod(shape)
            out[k] = flat[off:off + n].view(shape).mul_(kind[1])
            off += n
        else:
            out[k] = torch.full(shape, kind[1], dtype=dtype, device=device)
    return out
