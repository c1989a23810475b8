"""Weights of the IK head's model (``reference/model_ik.py``), made on the
device from the seed in one draw, as ``weights.py`` makes the 17-query
model's: the same initialiser of each leaf (``weights._plan``), one
``torch.randn`` over all leaves from a ``torch.Generator`` on the device,
scaled per leaf.  Leaves keep the model's names, so one state dict loads
into the program's ho3d_render model and the reference alike."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.inputs.weights import _plan
from benchmark.reference.model_ik import HOISDFIK


def make_state_dict_ik(cfg, seed: int, device, *, train_init: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """The state dict of the IK head's model for ``cfg``, f32 on ``device``."""
    with torch.device("meta"):
        model = HOISDFIK(cfg)
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
