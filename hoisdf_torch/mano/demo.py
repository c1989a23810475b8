"""Random-hand demo helper (``hoisdf_tpu/mano/demo.py``).

Parity target: ``manopth/manopth/demo.py:10-15`` (``generate_random_hand``),
the subject of the reference's only unit test (manopth/test/test_demo.py).
The draws come from a ``torch.Generator`` on the device, so they differ from
the JAX package's PRNG stream; the layer itself is held to JAX's on shared
inputs.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hoisdf_torch.mano.layer import ManoLayer
from hoisdf_torch.mano.model import ManoModel, make_synthetic_mano
from hoisdf_torch.train import resolve_device


def generate_random_hand(batch_size: int = 1, ncomps: int = 6,
                         model: Optional[ManoModel] = None, seed: int = 0,
                         device="cuda") -> Dict[str, torch.Tensor]:
    """Sample a random PCA pose and shape and run the MANO layer on
    ``device`` (the card unless the caller passes ``"cpu"``).

    Returns a dict with 'verts' [B,778,3] and 'joints' [B,21,3] (mm)."""
    dev = resolve_device(device)
    model = model or make_synthetic_mano(0)
    layer = ManoLayer(model, use_pca=True, ncomps=ncomps, center_idx=None, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pose = torch.randn(batch_size, ncomps + 3, generator=gen, device=dev)
    shape = torch.randn(batch_size, 10, generator=gen, device=dev)
    verts, joints = layer(pose, shape)
    return {"verts": verts, "joints": joints}
