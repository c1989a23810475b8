"""The reference HOISDF with the IK head (the release's ho3d_render setting,
``use_inverse_kinematics``): the hand transformer decodes one shape query
under ``get_manoshape_memory_mask``, with no target mask and no pose head,
and the shape head reads that query.

It subclasses ``model.py``'s ``HOISDF`` and changes only the head:

- the parent is built with one query whose index is the shape's (0), which
  gives the one-query embedding and the shape-only memory mask; the target
  mask it would make for one query masks nothing and is dropped;
- ``linear_pose`` is replaced by a module without parameters that gives an
  empty pose, so the state dict holds the IK head's leaves alone, and the
  forward drops the empty ``mano_pose6d`` from its outputs.

The outputs are the parent's, with ``mano_shape`` [L, B, 10] from the one
query.  Building it turns TF32 off for cuBLAS and cuDNN (process-wide), so
that its f32 runs in full f32 on the card.  It imports nothing of the
program.
"""

from __future__ import annotations

import types
from typing import Any, Dict

import torch
from torch import nn

from benchmark.reference.model import HOISDF
from benchmark.reference.transformer import get_manoshape_memory_mask


class _NoPose(nn.Module):
    """The IK head has no pose head: [..., 0, hidden] -> [..., 0, 6]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros(*x.shape[:-1], 6)


class HOISDFIK(HOISDF):
    def __init__(self, cfg):
        # f32 products and convolutions stay f32 on the card (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        one_query = types.SimpleNamespace(**{**vars(cfg), "mano_num_queries": 1,
                                             "mano_shape_indx": 0})
        super().__init__(one_query)
        self.linear_pose = _NoPose()
        self.tgt_mask = None
        self.memory_mask = get_manoshape_memory_mask(cfg.num_samp_hand, cfg.num_samp_obj).to(
            self.memory_mask.device)

    def forward(self, batch, **kw) -> Dict[str, Any]:
        out = super().forward(batch, **kw)
        del out["mano_pose6d"]
        return out
