"""The comparisons that decide ``correct``: the program's outputs, read from
its run, against the plain reference's on the same inputs and weights.

Every number is a worst case over what it covers, and larger is worse:

- ``outputs``: over the compared output tensors and the frames, the
  relative L2 gap ``||program - reference|| / max(||reference||, the median
  frame's)`` of a frame's tensor (the reference given the program's token
  points);
- ``select``: the mean over the checked frames and both fields of how much
  farther from the reference's surface the program's selected points lie
  than the reference's own selection, ``(mean |sdf| at the program's
  points - mean |sdf| at the reference's) / mean |sdf| over the first
  stage's probes``, all by the reference's field (the cascade prunes whole
  cells at near-ties, so a frame's gap swings by nature, and one field's
  mean can stay low under the fp8 control on a seed: the mean over both is
  the steady number that separates the program from the control);
- ``select_frame``: the same gap of the worst single frame and field, a
  loose bound that a fault in one slot of a batch cannot hide under the
  mean;
- ``mano``: over the frames, the relative gap of the MANO meshes to the
  reference's MANO layer on the program's own head outputs;
- ``loss``: ``|loss_p - loss_r| / |loss_r|`` of the first checked train
  step's total loss (the later steps' losses swing with the MANO head: the
  6D rotation's Gram-Schmidt and the matrix to axis-angle conversion are
  ill-conditioned near their branch points, and the mesh losses weigh 1e4;
  the first step is the steady number);
- ``grad``: over the leaves, ``| ||g_p|| - ||g_r|| | / max(||g_r||, median
  leaf's ||g_r||)`` of the first step's gradient;
- ``change``: the same of the parameters' change after the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (smaller ones move under AdamW by round-off alone).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch


def frame_gap(prog: torch.Tensor, ref: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """Relative L2 gap of each frame's tensor -> [B] (f64): measured against
    the reference's norm of that frame's tensor or of the median frame's,
    whichever is larger (a frame whose output is all but zero does not blow
    the ratio up)."""
    p = prog.double().movedim(batch_dim, 0).flatten(1)
    r = ref.double().movedim(batch_dim, 0).flatten(1)
    norms = r.norm(dim=1)
    return (p - r).norm(dim=1) / torch.maximum(norms, norms.median()).clamp_min(1e-30)


# the per-layer outputs carry the layer axis first and the frames second
BATCH_DIM = {"hand_off": 1, "hand_cls": 1}


def output_gaps(prog: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
                keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The per-frame gap of each key (non-finite program values read inf)."""
    out = {}
    for k in keys:
        gap = frame_gap(prog[k], ref[k], BATCH_DIM.get(k, 0))
        bad = ~torch.isfinite(prog[k].double().movedim(BATCH_DIM.get(k, 0), 0).flatten(1)).all(1)
        out[k] = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    return out


def worst(gaps: Mapping[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest gap and its key."""
    key = max(gaps, key=lambda k: float(gaps[k].max()))
    return float(gaps[key].max()), key


def selection_gap(field_prog: torch.Tensor, field_ref: torch.Tensor,
                  field_probe: torch.Tensor) -> torch.Tensor:
    """Per frame: (mean |sdf| at the program's points - at the reference's)
    / mean |sdf| at the first stage's probes, all [B, *] of the reference's
    field -> [B]."""
    scale = field_probe.abs().mean(dim=1).clamp_min(1e-12)
    return (field_prog.abs().mean(dim=1) - field_ref.abs().mean(dim=1)) / scale


def leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
              keep: Sequence[str]) -> Tuple[float, str]:
    """Worst ``| prog - ref | / max(ref, median ref)`` over the ``keep`` leaves
    of per-leaf norms -> (gap, leaf); a leaf the program lacks or reads
    NaN reads inf."""
    vals = sorted(ref[k] for k in keep)
    med = vals[len(vals) // 2]
    gaps = {}
    for k in keep:
        g = abs(prog.get(k, float("inf")) - ref[k]) / max(ref[k], med, 1e-30)
        gaps[k] = float("inf") if g != g else g
    key = max(gaps, key=gaps.get)
    return gaps[key], key


def moving_leaves(grad_ref: Mapping[str, float]) -> list:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    vals = sorted(grad_ref.values())
    med = vals[len(vals) // 2]
    return [k for k, v in grad_ref.items() if v >= 1e-3 * med]
