"""Pieces the cells' generators share: pinned inputs, the reading of the
program's selection, the reference built from the run's weights, the
judging of eval outputs, and the context the per-layer readers read."""

from __future__ import annotations

import types
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from benchmark import judge
from benchmark.reference.sampler import first_stage_probes


def host_tensors(arrays: Mapping[str, np.ndarray], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """numpy arrays as host tensors, pinned when the run is on a card."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    if device.type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def on_device(arrays: Mapping[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The reference's inputs: the arrays on ``device``, the u8 image as the
    f32 values byte / 255 and u8 masks as f32."""
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if t.dtype == torch.uint8:
            t = t.float() / 255.0 if k == "img" else t.float()
        out[k] = t
    return out


class ProgramReader:
    """Reads what the program's forward decided on the way to its answers:
    wraps the model's bound ``forward`` and records, for each call, the
    token points each field's sampler selected (scaled frame) and the final
    decoder layer's MANO head inputs, ``mano_pose6d`` and ``mano_shape``.
    A run installs it only for a checked pass outside its window."""

    KEYS = ("hand", "obj", "mano_pose6d", "mano_shape")

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.calls: List[Dict[str, torch.Tensor]] = []
        inner = model.forward

        def forward(*args, **kwargs):
            out = inner(*args, **kwargs)
            record = {"hand": out.get("hand_points"), "obj": out.get("obj_points")}
            if "mano_pose6d" in out:
                record["mano_pose6d"] = out["mano_pose6d"][-1]
                record["mano_shape"] = out["mano_shape"][-1]
            self.calls.append({k: v for k, v in record.items() if v is not None})
            return out

        model.forward = forward

    def remove(self) -> None:
        del self.model.forward

    def take(self) -> Dict[str, torch.Tensor]:
        """The one forward call since the last take (empty where there was
        none, or more than one), and forget it."""
        calls, self.calls = self.calls, []
        return calls[0] if len(calls) == 1 else {}


# what the program decided, under the names its forward gives them, where
# its own outputs carry it (the final decoder layer's head inputs, [B, ...])
OUTPUT_READS = {"hand": "hand_points", "obj": "obj_points", "mano_pose6d": "mano_pose6d",
                "mano_shape": "mano_shape"}


def output_read(out: Mapping) -> Dict[str, torch.Tensor]:
    """The read from a step's or a predictor's own outputs, where they
    carry every key of :data:`OUTPUT_READS`; else empty."""
    if not all(v in out for v in OUTPUT_READS.values()):
        return {}
    return {k: torch.as_tensor(out[v]) for k, v in OUTPUT_READS.items()}


def reference_model(ref_cfg, state_dict, device: torch.device):
    """The reference HOISDF on ``device`` with the run's weights."""
    from benchmark.reference.model import HOISDF

    with torch.device(device):
        model = HOISDF(ref_cfg)
    model.to(device)
    model.load_state_dict(state_dict, strict=True)
    return model


def selection_gaps(ref, batch: Mapping[str, torch.Tensor], picks: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Per field, the per-frame :func:`judge.selection_gap` of the program's
    points ``picks`` against the reference's own selection."""
    c = ref.cfg
    with torch.no_grad():
        _, pyramid = ref.backbone(batch)
        out = {}
        for which in ("hand", "obj"):
            center, _, scale, _ = ref._field_args(batch, which)
            own, _ = ref.select(pyramid, batch, which)
            levels = c.hier_levels
            if which == "obj" and c.hier_levels_obj is not None:
                levels = c.hier_levels_obj
            probes = first_stage_probes(c.bins_n, levels[0][0], own.device)
            probes = probes[None].expand(own.shape[0], -1, -1)
            f = [ref.field(pyramid, pts.float(), center, batch["cam_intr"], scale, which)
                 for pts in (picks[which], own, probes)]
            out[which] = judge.selection_gap(*f)
    return out


def batch_dim(key: str) -> int:
    return judge.BATCH_DIM.get(key, 0)


EVAL_KEYS = ("hand_points_notrans", "hand_off", "hand_cls", "decoder_heads", "obj_rot",
             "obj_trans", "hand_joints", "mano_pose6d", "mano_shape")
MANO_KEYS = ("mano_verts", "mano_joints")


class Tally:
    """Each compared number over the batches judged: the worst (:meth:`add`)
    or the mean over every frame (:meth:`add_mean`)."""

    def __init__(self):
        self.numbers: Dict[str, float] = {}
        self.where: Dict[str, str] = {}
        self._sums: Dict[str, List[float]] = {}

    def add(self, name: str, value: float, where: str = "") -> None:
        if value != value:
            value = float("inf")
        if name not in self.numbers or value > self.numbers[name]:
            self.numbers[name] = value
            self.where[name] = where

    def add_mean(self, name: str, values: torch.Tensor, where: str = "") -> None:
        acc = self._sums.setdefault(name, [0.0, 0, float("-inf")])
        acc[0] += float(values.double().sum())
        acc[1] += values.numel()
        if float(values.max()) > acc[2]:
            acc[2] = float(values.max())
            self.where[name] = f"{where} (worst frame {acc[2]!r})"
        self.numbers[name] = acc[0] / acc[1] if acc[0] == acc[0] else float("inf")

    def add_selection(self, gaps: torch.Tensor, where: str = "") -> None:
        """Per-frame selection gaps: their mean over every frame judged
        (``select``) and the worst frame's (``select_frame``)."""
        self.add_mean("select", gaps, where)
        self.add("select_frame", float(gaps.max()), where)

    def fail(self, names: Sequence[str], why: str) -> None:
        for name in names:
            self.add(name, float("inf"), why)


JUDGED = ("outputs", "mano", "select", "select_frame")


def judge_eval_batch(tally: Tally, ref, mano, batch: Mapping[str, torch.Tensor],
                     prog: Mapping[str, torch.Tensor], read: Mapping[str, torch.Tensor],
                     keys: Sequence[str], *, label: str = "") -> None:
    """Judge one batch of the program's eval outputs ``prog`` (their frames
    in ``batch``'s order; ``keys`` of them against the reference's) and what
    the program decided on the way, ``read`` (:class:`ProgramReader`, from
    the checked pass): its selection, judged against the reference's own,
    and its MANO head inputs, judged as outputs, on which the reference's
    MANO layer judges the meshes (``mano``).  The Gram-Schmidt of the 6D
    rotation and the matrix to axis-angle conversion are ill-conditioned
    near their branch points, so a mesh is held to MANO on the program's
    own head outputs.  A read that is missing fails every number."""
    from benchmark.reference.steps import eval_outputs, mano_outputs

    if any(k not in read for k in ProgramReader.KEYS):
        tally.fail(JUDGED, f"{label} (the checked pass saw no forward of the program)")
        return
    rows = batch["img"].shape[0]
    given = {**prog, **{k: read[k] for k in ("mano_pose6d", "mano_shape")}}
    if any(read[w].shape[0] != rows for w in ("hand", "obj")) or \
            any(given[k].shape[batch_dim(k)] != rows for k in (*keys, *MANO_KEYS)):
        tally.fail(JUDGED, f"{label} (the program's rows do not cover the batch)")
        return
    dev = batch["img"].device
    picks = {w: read[w].to(dev) for w in ("hand", "obj")}
    # the eval step's outputs do not depend on its SDF supervision queries
    ref_out = eval_outputs(ref, mano, batch, supervise_sdf=False, forced=picks)
    gaps = judge.output_gaps({k: given[k].to(dev) for k in keys}, ref_out, keys)
    value, key = judge.worst(gaps)
    tally.add("outputs", value, f"{label} {key}")
    meshes = mano_outputs(mano, read["mano_pose6d"].to(dev), read["mano_shape"].to(dev))
    value, key = judge.worst(judge.output_gaps({k: given[k].to(dev) for k in MANO_KEYS},
                                               meshes, MANO_KEYS))
    tally.add("mano", value, f"{label} {key}")
    tally.add_selection(torch.cat(list(selection_gaps(ref, batch, picks).values())), label)


def layer_context(**kw) -> types.SimpleNamespace:
    """What the per-layer readers read: ``spans`` (name -> ms list),
    ``counters``, ``trace`` (a DeviceTrace), ``phase``, and the counts of
    the profiled steps (``profiled_steps``, ``bounds`` kernel -> seconds
    over them), ``flops`` and ``span_seconds`` of the span-timed part, and
    a served cell's ``latency_p95_ms`` over its requests due before the
    profiled tail."""
    base = dict(spans={}, counters={}, trace=None, phase=None, profiled_steps=0,
                bounds={}, flops=None, span_seconds=None, peak_flops=None,
                latency_p95_ms=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def median(values: Sequence[float]) -> Optional[float]:
    return float(np.median(values)) if len(values) else None
