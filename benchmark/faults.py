"""Faults planted under a cell's timed path, which the comparison has to
catch: the tests run them at a tiny size on the CPU, and on the card they
give the readings that set the upper end of a limit.

    python -m benchmark.faults --workload <cell> --fault <name> --seeds 1,2,3

Each fault is a hook ``(what, obj) -> obj`` that a run passes everything
its window drives through (``Session.program``).  One result line a seed,
as the command prints it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch


def _one_frame_off_surface(model):
    """The hand field's selection of a batch's first frame replaced by the
    cascade's first-stage lattice, spread over the box: one slot's points
    far from the surface."""
    from benchmark.reference.sampler import first_stage_probes

    inner = model.sdf_infer

    def sdf_infer(pyramid, center, cam_intr, bbox, sdf_scale, num_points, which):
        points, sdf, posenc = inner(pyramid, center, cam_intr, bbox, sdf_scale, num_points,
                                    which)
        if which == "hand":
            c = model.cfg
            lattice = first_stage_probes(c.bins_n, c.hier_levels[0][0], points.device)
            idx = torch.arange(points.shape[1], device=points.device) * len(lattice)
            points = points.clone()
            points[0] = lattice[idx // points.shape[1]].to(points.dtype)
        return points, sdf, posenc

    model.sdf_infer = sdf_infer
    return model


def one_frame_select(what, obj):
    if what == "model":
        return _one_frame_off_surface(obj)
    if what == "predictor":
        _one_frame_off_surface(obj.model)
    if what == "train_state":
        _one_frame_off_surface(obj.module)
    return obj


def altered_eval(what, step):
    if what != "eval_step":
        return step

    def altered(batch):
        out = dict(step(batch))
        joints = out["mano_joints"].clone()
        joints[-1] *= 1.5  # one frame's answer, half as large again
        out["mano_joints"] = joints
        return out
    return altered


def half_eval(what, step):
    if what != "eval_step":
        return step

    def half(batch):
        n = batch["img"].shape[0]
        out = step({k: v[: n // 2] for k, v in batch.items()})
        return {k: torch.cat([v, v], dim=1 if k in ("hand_off", "hand_cls") else 0)
                for k, v in out.items()}
    return half


def altered_serve(what, pred):
    if what != "predictor":
        return pred
    inner = pred.materialize

    def altered(handle, n):
        out = inner(handle, n)
        out["mano_joints"] = out["mano_joints"].copy()
        out["mano_joints"][0] *= 1.5  # one request's answer
        return out
    pred.materialize = altered
    return pred


def half_serve(what, pred):
    if what != "predictor":
        return pred
    inner = pred.predict_async

    def half(frames):
        n = frames["img"].shape[0]
        handle, _ = inner({k: v[: (n + 1) // 2] for k, v in frames.items()})
        return handle, n
    pred.predict_async = half
    return pred


def unchanged_state(what, obj):
    if what == "train_state":
        obj.optimizer.step = lambda *a, **k: None
    return obj


def half_train(what, step):
    if what != "train_step":
        return step

    def half(state, inputs, targets, *args, **kwargs):
        n = inputs["img"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in inputs.items()},
                    {k: v[:n] for k, v in targets.items()}, *args, **kwargs)
    return half


FAULTS = {f.__name__: f for f in (one_frame_select, altered_eval, half_eval, altered_serve,
                                  half_serve, unchanged_state, half_train)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    from benchmark import run

    p = argparse.ArgumentParser(prog="benchmark.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", default="2")
    args = p.parse_args(argv)
    for seed in [x.strip() for x in args.seeds.split(",") if x.strip()]:
        rc = run.main(["--workload", args.workload, "--seed", seed, "--seconds", args.seconds,
                       "--trace", "0"], fault=FAULTS[args.fault])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
