"""Evaluation over a stream of batches under the IK head (the ho3d_render
setting): ``eval_stream``'s traffic, with the hand solved by inverse
kinematics inside the eval step.

``train.make_eval_step`` is enqueued back to back on a pool of distinct
pinned batches, each step's outputs copied to the host with at most
``inflight`` steps in flight.  Parameters (``traffic/<mix>.json``): those of
``eval_stream``.  ``eval_fps`` is every frame whose step completed over the
whole window.  A program whose step gives no hand under the IK head (no
``mano_joints``) stops the run at its first step.

The comparison, after the window, judges the last outputs of each pool
batch.  ``eval_stream``'s checked pass runs the step once more on each batch
and reads the token points the sampler selected.  Then:

- ``outputs``: the forward's outputs against the IK head's reference
  (``reference/model_ik.py``) following the program's points;
- ``select`` / ``select_frame``: the selection against the reference's own,
  as ``eval_stream`` judges it;
- ``ik`` / ``ik_frame``: the reference's IK and MANO (``reference/ik.py``)
  on the program's own voted joints and shape, against the program's
  ``mano_joints`` and ``mano_verts``: per frame the largest distance of a
  joint or vertex, in metres; ``ik`` the mean over the frames, ``ik_frame``
  the worst frame (a frame whose bones lie near parallel has an
  ill-conditioned axis);
- ``ik_valid``: the share of frames whose reflection flag differs.

A traced run also gives the device time of the kernels launched inside the
program's ``eval.ik`` spans (matched to their launches by the profiler's
correlation ids) and the IK kernel's bound.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import deque
from typing import Dict, Sequence

import numpy as np
import torch

from benchmark import counts, judge, shared
from benchmark.inputs.frames import make_batch
from benchmark.kinds.eval_stream import checked_pass
from benchmark.trace import read_chrome_trace

# the outputs an evaluator reads back every step
HOST_KEYS = ("mano_joints", "mano_verts", "mano_pose", "hand_joints", "obj_rot", "obj_trans",
             "hand_points_notrans")
# the forward's outputs judged against the reference
OUTPUT_KEYS = ("hand_points_notrans", "hand_off", "hand_cls", "decoder_heads", "obj_rot",
               "obj_trans", "hand_joints", "mano_shape")
IK_KEYS = ("mano_joints", "mano_verts")
RANGES = ("eval.ik",)


def _weights(s):
    from benchmark.inputs.seeds import torch_seed
    from benchmark.inputs.weights_ik import make_state_dict_ik

    return make_state_dict_ik(s.ref_cfg, torch_seed(s.seed, "weights"), s.device)


def run(s) -> dict:
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import make_eval_step

    p, cfg, dev = s.params, s.cfg, s.device
    b = p["batch"]
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=False) for _ in range(p["pool"])]
    if cfg.transfer_dtype == "float32":
        for batch in pool_np:
            batch["img"] = batch["img"].astype("float32") / 255.0
    pool = [shared.host_tensors(x, dev) for x in pool_np]
    s.mark("frames made")
    state_dict = _weights(s)
    ref_mano, port_mano = s.mano()
    s.mark("weights made")
    with torch.device(dev):
        model = HOISDF(cfg)
    model.load_state_dict(state_dict, strict=True)
    model = s.program("model", model)
    step = s.program("eval_step", make_eval_step(cfg, model, port_mano, device=dev))
    s.mark("eval step built")
    cuda = dev.type == "cuda"

    ring = [{k: None for k in HOST_KEYS} for _ in range(p["inflight"] + 1)]
    last = {}  # pool index -> the outputs of its latest step
    failed = [0]

    def enqueue(i: int):
        k = i % len(pool)
        with s.spans.span("eval.step"):
            out = step(pool[k])
        missing = [key for key in HOST_KEYS if key not in out]
        if missing:
            raise RuntimeError(f"the program's eval step gives no {missing} under the IK head "
                               "(use_inverse_kinematics)")
        last[k] = out
        with s.spans.span("eval.read_back"):
            bufs = ring[i % len(ring)]
            for key in HOST_KEYS:
                if bufs[key] is None:
                    bufs[key] = torch.empty(out[key].shape, dtype=out[key].dtype,
                                            pin_memory=cuda)
                bufs[key].copy_(out[key], non_blocking=True)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        return event, bufs

    def complete(item) -> int:
        event, bufs = item
        with s.spans.span("eval.wait"):
            if event is not None:
                event.synchronize()
        with s.spans.span("eval.check"):
            bad = np.zeros(b, dtype=bool)
            for key in HOST_KEYS:
                bad |= ~np.isfinite(bufs[key].numpy().reshape(b, -1)).all(axis=1)
            failed[0] += int(bad.sum())
        return b

    def stream(n_steps=None, until=None, first=0):
        inflight, done, i = deque(), 0, first
        while (n_steps is None or i - first < n_steps) and \
                (until is None or time.perf_counter() < until):
            inflight.append(enqueue(i))
            if len(inflight) >= p["inflight"]:
                done += complete(inflight.popleft())
            i += 1
        while inflight:
            done += complete(inflight.popleft())
        return i - first, done

    stream(n_steps=p["warmup"])
    s.sync()
    s.mark("warmed up")
    failed[0] = 0
    t0 = time.perf_counter()
    setup_s = t0 - s.t_start
    ctx = None
    if not s.trace:
        steps, frames = stream(until=t0 + s.seconds, first=p["warmup"])
        elapsed = time.perf_counter() - t0
        e2e = {"eval_fps": frames / elapsed, "setup_s": setup_s}
    else:
        s.spans.on = True
        steps, frames = stream(until=t0 + s.seconds * p["span_share"], first=p["warmup"])
        span_s = time.perf_counter() - t0
        s.spans.on = False
        n_prof = p["profile_steps"]
        tr, range_s = profiled_ranges(lambda: stream(n_steps=n_prof, first=p["warmup"] + steps),
                                      s.sync, RANGES)
        pk = counts.peaks(torch.cuda.get_device_name(dev)) if cuda else None
        bounds = {}
        if pk:
            from benchmark.counts.ik import ik_solve_bound_s

            bounds = {k: v * n_prof for k, v in counts.eval_step_bounds(cfg, b, pk, False).items()}
            bounds["ik_solve"] = ik_solve_bound_s(b, pk) * n_prof
        ctx = shared.layer_context(
            spans=dict(s.spans.ms), trace=tr, phase="eval", profiled_steps=n_prof,
            bounds=bounds, flops=eval_step_flops_ik(s.ref_cfg, b) * steps,
            span_seconds=span_s, peak_flops=pk[cfg.compute_dtype] if pk else None,
            range_device_s=range_s)
        e2e = {}
        s.log(f"span part: {steps} steps in {span_s:.3f} s; profiled {n_prof} steps; "
              + ", ".join(f"{k} median {shared.median(v):.3f} ms"
                          for k, v in s.spans.ms.items())
              + f"; device s under ranges {range_s}")
    attempted = (steps + (p["profile_steps"] if s.trace else 0)) * b
    peak = s.memory_peak()
    s.log(f"window: {steps} steps, {frames} frames, set-up {setup_s:.3f} s, "
          f"peak {peak / 2**30:.3f} GiB")

    checked = checked_pass(s, model, step, pool, last)
    del step, model, last, ring
    if cuda:
        torch.cuda.empty_cache()
    tally = compare(s, checked, pool_np, state_dict, ref_mano)
    return {"end_to_end": e2e, "layer_context": ctx, "compare": tally.numbers,
            "attempted": attempted, "failed": failed[0], "memory_peak_bytes": peak}


def profiled_ranges(run_fn, sync, names: Sequence[str]):
    """``trace.profiled``'s sub-window, and the device seconds of the
    operations launched inside the host ranges ``names`` (the program's
    spans, recorded as ``record_function`` ranges on the profiled thread):
    a launch is inside a range when its runtime call starts there, and its
    kernel, copy or set is found by the launch's correlation id.
    -> (DeviceTrace, name -> seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("benchmark.window"):
            run_fn()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        marks = [ev for ev in events if ev.get("name") == "benchmark.window"
                 and ev.get("ph") == "X"]
        if not marks:
            raise RuntimeError("the profiler's trace lacks the window's annotation")
        mark = max(marks, key=lambda ev: ev["dur"])
        window = (mark["ts"] * 1e-6, (mark["ts"] + mark["dur"]) * 1e-6)
        trace = read_chrome_trace(path, window)
    finally:
        os.unlink(path)
    trace.host = [h for h in trace.host if h[0] != "benchmark.window"]
    return trace, range_device_seconds(events, names)


def range_device_seconds(events, names: Sequence[str]) -> Dict[str, float]:
    """name -> device seconds of the operations whose launch lies inside a
    host range of that name (Chrome trace events of ``torch.profiler``)."""
    ranges = {n: [] for n in names}
    launches, device = [], {}
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name in ranges:
            ranges[name].append((ev["ts"], ev["ts"] + ev["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches.append((ev["ts"], corr))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") and corr is not None:
            device[corr] = device.get(corr, 0.0) + ev["dur"] * 1e-6
    out = {}
    for n, spans in ranges.items():
        if not spans:
            continue
        spans.sort()
        starts = np.array([a for a, _ in spans])
        ends = np.array([e for _, e in spans])
        total = 0.0
        for ts, corr in launches:
            i = np.searchsorted(starts, ts, side="right") - 1
            if i >= 0 and ts <= ends[i]:
                total += device.get(corr, 0.0)
        out[n] = total
    return out


def eval_step_flops_ik(cfg, b: int) -> int:
    """FLOPs of one eval step under the IK head at batch ``b``:
    ``FlopCounterMode`` over ``reference/model_ik.py``'s forward and the
    reference IK on ``meta``, plus the sampler's probes (``counts.flops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.counts.flops import _meta_batch, _mano, _sampler_flops
    from benchmark.reference.ik import ik_hand
    from benchmark.reference.model_ik import HOISDFIK
    from benchmark.reference.steps import vote_hand_joints

    with torch.device("meta"):
        model = HOISDFIK(cfg).to("meta")
    model.eval().requires_grad_(False)
    batch, forced, _ = _meta_batch(cfg, b, False)
    mano = _mano()
    with FlopCounterMode(display=False) as counter:
        out = model(dict(batch), supervise_sdf=False, forced=forced)
        ik_hand(mano, vote_hand_joints(out), out["mano_shape"][-1])
    return int(counter.get_total_flops()) + _sampler_flops(cfg, b)


@torch.no_grad()
def reference_outputs(ref, batch, forced=None) -> Dict[str, torch.Tensor]:
    """The IK head's reference forward in eval mode: the final layer's
    outputs the eval step returns, and the voted joints."""
    from benchmark.reference.steps import vote_hand_joints

    ref.eval()
    out = ref(dict(batch), supervise_sdf=False, forced=forced)
    return {"obj_rot": out["obj_rot"][-1], "obj_trans": out["obj_trans"][-1],
            "hand_points_notrans": out["hand_points_notrans"], "hand_off": out["hand_off"],
            "hand_cls": out["hand_cls"], "decoder_heads": out["decoder_heads"],
            "hand_joints": vote_hand_joints(out), "mano_shape": out["mano_shape"][-1],
            "hand_points": out["hand_points"], "obj_points": out["obj_points"]}


JUDGED = ("outputs", "select", "select_frame", "ik", "ik_frame", "ik_valid")


def judge_ik_batch(tally: shared.Tally, ref, mano, batch, prog, read, *, label: str = ""
                   ) -> None:
    """Judge one batch of the program's outputs ``prog`` and the points it
    selected (``read``); the reference IK that judges ``prog``'s hand is in
    full f32 (a control rounds its own IK, never the judge's)."""
    from benchmark.reference.ik import ik_hand

    if any(w not in read for w in ("hand", "obj")):
        tally.fail(JUDGED, f"{label} (the checked pass saw no forward of the program)")
        return
    rows = batch["img"].shape[0]
    if any(k not in prog for k in (*OUTPUT_KEYS, *IK_KEYS, "ik_valid")):
        tally.fail(JUDGED, f"{label} (the program's outputs lack the IK head's)")
        return
    if any(read[w].shape[0] != rows for w in ("hand", "obj")) or \
            any(prog[k].shape[shared.batch_dim(k)] != rows for k in (*OUTPUT_KEYS, *IK_KEYS)):
        tally.fail(JUDGED, f"{label} (the program's rows do not cover the batch)")
        return
    dev = batch["img"].device
    picks = {w: read[w].to(dev) for w in ("hand", "obj")}
    ref_out = reference_outputs(ref, batch, forced=picks)
    gaps = judge.output_gaps({k: prog[k].to(dev) for k in OUTPUT_KEYS}, ref_out, OUTPUT_KEYS)
    value, key = judge.worst(gaps)
    tally.add("outputs", value, f"{label} {key}")
    want = ik_hand(mano, prog["hand_joints"].to(dev), prog["mano_shape"].to(dev))
    dist = torch.cat([(prog[k].to(dev).double() - want[k].double()).norm(dim=-1)
                      for k in IK_KEYS], dim=1).amax(dim=1)
    dist = torch.where(torch.isfinite(dist), dist, torch.full_like(dist, float("inf")))
    tally.add_mean("ik", dist, label)
    tally.add("ik_frame", float(dist.max()), label)
    tally.add_mean("ik_valid", (prog["ik_valid"].to(dev).int() != want["ik_valid"]).double(),
                   label)
    tally.add_selection(torch.cat(list(shared.selection_gaps(ref, batch, picks).values())),
                        label)


def _reference(s, state_dict):
    from benchmark.reference.model_ik import HOISDFIK

    with torch.device(s.device):
        ref = HOISDFIK(s.ref_cfg)
    ref.to(s.device)
    ref.load_state_dict(state_dict, strict=True)
    return ref


def compare(s, checked, pool_np, state_dict, ref_mano) -> shared.Tally:
    """Judge each pool batch's last outputs against the reference."""
    ref = _reference(s, state_dict)
    tally = shared.Tally()
    for k in sorted(checked):
        out, read = checked[k]
        batch = shared.on_device(pool_np[k], s.device)
        judge_ik_batch(tally, ref, ref_mano, batch, out, read, label=f"batch {k}")
    for name, where in tally.where.items():
        s.log(f"worst {name}: {tally.numbers[name]!r} at {where}")
    return tally


def control(s, rounding) -> shared.Tally:
    """The control: the reference with ``rounding`` on every product's
    operands in the program's place, its hand solved by the reference IK
    with its products in TF32 (f32 geometry's nearest lower precision),
    judged like the program."""
    from benchmark.reference.ik import ik_hand
    from benchmark.reference.layers import set_operand_rounding
    from benchmark.reference.precision import MANO_ROUNDING

    p, cfg = s.params, s.cfg
    b = p["batch"]
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=False) for _ in range(p["pool"])]
    state_dict = _weights(s)
    ref_mano, _ = s.mano()
    low = set_operand_rounding(_reference(s, state_dict), rounding)
    checked = {}
    for k, batch_np in enumerate(pool_np):
        out = reference_outputs(low, shared.on_device(batch_np, s.device))
        out.update(ik_hand(ref_mano, out["hand_joints"], out["mano_shape"],
                           round_operands=MANO_ROUNDING))
        checked[k] = (out, {"hand": out["hand_points"], "obj": out["obj_points"]})
    del low
    return compare(s, checked, pool_np, state_dict, ref_mano)
