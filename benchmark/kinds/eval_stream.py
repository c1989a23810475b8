"""Evaluation over a stream of batches: ``train.make_eval_step`` enqueued back
to back on a pool of distinct pinned batches, each step's outputs copied to
the host with at most ``inflight`` steps in flight (the one-batch lookahead
of ``evaluate_batches``).

Parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (distinct batches),
``inflight``, ``warmup`` (steps of set-up), ``profile_steps`` (steps under
the profiler at the end of a traced window).

``eval_fps`` is every frame whose step completed over the whole window.
The window runs the port untouched.  The comparison judges the last
outputs of each pool batch in the window (each batch's frames are
distinct) against the reference.  A checked pass after the window runs
the same step once more on each pool batch and reads, from the model's
forward, the token points the sampler selected and the MANO head's
inputs: the reference follows those points, and the selection is judged
against the reference's own.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import counts, shared
from benchmark.inputs.frames import make_batch
from benchmark.trace import profiled

# the outputs an evaluator reads back every step
HOST_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans",
             "hand_points_notrans")


def run(s) -> dict:
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import make_eval_step

    p, cfg, dev = s.params, s.cfg, s.device
    b = p["batch"]
    # the eval step's own default (``supervise_sdf=None``): DexYCB also
    # queries the SDF at the frame's supervision points; the batches and
    # the counts follow it
    supervise = cfg.dataset == "dexycb"
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=supervise) for _ in range(p["pool"])]
    if cfg.transfer_dtype == "float32":
        for batch in pool_np:
            batch["img"] = batch["img"].astype("float32") / 255.0
    pool = [shared.host_tensors(x, dev) for x in pool_np]
    s.mark("frames made")
    state_dict = s.weights(train_init=False)
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
        """Enqueue steps from ``first`` until ``n_steps`` ran or the clock
        passed ``until``; -> (steps, frames completed)."""
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
        steps, frames = stream(until=t0 + s.seconds * p["span_share"],
                               first=p["warmup"])
        span_s = time.perf_counter() - t0
        s.spans.on = False
        n_prof = p["profile_steps"]
        tr = profiled(lambda: stream(n_steps=n_prof, first=p["warmup"] + steps), s.sync)
        pk = counts.peaks(torch.cuda.get_device_name(dev)) if cuda else None
        bounds = ({k: v * n_prof for k, v in counts.eval_step_bounds(cfg, b, pk, supervise)
                   .items()} if pk else {})
        from benchmark.counts.flops import eval_step_flops

        ctx = shared.layer_context(
            spans=dict(s.spans.ms), trace=tr, phase="eval", profiled_steps=n_prof,
            bounds=bounds, flops=eval_step_flops(s.ref_cfg, b, supervise) * steps,
            span_seconds=span_s, peak_flops=pk[cfg.compute_dtype] if pk else None)
        e2e = {}
        s.log(f"span part: {steps} steps in {span_s:.3f} s; profiled {n_prof} steps; "
              + ", ".join(f"{k} median {shared.median(v):.3f} ms"
                          for k, v in s.spans.ms.items()))
    attempted = (steps + (p["profile_steps"] if s.trace else 0)) * b
    peak = s.memory_peak()
    s.log(f"window: {steps} steps, {frames} frames, set-up {setup_s:.3f} s, "
          f"peak {peak / 2**30:.3f} GiB")

    # ---- the comparison, once the window has closed ---------------------------
    checked = checked_pass(s, model, step, pool, last)
    del step, model, last, ring
    if cuda:
        torch.cuda.empty_cache()
    tally = compare(s, checked, pool_np, state_dict, ref_mano)
    return {"end_to_end": e2e, "layer_context": ctx, "compare": tally.numbers,
            "attempted": attempted, "failed": failed[0], "memory_peak_bytes": peak}


def checked_pass(s, model, step, pool, last) -> dict:
    """Each pool batch's last outputs of the window beside what the program
    decided for them, read from a second run of the same step on the same
    batch (from its outputs where they carry it, else from the model's
    forward) -> pool index -> (outputs, read)."""
    window = {k: {key: v.clone() for key, v in out.items()} for k, out in last.items()}
    reader = shared.ProgramReader(model)
    checked, same = {}, 0
    try:
        for k in sorted(window):
            again = step(pool[k])
            checked[k] = (window[k], shared.output_read(again) or reader.take())
            same += all(torch.equal(again[key], v) for key, v in window[k].items())
    finally:
        reader.remove()
    s.log(f"checked pass: {same} of {len(window)} batches' outputs equal the window's")
    return checked


def compare(s, checked, pool_np, state_dict, ref_mano) -> shared.Tally:
    """Judge each pool batch's last outputs against the reference."""
    ref = shared.reference_model(s.ref_cfg, state_dict, s.device)
    tally = shared.Tally()
    for k in sorted(checked):
        out, read = checked[k]
        batch = shared.on_device(pool_np[k], s.device)
        shared.judge_eval_batch(tally, ref, ref_mano, batch, out, read, shared.EVAL_KEYS,
                                label=f"batch {k}")
    for name, where in tally.where.items():
        s.log(f"worst {name}: {tally.numbers[name]!r} at {where}")
    return tally


def control(s, rounding) -> shared.Tally:
    """The control: the reference with ``rounding`` on every product's
    operands, in the program's place, judged like the program."""
    from benchmark.reference.layers import set_operand_rounding
    from benchmark.reference.precision import MANO_ROUNDING
    from benchmark.reference.steps import eval_outputs

    p, cfg = s.params, s.cfg
    b = p["batch"]
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=cfg.dataset == "dexycb")
               for _ in range(p["pool"])]
    state_dict = s.weights(train_init=False)
    ref_mano, _ = s.mano()
    low = set_operand_rounding(shared.reference_model(s.ref_cfg, state_dict, s.device),
                               rounding)
    checked = {}
    for k, batch_np in enumerate(pool_np):
        out = eval_outputs(low, ref_mano, shared.on_device(batch_np, s.device),
                           supervise_sdf=False, mano_rounding=MANO_ROUNDING)
        checked[k] = (out, {"hand": out["hand_points"], "obj": out["obj_points"],
                            "mano_pose6d": out["mano_pose6d"], "mano_shape": out["mano_shape"]})
    del low
    return compare(s, checked, pool_np, state_dict, ref_mano)
