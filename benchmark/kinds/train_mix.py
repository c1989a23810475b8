"""Training steps in the late phase of the schedule: ``train.make_train_step``
on ``train.create_train_state``'s state, at epoch ``epoch`` (past
``point_sampling_epoch``), where ``field_guided_per_block`` of every
``block`` steps take the field-guided sampler and the rest the jittered
presampled points, in an order drawn from the seed (every seed the same
mix).  ``dist_range`` follows the step's progress through the epoch, as
``presample_gate`` sets it.  Losses are read back ``loss_lag`` steps late,
as the train loop reads them.

Parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (distinct
batches), ``epoch``, ``steps_per_epoch``, ``block``,
``field_guided_per_block``, ``loss_lag``, ``checked_steps``,
``profile_steps``.

Set-up builds the state and drives it through one block (both branches),
the first ``checked_steps`` of them on distinct batches, through the same
call the window makes; the window continues with the same state.  The
reference follows the checked steps: each step's loss, the first step's
gradient by leaf and the parameters' change after the checked steps.  In
the checked field-guided steps it is given the points the program's
sampler selected, read from the model's forward, and judges them against
its own selection at the same weights.
``train_step_ms`` is the window over the steps completed in it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts, judge, shared
from benchmark.inputs.frames import make_batch, split
from benchmark.inputs.seeds import torch_seed
from benchmark.trace import profiled


def lr_for_step(cfg, step: int, steps_per_epoch: int) -> float:
    """StepLR gamma^(epoch // lr_drop) with the original's floor."""
    epoch = step // steps_per_epoch
    return max(cfg.lr * cfg.lr_decay_gamma ** (epoch // cfg.lr_drop), cfg.lr_floor)


def dist_range(cfg, step: int, steps_per_epoch: int) -> float:
    """The jitter distance by the step's progress through its epoch."""
    ratio = (step % steps_per_epoch) / steps_per_epoch
    return cfg.random_move_dist[sum(1 for r in cfg.random_ratio if ratio > r)]


def branch_order(rng: np.random.Generator, n: int, block: int, field_guided: int) -> List[bool]:
    """``n`` flags (True: field-guided), each block of ``block`` holding
    ``field_guided`` of them in a random order."""
    out: List[bool] = []
    while len(out) < n:
        out.extend(bool(x) for x in rng.permutation([1] * field_guided
                                                    + [0] * (block - field_guided)))
    return out[:n]


def _pool(s, cfg, b: int, n: int):
    rng = s.rng("frames")
    out = []
    for _ in range(n):
        inputs, targets = split(make_batch(cfg, b, rng, train=True))
        if cfg.transfer_dtype == "float32":
            inputs["img"] = inputs["img"].astype(np.float32) / 255.0
        out.append((inputs, targets))
    return out


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def run(s) -> dict:
    from hoisdf_torch.models.hoisdf import HOISDF
    from hoisdf_torch.train import create_train_state, make_train_step

    p, cfg, dev = s.params, s.cfg, s.device
    b, spe = p["batch"], p["steps_per_epoch"]
    pool_np = _pool(s, cfg, b, p["pool"])
    pool = [(shared.host_tensors(i, dev), shared.host_tensors(t, dev)) for i, t in pool_np]
    order = branch_order(s.rng("order"), 100000, p["block"], p["field_guided_per_block"])
    s.mark("batches made")
    state_dict = s.weights(train_init=True)
    ref_mano, port_mano = s.mano()
    s.mark("weights made")
    with torch.device(dev):
        model = HOISDF(cfg)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(cfg, model, spe, device=dev)
    first_step = p["epoch"] * spe
    state.step = first_step
    step = s.program("train_step", make_train_step(cfg, port_mano, device=dev))
    state = s.program("train_state", state)
    gen = torch.Generator(device=dev).manual_seed(torch_seed(s.seed, "generator"))
    s.mark("train state and step built")

    def one(i: int):
        inputs, targets = pool[i % len(pool)]
        k = state.step
        with s.spans.span("train.step"):
            _, losses = step(state, inputs, targets, gen, dist_range(cfg, k, spe),
                             use_presampled=not order[i])
        return losses

    # ---- set-up: one block, the first steps checked ------------------------------
    checked = p["checked_steps"]
    names = [n for n, _ in state.module.named_parameters()]
    prog_losses, picks = [], []
    grad_p: Dict[str, float] = {}
    change_p: Dict[str, float] = {}
    reader = shared.ProgramReader(state.module)
    for i in range(p["block"]):
        if i == checked:
            reader.remove()
        losses = one(i)
        if i < checked:
            read = reader.take()
            prog_losses.append({k: float(v) for k, v in losses.items()})
            picks.append({w: read[w] for w in ("hand", "obj") if w in read}
                         if order[i] else None)
        if i == 0:
            grad_p = _norms({n: q.grad for n, q in state.module.named_parameters()
                             if q.grad is not None})
        if i == checked - 1:
            cur = dict(state.module.named_parameters())
            change_p = _norms({n: cur[n].detach() - state_dict[n] for n in names})
    s.sync()
    s.mark("checked steps and warm-up done")

    # ---- the window ----------------------------------------------------------------
    failed = [0]
    pending: deque = deque()

    def steps(n=None, until=None, first=0):
        i = first
        while (n is None or i - first < n) and (until is None or time.perf_counter() < until):
            pending.append(one(i)["total"])
            if len(pending) > p["loss_lag"]:
                failed[0] += not np.isfinite(float(pending.popleft()))
            i += 1
        return i - first

    def drain():
        while pending:
            failed[0] += not np.isfinite(float(pending.popleft()))

    t0 = time.perf_counter()
    setup_s = t0 - s.t_start
    ctx = None
    first = p["block"]
    if not s.trace:
        n = steps(until=t0 + s.seconds, first=first)
        drain()
        s.sync()
        elapsed = time.perf_counter() - t0
        e2e = {"train_step_ms": elapsed * 1e3 / n, "setup_s": setup_s}
    else:
        s.spans.on = True
        n = steps(until=t0 + s.seconds * p["span_share"], first=first)
        drain()
        s.sync()
        span_s = time.perf_counter() - t0
        s.spans.on = False
        n_prof = p["profile_steps"]
        prof_first = first + n

        def profiled_steps():
            steps(n=n_prof, first=prof_first)
            drain()

        tr = profiled(profiled_steps, s.sync)
        cuda = dev.type == "cuda"
        pk = counts.peaks(torch.cuda.get_device_name(dev)) if cuda else None
        bounds: Dict[str, float] = {}
        if pk:
            for i in range(prof_first, prof_first + n_prof):
                for k, v in counts.train_step_bounds(cfg, b, pk, order[i]).items():
                    bounds[k] = bounds.get(k, 0.0) + v
        from benchmark.counts.flops import train_step_flops

        fg = train_step_flops(s.ref_cfg, b, True)
        pre = train_step_flops(s.ref_cfg, b, False)
        flops = sum(fg if order[i] else pre for i in range(first, first + n))
        ctx = shared.layer_context(spans=dict(s.spans.ms), trace=tr, phase="train",
                                   profiled_steps=n_prof, bounds=bounds, flops=flops,
                                   span_seconds=span_s,
                                   peak_flops=pk["float32"] if pk else None)
        e2e = {}
        s.log(f"span part: {n} steps in {span_s:.3f} s; profiled {n_prof} steps")
    peak = s.memory_peak()
    s.log(f"window: {n} steps, set-up {setup_s:.3f} s, peak {peak / 2**30:.3f} GiB")

    attempted = n + (p["profile_steps"] if s.trace else 0)
    del step, state, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if any(pk is not None and (len(pk) != 2 or any(v.shape[0] != b for v in pk.values()))
           for pk in picks):
        s.log("the checked steps' reads do not cover the batch's selection")
        compared = {k: float("inf") for k in ("loss", "grad", "change", *SELECT)}
    else:
        ref_losses, grad_r, change_r, _, gaps = reference_steps(
            s, state_dict, ref_mano, pool_np, order, first_step, checked, picks, None)
        compared = numbers(s, prog_losses, ref_losses, grad_p, grad_r, change_p, change_r,
                           gaps)
    return {"end_to_end": e2e, "layer_context": ctx, "compare": compared,
            "attempted": attempted, "failed": failed[0], "memory_peak_bytes": peak}


SELECT = ("select", "select_frame")


def selection_gaps(model, batch, picks) -> torch.Tensor:
    """The per-frame gaps of ``picks`` against the reference's own selection
    at its current weights in train mode, as a train step's sampler sees
    the pyramid (batch statistics); the running statistics that forward
    updates are put back."""
    model.train()
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    gaps = shared.selection_gaps(model, batch, picks)
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
    return torch.cat(list(gaps.values()))


def reference_steps(s, state_dict, ref_mano, pool_np, order, first_step: int, checked: int,
                    picks, rounding):
    """The reference's ``checked`` steps from the run's weights: their total
    losses, the first step's gradient norms by leaf, the change norms after
    the last, the points each field-guided step selected, and the per-frame
    selection gaps of the given points.  ``picks`` (the program's points)
    are given to its field-guided steps, judged first against its own
    selection; without them (a control) it selects its own."""
    from benchmark.reference.layers import set_operand_rounding
    from benchmark.reference.steps import AdamW, train_step

    p, cfg = s.params, s.ref_cfg
    spe = p["steps_per_epoch"]
    model = shared.reference_model(cfg, state_dict, s.device)
    set_operand_rounding(model, rounding)
    opt = AdamW(model)
    gen = torch.Generator(device=s.device).manual_seed(torch_seed(s.seed, "generator"))
    losses, own, gaps = [], [], []
    grad: Dict[str, float] = {}
    change: Dict[str, float] = {}
    for i in range(checked):
        inputs, targets = pool_np[i % len(pool_np)]
        batch = shared.on_device(inputs, s.device)
        tg = shared.on_device(targets, s.device)
        k = first_step + i
        forced = ({w: picks[i][w].to(s.device) for w in ("hand", "obj")}
                  if picks is not None and order[i] else None)
        if forced is not None:
            gaps.append(selection_gaps(model, batch, forced))
        out, picked = train_step(cfg, model, opt, ref_mano, batch, tg, gen,
                                 dist_range(cfg, k, spe), lr_for_step(cfg, k, spe),
                                 use_presampled=not order[i], forced=forced)
        losses.append({k: float(v) for k, v in out.items()})
        own.append(picked)
        if i == 0:
            grad = _norms({n: q.grad for n, q in model.named_parameters()
                           if q.grad is not None})
    cur = dict(model.named_parameters())
    change = _norms({n: cur[n].detach() - state_dict[n] for n in cur})
    return losses, grad, change, own, gaps


def numbers(s, prog_losses, ref_losses, grad_p, grad_r, change_p, change_r,
            select_gaps) -> Dict[str, float]:
    """The first step's total loss (the later steps' swing with the MANO
    head's conditioning, see ``judge``), the first gradient and the
    change, each as a gap to the reference's; and the checked field-guided
    steps' selection gaps, their mean and worst frame."""
    gaps = [abs(a["total"] - r["total"]) / max(abs(r["total"]), 1e-30)
            if np.isfinite(a["total"]) else float("inf")
            for a, r in zip(prog_losses, ref_losses)]
    grad, gleaf = judge.leaf_gaps(grad_p, grad_r, list(grad_r))
    change, cleaf = judge.leaf_gaps(change_p, change_r, judge.moving_leaves(grad_r))
    s.log(f"total losses program {[a['total'] for a in prog_losses]} reference "
          f"{[r['total'] for r in ref_losses]}; gaps by step {gaps}")
    last_p, last_r = prog_losses[-1], ref_losses[-1]
    s.log("last checked step's gaps by term: " + ", ".join(
        f"{k} {abs(last_p[k] - last_r[k]) / max(abs(last_r[k]), 1e-30):.3g}"
        for k in last_r if k in last_p))
    s.log(f"worst grad leaf {gleaf}: {grad!r}; worst change leaf {cleaf}: {change!r}")
    tally = shared.Tally()
    tally.add_selection(torch.cat(select_gaps), "the checked field-guided steps")
    s.log(f"selection: mean {tally.numbers['select']!r} over {sum(map(len, select_gaps))} "
          f"frames and fields, worst frame {tally.numbers['select_frame']!r}")
    return {"loss": gaps[0], "grad": grad, "change": change, **tally.numbers}


def control(s, rounding) -> shared.Tally:
    """The reference with ``rounding`` on every product's operands, selecting
    its own points, in the program's place; judged by the f32 reference
    given the control's points."""
    p = s.params
    pool_np = _pool(s, s.cfg, p["batch"], p["pool"])
    order = branch_order(s.rng("order"), p["block"], p["block"], p["field_guided_per_block"])
    state_dict = s.weights(train_init=True)
    ref_mano, _ = s.mano()
    first_step = p["epoch"] * p["steps_per_epoch"]
    checked = p["checked_steps"]
    low = reference_steps(s, state_dict, ref_mano, pool_np, order, first_step, checked,
                          None, rounding)
    picks = low[3]
    ref = reference_steps(s, state_dict, ref_mano, pool_np, order, first_step, checked,
                          picks, None)
    tally = shared.Tally()
    for k, v in numbers(s, low[0], ref[0], low[1], ref[1], low[2], ref[2], ref[4]).items():
        tally.add(k, v)
    return tally
