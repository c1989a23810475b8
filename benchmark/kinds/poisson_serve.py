"""Open-loop serving: single-frame requests from many independent cameras,
arriving as a Poisson process at ``rate_hz``, submitted to a
``predictor.BatchingServer`` over a ``predictor.Predictor``.

Parameters (``traffic/<mix>.json``): ``batch`` (the predictor's),
``rate_hz``, ``pool`` (distinct frames), ``max_wait_ms``,
``pipeline_depth``, ``checked_requests``, ``profile_seconds`` (the
profiled tail of a traced run's arrivals), ``drain_seconds``.

The arrivals are the same for every seed up to their order: the gaps are
the ``rate_hz x seconds`` quantiles of the exponential, scaled to fill the
window, shuffled by the seed (:func:`arrivals`).  Each request is timed
from its due time, so a generator held up behind the server's threads
charges the wait to the requests it delays, and the generator's lateness is
printed.  ``serve_fps`` is the requests completed over the time from the
window's start to the last completion; one that fails or never completes
is left out of it and counted in ``failed``.  The 95th percentile over
every request due in the window (a missing one infinitely late) is
printed, and a traced run reports it over the requests due before its
profiled tail (``serve.p95_ms``).  The window runs the port
untouched.  After it a sample of the completed requests, drawn from the
seed, is judged against the reference on its own frame.  A checked pass
serves the sampled frames once more through the same predictor, in
batches of its size, and reads from the model's forward the points the
sampler selected for each frame and the MANO head's inputs (a frame's row
of a padded batch does not depend on the other rows): the reference
follows those points, and the selection is judged against its own.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import shared
from benchmark.inputs.frames import INPUT_KEYS, frames_of, make_batch
from benchmark.trace import profiled

SERVE_KEYS = ("mano_joints", "mano_verts", "hand_joints", "obj_rot", "obj_trans")
# the served outputs held against the reference's, with the MANO head's inputs
OUT_KEYS = ("hand_joints", "obj_rot", "obj_trans", "mano_pose6d", "mano_shape")


def arrivals(rng: np.random.Generator, rate_hz: float, seconds: float) -> np.ndarray:
    """Due times in [0, seconds): ``round(rate x seconds)`` exponential
    gaps at their quantiles, scaled to sum to ``seconds``, in the seed's
    order."""
    n = max(1, int(round(rate_hz * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate_hz
    gaps = rng.permutation(gaps * (seconds / gaps.sum()))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class OpenLoop:
    """Submits ``frames[order[i]]`` at ``t0 + due[i]`` whatever the server's
    state; records each request's due, submit and completion times."""

    def __init__(self, submit, frames: List[Dict], due: np.ndarray, order: np.ndarray):
        self.submit, self.frames, self.due, self.order = submit, frames, due, order
        n = len(due)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.errors = 0
        self.futures: List = [None] * n
        self._lock = threading.Lock()
        self.t0 = 0.0

    def _callback(self, i: int):
        def cb(fut):
            now = time.perf_counter()
            with self._lock:
                if fut.cancelled() or fut.exception() is not None:
                    self.errors += 1
                else:
                    self.done[i] = now
        return cb

    def run(self, t0: float, first: int = 0, last: Optional[int] = None) -> None:
        """Send requests ``first`` to ``last``, each at its due time."""
        self.t0 = t0
        last = len(self.due) if last is None else last
        for i in range(first, last):
            # a plain sleep: a spin would take the GIL from the server's
            # threads at every turn; its overshoot is charged as lateness
            wait = t0 + self.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.sent[i] = time.perf_counter()
            fut = self.submit(self.frames[self.order[i]])
            self.futures[i] = fut
            fut.add_done_callback(self._callback(i))

    def wait(self, timeout_s: float) -> None:
        deadline = time.perf_counter() + timeout_s
        for fut in self.futures:
            if fut is None:
                continue
            try:
                fut.result(timeout=max(deadline - time.perf_counter(), 1e-3))
            except Exception:  # counted by the callback, or missing
                pass

    def latencies_ms(self, first: int = 0, last: Optional[int] = None) -> np.ndarray:
        """From due time to completion; missing requests read inf."""
        sl = slice(first, last)
        lat = (self.done[sl] - (self.t0 + self.due[sl])) * 1e3
        return np.where(np.isnan(lat), np.inf, lat)

    def completed_per_s(self) -> float:
        """Requests completed over the time from the first due time to the
        last completion: the rate the server kept up with."""
        done = self.done[~np.isnan(self.done)]
        return float(len(done) / (done.max() - self.t0)) if len(done) else 0.0

    def lateness_ms(self) -> np.ndarray:
        sent = ~np.isnan(self.sent)
        return (self.sent[sent] - (self.t0 + self.due[sent])) * 1e3


def percentile(values: np.ndarray, q: float) -> float:
    """``np.percentile`` (linear) where every value is finite; with missing
    (inf) values, the order statistic at the same rank."""
    if np.isfinite(values).all():
        return float(np.percentile(values, q))
    s = np.sort(values)
    return float(s[min(len(s) - 1, int(math.ceil(q / 100 * len(s))) - 1)])


def run(s) -> dict:
    from hoisdf_torch.predictor import BatchingServer, Predictor

    p, cfg, dev = s.params, s.cfg, s.device
    b = p["batch"]
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=False)
               for _ in range(math.ceil(p["pool"] / b))]
    frames = [f for batch in pool_np for f in frames_of(batch)][:p["pool"]]
    s.mark("frames made")
    state_dict = s.weights(train_init=False)
    ref_mano, _ = s.mano()
    s.mark("weights made")
    pred = Predictor(cfg, b, cfg.transfer_dtype, device=dev)
    pred.model.load_state_dict(state_dict, strict=True)
    for mine, theirs in zip(ref_mano, pred.mano):
        if not torch.equal(mine.to(theirs.device), theirs):
            raise RuntimeError("the predictor's MANO stand-in differs from the benchmark's")
    s.mark("predictor built")
    pred.warmup()
    pred.warmup()
    s.mark("warmed up")
    pred = s.program("predictor", pred)
    due = arrivals(s.rng("arrivals"), p["rate_hz"], s.seconds)
    order = s.rng("order").integers(0, len(frames), len(due))
    srv = BatchingServer(pred, max_wait_ms=p["max_wait_ms"], pipeline_depth=p["pipeline_depth"])
    if s.trace:
        pred.predict_async = s.spans.wrap("serve.predict_async", pred.predict_async)
    load = OpenLoop(srv.submit, frames, due, order)
    s.sync()
    # set-up's objects out of the collector's full passes, which would
    # otherwise stall every thread in the window for a tenth of a second
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - s.t_start
    ctx = None
    try:
        if not s.trace:
            load.run(t0)
            load.wait(s.seconds + p["drain_seconds"])
        else:
            # spans over the first part, the profiler over the last
            # profile_seconds of arrivals, the server's counters over both
            split = int(np.searchsorted(due, s.seconds - p["profile_seconds"]))
            s.spans.on = True
            load.run(t0, 0, split)
            s.spans.on = False

            def tail():
                load.run(t0, split)
                load.wait(s.seconds + p["drain_seconds"])

            tr = profiled(tail, s.sync)
            counters = {"frames": srv.frames_served, "batches": srv.batches_dispatched}
            ctx = shared.layer_context(spans=dict(s.spans.ms), counters=counters, trace=tr,
                                       phase="serve",
                                       latency_p95_ms=percentile(load.latencies_ms(0, split), 95))
    finally:
        srv.close()
        gc.unfreeze()
    lat = load.latencies_ms()
    late = load.lateness_ms()
    missing = int(np.sum(~np.isfinite(lat)))
    s.log(f"requests {len(due)} over {s.seconds} s at {p['rate_hz']} Hz; completed "
          f"{len(due) - missing}; batches {srv.batches_dispatched}")
    if len(late):
        s.log(f"generator lateness ms: median {np.median(late):.3f}, p95 "
              f"{np.percentile(late, 95):.3f}, max {late.max():.3f}")
    e2e = {} if s.trace else {"serve_fps": load.completed_per_s(), "setup_s": setup_s}
    s.log(f"latency ms: p50 {percentile(lat, 50):.3f} p95 {percentile(lat, 95):.3f} "
          f"p99 {percentile(lat, 99):.3f}; completed {load.completed_per_s():.4f} f/s")
    peak = s.memory_peak()

    # ---- the comparison -----------------------------------------------------------
    done = [i for i in range(len(due)) if np.isfinite(lat[i])]
    pick = s.rng("sample").choice(len(done), size=min(p["checked_requests"], len(done)),
                                  replace=False)
    sample = [done[j] for j in sorted(pick)]
    served = [load.futures[i].result() for i in sample]
    chosen = [frames[order[i]] for i in sample]
    reads = checked_pass(s, pred, chosen, served)
    del pred, srv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare(s, chosen, served, reads, state_dict, ref_mano)
    return {"end_to_end": e2e, "layer_context": ctx, "compare": tally.numbers,
            "attempted": len(due), "failed": missing, "memory_peak_bytes": peak}


def checked_pass(s, pred, frames: List[Dict], served: List[Dict]) -> List[Dict]:
    """What the program decided for each of ``frames``, read while the same
    predictor serves them once more in batches of its size, from its
    outputs where they carry it, else from the model's forward -> one read
    a frame (empty where none was seen)."""
    b = s.params["batch"]
    reader = shared.ProgramReader(pred.model)
    reads, same = [], 0
    try:
        for lo in range(0, len(frames), b):
            block = frames[lo:lo + b]
            again = pred.materialize(*pred.predict_async(
                {k: np.stack([np.asarray(f[k]) for f in block]) for k in INPUT_KEYS}))
            read = shared.output_read(again) or reader.take()
            reads.extend({k: v[r] for k, v in read.items()} for r in range(len(block)))
            same += sum(all(np.array_equal(again[k][r], served[lo + r][k]) for k in SERVE_KEYS)
                        for r in range(len(block)))
    finally:
        reader.remove()
    s.log(f"checked pass: {same} of {len(frames)} served outputs equal the window's")
    return reads


def compare(s, frames: List[Dict], served: List[Dict], reads: List[Dict],
            state_dict, ref_mano) -> shared.Tally:
    """Judge served outputs request by request, in blocks of the batch."""
    ref = shared.reference_model(s.ref_cfg, state_dict, s.device)
    tally = shared.Tally()
    b = s.params["batch"]
    for lo in range(0, len(frames), b):
        block = range(lo, min(lo + b, len(frames)))
        batch = shared.on_device({k: np.stack([frames[i][k] for i in block])
                                  for k in INPUT_KEYS}, s.device)
        prog = {k: torch.from_numpy(np.stack([np.asarray(served[i][k]) for i in block]))
                for k in SERVE_KEYS}
        keys = set.intersection(*(set(reads[i]) for i in block))
        read = {key: torch.stack([reads[i][key] for i in block]).to(s.device)
                for key in keys}
        shared.judge_eval_batch(tally, ref, ref_mano, batch, prog, read, OUT_KEYS,
                                label=f"requests {lo}..")
    for name, w in tally.where.items():
        s.log(f"worst {name}: {tally.numbers[name]!r} at {w}")
    return tally


def control(s, rounding) -> shared.Tally:
    """The reference with ``rounding`` on every product's operands serves
    the sampled frames in batches, in the program's place."""
    from benchmark.reference.layers import set_operand_rounding
    from benchmark.reference.precision import MANO_ROUNDING
    from benchmark.reference.steps import eval_outputs

    p, cfg = s.params, s.cfg
    b = p["batch"]
    rng = s.rng("frames")
    pool_np = [make_batch(cfg, b, rng, supervise=False) for _ in range(math.ceil(p["pool"] / b))]
    frames = [f for batch in pool_np for f in frames_of(batch)][:p["pool"]]
    pick = s.rng("sample").choice(len(frames), size=min(p["checked_requests"], len(frames)),
                                  replace=False)
    chosen = [frames[i] for i in pick]
    state_dict = s.weights(train_init=False)
    ref_mano, _ = s.mano()
    low = set_operand_rounding(shared.reference_model(s.ref_cfg, state_dict, s.device),
                               rounding)
    served, reads = [], []
    for lo in range(0, len(chosen), b):
        block = chosen[lo:lo + b]
        out = eval_outputs(low, ref_mano, shared.on_device(
            {k: np.stack([f[k] for f in block]) for k in INPUT_KEYS}, s.device),
            supervise_sdf=False, mano_rounding=MANO_ROUNDING)
        for r in range(len(block)):
            served.append({k: out[k][r].cpu().numpy() for k in SERVE_KEYS})
            reads.append({key: out[v][r] for key, v in (
                ("hand", "hand_points"), ("obj", "obj_points"),
                ("mano_pose6d", "mano_pose6d"), ("mano_shape", "mano_shape"))})
    del low
    return compare(s, chosen, served, reads, state_dict, ref_mano)
