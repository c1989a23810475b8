"""The knee of a serving cell: its open-loop generator at a list of offered
rates, one predictor and one server a rate, in one process.

    python -m benchmark.sweep --workload dexycb.serve --rates 200,240,280 --seconds 15

One JSON line a rate: offered and completed frames/s, p50 / p95 / p99 from
due time, the median latency of the window's first and last thirds (a
queue that grows shows as the last above the first), and the generator's
lateness.  The knee is the highest rate whose completed rate stays within a
few percent of the offered and whose latency does not grow; the cell's rate
is set once from it, never searched for in a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark import core


def main(argv=None) -> int:
    from hoisdf_torch.predictor import BatchingServer, Predictor

    from benchmark.inputs.frames import frames_of, make_batch
    from benchmark.kinds.poisson_serve import OpenLoop, arrivals, percentile
    from benchmark.run import Session

    ap = argparse.ArgumentParser(prog="benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    core.cache_dirs(core.ROOT)
    cell = core.resolve_cell(args.workload)
    s = Session(cell, args.seed, args.seconds, False, core.card(cell.chips))
    p, cfg = s.params, s.cfg
    b = p["batch"]
    rng = s.rng("frames")
    pool = [make_batch(cfg, b, rng, supervise=False) for _ in range(-(-p["pool"] // b))]
    frames = [f for batch in pool for f in frames_of(batch)][:p["pool"]]
    pred = Predictor(cfg, b, cfg.transfer_dtype, device=s.device)
    pred.model.load_state_dict(s.weights(train_init=False), strict=True)
    pred.warmup()
    for rate in [float(r) for r in args.rates.split(",")]:
        due = arrivals(s.rng("arrivals"), rate, args.seconds)
        order = s.rng("order").integers(0, len(frames), len(due))
        with BatchingServer(pred, max_wait_ms=p["max_wait_ms"],
                            pipeline_depth=p["pipeline_depth"]) as srv:
            load = OpenLoop(srv.submit, frames, due, order)
            t0 = time.perf_counter()
            load.run(t0)
            load.wait(args.seconds + 60)
        lat = load.latencies_ms()
        done = np.isfinite(lat)
        span = np.nanmax(load.done) - t0 if done.any() else float("nan")
        third = len(lat) // 3
        print(json.dumps({
            "offered_hz": rate, "completed_hz": float(done.sum() / span),
            "completed": int(done.sum()), "requests": len(lat),
            "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
            "p99_ms": percentile(lat, 99),
            "first_third_p50_ms": percentile(lat[:third], 50),
            "last_third_p50_ms": percentile(lat[-third:], 50),
            "lateness_p95_ms": float(np.percentile(load.lateness_ms(), 95)),
            "batches": srv.batches_dispatched}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
