"""Host and device time of the dexycb serving step, for comparing two trees
of the port on one card.

    python3 scripts/probe_serving_host.py --tree DIR --label NAME

imports ``hoisdf_torch`` from DIR (a checkout or an unpacked ``git
archive``), builds its kernels, and times a warmed ``Predictor`` (dexycb,
bf16, batch 22, u8 wire, random weights from seed 0): ``predict_async``'s
host ms (the card idle at each call, median of 40), the blocking
``predict`` p50 over 40 requests, and the step's device ms
(torch.profiler over two steps).  One JSON line with the label, the card
and its power limit.  To compare a base and a change, run it in turns in
one call (base, change, change, base) and take each side's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=".")
    p.add_argument("--label", default="tree")
    p.add_argument("--requests", type=int, default=40)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("probe_serving_host needs a CUDA card")
    from hoisdf_torch.config import get_config
    from hoisdf_torch.data.synthetic import synthetic_batch
    from hoisdf_torch.ops import wire
    from hoisdf_torch.ops.kernels import build
    from hoisdf_torch.predictor import INPUT_KEYS, Predictor

    assert os.path.abspath(sys.modules["hoisdf_torch"].__file__).startswith(
        os.path.abspath(args.tree))
    build.build()
    cfg = get_config("dexycb", compute_dtype="bfloat16")
    pred = Predictor(cfg, 22, "uint8", device="cuda")
    pred.warmup()
    frames = []
    for i in range(8):
        b = synthetic_batch(cfg, 22, seed=100 + i)
        frames.append(dict({k: b[k] for k in INPUT_KEYS}, img=wire.quantize_image_u8(b["img"])))
    host = []
    for i in range(args.requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = pred.predict_async(frames[i % 8])
        host.append((time.perf_counter() - t0) * 1e3)
        pred.materialize(*handle)
    lat = []
    for i in range(args.requests):
        t0 = time.perf_counter()
        pred.predict(frames[i % 8])
        lat.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(2):
            pred.predict(frames[i])
        torch.cuda.synchronize()
    dev_us = sum(getattr(ev, "device_time_total", 0.0) for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"label": args.label, "card": smi.strip(),
                      "predict_async_host_ms": statistics.median(host),
                      "predict_async_host_ms_range": [min(host), max(host)],
                      "predict_p50_ms": float(np.percentile(lat, 50)),
                      "step_device_ms": dev_us / 2 / 1e3}), flush=True)


if __name__ == "__main__":
    main()
