"""Profiling helpers: trace capture, a step's device time by kernel, and
per-step timing statistics (``hoisdf_tpu/utils/profiling.py``).

``capture_trace`` is ``torch.profiler`` over the host and, where a card is
present, CUDA: a Chrome trace (``*.pt.trace.json``) lands under ``log_dir``,
readable in Perfetto or ``chrome://tracing``.  Capture is best effort: a
profiler that cannot start prints why and the work runs untraced.
``device_breakdown`` reads the card's time per step from the same profiler
(the eval step is host-bound, so CUDA events around it would time the host's
enqueueing); it needs a card and raises without one.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Trace the work inside the block into ``log_dir`` (no-op on failure)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # the profiler may be unavailable
        print(f"[profiling] trace capture unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
            except Exception as e:
                print(f"[profiling] trace export failed: {e}")


# kernel-name substrings of device_breakdown's groups: the port's kernels (the
# gather's backward before the gather) and the host-device copies
PROFILE_GROUPS = ("gather_lerp_bwd", "gather_lerp", "sdf_mlp", "Memcpy")


def device_breakdown(fn, steps: int) -> Dict:
    """Device time of ``steps`` calls of ``fn`` on the card (``torch.profiler``):
    ms and kernel launches per step, the split by PROFILE_GROUPS (and
    "other"), the top kernels and the top ATen operators by device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("device_breakdown profiles the card; CUDA is not available")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us / steps / 1e3, ev.count // steps, ev.key[:80]))
    rows.sort(reverse=True)
    groups: Dict[str, Dict] = {}
    for ms, calls, key in rows:
        name = next((g for g in PROFILE_GROUPS if g in key), "other")
        acc = groups.setdefault(name, {"ms": 0.0, "launches": 0})
        acc["ms"] += ms
        acc["launches"] += calls
    # the operators that launched the most device time, kernels included
    ops = sorted(((getattr(ev, "device_time_total", 0.0) / steps / 1e3, ev.count // steps,
                   ev.key[:60]) for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CPU
                  and ev.key.startswith("aten::")), reverse=True)
    return {"device_ms_per_step": sum(r[0] for r in rows),
            "launches_per_step": sum(r[1] for r in rows), "by_group": groups,
            "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:15]],
            "top_ops": [{"ms": r[0], "calls": r[1], "op": r[2]} for r in ops[:12]]}


class StepStats:
    """Rolling per-step latency stats (p50/p90/mean) for serving telemetry."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)
        if len(self.samples) > self.window:
            self.samples.pop(0)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "p50_ms": s[n // 2] * 1000,
            "p90_ms": s[int(n * 0.9)] * 1000,
            "mean_ms": sum(s) / n * 1000,
            "n": n,
        }
