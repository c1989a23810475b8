"""Profiling helpers: trace capture and per-step timing statistics
(``hoisdf_tpu/utils/profiling.py``).

``capture_trace`` is ``torch.profiler`` over the host and, where a card is
present, CUDA: a Chrome trace (``*.pt.trace.json``) lands under ``log_dir``,
readable in Perfetto or ``chrome://tracing``.  Capture is best effort: a
profiler that cannot start prints why and the work runs untraced.
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
