"""Wall-clock averaging timer (``hoisdf_tpu/utils/timer.py``): the average
starts after ``warmup`` calls, as the original's timer does."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, warmup: int = 10):
        self.warmup = warmup
        self.calls = 0
        self.total_time = 0.0
        self.average_time = 0.0
        self.diff = 0.0
        self._start = 0.0

    def tic(self) -> None:
        self._start = time.perf_counter()

    def toc(self) -> float:
        """Seconds since ``tic``; updates and returns the running average."""
        self.diff = time.perf_counter() - self._start
        self.calls += 1
        if self.calls > self.warmup:
            self.total_time += self.diff
            self.average_time = self.total_time / (self.calls - self.warmup)
        else:
            self.average_time = self.diff
        return self.average_time
