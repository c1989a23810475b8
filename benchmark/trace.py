"""Host spans and the device trace of a traced run.

``Spans`` times calls on the host clock (``perf_counter``), kept in memory.
``profiled`` runs ``torch.profiler`` (CPU and CUDA activities) over a short
sub-window and reads its Chrome trace back into a :class:`DeviceTrace`: every
device operation (kernels, copies, sets) with its start and length, and the
host operations and annotations with theirs.  The busy time is the union of
the device intervals (a second stream's overlap is counted once); idle gaps
are the holes of that union inside the window, each labelled by the host
operation that was running at its middle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Spans:
    """Durations in ms by name, kept while ``on``."""

    def __init__(self):
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self.on = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.ms[name].append((time.perf_counter() - t0) * 1e3)

    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` with each call timed as ``name``."""

        def timed(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return timed


class DeviceTrace:
    """Device and host intervals of a profiled window, in seconds."""

    def __init__(self, device: Sequence[Tuple[str, float, float]],
                 host: Sequence[Tuple[str, float, float]], window: Tuple[float, float]):
        self.device = list(device)  # (name, start, end)
        self.host = list(host)
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def union(self) -> List[Tuple[float, float]]:
        """The merged device intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union())

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.union():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the operations whose name ``match``es."""
        return sum(e - s for n, s, e in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            acc[name[:120]] += e - s
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle seconds summed by the innermost host operation running at
        each gap's middle ("idle" where none ran)."""
        if not self.host:
            labels = ["idle"] * len(self.gaps())
        else:
            starts = np.array([s for _, s, _ in self.host])
            ends = np.array([e for _, _, e in self.host])
            lengths = ends - starts
            labels = []
            for s, e in self.gaps():
                mid = 0.5 * (s + e)
                inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
                labels.append(self.host[inside[np.argmin(lengths[inside])]][0][:120]
                              if inside.size else "idle")
        acc: Dict[str, float] = defaultdict(float)
        for (s, e), label in zip(self.gaps(), labels):
            acc[label] += e - s
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]


def read_chrome_trace(path: str, window: Tuple[float, float]) -> DeviceTrace:
    """A Chrome trace of ``torch.profiler`` -> :class:`DeviceTrace`; ``window``
    is (start, end) on the trace's clock, in seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        item = (ev.get("name", ""), ev["ts"] * 1e-6, (ev["ts"] + ev["dur"]) * 1e-6)
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat in HOST_CATS:
            host.append(item)
    return DeviceTrace(device, host, window)


def profiled(run: Callable[[], None], sync: Callable[[], None]) -> DeviceTrace:
    """Run ``run`` (which ends in ``sync``) under ``torch.profiler`` and read
    its trace; the window is from the first host event the run makes to the
    end of ``sync``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("benchmark.window"):
            run()
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
    return trace
