"""Profiling helpers: in-program spans, trace capture, a step's device time
by kernel, and per-step timing statistics (``hoisdf_tpu/utils/profiling.py``).

``span`` and ``record`` mark the program's stages where the work happens.
They record only while a ``torch.profiler`` runs: otherwise ``span`` returns
one shared no-op context after a single read of the profiler's process-wide
flag, and ``record`` returns.  While a profiler runs, each span keeps
``(name, thread id, start_ns, end_ns, parent, rid)`` on the host's
``perf_counter_ns`` clock in a bounded buffer (:data:`RECORDER`); on a
thread the profiler records, it also opens a ``record_function`` range, so
the stage shows among the device operations.  The profiler does not record
threads started before it (the serving front end's dispatcher and
completer), and its clock is not ``perf_counter``'s: :func:`trace_clock`
maps the host clock onto the trace's from the spans recorded both ways, and
:func:`on_trace_clock` places every buffered span on the trace's clock.

``capture_trace`` is ``torch.profiler`` over the host and, where a card is
present, CUDA: a Chrome trace (``*.pt.trace.json``) lands under ``log_dir``,
readable in Perfetto or ``chrome://tracing``, with the spans of the threads
the profiler missed written in on its clock, one track per thread (the
per-request spans on tracks of their own).  Capture is best effort: a
profiler that cannot start prints why and the work runs untraced.
``device_breakdown`` reads the card's time per step from the same profiler
(the eval step is host-bound, so CUDA events around it would time the host's
enqueueing); it needs a card and raises without one.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# ---- in-program spans ------------------------------------------------------------

SPAN_CAPACITY = 1 << 16  # spans the buffer keeps; the oldest go first
# a range whose opening took longer (another thread held the interpreter
# meanwhile) places its span no better than half of it: it does not set the
# clock (:func:`trace_clock`)
CLOCK_OPEN_NS = 100_000


class Span(NamedTuple):
    """A recorded span, on the host's ``perf_counter_ns`` clock.  ``tid`` is
    the native thread id (the Chrome trace's ``tid``); ``parent`` the name
    of the innermost span open on the same thread (None for a span whose
    ends lie on two threads); ``traced`` that the profiler recorded it too,
    as a ``record_function`` range, which took ``open_ns`` to open."""

    name: str
    tid: int
    start_ns: int
    end_ns: int
    parent: Optional[str]
    rid: Optional[int]
    traced: bool
    open_ns: int = 0


class Recorder:
    """The spans recorded while a profiler ran, oldest first, at most
    ``capacity`` of them (``dropped`` counts those pushed out), and each
    thread's stack of open spans."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._local = threading.local()
        self.dropped = 0
        self.threads: Dict[int, str] = {}  # native id -> name, of the threads that recorded

    def add(self, s: Span) -> None:
        """Keep ``s``; called on the thread that recorded it."""
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)
            if s.tid not in self.threads:
                self.threads[s.tid] = threading.current_thread().name

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self.threads.clear()

    def stack(self) -> List[str]:
        """The calling thread's open spans, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st


RECORDER = Recorder()


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "rid", "parent", "start", "open", "range")

    def __init__(self, name: str, rid: Optional[int]):
        self.name, self.rid = name, rid

    def __enter__(self) -> None:
        stack = RECORDER.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = None
        if torch._C._autograd._profiler_enabled():  # the profiler records this thread
            t0 = time.perf_counter_ns()
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            # the trace stamps a range's start midway through its opening
            # (tens of us on a loaded host) and its end as it closes
            t1 = time.perf_counter_ns()
            self.start, self.open = (t0 + t1) // 2, t1 - t0
        else:
            self.start, self.open = time.perf_counter_ns(), 0

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        RECORDER.stack().pop()
        RECORDER.add(Span(self.name, threading.get_native_id(), self.start, end, self.parent,
                          self.rid, self.range is not None, self.open))
        return False


def span(name: str, rid: Optional[int] = None):
    """A context that records the block as the span ``name`` (of request
    ``rid``) while a profiler runs; otherwise the shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _OpenSpan(name, rid)


def record(name: str, start_ns: int, end_ns: Optional[int] = None,
           rid: Optional[int] = None) -> None:
    """Record a span whose ends lie on two threads, from ``start_ns`` to
    ``end_ns`` (now, where None) on the ``perf_counter_ns`` clock, while a
    profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    end = time.perf_counter_ns() if end_ns is None else end_ns
    RECORDER.add(Span(name, threading.get_native_id(), start_ns, end, None, rid, False))


class TraceClock(NamedTuple):
    """The host's ``perf_counter_ns`` clock on a profiler trace's clock:
    ``offset_us`` is the median over the spans recorded both ways whose
    range opened within ``CLOCK_OPEN_NS`` of the trace's start (``ts``, us)
    minus the span's start / 1e3; ``spread_us`` the distance between those
    offsets' first and third quartiles, ``worst_us`` the farthest from the
    median, over ``pairs`` spans."""

    offset_us: float
    spread_us: float
    worst_us: float
    pairs: int

    def trace_us(self, ns: int) -> float:
        return ns / 1e3 + self.offset_us


def trace_clock(annotations: Iterable[Tuple[str, float]],
                spans: Optional[Sequence[Span]] = None) -> Optional[TraceClock]:
    """The mapping from the host clock to a trace's, from the trace's
    ``record_function`` ranges ``annotations`` ((name, start us); other
    events are passed over) and the buffered spans (``spans``, default the
    recorder's).  Each name's ranges pair with its spans recorded both ways
    in order, aligned at the newest (older spans may be left from an earlier
    trace); the pairs whose range opened slowly are left out where any
    other pairs.  None where no span pairs."""
    spans = RECORDER.spans() if spans is None else spans
    mine: Dict[str, List[Tuple[int, int]]] = {}
    for s in spans:
        if s.traced:
            mine.setdefault(s.name, []).append((s.start_ns, s.open_ns))
    theirs: Dict[str, List[float]] = {}
    for name, ts in annotations:
        if name in mine:
            theirs.setdefault(name, []).append(ts)
    pairs: List[Tuple[float, int]] = []
    for name, ts in theirs.items():
        ns = sorted(mine[name])
        ts.sort()
        n = min(len(ns), len(ts))
        pairs += [(t - s / 1e3, o) for t, (s, o) in zip(ts[len(ts) - n:], ns[len(ns) - n:])]
    offsets = [d for d, o in pairs if o <= CLOCK_OPEN_NS] or [d for d, _ in pairs]
    if not offsets:
        return None
    mid = statistics.median(offsets)
    spread = 0.0
    if len(offsets) > 1:
        q1, _, q3 = statistics.quantiles(offsets, n=4)
        spread = q3 - q1
    return TraceClock(mid, spread, max(abs(d - mid) for d in offsets), len(offsets))


class PlacedSpan(NamedTuple):
    """A span placed on a trace's clock, in seconds."""

    name: str
    tid: int
    start: float
    end: float
    parent: Optional[str]
    rid: Optional[int]
    traced: bool


def on_trace_clock(annotations: Iterable[Tuple[str, float]]
                   ) -> Optional[Tuple[TraceClock, List[PlacedSpan]]]:
    """The recorder's spans placed on the clock of a trace whose
    ``record_function`` ranges are ``annotations`` ((name, start us)) ->
    (the clock, the spans), or None where no span pairs."""
    spans = RECORDER.spans()
    clock = trace_clock(annotations, spans)
    if clock is None:
        return None
    return clock, [PlacedSpan(s.name, s.tid, clock.trace_us(s.start_ns) * 1e-6,
                              clock.trace_us(s.end_ns) * 1e-6, s.parent, s.rid, s.traced)
                   for s in spans]


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The merged, sorted union of (start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def overlap(a: Iterable[Tuple[float, float]], b: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``a`` inside the union of ``b``."""
    ua, ub = union(a), union(b)
    total, j = 0.0, 0
    for s, e in ua:
        while j < len(ub) and ub[j][1] <= s:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < e:
            total += min(e, ub[k][1]) - max(s, ub[k][0])
            k += 1
    return total


def _merge_spans(path: str) -> None:
    """Write the recorder's spans that the profiler missed into the Chrome
    trace at ``path``, on its clock: a track per thread, and the spans
    whose ends lie on two threads as async ranges keyed by ``rid``."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    placed = on_trace_clock((ev["name"], ev["ts"]) for ev in events
                            if ev.get("cat") == "user_annotation" and "ts" in ev)
    if placed is None:
        return
    clock, spans = placed
    pid = os.getpid()
    threads = dict(RECORDER.threads)
    for tid in sorted({s.tid for s in spans if not s.traced}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"spans: {threads.get(tid, tid)}"}})
    for s in spans:
        if s.traced:
            continue
        ts, dur = s.start * 1e6, (s.end - s.start) * 1e6
        args = {"rid": s.rid, "parent": s.parent}
        if s.parent is None and s.rid is not None:  # across threads: one range per request
            events.append({"ph": "b", "cat": "request", "name": s.name, "id": s.rid,
                           "pid": pid, "tid": s.tid, "ts": ts, "args": args})
            events.append({"ph": "e", "cat": "request", "name": s.name, "id": s.rid,
                           "pid": pid, "tid": s.tid, "ts": ts + dur})
        else:
            events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                           "tid": s.tid, "ts": ts, "dur": dur, "args": args})
    trace["spanClock"] = clock._asdict()
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Trace the work inside the block into ``log_dir`` (no-op on failure),
    the program's spans written in (module docstring)."""
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
    RECORDER.reset()
    try:
        # an anchor on this thread, recorded both ways, places the spans
        # of threads the profiler misses
        with span("capture_trace"):
            yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(
                    log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
                prof.export_chrome_trace(path)
                _merge_spans(path)
            except Exception as e:
                print(f"[profiling] trace export failed: {e}")


# kernel-name substrings of device_breakdown's groups: the port's kernels (the
# gather's backward before the gather) and the host-device copies
PROFILE_GROUPS = ("gather_lerp_bwd", "gather_lerp", "sdf_mlp", "Memcpy")


def device_breakdown(fn, steps: int) -> Dict:
    """Device time of ``steps`` calls of ``fn`` on the card (``torch.profiler``):
    ms and kernel launches per step, the split by PROFILE_GROUPS (and
    "other"), the top kernels and the top ATen operators by device ms."""
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
