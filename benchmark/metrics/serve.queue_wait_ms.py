"""95th percentile ms of the program's ``serve.queued`` spans (a request's
wait from its submit to the dispatcher's take) over the requests submitted
in the profiled tail of a traced run, placed on the trace's clock through
the spans the profiler recorded too.  Nothing from a program without these
spans."""

import numpy as np


def read(ctx):
    if ctx.phase != "serve" or ctx.trace is None:
        return None
    try:
        from hoisdf_torch.utils.profiling import on_trace_clock
    except ImportError:
        return None
    placed = on_trace_clock((name, start * 1e6) for name, start, _ in ctx.trace.host)
    if placed is None:
        return None
    lo, hi = ctx.trace.window
    waits = [(s.end - s.start) * 1e3 for s in placed[1]
             if s.name == "serve.queued" and lo <= s.start <= hi]
    return float(np.percentile(waits, 95)) if waits else None
