"""95th percentile ms of the served requests due before the profiled tail
of a traced run, each timed from its due time to its result (a missing
request counts as infinitely late)."""

import math


def read(ctx):
    v = ctx.latency_p95_ms if ctx.phase == "serve" else None
    return v if v is not None and math.isfinite(v) else None
