"""Median host ms of one eval step call (its enqueue: the step makes no
host sync), timed by a span around each call."""

import statistics


def read(ctx):
    ms = ctx.spans.get("eval.step") if ctx.phase == "eval" else None
    return statistics.median(ms) if ms else None
