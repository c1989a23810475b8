"""Median host ms of ``Predictor.predict_async`` (slot fill, copies and the
step's enqueue), timed by a span around each call."""

import statistics


def read(ctx):
    ms = ctx.spans.get("serve.predict_async") if ctx.phase == "serve" else None
    return statistics.median(ms) if ms else None
