"""The share of the profiled window of a traced serving run in which the
device is idle while the server's dispatcher works on a batch: in the
program's ``serve.collect``, ``serve.assemble``,
``predictor.predict_async`` or ``serve.pipeline_full`` spans, placed on the
trace's clock, in %.  The rest of ``device_idle.serve`` lies mostly under
``serve.wait_first`` (no request to serve).  Nothing where no operation ran
on a device (a CPU run), or from a program without these spans."""

DISPATCHER = ("serve.collect", "serve.assemble", "predictor.predict_async",
              "serve.pipeline_full")


def read(ctx):
    if ctx.phase != "serve" or ctx.trace is None or ctx.trace.window_s <= 0 \
            or ctx.trace.busy_s() <= 0:
        return None
    try:
        from hoisdf_torch.utils.profiling import on_trace_clock, overlap
    except ImportError:
        return None
    placed = on_trace_clock((name, start * 1e6) for name, start, _ in ctx.trace.host)
    if placed is None:
        return None
    threads = {s.tid for s in placed[1] if s.name == "serve.collect"}
    busy = [(s.start, s.end) for s in placed[1] if s.name in DISPATCHER and s.tid in threads]
    if not busy:
        return None
    return 100.0 * overlap(busy, ctx.trace.gaps()) / ctx.trace.window_s
