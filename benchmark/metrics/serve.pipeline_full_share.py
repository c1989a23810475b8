"""The share of the profiled tail of a traced run that the server's
dispatcher spent blocked on a full pipeline (the program's
``serve.pipeline_full`` spans: ``pipeline_depth`` steps already in flight),
placed on the trace's clock, in %.  Nothing from a program without these
spans."""


def read(ctx):
    if ctx.phase != "serve" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    try:
        from hoisdf_torch.utils.profiling import on_trace_clock, overlap
    except ImportError:
        return None
    placed = on_trace_clock((name, start * 1e6) for name, start, _ in ctx.trace.host)
    if placed is None or not any(s.name == "serve.collect" for s in placed[1]):
        return None
    full = [(s.start, s.end) for s in placed[1] if s.name == "serve.pipeline_full"]
    return 100.0 * overlap(full, [ctx.trace.window]) / ctx.trace.window_s
