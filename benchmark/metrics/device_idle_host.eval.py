"""The share of the profiled window of the eval cell in which the device is
idle inside the program's ``eval.step`` annotations (the step's enqueue on
the host: it makes no host sync), in %.  Nothing where no operation ran on
a device (a CPU run), or from a program without the annotation."""


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None or ctx.trace.window_s <= 0 \
            or ctx.trace.busy_s() <= 0:
        return None
    steps = [(start, end) for name, start, end in ctx.trace.host if name == "eval.step"]
    if not steps:
        return None
    from hoisdf_torch.utils.profiling import overlap

    return 100.0 * overlap(steps, ctx.trace.gaps()) / ctx.trace.window_s
