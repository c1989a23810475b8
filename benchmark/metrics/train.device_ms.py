"""Device ms of one train step: every device operation's time in the
profiled sub-window over its steps (a sum, not a union)."""


def read(ctx):
    if ctx.phase != "train" or ctx.trace is None or not ctx.profiled_steps:
        return None
    total = ctx.trace.kernel_seconds(lambda name: True)
    return total * 1e3 / ctx.profiled_steps if total > 0 else None
