"""The device's idle share in the profiled sub-window of the eval cells: 1
minus the union of the device operations' intervals over the window, in %.
Nothing where no operation ran on a device (a CPU run)."""


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.trace.window_s) if busy > 0 else None
