"""Frames a batch: the server's own counters over the traced run,
``frames_served`` over ``batches_dispatched``, read once every request
has completed."""


def read(ctx):
    c = ctx.counters
    if ctx.phase != "serve" or not c.get("batches"):
        return None
    return c["frames"] / c["batches"]
