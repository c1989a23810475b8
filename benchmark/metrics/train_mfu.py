"""The train step's share of the card's f32 peak (TF32 off): the
benchmark's FLOPs of the span-timed part's steps (forward, losses,
backward) over that part's host-clock seconds, in %."""


def read(ctx):
    if ctx.phase != "train" or not ctx.flops or not ctx.span_seconds or not ctx.peak_flops:
        return None
    return 100.0 * ctx.flops / ctx.span_seconds / ctx.peak_flops
