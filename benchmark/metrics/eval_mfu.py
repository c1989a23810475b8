"""The eval step's share of the card's bf16 dense peak: the benchmark's
FLOPs of the steps of the span-timed part over that part's host-clock
seconds (all its work, completed), in %."""


def read(ctx):
    if ctx.phase != "eval" or not ctx.flops or not ctx.span_seconds or not ctx.peak_flops:
        return None
    return 100.0 * ctx.flops / ctx.span_seconds / ctx.peak_flops
