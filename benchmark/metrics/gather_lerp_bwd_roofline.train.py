"""Kernel B's backward in the train step: the benchmark's byte bound of the
profiled steps' launches over the kernel's device time there, in %."""


def read(ctx):
    if ctx.phase != "train" or ctx.trace is None or not ctx.bounds.get("gather_lerp_bwd"):
        return None
    t = ctx.trace.kernel_seconds(lambda name: "gather_lerp_bwd_kernel" in name)
    return 100.0 * ctx.bounds["gather_lerp_bwd"] / t if t > 0 else None
