"""Kernel B (the bilinear pyramid gather, bf16) in the eval step: the
benchmark's byte bound of the profiled steps' launches over the kernel's
device time there, in %."""


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None or not ctx.bounds.get("gather_lerp"):
        return None
    t = ctx.trace.kernel_seconds(lambda name: "gather_lerp_kernel" in name)
    return 100.0 * ctx.bounds["gather_lerp"] / t if t > 0 else None
