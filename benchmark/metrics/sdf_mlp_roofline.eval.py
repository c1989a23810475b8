"""Kernel A (bf16) in the eval step: the benchmark's bound of the profiled
steps' launches over the kernel's device time there, in %."""


def read(ctx):
    if ctx.phase != "eval" or ctx.trace is None or not ctx.bounds.get("sdf_mlp"):
        return None
    t = ctx.trace.kernel_seconds(lambda name: "sdf_mlp_bf16_kernel" in name)
    return 100.0 * ctx.bounds["sdf_mlp"] / t if t > 0 else None
