"""Kernel A's f32 path in the train step (the field-guided steps' sampler):
the benchmark's bound of the profiled steps' launches over the kernel's
device time there, against the f32 peak, in %."""


def read(ctx):
    if ctx.phase != "train" or ctx.trace is None or not ctx.bounds.get("sdf_mlp"):
        return None
    t = ctx.trace.kernel_seconds(lambda name: "sdf_mlp_f32_kernel" in name)
    return 100.0 * ctx.bounds["sdf_mlp"] / t if t > 0 else None
